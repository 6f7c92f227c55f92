"""The replica-quantized fixed-point scaling algorithm (pure functions;
counterpart of ``edl_tpu/autoscaler/algorithm.py``).

The reference's decision core (``pkg/autoscaler.go``) kept its shape —
ascending-fulfillment sort (ref ``:54-64``, ``:97-129``), per-job dry
run against a mutable simulated ``ClusterResource`` (ref ``:201-291``),
iterate to a fixed point (ref ``:296-337``) — with the JAX package's
deltas, which the port keeps:

- **Replica quantization.** A trainer replica owns a fixed number of
  GPUs (``h100-N``), and a job may additionally be limited to world
  sizes that divide its global batch (``TrainingJob.legal_world_sizes``).
  So a scaling step is "to the next/previous *legal* world size", not
  ±1 pod.
- **Pending-demand shedding.** The dry run takes the pending jobs'
  aggregate demand (GPUs, CPU, memory) explicitly: while free capacity
  is short of it on an axis, scale-ups of jobs competing on that axis
  pause and the least-deserving elastic jobs shed toward min; growth
  always leaves the demand reserved.  (The reference made room only
  when load crossed ``max_load_desired``, ref ``:235-246``, which never
  fires with the devices at 100%.)
- **No livelock.** Up/down conditions are complementary (up to 100% of
  GPUs, shed only on oversubscription or pending demand), and the fixed
  point is capped.

Reference quirks fixed: node idle resources are *subtracted* on
simulated scale-up (the reference added them back, ``:213-216``), and
scale-down returns capacity to the shed pods' *nodes*
(``JobView.pod_nodes``, victim-first) so the same pass can re-place a
freed replica — the reference returned it to cluster totals only
(``:230-249``), which with quantized jumps would strand a freed h100-16.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

from edl_tpu_torch.cluster.resources import ClusterResource
from edl_tpu_torch.resource.training_job import TrainingJob


@dataclass
class PendingDemand:
    """Aggregate resources fully-pending jobs need to start (their
    min_instance worth).  The reference had no such notion — pending
    jobs got room only when cluster load happened to cross
    ``max_load_desired`` (ref ``pkg/autoscaler.go:235-246``), which
    never fires when GPUs are at 100% or the pressure is on an
    uncharged axis.  The dry run treats unmet demand as *starvation*:
    sheds fire and competing scale-ups pause until free capacity covers
    it."""

    gpus: int = 0
    cpu_milli: int = 0
    mem_mega: int = 0

    def __bool__(self) -> bool:
        return bool(self.gpus or self.cpu_milli or self.mem_mega)


def _starved_axes(
    r: ClusterResource, demand: PendingDemand, max_load_desired: float
) -> set:
    """Axes whose free capacity cannot cover the pending demand."""
    axes = set()
    if demand.gpus and r.gpu_total - r.gpu_limit < demand.gpus:
        axes.add("gpu")
    if (
        demand.cpu_milli
        and r.cpu_total_milli * max_load_desired - r.cpu_request_milli
        < demand.cpu_milli
    ):
        axes.add("cpu")
    if (
        demand.mem_mega
        and r.memory_total_mega - r.memory_request_mega < demand.mem_mega
    ):
        axes.add("mem")
    return axes


def _competes_on(j: JobView, axes: set) -> bool:
    return (
        ("gpu" in axes and j.gpu_per_trainer > 0)
        or ("cpu" in axes and j.cpu_request_milli > 0)
        or ("mem" in axes and j.mem_request_mega > 0)
    )


@dataclass
class JobView:
    """The autoscaler's read-model of one job — the analog of the
    reference's ``job`` struct (config + actuated trainer workload,
    ref ``pkg/autoscaler.go:34-37``) flattened to plain numbers so the
    algorithm stays pure and trivially testable."""

    name: str
    min_instance: int
    max_instance: int
    #: current actuated parallelism (ref ``*TrainerJob.Spec.Parallelism``)
    parallelism: int
    cpu_request_milli: int = 0
    mem_request_mega: int = 0
    #: GPUs per trainer replica (0 = CPU-only job)
    gpu_per_trainer: int = 0
    #: Replica topology name (e.g. "h100-16"); "" = any GPU pool.
    slice_topology: str = ""
    #: ascending legal world sizes within [min, max]; empty = every size
    legal_sizes: List[int] = field(default_factory=list)
    elastic: bool = True
    #: fleet-arbiter scheduling priority (``TrainingJobSpec.priority``,
    #: higher = more important); the single-cluster fixed point here
    #: ignores it; the multi-job market (JAX ``edl_tpu.fleet``, the
    #: port's with ROADMAP A-4) orders growth by it
    priority: int = 0
    #: host pods per replica (>1 for multi-host replicas: the replica's
    #: pods land on `hosts` DISTINCT nodes of one pool, each consuming
    #: per-pod cpu/mem and GPUs-per-host)
    hosts: int = 1
    #: node names of the job's CURRENT pods, victim-first (newest pod
    #: first — the coordinator drops newest-joined members on
    #: scale-down, and the multi-host path deletes highest-indexed
    #: replica Jobs).  Lets a dry-run shed return the replica's
    #: capacity to the node maps it actually occupies, so the same
    #: fixed-point pass can re-place the freed replica (the reference
    #: returned it to cluster totals only, ref
    #: ``pkg/autoscaler.go:230-249``).
    pod_nodes: List[str] = field(default_factory=list)
    #: per-pod nodes THIS dry run placed on simulated scale-ups (so a
    #: later shed of a not-yet-real replica frees the simulated nodes,
    #: not a live pod's)
    _sim_placed: List[str] = field(default_factory=list)

    @staticmethod
    def from_job(
        job: TrainingJob,
        parallelism: Optional[int] = None,
        pod_nodes: Optional[List[str]] = None,
    ) -> "JobView":
        t = job.spec.trainer
        return JobView(
            pod_nodes=list(pod_nodes or []),
            name=job.name,
            min_instance=t.min_instance,
            max_instance=t.max_instance,
            parallelism=(
                parallelism if parallelism is not None else job.status.parallelism
            )
            or t.min_instance,
            cpu_request_milli=t.resources.cpu_request_milli(),
            mem_request_mega=t.resources.mem_request_mega(),
            gpu_per_trainer=job.gpu_per_trainer(),
            slice_topology=t.slice_topology if job.gpu_per_trainer() else "",
            legal_sizes=job.legal_world_sizes(),
            elastic=job.elastic(),
            priority=job.spec.priority,
            hosts=job.hosts_per_replica(),
        )

    # -- per-pod / per-replica views ----------------------------------------
    @property
    def gpu_per_pod(self) -> int:
        """GPUs one POD consumes (a replica's GPUs split over hosts)."""
        return self.gpu_per_trainer // max(1, self.hosts)

    @property
    def cpu_per_replica(self) -> int:
        """cpu_request_milli is per POD; a replica runs ``hosts`` pods."""
        return self.cpu_request_milli * max(1, self.hosts)

    @property
    def mem_per_replica(self) -> int:
        return self.mem_request_mega * max(1, self.hosts)

    # -- legal-size stepping ------------------------------------------------
    def _sizes(self) -> List[int]:
        if self.legal_sizes:
            return self.legal_sizes
        return list(range(self.min_instance, self.max_instance + 1))

    def next_size_up(self, planned: int) -> Optional[int]:
        """Smallest legal world size strictly above ``planned``."""
        for s in self._sizes():
            if s > planned:
                return s
        return None

    def next_size_down(self, planned: int) -> Optional[int]:
        """Largest legal world size strictly below ``planned``."""
        for s in reversed(self._sizes()):
            if s < planned:
                return s
        return None

    def clamp_size(self, planned: int) -> int:
        """Largest legal size <= planned (used to clamp over-max plans)."""
        best = self._sizes()[0]
        for s in self._sizes():
            if s <= planned:
                best = s
        return best


def fulfillment(j: JobView) -> float:
    """(cur - min) / (max - min); 1.0 when min == max
    (ref ``Fulfillment()``, ``pkg/autoscaler.go:54-64``)."""
    if j.min_instance == j.max_instance:
        return 1.0
    return (j.parallelism - j.min_instance) / (j.max_instance - j.min_instance)


def sorted_jobs(
    jobs: Iterable[JobView], *filters
) -> List[JobView]:
    """Ascending by fulfillment; ties broken by GPUs, then CPU request,
    then memory request, all ascending — smaller jobs first (ref
    ``jobs.Less`` + ``sortedJobs``, ``pkg/autoscaler.go:97-129,
    175-189``)."""
    out = [j for j in jobs if all(f(j) for f in filters)]
    out.sort(
        key=lambda j: (
            fulfillment(j),
            j.gpu_per_trainer,
            j.cpu_request_milli,
            j.mem_request_mega,
        )
    )
    return out


def elastic(j: JobView) -> bool:
    """ref ``elastic`` filter (``pkg/autoscaler.go:132-134``)."""
    return j.elastic


def needs_gpu(j: JobView) -> bool:
    """ref ``gpu`` filter (``pkg/autoscaler.go:137-139``)."""
    return j.gpu_per_trainer > 0


def _slice_fits_pool(r: ClusterResource, name: str, j: JobView) -> bool:
    """Shape-aware placement: where a pool declares a replica topology,
    a replica must come from a pool of its own topology.  Pools that
    declare none are GPU-counted, as the reference counted GPUs per node
    (``pkg/cluster.go:224-234``).  GPU nodes carry no slice label, so
    every node ``KubectlAPI`` reads is such a pool: an ``h100-1`` or
    ``h100-4`` replica takes part of an 8-GPU node, and an ``h100-16``
    replica takes two whole 8-GPU nodes of one nodepool (its per-pod
    GPU count and ``search_assignable_nodes``' one-pool rule).  A
    FakeKube may declare a topology; the JAX package's rule then holds
    unchanged."""
    pool_topo = r.nodes.pool_topology.get(name)
    if not pool_topo:
        return True
    from edl_tpu_torch.cluster.gpu_topology import normalize_topology

    pool = normalize_topology(pool_topo)
    if pool is None:
        return True  # unrecognized label: fall back to GPU counting
    if j.slice_topology:
        job_topo = normalize_topology(j.slice_topology)
        if job_topo is not None:
            return job_topo.name == pool.name
    # Untyped job (hand-built JobView): require the pool's replica unit
    # to be exactly the replica's GPU count (hosts follow the shape).
    return j.gpu_per_trainer == pool.gpus


def search_assignable_nodes(
    r: ClusterResource, j: JobView
) -> Optional[List[str]]:
    """Nodes for ONE replica's pods — ``j.hosts`` DISTINCT nodes, each
    with room for one pod (per-pod cpu/mem/GPUs) on a pool of the
    replica's topology.  Single-host replicas reduce to the reference's
    one-node check (``searchAssignableNode``,
    ``pkg/autoscaler.go:191-199``, extended: the GPU check requires
    replica-shaped capacity, not loose GPUs).

    Multi-host replicas must take ALL their nodes from ONE nodepool:
    hosts of two pools share no fabric the replica can rely on, and
    admitting them would plan replicas the scheduler never co-locates.
    Nodes without a pool identity cannot prove co-location, so a
    hosts>1 replica refuses them.
    Deterministic order so plans are reproducible (the reference
    iterated a Go map)."""
    hosts = max(1, j.hosts)

    def fits(name: str) -> bool:
        if j.cpu_request_milli > r.nodes.cpu_idle_milli[name]:
            return False
        if j.mem_request_mega > r.nodes.memory_free_mega.get(name, 0):
            return False
        if j.gpu_per_trainer > 0:
            if j.gpu_per_pod > r.nodes.gpu_free.get(name, 0):
                return False
            if not _slice_fits_pool(r, name, j):
                return False
        return True

    if hosts == 1:
        for name in sorted(r.nodes.cpu_idle_milli):
            if fits(name):
                return [name]
        return None

    by_pool: Dict[str, List[str]] = {}
    for name in sorted(r.nodes.cpu_idle_milli):
        pool = r.nodes.node_pool.get(name, "")
        if not pool:
            continue  # co-location unprovable without pool identity
        if fits(name):
            by_pool.setdefault(pool, []).append(name)
    for pool in sorted(by_pool):
        if len(by_pool[pool]) >= hosts:
            return by_pool[pool][:hosts]
    return None


def search_assignable_node(r: ClusterResource, j: JobView) -> Optional[str]:
    """Single-node view of ``search_assignable_nodes`` (the reference's
    shape; still the right call for hosts == 1 replicas)."""
    nodes = search_assignable_nodes(r, j)
    return nodes[0] if nodes else None


def _apply(r: ClusterResource, j: JobView, delta_replicas: int, nodes: Sequence[str]):
    """Mutate the simulated inventory for ``delta_replicas`` more (or
    fewer) replicas of ``j`` (the reference did this in a defer,
    ``pkg/autoscaler.go:209-217`` — with the idle-adjustment sign
    inverted, which we fix).  ``nodes``: per-POD placements (one entry
    per host pod)."""
    r.gpu_limit += j.gpu_per_trainer * delta_replicas
    r.cpu_request_milli += j.cpu_per_replica * delta_replicas
    r.memory_request_mega += j.mem_per_replica * delta_replicas
    for name in nodes:
        r.nodes.cpu_idle_milli[name] -= j.cpu_request_milli
        r.nodes.memory_free_mega[name] -= j.mem_request_mega
        if j.gpu_per_trainer > 0:
            r.nodes.gpu_free[name] = (
                r.nodes.gpu_free.get(name, 0) - j.gpu_per_pod
            )


def _free_replicas(r: ClusterResource, j: JobView, n_replicas: int):
    """Return ``n_replicas`` shed replicas' per-pod capacity to the
    node maps.  Prefers nodes this dry run itself placed (a simulated
    grow later shed), then the job's real pod placements, victim-first.
    Pods whose placement is unknown (no ``pod_nodes`` info — e.g. a
    hand-built ``JobView``) or whose node has left the inventory free
    cluster totals only, the reference's behavior (crediting a vanished
    node would fabricate schedulable capacity)."""
    for _ in range(n_replicas * max(1, j.hosts)):
        if j._sim_placed:
            name = j._sim_placed.pop()
        elif j.pod_nodes:
            name = j.pod_nodes.pop(0)
        else:
            return
        if name not in r.nodes.cpu_idle_milli:
            continue  # node gone from inventory: totals-only freeing
        r.nodes.cpu_idle_milli[name] = (
            r.nodes.cpu_idle_milli.get(name, 0) + j.cpu_request_milli
        )
        r.nodes.memory_free_mega[name] = (
            r.nodes.memory_free_mega.get(name, 0) + j.mem_request_mega
        )
        if j.gpu_per_trainer > 0:
            r.nodes.gpu_free[name] = (
                r.nodes.gpu_free.get(name, 0) + j.gpu_per_pod
            )


def scale_dry_run(
    r: ClusterResource,
    j: JobView,
    cur_diff: int,
    max_load_desired: float = 0.97,
    scale_down: bool = False,
    pending: Optional[PendingDemand] = None,
) -> int:
    """Decide one scaling step for one job against the simulated
    inventory, mutating ``r`` by whatever is decided.  Returns the
    replica delta (ref ``scaleDryRun``, ``pkg/autoscaler.go:201-291``).

    Steps move between *legal* world sizes (replica + batch quantization);
    feasibility is checked for the whole step, per replica, against the
    per-node maps.
    """
    planned = j.parallelism + cur_diff
    pending = pending or PendingDemand()
    starved = _starved_axes(r, pending, max_load_desired)

    # ======================= scale down =======================
    if scale_down:
        if planned > j.max_instance:
            # Over max (e.g. spec shrank): clamp down to the largest
            # legal size (ref ``:231-234`` stepped -1; we jump).
            target = j.clamp_size(min(planned, j.max_instance))
            delta = target - planned
            _free_replicas(r, j, -delta)
            _apply(r, j, delta, ())
            return delta
        cpu_hot = r.cpu_request_milli > r.cpu_total_milli * max_load_desired
        # Oversubscription: inventory shrank under running pods.
        gpu_over = r.gpu_limit > r.gpu_total
        mem_over = r.memory_request_mega > r.memory_total_mega
        if cpu_hot or gpu_over or mem_over or _competes_on(j, starved):
            if planned > j.min_instance:
                target = j.next_size_down(planned)
                if target is not None and target >= j.min_instance:
                    delta = target - planned
                    _free_replicas(r, j, -delta)
                    _apply(r, j, delta, ())
                    return delta
        return 0

    # ======================= scale up =========================
    if planned >= j.max_instance:
        # At (or erroneously above) max: clamp back to the largest
        # *legal* size <= max, never grow (ref ``:252-257``; plain
        # max_instance could pin an over-max job on an illegal size
        # when max itself isn't in legal_sizes).
        delta = min(0, j.clamp_size(j.max_instance) - planned)
        _free_replicas(r, j, -delta)
        _apply(r, j, delta, ())
        return delta
    if _competes_on(j, starved):
        # Free capacity doesn't yet cover the pending jobs' demand on an
        # axis this job consumes: pause its growth so sheds aren't
        # immediately re-eaten.  (Once free >= demand, growth resumes —
        # a job pending for non-capacity reasons can't freeze the
        # cluster.)
        return 0

    target = j.next_size_up(planned)
    if target is None or target > j.max_instance:
        return 0
    step = target - planned

    # Whole-step feasibility, with the pending jobs' demand reserved so
    # growth never consumes room a queued job is waiting for (otherwise
    # the fixed point would grow/shed in a loop).
    if (
        r.memory_total_mega - r.memory_request_mega - pending.mem_mega
        < j.mem_per_replica * step
    ):
        return 0  # insufficient memory (ref ``:259-263``)
    if (
        r.cpu_total_milli * max_load_desired
        - r.cpu_request_milli
        - pending.cpu_milli
        < j.cpu_per_replica * step
    ):
        return 0  # would push CPU above max_load_desired (ref ``:269-273``)
    if j.gpu_per_trainer > 0 and (
        r.gpu_total - r.gpu_limit - pending.gpus
        < j.gpu_per_trainer * step
    ):
        return 0  # not enough free GPUs; GPUs may go to 100% (ref ``:275-278``)

    # Per-replica node placement (ref ``:264-267`` checked one replica
    # on one node; a quantized step places each new replica — `hosts`
    # pods on distinct nodes for multi-host replicas).
    placed: List[str] = []
    for _ in range(step):
        nodes = search_assignable_nodes(r, j)
        if nodes is None:
            # Roll back trial placements and refuse the step.
            for n in placed:
                r.nodes.cpu_idle_milli[n] += j.cpu_request_milli
                r.nodes.memory_free_mega[n] += j.mem_request_mega
                if j.gpu_per_trainer > 0:
                    r.nodes.gpu_free[n] += j.gpu_per_pod
            return 0
        # Reserve on the node map immediately so the next pod sees it.
        for node in nodes:
            r.nodes.cpu_idle_milli[node] -= j.cpu_request_milli
            r.nodes.memory_free_mega[node] -= j.mem_request_mega
            if j.gpu_per_trainer > 0:
                r.nodes.gpu_free[node] = (
                    r.nodes.gpu_free.get(node, 0) - j.gpu_per_pod
                )
            placed.append(node)

    # Cluster-level totals (node maps already adjusted above); remember
    # the placements so a later shed of this simulated replica frees
    # these nodes rather than a live pod's.
    j._sim_placed.extend(placed)
    _apply(r, j, step, ())
    return step


def scale_all_jobs_dry_run(
    jobs: Sequence[JobView],
    r: ClusterResource,
    max_load_desired: float = 0.97,
    pending: Optional[PendingDemand] = None,
    max_iters: int = 100,
) -> Dict[str, int]:
    """Iterate per-job dry runs to a fixed point; returns name -> replica
    delta (ref ``scaleAllJobsDryRun``, ``pkg/autoscaler.go:296-337``).

    Forward pass scales up from the least-fulfilled job; reverse pass
    scales down from the most-fulfilled.  ``r`` is mutated (pass a
    ``deepcopy`` to keep the real inventory).  ``max_iters`` bounds the
    loop (the reference had no bound and could livelock at full device
    utilization)."""
    diff: Dict[str, int] = {j.name: 0 for j in jobs}
    sim = r  # mutated in place, like the reference's value copy
    for _ in range(max_iters):
        no_change = True
        ordered = sorted_jobs(jobs, elastic)
        for j in ordered:  # scale up, neediest first
            add = scale_dry_run(
                sim, j, diff[j.name], max_load_desired, False, pending
            )
            diff[j.name] += add
            if add != 0:
                no_change = False
        for j in reversed(ordered):  # scale down, most-fulfilled first
            add = scale_dry_run(
                sim, j, diff[j.name], max_load_desired, True, pending
            )
            diff[j.name] += add
            if add != 0:
                no_change = False
        if no_change:
            break
    return {k: v for k, v in diff.items() if v != 0}
