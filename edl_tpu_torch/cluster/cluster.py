"""L1 cluster abstraction: inventory + trainer-workload actuation
(counterpart of ``edl_tpu/cluster/cluster.py``).

Mirrors the reference's ``Cluster`` surface (``pkg/cluster.go``):

- ``inquiry_resource``      (ref ``InquiryResource``, ``:176-242``)
- ``get_trainer_workload``  (ref ``GetTrainerJob(ByName)``, ``:91-108``)
- ``update_parallelism``    (ref ``UpdateTrainerJob``, ``:110-113``)
- ``job_pods``              (ref ``JobPods``, ``:117-136``)
- create/delete             (ref ``:245-291``)

All Kubernetes I/O goes through the injected ``KubeAPI`` so everything
here is testable against ``FakeKube`` (the reference left this layer
entirely untested, SURVEY.md §4).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from edl_tpu_torch.cluster.kube import KubeAPI, WorkloadInfo
from edl_tpu_torch.cluster.resources import ClusterResource, Nodes
from edl_tpu_torch.resource.training_job import TrainingJob
from edl_tpu_torch.utils.retry import GiveUpError, RetryPolicy


class ParallelismUpdateError(GiveUpError):
    """``update_parallelism`` gave up: the optimistic-concurrency
    conflict storm outlasted the retry policy.  Typed so the autoscaler
    tick can log-and-skip the one job (the next 5s tick retries) while
    anything else failing still surfaces."""


#: Conflict-retry default: 5 attempts (the reference's ``scaleAllJobs``
#: count, ``pkg/autoscaler.go:346-370``) with a short jittered backoff
#: and a total deadline well inside the 5s control tick.
CONFLICT_RETRY = RetryPolicy(
    max_attempts=5, base_delay=0.05, max_delay=0.5, deadline=2.0
)


class Cluster:
    def __init__(self, kube: KubeAPI, conflict_retry: RetryPolicy = None):
        self.kube = kube
        self.conflict_retry = conflict_retry or CONFLICT_RETRY

    # -- inventory (ref InquiryResource) ------------------------------------
    def inquiry_resource(self) -> ClusterResource:
        """Total/used/idle snapshot.  Sums node allocatables; charges
        every scheduled, non-terminal pod's requests (and GPU limits)
        against the totals and its node's idle maps (ref
        ``pkg/cluster.go:176-242``)."""
        nodes = self.kube.list_nodes()
        pods = self.kube.list_pods()

        r = ClusterResource(
            node_count=len(nodes),
            nodes=Nodes(
                cpu_idle_milli={n.name: n.cpu_milli for n in nodes},
                memory_free_mega={n.name: n.memory_mega for n in nodes},
                gpu_free={n.name: n.gpus for n in nodes},
                pool_topology={
                    n.name: n.gpu_topology for n in nodes if n.gpu_topology
                },
                node_pool={n.name: n.pool for n in nodes if n.pool},
            ),
        )
        for n in nodes:
            r.cpu_total_milli += n.cpu_milli
            r.memory_total_mega += n.memory_mega
            r.gpu_total += n.gpus

        for p in pods:
            if p.phase in ("Succeeded", "Failed"):
                continue  # ref filters these server-side (``:202-210``)
            if not p.node:
                # Unscheduled pod: physical usage is zero.  The reference
                # charged these anyway (``:202-210``), inflating load with
                # unmet demand; we surface them via the autoscaler's
                # explicit pending-demand path instead (fix, don't
                # replicate — see autoscaler.scaler docstring).
                continue
            r.cpu_request_milli += p.cpu_request_milli
            r.memory_request_mega += p.memory_request_mega
            r.gpu_request += p.gpu_limit
            r.gpu_limit += p.gpu_limit
            if p.node in r.nodes.cpu_idle_milli:
                r.nodes.cpu_idle_milli[p.node] -= p.cpu_request_milli
                r.nodes.memory_free_mega[p.node] -= p.memory_request_mega
                r.nodes.gpu_free[p.node] -= p.gpu_limit
        return r

    # -- trainer workload (ref GetTrainerJob / UpdateTrainerJob) ------------
    def _slice_jobs(self, job: TrainingJob) -> List[WorkloadInfo]:
        """The per-replica Indexed Jobs of a multi-host-topology job,
        sorted by replica index (workload name ``<job>-trainer-<r>``)."""
        prefix = job.trainer_job_name() + "-"
        out = []
        for w in self.kube.list_workloads():
            if w.kind != "Job" or not w.name.startswith(prefix):
                continue
            suffix = w.name[len(prefix):]
            if suffix.isdigit():
                out.append((int(suffix), w))
        return [w for _, w in sorted(out, key=lambda t: t[0])]

    @staticmethod
    def _aggregate_slices(
        job_name: str, trainer_name: str, slices: List[WorkloadInfo]
    ) -> WorkloadInfo:
        """Virtual aggregate over a multi-host job's per-replica Jobs:
        ``parallelism`` counts REPLICAS (slice groups), the unit every
        control-plane decision is made in."""
        return WorkloadInfo(
            name=trainer_name,
            job_name=job_name,
            parallelism=len(slices),
            cpu_request_milli=slices[0].cpu_request_milli,
            memory_request_mega=slices[0].memory_request_mega,
            gpu_limit=slices[0].gpu_limit,
            kind="Job",
            owner=slices[0].owner,
        )

    def get_trainer_workload(self, job: TrainingJob) -> Optional[WorkloadInfo]:
        """The job's trainer workload view.  Single-host: the batch Job
        itself.  Multi-host: the virtual replica-count aggregate."""
        if job.hosts_per_replica() == 1:
            return self.kube.get_workload(job.trainer_job_name())
        slices = self._slice_jobs(job)
        if not slices:
            return None
        return self._aggregate_slices(job.name, job.trainer_job_name(), slices)

    def trainer_workloads_map(self) -> Dict[str, WorkloadInfo]:
        """job name -> trainer workload view for EVERY framework job,
        from ONE ``list_workloads`` call — the control loop uses this so
        a tick costs O(1) kubectl subprocesses, not one ``get`` per job
        (the reference's ``GetTrainerJob``-per-job pattern blows the 5s
        tick at cluster scope).  Multi-host jobs aggregate to their
        replica count, same as ``get_trainer_workload``."""
        singles: Dict[str, WorkloadInfo] = {}
        groups: Dict[str, List[tuple]] = {}
        for w in self.kube.list_workloads():
            if w.kind != "Job" or not w.job_name:
                continue
            trainer_name = f"{w.job_name}-trainer"
            if w.name == trainer_name:
                singles[w.job_name] = w
                continue
            prefix = trainer_name + "-"
            if w.name.startswith(prefix) and w.name[len(prefix):].isdigit():
                groups.setdefault(w.job_name, []).append(
                    (int(w.name[len(prefix):]), w)
                )
        for job_name, pairs in groups.items():
            slices = [w for _, w in sorted(pairs, key=lambda t: t[0])]
            singles[job_name] = self._aggregate_slices(
                job_name, f"{job_name}-trainer", slices
            )
        return singles

    def update_parallelism(self, job: TrainingJob, parallelism: int) -> bool:
        """Set the trainer replica count.

        Single-host: rewrite the batch Job's parallelism under the
        ``conflict_retry`` policy — bounded attempts, jittered backoff,
        a deadline inside the control tick (the reference's bare
        5-retry loop, ``pkg/autoscaler.go:346-370``, with the retry
        behavior made uniform via ``utils.retry``).  Exhaustion raises
        the typed ``ParallelismUpdateError`` so the autoscaler tick can
        log-and-skip.  Returns False when the workload does not exist.
        Multi-host: a replica is a whole Indexed Job, so scaling
        creates the missing ``<job>-trainer-<r>`` Jobs (r ascending) or
        deletes the highest-indexed extras — the same
        highest-index-first order the coordinator's replica grouping
        drops, so control plane and world agree on victims."""
        from edl_tpu_torch.cluster.kube import ConflictError

        if job.hosts_per_replica() > 1:
            from edl_tpu_torch.controller.jobparser import parse_to_trainer_slice

            have = {  # replica index -> workload
                int(w.name.rsplit("-", 1)[1]): w
                for w in self._slice_jobs(job)
            }
            ok = True
            # Keep the LOWEST-indexed EXISTING replicas (the coordinator's
            # replica grouping keeps lowest complete replicas on
            # scale-down — deleting "every r >= parallelism" would kill
            # live survivors whenever indexes are non-contiguous, e.g.
            # after an external deletion of replica 0).
            existing = sorted(have)
            keep = existing[:parallelism]
            for r in existing[parallelism:]:
                if not self.kube.delete_workload(have[r].name):
                    ok = False
            # Fill the remainder with fresh Jobs on the smallest unused
            # indexes.
            missing = parallelism - len(keep)
            idx = 0
            while missing > 0:
                if idx not in have:
                    try:
                        self.kube.apply_manifests(
                            [parse_to_trainer_slice(job, idx)]
                        )
                    except Exception:
                        ok = False
                    missing -= 1
                idx += 1
            return ok

        missing = object()  # sentinel threaded out of the retry closure

        def put():
            w = self.kube.get_workload(job.trainer_job_name())
            if w is None:
                return missing
            w.parallelism = parallelism
            self.kube.update_workload(w)
            return True

        import zlib

        try:
            result = self.conflict_retry.run(
                put,
                retryable=lambda e: isinstance(e, ConflictError),
                # Per-job jitter stream: concurrent controllers fighting
                # over different Jobs decorrelate their retries.
                seed=zlib.crc32(job.name.encode()),
                describe=f"parallelism PUT for {job.name}",
            )
        except GiveUpError as e:
            raise ParallelismUpdateError(
                f"parallelism PUT for {job.name} -> {parallelism} gave up "
                f"after {e.attempts} conflict(s)",
                last_error=e.last_error,
                attempts=e.attempts,
            ) from e.last_error
        return result is not missing

    def update_serving_replicas(self, job: TrainingJob, replicas: int) -> bool:
        """Set the serving replica Deployment's replica count (the
        ``ServingLane`` retarget's kube half: the coordinator target
        moves the serving WORLD, this moves the pods that fill it).
        Same optimistic-concurrency discipline as
        ``update_parallelism`` — bounded ``conflict_retry`` attempts,
        typed ``ParallelismUpdateError`` on exhaustion so the lane's
        tick can log-and-skip.  Returns False when the job renders no
        serving fleet (``spec.serving`` unset) or the Deployment does
        not exist."""
        from edl_tpu_torch.cluster.kube import ConflictError

        if job.spec.serving is None:
            return False
        name = job.serving_name()
        missing = object()

        def put():
            w = self.kube.get_workload(name, kind="Deployment")
            if w is None:
                return missing
            w.parallelism = replicas
            self.kube.update_workload(w)
            return True

        import zlib

        try:
            result = self.conflict_retry.run(
                put,
                retryable=lambda e: isinstance(e, ConflictError),
                seed=zlib.crc32(name.encode()),
                describe=f"serving replicas PUT for {job.name}",
            )
        except GiveUpError as e:
            raise ParallelismUpdateError(
                f"serving replicas PUT for {job.name} -> {replicas} gave "
                f"up after {e.attempts} conflict(s)",
                last_error=e.last_error,
                attempts=e.attempts,
            ) from e.last_error
        return result is not missing

    # -- pod counting (ref JobPods) -----------------------------------------
    def job_pods(self, job: TrainingJob) -> Tuple[int, int, int, int]:
        """(total, running, pending, succeeded) over the job's
        non-deleting pods (ref ``pkg/cluster.go:117-136``:
        label-selected, honoring DeletionTimestamp)."""
        return self.job_pods_map().get(job.name, (0, 0, 0, 0))

    def job_pods_map(self, pods=None) -> Dict[str, Tuple[int, int, int, int]]:
        """(total, running, pending, succeeded) for every job in ONE
        pod list — the autoscaler loop uses this so a tick costs one
        list call, not one per job.  ``pods``: optional shared
        snapshot."""
        out: Dict[str, List[int]] = {}
        for p in pods if pods is not None else self.kube.list_pods():
            if not p.job_name or p.deleting:
                continue
            c = out.setdefault(p.job_name, [0, 0, 0, 0])
            c[0] += 1
            if p.phase == "Running":
                c[1] += 1
            elif p.phase == "Pending":
                c[2] += 1
            elif p.phase == "Succeeded":
                c[3] += 1
        return {k: tuple(v) for k, v in out.items()}

    def job_pod_nodes_map(self, pods=None) -> Dict[str, List[str]]:
        """job name -> its scheduled, non-terminal, non-deleting pods'
        node names, newest pod first (descending ``creationTimestamp``,
        name as tiebreak — APPROXIMATING the coordinator's drop-newest
        victim order: k8s timestamps have 1s resolution and pod names
        carry random suffixes, so within one creation second the order
        can diverge from the true join order.  Harmless by design —
        this feeds only the autoscaler's dry-run capacity simulation,
        which self-corrects on the next tick from live pod state; the
        authoritative victim choice is the coordinator's).
        ``pods``: optional shared pod snapshot so a control tick costs
        ONE pod list for all its maps.  The autoscaler threads the
        result into ``JobView.pod_nodes`` so a dry-run shed returns
        capacity to the right node maps."""
        out: Dict[str, List[Tuple[str, str, str]]] = {}
        for p in pods if pods is not None else self.kube.list_pods():
            if not p.job_name or p.deleting or not p.node:
                continue
            if p.phase in ("Succeeded", "Failed"):
                continue
            out.setdefault(p.job_name, []).append((p.created, p.name, p.node))
        return {
            job: [node for _, _, node in sorted(triples, reverse=True)]
            for job, triples in out.items()
        }

    # -- CRUD (ref :245-291) -------------------------------------------------
    def create_trainer_workload(self, job: TrainingJob) -> Optional[WorkloadInfo]:
        """Create the trainer workload(s) by applying the jobparser's
        real manifests — one creation path for FakeKube and a live
        cluster (the reference's TODO at ``pkg/controller.go:115-133``,
        wired)."""
        from edl_tpu_torch.controller.jobparser import parse_to_trainer_manifests

        self.kube.apply_manifests(parse_to_trainer_manifests(job))
        return self.get_trainer_workload(job)

    def delete_trainer_workload(self, job: TrainingJob) -> bool:
        if job.hosts_per_replica() > 1:
            deleted = False
            for w in self._slice_jobs(job):
                deleted = self.kube.delete_workload(w.name) or deleted
            # the headless per-pod-DNS Service shares the trainer name
            self.kube.delete_workload(job.trainer_job_name())
            return deleted
        return self.kube.delete_workload(job.trainer_job_name())

    def delete_pod(self, name: str) -> bool:
        """Graceful named-pod delete (scale-down victim coordination:
        the autoscaler deletes exactly the pods the coordinator dropped
        from the plan, so the kube Job controller never picks its own
        victim)."""
        return self.kube.delete_pod(name)
