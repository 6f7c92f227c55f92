"""L3 autoscaler control loop: events + ticker -> plan -> actuation
(counterpart of ``edl_tpu/autoscaler/scaler.py``).

The reference's ``Autoscaler.Run`` (``pkg/autoscaler.go:451-485``):
select on a 5s ticker and an event channel, inventory the cluster,
detect pending jobs, dry-run the fixed point over the reschedulable
jobs, and actuate by rewriting trainer parallelism.  Same loop here,
with ``run_once`` factored out so tests drive it synchronously (the
reference's loop was untestable and only smoke-checked for liveness,
``pkg/autoscaler_test.go:29-45``).

Inventory departure (fix, don't replicate): the reference charged
*unscheduled* pending pods' requests against cluster usage
(``pkg/cluster.go:202-210`` lists all non-terminal pods), inflating
load with demand that consumes nothing physically.  We charge only
scheduled pods; unscheduled demand enters the algorithm explicitly as
``pending_gpu_demand`` (see ``algorithm.scale_dry_run``), which both
sheds room for it and stops scale-ups from stealing that room.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

from edl_tpu_torch.autoscaler.algorithm import (
    JobView,
    PendingDemand,
    scale_all_jobs_dry_run,
)
from edl_tpu_torch.cluster.cluster import Cluster
from edl_tpu_torch.resource.training_job import TrainingJob

DEFAULT_LOOP_SECONDS = 5.0  # ref defaultLoopDur (pkg/autoscaler.go:30-32)
DEFAULT_MAX_LOAD_DESIRED = 0.97  # ref cmd/edl/edl.go:19-20


def wait_for_world_ack(client, timeout: float) -> bool:
    """Bounded wait for a retargeted world to re-form — the consensus
    stop agreement's actuation-side half: until every surviving member
    acks the new generation, the victims may still be stepping toward
    the agreed stop boundary, and a SIGTERM (pod deletion) or a GPU
    reallocation mid-quiesce yanks them out of a live world.  Used by
    the training lane's victim deletion (and, in the JAX package, by
    the fleet arbiter's preemption path).  Best effort: coordinators
    without the signal (test doubles, pre-consensus versions) and
    worlds with no live trainers (``acked_members`` 0) skip the wait;
    returns False on timeout (the broken-world machinery still
    recovers, it just pays a replay)."""
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            m = client.metrics()
        except Exception:
            return True
        if not isinstance(m, dict) or "world_acked" not in m:
            return True  # pre-consensus coordinator: nothing to wait on
        if m.get("world_acked") or not m.get("acked_members"):
            return True
        time.sleep(0.5)
    return False


@dataclass
class _Event:
    type: str  # "add" | "update" | "del"  (ref eventType, :141-147)
    job: TrainingJob


@dataclass
class ScalePlan:
    """One loop iteration's outcome (for logging/metrics/tests)."""

    targets: Dict[str, int]
    diff: Dict[str, int]
    have_pending: bool
    pending: PendingDemand
    #: per-job structured decision trace (goodput-annotated): what the
    #: dry run proposed, what was observed, why it did/didn't actuate
    decisions: Optional[List[dict]] = None


class Autoscaler:
    def __init__(
        self,
        cluster: Cluster,
        max_load_desired: float = DEFAULT_MAX_LOAD_DESIRED,
        loop_seconds: float = DEFAULT_LOOP_SECONDS,
        coord_client_factory=None,
    ):
        """``coord_client_factory``: job -> coordinator client (the
        actuation handshake's transport); defaults to the HTTP client
        resolved from the job's coordinator Service.  Injectable so
        tests can point it at an in-process coordinator."""
        from edl_tpu_torch.controller.coordclient import make_coord_client

        self.cluster = cluster
        self.max_load_desired = max_load_desired
        self.loop_seconds = loop_seconds
        self.jobs: Dict[str, TrainingJob] = {}
        self._events: "queue.Queue[_Event]" = queue.Queue()
        self._stop = threading.Event()
        self.plans: List[ScalePlan] = []
        self._coord_client = coord_client_factory or make_coord_client
        # Goodput-annotated decision log (edl_tpu_torch.telemetry): each tick
        # records, per candidate job, the dry-run trace plus the
        # OBSERVED step rate / resize cost from the job coordinator's
        # merged trainer telemetry — elastic decisions driven by
        # measured throughput, not declared replica ranges alone
        # (Varuna/Bamboo, PAPERS.md).  Bounded; newest last.
        from edl_tpu_torch import telemetry

        self.decision_log: List[dict] = []
        self.decision_log_max = 256
        self._recorder = telemetry.get_recorder()
        reg = telemetry.get_registry()
        self._m_ticks = reg.counter("edl_autoscaler_ticks_total")
        self._m_actuations = reg.counter("edl_autoscaler_actuations_total")
        self._g_step_rate = reg.gauge("edl_observed_step_rate")
        self._g_resize_cost = reg.gauge("edl_observed_resize_cost_seconds")
        #: goodput observation failure memo: job -> tick of last failed
        #: probe.  An unreachable coordinator (fake clusters, jobs still
        #: scheduling) must not charge its connect-retry latency to
        #: EVERY 5s tick — re-probe only every goodput_retry_ticks.
        self._tick_count = 0
        self._goodput_failed_tick: Dict[str, int] = {}
        self.goodput_retry_ticks = 20
        #: how long a scale-down waits for the retargeted world to ack
        #: (= every member, victims included, left the old world at the
        #: consensus-agreed stop boundary) before deleting victim pods
        #: — deleting earlier SIGTERMs a victim mid-quiesce and turns
        #: the clean agreed-boundary teardown into a world-break +
        #: replay for the survivors
        self.victim_drain_timeout = 20.0

    # -- event intake (ref OnAdd/OnUpdate/OnDel, :158-171) -------------------
    def on_add(self, job: TrainingJob):
        self._events.put(_Event("add", job))

    def on_update(self, job: TrainingJob):
        self._events.put(_Event("update", job))

    def on_del(self, job: TrainingJob):
        self._events.put(_Event("del", job))

    def _drain_events(self):
        """ref updateJobList (:383-402), minus the TrainerJob caching —
        the workload is re-fetched fresh each loop anyway."""
        while True:
            try:
                evt = self._events.get_nowait()
            except queue.Empty:
                return
            if evt.type in ("add", "update"):
                self.jobs[evt.job.name] = evt.job
            elif evt.type == "del":
                self.jobs.pop(evt.job.name, None)

    # -- one decision cycle ---------------------------------------------------
    def run_once(
        self, workloads=None, pods_by_job=None, pod_nodes=None
    ) -> Optional[ScalePlan]:
        """Inventory -> pending detection -> fixed-point dry run ->
        actuation.  Returns the plan (None when there was nothing to
        decide over).  ``workloads`` / ``pods_by_job`` / ``pod_nodes``:
        optional snapshots (``Cluster.trainer_workloads_map`` /
        ``job_pods_map`` / ``job_pod_nodes_map``) shared across the
        controller tick; computed here — both pod maps from ONE pod
        list — when absent."""
        self._drain_events()
        if not self.jobs:
            return None
        r = self.cluster.inquiry_resource()
        if pods_by_job is None or pod_nodes is None:
            pods = self.cluster.kube.list_pods()  # ONE pod list
            if pods_by_job is None:
                pods_by_job = self.cluster.job_pods_map(pods)
            if pod_nodes is None:
                pod_nodes = self.cluster.job_pod_nodes_map(pods)
        if workloads is None:
            workloads = self.cluster.trainer_workloads_map()  # ONE list

        views: List[tuple] = []
        demand = PendingDemand()
        have_pending = False
        for job in self.jobs.values():
            w = workloads.get(job.name)
            if w is None:
                continue  # not created yet (ref tryToRetrieve..., :424-447)
            total, running, pending, _ = pods_by_job.get(job.name, (0, 0, 0, 0))
            if total > 0 and total == pending:
                # every pod pending: the job cannot start (ref
                # findPendingJob, :406-422).  Its min-instance needs
                # become explicit demand on every axis it consumes.
                have_pending = True
                t = job.spec.trainer
                hosts = job.hosts_per_replica()  # pods per replica
                demand.gpus += t.min_instance * job.gpu_per_trainer()
                demand.cpu_milli += (
                    t.min_instance * hosts * t.resources.cpu_request_milli()
                )
                demand.mem_mega += (
                    t.min_instance * hosts * t.resources.mem_request_mega()
                )
                continue  # a fully-pending job is demand, not a candidate
            views.append(
                (
                    JobView.from_job(
                        job,
                        parallelism=w.parallelism,
                        pod_nodes=pod_nodes.get(job.name),
                    ),
                    total,
                    running,
                )
            )

        # Reschedulable set: stable jobs always; every job when pending
        # exists (ref findTrainingJobsMightBeRescheduled, :487-511).
        candidates = [
            v for v, total, running in views if total == running or have_pending
        ]
        if not candidates and not demand:
            return None

        diff = scale_all_jobs_dry_run(
            candidates,
            r.deepcopy(),
            self.max_load_desired,
            pending=demand,
        )
        self._m_ticks.inc()
        self._tick_count += 1

        targets: Dict[str, int] = {}
        for v in candidates:
            if diff.get(v.name):
                targets[v.name] = v.parallelism + diff[v.name]
        applied, stop_steps, traces = self._actuate(targets, diff)
        # Decisions are journaled AFTER actuation so ``actuated``
        # reports what actually happened (a PUT that gave up under a
        # conflict storm is exactly the case the log exists for).
        decisions = self._record_decisions(
            candidates, diff, targets, have_pending, applied, stop_steps,
            traces,
        )
        plan = ScalePlan(
            targets=targets,
            diff=diff,
            have_pending=have_pending,
            pending=demand,
            decisions=decisions,
        )
        self.plans.append(plan)
        return plan

    def _observe_goodput(self, name: str) -> dict:
        """Best-effort read of the job coordinator's merged trainer
        telemetry (``GET /telemetry``): observed step rate, mean resize
        cost, cumulative steps.  Empty dict when the coordinator is
        unreachable or predates telemetry — the decision still logs,
        just without observations."""
        job = self.jobs.get(name)
        if job is None:
            return {}
        last_fail = self._goodput_failed_tick.get(name)
        if (
            last_fail is not None
            and self._tick_count - last_fail < self.goodput_retry_ticks
        ):
            return {}
        try:
            client = self._coord_client(job)
            tel = getattr(client, "telemetry", None)
            if tel is None:
                return {}
            t = tel() or {}
        except Exception:
            self._goodput_failed_tick[name] = self._tick_count
            return {}
        self._goodput_failed_tick.pop(name, None)
        merged = t.get("merged") or {}
        steps = (merged.get("counters") or {}).get("edl_steps_total") or {}
        goodput = t.get("goodput") or {}
        obs = {
            "step_rate": t.get("step_rate"),
            "resize_cost_seconds": t.get("resize_cost_seconds"),
            "steps_total": sum(steps.values()),
            # The goodput ledger's job-level read: the wall-clock
            # fraction actually spent stepping, plus its decomposition
            # (resizing[:phase] / holding / replaying / broken ...) —
            # the signal a step RATE alone cannot carry.
            "goodput_frac": goodput.get("frac"),
            "goodput_seconds": goodput.get("seconds"),
        }
        if obs["step_rate"] is not None:
            self._g_step_rate.set(obs["step_rate"], job=name)
        if obs["resize_cost_seconds"] is not None:
            self._g_resize_cost.set(obs["resize_cost_seconds"], job=name)
        return obs

    def _record_decisions(
        self, candidates, diff, targets, have_pending, applied,
        stop_steps=None, traces=None,
    ) -> List[dict]:
        """One structured decision entry per candidate: the dry-run
        trace (current -> proposed), the observed goodput inputs, and
        the reason the tick did or didn't actuate.  ``applied``: the
        per-job actuation outcome from ``_actuate``; ``stop_steps``:
        the coordinator-stamped stop step read back after a scale-down
        retarget (None otherwise); ``traces``: the per-job causal-trace
        id this decision minted — with the trainers' flight events
        carrying the same id, the whole decision-to-first-step chain
        reconstructs from the journal alone (``edl trace``).  Appended
        to the bounded ``decision_log`` and journaled to the flight
        recorder (the trace id in the NON-identity trace field, so
        chaos-soak digests stay deterministic)."""
        decisions = []
        for v in candidates:
            d = diff.get(v.name, 0)
            obs = self._observe_goodput(v.name)
            if d > 0:
                reason = f"dry run found headroom: +{d} replicas"
            elif d < 0:
                reason = (
                    "shed for pending demand"
                    if have_pending
                    else f"dry run sheds {-d} replicas"
                )
            else:
                reason = "dry run at fixed point (no diff)"
            outcome = applied.get(v.name)
            if v.name in targets and outcome != "applied":
                reason += f"; actuation {outcome or 'not attempted'}"
            trace_id = (traces or {}).get(v.name, "")
            entry = {
                "job": v.name,
                "dry_run": {
                    "current": v.parallelism,
                    "diff": d,
                    "proposed": targets.get(v.name, v.parallelism),
                },
                "observed": obs,
                "have_pending": have_pending,
                "actuated": outcome == "applied",
                "reason": reason,
                "stop_step": (stop_steps or {}).get(v.name),
                "trace_id": trace_id,
            }
            decisions.append(entry)
            self.decision_log.append(entry)
            data = {k: v2 for k, v2 in entry.items() if k != "trace_id"}
            self._recorder.record(
                "autoscaler.decision", data, trace=trace_id
            )
        del self.decision_log[: -self.decision_log_max]
        return decisions

    def _actuate(
        self, targets: Dict[str, int], diff: Dict[str, int]
    ) -> tuple:
        """ref scaleAllJobs (:339-376); the 5-retry conflict loop lives
        in Cluster.update_parallelism.  Beyond the reference: each PUT
        is paired with the coordinator handshake (SURVEY §7.1 row 4) —
        **retarget-then-PUT on scale-down** so survivors re-form the
        world before the kube Job controller kills pods, PUT-then-
        retarget on scale-up so the target grows once pods can exist.
        Scale-down additionally deletes the *specific* pods the
        coordinator dropped from the plan (pod name == EDL_POD_NAME ==
        member id) before the PUT: the reference let the kube Job
        controller choose its own victims (``pkg/autoscaler.go:
        339-376``), which can kill an active-world member and turn a
        graceful resize into a lease-timeout + replay."""
        import sys

        from edl_tpu_torch.cluster.cluster import ParallelismUpdateError
        from edl_tpu_torch.telemetry.trace import new_trace_id

        applied: Dict[str, str] = {}
        #: job -> the stop_step the coordinator stamped into the
        #: retargeted plan (scale-downs; read back for the decision log)
        stop_steps: Dict[str, Optional[int]] = {}
        #: job -> the causal-trace id THIS decision minted; it rides
        #: the prewarm hint and the retarget into ElasticPlan.trace_id,
        #: so every member journals the whole resize under it
        traces: Dict[str, str] = {}
        for name, parallelism in targets.items():
            job = self.jobs.get(name)
            if job is None:
                applied[name] = "job gone"
                continue
            trace_id = new_trace_id()
            traces[name] = trace_id
            # Prewarm announcement FIRST — before any retarget or PUT:
            # the plan carries the incoming world size while trainers
            # still step at the current one (the JAX trainers compile
            # it ahead; the port's record the hint: eager PyTorch has
            # no step to compile).  Purely advisory and best-effort.
            self._announce_prewarm(job, parallelism, trace_id)
            scale_down = diff.get(name, 0) < 0
            if scale_down:
                client = self._retarget(job, parallelism, trace_id)
                if client is not None:
                    # ONE plan fetch serves both the decision-log stamp
                    # and the victim choice: the journaled stop_step and
                    # the deleted pods must come from the SAME plan (a
                    # rebuild during the quiesce wait would otherwise
                    # desync them), and the coordinator round-trip isn't
                    # paid twice.
                    plan = None
                    try:
                        plan = client.plan()
                    except Exception:
                        pass  # decision still logs, without the stamp
                    if plan is not None:
                        stop_steps[name] = getattr(
                            plan, "stop_step", None
                        )
                    self._delete_dropped_members(job, client, plan=plan)
            try:
                self.cluster.update_parallelism(job, parallelism)
            except ParallelismUpdateError as e:
                # Conflict storm outlasted the bounded retry policy:
                # skip THIS job this tick (the dry run recomputes from
                # live state in 5s) instead of crashing the whole tick.
                print(
                    f"[edl-autoscaler] parallelism PUT for {name} -> "
                    f"{parallelism} gave up ({e}); retrying next tick",
                    file=sys.stderr,
                )
                applied[name] = "PUT gave up (retrying next tick)"
                continue
            applied[name] = "applied"
            self._m_actuations.inc(
                direction="down" if scale_down else "up"
            )
            if not scale_down:
                self._retarget(job, parallelism, trace_id)
        return applied, stop_steps, traces

    def _announce_prewarm(
        self, job: TrainingJob, world: int, trace_id: str = ""
    ) -> None:
        """POST the planned next parallelism to the job's coordinator
        (``/prewarm``), carrying this decision's causal-trace id.
        Tolerates clients without the endpoint (injected test doubles,
        older coordinators) — the hint is advisory, a failure to
        deliver it must never block the actuation."""
        try:
            client = self._coord_client(job)
            hint = getattr(client, "set_prewarm", None)
            if hint is not None:
                try:
                    hint(world, trace_id=trace_id)
                except TypeError:
                    hint(world)  # pre-tracing client/double
        except Exception:
            pass  # the resize still works without the hint

    def _retarget(self, job: TrainingJob, world: int, trace_id: str = ""):
        """POST the new target world to the job's coordinator.  Returns
        the client on success, None on failure.  Failure is tolerated
        (the coordinator may still be scheduling) but LOGGED — a
        persistently unreachable coordinator (bad Service, NetworkPolicy)
        must be visible; the controller's level-triggered
        ``reconcile_targets`` converges the handshake on a later tick.
        ``trace_id`` stamps the retargeted plan (ElasticPlan.trace_id)."""
        import sys

        try:
            client = self._coord_client(job)
            try:
                client.set_target_world(world, trace_id=trace_id)
            except TypeError:
                client.set_target_world(world)  # pre-tracing double
            return client
        except Exception as e:
            print(
                f"[edl-autoscaler] retarget {job.name} -> world {world} "
                f"failed (coordinator unreachable?): {e}",
                file=sys.stderr,
            )
            return None

    def _wait_for_quiesce(self, client) -> None:
        """See ``wait_for_world_ack``; a timeout proceeds to deletion."""
        wait_for_world_ack(client, self.victim_drain_timeout)

    def _delete_dropped_members(
        self, job: TrainingJob, client, plan=None, quiesce: bool = True
    ) -> List[str]:
        """Delete the pods whose member ids are registered but no
        longer in the plan's rank order (the scale-down victims the
        coordinator just chose).  Sequenced AFTER the retargeted world
        quiesces (``_wait_for_quiesce``) so the victims leave the old
        world at the consensus-agreed stop boundary before their pods
        are SIGTERMed.  ``plan``: the retargeted plan the caller
        already fetched (victims and the journaled stop_step must come
        from the same plan).  ``quiesce=False``: the caller already
        waited for the ack (the fleet market's ``wait_drain``).  Best
        effort: a failure here only degrades to the reference's behavior
        (kube picks the victim)."""
        import sys

        if quiesce:
            self._wait_for_quiesce(client)
        try:
            if plan is None:
                plan = client.plan()
            members = client.members()
        except Exception as e:
            print(
                f"[edl-autoscaler] victim query for {job.name} failed: {e}",
                file=sys.stderr,
            )
            return []
        active = set(plan.members) if plan is not None else set()
        victims = sorted(m for m in members if m not in active)
        deleted = []
        for v in victims:
            try:
                if self.cluster.delete_pod(v):
                    deleted.append(v)
            except Exception as e:
                print(
                    f"[edl-autoscaler] deleting victim pod {v} failed: {e}",
                    file=sys.stderr,
                )
        return deleted

    # -- the loop (ref Run, :451-485) ----------------------------------------
    def run(self):
        while not self._stop.is_set():
            try:
                self.run_once()
            except Exception:  # keep the loop alive, like the ref's log+continue
                import traceback

                traceback.print_exc()
            self._stop.wait(self.loop_seconds)

    def stop(self):
        self._stop.set()
