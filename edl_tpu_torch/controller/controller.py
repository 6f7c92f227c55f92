"""L4 controller: the event plane + job status state machine
(counterpart of ``edl_tpu/controller/controller.py``).

The reference controller (``pkg/controller.go``) watches the
TrainingJob CRD through an informer and forwards add/update/delete to
the autoscaler (``:110-147``) — and that is *all*: creation was a
logged TODO (``:115-133``) and ``TrainingJobStatus`` was never written
(SURVEY.md §5.5).  This controller fixes both, as the reference's own
comments say it should:

- **wired creation/teardown** via ``JobLifecycle`` on add/delete,
- **a real status state machine** Created -> Running -> (Scaling) ->
  Succeed/Failed, driven from pod counts each reconcile, including the
  pending-time metric.

The watch source is injected as a plain callback registry so local
mode, tests, and a real CRD informer (kubectl watch) all drive the same
object.

Not ported yet: the multi-job GPU market (the JAX controller's
``_fleet_inventory`` / ``_maybe_attach_fleet``, which hand jobs with
``spec.priority > 0`` to ``edl_tpu.fleet``'s arbiter once two of them
are live).  Until ROADMAP A-4 brings it, this controller refuses a
second live prioritized job with ``NotImplementedError`` rather than
planning it in the single-cluster lane, which the JAX controller never
does.  The watch (``watch.TrainingJobWatcher``) hands such a refusal,
and a ``ValidationError``, to ``refuse`` for that CR alone.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from edl_tpu_torch.autoscaler.scaler import Autoscaler
from edl_tpu_torch.cluster.cluster import Cluster
from edl_tpu_torch.controller.lifecycle import JobLifecycle
from edl_tpu_torch.resource.training_job import JobState, TrainingJob


class Controller:
    def __init__(
        self,
        cluster: Cluster,
        autoscaler: Optional[Autoscaler] = None,
        lifecycle: Optional[JobLifecycle] = None,
        clock: Callable[[], float] = time.time,
        coord_client_factory=None,
    ):
        self.cluster = cluster
        self.autoscaler = autoscaler or Autoscaler(cluster)
        self.lifecycle = lifecycle or JobLifecycle(cluster)
        self.jobs: Dict[str, TrainingJob] = {}
        self._clock = clock
        self._stop = threading.Event()
        # One handshake transport for the whole control plane: default
        # to the autoscaler's factory so injecting it there (tests,
        # non-HTTP transports) covers the controller's half too.
        self._coord_client = (
            coord_client_factory or self.autoscaler._coord_client
        )
        #: spec updates whose manifest re-apply failed; retried per tick
        self._pending_refresh: set = set()
        #: last status payload pushed to each CR (avoid a PATCH per tick)
        self._pushed_status: Dict[str, str] = {}
        #: jobs whose coordinator handshake is currently failing (each
        #: outage logs once; cleared on recovery)
        self._handshake_down: set = set()

    # -- the multi-job GPU market (not ported: ROADMAP A-4) -----------------
    def _refuse_fleet_market(self, incoming: Optional[TrainingJob] = None) -> None:
        """Raise where the JAX controller would hand jobs to the fleet
        market: two or more live jobs with ``spec.priority > 0``
        (``incoming`` counts as one of them)."""
        live = {
            name
            for name, job in self.jobs.items()
            if job.spec.priority > 0
            and job.status.state not in (JobState.SUCCEED, JobState.FAILED)
        }
        if incoming is not None:
            live.discard(incoming.name)
            if incoming.spec.priority > 0:
                live.add(incoming.name)
        if len(live) >= 2:
            raise NotImplementedError(
                f"jobs {sorted(live)} carry spec.priority > 0: prioritized "
                "jobs share a GPU market (edl_tpu.fleet in the JAX package) "
                "that the PyTorch port has not ported yet (ROADMAP A-4, the "
                "fleet market); drop the priority of all but one job"
            )

    def refuse(self, manifest: dict, err: Exception) -> None:
        """Record a CR event the controller refused (``on_add`` /
        ``on_update`` raised ``ValidationError`` or
        ``NotImplementedError``) so the other jobs go on.  A job that
        is already running keeps its old spec and carries the refusal
        in its status message; a new one gets a Failed status on its
        CR, since no object of it was created."""
        meta = manifest.get("metadata") or {}
        name = meta.get("name", "")
        msg = f"refused: {err}"
        print(f"[edl] TrainingJob {name}: {msg}", flush=True)
        job = self.jobs.get(name)
        if job is not None:
            job.status.message = msg
            return
        payload = {"state": JobState.FAILED.value, "parallelism": 0, "running": 0,
                   "pending": 0, "message": msg}
        try:
            self.cluster.kube.update_training_job_status(
                name, payload, namespace=meta.get("namespace") or None
            )
        except Exception:
            pass  # the message is logged; the CR stays as it was

    # -- event handlers (ref onAdd/onUpdate/onDelete, :110-147) --------------
    def on_add(self, job: TrainingJob) -> TrainingJob:
        """Validate, create cluster objects, hand to the autoscaler
        (the reference only logged here — its TODO, ``:115-133``).
        Raises ``NotImplementedError`` for a second live prioritized
        job (see the module docstring)."""
        job = job.validate()
        self._refuse_fleet_market(job)
        job.status.state = JobState.CREATED
        job.status.submitted_at = self._clock()
        job.status.parallelism = job.spec.trainer.min_instance
        if not self.lifecycle.ensure(job):
            job.status.state = JobState.FAILED
            job.status.message = "failed to create trainer/coordinator objects"
            self.jobs[job.name] = job
            return job
        self.jobs[job.name] = job
        self.autoscaler.on_add(job)
        return job

    def on_update(self, job: TrainingJob) -> None:
        job = job.validate()
        self._refuse_fleet_market(job)
        old = self.jobs.get(job.name)
        if old is not None:
            job.status = old.status
        spec_changed = old is None or old.spec != job.spec
        self.jobs[job.name] = job
        if job.status.state in (JobState.SUCCEED, JobState.FAILED):
            # Terminal: a spec edit must not re-enroll the job in the
            # autoscaler or resurrect the coordinator that
            # mark_succeeded/complete already tore down.
            return
        self.autoscaler.on_update(job)
        if spec_changed:
            # Re-render + re-apply so image/resource changes reach the
            # running workload (parallelism preserved).
            # A failed apply queues for level-triggered retry each tick —
            # the next watch event carries the same spec, so the edge
            # alone would lose the update forever.
            if not self.lifecycle.refresh(job):
                self._pending_refresh.add(job.name)
            else:
                self._pending_refresh.discard(job.name)

    def on_delete(self, job: TrainingJob) -> None:
        self.autoscaler.on_del(job)
        self.lifecycle.destroy(job)
        self.jobs.pop(job.name, None)
        # A resubmitted job with an identical status must hit the fresh
        # CR: drop the dedup key with the job.  Same for the handshake
        # outage marker — a new job's outage must log again.
        self._pushed_status.pop(job.name, None)
        self._pending_refresh.discard(job.name)
        self._handshake_down.discard(job.name)

    # -- status reconciliation (what the reference never did) ----------------
    def reconcile_status(
        self,
        pods_by_job: Optional[Dict] = None,
        workloads: Optional[Dict] = None,
    ) -> None:
        """Refresh every job's status from observed cluster state.
        ``pods_by_job`` / ``workloads``: share one pod-list and one
        workload-list snapshot across the tick's passes (each list is a
        kubectl subprocess on a real cluster; per-job gets would make
        the tick O(jobs))."""
        if pods_by_job is None:
            pods_by_job = self.cluster.job_pods_map()
        if workloads is None:
            workloads = self.cluster.trainer_workloads_map()
        for job in list(self.jobs.values()):
            if job.status.state in (JobState.SUCCEED, JobState.FAILED):
                continue
            w = workloads.get(job.name)
            if w is None:
                job.status.state = JobState.FAILED
                job.status.message = "trainer workload disappeared"
                self._freeze_pending_clock(job)
                continue
            total, running, pending, succeeded = pods_by_job.get(
                job.name, (0, 0, 0, 0)
            )
            job.status.parallelism = w.parallelism
            job.status.running = running
            job.status.pending = pending
            if total > 0 and succeeded == total:
                # Every trainer pod ran to completion (RestartPolicy
                # Never): the job is done — the terminal-pods completion
                # path (ref Complete, pkg/trainingjober.go:126-132).
                self.mark_succeeded(job.name)
                continue
            if job.status.state == JobState.CREATED and running > 0:
                job.status.state = JobState.RUNNING
                job.status.started_at = self._clock()
            elif job.status.state == JobState.RUNNING and pending > 0:
                job.status.state = JobState.SCALING
            elif job.status.state == JobState.SCALING and pending == 0:
                job.status.state = JobState.RUNNING
        self.push_statuses()

    def push_statuses(self) -> None:
        """Write each job's status to its CR's status subresource (only
        when it changed) so ``kubectl get trainingjobs`` reflects the
        controller's state machine — the reference declared
        ``TrainingJobStatus`` and never wrote it (SURVEY.md §5.5)."""
        import json

        for job in self.jobs.values():
            s = job.status
            payload = {
                "state": s.state.value,
                "parallelism": s.parallelism,
                "running": s.running,
                "pending": s.pending,
                "message": s.message,
            }
            key = json.dumps(payload, sort_keys=True)
            if self._pushed_status.get(job.name) == key:
                continue
            try:
                if self.cluster.kube.update_training_job_status(
                    job.name, payload, namespace=job.namespace
                ):
                    self._pushed_status[job.name] = key
            except Exception:
                continue  # next tick retries (level-triggered)

    # -- actuation handshake + completion (coordinator-facing) ---------------
    #: concurrent coordinator probes per tick: each probe can block on
    #: its connect timeout (~1-2s); serial probes would make the tick
    #: O(jobs x timeout)
    PROBE_WORKERS = 8

    def reconcile_targets(
        self,
        pods_by_job: Optional[Dict] = None,
        workloads: Optional[Dict] = None,
    ) -> None:
        """Level-triggered half of the actuation handshake: converge
        every live coordinator's target world onto the observed trainer
        parallelism, and fire completion when a coordinator reports the
        job finished.  The autoscaler POSTs targets eagerly at actuation
        time; this pass repairs any handshake that was lost (coordinator
        still scheduling, transient network) so the two halves cannot
        stay disconnected.  Probes run with bounded
        concurrency, and a RUNNING job whose coordinator stays
        unreachable is logged (once per outage) — a bad Service or
        NetworkPolicy must not be invisible."""
        import sys
        from concurrent.futures import ThreadPoolExecutor

        if pods_by_job is None:
            pods_by_job = self.cluster.job_pods_map()
        if workloads is None:
            workloads = self.cluster.trainer_workloads_map()
        targets = []
        for job in list(self.jobs.values()):
            if job.status.state in (JobState.SUCCEED, JobState.FAILED):
                continue
            if pods_by_job.get(job.name, (0, 0, 0, 0))[1] == 0:
                # No trainer pod running yet: the coordinator is very
                # likely still scheduling too — don't burn the control
                # tick on connect timeouts (each probe can block ~1s).
                continue
            w = workloads.get(job.name)
            if w is None:
                continue
            targets.append((job, w.parallelism))
        if not targets:
            return

        def probe(item):
            job, parallelism = item
            try:
                # Factory contract is job -> client (scaler.py
                # docstring); keyword extras would break injected
                # factories.
                coord = self._coord_client(job)
                m = coord.metrics()
                if m.get("completed"):
                    return (job.name, "completed")
                if m.get("target_world") != parallelism:
                    coord.set_target_world(parallelism)
                return (job.name, "ok")
            except Exception as e:
                return (job.name, f"unreachable: {e}")

        with ThreadPoolExecutor(max_workers=self.PROBE_WORKERS) as pool:
            results = list(pool.map(probe, targets))
        for name, outcome in results:
            if outcome == "completed":
                self.mark_succeeded(name)
            elif outcome == "ok":
                self._handshake_down.discard(name)
            elif name not in self._handshake_down:
                # Log the outage once; clear on recovery so a later
                # outage logs again.  The handshake stays level-
                # triggered — the next tick retries regardless.
                self._handshake_down.add(name)
                print(
                    f"[edl-controller] coordinator handshake for {name} "
                    f"failing while the job has running trainers "
                    f"({outcome})",
                    file=sys.stderr,
                )

    # -- orphan GC (level-triggered, from observed state) --------------------
    def gc_orphans(self, live_cr_names) -> int:
        """Destroy framework-owned workloads whose TrainingJob CR no
        longer exists.  Kubernetes ownerReferences do this natively in a
        real cluster; this pass makes the controller itself converge
        from observed state — a controller restarted after ``edl kill``
        still cleans up (the reference's informers re-listed on start,
        ``pkg/controller.go:79-108``, but it never deleted anything).
        Returns the number of workloads deleted."""
        live = set(live_cr_names)
        deleted = 0
        for w in self.cluster.kube.list_workloads():
            if w.owner and w.owner not in live:
                if self.cluster.kube.delete_workload(w.name):
                    deleted += 1
        return deleted

    def mark_succeeded(self, name: str) -> None:
        """Terminal success (reported by the job's coordinator when the
        pass count completes).  The job leaves the autoscaler's managed
        set — a finished workload must never be rescaled back to life."""
        job = self.jobs.get(name)
        if job is not None:
            job.status.state = JobState.SUCCEED
            self._freeze_pending_clock(job)
            self.autoscaler.on_del(job)
            self.lifecycle.complete(job)
            self._handshake_down.discard(name)

    def _freeze_pending_clock(self, job: TrainingJob) -> None:
        """A job reaching a terminal state without ever being observed
        running must stop accruing pending time, or pending_p50_s would
        grow without bound while the terminal job lingers."""
        if job.status.started_at <= 0:
            job.status.started_at = self._clock()

    # -- run loop (ref Run, :64-76: watch goroutine + autoscaler goroutine) --
    def run_once(self) -> None:
        # One pod-list + one workload-list snapshot serve every pass
        # this tick: the tick costs O(1) kubectl subprocesses however
        # many jobs the controller manages.
        pods = self.cluster.kube.list_pods()
        pods_by_job = self.cluster.job_pods_map(pods)
        pod_nodes = self.cluster.job_pod_nodes_map(pods)
        workloads = self.cluster.trainer_workloads_map()
        self.reconcile_status(pods_by_job, workloads)
        for name in list(self._pending_refresh):
            job = self.jobs.get(name)
            if job is None or self.lifecycle.refresh(job):
                self._pending_refresh.discard(name)
        plan = self.autoscaler.run_once(
            workloads=workloads, pods_by_job=pods_by_job, pod_nodes=pod_nodes
        )
        if plan is not None and plan.targets:
            # The actuation just changed parallelism: re-list (still
            # O(1)) so the handshake below converges on the NEW values —
            # reconciling against the stale snapshot would POST the old
            # target back and force a spurious world resize.
            workloads = self.cluster.trainer_workloads_map()
        self.reconcile_targets(pods_by_job, workloads)

    def run(self, interval: float = 5.0) -> None:
        while not self._stop.is_set():
            try:
                self.run_once()
            except Exception:
                import traceback

                traceback.print_exc()
            self._stop.wait(interval)

    def stop(self) -> None:
        self._stop.set()
        self.autoscaler.stop()

    # -- views ---------------------------------------------------------------
    def job_statuses(self) -> List[dict]:
        out = []
        for job in self.jobs.values():
            s = job.status
            out.append(
                {
                    "name": job.name,
                    "state": s.state.value,
                    "parallelism": s.parallelism,
                    "running": s.running,
                    "pending": s.pending,
                    "pending_seconds": round(
                        s.pending_seconds(now=self._clock()), 3
                    ),
                    "elastic": job.elastic(),
                }
            )
        return out

    def cluster_metrics(self) -> dict:
        """The north-star aggregates: cluster GPU utilization (GPUs in
        use / schedulable) and pending-time p50
        across jobs (seconds from submit to first running pod; still-
        pending jobs contribute their elapsed wait)."""
        import statistics

        r = self.cluster.inquiry_resource()
        now = self._clock()
        waits = [
            j.status.pending_seconds(now=now)
            for j in self.jobs.values()
            if j.status.submitted_at > 0
        ]
        return {
            "gpu_total": r.gpu_total,
            "gpu_in_use": r.gpu_request,
            "gpu_utilization": round(
                r.gpu_request / r.gpu_total if r.gpu_total else 0.0, 4
            ),
            "pending_p50_s": round(statistics.median(waits), 3) if waits else 0.0,
            "jobs": len(self.jobs),
        }
