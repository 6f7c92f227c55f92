"""Job lifecycle: create/ensure/teardown of a job's cluster objects.

The reference's ``TrainingJober`` (``pkg/trainingjober.go``) did this
for trainer Job + pserver RS + master RS — but was **never wired in**
(SURVEY.md §1 "orphaned"; creation happened in the external paddlecloud
server).  Here the lifecycle is owned by the controller, as the
reference's own TODO intended (``pkg/controller.go:115-133``), and a
job is two objects: trainer workload + coordinator.

Semantics kept from the reference: ``ensure`` = bounded retries with a
pause (ref 3 tries x 1s, ``pkg/trainingjober.go:25-28,196-207``);
partial-creation rollback (ref ``:170-189``); ``complete`` tears down
the coordinator but leaves the trainer workload for GC (ref
``Complete`` kept the trainer Job, ``:126-132``); ``destroy`` removes
everything (ref ``:135-140``).
"""

from __future__ import annotations

import time
from typing import Callable

from edl_tpu_torch.cluster.cluster import Cluster
from edl_tpu_torch.resource.training_job import TrainingJob

ENSURE_ATTEMPTS = 3  # ref convertedJobMaxRetryCount (pkg/trainingjober.go:25-28)
ENSURE_PAUSE_SECONDS = 1.0


class JobLifecycle:
    def __init__(
        self,
        cluster: Cluster,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.cluster = cluster
        self._sleep = sleep

    # -- create -------------------------------------------------------------
    def check_and_create(self, job: TrainingJob) -> bool:
        """Create whichever of the job's objects are missing — by
        applying the jobparser's rendered manifests — with rollback of
        this call's creations on failure (ref ``checkAndCreate``,
        ``pkg/trainingjober.go:142-193``)."""
        from edl_tpu_torch.controller.jobparser import parse_to_coordinator

        created = []
        try:
            if self.cluster.kube.get_workload(job.coordinator_name()) is None:
                # record intent BEFORE applying: a mid-apply failure
                # must roll back the partial creation
                created.append(job.coordinator_name())
                self.cluster.kube.apply_manifests(parse_to_coordinator(job))
            if self.cluster.get_trainer_workload(job) is None:
                created.append(job.trainer_job_name())
                self.cluster.create_trainer_workload(job)
            return True
        except Exception:
            for name in created:  # rollback partial creation
                try:
                    if name == job.trainer_job_name():
                        # enumerates per-replica slice Jobs too — a bare
                        # delete_workload would orphan a multi-host
                        # job's partially created mh-trainer-N Jobs
                        self.cluster.delete_trainer_workload(job)
                    else:
                        self.cluster.kube.delete_workload(name)
                except Exception:
                    pass
            return False

    def ensure(self, job: TrainingJob) -> bool:
        """ref ``Ensure`` (``pkg/trainingjober.go:196-207``)."""
        for attempt in range(ENSURE_ATTEMPTS):
            if self.check_and_create(job):
                return True
            if attempt < ENSURE_ATTEMPTS - 1:
                self._sleep(ENSURE_PAUSE_SECONDS)
        return False

    # -- spec update --------------------------------------------------------
    def refresh(self, job: TrainingJob) -> bool:
        """Spec changed on a live job: re-render and re-apply its
        manifests so image/resource/env changes actually reach the
        running workload (the reference applied spec updates to the
        autoscaler's view only).  The actuated parallelism is preserved
        (clamped into the new [min, max]) so a spec edit doesn't stomp
        the autoscaler's plan."""
        from edl_tpu_torch.controller.jobparser import (
            parse_to_coordinator,
            parse_to_trainer_manifests,
        )

        try:
            cur = self.cluster.get_trainer_workload(job)
            p = job.spec.trainer.min_instance
            if cur is not None:
                p = max(
                    job.spec.trainer.min_instance,
                    min(cur.parallelism, job.spec.trainer.max_instance),
                )
            if job.hosts_per_replica() > 1:
                # Re-apply the spec into the EXISTING replica Jobs the
                # clamp keeps (lowest indexes — the same ones
                # update_parallelism and the coordinator keep; rendering
                # range(p) instead would conjure fresh empty low-index
                # Jobs that then displace live high-index replicas).
                have = sorted(
                    int(w.name.rsplit("-", 1)[1])
                    for w in self.cluster._slice_jobs(job)
                )
                self.cluster.kube.apply_manifests(
                    parse_to_trainer_manifests(
                        job, replicas=p, indexes=have[:p] or None
                    )
                )
                # count convergence (creates missing / deletes excess)
                self.cluster.update_parallelism(job, p)
            else:
                self.cluster.kube.apply_manifests(
                    parse_to_trainer_manifests(job, replicas=p)
                )
            self.cluster.kube.apply_manifests(parse_to_coordinator(job))
            return True
        except Exception:
            import traceback

            traceback.print_exc()
            return False

    # -- teardown -----------------------------------------------------------
    def complete(self, job: TrainingJob) -> None:
        """Job finished: drop the coordinator, keep the trainer workload
        for inspection/GC (ref ``Complete``, ``:126-132``)."""
        self.cluster.kube.delete_workload(job.coordinator_name())

    def destroy(self, job: TrainingJob) -> None:
        """Job deleted: remove everything (ref ``Destroy``, ``:135-140``)."""
        self.cluster.kube.delete_workload(job.coordinator_name())
        self.cluster.delete_trainer_workload(job)
