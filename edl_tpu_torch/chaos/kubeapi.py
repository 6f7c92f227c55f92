"""Kube actuation chaos: conflict storms and scheduling holds
(counterpart of ``edl_tpu/chaos/kubeapi.py``).

``ChaosKube`` wraps a ``KubeAPI`` (``FakeKube`` or ``KubectlAPI``), so
the control plane's actuation path (``Cluster.update_parallelism`` and
the autoscaler tick above it) runs against the failures a real API
server produces:

- ``kube.conflict``: the next N ``update_workload`` calls raise
  ``ConflictError`` (an optimistic-concurrency storm).  Budgets above
  the retry policy's attempts reach the typed give-up
  (``cluster.ParallelismUpdateError``) the autoscaler logs and skips.
- ``kube.hold`` / ``kube.release``: a job's pods stick ``Pending`` and
  later release.  Needs a ``FakeKube`` inner (its ``hold_pending``).
"""

from __future__ import annotations

from edl_tpu_torch.chaos.schedule import FaultSchedule
from edl_tpu_torch.cluster.kube import ConflictError


class ChaosKube:
    """Delegating ``KubeAPI`` wrapper; pass it anywhere a ``KubeAPI``
    goes (``Cluster(ChaosKube(FakeKube(...), schedule))``)."""

    def __init__(self, inner, schedule: FaultSchedule):
        self._inner = inner
        self.schedule = schedule
        self._conflict_budget = 0
        self.injected_conflicts = 0

    def _pull_events(self) -> None:
        for ev in self.schedule.due("kube.conflict"):
            self._conflict_budget += int(ev.arg or 1)
        for ev in self.schedule.due("kube.hold"):
            self._inner.hold_pending.add(ev.arg)
        released = False
        for ev in self.schedule.due("kube.release"):
            self._inner.hold_pending.discard(ev.arg)
            released = True
        if released and hasattr(self._inner, "retry_scheduling"):
            self._inner.retry_scheduling()

    def update_workload(self, w):
        self._pull_events()
        if self._conflict_budget > 0:
            self._conflict_budget -= 1
            self.injected_conflicts += 1
            raise ConflictError(f"chaos: conflict storm (step {self.schedule.now})")
        return self._inner.update_workload(w)

    def list_pods(self):
        self._pull_events()  # holds and releases land on the read path too
        return self._inner.list_pods()

    def __getattr__(self, name):
        return getattr(self._inner, name)


__all__ = ["ChaosKube"]
