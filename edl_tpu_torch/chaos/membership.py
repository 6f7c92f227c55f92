"""Coordinator membership chaos: lossy heartbeats, coordinator restart
(counterpart of ``edl_tpu/chaos/membership.py``).

``ChaosCoordinator`` wraps a coordinator (``LocalCoordinator`` or the
HTTP client) and perturbs the membership signals the real world
perturbs:

- ``coord.heartbeat.drop``: the next N heartbeats are lost in flight
  (the trainer believes it beat; the lease keeps aging), unlike
  ``transport.refuse``, where the client sees the failure.
- ``coord.heartbeat.delay``: a heartbeat lands, but the member's lease
  is back-dated by ``arg`` seconds (the beat that arrives is old news).
  Needs a ``LocalCoordinator`` inner: lease state is server-side.
- ``restart()``: swap the inner coordinator for a fresh one, the
  coordinator pod restarted and lost ALL membership state.  A
  ``CoordinatorServer`` holding this wrapper keeps serving across the
  swap, like a restarted pod behind a stable Service name.

Trainer kill and restart are the monkey's verbs (``chaos.monkey``):
they act on the wrapped coordinator through its public API.
"""

from __future__ import annotations

from typing import Callable

from edl_tpu_torch.chaos.schedule import FaultSchedule


class ChaosCoordinator:
    """Delegating membership-chaos wrapper with the interface of the
    coordinator it wraps (explicit intercepts + ``__getattr__``)."""

    def __init__(self, inner, schedule: FaultSchedule):
        self._inner = inner
        self.schedule = schedule
        self._drop_budget = 0
        self.dropped_heartbeats = 0
        self.restarts = 0

    # -- chaos verbs ---------------------------------------------------------
    def restart(self, factory: Callable[[], object]) -> None:
        """Coordinator process restart: all membership state is lost.
        ``factory`` builds the replacement (same config, empty state).
        Live trainers must register again, through the monkey (soak) or
        the heartbeat ``KeyError`` -> register path of
        ``ElasticTrainer._beat_once``."""
        self._inner = factory()
        self.restarts += 1

    # -- intercepted coordinator surface -------------------------------------
    def heartbeat(self, trainer_id: str, step: int = -1):
        for ev in self.schedule.due("coord.heartbeat.drop"):
            self._drop_budget += int(ev.arg or 1)
        if self._drop_budget > 0:
            self._drop_budget -= 1
            self.dropped_heartbeats += 1
            return  # lost in flight: the caller sees success, the lease ages
        result = self._inner.heartbeat(trainer_id, step=step)
        # Back-date AFTER the beat lands: the lease reads "last heard
        # arg seconds ago".
        for ev in self.schedule.due("coord.heartbeat.delay"):
            self._backdate(trainer_id, float(ev.arg or 0.0))
        return result

    def _backdate(self, trainer_id: str, seconds: float) -> None:
        """Age a member's lease.  Reaches into ``LocalCoordinator``
        internals on purpose: the lease clock is server-side state with
        no public mutator."""
        inner = self._inner
        members = getattr(inner, "_members", None)
        if members is None:
            raise TypeError(
                "coord.heartbeat.delay needs a LocalCoordinator inner "
                "(lease state is server-side)"
            )
        with inner._lock:
            m = members.get(trainer_id)
            if m is not None:
                m.last_heartbeat -= seconds

    # -- everything else delegates -------------------------------------------
    def __getattr__(self, name):
        return getattr(self._inner, name)


__all__ = ["ChaosCoordinator"]
