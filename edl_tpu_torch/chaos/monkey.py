"""The chaos monkey: applies a ``FaultSchedule`` to a live world
(counterpart of ``edl_tpu/chaos/monkey.py``).

``ChaosMonkey`` binds the schedule to the objects that make up one
training world (the trainer, its coordinator, possibly wrapped in
``ChaosCoordinator`` and reached over a chaos HTTP transport, and its
checkpoint store) and delivers the membership and storage events at
step boundaries through ``ElasticTrainer.run(on_step=monkey.on_step)``:

- ``scale.target``: the autoscaler's retarget (arg: new world size).
- ``member.kill``: a trainer pod dies (graceful from the survivors'
  view: their state is intact, the resize flushes).  arg: trainer id.
- ``member.die_with_state``: a death that takes the live state with it
  (host loss mid-step): the next resize falls back to the last interval
  checkpoint and REPLAYS, deterministically, because the data is a pure
  function of (seed, step).  In a world with no ``world_builder`` the
  port's trainer is one process whatever the plan's world size: the
  verb drops that process's state (``ElasticTrainer.inject_failure``)
  and deregisters the member, so the plan's world size and membership
  change as they do in the JAX package's in-process mesh.
- ``member.restart``: a killed trainer rejoins.  arg: trainer id.
- ``checkpoint.corrupt``: silently corrupt the newest stored snapshot
  (``chaos.storage``); the restore must catch it by CRC and fall back.
- ``coord.restart``: the coordinator loses all state; the monkey
  registers again the members it knows are live.

Transport and in-store faults fire at their own injection points; the
monkey only advances the shared chaos clock they read.  Kills
deregister through the coordinator's public API (the graceful-leave
path): eviction by lease timeout is wall-clock driven and has no place
in a bit-reproducible soak.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from edl_tpu_torch.chaos.schedule import FaultSchedule
from edl_tpu_torch.chaos.storage import corrupt_newest


class ChaosMonkey:
    """Step-boundary fault applier.  Pass ``on_step`` to
    ``ElasticTrainer.run``; ``track`` seeds the membership it keeps."""

    def __init__(
        self,
        schedule: FaultSchedule,
        trainer,
        coordinator=None,
        store=None,
        coordinator_factory: Optional[Callable[[], object]] = None,
    ):
        """``coordinator``: the handle the monkey kills and registers
        through (default ``trainer.coordinator``).
        ``coordinator_factory``: builds a fresh inner coordinator for
        ``coord.restart`` (``coordinator`` must then be a
        ``ChaosCoordinator``)."""
        self.schedule = schedule
        self.trainer = trainer
        self.coordinator = coordinator if coordinator is not None else trainer.coordinator
        self.store = store if store is not None else trainer.store
        self.coordinator_factory = coordinator_factory
        self.live: List[str] = []
        self.log: List[tuple] = []  # (step, verb, arg) as applied

    def track(self, member_ids) -> "ChaosMonkey":
        self.live = list(member_ids)
        return self

    # -- the hook ------------------------------------------------------------
    def on_step(self, rec) -> None:
        """``ElasticTrainer.run``'s ``on_step``: advance the chaos clock
        and apply every membership and storage event now due."""
        step = rec.step
        self.schedule.advance(step)
        for ev in self.schedule.due("scale.target"):
            self.coordinator.set_target_world(int(ev.arg))
            self.log.append((step, "scale.target", ev.arg))
        for ev in self.schedule.due("member.kill"):
            self._kill(ev.arg)
            self.log.append((step, "member.kill", ev.arg))
        for ev in self.schedule.due("member.die_with_state"):
            # In-flight saves land first, so the restore point is the
            # deterministic newest interval snapshot.
            self.store.wait()
            self.trainer.inject_failure()
            self._kill(ev.arg)
            self.log.append((step, "member.die_with_state", ev.arg))
        for ev in self.schedule.due("member.restart"):
            if ev.arg not in self.live:
                self.live.append(ev.arg)
            self.coordinator.register(ev.arg)
            self.log.append((step, "member.restart", ev.arg))
        for ev in self.schedule.due("checkpoint.corrupt"):
            # The newest INTERVAL snapshot is the victim (saves are
            # step-indexed, so this is deterministic).
            self.store.wait()
            victim = corrupt_newest(self.store)
            self.log.append((step, "checkpoint.corrupt", victim))
        for ev in self.schedule.due("coord.restart"):
            self._restart_coordinator()
            self.log.append((step, "coord.restart", None))

    # -- verbs ---------------------------------------------------------------
    def _kill(self, member_id: str) -> None:
        if member_id in self.live:
            self.live.remove(member_id)
        # The dead pod stops beating before it stops being registered.
        if member_id in getattr(self.trainer, "heartbeat_ids", ()):
            self.trainer.heartbeat_ids.remove(member_id)
        self.coordinator.deregister(member_id)

    def _restart_coordinator(self) -> None:
        if self.coordinator_factory is None:
            raise ValueError("coord.restart scheduled but no coordinator_factory given")
        target = self.coordinator
        # The restart verb lives on ChaosCoordinator (the server-side
        # wrapper; an HTTP client cannot restart its server).
        restart = getattr(target, "restart", None)
        if restart is None:
            raise TypeError(f"coord.restart needs a ChaosCoordinator (got {type(target).__name__})")
        restart(self.coordinator_factory)
        # The surviving pods register again (their heartbeat KeyError
        # path does it in a deployment; the monkey does it here so the
        # soak stays step-deterministic).
        for tid in self.live:
            target.register(tid)


__all__ = ["ChaosMonkey"]
