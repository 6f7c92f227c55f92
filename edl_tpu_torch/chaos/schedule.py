"""Deterministic, seeded fault schedule: the clock of every chaos run
(counterpart of ``edl_tpu/chaos/schedule.py``).

Every failure gets a **name**, a **step** and a **seed**:

- A ``FaultEvent`` is (step, point, arg): at or after global training
  step ``step``, injection point ``point`` fires once with payload
  ``arg``.
- A ``FaultSchedule`` holds the seed, the event list and the current
  step (advanced at step boundaries).  Consumers pull their due events
  with ``due(point)``; one-shot delivery makes a replayed schedule fire
  the identical faults at the identical steps.
- ``roll`` / ``rng`` derive per-point deterministic randomness from the
  seed for rate-based faults.  They draw what the JAX package's draw,
  bit for bit: the same ``crc32(f"{seed}:{point}:{n}")`` and the same
  per-point counters.

``KNOWN_POINTS`` lists the injection points the port consults (docs and
typo guard): the JAX package's tuple without the four ``fabric.*``
points of the sharded checkpoint fabric, which is not ported.
"""

from __future__ import annotations

import random
import threading
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Type

#: every injection point threaded through the port;
#: ``FaultSchedule(strict=True)`` rejects events naming anything else.
KNOWN_POINTS = (
    # (1) coordinator membership (chaos.membership + chaos.monkey)
    "coord.heartbeat.drop",      # swallow the next N heartbeats
    "coord.heartbeat.delay",     # back-date a member's lease by arg s
    "coord.restart",             # coordinator process restart (state loss)
    "member.kill",               # trainer pod dies mid-step (arg: id)
    "member.die_with_state",     # kill + device state loss -> replay
    "member.restart",            # killed trainer rejoins (arg: id)
    "scale.target",              # autoscaler retarget (arg: world)
    # (2) coord_service HTTP transport (chaos.transport)
    "transport.refuse",          # next N requests: connection refused
    "transport.timeout",         # next N requests: socket timeout
    "transport.slow",            # next request delayed arg seconds
    "transport.torn",            # next N responses: truncated JSON
    # (3) checkpoint store (chaos.storage + hostdram hooks)
    "checkpoint.save_thread",    # async save worker dies
    "checkpoint.corrupt",        # flip bytes in the newest snapshot
    "checkpoint.spill",          # spill-dir I/O error
    "flush.spill.slow",          # resize flush's bg hash/spill stalls arg s
    # (3b) streaming restore transfer (checkpoint.transfer)
    "transfer.chunk.torn",       # flip a byte in one received chunk
    "transfer.chunk.slow",       # stall the source arg s before a send
    # (4) kube actuation (chaos.kubeapi)
    "kube.conflict",             # next N update_workload: ConflictError
    "kube.hold",                 # job's pods stick Pending (arg: job)
    "kube.release",              # release a held job (arg: job)
    # (5) prewarm hint (runtime.elastic._note_prewarm)
    "prewarm.hint.dropped",      # autoscaler prewarm hint lost en route
    # (6) steady-state batch stager (runtime.data.BatchStager)
    "stage.batch.slow",          # background stager stalls arg seconds
    "stage.batch.failed",        # stager worker fails one batch (the
                                 # consumer stages it synchronously and
                                 # loses no step)
    # (7) data-plane step agreement (consensus + elastic)
    "consensus.vote.delayed",    # member's plan poll suppressed arg s
                                 # at a retarget (the poll-skew race the
                                 # step bus makes harmless)
    "consensus.watchdog.trip",   # next guarded fetch treated as a
                                 # wedged collective (deadline expiry
                                 # without the wait)
    # (8) inference serving (serving.engine / batcher)
    "serve.swap.torn",           # corrupt the hot-swap candidate's bytes
                                 # (latest_verified rejects it and the
                                 # engine keeps serving old weights)
    "serve.request.slow",        # batcher worker stalls arg s before a
                                 # dispatch
    "serve.queue.full",          # force one admission rejection
    # (8b) serving-plane fault tolerance (serving.server / engine)
    "serve.replica.die",         # replica killed mid-generation, no
                                 # drain: clients retry on survivors
    "serve.dispatch.wedged",     # next prefill/chunk/decode dispatch
                                 # treated as wedged (pool rebuild +
                                 # re-prefill)
    "serve.drain.slow",          # drain wait stalls arg s per poll
    "serve.coord.unreachable",   # the serving coordinator vanishes for
                                 # arg seconds: serve on, reconverge
    # (8c) live KV sequence migration (serving.migrate)
    "serve.migrate.kill",        # source dies mid-push
    "serve.migrate.torn",        # one received KV chunk corrupted
    "serve.migrate.exhausted",   # dest KV pool refuses the offer
    "serve.migrate.swap",        # a hot swap lands between grant and
                                 # adoption: re-prefill, never mix
    # (8d) content-addressed KV prefix cache (serving.prefix)
    "serve.prefix.evicted",      # force-evict arg (default 1) LRU
                                 # cached prefix blocks
    "serve.prefix.hash.skew",    # a lookup's chain hash treated as
                                 # colliding: a miss, never wrong K/V
    # (8e) fleet front door (serving.router)
    "route.backend.refused",     # next proxy attempt refused
    "route.probe.fail",          # next /healthz probe forced to fail
    "route.stream.cut",          # a relayed stream torn after its next
                                 # token line: re-drive on a survivor
)


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: at or after step ``step``, point ``point``
    fires once with payload ``arg`` (trainer id, duration, count...)."""

    step: int
    point: str
    arg: Any = None


class FaultSchedule:
    """Seed + step-indexed event list; every chaos run driven by the
    same schedule is bit-reproducible.

    Thread-safe: transport wrappers consult it from retry loops and the
    checkpoint store from its save threads while the training loop
    advances the step."""

    def __init__(
        self,
        seed: int = 0,
        events: Sequence[FaultEvent] = (),
        strict: bool = True,
    ):
        self.seed = seed
        if strict:
            for ev in events:
                if ev.point not in KNOWN_POINTS:
                    raise ValueError(
                        f"unknown injection point {ev.point!r} "
                        f"(known: {', '.join(KNOWN_POINTS)})"
                    )
        # Stable order: (step, original index), so same-step events fire
        # in authoring order on every run.
        self._events: List[FaultEvent] = [
            ev for _, ev in sorted(enumerate(events), key=lambda t: (t[1].step, t[0]))
        ]
        self._lock = threading.Lock()
        self._now = -1
        self._draws: Dict[str, int] = {}
        self._fired: List[FaultEvent] = []

    # -- clock ---------------------------------------------------------------
    def advance(self, step: int) -> None:
        """Move the chaos clock to global training step ``step``
        (monotonic; called at each step boundary)."""
        with self._lock:
            if step > self._now:
                self._now = step

    @property
    def now(self) -> int:
        with self._lock:
            return self._now

    # -- event delivery ------------------------------------------------------
    def due(self, point: str, step: Optional[int] = None) -> List[FaultEvent]:
        """Pop (one-shot) every not yet fired event for ``point`` whose
        step is <= the chaos clock (or an explicit ``step``).  Every
        delivered fault is journaled as a ``chaos`` flight event and
        counted in ``edl_chaos_injections_total{point=}``, so a soak
        failure can be reconstructed from telemetry alone."""
        with self._lock:
            now = self._now if step is None else step
            hits = [ev for ev in self._events if ev.point == point and ev.step <= now]
            for ev in hits:
                self._events.remove(ev)
            self._fired.extend(hits)
        if hits:
            from edl_tpu_torch import telemetry

            rec = telemetry.get_recorder()
            counter = telemetry.get_registry().counter("edl_chaos_injections_total")
            for ev in hits:
                counter.inc(point=ev.point)
                rec.record(
                    "chaos",
                    {"point": ev.point, "scheduled_step": ev.step, "arg": ev.arg},
                    step=now,
                )
        return hits

    def pending(self) -> List[FaultEvent]:
        """Events not delivered yet (a finished soak asserts this is
        empty: every scheduled fault actually fired)."""
        with self._lock:
            return list(self._events)

    def fired(self) -> List[FaultEvent]:
        with self._lock:
            return list(self._fired)

    def maybe_raise(self, point: str, exc: Type[BaseException] = RuntimeError) -> None:
        """Raise ``exc`` if an event for ``point`` is due: the hook shape
        production code embeds (one branch, no cost without chaos)."""
        if self.due(point):
            raise exc(f"chaos[{point}] injected at step {self.now}")

    # -- derived determinism -------------------------------------------------
    def roll(self, point: str, p: float) -> bool:
        """Deterministic Bernoulli(p) draw for ``point``: the n-th draw
        of a point is a pure function of (seed, point, n)."""
        with self._lock:
            n = self._draws.get(point, 0)
            self._draws[point] = n + 1
        h = zlib.crc32(f"{self.seed}:{point}:{n}".encode()) / 2**32
        return h < p

    def rng(self, point: str) -> random.Random:
        """A fresh per-point ``random.Random`` stream derived from the
        seed (for fault payloads such as delay durations)."""
        return random.Random(zlib.crc32(f"{self.seed}:{point}".encode()))


__all__ = ["KNOWN_POINTS", "FaultEvent", "FaultSchedule"]
