"""Collective watchdog: a deadline on in-flight step/control futures (a
copy of ``edl_tpu/consensus/watchdog.py``).

gloo collectives have no native timeout: when a peer stands down (or
wedges) mid-step, the survivor's blocking fetch waits forever — the
exact hang the step bus prevents for COORDINATED teardowns.  The
watchdog is the backstop for everything else: each harvest-time fetch
runs on a reusable helper thread with a deadline; on expiry the fetch
thread is abandoned (it is stuck inside the collective — it leaks with
the dead world's handles) and ``CollectiveTimeout`` raises into the
harvest path, where the shared ``_absorb_step_failure`` recovery buries
the world and holds for a fresh generation instead of hanging until the
job's timeout.

Chaos: ``consensus.watchdog.trip`` simulates a wedged collective
deterministically (the fetch reports expiry without waiting), so the
recovery path is testable in any world.

The serving engine reuses the deadline machinery for its dispatch
watchdog: ``chaos_check`` replaces the ``consensus.watchdog.trip`` probe
(with its own ``serve.dispatch.wedged``) and ``on_trip`` replaces the
consensus trip counter and its ``consensus.watchdog`` event with the
reuser's own accounting.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional


class CollectiveTimeout(RuntimeError):
    """An in-flight step/control future missed the watchdog deadline:
    the collective is considered wedged (peer stood down or died
    silently) and the world must be buried and re-formed."""


class CollectiveWatchdog:
    """Deadline-guarded fetches.  ``timeout <= 0`` disables the guard
    (fetches run inline — the single-process default, where a wedge is
    impossible and the thread hop would be pure overhead).

    ``chaos``: a ``FaultSchedule`` whose ``consensus.watchdog.trip``
    the fetch consults.  A reuser outside the consensus lane (the
    serving engine's dispatch watchdog) keeps the deadline machinery but
    swaps the names: ``chaos_check()`` replaces that probe and
    ``on_trip(what, waited)`` counts its trips instead of the consensus
    counter and event."""

    def __init__(
        self,
        timeout: float = 0.0,
        chaos=None,
        registry=None,
        recorder=None,
        chaos_check: Optional[Callable[[], bool]] = None,
        on_trip: Optional[Callable[[str, float], None]] = None,
    ):
        from edl_tpu_torch import telemetry

        self.timeout = timeout
        self.chaos = chaos
        self.registry = registry if registry is not None else telemetry.get_registry()
        self.recorder = recorder if recorder is not None else telemetry.get_recorder()
        self._m_trips = self.registry.counter(
            "edl_consensus_watchdog_trips_total"
        )
        self.chaos_check = chaos_check
        self.on_trip = on_trip
        self.trips = 0
        self._lock = threading.Lock()
        self._q: Optional[queue.SimpleQueue] = None
        self._worker: Optional[threading.Thread] = None

    # -- worker --------------------------------------------------------------
    def _ensure_worker(self) -> queue.SimpleQueue:
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._q = queue.SimpleQueue()
                self._worker = threading.Thread(
                    target=self._loop,
                    args=(self._q,),
                    daemon=True,
                    name="edl-collective-fetch",
                )
                self._worker.start()
            return self._q

    @staticmethod
    def _loop(q: queue.SimpleQueue) -> None:
        while True:
            task = q.get()
            if task is None:
                return
            fn, box, done = task
            try:
                box["val"] = fn()
            except BaseException as e:  # delivered to the waiter
                box["err"] = e
            done.set()

    def _abandon_worker(self) -> None:
        """The worker is stuck inside a wedged collective: forget it
        (the thread leaks with the dead world — un-joinable by design)
        and let the next fetch start fresh."""
        with self._lock:
            self._worker = None
            self._q = None

    def _trip(self, what: str, waited: float) -> None:
        self.trips += 1
        if self.on_trip is not None:
            # the reuser's own accounting (the serving dispatch
            # watchdog's counter and serve.watchdog event)
            self.on_trip(what, waited)
            return
        self._m_trips.inc()
        self.recorder.record(
            "consensus.watchdog", {"what": what, "waited_s": round(waited, 3)}
        )

    # -- the guarded fetch ---------------------------------------------------
    def fetch(self, fn: Callable, what: str = "step"):
        """Run ``fn`` (a blocking fetch) under the deadline.  Raises
        ``CollectiveTimeout`` on expiry or a due
        ``consensus.watchdog.trip`` chaos event; otherwise returns
        ``fn()``'s value (exceptions propagate unchanged)."""
        chaos = self.chaos
        tripped = (
            self.chaos_check()
            if self.chaos_check is not None
            else chaos is not None and chaos.due("consensus.watchdog.trip")
        )
        if tripped:
            # chaos[consensus.watchdog.trip] (or the reuser's probe): the
            # collective is wedged.  Report expiry without calling fn (a
            # dead world's future has no value).
            self._trip(what, 0.0)
            raise CollectiveTimeout(
                f"chaos: {what} fetch treated as wedged (deterministic "
                "watchdog trip)"
            )
        if self.timeout <= 0:
            return fn()
        q = self._ensure_worker()
        box: dict = {"val": None, "err": None}
        done = threading.Event()
        q.put((fn, box, done))
        if not done.wait(self.timeout):
            self._abandon_worker()
            self._trip(what, self.timeout)
            raise CollectiveTimeout(
                f"{what} future missed the {self.timeout}s collective "
                "watchdog deadline (wedged allreduce? peer stood down "
                "without agreement?)"
            )
        if box["err"] is not None:
            raise box["err"]
        return box["val"]
