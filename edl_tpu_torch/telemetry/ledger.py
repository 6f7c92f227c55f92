"""The goodput ledger: an honest wall-clock decomposition of training
(a copy of ``edl_tpu/telemetry/ledger.py``).

Varuna-style elastic systems optimize *goodput* — the fraction of wall
clock actually spent stepping, as opposed to resizing, replaying lost
work, holding at an unformable barrier, or recovering a broken world.
Before this module the autoscaler's decision log saw a step RATE but
had no wall-clock decomposition to read: a job stepping fast 60% of
the time looked identical to one stepping fast 95% of the time.

``GoodputLedger`` is a per-member state machine fed by the elastic
runtime at its existing transition points:

- ``stepping``          dispatching/harvesting fresh steps
- ``staging_stalled``   host blocked assembling/placing a batch (the
                        slice of stepping the async stager exists to
                        hide — carved out via ``note_staging``)
- ``resizing``          inside the resize barrier; refined post-hoc to
                        ``resizing:<phase>`` from the measured
                        ``ResizeEvent.phase_seconds`` (serial phases)
- ``holding``           parked: no formable world / quiesced at the
                        agreed stop / standby
- ``replaying``         re-running steps already completed before a
                        non-graceful resize fell back to a checkpoint
- ``broken``            between a world break and its recovery resize

Time is attributed ONLY at transitions (plus a throttled ``touch`` so
long steady states stay fresh on the telemetry cadence), so the hot
loop pays one monotonic read and a comparison per iteration.  Totals
publish to ``edl_goodput_seconds_total{state=}`` and the rolling
fraction to ``edl_goodput_frac``.  ``goodput_decomposition`` turns
the coordinator's merge of the members' counters into the job-level
decomposition.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from edl_tpu_torch.telemetry.registry import parse_label_key

#: the stepping state — the numerator of the goodput fraction
STEPPING = "stepping"

#: resize phases refined out of the "resizing" bucket (the serial
#: window phases; overlapped background work is not window time)
RESIZE_PHASES = ("flush", "world_formation", "restore")

#: how often (seconds) ``touch`` flushes the current state's elapsed
#: time into the counters without a transition
TOUCH_INTERVAL = 1.0


class GoodputLedger:
    """Transition-clocked wall-time attribution (see module doc)."""

    def __init__(self, registry=None, clock=time.monotonic):
        if registry is None:
            from edl_tpu_torch import telemetry

            registry = telemetry.get_registry()
        self._m_seconds = registry.counter("edl_goodput_seconds_total")
        self._g_frac = registry.gauge("edl_goodput_frac")
        self._clock = clock
        self._state: Optional[str] = None
        self._t: Optional[float] = None
        self._last_touch = 0.0
        #: staging seconds accumulated during the CURRENT stepping
        #: stretch, carved out of it at the next attribution
        self._staged = 0.0
        self.totals: Dict[str, float] = {}

    # -- attribution ---------------------------------------------------------
    def _add(self, state: str, seconds: float) -> None:
        if seconds <= 0.0:
            return
        self.totals[state] = self.totals.get(state, 0.0) + seconds
        self._m_seconds.inc(seconds, state=state)

    def _flush(self, now: float) -> None:
        """Attribute the current stretch up to ``now`` (caller updates
        ``_t``)."""
        if self._state is None or self._t is None:
            return
        elapsed = now - self._t
        if self._state in (STEPPING, "replaying") and self._staged > 0.0:
            staged = min(self._staged, max(0.0, elapsed))
            self._add("staging_stalled", staged)
            self._add(self._state, elapsed - staged)
        else:
            self._add(self._state, elapsed)
        # Staging accumulated in a stretch never leaks into the next
        # one (a carve-out larger than its own stretch would silently
        # shrink a later, unrelated stepping bucket).
        self._staged = 0.0

    def transition(self, state: str) -> None:
        """Enter ``state``; attributes the elapsed stretch to the one
        being left.  Same-state calls are a cheap no-op."""
        if state == self._state:
            return
        now = self._clock()
        self._flush(now)
        self._state = state
        self._t = now
        self._update_frac()

    def note_staging(self, seconds: float) -> None:
        """Host time spent assembling/placing the next batch inside
        the current stepping stretch (carved into ``staging_stalled``
        at the next attribution, keeping totals = wall clock)."""
        if seconds > 0.0:
            self._staged += seconds

    def touch(self) -> None:
        """Throttled mid-state flush so a long stepping stretch keeps
        the published counters (and the telemetry reports riding the
        heartbeat cadence) fresh."""
        now = self._clock()
        if now - self._last_touch < TOUCH_INTERVAL:
            return
        self._last_touch = now
        self._flush(now)
        self._t = now
        self._update_frac()

    def split_resize(self, phases: Optional[Dict[str, float]]) -> None:
        """Refine the just-attributed ``resizing`` bucket into
        ``resizing:<phase>`` using the measured serial phase seconds
        (bounded by what the bucket actually holds — the remainder
        stays plain ``resizing``)."""
        if not phases:
            return
        # Attribute the in-flight stretch first: split_resize is called
        # at the END of the resize window, before the loop transitions
        # out of "resizing" — without a flush the bucket would still be
        # empty and the refinement would have no budget to draw on.
        now = self._clock()
        self._flush(now)
        self._t = now
        budget = self.totals.get("resizing", 0.0)
        for name in RESIZE_PHASES:
            s = float(phases.get(name) or 0.0)
            s = min(s, budget)
            if s <= 0.0:
                continue
            budget -= s
            self.totals["resizing"] = self.totals.get("resizing", 0.0) - s
            self._add(f"resizing:{name}", s)
            # the counter cannot decrement; the decomposition's source
            # of truth for "plain resizing" is total minus the phases
        self._update_frac()

    # -- reads ---------------------------------------------------------------
    def frac(self) -> Optional[float]:
        total = sum(self.totals.values())
        if total <= 0.0:
            return None
        return self.totals.get(STEPPING, 0.0) / total

    def _update_frac(self) -> None:
        f = self.frac()
        if f is not None:
            self._g_frac.set(f)


def goodput_decomposition(snapshot: dict) -> Optional[dict]:
    """Job-level goodput from a (merged) registry snapshot: per-state
    seconds + the stepping fraction.  ``resizing`` phase refinements
    sum INTO the plain ``resizing`` counter too (monotone counters
    can't move time between series), so the total counts the serial
    window once: phases are detail, plain-resizing = bucket - phases.
    None when no ledger ever reported."""
    series = (snapshot.get("counters") or {}).get(
        "edl_goodput_seconds_total"
    )
    if not series:
        return None
    seconds: Dict[str, float] = {}
    for key, v in series.items():
        labels = dict(parse_label_key(key))
        state = labels.get("state", "unknown")
        seconds[state] = seconds.get(state, 0.0) + float(v)
    phase_s = sum(
        v for k, v in seconds.items() if k.startswith("resizing:")
    )
    total = sum(
        v for k, v in seconds.items() if not k.startswith("resizing:")
    )
    if "resizing" in seconds:
        seconds["resizing"] = max(0.0, seconds["resizing"] - phase_s)
    if total <= 0.0:
        return None
    return {
        "seconds": {k: round(v, 6) for k, v in sorted(seconds.items())},
        "total_s": round(total, 6),
        "frac": round(seconds.get(STEPPING, 0.0) / total, 6),
    }
