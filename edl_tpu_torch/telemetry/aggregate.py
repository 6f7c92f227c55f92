"""Coordinator-side telemetry aggregation + goodput derivation (a copy
of ``edl_tpu/telemetry/aggregate.py``).

Trainers ship CUMULATIVE registry snapshots (not deltas) keyed by
(trainer_id, seq): the aggregator keeps the latest snapshot per source
and merges on read, which makes delivery idempotent — a re-sent or
out-of-order report changes nothing, and a restarted coordinator
(empty aggregator) reconverges to the exact pre-restart merge as soon
as each live trainer's next report lands.  That is the same
crash-recovery shape the membership plane already has (trainers
re-register on heartbeat KeyError).

From the merged view the aggregator derives the two goodput signals
the autoscaler's decision log records:

- ``step_rate``: observed cluster steps/s, from a short ring of
  (clock, merged edl_steps_total) points — survives report jitter and
  needs no trainer-side clocks to agree.
- ``resize_cost_seconds``: mean observed resize-window seconds
  (``edl_resize_seconds`` sum/count).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional, Tuple

from edl_tpu_torch.telemetry.registry import merge_snapshots

#: coordinator snapshot key (LocalCoordinator.metrics()) -> gauge name
COORD_GAUGES = {
    "generation": "edl_generation",
    "world_size": "edl_world_size",
    "members": "edl_members",
    "standby": "edl_standby_members",
    "target_world": "edl_target_world",
    "prewarm": "edl_prewarm_world",
    "target_steps": "edl_target_steps",
    "latest_checkpoint_step": "edl_latest_checkpoint_step",
    "resizes": "edl_plan_rebuilds",
    "completed": "edl_completed",
    "completed_step": "edl_completed_step",
}


def coord_snapshot_gauges(metrics: dict) -> dict:
    """Map the coordinator's JSON snapshot onto cataloged gauge series
    (a snapshot-shaped dict mergeable with trainer telemetry)."""
    gauges = {}
    for key, name in COORD_GAUGES.items():
        if key in metrics:
            gauges[name] = {"": float(metrics[key])}
    return {"counters": {}, "gauges": gauges, "histograms": {}}


def histogram_quantile(hist: Optional[dict], q: float) -> Optional[float]:
    """Prometheus-style quantile estimate from one snapshot-shaped
    histogram series ``{"buckets", "counts", "sum", "count"}`` (or a
    dict of label-keyed series, which are merged first — the serving
    latency histogram is unlabeled, but a merged snapshot may carry an
    overflow series).  Linear interpolation within the winning bucket;
    observations in the +Inf bucket clamp to the largest finite bound
    (the standard histogram_quantile() behavior).  None when empty."""
    if not hist:
        return None
    if "counts" not in hist:  # label-keyed dict of series: merge
        series = [h for h in hist.values() if h and h.get("count")]
        if not series:
            return None
        buckets = list(series[0]["buckets"])
        counts = [0.0] * (len(buckets) + 1)
        for h in series:
            if list(h["buckets"]) != buckets:
                continue  # bucket-schema skew: skip (rolling upgrade)
            for i, c in enumerate(h["counts"]):
                counts[i] += c
        hist = {"buckets": buckets, "counts": counts,
                "count": sum(counts)}
    total = hist.get("count") or sum(hist["counts"])
    if not total:
        return None
    rank = max(0.0, min(1.0, q)) * total
    cum = 0.0
    buckets = hist["buckets"]
    for i, c in enumerate(hist["counts"][: len(buckets)]):
        prev_cum = cum
        cum += c
        if cum >= rank and c > 0:
            lo = buckets[i - 1] if i > 0 else 0.0
            hi = buckets[i]
            return lo + (hi - lo) * ((rank - prev_cum) / c)
    return float(buckets[-1]) if buckets else None


class TelemetryAggregator:
    """Latest-cumulative-snapshot-per-source merge (see module doc)."""

    def __init__(self, clock=time.monotonic, rate_window: int = 32):
        self._clock = clock
        #: trainer_id -> (boot, seq, snapshot).  ``boot`` is a
        #: per-process nonce: a RESTARTED trainer restarts its seq at 1
        #: under a fresh boot, and must not be mistaken for a stale
        #: replay of the old incarnation (whose seq may be thousands).
        self._by_source: Dict[str, Tuple[str, int, dict]] = {}
        #: per-source (clock, steps_total) observations — rates are
        #: derived per source then summed, so a membership change (or
        #: a coordinator restart re-learning sources one by one) never
        #: attributes one source's whole history to a short window
        self._rate_window = max(2, rate_window)
        self._rate_points: Dict[str, deque] = {}
        #: source -> latest reported clock info ({"offset", "rtt"}) —
        #: the NTP-style wall-clock alignment the timeline merger uses
        #: (``telemetry.trace.ClockOffsetEstimator``, client-side)
        self._clock_info: Dict[str, dict] = {}
        self.reports = 0

    def report(
        self,
        source: str,
        snapshot: dict,
        seq: int = 0,
        boot: str = "",
        clock: Optional[dict] = None,
    ) -> bool:
        """Store ``source``'s cumulative snapshot.  Returns False (and
        changes nothing) when ``seq`` is not newer than what's stored
        for the same boot — the idempotence half of the contract.  A
        DIFFERENT boot always wins: the process restarted, its new
        cumulative stream replaces the dead incarnation's.  ``clock``:
        the source's estimated wall-clock offset vs this coordinator
        (kept per source for the merged-timeline alignment)."""
        prev = self._by_source.get(source)
        if prev is not None and boot == prev[0] and seq <= prev[1]:
            return False
        if prev is not None and boot != prev[0]:
            # fresh incarnation: its counter stream restarts too
            self._rate_points.pop(source, None)
        self._by_source[source] = (boot, int(seq), snapshot or {})
        if clock:
            self._clock_info[source] = dict(clock)
        self.reports += 1
        self._rate_points.setdefault(
            source, deque(maxlen=self._rate_window)
        ).append((self._clock(), self._steps_of(source)))
        return True

    def _steps_of(self, source: str) -> float:
        snap = self._by_source[source][2]
        series = (snap.get("counters") or {}).get("edl_steps_total") or {}
        return sum(series.values())

    def drop_source(self, source: str) -> None:
        """Forget ``source``'s snapshot, rate window, and clock info —
        the heartbeat-lease eviction hook.  A dead
        (never-drained) serving replica's last report is frozen at its
        moment of death: its queue-depth gauge pins the merged max
        forever and its histogram sits in every quantile window — a
        ghost p95 that an autoscaling lane would keep scaling on.
        Eviction is the membership plane saying "this source is gone";
        the telemetry plane must agree.  A replica that was evicted
        while actually alive re-registers on its next heartbeat and
        re-reports its CUMULATIVE snapshot — the same reconvergence
        contract as a coordinator restart, so dropping is always
        safe."""
        self._by_source.pop(source, None)
        self._rate_points.pop(source, None)
        self._clock_info.pop(source, None)

    def merged(self) -> dict:
        return merge_snapshots(
            [snap for _, _, snap in self._by_source.values()]
        )

    def sources(self) -> Dict[str, int]:
        return {src: seq for src, (_, seq, _) in self._by_source.items()}

    # -- goodput signals ------------------------------------------------------
    def step_rate(self) -> Optional[float]:
        """Observed steps/s: the SUM of per-source rates over each
        source's report window (None until some source has two spaced
        reports).  Per-source on purpose — a global total would spike
        when a restarted coordinator/trainer re-learns history in one
        report."""
        rates = []
        for pts in self._rate_points.values():
            if len(pts) < 2:
                continue
            (t0, s0), (t1, s1) = pts[0], pts[-1]
            if t1 > t0:
                rates.append(max(0.0, (s1 - s0) / (t1 - t0)))
        return sum(rates) if rates else None

    def resize_cost_seconds(
        self, merged: Optional[dict] = None
    ) -> Optional[float]:
        """Mean observed resize seconds.  ``merged``: pass an
        already-computed ``merged()`` to avoid re-merging."""
        m = merged if merged is not None else self.merged()
        hist = (m.get("histograms") or {}).get("edl_resize_seconds") or {}
        total = sum(h["sum"] for h in hist.values())
        count = sum(h["count"] for h in hist.values())
        return (total / count) if count else None

    def goodput(self, merged: Optional[dict] = None) -> Optional[dict]:
        """Job-level goodput decomposition (per-state seconds + the
        stepping fraction) from the members' merged
        ``edl_goodput_seconds_total`` counters; None until some member
        reported a ledger."""
        from edl_tpu_torch.telemetry.ledger import goodput_decomposition

        m = merged if merged is not None else self.merged()
        return goodput_decomposition(m)

    def clock_offsets(self) -> Dict[str, Optional[float]]:
        """Latest per-source wall-clock offset estimate (seconds to add
        to the member's wall to land on this coordinator's timeline)."""
        return {
            src: info.get("offset")
            for src, info in self._clock_info.items()
        }
