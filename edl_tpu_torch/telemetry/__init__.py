"""``edl_tpu_torch.telemetry`` — the port's metrics registry, flight
recorder and cluster aggregation (counterpart of ``edl_tpu.telemetry``).

- ``registry``: process-local counters / gauges / bounded histograms
  with catalog-enforced names, Prometheus text exposition and
  mergeable snapshots.
- ``recorder``: the flight recorder — a (step, generation)-stamped
  event journal with an order-independent digest and an optional
  JSONL spill (``EDL_FLIGHT_RECORDER_FILE``).
- ``aggregate``: the coordinator-side merge of cumulative per-source
  snapshots, and the quantile and goodput reads of that merge.
- ``trace``: causal-trace ids, clock alignment, and the merged
  Chrome-trace timeline ``edl trace`` writes.

Process-global default instances live here; ``scoped()`` swaps them
for a ``with`` block so tests get hermetic telemetry.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

from edl_tpu_torch.telemetry.aggregate import (
    TelemetryAggregator,
    coord_snapshot_gauges,
    histogram_quantile,
)
from edl_tpu_torch.telemetry.catalog import CATALOG, KNOWN_EVENT_KINDS
from edl_tpu_torch.telemetry.recorder import FlightEvent, FlightRecorder
from edl_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    merge_snapshots,
    render_prometheus,
)
from edl_tpu_torch.telemetry.spans import span
from edl_tpu_torch.telemetry.trace import ClockOffsetEstimator, new_trace_id

__all__ = [
    "CATALOG",
    "ClockOffsetEstimator",
    "FlightEvent",
    "FlightRecorder",
    "MetricsRegistry",
    "TelemetryAggregator",
    "coord_snapshot_gauges",
    "get_recorder",
    "get_registry",
    "KNOWN_EVENT_KINDS",
    "histogram_quantile",
    "merge_snapshots",
    "new_trace_id",
    "render_prometheus",
    "scoped",
    "set_recorder",
    "set_registry",
    "span",
]

_lock = threading.Lock()
_registry = MetricsRegistry()
_recorder = FlightRecorder()


def get_registry() -> MetricsRegistry:
    return _registry


def get_recorder() -> FlightRecorder:
    return _recorder


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    global _registry
    with _lock:
        old, _registry = _registry, registry
    return old


def set_recorder(recorder: FlightRecorder) -> FlightRecorder:
    global _recorder
    with _lock:
        old, _recorder = _recorder, recorder
    return old


@contextmanager
def scoped(registry=None, recorder=None):
    """Swap the process-global registry and recorder for the block.
    Yields (registry, recorder)."""
    reg = registry if registry is not None else MetricsRegistry()
    rec = recorder if recorder is not None else FlightRecorder()
    old_reg = set_registry(reg)
    old_rec = set_recorder(rec)
    try:
        yield reg, rec
    finally:
        set_registry(old_reg)
        set_recorder(old_rec)
