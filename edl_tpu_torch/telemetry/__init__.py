"""``edl_tpu_torch.telemetry`` — the port's metrics registry.

A process-global default registry lives here; ``scoped()`` swaps it for
a ``with`` block so tests get hermetic metrics.  The flight recorder
and cluster aggregation come with later slices.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

from edl_tpu_torch.telemetry.catalog import CATALOG
from edl_tpu_torch.telemetry.registry import MetricsRegistry, render_prometheus

__all__ = [
    "CATALOG",
    "MetricsRegistry",
    "get_registry",
    "render_prometheus",
    "scoped",
    "set_registry",
]

_lock = threading.Lock()
_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    global _registry
    with _lock:
        old, _registry = _registry, registry
    return old


@contextmanager
def scoped(registry=None):
    """Swap the process-global registry for the block.  Yields it."""
    reg = registry if registry is not None else MetricsRegistry()
    old = set_registry(reg)
    try:
        yield reg
    finally:
        set_registry(old)
