"""Spans: one name, two sinks — the profiler trace AND the metrics (a
copy of ``edl_tpu/telemetry/spans.py``).

``span("resize/flush")`` wraps the body in
``torch.profiler.record_function`` (a named range when a
``torch.profiler`` trace is live, cheap otherwise) and, on exit,
observes the duration into the ``edl_span_seconds{span=...}``
histogram, so a phase seen in a trace and a phase seen on ``/metrics``
carry the same name.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


@contextmanager
def span(name: str, registry=None):
    """Timed, trace-annotated region.  ``registry`` defaults to the
    process-global one at call time (so a test's scoped registry wins
    even for code that imported this module earlier)."""
    import torch

    if registry is None:
        from edl_tpu_torch.telemetry import get_registry

        registry = get_registry()
    hist = registry.histogram("edl_span_seconds")
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        try:
            yield
        finally:
            hist.observe(time.perf_counter() - t0, span=name)
