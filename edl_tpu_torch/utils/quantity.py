"""Kubernetes-style resource quantity parsing (the port's own copy of
``edl_tpu/utils/quantity.py``).

The reference reads trainer resource quantities through client-go's
``resource.Quantity`` (``pkg/autoscaler.go:39-52`` —
``TrainerGPULimit``/``TrainerCPURequestMilli``/``TrainerMemRequestMega``)
and sums them with ``AddResourceList`` (``pkg/utils.go:23-34``).  We keep
quantities as plain strings in specs and normalize at the edge:

- CPU      -> integer **millicores** ("250m" -> 250, "2" -> 2000)
- memory   -> integer **mebibytes**  ("1Gi" -> 1024, "500M" -> ~477)
- gpu      -> integer device count

No kubernetes client library is required.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Union

Quantity = Union[str, int, float]

# k8s suffix multipliers, decimal + binary.  Ref semantics: client-go
# resource.Quantity (vendored in the reference; not reimplemented here —
# we support the common subset used in TrainingJob specs).
_DECIMAL = {"": 1, "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15, "E": 10**18}
_BINARY = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}

_QTY_RE = re.compile(r"^\s*([+-]?[0-9]*\.?[0-9]+)\s*([a-zA-Z]*)\s*$")


def _split(q: Quantity) -> tuple[float, str]:
    if isinstance(q, (int, float)):
        return float(q), ""
    m = _QTY_RE.match(q)
    if not m:
        raise ValueError(f"invalid quantity: {q!r}")
    return float(m.group(1)), m.group(2)


def parse_cpu_milli(q: Quantity) -> int:
    """CPU quantity -> millicores (reference: TrainerCPURequestMilli,
    ``pkg/autoscaler.go:44-47``: ``q.ScaledValue(resource.Milli)``)."""
    if q in ("", None):
        return 0
    value, suffix = _split(q)
    if suffix == "m":
        return int(round(value))
    if suffix in _DECIMAL:
        return int(round(value * _DECIMAL[suffix] * 1000))
    if suffix in _BINARY:
        return int(round(value * _BINARY[suffix] * 1000))
    raise ValueError(f"invalid cpu quantity: {q!r}")


def parse_quantity_bytes(q: Quantity) -> int:
    """Memory quantity -> bytes."""
    if q in ("", None):
        return 0
    value, suffix = _split(q)
    if suffix in _BINARY:
        return int(round(value * _BINARY[suffix]))
    if suffix in _DECIMAL:
        return int(round(value * _DECIMAL[suffix]))
    if suffix == "m":  # milli-bytes: legal in k8s, round up to bytes
        return int(math.ceil(value / 1000.0))
    raise ValueError(f"invalid memory quantity: {q!r}")


def parse_memory_mega(q: Quantity) -> int:
    """Memory quantity -> MiB (reference: TrainerMemRequestMega,
    ``pkg/autoscaler.go:49-52``: ``q.ScaledValue(resource.Mega)`` — the
    reference uses decimal mega; we use MiB uniformly on both the spec
    and inventory sides, so comparisons stay consistent)."""
    return parse_quantity_bytes(q) // (2**20)


def parse_count(q: Quantity) -> int:
    """Integer device count (GPUs).  Reference: TrainerGPULimit
    ``pkg/autoscaler.go:39-42``."""
    if q in ("", None):
        return 0
    value, suffix = _split(q)
    if suffix not in ("",):
        raise ValueError(f"device count must be a bare integer: {q!r}")
    if value != int(value):
        raise ValueError(f"device count must be integral: {q!r}")
    if value < 0:
        raise ValueError(f"device count must be >= 0: {q!r}")
    return int(value)


def format_cpu_milli(milli: int) -> str:
    return f"{milli}m"


def format_memory_mega(mega: int) -> str:
    return f"{mega}Mi"


def add_resource_list(a: Dict[str, int], b: Mapping[str, int]) -> Dict[str, int]:
    """Element-wise addition of normalized resource dicts into ``a``.

    Reference: ``AddResourceList`` (``pkg/utils.go:23-34``) — same
    semantics (keys absent in ``a`` are inserted), minus the reference's
    redundant double-write quirk (SURVEY.md §2.1 quirks)."""
    for name, v in b.items():
        a[name] = a.get(name, 0) + v
    return a
