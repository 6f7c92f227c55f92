"""Clock alignment for the merged cluster timeline (the
``ClockOffsetEstimator`` of ``edl_tpu/telemetry/trace.py``; the rest of
that module — journals, timelines — comes with the flight recorder).
"""

from __future__ import annotations

from collections import deque
from typing import Optional


class ClockOffsetEstimator:
    """NTP-style offset of a remote (server) clock vs the local one.

    Feed it request/response pairs: ``add(t0, server_time, t1)`` with
    t0/t1 the LOCAL wall clock around the round-trip and
    ``server_time`` the server's wall clock mid-handling.  The classic
    estimate ``offset = server_time - (t0 + t1) / 2`` is exact for
    symmetric network delay and off by at most RTT/2 otherwise, so
    ``offset()`` returns the estimate from the minimum-RTT sample in a
    sliding window — congestion spikes and asymmetric stragglers decay
    out instead of polluting the alignment."""

    def __init__(self, window: int = 32):
        #: (rtt, offset) samples, newest last
        self._samples: deque = deque(maxlen=max(2, window))

    def add(self, t0: float, server_time: float, t1: float) -> float:
        """Record one round-trip sample; returns its raw offset."""
        rtt = max(0.0, float(t1) - float(t0))
        offset = float(server_time) - (float(t0) + float(t1)) / 2.0
        self._samples.append((rtt, offset))
        return offset

    def offset(self) -> Optional[float]:
        """Best current estimate: the min-RTT sample's offset (add to
        LOCAL wall time to get server time).  None until a sample."""
        if not self._samples:
            return None
        return min(self._samples)[1]

    def rtt(self) -> Optional[float]:
        """The filter's minimum observed round-trip (= 2x the bound on
        the offset estimate's error)."""
        if not self._samples:
            return None
        return min(self._samples)[0]

    def sample_count(self) -> int:
        return len(self._samples)


__all__ = ["ClockOffsetEstimator"]
