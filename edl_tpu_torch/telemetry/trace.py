"""Cluster-wide causal tracing: one trace id from autoscaler decision
to first post-resize step, and one merged Perfetto timeline (a copy of
``edl_tpu/telemetry/trace.py``).

Six PRs built per-process journals (flight recorders, resize phase
breakdowns, consensus events) that every cross-process question —
"which member quiesced late?", "where did the resize regression come
from?" — had to answer by hand-merging inside individual tests.  This
module is the instrument that merges them:

- **Trace context**: the autoscaler mints a ``trace_id`` per actuation
  decision (``new_trace_id``); it rides the ``/prewarm`` hint and the
  retarget PUT into ``ElasticPlan.trace_id``, which every member's
  resize path installs as the flight recorder's ambient trace
  (``FlightRecorder.set_trace``) — so the decision, the plan rebuild,
  the consensus votes/stop/quiesce, the flush/transfer/restore, and
  the first post-resize step all journal under ONE id.  Plan rebuilds
  with no pending decision (joins, evictions) mint their own, so every
  resize is traceable.  Trace ids live in the events' NON-identity
  fields: chaos-soak journal digests stay bit-identical with tracing
  on.

- **Clock alignment**: ``ClockOffsetEstimator`` derives each member's
  wall-clock offset vs the coordinator NTP-style from heartbeat
  request/response pairs (client stamps t0/t1, server returns its
  time; ``offset = server - (t0+t1)/2``, min-RTT filtered so an
  asymmetric or congested sample cannot dominate).  Members report
  their estimate on the telemetry cadence; the merger shifts each
  member's events onto the coordinator timeline before ordering.

- **Merged timeline**: ``merge_events`` + ``chrome_trace`` turn the
  coordinator journal plus the member journals/spills into one
  Chrome-trace/Perfetto JSON — pid = member (lane per member), tid =
  subsystem (resize / consensus / checkpoint / ...), duration slices
  from events that carry ``timing`` (a resize's phase breakdown
  renders as nested slices), instants for everything else.  Open the
  file at ui.perfetto.dev or chrome://tracing.

Everything here is stdlib-only: the merger must run in a post-mortem
CLI (``edl trace``) on a machine with nothing installed.
"""

from __future__ import annotations

import json
import uuid
from collections import deque
from typing import Dict, List, Optional, Tuple

# The serial resize-window phases, shared with the goodput ledger so
# the Perfetto child slices and the resizing:<phase> decomposition can
# never silently desync when a phase is added/renamed in elastic.py.
from edl_tpu_torch.telemetry.ledger import RESIZE_PHASES as _SERIAL_PHASES

__all__ = [
    "ClockOffsetEstimator",
    "chrome_trace",
    "load_journal",
    "member_streams",
    "merge_events",
    "new_trace_id",
    "subsystem_of",
    "trace_chains",
]


def new_trace_id() -> str:
    """Mint a causal-trace correlation id (one per autoscaler decision
    / coordinator plan rebuild)."""
    return uuid.uuid4().hex[:16]


# ---------------------------------------------------------------------------
# clock alignment
# ---------------------------------------------------------------------------
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


# ---------------------------------------------------------------------------
# journal loading / splitting
# ---------------------------------------------------------------------------
def load_journal(path: str) -> List[dict]:
    """Read a flight-recorder JSONL spill (tolerates a torn final line
    — crashed pods tear their last write)."""
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue  # torn tail line
    return out


def member_streams(
    events: List[dict], coordinator: str = "coordinator"
) -> Dict[str, List[dict]]:
    """Split a coordinator journal into per-member streams: ingested
    member tails carry ``data.origin`` (``FlightRecorder.ingest``);
    everything else is the coordinator's own lane."""
    streams: Dict[str, List[dict]] = {}
    for ev in events:
        origin = (ev.get("data") or {}).get("origin") or coordinator
        streams.setdefault(origin, []).append(ev)
    return streams


def subsystem_of(kind: str) -> str:
    """The timeline lane (tid) an event kind renders on: its first
    dotted segment (``consensus.vote`` -> ``consensus``); bare kinds
    map to themselves (``resize`` -> ``resize``)."""
    return kind.split(".", 1)[0] if kind else "event"


# ---------------------------------------------------------------------------
# the merger
# ---------------------------------------------------------------------------
def merge_events(
    streams: Dict[str, List[dict]],
    offsets: Optional[Dict[str, float]] = None,
) -> List[dict]:
    """Merge per-member event streams onto one causally-ordered
    timeline.  Each returned event is a copy with two added fields:
    ``member`` (its lane) and ``wall_aligned`` (its wall clock shifted
    by the member's estimated offset onto the coordinator timeline).
    Sorted by ``wall_aligned`` with (member, seq) as the tiebreak, so
    same-instant events order deterministically."""
    offsets = offsets or {}
    merged: List[dict] = []
    for member, evs in streams.items():
        off = float(offsets.get(member) or 0.0)
        for ev in evs:
            e = dict(ev)
            e["member"] = member
            e["wall_aligned"] = float(e.get("wall") or 0.0) + off
            merged.append(e)
    merged.sort(
        key=lambda e: (
            e["wall_aligned"],
            e["member"],
            int(e.get("seq") or 0),
        )
    )
    return merged


#: overlapped background phases: parallel slices from the window start
#: (the serial phases render back-to-back — see _SERIAL_PHASES above)
_OVERLAP_PHASES = ("compile", "flush_bg")


def _event_args(ev: dict) -> dict:
    args = {
        "step": ev.get("step"),
        "generation": ev.get("generation"),
    }
    if ev.get("trace"):
        args["trace"] = ev["trace"]
    for k, v in (ev.get("data") or {}).items():
        args[k] = v
    return args


def chrome_trace(
    events: List[dict], trace_id: str = ""
) -> dict:
    """Render merged events (``merge_events`` output) as a Chrome
    trace / Perfetto JSON document: pid = member, tid = subsystem,
    ``X`` duration slices for events carrying ``timing.seconds``
    (ending at the event's wall stamp — flight events journal at
    completion), nested phase slices for resizes, ``i`` instants for
    everything else.  ``trace_id`` filters to one causal chain."""
    if trace_id:
        events = [e for e in events if e.get("trace") == trace_id]
    out: List[dict] = []
    pids: Dict[str, int] = {}
    tids: Dict[Tuple[str, str], int] = {}
    if events:
        base = min(e["wall_aligned"] for e in events)
    else:
        base = 0.0

    def us(t: float) -> float:
        return round((t - base) * 1e6, 1)

    def pid(member: str) -> int:
        p = pids.get(member)
        if p is None:
            p = pids[member] = len(pids) + 1
            out.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": p,
                    "args": {"name": member},
                }
            )
        return p

    def tid(member: str, subsystem: str) -> int:
        key = (member, subsystem)
        t = tids.get(key)
        if t is None:
            t = tids[key] = (
                len([k for k in tids if k[0] == member]) + 1
            )
            out.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid(member),
                    "tid": t,
                    "args": {"name": subsystem},
                }
            )
        return t

    for ev in events:
        member = ev["member"]
        kind = ev.get("kind") or "event"
        sub = subsystem_of(kind)
        p, t = pid(member), tid(member, sub)
        end = ev["wall_aligned"]
        timing = ev.get("timing") or {}
        seconds = timing.get("seconds")
        args = _event_args(ev)
        if seconds:
            start = end - float(seconds)
            out.append(
                {
                    "name": kind,
                    "ph": "X",
                    "pid": p,
                    "tid": t,
                    "ts": us(start),
                    "dur": round(float(seconds) * 1e6, 1),
                    "args": args,
                }
            )
            phases = timing.get("phases") or {}
            cursor = start
            for ph_name in _SERIAL_PHASES:
                s = phases.get(ph_name)
                if not s:
                    continue
                out.append(
                    {
                        "name": f"{kind}/{ph_name}",
                        "ph": "X",
                        "pid": p,
                        "tid": t,
                        "ts": us(cursor),
                        "dur": round(float(s) * 1e6, 1),
                        "args": {"phase": ph_name},
                    }
                )
                cursor += float(s)
            for ph_name in _OVERLAP_PHASES:
                s = phases.get(ph_name)
                if not s:
                    continue
                # Overlapped background work: parallel slice on its
                # own lane so the overlap (join << duration) is the
                # visible shape, not a fabricated serialization.
                out.append(
                    {
                        "name": f"{kind}/{ph_name}",
                        "ph": "X",
                        "pid": p,
                        "tid": tid(member, f"{sub}/overlap"),
                        "ts": us(start),
                        "dur": round(float(s) * 1e6, 1),
                        "args": {"phase": ph_name, "overlapped": True},
                    }
                )
        else:
            out.append(
                {
                    "name": kind,
                    "ph": "i",
                    "pid": p,
                    "tid": t,
                    "ts": us(end),
                    "s": "t",  # thread-scoped instant
                    "args": args,
                }
            )
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def trace_chains(events: List[dict]) -> Dict[str, List[dict]]:
    """Group merged events by trace id (the causal chains); untraced
    events are dropped.  Each chain keeps the merged order."""
    chains: Dict[str, List[dict]] = {}
    for ev in events:
        t = ev.get("trace")
        if t:
            chains.setdefault(t, []).append(ev)
    return chains
