"""The flight recorder: a deterministic, stamped structured journal (a
copy of ``edl_tpu/telemetry/recorder.py``).

Every event that matters to a post-mortem — resizes, retries, chaos
injections, checkpoint saves, transfer summaries, world breaks,
autoscaler decisions — lands here as a ``FlightEvent`` stamped with
(seq, step, generation, kind, data).  The buffer is a bounded ring
(``capacity`` events) with an optional JSONL spill, so a crashed soak
leaves its last N events on disk even when the process dies.

Determinism contract: the *identity* of an event is (step, generation,
kind, canonical-JSON(data)) — ``digest()`` hashes exactly that, as an
order-independent multiset, so two same-seed chaos runs produce the
same digest even when background threads (async saves, heartbeats)
interleave their records differently.  Wall-clock timestamps and
duration measurements are carried in the separate ``wall`` / ``timing``
fields and excluded from the digest: they are diagnostics, not
identity.

Writers that only know *when* (not *where in training*) an event
happened inherit the step/generation from the recorder's context,
which the elastic step loop refreshes at every step boundary.

Trace context: events may carry a cluster-wide ``trace`` id (the
causal-tracing correlation key minted per autoscaler decision /
coordinator plan rebuild, ``edl_tpu_torch.telemetry.trace``).  Like ``wall``
and ``timing`` it is a NON-identity field — trace ids are random, and
including them in ``identity()`` would break the chaos-soak digest
determinism contract.  ``set_trace`` installs an ambient trace id that
stamps every subsequent record until cleared.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

#: default JSONL spill rotation bound (``EDL_FLIGHT_RECORDER_MAX_MB``)
DEFAULT_SPILL_MAX_MB = 64.0

#: after a spill write failure, skip (and count) spill attempts for
#: this many seconds before retrying — a gone disk must not charge an
#: open() syscall to every recorded event
SPILL_RETRY_SECONDS = 5.0


def json_safe(v: Any) -> Any:
    """Coerce arbitrary payload values to something JSON-serializable
    (chaos event args can be rich objects; the journal stores their
    repr rather than failing the injection that carried them)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): json_safe(x) for k, x in v.items()}
    return repr(v)


@dataclass(frozen=True)
class FlightEvent:
    seq: int
    step: int
    generation: int
    kind: str
    data: Dict[str, Any] = field(default_factory=dict)
    #: wall-clock timestamp — diagnostics only, excluded from digest()
    wall: float = 0.0
    #: non-deterministic measurements (durations...), excluded too
    timing: Optional[Dict[str, Any]] = None
    #: causal-trace correlation id (autoscaler decision -> resize);
    #: random per decision, so excluded from identity/digest too
    trace: str = ""

    def identity(self) -> str:
        """The deterministic part, canonically serialized."""
        return json.dumps(
            [self.step, self.generation, self.kind, self.data],
            sort_keys=True,
            separators=(",", ":"),
        )

    def to_dict(self) -> dict:
        d = {
            "seq": self.seq,
            "step": self.step,
            "generation": self.generation,
            "kind": self.kind,
            "data": self.data,
            "wall": self.wall,
        }
        if self.timing:
            d["timing"] = self.timing
        if self.trace:
            d["trace"] = self.trace
        return d


class FlightRecorder:
    """Bounded, thread-safe event journal with optional JSONL spill."""

    def __init__(
        self,
        capacity: int = 2048,
        spill_path: str = "",
        clock=time.time,
        spill_max_mb: Optional[float] = None,
    ):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, capacity))
        self._seq = 0
        self._clock = clock
        self._spill_path = spill_path
        self._spill_f = None
        if spill_max_mb is None:
            spill_max_mb = float(
                os.environ.get(
                    "EDL_FLIGHT_RECORDER_MAX_MB", str(DEFAULT_SPILL_MAX_MB)
                )
            )
        #: rotation bound for the JSONL spill: at most ~2x this many
        #: bytes on disk (live file + one rotated predecessor)
        self._spill_max_bytes = max(1, int(spill_max_mb * (1 << 20)))
        self._spill_bytes = 0
        #: monotonic-ish deadline before which spill attempts are
        #: skipped (set after a write failure — see SPILL_RETRY_SECONDS)
        self._spill_retry_at = 0.0
        #: spill writes dropped (failed or skipped while disabled) —
        #: also published as edl_flight_spill_dropped_total
        self.spill_dropped = 0
        #: (step, generation) ambient context for writers that don't
        #: know their training position (updated by the step loop)
        self._context = (-1, -1)
        #: ambient causal-trace id (see module doc)
        self._trace = ""

    # -- context --------------------------------------------------------------
    def set_context(self, step: int, generation: int) -> None:
        self._context = (step, generation)

    def set_trace(self, trace_id: str) -> None:
        """Install (or clear, with "") the ambient trace id stamped on
        every subsequent record that doesn't pass its own."""
        self._trace = trace_id or ""

    def trace_context(self) -> str:
        return self._trace

    # -- spill ----------------------------------------------------------------
    def spill_to(self, path: str) -> None:
        """(Re)direct the JSONL spill.  Opened lazily on first record."""
        with self._lock:
            if self._spill_f is not None:
                try:
                    self._spill_f.close()
                except Exception:
                    pass
                self._spill_f = None
            self._spill_path = path
            self._spill_bytes = 0
            self._spill_retry_at = 0.0
            if path:
                # The drop counter exists from the moment the spill is
                # on, so a scrape can tell "no drops" from "no spill".
                self._count_spill_drop(0)

    def _count_spill_drop(self, n: int = 1) -> None:
        """Caller holds the lock.  Best-effort catalog counter — the
        registry import is lazy (this module must stay importable
        standalone) and a broken registry must not fail the record."""
        self.spill_dropped += n
        try:
            from edl_tpu_torch import telemetry

            telemetry.get_registry().counter(
                "edl_flight_spill_dropped_total"
            ).inc(n)
        except Exception:
            pass

    def _spill(self, ev: FlightEvent) -> None:
        """Caller holds the lock.  Best-effort: a full/gone disk must
        never fail the event that was being recorded.  A write failure
        no longer disables the spill forever — the drop is counted
        (``edl_flight_spill_dropped_total``) and the spill retries
        after ``SPILL_RETRY_SECONDS``; on success the file rotates at
        ``EDL_FLIGHT_RECORDER_MAX_MB`` (previous generation kept as
        ``<path>.1``) so a long healthy run stays size-bounded."""
        if not self._spill_path:
            return
        if self._spill_retry_at and self._clock() < self._spill_retry_at:
            self._count_spill_drop()
            return
        try:
            if self._spill_f is None:
                self._spill_f = open(self._spill_path, "a", buffering=1)
                try:
                    self._spill_bytes = os.fstat(
                        self._spill_f.fileno()
                    ).st_size
                except OSError:
                    self._spill_bytes = 0
            line = json.dumps(ev.to_dict()) + "\n"
            if self._spill_bytes + len(line) > self._spill_max_bytes:
                self._spill_f.close()
                self._spill_f = None
                os.replace(self._spill_path, self._spill_path + ".1")
                self._spill_f = open(self._spill_path, "a", buffering=1)
                self._spill_bytes = 0
            self._spill_f.write(line)
            self._spill_bytes += len(line)
            self._spill_retry_at = 0.0
        except Exception:
            if self._spill_f is not None:
                try:
                    self._spill_f.close()
                except Exception:
                    pass
                self._spill_f = None
            self._spill_retry_at = self._clock() + SPILL_RETRY_SECONDS
            self._count_spill_drop()

    # -- recording ------------------------------------------------------------
    def record(
        self,
        kind: str,
        data: Optional[Dict[str, Any]] = None,
        step: Optional[int] = None,
        generation: Optional[int] = None,
        timing: Optional[Dict[str, Any]] = None,
        trace: Optional[str] = None,
        wall: Optional[float] = None,
    ) -> FlightEvent:
        """``trace``: explicit causal-trace id (None = the ambient
        ``set_trace`` context).  ``wall``: preserve another recorder's
        original timestamp instead of stamping now (the ingest path —
        re-stamping member events with the coordinator's clock would
        destroy the merged timeline's causal ordering)."""
        ctx_step, ctx_gen = self._context
        with self._lock:
            self._seq += 1
            ev = FlightEvent(
                seq=self._seq,
                step=ctx_step if step is None else int(step),
                generation=ctx_gen if generation is None else int(generation),
                kind=kind,
                data=json_safe(data or {}),
                wall=self._clock() if wall is None else float(wall),
                timing=json_safe(timing) if timing else None,
                trace=self._trace if trace is None else str(trace),
            )
            self._ring.append(ev)
            self._spill(ev)
            return ev

    def ingest(self, events: List[dict], origin: str = "") -> None:
        """Merge already-serialized events from another recorder (the
        coordinator ingests trainer-reported tails).  Stamps fresh
        local seqs; the origin rides in the data, and the source's
        wall/trace are preserved verbatim (timeline + causal-chain
        fidelity)."""
        for d in events:
            data = dict(d.get("data") or {})
            if origin:
                data["origin"] = origin
            self.record(
                d.get("kind", "event"),
                data,
                step=d.get("step", -1),
                generation=d.get("generation", -1),
                timing=d.get("timing"),
                trace=d.get("trace", ""),
                wall=d.get("wall"),
            )

    # -- reads ----------------------------------------------------------------
    def events(self, last: Optional[int] = None) -> List[FlightEvent]:
        with self._lock:
            evs = list(self._ring)
        return evs if last is None else evs[-last:]

    def events_since(self, seq: int) -> List[FlightEvent]:
        with self._lock:
            return [e for e in self._ring if e.seq > seq]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def digest(self) -> int:
        """Order-independent crc32 over every buffered event's
        deterministic identity — the reproducibility check of the
        chaos soak (same seed, same digest)."""
        with self._lock:
            idents = sorted(e.identity() for e in self._ring)
        crc = 0
        for s in idents:
            crc = zlib.crc32(s.encode(), crc)
        return crc
