"""Continuous batchers: bounded queue, deadline-aware admission, bucket
padding, backpressure, drain (counterpart of
``edl_tpu/serving/batcher.py``).

Orca-style continuous batching: the batch boundary is the scheduling
boundary.  ``ContinuousBatcher`` schedules single-shot requests (the
request IS the iteration); ``TokenContinuousBatcher`` schedules per
TOKEN over a ``DecodeEngine``'s paged KV cache, so requests join and
leave the running batch at token boundaries.

Admission is where backpressure lives: a full queue rejects at once
with a retry-after hint (HTTP 429) instead of buffering without bound,
and a request whose deadline passed while queued is expired, not
computed.  A draining replica rejects with ``DrainingError`` (HTTP 503:
go elsewhere) while everything already admitted runs to its finish.

The hot-swap moment lives here too, between batches and at token
boundaries (``engine.refresh()``): a dispatch in flight bound its
weights when it started, so no output mixes weight generations.

Live migration (``serving/migrate.py``) works through the token
batcher's token-boundary hooks: ``frozen`` parks the worker while a
drain reads the pool, ``detach`` / ``take_cold`` hand sequences off,
``readmit`` takes one back, and ``adopt`` queues a migrated-in sequence
for the worker to place at its next token boundary, after checking the
weights it was produced under.

Chaos (``chaos=``, by default the engine's schedule):
``serve.queue.full`` forces one admission rejection (the 429 path
without a real storm), ``serve.request.slow`` stalls a dispatch by arg
seconds, and the token batcher ticks the prefix cache's
``serve.prefix.evicted`` at each token boundary.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import numpy as np

from edl_tpu_torch.serving.engine import DispatchWedgedError, NotReadyError


class QueueFullError(RuntimeError):
    """Admission rejected: the bounded queue is full.  ``retry_after``
    is the backoff hint (seconds) the HTTP front sends as Retry-After."""

    def __init__(self, msg: str, retry_after: float = 0.05):
        super().__init__(msg)
        self.retry_after = retry_after


class DeadlineExceededError(RuntimeError):
    """The request's deadline passed before it could be served."""


class DrainingError(RuntimeError):
    """Admission closed: the replica is draining.  Distinct from
    ``QueueFullError`` on purpose: the HTTP front maps it to 503 +
    Retry-After (go to another replica; this one is leaving), where a
    full queue is 429 (back off and retry here)."""

    def __init__(self, msg: str = "replica draining: admission closed; "
                 "retry another replica", retry_after: float = 0.5):
        super().__init__(msg)
        self.retry_after = retry_after


class FreezeTimeoutError(RuntimeError):
    """``frozen()`` gave up: the worker did not park at a token boundary
    within ``freeze_timeout`` (a call still running).  Nothing was read
    or written under the freeze; the caller must not touch the pool or
    the batch state."""


class Ticket:
    """One admitted single-shot request's future."""

    __slots__ = (
        "inputs", "rows", "deadline", "enqueued", "_done", "_result",
        "_error",
    )

    def __init__(self, inputs: Dict[str, np.ndarray], rows: int, deadline: float):
        self.inputs = inputs
        self.rows = rows
        self.deadline = deadline
        self.enqueued = time.monotonic()
        self._done = threading.Event()
        self._result: Optional[tuple] = None
        self._error: Optional[BaseException] = None

    def _resolve(self, outputs, meta) -> None:
        self._result = (outputs, meta)
        self._done.set()

    def _reject(self, err: BaseException) -> None:
        self._error = err
        self._done.set()

    def result(self, timeout: Optional[float] = None) -> tuple:
        """Block for (outputs, meta); raises the worker's error."""
        if not self._done.wait(timeout):
            raise TimeoutError("request still in flight")
        if self._error is not None:
            raise self._error
        return self._result


class ContinuousBatcher:
    """Background worker turning admitted requests into padded-bucket
    forward passes on an ``InferenceEngine``."""

    def __init__(
        self,
        engine,
        queue_limit: int = 256,
        default_deadline_s: float = 2.0,
        chaos=None,
    ):
        self.engine = engine
        self.queue_limit = int(queue_limit)
        self.default_deadline_s = float(default_deadline_s)
        self.chaos = chaos if chaos is not None else engine.chaos
        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._stop = False
        #: admission closed (drain): submit raises DrainingError while
        #: queued and dispatching work runs to completion
        self._draining = False
        #: tickets the worker holds (popped, not yet resolved)
        self._busy = 0
        self._thread: Optional[threading.Thread] = None

        from edl_tpu_torch import telemetry

        reg = telemetry.get_registry()
        self._m_requests = reg.counter("edl_serve_requests_total")
        self._m_batches = reg.counter("edl_serve_batches_total")
        self._m_examples = reg.counter("edl_serve_examples_total")
        self._g_depth = reg.gauge("edl_serve_queue_depth")
        self._m_latency = reg.histogram("edl_serve_latency_seconds")
        self._m_occupancy = reg.histogram("edl_serve_batch_occupancy")

    def start(self) -> "ContinuousBatcher":
        with self._cv:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop = False
            self._thread = threading.Thread(
                target=self._work, daemon=True, name="edl-serve-batcher"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
        # Nothing queued survives a stop: resolve, don't strand callers.
        with self._cv:
            pending = list(self._queue)
            self._queue.clear()
            self._g_depth.set(0)
        for t in pending:
            self._m_requests.inc(status="error")
            t._reject(RuntimeError("batcher stopped"))

    @property
    def depth(self) -> int:
        with self._cv:
            return len(self._queue)

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def in_flight(self) -> int:
        """Requests admitted but not yet resolved: queued plus the batch
        the worker holds.  A drain waits for it to reach 0."""
        with self._cv:
            return len(self._queue) + self._busy

    def close_admission(self) -> None:
        """Enter drain: every later ``submit`` raises DrainingError;
        requests already admitted keep computing."""
        with self._cv:
            self._draining = True

    def submit(
        self,
        inputs: Dict[str, Any],
        deadline_s: Optional[float] = None,
    ) -> Ticket:
        """Admit one request (1..max_batch rows).  Raises
        ``QueueFullError`` on backpressure, ``DrainingError`` once
        admission closed for a drain, and ``ValueError`` on a schema
        mismatch — all before the request costs any compute."""
        if self._draining:
            self._m_requests.inc(status="draining")
            raise DrainingError()
        arrays, rows = self.engine.coerce_inputs(inputs)
        if rows < 1:
            raise ValueError("empty request (0 rows)")
        if rows > self.engine.max_batch:
            raise ValueError(
                f"request of {rows} rows exceeds max_batch "
                f"{self.engine.max_batch}; split it client-side"
            )
        budget = (
            deadline_s if deadline_s is not None else self.default_deadline_s
        )
        ticket = Ticket(arrays, rows, time.monotonic() + budget)
        with self._cv:
            if self._draining:
                # Re-checked under the lock: a drain that read in_flight
                # must not see it grow afterwards.
                self._m_requests.inc(status="draining")
                raise DrainingError()
            forced = self.chaos is not None and bool(self.chaos.due("serve.queue.full"))
            if forced or len(self._queue) >= self.queue_limit:
                # chaos[serve.queue.full] forces this branch.
                self._m_requests.inc(status="rejected")
                raise QueueFullError(
                    f"admission queue full ({self.queue_limit}); retry",
                    retry_after=max(0.01, budget / 4),
                )
            self._queue.append(ticket)
            self._g_depth.set(len(self._queue))
            self._cv.notify()
        return ticket

    def _take_batch(self) -> List[Ticket]:
        """Pop whatever is queued up to the largest bucket (no
        artificial wait: the previous batch's compute WAS the window),
        expiring dead requests on the way."""
        taken: List[Ticket] = []
        now = time.monotonic()
        cap = self.engine.max_batch
        rows = 0
        with self._cv:
            while self._queue:
                t = self._queue[0]
                if t.deadline <= now:
                    self._queue.popleft()
                    self._m_requests.inc(status="expired")
                    t._reject(DeadlineExceededError("deadline passed while queued"))
                    continue
                if rows + t.rows > cap:
                    break
                self._queue.popleft()
                taken.append(t)
                rows += t.rows
            self._busy = len(taken)
            self._g_depth.set(len(self._queue))
        return taken

    def _work(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait(timeout=0.5)
                if self._stop:
                    return
            # The hot-swap moment: between batches.  A failure of the
            # swap path costs the swap, never the worker.
            try:
                self.engine.refresh()
            except Exception:
                traceback.print_exc()
            batch = self._take_batch()
            if not batch:
                continue
            if self.chaos is not None:
                for ev in self.chaos.due("serve.request.slow"):
                    # chaos[serve.request.slow]: a slow dispatch inflates
                    # the latency histogram the serving lane scales on.
                    time.sleep(float(ev.arg or 0.05))
            rows = sum(t.rows for t in batch)
            merged = {
                k: np.concatenate([t.inputs[k] for t in batch], axis=0)
                for k in batch[0].inputs
            }
            try:
                outputs, meta = self.engine.predict(merged)
            except Exception as e:
                for t in batch:
                    self._m_requests.inc(status="error")
                    t._reject(e)
                with self._cv:
                    self._busy = 0
                continue
            self._m_batches.inc()
            self._m_examples.inc(rows)
            self._m_occupancy.observe(rows / meta["bucket"])
            now = time.monotonic()
            lo = 0
            for t in batch:
                sl = {k: v[lo : lo + t.rows] for k, v in outputs.items()}
                lo += t.rows
                self._m_requests.inc(status="ok")
                self._m_latency.observe(now - t.enqueued)
                t._resolve(sl, dict(meta))
            with self._cv:
                self._busy = 0


# -- per-token continuous batching -------------------------------------------


class GenerateTicket:
    """One admitted generate request: the prompt, its budget, and the
    future its caller blocks on.  ``on_event`` (optional) streams
    incremental events as the worker emits them:

    - ``{"token": id, "i": n}``     — one generated token
    - ``{"restart": True, ...}``    — new weights voided prior tokens
      (the sequence re-prefills; earlier streamed tokens are not part
      of the final output)
    - ``{"done": True, "tokens": [...], ...meta}`` / ``{"error": ...}``
    """

    __slots__ = (
        "prompt", "max_new", "deadline", "eos_id", "enqueued", "on_event",
        "blocks", "table", "length", "last_token", "tokens", "restarts",
        "last_time", "prefilled", "chunks", "reused_blocks", "first_time",
        "migrated", "_done", "_result", "_error",
    )

    def __init__(
        self,
        prompt: np.ndarray,
        max_new: int,
        deadline: float,
        eos_id: Optional[int],
        on_event=None,
    ):
        self.prompt = prompt
        self.max_new = max_new
        self.deadline = deadline
        self.eos_id = eos_id
        self.enqueued = time.monotonic()
        self.on_event = on_event
        #: owned physical block ids (freed the iteration we finish)
        self.blocks: List[int] = []
        self.table: Optional[np.ndarray] = None
        #: written cache positions (prompt + generated so far)
        self.length = 0
        self.last_token = 0
        self.tokens: List[int] = []
        self.restarts = 0
        self.last_time = 0.0
        #: prompt positions already written by prefill chunks (a weight
        #: swap resets it to 0)
        self.prefilled = 0
        #: prefill calls this request paid (monolithic: one per
        #: prefill; chunked: one per chunk), over restarts too
        self.chunks = 0
        #: KV blocks claimed from the prefix cache at admission (a
        #: restart resets it with ``prefilled``)
        self.reused_blocks = 0
        #: wall time of the FIRST ever emitted token (a restart never
        #: moves it): TTFT spans enqueue to it, over every chunk
        self.first_time: Optional[float] = None
        #: handed to a survivor replica (live KV migration or a cold
        #: requeue): it no longer counts toward the local drain, and
        #: its caller's future resolves through the relay
        self.migrated = False
        self._done = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def _event(self, ev: dict) -> None:
        if self.on_event is not None:
            try:
                self.on_event(ev)
            except Exception:
                self.on_event = None  # a dead stream must not kill the worker

    def _finish(self, meta: Dict[str, Any]) -> None:
        self._result = (list(self.tokens), meta)
        self._event({"done": True, "tokens": list(self.tokens), **meta})
        self._done.set()

    def _reject(self, err: BaseException) -> None:
        self._error = err
        self._event({"error": str(err)})
        self._done.set()

    def result(self, timeout: Optional[float] = None) -> tuple:
        """Block for (tokens, meta); raises the worker's error."""
        if not self._done.wait(timeout):
            raise TimeoutError("generation still in flight")
        if self._error is not None:
            raise self._error
        return self._result


class TokenContinuousBatcher:
    """Per-TOKEN iteration scheduling over a ``DecodeEngine``.

    Each worker iteration:

    1. **weights check** — at the token boundary only.  With
       ``refresh`` the batcher asks the engine for a newer verified
       checkpoint (also while idle, so an idle replica picks up new
       weights too).  A new weight generation, or a lost cache (a new
       ``cache_epoch``), re-prefills every in-flight sequence: its
       partial output is void (streamed as a restart event), and one
       sequence never mixes weight generations.  The prefix index is
       rekeyed first, so nothing filled under the old weights is
       claimed again.
    2. **join** — queued requests are admitted while decode slots last.
       With **chunked prefill** (the default when the model declares a
       ``chunk_fn``) an admitted request enters a FIFO of partly
       prefilled sequences, after claiming from the prefix cache any
       published run its prompt starts with; its prompt is fed through
       chunks under a per-iteration token budget, at most
       ``prefill_token_budget`` prompt tokens beside each decode step,
       so a long admission never stalls the running batch.  It joins
       decode when its last chunk lands (the TTFT moment), and its
       full prompt blocks are published.  With
       ``chunked_prefill=False`` each join pays one monolithic bucketed
       prefill (B1, the flash kernel, on every layer).
    3. **decode** — one token for every active sequence (bucketed by
       count; block tables absorb ragged lengths).  Finished sequences
       (EOS / token budget / context cap / past deadline) resolve and
       release their KV blocks the same iteration; half-prefilled ones
       release theirs at expiry too.

    Admission: bounded queue -> ``QueueFullError`` (HTTP 429 +
    Retry-After); a closed admission (drain) -> ``DrainingError`` (HTTP
    503); queued requests past their deadline expire; a prompt over the
    context cap raises ``PromptTooLongError`` at submit, never
    mid-chunk.
    """

    def __init__(
        self,
        engine,
        queue_limit: int = 256,
        default_deadline_s: float = 30.0,
        default_max_new: int = 16,
        refresh: bool = True,
        chaos=None,
        chunked_prefill: Optional[bool] = None,
        prefill_token_budget: int = 0,
        prefix_cache: Optional[bool] = None,
    ):
        self.engine = engine
        self.queue_limit = int(queue_limit)
        self.default_deadline_s = float(default_deadline_s)
        self.default_max_new = int(default_max_new)
        #: False: another batcher sharing this engine drives refresh();
        #: this one still sees generation changes and re-prefills
        self.refresh = refresh
        self.chaos = chaos if chaos is not None else engine.chaos
        has_chunk = getattr(engine.spec, "chunk_fn", None) is not None
        if chunked_prefill is None:
            chunked_prefill = has_chunk
        elif chunked_prefill and not has_chunk:
            raise ValueError(
                f"model {engine.model.name!r} declares no chunk_fn; "
                "chunked prefill unavailable"
            )
        self.chunked_prefill = bool(chunked_prefill)
        #: prompt tokens one iteration may spend on prefill chunks beside
        #: its decode step (0 -> the engine's max chunk size)
        self.prefill_token_budget = int(
            prefill_token_budget or engine.max_chunk_tokens
        )
        #: content-addressed prefix reuse: chunked mode only (the skip
        #: offset is a chunk offset); on by default with it
        if prefix_cache is None:
            prefix_cache = self.chunked_prefill
        self.prefix = None
        if prefix_cache:
            if not self.chunked_prefill:
                raise ValueError(
                    "prefix_cache requires chunked prefill (the claimed "
                    "run's skip offset is a chunk offset)"
                )
            from edl_tpu_torch.serving.prefix import PrefixCache

            self.prefix = PrefixCache(engine.pool, engine.block_tokens, chaos=self.chaos)
        self._cv = threading.Condition()
        self._queue: deque = deque()
        #: FIFO of admitted, partly prefilled sequences (chunked mode):
        #: the head is fed chunk by chunk under the budget
        self._prefilling: deque = deque()
        #: running counts behind ``queued_prefill_tokens``: queued
        #: prompt tokens (changed under _cv with the queue) and the
        #: FIFO's remaining tokens (worker thread only)
        self._queued_tokens = 0
        self._prefilling_tokens = 0
        self._active: List[GenerateTicket] = []
        #: sequences migrated in (K/V already imported into granted
        #: blocks) awaiting adoption at the next token boundary:
        #: (ticket, weights_step, weights_digest, cache_epoch) entries
        self._adopted: deque = deque()
        self._stop = False
        #: admission closed (drain): submit_generate raises
        #: DrainingError; queued, prefilling and active sequences finish
        self._draining = False
        #: the token-boundary freeze handshake (a migration's export):
        #: the exporter raises _freeze_req, the worker parks and acks,
        #: _resume releases it
        self._freeze_req = threading.Event()
        self._frozen_ack = threading.Event()
        self._resume = threading.Event()
        #: serializes frozen() callers (a drain's export racing an
        #: import would otherwise share one handshake)
        self._freeze_lock = threading.Lock()
        #: seconds frozen() waits for the worker to park before it
        #: raises FreezeTimeoutError
        self.freeze_timeout = 30.0
        self._thread: Optional[threading.Thread] = None
        self._bound_gen = -1
        self._bound_step = -1
        self._bound_epoch = 0  # engine.cache_epoch last observed
        self.stats = {"iterations": 0, "prefills": 0, "swaps": 0,
                      "restarts": 0, "chunks": 0}

        from edl_tpu_torch import telemetry

        reg = telemetry.get_registry()
        self.recorder = telemetry.get_recorder()
        self._m_requests = reg.counter("edl_serve_requests_total")
        self._m_tokens = reg.counter("edl_serve_tokens_total")
        self._m_prefills = reg.counter("edl_serve_prefills_total")
        self._m_iterations = reg.counter("edl_serve_decode_iterations_total")
        self._m_restarts = reg.counter("edl_serve_restarts_total")
        self._g_depth = reg.gauge("edl_serve_decode_queue_depth")
        self._g_active = reg.gauge("edl_serve_active_sequences")
        self._g_kv = reg.gauge("edl_serve_kv_occupancy")
        self._g_kv_bytes = reg.gauge("edl_serve_kv_used_bytes_per_device")
        self._m_ttft = reg.histogram("edl_serve_ttft_seconds")
        self._m_intertoken = reg.histogram("edl_serve_intertoken_seconds")
        self._m_occupancy = reg.histogram("edl_serve_batch_occupancy")
        self._m_chunks = reg.counter("edl_serve_prefill_chunks_total")
        self._m_prefill_tokens = reg.counter("edl_serve_prefill_tokens_total")
        self._g_prefill_queued = reg.gauge("edl_serve_prefill_queued_tokens")
        self._m_stall = reg.histogram("edl_serve_prefill_stall_seconds")

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "TokenContinuousBatcher":
        with self._cv:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop = False
            self._thread = threading.Thread(
                target=self._work, daemon=True, name="edl-serve-decode"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)

    @property
    def depth(self) -> int:
        with self._cv:
            return len(self._queue)

    @property
    def active_count(self) -> int:
        return len(self._active)

    @property
    def prefilling_count(self) -> int:
        return len(self._prefilling)

    @property
    def queued_prefill_tokens(self) -> int:
        """Prompt tokens still awaiting prefill: the chunk FIFO's
        remaining work plus every queued prompt (running counts, so a
        /healthz read never walks a deque the worker is changing)."""
        return self._queued_tokens + self._prefilling_tokens

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def adopted_count(self) -> int:
        with self._cv:
            return len(self._adopted)

    @property
    def in_flight(self) -> int:
        """Sequences admitted but not yet resolved: queued, mid-prefill,
        in the decode batch and migrated in awaiting adoption.  A drain
        waits for it to reach 0; the KV pool then holds no owned block
        (every finish path frees its blocks the same iteration)."""
        with self._cv:
            return (
                len(self._queue) + len(self._prefilling) + len(self._active)
                + len(self._adopted)
            )

    def close_admission(self) -> None:
        """Enter drain: later ``submit_generate`` calls raise
        DrainingError (HTTP 503 + Retry-After); every admitted sequence
        runs to its normal finish and frees its KV blocks."""
        with self._cv:
            self._draining = True

    def pending(self) -> List[GenerateTicket]:
        """The tickets on this batcher's books: queued, mid-prefill,
        decoding and awaiting adoption."""
        with self._cv:
            return (
                list(self._queue) + list(self._prefilling) + list(self._active)
                + [e[0] for e in self._adopted]
            )

    # -- live KV sequence migration -------------------------------------------
    @contextmanager
    def frozen(self):
        """Park the worker at a token boundary and hold it there while a
        migration reads the pool and the batch state: no call can write
        either until the block exits.  The worker resumes even if the
        body raises; if the worker is not running, the state is already
        still.  Raises ``FreezeTimeoutError`` (before the body runs) when
        the worker does not park within ``freeze_timeout`` seconds."""
        with self._freeze_lock:
            if self._thread is None or not self._thread.is_alive():
                yield
                return
            self._resume.clear()
            self._frozen_ack.clear()
            self._freeze_req.set()
            with self._cv:
                self._cv.notify_all()
            if not self._frozen_ack.wait(timeout=self.freeze_timeout):
                # The pools are written in place: reading them while a
                # call may still be writing would hand out torn K/V.
                self._freeze_req.clear()
                self._resume.set()
                raise FreezeTimeoutError(
                    f"the decode worker did not park within "
                    f"{self.freeze_timeout:g} s"
                )
            try:
                yield
            finally:
                self._freeze_req.clear()
                self._resume.set()

    def detach(self, t: GenerateTicket) -> None:
        """Take a decoding sequence out of the batch and free its blocks
        (its K/V is already copied to the host).  The caller holds the
        worker frozen."""
        if t in self._active:
            self._active.remove(t)
        self._free_blocks(t)
        t.migrated = True

    def take_cold(self) -> List[GenerateTicket]:
        """Detach every queued and half-prefilled sequence for a cold
        handoff to a survivor: they streamed nothing, so a requeue there
        prefills the prompt again, with no restart event and no claim on
        the local drain.  The caller holds the worker frozen."""
        out: List[GenerateTicket] = []
        with self._cv:
            while self._queue:
                t = self._queue.popleft()
                self._queued_tokens -= int(t.prompt.shape[0])
                out.append(t)
            self._g_depth.set(0)
        while self._prefilling:
            t = self._prefilling.popleft()
            self._prefilling_tokens -= int(t.prompt.shape[0]) - t.prefilled
            self._free_blocks(t)
            t.prefilled = 0
            t.reused_blocks = 0
            out.append(t)
        for t in out:
            t.migrated = True
        return out

    def readmit(self, t: GenerateTicket) -> None:
        """The fallback ladder's last rung: no survivor took the
        sequence, so it returns to the local queue and the drain waits
        it out.  Streamed tokens are void: it prefills again under the
        local weights."""
        t.migrated = False
        if t.tokens:
            t.restarts += 1
            self.stats["restarts"] += 1
            self._m_restarts.inc()
            t._event({"restart": True, "reason": "migration failed"})
        t.tokens = []
        t.length = 0
        t.last_token = 0
        t.prefilled = 0
        t.reused_blocks = 0
        with self._cv:
            self._queue.appendleft(t)
            self._queued_tokens += int(t.prompt.shape[0])
            self._g_depth.set(len(self._queue))
            self._cv.notify()

    def adopt(
        self,
        t: GenerateTicket,
        weights_step: int,
        weights_digest: int,
        cache_epoch: int,
    ) -> None:
        """Hand a migrated-in sequence (K/V already imported into its
        granted blocks) to the worker for adoption at the next token
        boundary.  ``weights_step`` / ``weights_digest`` name the
        checkpoint the K/V was produced under and ``cache_epoch`` the
        pool it was imported into; the worker checks them at adoption
        and sends any skew to a cold re-prefill.  Runs on the migration
        receiver's thread."""
        with self._cv:
            if self._stop:
                raise RuntimeError("batcher stopped")
            self._adopted.append(
                (t, int(weights_step), int(weights_digest), int(cache_epoch))
            )
            self._cv.notify()

    def _adopt_pending(self, w) -> int:
        """Place migrated-in sequences in the decode batch.  The weights
        check happens here, at the token boundary: if a swap or a pool
        rebuild landed between the import's grant and adoption, the
        imported cache is unusable and the sequence re-prefills cold (a
        restart event, never a token of mixed weights)."""
        adopted = 0
        while True:
            with self._cv:
                if not self._adopted:
                    return adopted
                t, step, digest, epoch = self._adopted.popleft()
            stale = (
                step != w.step or digest != w.digest
                or epoch != self.engine.cache_epoch
            )
            if stale or len(self._active) >= self.engine.max_seqs:
                self._free_blocks(t)
                t.tokens = []
                t.length = 0
                t.last_token = 0
                t.prefilled = 0
                t.reused_blocks = 0
                t.restarts += 1
                t._event(
                    {
                        "restart": True,
                        "weights_generation": w.generation,
                        "weights_step": w.step,
                    }
                )
                self.stats["restarts"] += 1
                self._m_restarts.inc()
                with self._cv:
                    self._queue.appendleft(t)
                    self._queued_tokens += int(t.prompt.shape[0])
                    self._g_depth.set(len(self._queue))
                continue
            t.last_time = time.monotonic()
            self._active.append(t)
            adopted += 1
            if self._seq_finished(t):
                self._finish(t)

    # -- admission ----------------------------------------------------------
    def submit_generate(
        self,
        inputs: Dict[str, Any],
        max_new_tokens: Optional[int] = None,
        deadline_s: Optional[float] = None,
        eos_id: Optional[int] = None,
        on_event=None,
    ) -> GenerateTicket:
        """Admit one autoregressive request (a single prompt row).
        Raises ``QueueFullError`` on backpressure, ``DrainingError``
        once admission closed for a drain, and ``ValueError``
        (``PromptTooLongError`` included) on a schema violation — all
        before any compute."""
        if self._draining:
            self._m_requests.inc(status="draining")
            raise DrainingError()
        prompt = self.engine.coerce_prompt(inputs)
        max_new = int(max_new_tokens or self.default_max_new)
        if max_new < 1:
            raise ValueError(f"max_new_tokens {max_new} < 1")
        budget = (
            deadline_s if deadline_s is not None else self.default_deadline_s
        )
        ticket = GenerateTicket(
            prompt,
            max_new,
            time.monotonic() + budget,
            None if eos_id is None else int(eos_id),
            on_event=on_event,
        )
        with self._cv:
            if self._draining:
                self._m_requests.inc(status="draining")
                raise DrainingError()
            forced = self.chaos is not None and bool(self.chaos.due("serve.queue.full"))
            if forced or len(self._queue) >= self.queue_limit:
                # chaos[serve.queue.full] forces this branch.
                self._m_requests.inc(status="rejected")
                raise QueueFullError(
                    f"admission queue full ({self.queue_limit}); retry",
                    retry_after=max(0.01, budget / 4),
                )
            self._queue.append(ticket)
            self._queued_tokens += int(prompt.shape[0])
            self._g_depth.set(len(self._queue))
            self._cv.notify()
        return ticket

    # -- worker internals ---------------------------------------------------
    def _free_blocks(self, t: GenerateTicket) -> None:
        if t.blocks:
            self.engine.pool.free(t.blocks)
            t.blocks = []
        t.table = None

    def _finish(self, t: GenerateTicket, status: str = "ok") -> None:
        """Resolve + release KV blocks (the SAME iteration the final
        token was emitted)."""
        self._free_blocks(t)
        if t in self._active:
            self._active.remove(t)
        self._m_requests.inc(status=status)
        t._finish(
            {
                "weights_step": self._bound_step,
                "weights_generation": self._bound_gen,
                "restarts": t.restarts,
                "prompt_tokens": int(t.prompt.shape[0]),
                "prefill_chunks": t.chunks,
                "reused_blocks": t.reused_blocks,
                "ttft_s": (
                    round(t.first_time - t.enqueued, 6)
                    if t.first_time is not None
                    else None
                ),
            }
        )

    def _expire(self, t: GenerateTicket) -> None:
        self._free_blocks(t)
        if t in self._active:
            self._active.remove(t)
        self._m_requests.inc(status="expired")
        t._reject(DeadlineExceededError("deadline passed mid-generation"))

    def _restart_active(self, new_gen: int, new_step: int) -> None:
        """New weights landed, or the cache was lost: every in-flight
        sequence re-prefills.  A decoding sequence's tokens so far are
        VOID (streamed as a restart event): continuing its prefix under
        new weights would mix generations within one sequence.
        Half-prefilled sequences restart their chunking from zero too
        (their cache holds old K/V); they streamed nothing, so they get
        no restart event."""
        restarted = list(self._active)
        self._active = []
        rewound = list(self._prefilling)
        self._prefilling.clear()
        self._prefilling_tokens = 0
        for t in rewound + restarted:
            self._free_blocks(t)
            t.prefilled = 0
            t.reused_blocks = 0
        for t in restarted:
            t.tokens = []
            t.length = 0
            t.last_token = 0
            t.restarts += 1
            t._event(
                {
                    "restart": True,
                    "weights_generation": new_gen,
                    "weights_step": new_step,
                }
            )
        # back at the queue's head in arrival order: the half-prefilled
        # were admitted after the decoding ones, both before the queue
        with self._cv:
            for t in reversed(restarted + rewound):
                self._queue.appendleft(t)
                self._queued_tokens += int(t.prompt.shape[0])
            self._g_depth.set(len(self._queue))
        if restarted:
            self.stats["restarts"] += len(restarted)
            self._m_restarts.inc(len(restarted))
            self.recorder.record(
                "serve.restart",
                {
                    "sequences": len(restarted),
                    "to_generation": new_gen,
                    "to_step": new_step,
                },
                step=max(0, new_step),
            )

    def _pop_admissible(self) -> Optional[GenerateTicket]:
        """The queue's head, expiring dead requests on the way (caller
        holds ``_cv``)."""
        while self._queue:
            t = self._queue[0]
            if t.deadline > time.monotonic():
                return t
            self._queue.popleft()
            self._queued_tokens -= int(t.prompt.shape[0])
            self._g_depth.set(len(self._queue))
            self._m_requests.inc(status="expired")
            t._reject(DeadlineExceededError("deadline passed while queued"))
        return None

    def _admit(self, weights) -> int:
        """Monolithic JOIN: pop queued requests while decode slots and
        KV blocks last; each pays its own bucketed prefill.  Returns how
        many sequences joined."""
        bt = self.engine.block_tokens
        joined = 0
        epoch0 = self.engine.cache_epoch
        while len(self._active) < self.engine.max_seqs:
            with self._cv:
                t = self._pop_admissible()
                if t is None:
                    return joined
                plen = int(t.prompt.shape[0])
                need = self.engine.prompt_bucket_for(plen) // bt
                blocks = self.engine.pool.alloc(need)
                if blocks is None:
                    return joined  # KV pressure: no more joins now
                self._queue.popleft()
                self._queued_tokens -= plen
                self._g_depth.set(len(self._queue))
            t.blocks = blocks
            t.table = np.zeros(self.engine.blocks_per_seq, np.int32)
            t.table[: len(blocks)] = blocks
            try:
                first = self.engine.prefill(weights, t.prompt, t.table)
            except DispatchWedgedError:
                # Recoverable: the engine already rebuilt the pool and
                # bumped cache_epoch.  The request survives at the
                # queue's head; the worker's epoch check rewinds the
                # rest next iteration.
                self._free_blocks(t)
                with self._cv:
                    self._queue.appendleft(t)
                    self._queued_tokens += plen
                    self._g_depth.set(len(self._queue))
                return joined
            except Exception as e:
                traceback.print_exc()
                self._free_blocks(t)
                self._m_requests.inc(status="error")
                t._reject(e)
                if self.engine.cache_epoch != epoch0:
                    return joined  # the cache is lost: rewind first
                continue
            t.chunks += 1
            self._join_decode(t, first, plen, weights)
            joined += 1
        return joined

    def _join_decode(self, t: GenerateTicket, first: int, plen: int, weights) -> None:
        """The TTFT moment: a fully prefilled sequence emits its first
        token and joins the running decode batch (after a monolithic
        prefill or its final chunk; TTFT counts from enqueue either
        way)."""
        self.stats["prefills"] += 1
        self._m_prefills.inc()
        now = time.monotonic()
        if t.first_time is None:
            # TTFT observes once per request (a restart re-joins here
            # but must not add a second, inflated sample).
            self._m_ttft.observe(now - t.enqueued)
            t.first_time = now
        t.length = plen
        t.last_token = first
        t.last_time = now
        t.tokens.append(first)
        t._event({
            "token": first,
            "i": 0,
            "weights_step": weights.step,
            "weights_generation": weights.generation,
        })
        self._m_tokens.inc()
        self._active.append(t)
        if self._seq_finished(t):
            self._finish(t)

    def _admit_chunked(self) -> int:
        """Chunked JOIN: pop queued requests into the prefill FIFO while
        decode slots last (a prefilling sequence holds one).  KV blocks
        are taken per chunk, so admission itself is instant; a prompt
        that starts with a published run claims it and skips to its
        first cold block."""
        joined = 0
        while len(self._active) + len(self._prefilling) < self.engine.max_seqs:
            with self._cv:
                t = self._pop_admissible()
                if t is None:
                    return joined
                self._queue.popleft()
                self._queued_tokens -= int(t.prompt.shape[0])
                self._g_depth.set(len(self._queue))
            if t.table is None:
                t.table = np.zeros(self.engine.blocks_per_seq, np.int32)
            if self.prefix is not None and t.prefilled == 0 and not t.blocks:
                run, skip = self.prefix.claim(t.prompt)
                if skip:
                    # The claimed blocks are read-only here: every write
                    # of this sequence lands at positions >= skip, in
                    # blocks the chunk loop allocates for it.
                    t.blocks = list(run)
                    t.table[: len(run)] = run
                    t.prefilled = skip
                    t.reused_blocks = len(run)
            self._prefilling_tokens += int(t.prompt.shape[0]) - t.prefilled
            self._prefilling.append(t)
            joined += 1
        return joined

    def _prefill_iteration(self, weights) -> int:
        """Feed the prefill FIFO's head at most ``prefill_token_budget``
        prompt tokens of chunks (a sequence's chunks in order; the head
        finishes before the next starts).  Non-final chunks are
        block-aligned, so every offset stays aligned; the final chunk
        pads to its bucket and emits the first token.  Returns how many
        chunks ran."""
        eng = self.engine
        bt = eng.block_tokens
        budget = max(self.prefill_token_budget, bt)
        epoch0 = eng.cache_epoch
        dispatched = 0
        while budget > 0 and self._prefilling:
            t = self._prefilling[0]
            plen = int(t.prompt.shape[0])
            if t.deadline <= time.monotonic():
                # Expiry frees a half-prefilled sequence's blocks too.
                self._prefilling.popleft()
                self._prefilling_tokens -= plen - t.prefilled
                self._free_blocks(t)
                self._m_requests.inc(status="expired")
                t._reject(DeadlineExceededError("deadline passed mid-prefill"))
                continue
            rem = plen - t.prefilled
            # Cap the chunk so its padded bucket still fits the context
            # window (the offset is block-aligned and below the window,
            # so at least one block of room is left).
            room = eng.max_context - t.prefilled
            cap = bt
            for c in eng.chunk_buckets:
                if c <= room:
                    cap = c
            clen = min(rem, cap, budget)
            if clen < rem:
                clen = (clen // bt) * bt
                if clen == 0:
                    break  # budget left under one block: next iteration
            bucket = eng.chunk_bucket_for(clen)
            need = (t.prefilled + bucket) // bt - len(t.blocks)
            if need > 0:
                blocks = eng.pool.alloc(need)
                if blocks is None:
                    break  # KV pressure: the FIFO head waits its turn
                for b in blocks:
                    t.table[len(t.blocks)] = b
                    t.blocks.append(b)
            try:
                first = eng.prefill_chunk(
                    weights, t.prompt[t.prefilled:t.prefilled + clen],
                    t.prefilled, t.table,
                )
            except DispatchWedgedError:
                # Recoverable: the sequence stays at the FIFO head; the
                # epoch rewind next iteration frees its blocks, resets
                # its progress and requeues it.
                break
            except Exception as e:
                traceback.print_exc()
                self._prefilling.popleft()
                self._prefilling_tokens -= plen - t.prefilled
                self._free_blocks(t)
                self._m_requests.inc(status="error")
                t._reject(e)
                if eng.cache_epoch != epoch0:
                    break  # the cache is lost: the worker rewinds first
                continue
            t.prefilled += clen
            t.chunks += 1
            self._prefilling_tokens -= clen
            budget -= clen
            dispatched += 1
            self.stats["chunks"] += 1
            self._m_chunks.inc()
            self._m_prefill_tokens.inc(clen)
            if t.prefilled >= plen:
                self._prefilling.popleft()
                if self.prefix is not None:
                    # Publish the full prompt blocks: this sequence's own
                    # reference keeps them while it decodes; at refcount
                    # 0 they park on the pool's cached LRU.
                    self.prefix.publish(t.prompt, t.blocks)
                self._join_decode(t, first, plen, weights)
        return dispatched

    def _seq_finished(self, t: GenerateTicket) -> bool:
        if t.eos_id is not None and t.tokens and t.tokens[-1] == t.eos_id:
            return True
        if len(t.tokens) >= t.max_new:
            return True
        # context cap: position t.length (the next write) must exist
        return t.length >= self.engine.max_context

    def _decode_iteration(self, weights) -> int:
        """ONE token for every active sequence.  Returns how many
        sequences decoded."""
        now = time.monotonic()
        for t in list(self._active):
            if t.deadline <= now:
                self._expire(t)
        if not self._active:
            return 0
        bt = self.engine.block_tokens
        ready: List[GenerateTicket] = []
        for t in self._active:
            bi = t.length // bt
            if bi >= len(t.blocks):
                blk = self.engine.pool.alloc(1)
                if blk is None:
                    continue  # KV pressure: this seq skips one iteration
                t.blocks.append(blk[0])
                t.table[bi] = blk[0]
            ready.append(t)
        if not ready:
            return 0
        if self.chaos is not None:
            for ev in self.chaos.due("serve.request.slow"):
                # chaos[serve.request.slow]: a slow decode iteration
                # inflates TTFT and the inter-token gap.
                time.sleep(float(ev.arg or 0.05))
        bucket = self.engine.decode_bucket_for(len(ready))
        tokens = np.zeros(bucket, np.int32)
        lengths = np.zeros(bucket, np.int32)
        # padding rows: trash block, length 0
        tables = np.zeros((bucket, self.engine.blocks_per_seq), np.int32)
        for i, t in enumerate(ready):
            tokens[i] = t.last_token
            lengths[i] = t.length
            tables[i] = t.table
        try:
            ids = self.engine.decode_step(weights, tokens, lengths, tables)
        except DispatchWedgedError:
            # Recoverable: the sequences stay active; the epoch check
            # next iteration re-prefills every one of them on the
            # rebuilt pool.  A genuine compute error (below) rejects.
            return 0
        except Exception as e:
            traceback.print_exc()
            for t in ready:
                if t in self._active:
                    self._active.remove(t)
                self._free_blocks(t)
                self._m_requests.inc(status="error")
                t._reject(e)
            return 0
        self.stats["iterations"] += 1
        self._m_iterations.inc()
        self._m_tokens.inc(len(ready))
        self._m_occupancy.observe(len(ready) / bucket)
        now = time.monotonic()
        for i, t in enumerate(ready):
            tok = int(ids[i])
            t.length += 1
            t.last_token = tok
            t.tokens.append(tok)
            self._m_intertoken.observe(now - t.last_time)
            t.last_time = now
            ev = {"token": tok, "i": len(t.tokens) - 1}
            if ev["i"] == 0:
                # a sequence's first token names the weights that made
                # it (the purity stamp a stream relay resumes on)
                ev["weights_step"] = weights.step
                ev["weights_generation"] = weights.generation
            t._event(ev)
            if self._seq_finished(t):
                self._finish(t)
        return len(ready)

    def _refresh(self) -> None:
        """Ask the engine for newer weights (a failure of the swap path
        costs the swap, never the worker)."""
        if not self.refresh:
            return
        try:
            if self.engine.refresh():
                self.stats["swaps"] += 1
        except Exception:
            traceback.print_exc()

    def _work(self) -> None:
        while True:
            with self._cv:
                idle = not (
                    self._queue or self._active or self._prefilling or self._adopted
                )
                if idle and not self._stop and not self._freeze_req.is_set():
                    self._cv.wait(timeout=0.5)
                if self._stop:
                    queued = list(self._queue)
                    self._queue.clear()
                    self._queued_tokens = 0
                    self._g_depth.set(0)
                    adopted = [e[0] for e in self._adopted]
                    self._adopted.clear()
                    break
                idle = not (
                    self._queue or self._active or self._prefilling or self._adopted
                )
            if self._freeze_req.is_set():
                # The token-boundary freeze (a migration): the exporter
                # owns the pool and the batch state until it resumes us.
                self._frozen_ack.set()
                # parked until the exporter resumes us, however long
                # its body takes (or the batcher stops)
                while not self._resume.wait(timeout=0.5) and not self._stop:
                    pass
                self._frozen_ack.clear()
                continue
            # 1. the weights check, at the token boundary only (and on
            # each idle wake-up, so an idle replica swaps as well)
            self._refresh()
            if idle:
                continue
            w = self.engine.current_weights()
            if w is None:
                # No weights loaded: requests cannot be served.
                with self._cv:
                    queued = list(self._queue)
                    self._queue.clear()
                    self._queued_tokens = 0
                    self._g_depth.set(0)
                for t in queued:
                    self._m_requests.inc(status="error")
                    t._reject(NotReadyError("no weights loaded"))
                continue
            epoch = self.engine.cache_epoch
            if w.generation != self._bound_gen or epoch != self._bound_epoch:
                if self.prefix is not None:
                    # Rekey before the restart frees any block: the index
                    # drops at once, and no admission under the new key
                    # can claim a block filled under the old one.
                    self.prefix.rekey((w.generation, epoch))
                if self._bound_gen >= 0:
                    self._restart_active(w.generation, w.step)
                self._bound_gen = w.generation
                self._bound_step = w.step
                self._bound_epoch = epoch
            if self.prefix is not None and self.chaos is not None:
                # chaos[serve.prefix.evicted]: force LRU evictions of
                # cached prefix blocks as if allocation pressure hit.
                self.prefix.chaos_tick()
            # 1b. adopt migrated-in sequences (checked against the
            # weights just bound: a skew re-prefills cold)
            adopted_work = self._adopt_pending(w) if self._adopted else 0
            # 2. join + budgeted prefill work; 3. one decode iteration.
            # The time admission work holds up a running batch is the
            # stall the chunked scheduler bounds.
            had_active = bool(self._active)
            t_pre = time.monotonic()
            if self.chunked_prefill:
                progress = self._admit_chunked()
                prefill_work = self._prefill_iteration(w)
                progress += prefill_work
            else:
                progress = prefill_work = self._admit(w)
            if had_active and prefill_work:
                self._m_stall.observe(time.monotonic() - t_pre)
            if self.engine.cache_epoch != epoch:
                # A failed call rebuilt the pool: the active batch's
                # cache is gone, so decoding it now would emit garbage.
                # Rewind first (next iteration's check).
                continue
            progress += adopted_work
            progress += self._decode_iteration(w)
            pool = self.engine.pool
            self._g_active.set(len(self._active))
            self._g_kv.set(pool.occupancy())
            self._g_kv_bytes.set(pool.used_blocks * (pool.nbytes() // pool.num_blocks))
            self._g_prefill_queued.set(self.queued_prefill_tokens)
            if not progress and (self._active or self._queue or self._prefilling):
                # Every live sequence is stalled (KV-block exhaustion)
                # and nobody could join: nothing changes until a
                # deadline expires or blocks free, so don't busy-spin.
                time.sleep(0.01)
        # stopped: nothing queued, adopted, prefilling or active survives.
        for t in queued + adopted + list(self._prefilling) + list(self._active):
            self._free_blocks(t)
            self._m_requests.inc(status="error")
            t._reject(RuntimeError("batcher stopped"))
        self._prefilling.clear()
        self._prefilling_tokens = 0
        self._active = []
        self._g_active.set(0)
