"""Continuous batchers: bounded queue, deadline-aware admission, bucket
padding, backpressure (counterpart of ``edl_tpu/serving/batcher.py``).

Orca-style continuous batching: the batch boundary is the scheduling
boundary.  ``ContinuousBatcher`` schedules single-shot requests (the
request IS the iteration); ``TokenContinuousBatcher`` schedules per
TOKEN over a ``DecodeEngine``'s paged KV cache, so requests join and
leave the running batch at token boundaries.

Admission is where backpressure lives: a full queue rejects at once
with a retry-after hint (HTTP 429) instead of buffering without bound,
and a request whose deadline passed while queued is expired, not
computed.

Drain, chaos injection, chunked prefill, the prefix cache and live
migration come with later slices.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from edl_tpu_torch.serving.engine import NotReadyError


class QueueFullError(RuntimeError):
    """Admission rejected: the bounded queue is full.  ``retry_after``
    is the backoff hint (seconds) the HTTP front sends as Retry-After."""

    def __init__(self, msg: str, retry_after: float = 0.05):
        super().__init__(msg)
        self.retry_after = retry_after


class DeadlineExceededError(RuntimeError):
    """The request's deadline passed before it could be served."""


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
    ):
        self.engine = engine
        self.queue_limit = int(queue_limit)
        self.default_deadline_s = float(default_deadline_s)
        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._stop = False
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

    def submit(
        self,
        inputs: Dict[str, Any],
        deadline_s: Optional[float] = None,
    ) -> Ticket:
        """Admit one request (1..max_batch rows).  Raises
        ``QueueFullError`` on backpressure and ``ValueError`` on a
        schema mismatch — both before the request costs any compute."""
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
            if len(self._queue) >= self.queue_limit:
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
            self._g_depth.set(len(self._queue))
        return taken

    def _work(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait(timeout=0.5)
                if self._stop:
                    return
            batch = self._take_batch()
            if not batch:
                continue
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
        "last_time", "first_time", "_done", "_result", "_error",
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
        #: wall time of the FIRST ever emitted token (a restart never
        #: moves it)
        self.first_time: Optional[float] = None
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

    1. **weights check** — at the token boundary only.  If a new weight
       generation was installed, every in-flight sequence re-prefills
       against it (its partial output is void, streamed as a restart
       event): one sequence never mixes weight generations.
    2. **join** — queued requests are admitted while decode slots and
       KV blocks last; each pays one monolithic bucketed prefill, which
       emits its first token (the TTFT moment).
    3. **decode** — one token for every active sequence (bucketed by
       count; block tables absorb ragged lengths).  Finished sequences
       (EOS / token budget / context cap / past deadline) resolve and
       release their KV blocks the SAME iteration.

    Admission: bounded queue -> ``QueueFullError`` (HTTP 429 +
    Retry-After); queued requests past their deadline expire; a prompt
    over the context cap raises ``PromptTooLongError`` at submit.

    ``chunked_prefill=True`` (the JAX default when the model declares a
    ``chunk_fn``) is not ported yet: this slice serves the monolithic
    posture (``chunked_prefill=False``), which is what puts the flash
    kernel on every prefill.
    """

    def __init__(
        self,
        engine,
        queue_limit: int = 256,
        default_deadline_s: float = 30.0,
        default_max_new: int = 16,
        chunked_prefill: bool = False,
    ):
        if chunked_prefill:
            raise NotImplementedError(
                "chunked prefill is not ported yet (ROADMAP queue A, "
                "serving slice residue); use chunked_prefill=False"
            )
        self.engine = engine
        self.queue_limit = int(queue_limit)
        self.default_deadline_s = float(default_deadline_s)
        self.default_max_new = int(default_max_new)
        self.chunked_prefill = False
        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._active: List[GenerateTicket] = []
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._bound_gen = -1
        self._bound_step = -1
        self.stats = {"iterations": 0, "prefills": 0, "restarts": 0}

        from edl_tpu_torch import telemetry

        reg = telemetry.get_registry()
        self._m_requests = reg.counter("edl_serve_requests_total")
        self._m_tokens = reg.counter("edl_serve_tokens_total")
        self._m_prefills = reg.counter("edl_serve_prefills_total")
        self._m_iterations = reg.counter("edl_serve_decode_iterations_total")
        self._m_restarts = reg.counter("edl_serve_restarts_total")
        self._g_depth = reg.gauge("edl_serve_decode_queue_depth")
        self._g_active = reg.gauge("edl_serve_active_sequences")
        self._g_kv = reg.gauge("edl_serve_kv_occupancy")
        self._m_ttft = reg.histogram("edl_serve_ttft_seconds")
        self._m_intertoken = reg.histogram("edl_serve_intertoken_seconds")
        self._m_occupancy = reg.histogram("edl_serve_batch_occupancy")

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
        Raises ``QueueFullError`` on backpressure and ``ValueError``
        (``PromptTooLongError`` included) on a schema violation — both
        before any compute."""
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
            if len(self._queue) >= self.queue_limit:
                self._m_requests.inc(status="rejected")
                raise QueueFullError(
                    f"admission queue full ({self.queue_limit}); retry",
                    retry_after=max(0.01, budget / 4),
                )
            self._queue.append(ticket)
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
        """New weights landed: every in-flight sequence re-prefills
        against them.  Its emitted-so-far tokens are VOID (streamed as a
        restart event) — continuing the old prefix under new weights
        would mix generations within one sequence."""
        restarted = list(self._active)
        self._active = []
        with self._cv:
            for t in reversed(restarted):
                self._free_blocks(t)
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
                self._queue.appendleft(t)  # keep arrival order
            self._g_depth.set(len(self._queue))
        if restarted:
            self.stats["restarts"] += len(restarted)
            self._m_restarts.inc(len(restarted))

    def _admit(self, weights) -> int:
        """Token-boundary JOIN: pop queued requests while decode slots
        and KV blocks last; each pays its own bucketed prefill.  Returns
        how many sequences joined."""
        bt = self.engine.block_tokens
        joined = 0
        while len(self._active) < self.engine.max_seqs:
            with self._cv:
                if not self._queue:
                    return joined
                t = self._queue[0]
                if t.deadline <= time.monotonic():
                    self._queue.popleft()
                    self._g_depth.set(len(self._queue))
                    self._m_requests.inc(status="expired")
                    t._reject(DeadlineExceededError("deadline passed while queued"))
                    continue
                plen = int(t.prompt.shape[0])
                need = self.engine.prompt_bucket_for(plen) // bt
                blocks = self.engine.pool.alloc(need)
                if blocks is None:
                    return joined  # KV pressure: no more joins now
                self._queue.popleft()
                self._g_depth.set(len(self._queue))
            t.blocks = blocks
            t.table = np.zeros(self.engine.blocks_per_seq, np.int32)
            t.table[: len(blocks)] = blocks
            try:
                first = self.engine.prefill(weights, t.prompt, t.table)
            except Exception as e:
                traceback.print_exc()
                self._free_blocks(t)
                self._m_requests.inc(status="error")
                t._reject(e)
                continue
            self._join_decode(t, first, plen, weights)
            joined += 1
        return joined

    def _join_decode(self, t: GenerateTicket, first: int, plen: int, weights) -> None:
        """The TTFT moment: a prefilled sequence emits its first token
        and joins the running decode batch."""
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
            t._event({"token": tok, "i": len(t.tokens) - 1})
            if self._seq_finished(t):
                self._finish(t)
        return len(ready)

    def _work(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._active and not self._stop:
                    self._cv.wait(timeout=0.5)
                if self._stop:
                    queued = list(self._queue)
                    self._queue.clear()
                    self._g_depth.set(0)
                    break
            w = self.engine.current_weights()
            if w is None:
                # No weights installed: requests cannot be served.
                with self._cv:
                    queued = list(self._queue)
                    self._queue.clear()
                    self._g_depth.set(0)
                for t in queued:
                    self._m_requests.inc(status="error")
                    t._reject(NotReadyError("no weights installed"))
                continue
            if w.generation != self._bound_gen:
                if self._bound_gen >= 0:
                    self._restart_active(w.generation, w.step)
                self._bound_gen = w.generation
                self._bound_step = w.step
            progress = self._admit(w)
            progress += self._decode_iteration(w)
            self._g_active.set(len(self._active))
            self._g_kv.set(self.engine.pool.occupancy())
            if not progress and (self._active or self._queue):
                # Every live sequence is stalled (KV-block exhaustion)
                # and nobody could join: nothing changes until a
                # deadline expires or blocks free, so don't busy-spin.
                time.sleep(0.01)
        # stopped: nothing queued or active survives.
        for t in queued + list(self._active):
            self._free_blocks(t)
            self._m_requests.inc(status="error")
            t._reject(RuntimeError("batcher stopped"))
        self._active = []
        self._g_active.set(0)
