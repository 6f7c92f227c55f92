"""Inference engines: forward-only, bucketed, weight-swapping
(counterpart of ``edl_tpu/serving/engine.py``).

- **Weights** come in through ``install(state_dict, step)``: from
  ``convert.params_from_flax`` (weights carried across from the JAX
  package) or a seeded ``init_params``.  Each install publishes one
  immutable ``_Weights`` record, swapped atomically; a batch in flight
  bound its record at dispatch, so it never sees torn weights.
- **Shapes**: single-shot batches pad to power-of-two row buckets;
  prompts pad to block-aligned power-of-two buckets; decode batches pad
  to power-of-two sequence-count buckets.  The shape discipline is the
  JAX engine's (there it bounds the held executables).
- **Device**: one engine, one device, named explicitly (default CUDA).

Loading from ``HostDRAMStore`` or a durable checkpoint dir, tp meshes,
KV export/import for migration, the dispatch watchdog and chunked
prefill come with later slices.
"""

from __future__ import annotations

import threading
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from edl_tpu_torch import DeviceLike, resolve_device
from edl_tpu_torch.models.base import ModelDef, StateDict


class NotReadyError(RuntimeError):
    """No weights have been installed yet (the /healthz 503)."""


class PromptTooLongError(ValueError):
    """The prompt exceeds the engine's context window.  Raised at
    admission (``coerce_prompt``), before it costs any compute or KV
    blocks.  A ValueError, so the HTTP front maps it to 400."""


class BlockOwnershipError(RuntimeError):
    """A ``KVBlockPool`` block was freed or referenced without being
    owned.  A double free would eventually hand one block to two
    sequences, whose decode steps then write each other's K/V — silent
    corruption; raising at the bad ``free`` makes it a loud bug."""


@dataclass(frozen=True)
class _Weights:
    """One installed weight set.  Immutable and swapped atomically: a
    call reads the record once, so the params it binds are consistent
    even if a swap lands mid-batch."""

    generation: int  # engine-local install counter (monotonic)
    step: int        # training step of the weights
    digest: int      # content fingerprint of the state_dict
    params: Any      # device-resident params (the bound module)


def state_digest(state_dict: StateDict) -> int:
    """crc32 over the state_dict's keys and bytes, in key order."""
    crc = 0
    for k in sorted(state_dict):
        t = state_dict[k].detach().cpu().contiguous()
        crc = zlib.crc32(k.encode(), crc)
        crc = zlib.crc32(t.reshape(-1).view(torch.uint8).numpy(), crc)
    return crc


def _check_token_ids(a: np.ndarray, vocab_size: int) -> None:
    """Reject token ids outside ``[0, vocab_size)`` at admission: on the
    card an out-of-range embedding lookup is a device-side assert that
    poisons the whole CUDA context, not one request."""
    if a.size and (a.min() < 0 or a.max() >= vocab_size):
        raise ValueError(
            f"token ids must lie in [0, {vocab_size}), got "
            f"[{a.min()}, {a.max()}]"
        )


def _pow2_buckets(lo: int, hi: int) -> Tuple[int, ...]:
    """lo, 2*lo, 4*lo ... below hi, then hi itself as the last bucket
    (the configured cap is honored exactly, not rounded to a power)."""
    out: List[int] = []
    b = lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(out)


class InferenceEngine:
    """Forward-only engine over one model on one device.

    ``model`` must declare ``predict_fn`` and ``predict_inputs``."""

    def __init__(
        self,
        model: ModelDef,
        device: DeviceLike = None,
        max_batch: int = 64,
    ):
        if model.predict_fn is None:
            raise ValueError(
                f"model {model.name!r} declares no predict_fn; it cannot "
                "serve"
            )
        if not model.predict_inputs:
            raise ValueError(
                f"model {model.name!r} declares predict_fn but no "
                "predict_inputs (the request schema)"
            )
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.model = model
        self.device = resolve_device(device)
        self.buckets: Tuple[int, ...] = _pow2_buckets(1, int(max_batch))
        self.max_batch = int(max_batch)
        #: request schema: input key -> (trailing shape, dtype), probed
        #: from the model's own synthetic batch
        probe = model.synth_batch(np.random.RandomState(0), 1)
        self.input_schema: Dict[str, Tuple[tuple, Any]] = {
            k: (tuple(probe[k].shape[1:]), probe[k].dtype)
            for k in model.predict_inputs
        }
        self._weights: Optional[_Weights] = None
        self._swap_lock = threading.Lock()

        from edl_tpu_torch import telemetry

        self.telemetry = telemetry.get_registry()
        self._m_swaps = self.telemetry.counter("edl_serve_hot_swaps_total")
        self._m_weights_step = self.telemetry.gauge("edl_serve_weights_step")

    # -- weights ------------------------------------------------------------
    @property
    def weights_step(self) -> int:
        w = self._weights
        return w.step if w is not None else -1

    @property
    def weights_generation(self) -> int:
        w = self._weights
        return w.generation if w is not None else 0

    @property
    def ready(self) -> bool:
        return self._weights is not None

    def current_weights(self) -> Optional[_Weights]:
        """The installed weight record.  The token batcher binds it once
        per iteration, so a swap can only take effect at a token
        boundary."""
        return self._weights

    def install(self, state_dict: StateDict, step: int = 0) -> _Weights:
        """Place ``state_dict`` on the engine's device and publish it as
        the next weight generation.  Installs after the first count as
        hot swaps; the token batcher re-prefills in-flight sequences on
        the new generation."""
        digest = state_digest(state_dict)
        params = self.model.bind_params(state_dict, self.device)
        with self._swap_lock:
            gen = (self._weights.generation + 1) if self._weights else 1
            w = self._weights = _Weights(
                generation=gen, step=int(step), digest=digest, params=params
            )
        if gen > 1:
            self._m_swaps.inc()
        self._m_weights_step.set(int(step))
        return w

    def install_seeded(self, seed: int, step: int = 0) -> _Weights:
        """Install the model's seeded init (``init_params`` from a CPU
        ``torch.Generator`` seeded with ``seed``)."""
        from edl_tpu_torch import generator

        return self.install(self.model.init_params(generator(seed)), step)

    # -- the single-shot request path ---------------------------------------
    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"batch of {n} rows exceeds the largest bucket "
            f"{self.buckets[-1]} (max_batch)"
        )

    def _pad(self, inputs: Dict[str, np.ndarray], n: int, bucket: int):
        if n == bucket:
            return inputs
        out = {}
        for k, v in inputs.items():
            pad = np.broadcast_to(v[-1:], (bucket - n,) + tuple(v.shape[1:]))
            out[k] = np.concatenate([v, pad], axis=0)
        return out

    def coerce_inputs(
        self, inputs: Dict[str, Any]
    ) -> Tuple[Dict[str, np.ndarray], int]:
        """Validate a request's inputs against the model schema and
        coerce to the schema dtypes.  Returns (arrays, rows)."""
        missing = [k for k in self.input_schema if k not in inputs]
        if missing:
            raise ValueError(
                f"request missing input(s) {missing}; model "
                f"{self.model.name!r} expects {sorted(self.input_schema)}"
            )
        arrays: Dict[str, np.ndarray] = {}
        n = None
        for k, (shape, dtype) in self.input_schema.items():
            a = np.asarray(inputs[k], dtype=dtype)
            if a.ndim == len(shape):  # single example: add the batch dim
                a = a[None]
            if (
                tuple(a.shape[1:]) != shape
                and len(shape) == 1
                and a.ndim == 2
                and np.issubdtype(np.dtype(dtype), np.integer)
                and a.shape[1] < shape[0]
            ):
                # Token rows shorter than the schema (probed from the
                # training corpus, whose rows carry the shifted-label
                # position): right-pad with 0, the LM families' pad id.
                a = np.concatenate(
                    [a, np.zeros((a.shape[0], shape[0] - a.shape[1]), dtype)],
                    axis=1,
                )
            if tuple(a.shape[1:]) != shape:
                raise ValueError(
                    f"input {k!r} rows have shape {tuple(a.shape[1:])}, "
                    f"expected {shape}"
                )
            if k == "tokens" and self.model.decode is not None:
                _check_token_ids(a, self.model.decode.vocab_size)
            if n is None:
                n = a.shape[0]
            elif a.shape[0] != n:
                raise ValueError(
                    "request inputs disagree on row count "
                    f"({k!r}: {a.shape[0]} vs {n})"
                )
            arrays[k] = a
        return arrays, int(n or 0)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def predict(
        self, inputs: Dict[str, np.ndarray]
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        """Run the forward on ``inputs`` (schema-shaped numpy arrays,
        leading dim = rows), padded to the smallest bucket.  Returns
        (host outputs sliced to the real rows, meta with the weight
        generation/step the batch was computed with)."""
        w = self._weights  # ONE read: the whole batch binds this record
        if w is None:
            raise NotReadyError("no weights installed")
        n = next(iter(inputs.values())).shape[0]
        bucket = self.bucket_for(n)
        padded = self._pad(inputs, n, bucket)
        with torch.no_grad():
            batch = {k: self._to_device(v) for k, v in padded.items()}
            out = self.model.predict_fn(w.params, batch)
            host = {k: v.cpu().numpy()[:n] for k, v in out.items()}
        meta = {
            "weights_step": w.step,
            "weights_generation": w.generation,
            "bucket": bucket,
            "rows": n,
        }
        return host, meta


class KVBlockPool:
    """Preallocated paged KV cache: fixed-size blocks in one device
    pool, free list managed HOST-side (the device only ever sees block
    tables).  Block 0 is the trash block (padding rows of a decode batch
    write there); real sequences allocate from 1..num_blocks-1.

    Allocation is all-or-nothing (``alloc`` returns None rather than a
    partial grant), so a prompt either gets its full block run or waits
    at admission.  Blocks are refcounted: ``alloc`` grants at refcount
    1, ``ref`` adds an owner, ``free`` drops one and returns the block
    to circulation at 0.  (The prefix cache's publish/LRU comes with
    the prefix-cache slice.)"""

    def __init__(
        self,
        layers: int,
        heads: int,
        head_dim: int,
        num_blocks: int,
        block_tokens: int,
        dtype: torch.dtype,
        device: DeviceLike = None,
    ):
        if num_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (block 0 is trash)")
        self.num_blocks = int(num_blocks)
        self.block_tokens = int(block_tokens)
        shape = (layers, self.num_blocks, self.block_tokens, heads, head_dim)
        dev = resolve_device(device)
        self.kpool = torch.zeros(shape, dtype=dtype, device=dev)
        self.vpool = torch.zeros(shape, dtype=dtype, device=dev)
        self._free = deque(range(1, self.num_blocks))
        self._ref: Dict[int, int] = {}  # owned block -> refcount
        self._lock = threading.Lock()

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Blocks held by live sequences."""
        return self.usable_blocks - self.free_blocks

    def occupancy(self) -> float:
        return self.used_blocks / max(1, self.usable_blocks)

    def nbytes(self) -> int:
        """Device bytes of both planes."""
        return 2 * self.kpool.numel() * self.kpool.element_size()

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` blocks at refcount 1, or None (never a partial
        grant)."""
        with self._lock:
            if n > len(self._free):
                return None
            got = [self._free.popleft() for _ in range(n)]
            for b in got:
                self._ref[b] = 1
            return got

    def ref(self, block: int) -> None:
        """Add an owner to an owned block."""
        b = int(block)
        with self._lock:
            if b not in self._ref:
                raise BlockOwnershipError(f"block {b} is not owned")
            self._ref[b] += 1

    def refcount(self, block: int) -> int:
        return self._ref.get(int(block), 0)

    def free(self, blocks: Sequence[int]) -> None:
        """Drop one reference per id.  Freeing a block this pool does
        not consider owned raises ``BlockOwnershipError``."""
        with self._lock:
            for b in blocks:
                b = int(b)
                if b == 0:
                    raise ValueError("block 0 (trash) is never owned")
                n = self._ref.get(b)
                if n is None:
                    raise BlockOwnershipError(
                        f"block {b} freed without being owned "
                        "(double free or stray id)"
                    )
                if n > 1:
                    self._ref[b] = n - 1
                else:
                    del self._ref[b]
                    self._free.append(b)


class DecodeEngine(InferenceEngine):
    """KV-cached autoregressive decode on top of the single-shot engine.

    - **prefill** runs per padded prompt bucket (block-aligned powers of
      two of ``block_tokens``), one sequence per call: a joining request
      pays its own prefill.
    - **decode** runs per active-sequence-count bucket (powers of two up
      to ``max_seqs``); ragged lengths ride one call because the block
      tables absorb them.

    Weights are passed explicitly (the ``current_weights()`` record), so
    a swap only takes effect at a token boundary.  The pools are written
    in place (the JAX engine donates them to its executables instead).
    """

    def __init__(
        self,
        model: ModelDef,
        device: DeviceLike = None,
        max_batch: int = 8,
        max_seqs: int = 8,
        block_tokens: int = 16,
        max_context: Optional[int] = None,
        num_blocks: Optional[int] = None,
    ):
        if model.decode is None:
            raise ValueError(
                f"model {model.name!r} declares no DecodeSpec; it can "
                "only serve single-shot forwards (InferenceEngine)"
            )
        super().__init__(model, device=device, max_batch=max_batch)
        spec = model.decode
        self.spec = spec
        self.block_tokens = int(block_tokens)
        ctx = min(max_context or spec.max_len, spec.max_len)
        #: blocks per sequence: the whole context window, block-aligned
        #: (rounded down — a partial trailing block is unaddressable)
        self.blocks_per_seq = max(1, ctx // self.block_tokens)
        self.max_context = self.blocks_per_seq * self.block_tokens
        self.max_seqs = int(max_seqs)
        if num_blocks is None:
            # Enough for every slot's full context + the trash block.
            num_blocks = self.max_seqs * self.blocks_per_seq + 1
        self.pool = KVBlockPool(
            spec.layers,
            spec.heads,
            spec.head_dim,
            num_blocks,
            self.block_tokens,
            spec.cache_dtype,
            self.device,
        )
        self.telemetry.gauge("edl_serve_kv_pool_bytes_per_device").set(
            self.pool.nbytes()
        )
        self.decode_buckets: Tuple[int, ...] = _pow2_buckets(1, self.max_seqs)
        self.prompt_buckets: Tuple[int, ...] = _pow2_buckets(
            self.block_tokens, self.max_context
        )

    @property
    def max_prompt(self) -> int:
        """Longest admissible prompt: one position must remain for the
        first generated token."""
        return self.max_context - 1

    def prompt_bucket_for(self, n: int) -> int:
        for p in self.prompt_buckets:
            if n <= p:
                return p
        raise ValueError(
            f"prompt of {n} tokens exceeds the context window "
            f"{self.max_context}"
        )

    def decode_bucket_for(self, n: int) -> int:
        for b in self.decode_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"{n} active sequences exceed max_seqs {self.max_seqs}"
        )

    def coerce_prompt(self, inputs: Dict[str, Any]) -> np.ndarray:
        """Validate one generate request's prompt: a 1-D (or [1, n])
        int token row, 1 <= n <= max_prompt."""
        if "tokens" not in inputs:
            raise ValueError(
                "generate request missing 'tokens' (the prompt row)"
            )
        a = np.asarray(inputs["tokens"])
        if a.ndim == 2 and a.shape[0] == 1:
            a = a[0]
        if a.ndim != 1:
            raise ValueError(
                f"prompt must be one token row, got shape {a.shape}"
            )
        if not np.issubdtype(a.dtype, np.integer):
            raise ValueError(f"prompt dtype {a.dtype} is not integral")
        if a.shape[0] > self.max_prompt:
            raise PromptTooLongError(
                f"prompt of {a.shape[0]} tokens exceeds max_prompt "
                f"{self.max_prompt} (context {self.max_context})"
            )
        if a.shape[0] < 1:
            raise ValueError(
                f"prompt of {a.shape[0]} tokens outside [1, "
                f"{self.max_prompt}] (context {self.max_context})"
            )
        _check_token_ids(a, self.spec.vocab_size)
        return a.astype(np.int32)

    def _run(self, fn, params, tokens, lengths, tables) -> np.ndarray:
        with torch.no_grad():
            ids, _, _ = fn(
                params,
                self._to_device(tokens),
                self._to_device(lengths),
                self.pool.kpool,
                self.pool.vpool,
                self._to_device(tables),
            )
            return ids.cpu().numpy()

    def prefill(
        self, weights: _Weights, prompt: np.ndarray, table_row: np.ndarray
    ) -> int:
        """Run one sequence's prompt (1-D int32, true length) padded to
        its bucket.  ``table_row``: the sequence's block table
        ``[blocks_per_seq]`` (unallocated tail = trash block 0).
        Returns the first generated token."""
        plen = int(prompt.shape[0])
        bucket = self.prompt_bucket_for(plen)
        tok = np.zeros((1, bucket), np.int32)
        tok[0, :plen] = prompt
        ids = self._run(
            self.spec.prefill_fn,
            weights.params,
            tok,
            np.asarray([plen], np.int32),
            np.asarray(table_row, np.int32)[None],
        )
        return int(ids[0])

    def decode_step(
        self,
        weights: _Weights,
        tokens: np.ndarray,
        lengths: np.ndarray,
        tables: np.ndarray,
    ) -> np.ndarray:
        """One token of compute for a padded decode batch.  ``tokens``
        [n]: each row's last token; ``lengths`` [n]: its position;
        ``tables`` [n, blocks_per_seq].  Padding rows point at the trash
        block with length 0.  Returns the next ids [n]."""
        return self._run(
            self.spec.decode_fn,
            weights.params,
            np.asarray(tokens, np.int32),
            np.asarray(lengths, np.int32),
            np.asarray(tables, np.int32),
        )
