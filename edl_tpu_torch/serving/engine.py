"""Inference engines: forward-only, bucketed, checkpoint-backed and
weight-swapping (counterpart of ``edl_tpu/serving/engine.py``).

- **Weights** come from the checkpoints training writes: the newest
  verified one in a ``HostDRAMStore``, else the newest intact spill of
  its durable directory (``load``); ``refresh`` hot-swaps to a newer
  one at a token boundary.  A checkpoint is the trainer's
  ``TrainState.leaves()``: its first leaves are the float32 parameters,
  mapped to weights through the model's own parameter order and cast
  to the serving dtype.  A candidate that fails its CRC or whose leaves
  do not fit that schema (count, shape, dtype) is rejected once and
  counted, never installed; the old weights keep serving.
  ``install(state_dict, step)`` places weights directly (seeded
  weights, or weights from ``convert.params_from_flax``).  Each install
  publishes one immutable ``_Weights`` record, swapped atomically; a
  batch in flight bound its record at dispatch, so it never sees torn
  weights.
- **Shapes**: single-shot batches pad to power-of-two row buckets;
  prompts pad to block-aligned power-of-two buckets; prefill chunks to
  block-aligned power-of-two chunk buckets, each gathering the window
  of the smallest prompt bucket that covers it; decode batches pad to
  power-of-two sequence-count buckets.  The shape discipline is the
  JAX engine's (there it bounds the held executables; here it bounds
  the gather and keeps padding and final-chunk behaviour the same).
- **Device**: one engine, one device, named explicitly (default CUDA).
- **Live migration**: ``export_kv`` gathers a sequence's filled K/V
  blocks to host memory and ``import_kv`` scatters them into freshly
  granted blocks of another engine (``serving/migrate.py`` moves them).
- **Dispatch watchdog**: with ``dispatch_timeout`` (or
  ``EDL_SERVE_DISPATCH_TIMEOUT``) > 0 each prefill, chunk and decode
  call runs under a deadline; a wedged call rebuilds the pool, bumps
  ``cache_epoch`` and raises ``DispatchWedgedError``, which the token
  batcher treats as recoverable (live sequences re-prefill).
- **Chaos** (``chaos=``, by default the store's schedule):
  ``serve.swap.torn`` rots the newest DRAM candidate before the next
  refresh verifies it (rejected once, the old weights keep serving);
  ``serve.dispatch.wedged`` trips the dispatch watchdog on the next
  prefill, chunk or decode call, whatever ``dispatch_timeout``.

Not ported yet: tp meshes and shard-only spills (the checkpoint fabric).
"""

from __future__ import annotations

import os
import threading
import time
import warnings
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from edl_tpu_torch import DeviceLike, generator, resolve_device
from edl_tpu_torch.consensus.watchdog import CollectiveTimeout, CollectiveWatchdog
from edl_tpu_torch.models.base import ModelDef, StateDict

#: the hand-written kernels the serving path launches (B1, on every
#: monolithic prefill); ``warm`` builds and loads them
SERVING_KERNELS = ("flash_fwd",)


class NotReadyError(RuntimeError):
    """No weights have been loaded or installed yet (the /healthz
    503)."""


class PromptTooLongError(ValueError):
    """The prompt exceeds the engine's context window.  Raised at
    admission (``coerce_prompt``), before it costs any compute or KV
    blocks.  A ValueError, so the HTTP front maps it to 400."""


class DispatchWedgedError(RuntimeError):
    """A prefill, chunk or decode call missed the dispatch watchdog's
    deadline.  By the time this raises the engine has rebuilt its KV
    pool and bumped ``cache_epoch``: the token batcher treats it as
    recoverable (live sequences re-prefill on the fresh cache instead of
    being rejected), where a genuine compute error still rejects."""


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
    digest: int      # content fingerprint of the checkpoint / state_dict
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
    """Forward-only engine over one model and one checkpoint store, on
    one device.

    ``model`` must declare ``predict_fn`` and ``predict_inputs``.
    ``store``: where ``load``/``refresh`` find checkpoints (an empty
    store without a spill directory when None: weights then come only
    through ``install``)."""

    def __init__(
        self,
        model: ModelDef,
        device: DeviceLike = None,
        max_batch: int = 64,
        *,
        store=None,
        chaos=None,
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
        from edl_tpu_torch.checkpoint import HostDRAMStore

        self.store = store if store is not None else HostDRAMStore()
        self.chaos = chaos if chaos is not None else self.store.chaos
        self.buckets: Tuple[int, ...] = _pow2_buckets(1, int(max_batch))
        self.max_batch = int(max_batch)
        #: request schema: input key -> (trailing shape, dtype), probed
        #: from the model's own synthetic batch
        probe = model.synth_batch(np.random.RandomState(0), 1)
        self.input_schema: Dict[str, Tuple[tuple, Any]] = {
            k: (tuple(probe[k].shape[1:]), probe[k].dtype)
            for k in model.predict_inputs
        }
        #: how often (seconds) ``refresh`` may list the spill directory;
        #: the DRAM step comparison runs on every call
        self.spill_poll_interval: float = 1.0
        self._last_spill_poll = 0.0
        #: step of the newest candidate already rejected: a torn or
        #: misfit checkpoint stays where it is until a newer one lands,
        #: and each poll that sees it again must not count it again
        self._last_rejected_step = -1
        self._last_rejected_spill = -1
        #: (parameter names, leaf specs) of a checkpoint of this model
        self._template: Optional[Tuple[List[str], list]] = None
        self.warmed = False
        self._weights: Optional[_Weights] = None
        self._swap_lock = threading.Lock()
        #: serializes refresh(): both batchers may drive it
        self._refresh_lock = threading.Lock()

        from edl_tpu_torch import telemetry

        self.telemetry = telemetry.get_registry()
        #: the flight recorder: ``serve.swap`` / ``serve.swap.rejected``
        #: journal here, and reach the coordinator's merged /telemetry
        #: with the replica's reports
        self.recorder = telemetry.get_recorder()
        self._m_swaps = self.telemetry.counter("edl_serve_hot_swaps_total")
        self._m_swap_rejected = self.telemetry.counter(
            "edl_serve_swap_rejected_total"
        )
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

    def _publish(self, params, step: int, digest: int) -> _Weights:
        with self._swap_lock:
            gen = (self._weights.generation + 1) if self._weights else 1
            w = self._weights = _Weights(
                generation=gen, step=int(step), digest=int(digest), params=params
            )
        self._m_weights_step.set(int(step))
        return w

    def install(self, state_dict: StateDict, step: int = 0) -> _Weights:
        """Place ``state_dict`` on the engine's device and publish it as
        the next weight generation.  Installs after the first count as
        hot swaps; the token batcher re-prefills in-flight sequences on
        the new generation."""
        digest = state_digest(state_dict)
        w = self._publish(self.model.bind_params(state_dict, self.device), step, digest)
        if w.generation > 1:
            self._m_swaps.inc()
        return w

    def install_seeded(self, seed: int, step: int = 0) -> _Weights:
        """Install the model's seeded init (``init_params`` from a CPU
        ``torch.Generator`` seeded with ``seed``)."""
        return self.install(self.model.init_params(generator(seed)), step)

    # -- checkpoints --------------------------------------------------------
    def leaf_template(self) -> Tuple[List[str], list]:
        """Parameter names (the trainable module's ``named_parameters``
        order) and the ``LeafSpec`` of every leaf of this model's
        ``TrainState.leaves()``: the schema a checkpoint must fit.  Made
        on the meta device: no weights, no memory."""
        if self._template is None:
            if self.model.train_params is None:
                raise ValueError(
                    f"model {self.model.name!r} has no training functions, "
                    "so no checkpoint schema to load from"
                )
            from edl_tpu_torch.checkpoint.hostdram import leaf_specs
            from edl_tpu_torch.runtime.train import leaf_template

            with torch.device("meta"):
                # the meta device makes shapes only: the seed changes nothing
                sd = self.model.init_params(generator(0))
            with warnings.catch_warnings():
                # loading meta tensors into a meta module copies nothing
                warnings.simplefilter("ignore")
                module = self.model.train_params(sd, "meta")
            named = list(module.named_parameters())
            self._template = (
                [n for n, _ in named],
                leaf_specs(leaf_template([p for _, p in named])),
            )
        return self._template

    def _fits(self, ckpt) -> bool:
        from edl_tpu_torch.checkpoint.hostdram import leaf_specs

        return leaf_specs(ckpt.leaves) == self.leaf_template()[1]

    def _stage_params(self, ckpt):
        """The checkpoint's parameters as the serving module on the
        engine's device: the first leaves of ``TrainState.leaves()``,
        by name in the trainable module's order, copied to the device
        as float32 and cast to the serving dtype there."""
        names, _ = self.leaf_template()
        sd = {}
        for name, leaf in zip(names, ckpt.leaves):
            t = torch.from_numpy(np.ascontiguousarray(leaf)).reshape(leaf.shape)
            sd[name] = t.to(self.device, non_blocking=True) if self.device.type == "cuda" else t
        params = self.model.bind_params(sd, self.device)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return params

    def _install(self, ckpt) -> _Weights:
        """Publish ``ckpt``'s parameters as the next weight generation.
        Only the parameters leave the host: serving never pays for the
        optimizer state."""
        w = self._publish(self._stage_params(ckpt), ckpt.step, ckpt.digest())
        # A successful install clears the rejection dedup: the next bad
        # candidate, whatever its step, counts again.
        self._last_rejected_step = -1
        return w

    def _reject(self, source: str, serving_step: int) -> None:
        self._m_swap_rejected.inc()
        self.recorder.record(
            "serve.swap.rejected",
            {"source": source, "serving_step": serving_step},
            step=max(0, serving_step),
        )

    def load(self) -> bool:
        """Initial load: the newest verified DRAM checkpoint, else the
        newest intact spill of the store's durable directory.  A
        candidate whose leaves do not fit the model's schema is
        rejected and counted.  Returns False when nothing servable
        exists."""
        ckpt = self.store.latest_verified()
        if ckpt is not None and not self._fits(ckpt):
            self._reject("dram", -1)
            ckpt = None
        if ckpt is None and self.store.spill_dir:
            try:
                ckpt = self.store.load_from_disk(self.leaf_template()[1])
            except FileNotFoundError:
                ckpt = None
            except (ValueError, RuntimeError):
                self._reject("disk", -1)
                ckpt = None
        if ckpt is None:
            return False
        self._install(ckpt)
        self.recorder.record(
            "serve.swap",
            {"step": int(ckpt.step), "initial": True},
            step=int(ckpt.step),
        )
        return True

    def refresh(self) -> bool:
        """Hot-swap to a newer verified checkpoint if one appeared.  The
        batchers call it between batches and at token boundaries, never
        mid-dispatch.  A candidate that fails its CRC (``latest_verified``
        drops it), an unreadable spill, or one whose leaves do not fit
        is rejected once and the current weights keep serving.  Cheap
        when nothing changed: one step comparison, and a listing of the
        spill directory at most every ``spill_poll_interval`` seconds."""
        with self._refresh_lock:
            return self._refresh_locked()

    def _refresh_locked(self) -> bool:
        current = self.weights_step
        if self.chaos is not None:
            for _ in self.chaos.due("serve.swap.torn"):
                # chaos[serve.swap.torn]: the newest DRAM candidate's
                # bytes rot before verification — latest_verified must
                # reject it, and the old weights keep answering.
                newest = self.store.latest()
                if newest is not None and newest.leaves:
                    from edl_tpu_torch.chaos.storage import corrupt_checkpoint

                    corrupt_checkpoint(newest)
        now = time.monotonic()
        if self.store.spill_dir and now - self._last_spill_poll >= self.spill_poll_interval:
            # A training fleet in another process spills here: new steps
            # show up only on disk.  Throttled: a listing of a network
            # volume must not run between every two tokens.
            self._last_spill_poll = now
            try:
                self._poll_spill_dir(current)
            except Exception:
                self._reject("disk", current)
        newest = self.store.latest()
        if newest is None or int(newest.step) <= current:
            return False
        if int(newest.step) == self._last_rejected_step:
            # Already rejected and nothing newer since: no second hash
            # pass, no second count.
            return False
        ckpt = self.store.latest_verified()
        if ckpt is None or int(ckpt.step) <= current or not self._fits(ckpt):
            self._last_rejected_step = int(newest.step)
            self._reject("dram", current)
            return False
        self._install(ckpt)
        self._m_swaps.inc()
        self.recorder.record(
            "serve.swap",
            {"step": int(ckpt.step), "from_step": current},
            step=int(ckpt.step),
        )
        return True

    def _poll_spill_dir(self, current: int) -> None:
        """Read a spill newer than anything served or in DRAM into the
        store, where the DRAM path of ``refresh`` verifies and swaps
        it.  A manifest listing only: the bytes are read (and their CRC
        checked) once per new step.  A spill that fails is remembered,
        so later polls skip it; the exception is the rejection."""
        dram = self.store.latest()
        dram_step = int(dram.step) if dram is not None else -1
        best = -1
        for name in os.listdir(self.store.spill_dir):
            if name.endswith(".json") and ".tmp." not in name and ".shard-r" not in name:
                try:
                    best = max(best, int(name[len("ckpt-"):-len(".json")]))
                except ValueError:
                    continue
        if best > max(current, dram_step) and best != self._last_rejected_spill:
            try:
                self.store.load_from_disk(self.leaf_template()[1], step=best)
            except Exception:
                self._last_rejected_spill = best
                raise

    def warm(self) -> int:
        """Make the first request build nothing.  Eager PyTorch compiles
        nothing per shape, so unlike the JAX engine's AOT warm-up there
        is nothing to compile: on CUDA this builds (``nvcc``, when the
        source has no current build) and loads the serving path's
        kernel libraries (``ops/_build.py``).  Returns how many model
        calls it ran (none here)."""
        if self.device.type == "cuda":
            from edl_tpu_torch.ops import _build

            for name in SERVING_KERNELS:
                _build.load(name)
        self.warmed = True
        return 0

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
    partial grant), so a prompt either gets its blocks or waits.  Blocks
    are refcounted so the prefix cache (``serving/prefix.py``) can share
    a filled block among every sequence whose prompt starts with its
    tokens: ``alloc`` grants at refcount 1, ``ref`` adds an owner, and
    ``free`` drops one.  At refcount 0 a block the prefix cache
    PUBLISHED parks on an LRU of cached blocks (its K/V stays valid and
    claimable) instead of going back to the free list; ``alloc`` evicts
    that LRU only when the free list alone is short, so retention never
    starves admission.  Shared blocks are only ever read: a claiming
    sequence writes at positions past its claimed run, in its own
    blocks."""

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
        self._shape = (layers, self.num_blocks, self.block_tokens, heads, head_dim)
        self._dtype = dtype
        self._device = resolve_device(device)
        self.kpool = torch.zeros(self._shape, dtype=dtype, device=self._device)
        self.vpool = torch.zeros(self._shape, dtype=dtype, device=self._device)
        self._free = deque(range(1, self.num_blocks))
        self._ref: Dict[int, int] = {}  # owned block -> refcount
        self._published: set = set()  # prefix-indexed blocks
        self._cached: Dict[int, None] = {}  # refcount-0 published, LRU order
        self._lock = threading.Lock()
        #: called with a block id when a cached block is evicted, so the
        #: prefix index drops its entry before the id can be granted
        self.on_evict = None
        #: called (no arguments) by ``reset``: the prefix index drops
        #: whole, without counting evictions
        self.on_reset = None
        self.evictions = 0

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        """Allocatable blocks: truly free plus evictable cached."""
        return len(self._free) + len(self._cached)

    @property
    def cached_blocks(self) -> int:
        return len(self._cached)

    @property
    def used_blocks(self) -> int:
        """Blocks held by live sequences (cached ones count as free:
        they are reclaimed on demand)."""
        return self.usable_blocks - self.free_blocks

    def occupancy(self) -> float:
        return self.used_blocks / max(1, self.usable_blocks)

    def nbytes(self) -> int:
        """Device bytes of both planes."""
        return 2 * self.kpool.numel() * self.kpool.element_size()

    def _evict_locked(self) -> None:
        b = next(iter(self._cached))  # the LRU end (insertion order)
        del self._cached[b]
        self._published.discard(b)
        if self.on_evict is not None:
            self.on_evict(b)
        self._free.append(b)
        self.evictions += 1

    def evict_cached(self, n: int = 1) -> int:
        """Evict up to ``n`` LRU cached blocks back to the free list
        (``alloc`` does so lazily under pressure).  Returns how many
        were evicted."""
        with self._lock:
            k = min(int(n), len(self._cached))
            for _ in range(k):
                self._evict_locked()
            return k

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` blocks at refcount 1, or None (never a partial
        grant).  Evicts LRU cached blocks when the free list alone is
        short."""
        with self._lock:
            if n > len(self._free) + len(self._cached):
                return None
            while len(self._free) < n:
                self._evict_locked()
            got = [self._free.popleft() for _ in range(n)]
            for b in got:
                self._ref[b] = 1
            return got

    def ref(self, block: int) -> None:
        """Claim a share of an owned or cached block (prefix reuse): an
        owned block gains an owner; a cached one revives at 1."""
        b = int(block)
        with self._lock:
            if b in self._ref:
                self._ref[b] += 1
            elif b in self._cached:
                del self._cached[b]
                self._ref[b] = 1
            else:
                raise BlockOwnershipError(f"block {b} is neither owned nor cached")

    def refcount(self, block: int) -> int:
        return self._ref.get(int(block), 0)

    def publish(self, block: int) -> None:
        """Mark an owned block as prefix-indexed: at refcount 0 it parks
        on the cached LRU instead of returning to the free list."""
        b = int(block)
        with self._lock:
            if b not in self._ref and b not in self._cached:
                raise BlockOwnershipError(f"cannot publish unowned block {b}")
            self._published.add(b)

    def drop_published(self) -> None:
        """Forget every published mark (the prefix index's invalidation
        on a weight swap): cached blocks return to the free list; blocks
        live sequences still hold only lose the mark."""
        with self._lock:
            for b in self._cached:
                self._free.append(b)
            self._cached.clear()
            self._published.clear()

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
                elif b in self._published:
                    del self._ref[b]
                    self._cached[b] = None  # the MRU end of the LRU
                else:
                    del self._ref[b]
                    self._free.append(b)

    def reset(self) -> None:
        """Return every block to the free list.  Stale bytes need no
        scrub: a reused block is overwritten by its prefill, and decode
        masks never expose positions past a sequence's length.  Fires
        ``on_reset`` (not ``on_evict``): the prefix index drops whole."""
        with self._lock:
            if self.on_reset is not None:
                self.on_reset()
            self._ref.clear()
            self._published.clear()
            self._cached.clear()
            self._free = deque(range(1, self.num_blocks))

    def rebuild(self) -> None:
        """Replace both planes with fresh zeros, keeping the ownership
        state.  The cached contents are lost: the engine bumps
        ``cache_epoch`` so every live sequence re-prefills."""
        self.kpool = torch.zeros(self._shape, dtype=self._dtype, device=self._device)
        self.vpool = torch.zeros(self._shape, dtype=self._dtype, device=self._device)


class DecodeEngine(InferenceEngine):
    """KV-cached autoregressive decode on top of the single-shot engine.

    - **prefill** runs per padded prompt bucket (block-aligned powers of
      two of ``block_tokens``), one sequence per call: a joining request
      pays its own prefill.
    - **chunk** (chunked prefill) runs one block-aligned prompt slice at
      an explicit cache offset, padded to a chunk bucket (block-aligned
      powers of two up to ``max_chunk_tokens``, by default four
      blocks), attending over the window of the smallest prompt bucket
      that covers offset + chunk.  The token batcher feeds chunks under
      a per-iteration token budget, so a long admission never stalls
      the running decode; the first generated token equals
      monolithic prefill's.
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
        *,
        store=None,
        max_chunk_tokens: Optional[int] = None,
        dispatch_timeout: Optional[float] = None,
        chaos=None,
    ):
        """``dispatch_timeout``: seconds one prefill, chunk or decode call
        may take before the watchdog declares it wedged (None: the
        ``EDL_SERVE_DISPATCH_TIMEOUT`` env key; <= 0: no deadline, the
        default, where the helper-thread hop would tax every token)."""
        if model.decode is None:
            raise ValueError(
                f"model {model.name!r} declares no DecodeSpec; it can "
                "only serve single-shot forwards (InferenceEngine)"
            )
        super().__init__(model, device=device, max_batch=max_batch, store=store, chaos=chaos)
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
        #: the largest prompt slice one chunk call carries (the JAX
        #: engine's default: four blocks).  The chunk is the quantum by
        #: which prefill and decode interleave, so its cap bounds how
        #: long one admission holds up the running batch.
        if max_chunk_tokens is None:
            max_chunk_tokens = 4 * self.block_tokens
        bt = self.block_tokens
        self.max_chunk_tokens = max(
            bt, min((max_chunk_tokens // bt) * bt, self.max_context)
        )
        self.chunk_buckets: Tuple[int, ...] = _pow2_buckets(bt, self.max_chunk_tokens)
        #: bumped whenever the cache contents were lost (a dispatch
        #: failed mid-write and the pool was rebuilt): the token batcher
        #: then re-prefills every live sequence, as after a weight swap
        self.cache_epoch = 0
        # The dispatch watchdog: a wedged call (hung device runtime,
        # stuck copy) would otherwise hang the token batcher's worker
        # forever.  The call runs on an abandonable helper thread under
        # a deadline, and expiry goes into the pool rebuild and
        # cache-epoch rewind a failed call already takes.
        if dispatch_timeout is None:
            dispatch_timeout = float(os.environ.get("EDL_SERVE_DISPATCH_TIMEOUT", "0") or 0)
        self.dispatch_timeout = float(dispatch_timeout)
        self._m_wedged = self.telemetry.counter("edl_serve_dispatch_wedged_total")

        def _wedge_due() -> bool:
            c = self.chaos
            return c is not None and bool(c.due("serve.dispatch.wedged"))

        def _wedge_trip(what: str, waited: float) -> None:
            self._m_wedged.inc()
            self.recorder.record("serve.watchdog", {"what": what, "waited_s": round(waited, 3)})

        self.watchdog = CollectiveWatchdog(
            timeout=self.dispatch_timeout,
            registry=self.telemetry,
            chaos_check=_wedge_due,
            on_trip=_wedge_trip,
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

    def chunk_bucket_for(self, n: int) -> int:
        for c in self.chunk_buckets:
            if n <= c:
                return c
        raise ValueError(
            f"chunk of {n} tokens exceeds max_chunk_tokens "
            f"{self.max_chunk_tokens}"
        )

    def chunk_window_blocks(self, offset: int, chunk_bucket: int) -> int:
        """Table columns a chunk at ``offset`` gathers: the smallest
        prompt bucket covering offset + chunk, in blocks, so the work
        grows with the filled prefix."""
        return self.prompt_bucket_for(
            min(offset + chunk_bucket, self.max_context)
        ) // self.block_tokens

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

    def warm(self) -> int:
        """The kernel libraries, and with weights installed one prefill,
        one chunk and one decode, each writing only the trash block: the
        first request of a registered replica builds and loads nothing.
        Each model call journals a ``serve.warm`` event with its bucket
        and seconds.  Returns how many model calls it ran."""
        ran = super().warm()
        w = self.current_weights()
        if w is None:
            return ran
        trash = np.zeros(self.blocks_per_seq, np.int32)
        one = np.asarray([3], np.int32)
        calls = [("prefill", self.prompt_bucket_for(1), lambda: self.prefill(w, one, trash))]
        if self.spec.chunk_fn is not None:
            calls.append(("chunk", self.chunk_bucket_for(1),
                          lambda: self.prefill_chunk(w, one, 0, trash)))
        calls.append(("decode", self.decode_bucket_for(1), lambda: self.decode_step(
            w, one, np.zeros(1, np.int32), trash[None])))
        for call, bucket, run in calls:
            t0 = time.perf_counter()
            run()
            self.recorder.record(
                "serve.warm",
                {"bucket": bucket, "call": call, "model": self.model.name},
                timing={"seconds": round(time.perf_counter() - t0, 6)},
            )
        return ran + len(calls)

    def _run(self, fn, params, tokens, lengths, tables, offsets=None, what="decode") -> np.ndarray:
        args = [self._to_device(tokens)]
        if offsets is not None:
            args.append(self._to_device(offsets))
        args += [
            self._to_device(lengths),
            self.pool.kpool,
            self.pool.vpool,
            self._to_device(tables),
        ]

        def dispatch():
            # The call and its host read under one deadline: a wedged
            # runtime can hang either.  (no_grad is per thread, so it
            # is entered here, on whichever thread runs the call.)
            with torch.no_grad():
                ids, _, _ = fn(params, *args)
                return ids.cpu().numpy()

        try:
            return self.watchdog.fetch(dispatch, what=what)
        except CollectiveTimeout as e:
            # The abandoned call may still be writing the old planes:
            # the pool gets fresh ones and a new epoch, and the batcher
            # re-prefills its live sequences instead of rejecting them.
            self.pool.rebuild()
            self.cache_epoch += 1
            raise DispatchWedgedError(str(e)) from e
        except BaseException:
            # The pools are written in place, layer by layer: a call
            # that raised may have left any of its writes half done.
            # The cache is treated as lost (fresh zeros, new epoch) and
            # the batcher re-prefills every live sequence.
            self.pool.rebuild()
            self.cache_epoch += 1
            raise

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
            what="prefill",
        )
        return int(ids[0])

    def prefill_chunk(
        self,
        weights: _Weights,
        chunk: np.ndarray,
        offset: int,
        table_row: np.ndarray,
    ) -> int:
        """Run one prompt slice (1-D int32, true length) at the
        block-aligned cache ``offset``, padded to its chunk bucket.  A
        non-final chunk must be a multiple of block_tokens, so the next
        offset stays aligned.  ``table_row`` is the sequence's full
        block table; the window truncation happens here.  Returns the
        greedy id at the chunk's last real position (the first
        generated token when this is the prompt's final chunk)."""
        if self.spec.chunk_fn is None:
            raise ValueError(
                f"model {self.model.name!r} declares no chunk_fn; use "
                "monolithic prefill"
            )
        clen = int(chunk.shape[0])
        offset = int(offset)
        if offset % self.block_tokens != 0:
            raise ValueError(
                f"chunk offset {offset} not block-aligned "
                f"(block_tokens {self.block_tokens})"
            )
        bucket = self.chunk_bucket_for(clen)
        if offset + bucket > self.max_context:
            # A padded bucket past the window would write past the block
            # table; the batcher caps its chunks so the bucket fits.
            raise ValueError(
                f"chunk bucket {bucket} at offset {offset} overruns the "
                f"context window {self.max_context}; split the chunk"
            )
        wblk = self.chunk_window_blocks(offset, bucket)
        tok = np.zeros((1, bucket), np.int32)
        tok[0, :clen] = chunk
        ids = self._run(
            self.spec.chunk_fn,
            weights.params,
            tok,
            np.asarray([offset + clen], np.int32),
            np.asarray(table_row, np.int32)[None, :wblk],
            offsets=np.asarray([offset], np.int32),
            what="chunk",
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

    # -- live KV migration (device <-> host block movement) -------------------
    def export_kv(self, block_ids: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gather a sequence's filled K/V blocks to host memory for
        migration: two CPU tensors ``[layers, n, block_tokens, heads,
        head_dim]`` in the pool's dtype, each a view of block-major
        memory (block ``j``'s ``[layers, block_tokens, heads, head_dim]``
        contiguous: the wire's leaf).  Must run at a token boundary with
        the batcher frozen.  The pool is written in place on this
        device's stream, so the gather queues behind the last decode
        step's writes; the copy lands in pinned memory and waits on its
        own event, so no byte is read before it arrived."""
        ids = torch.as_tensor(list(block_ids), dtype=torch.long).to(self.device)
        planes = []
        for pool in (self.pool.kpool, self.pool.vpool):
            rows = pool.index_select(1, ids).transpose(0, 1).contiguous()
            if self.device.type == "cuda":
                host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
                host.copy_(rows, non_blocking=True)
                rows = host
            planes.append(rows.transpose(0, 1))
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()
        return planes[0], planes[1]

    def import_kv(self, block_ids: Sequence[int], k: torch.Tensor, v: torch.Tensor) -> None:
        """Scatter migrated host K/V planes (``[layers, n, block_tokens,
        heads, head_dim]``, the pool's dtype) into freshly granted pool
        blocks: the survivor's half of a live migration.  Runs on this
        device's stream, so every later decode step reads the imported
        blocks after they landed."""
        shape = (self.pool._shape[0], len(block_ids)) + self.pool._shape[2:]
        for name, plane in (("k", k), ("v", v)):
            if tuple(plane.shape) != shape or plane.dtype != self.pool._dtype:
                raise ValueError(
                    f"imported {name} plane {tuple(plane.shape)} {plane.dtype} does "
                    f"not fit the pool's {shape} {self.pool._dtype}"
                )
        ids = torch.as_tensor(list(block_ids), dtype=torch.long).to(self.device)
        nb = self.device.type == "cuda" and k.is_pinned() and v.is_pinned()
        self.pool.kpool.index_copy_(1, ids, k.to(self.device, non_blocking=nb))
        self.pool.vpool.index_copy_(1, ids, v.to(self.device, non_blocking=nb))
