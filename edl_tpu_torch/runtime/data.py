"""Deterministic sharded data iteration (counterpart of
``edl_tpu/runtime/data.py``).

The global batch of step ``k`` is a pure function of ``(seed, step)``,
and each of ``world`` trainers takes the ``rank``-th contiguous slice of
it.  A membership change then re-slices the same batch stream, and a
replay from a checkpointed step sees the same data.  The permutation is
numpy's ``RandomState`` seeded exactly as the JAX package seeds it, so
the two packages give the same bytes for every step.

``device_batch`` places a batch synchronously (the depth-0 path of the
elastic loop); ``BatchStager`` prefetches batches for the steps ahead
on a background thread, through pinned host buffers allocated once and
reused, and a side-stream copy to the card.  Both give the same bytes.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from edl_tpu_torch import DeviceLike, resolve_device


class ShardedDataIterator:
    """Index-based deterministic iterator over an in-memory dataset.

    ``dataset`` is a dict of host numpy arrays sharing a leading
    dimension.  Epoch shuffles depend on ``seed`` and the epoch number
    only, so two trainers (or one trainer before and after a resize)
    agree on every batch without communicating."""

    def __init__(
        self,
        dataset: Dict[str, np.ndarray],
        global_batch_size: int,
        seed: int = 0,
    ):
        if not dataset:
            raise ValueError("dataset must be non-empty")
        sizes = {k: len(v) for k, v in dataset.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"dataset arrays disagree on length: {sizes}")
        self.dataset = dataset
        self.n = next(iter(sizes.values()))
        if global_batch_size <= 0:
            raise ValueError("global_batch_size must be positive")
        if global_batch_size > self.n:
            raise ValueError(
                f"global_batch_size {global_batch_size} exceeds dataset size {self.n}"
            )
        self.global_batch_size = global_batch_size
        self.seed = seed
        self.batches_per_epoch = self.n // global_batch_size

    def global_indices(self, step: int) -> np.ndarray:
        """Dataset indices of step ``step``'s global batch (pure function)."""
        if step < 0:
            raise ValueError("step must be >= 0")
        epoch, within = divmod(step, self.batches_per_epoch)
        perm = np.random.RandomState(
            (self.seed * 1_000_003 + epoch) % (2**32)
        ).permutation(self.n)
        lo = within * self.global_batch_size
        return perm[lo : lo + self.global_batch_size]

    def host_batch(
        self, step: int, world: int = 1, rank: int = 0
    ) -> Dict[str, np.ndarray]:
        """Rank-local slice of the global batch for ``step``; ``world``
        only sets how the same global batch is cut."""
        if not (0 <= rank < world):
            raise ValueError(f"rank {rank} out of range for world {world}")
        if self.global_batch_size % world != 0:
            raise ValueError(
                f"global batch {self.global_batch_size} not divisible by world {world}"
            )
        idx = self.global_indices(step)
        per = self.global_batch_size // world
        sl = idx[rank * per : (rank + 1) * per]
        return {k: v[sl] for k, v in self.dataset.items()}

    def device_batch(
        self, step: int, device, world: int = 1, rank: int = 0
    ) -> Dict[str, torch.Tensor]:
        """The rank's slice of step ``step``'s global batch as tensors on
        ``device``, placed synchronously (a CUDA copy from pageable
        memory waits for the device).  The pipelined path,
        ``BatchStager``, gives the same bytes without waiting."""
        device = torch.device(device)
        return {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in self.host_batch(step, world, rank).items()
        }


class _Slot:
    """One set of pinned host buffers for a batch (one per feature) and
    the event of the last copy out of it."""

    def __init__(self, like: Dict[str, np.ndarray]):
        self.bufs = {
            k: torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype, pin_memory=True)
            for k, v in like.items()
        }
        self.event: Optional[torch.cuda.Event] = None


class BatchStager:
    """Background batch prefetcher for the steady-state pipeline
    (counterpart of ``edl_tpu/runtime/data.py`` ``BatchStager``).

    One worker thread builds the batches of the steps ahead of the
    consumer, so host-side batch assembly and the copy to the card
    overlap the device's compute of earlier steps.  Because the global
    batch is a pure function of ``(seed, step)``, prefetching changes
    WHEN a batch is built, never WHAT it contains.

    On CUDA, the worker copies each batch into one of ``depth + 1`` sets
    of pinned host buffers, allocated once per batch layout and reused
    (a set is refilled only after the event of its last copy has
    passed), then to the card on a side stream, and records an event
    after the copy.  ``get`` makes the caller's stream wait on that
    event and marks the tensors as used on it (``record_stream``): the
    step never reads a half-copied batch, and the caching allocator
    never hands the memory out while the step may still read it.

    Staged batches are keyed by a caller-supplied ``key`` (the elastic
    runtime passes its generation) and by the ``(world, rank)`` slice:
    ``rebind`` with a new one drops everything staged for the old.  A
    worker failure (or chaos ``stage.batch.failed``) marks the step
    failed and the consumer falls back to the synchronous
    ``device_batch`` — prefetch is an optimization, never a correctness
    dependency.  ``chaos``: a ``FaultSchedule`` whose
    ``stage.batch.slow`` stalls the worker and whose
    ``stage.batch.failed`` fails one staging.
    """

    #: how long ``get`` waits on an in-flight staging before building
    #: the batch itself (fires only if the worker thread died)
    WAIT_TIMEOUT = 60.0

    def __init__(
        self, data: ShardedDataIterator, depth: int = 2, device: DeviceLike = None, chaos=None
    ):
        self.data = data
        self.chaos = chaos
        self.depth = max(1, int(depth))
        self.device = resolve_device(device)
        self._cv = threading.Condition()
        self._key: Any = None
        self._slice = (1, 0)
        self._bound = False
        self._ready: Dict[int, Any] = {}
        self._failed: set = set()
        self._inflight: Optional[int] = None
        self._queue: deque = deque()
        self._thread: Optional[threading.Thread] = None
        self._slots: list = []
        self._slot_layout: Any = None
        self._next_slot = 0
        self._stream = None
        self.stats = {"staged": 0, "hits": 0, "misses": 0, "failures": 0, "pinned_sets": 0}
        from edl_tpu_torch import telemetry

        self._m_stage_seconds = telemetry.get_registry().histogram("edl_batch_stage_seconds")

    # -- lifecycle -----------------------------------------------------------
    def rebind(self, key: Any, world: int = 1, rank: int = 0) -> None:
        """Serve rank ``rank`` of ``world`` under cache key ``key``; a
        new key or slice invalidates everything staged or queued."""
        with self._cv:
            if self._bound and key == self._key and (world, rank) == self._slice:
                return
            self._key, self._slice, self._bound = key, (world, rank), True
            self._ready.clear()
            self._failed.clear()
            self._queue.clear()
            self._cv.notify_all()

    def invalidate(self, join: bool = False) -> None:
        """Drop every staged/queued batch.  ``join=True`` also waits
        (bounded) for an in-flight staging to finish."""
        with self._cv:
            self._bound = False
            self._ready.clear()
            self._failed.clear()
            self._queue.clear()
            self._cv.notify_all()
            if join:
                self._cv.wait_for(lambda: self._inflight is None, timeout=10.0)

    # -- consumer API --------------------------------------------------------
    def get(self, step: int, horizon: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The batch of ``step`` on the device, from the prefetch cache
        when staged (or in flight), synchronously otherwise; then tops
        the prefetch window back up to ``depth`` steps ahead (bounded by
        ``horizon``, the run's target step, when given)."""
        with self._cv:
            if not self._bound:
                raise RuntimeError("BatchStager.get before rebind()")
            key, (world, rank) = self._key, self._slice
            staged = self._ready.pop(step, None)
            if staged is None and step in self._queue:
                # Not started yet: build it here rather than wait.
                self._queue.remove(step)
            elif staged is None and step == self._inflight:
                self._cv.wait_for(
                    lambda: step != self._inflight or self._key != key,
                    timeout=self.WAIT_TIMEOUT,
                )
                staged = self._ready.pop(step, None)
            self._failed.discard(step)
            for s in [s for s in self._ready if s <= step]:
                del self._ready[s]
            self.stats["hits" if staged is not None else "misses"] += 1
        if staged is None:
            t0 = time.perf_counter()
            batch = self.data.device_batch(step, self.device, world, rank)
            self._m_stage_seconds.observe(time.perf_counter() - t0)
        else:
            batch, event = staged
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                for t in batch.values():
                    t.record_stream(stream)
        self._schedule_ahead(step, horizon)
        return batch

    def _schedule_ahead(self, step: int, horizon: Optional[int]) -> None:
        last = step + self.depth
        if horizon is not None:
            last = min(last, horizon - 1)
        with self._cv:
            if not self._bound:
                return
            for s in range(step + 1, last + 1):
                if s in self._ready or s in self._queue or s == self._inflight or s in self._failed:
                    continue
                self._queue.append(s)
            if self._queue and (self._thread is None or not self._thread.is_alive()):
                self._thread = threading.Thread(
                    target=self._work, daemon=True, name="edl-batch-stager"
                )
                self._thread.start()
            self._cv.notify_all()

    # -- worker --------------------------------------------------------------
    def _slot_for(self, host: Dict[str, np.ndarray]) -> _Slot:
        layout = tuple((k, v.shape, v.dtype.str) for k, v in host.items())
        if layout != self._slot_layout:
            self._slots = [_Slot(host) for _ in range(self.depth + 1)]
            self._slot_layout = layout
            self.stats["pinned_sets"] += len(self._slots)
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        if slot.event is not None:
            slot.event.synchronize()  # its last copy has left the buffers
        return slot

    def _stage(self, step: int, world: int, rank: int) -> Any:
        """Build ``step``'s batch on the worker thread: ``(tensors,
        event)``, the event None off CUDA."""
        host = self.data.host_batch(step, world, rank)
        if self.device.type != "cuda":
            return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host.items()}, None
        slot = self._slot_for(host)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        out = {}
        with torch.cuda.stream(self._stream):
            for k, v in host.items():
                buf = slot.bufs[k]
                buf.numpy()[...] = v
                out[k] = buf.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        slot.event = event
        return out, event

    def _work(self) -> None:
        while True:
            with self._cv:
                while not self._queue:
                    if not self._cv.wait(timeout=5.0):
                        return  # idle out; get() respawns on demand
                step = self._queue.popleft()
                key, (world, rank) = self._key, self._slice
                self._inflight = step
            try:
                chaos = self.chaos
                if chaos is not None:
                    for ev in chaos.due("stage.batch.slow"):
                        time.sleep(float(ev.arg or 0.05))
                    chaos.maybe_raise("stage.batch.failed")
                t0 = time.perf_counter()
                staged = self._stage(step, world, rank)
                self._m_stage_seconds.observe(time.perf_counter() - t0)
            except Exception:
                with self._cv:
                    self._inflight = None
                    if self._key == key and self._slice == (world, rank):
                        self._failed.add(step)
                        self.stats["failures"] += 1
                    self._cv.notify_all()
                continue
            with self._cv:
                self._inflight = None
                if self._bound and self._key == key and self._slice == (world, rank):
                    self._ready[step] = staged
                    self.stats["staged"] += 1
                self._cv.notify_all()


def synthetic_dataset(
    model_synth_batch, n_examples: int, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Materialize a fixed synthetic dataset from a ModelDef's batch
    generator (deterministic in ``seed``)."""
    rng = np.random.RandomState(seed)
    return model_synth_batch(rng, n_examples)


__all__ = ["BatchStager", "ShardedDataIterator", "synthetic_dataset"]
