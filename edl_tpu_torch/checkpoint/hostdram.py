"""Asynchronous host-DRAM checkpoints (counterpart of
``edl_tpu/checkpoint/hostdram.py``).

A recent checkpoint must always be warm in host DRAM so a membership
change never waits on storage.  The store keeps the last ``keep``
checkpoints, plus an optional durable spill in the JAX package's format
(``ckpt-{step:012d}.npz`` holding ``leaf_{i}``, and a ``.json``
manifest with ``step``, ``generation``, ``created_at``, ``n_leaves``,
``digest``, ``digest_v: 2`` and ``leaf_digests``), so either package
reads the other's spills.

A checkpoint is a flat list of leaves: the state's ``leaves()`` (for a
``TrainState``: the float32 parameters, then Adam's ``exp_avg``,
``exp_avg_sq`` and ``step`` for each parameter).

- **The device-to-host copy** lands in pinned host buffers that are
  allocated once per leaf layout and reused (``PINNED``): a buffer goes
  back to the pool when the last reference to its leaf is gone.  The
  copy runs on a side CUDA stream ordered after the step's last kernel
  by an event.  ``save_async`` first snapshots the leaves on the card
  (the step loop updates the state in place right after), so the copy
  overlaps the next steps; ``flush_sync`` (the resize barrier, where no
  step runs) copies the live leaves and waits for the copy before it
  returns — the copy must land before the world is torn down.
- **The crc32 leaf digests and the durable spill** run on background
  threads, never on the step's or the barrier's critical path.  Interval
  saves spill through one worker that always takes the newest saved
  checkpoint: when saves come faster than a spill takes, the ones a
  newer save superseded before their spill began are not written (the
  directory keeps only the newest ``keep`` anyway), so the checkpoints
  alive in host memory stay bounded.  The JAX store spills every save
  on its own thread.

Chaos (``chaos=``, a ``FaultSchedule``; None in production, one branch
per save): ``checkpoint.save_thread`` kills an async save or a flush,
``checkpoint.spill`` fails the durable write with an ``OSError`` (the
DRAM copy stays warm), and ``flush.spill.slow`` stalls a flush's
background hash and spill.  The store also carries the schedule to its
readers: the elastic trainer, the batch stager, the restore transfer
and the watchdog consult ``store.chaos``.

Not ported yet: the JAX package's shard layouts, shard-only residency,
``bind_fabric`` and everything of ``checkpoint/fabric.py``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import weakref
import zlib
from collections import namedtuple
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from edl_tpu_torch import DeviceLike, resolve_device

#: shape and numpy dtype of one leaf: the schema a restore agreement
#: and a cold load check leaves against
LeafSpec = namedtuple("LeafSpec", "shape dtype")


def leaf_specs(leaves: Sequence[Any]) -> List[LeafSpec]:
    """The ``LeafSpec`` of each leaf (tensors or numpy arrays)."""
    out = []
    for leaf in leaves:
        dtype = leaf.dtype
        if isinstance(dtype, torch.dtype):
            dtype = torch.empty((), dtype=dtype).numpy().dtype
        out.append(LeafSpec(tuple(leaf.shape), np.dtype(dtype)))
    return out


def _leaf_crc(leaf: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(leaf).reshape(-1).view(np.uint8))


def _legacy_chained_crc(leaves: List[np.ndarray]) -> int:
    """The pre-digest_v2 fingerprint (crc32 chained over raw leaf
    bytes) — kept only to verify durable spills written by older
    revisions of the JAX package."""
    crc = 0
    for leaf in leaves:
        crc = zlib.crc32(np.ascontiguousarray(leaf).reshape(-1).view(np.uint8), crc)
    return crc


def _pack_leaf_digests(leaf_digests: List[int]) -> int:
    """Whole-checkpoint fingerprint: crc32 over the packed per-leaf
    crc32 vector (one memory pass yields both granularities)."""
    return zlib.crc32(np.asarray(leaf_digests, np.uint32).tobytes())


class PinnedPool:
    """Pinned host buffers by (shape, dtype), allocated once and reused.

    ``take`` hands out a numpy view of a pinned tensor and registers a
    finalizer on the view: when the last reference to it (or to any
    view derived from it) is gone, the tensor returns to the free list.
    So a buffer is never reused while a checkpoint, a transfer or a
    restore still reads it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._free: Dict[tuple, List[torch.Tensor]] = {}
        #: pinned tensors ever allocated, and their bytes
        self.allocations = 0
        self.allocated_bytes = 0

    def take(self, shape, dtype: torch.dtype) -> Tuple[np.ndarray, torch.Tensor]:
        key = (tuple(shape), dtype)
        with self._lock:
            free = self._free.get(key)
            t = free.pop() if free else None
        if t is None:
            t = torch.empty(key[0], dtype=dtype, pin_memory=True)
            with self._lock:
                self.allocations += 1
                self.allocated_bytes += t.numel() * t.element_size()
        arr = t.numpy()
        weakref.finalize(arr, self._give, key, t)
        return arr, t

    def _give(self, key, t: torch.Tensor) -> None:
        with self._lock:
            self._free.setdefault(key, []).append(t)

    def free_count(self, shape, dtype: torch.dtype) -> int:
        with self._lock:
            return len(self._free.get((tuple(shape), dtype), ()))

    def reserve(self, shape, dtype: torch.dtype, n: int) -> None:
        """Make sure ``n`` buffers of this layout wait in the free list."""
        while self.free_count(shape, dtype) < n:
            t = torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
            with self._lock:
                self.allocations += 1
                self.allocated_bytes += t.numel() * t.element_size()
                self._free.setdefault((tuple(shape), dtype), []).append(t)


#: the process's pinned pool: checkpoints of every store share it, so a
#: store made after another one was dropped reuses its buffers
PINNED = PinnedPool()


@dataclass
class HostCheckpoint:
    """One materialized checkpoint: host numpy leaves in the state's
    leaf order."""

    step: int
    generation: int
    leaves: List[np.ndarray]
    created_at: float = 0.0
    save_seconds: float = 0.0

    def nbytes(self) -> int:
        return sum(x.nbytes for x in self.leaves)

    def _leaf_crcs(self) -> List[int]:
        return [_leaf_crc(leaf) for leaf in self.leaves]

    def leaf_digests(self) -> List[int]:
        """Per-leaf crc32 fingerprints, cached: the currency of the
        delta-aware restore agreement (``checkpoint/transfer.py``).
        Thread-safe: the background hash and the restore agreement may
        ask at once, and one pass serves both."""
        with self._hash_lock:
            if self._leaf_digests is None:
                self._leaf_digests = self._leaf_crcs()
            return self._leaf_digests

    def digest(self) -> int:
        """Content fingerprint (crc32 over the per-leaf crc vector),
        cached."""
        with self._hash_lock:
            if self._digest is None:
                self._digest = _pack_leaf_digests(self.leaf_digests())
            return self._digest

    def verify(self) -> bool:
        """Whether the leaves still hash to the digest recorded when it
        was first computed.  With no recorded digest there is nothing
        to check against: record one now and report clean."""
        with self._hash_lock:
            if self._digest is None:
                self.digest()
                return True
            fresh = self._leaf_crcs()
            if _pack_leaf_digests(fresh) != self._digest:
                return False
            self._leaf_digests = fresh
            return True

    def adopt_digests(self, leaf_digests: List[int]) -> None:
        """Install externally verified per-leaf digests (the restore
        transfer checked every received leaf against the source's
        advertisement, so no re-hash pass is needed)."""
        with self._hash_lock:
            self._leaf_digests = [int(d) for d in leaf_digests]
            self._digest = _pack_leaf_digests(self._leaf_digests)

    _digest: Optional[int] = field(default=None, repr=False, compare=False)
    _leaf_digests: Optional[List[int]] = field(default=None, repr=False, compare=False)
    _hash_lock: Any = field(default_factory=threading.RLock, repr=False, compare=False)


class HostDRAMStore:
    """Always-warm checkpoint store in host DRAM.

    Each ``save_async`` finishes on its own daemon thread.  Saves of a
    step already stored or in flight are deduped (an interval save and
    a resize flush landing on the same step), and disk spills use
    unique tmp names with an atomic rename."""

    def __init__(self, keep: int = 2, spill_dir: Optional[str] = None, chaos=None):
        """``chaos``: optional ``FaultSchedule`` (see the module doc)."""
        self.keep = keep
        self.spill_dir = spill_dir
        self.chaos = chaos
        from edl_tpu_torch import telemetry

        reg = telemetry.get_registry()
        self.recorder = telemetry.get_recorder()
        self._m_saves = reg.counter("edl_checkpoint_saves_total")
        self._m_save_bytes = reg.counter("edl_checkpoint_bytes_total")
        self._m_save_seconds = reg.histogram("edl_checkpoint_save_seconds")
        self._lock = threading.Lock()
        self._checkpoints: Dict[int, HostCheckpoint] = {}
        self._pending: List[threading.Thread] = []
        self._inflight_steps: set = set()
        #: (save_id, error): errors of abandoned saves are discarded by
        #: ``wait`` instead of degrading a later resize
        self._save_errors: List[tuple] = []
        #: the newest saved checkpoint waiting for the spill worker
        self._spill_next: Optional[Tuple[int, HostCheckpoint]] = None
        self._spill_thread: Optional[threading.Thread] = None
        self._save_seq = 0
        self._abandoned_saves: set = set()
        self._tmp_counter = 0
        self._streams: Dict[Any, Any] = {}

    # -- device to host -------------------------------------------------------
    def _side_stream(self, device: torch.device):
        s = self._streams.get(device)
        if s is None:
            s = self._streams[device] = torch.cuda.Stream(device=device)
        return s

    def _copy_to_host(self, leaves: Sequence[torch.Tensor], snapshot: bool):
        """Issue the device-to-host copy of ``leaves``; returns (host
        numpy leaves, a function that waits for the copy).

        CUDA leaves go into pinned buffers on a side stream that waits
        on an event recorded on the current stream after the step's
        last kernel.  With ``snapshot`` they are first copied on the
        card (on the current stream, before any later step can write
        them), so the host copy may run under the next steps; the
        snapshot is marked in use on the side stream until the copy is
        done.  CPU leaves are copied at once."""
        host: List[np.ndarray] = []
        cuda = [t for t in leaves if t.is_cuda]
        if not cuda:
            return [t.detach().numpy().copy() for t in leaves], lambda: None
        device = cuda[0].device
        main = torch.cuda.current_stream(device)
        side = self._side_stream(device)
        srcs = [t.detach().clone() if (snapshot and t.is_cuda) else t.detach() for t in leaves]
        ready = torch.cuda.Event()
        ready.record(main)
        side.wait_event(ready)
        with torch.cuda.stream(side):
            for src in srcs:
                if src.is_cuda:
                    arr, pinned = PINNED.take(src.shape, src.dtype)
                    pinned.copy_(src, non_blocking=True)
                    src.record_stream(side)
                else:
                    arr = src.numpy().copy()
                host.append(arr)
        done = torch.cuda.Event()
        done.record(side)
        return host, done.synchronize

    def _reserve_like(self, leaves: Sequence[np.ndarray]) -> None:
        """Keep a spare set of pinned buffers for a checkpoint like
        ``leaves`` (allocated here, on a background thread), so the next
        save or flush allocates nothing on the critical path."""
        need: Dict[tuple, int] = {}
        for leaf in leaves:
            if isinstance(leaf.base, torch.Tensor) and leaf.base.is_pinned():
                key = (leaf.shape, leaf.base.dtype)
                need[key] = need.get(key, 0) + 1
        for (shape, dtype), n in need.items():
            PINNED.reserve(shape, dtype, n)

    def _publish(self, ckpt: HostCheckpoint) -> None:
        with self._lock:
            self._checkpoints[ckpt.step] = ckpt
            for s in sorted(self._checkpoints)[: -self.keep]:
                del self._checkpoints[s]

    # -- save -----------------------------------------------------------------
    def save_async(self, state, generation: int = 0) -> threading.Thread:
        """Snapshot ``state`` into host DRAM without blocking the step
        loop.  ``state``: a ``TrainState``, or any object with an int
        ``step`` and a ``leaves()`` list of tensors.  Returns the worker
        thread (join it, or call ``wait()``)."""
        t0 = time.perf_counter()
        step_val = int(state.step)
        with self._lock:
            if step_val in self._checkpoints or step_val in self._inflight_steps:
                th = threading.Thread(target=lambda: None, daemon=True)
                th.start()
                return th
            self._inflight_steps.add(step_val)
            self._save_seq += 1
            save_id = self._save_seq
        try:
            host, copied = self._copy_to_host(state.leaves(), snapshot=True)
        except BaseException:
            with self._lock:
                self._inflight_steps.discard(step_val)
            raise
        # Journaled at submission, on the caller's thread, so the event
        # order is deterministic; duration and bytes go to the metrics.
        self.recorder.record(
            "checkpoint.save", {"step": step_val, "kind": "async"},
            step=step_val, generation=generation,
        )

        def work():
            try:
                copied()
                if self.chaos is not None:
                    # chaos[checkpoint.save_thread]: the async save
                    # worker dies (after its copy landed, so no copy is
                    # left writing a pinned buffer) — the next wait()
                    # surfaces it and a resize degrades to replay.
                    self.chaos.maybe_raise("checkpoint.save_thread")
                self._reserve_like(host)
                ckpt = HostCheckpoint(
                    step=step_val,
                    generation=generation,
                    leaves=host,
                    created_at=time.time(),
                    save_seconds=time.perf_counter() - t0,
                )
                ckpt.digest()
                self._publish(ckpt)
                self._m_saves.inc(kind="async")
                self._m_save_bytes.inc(ckpt.nbytes(), kind="async")
                self._m_save_seconds.observe(ckpt.save_seconds, kind="async")
                if self.spill_dir:
                    self._queue_spill(save_id, ckpt)
            except BaseException as e:
                with self._lock:
                    self._save_errors.append((save_id, e))
            finally:
                with self._lock:
                    self._inflight_steps.discard(step_val)

        th = threading.Thread(target=work, daemon=True, name=f"ckpt-save-{step_val}")
        th.edl_save_id = save_id
        self._track(th)
        th.start()
        return th

    def _queue_spill(self, save_id: int, ckpt: HostCheckpoint) -> None:
        """Hand ``ckpt`` to the spill worker; it supersedes a queued
        older one whose spill has not begun."""
        with self._lock:
            if self._spill_next is None or self._spill_next[1].step < ckpt.step:
                self._spill_next = (save_id, ckpt)
            if self._spill_thread is not None and self._spill_thread.is_alive():
                return
            th = self._spill_thread = threading.Thread(
                target=self._spill_loop, daemon=True, name="ckpt-spill"
            )
        self._track(th)
        th.start()

    def _spill_loop(self) -> None:
        while True:
            with self._lock:
                item, self._spill_next = self._spill_next, None
                if item is None:
                    self._spill_thread = None
                    return
            save_id, ckpt = item
            try:
                self._spill(ckpt)
            except BaseException as e:
                with self._lock:
                    self._save_errors.append((save_id, e))

    def _track(self, th: threading.Thread) -> None:
        with self._lock:
            self._pending = [p for p in self._pending if p.ident is None or p.is_alive()]
            self._pending.append(th)

    def flush_sync(self, state, generation: int = 0):
        """The resize-window flush: device-to-host ORDERED, fingerprint
        and spill OVERLAPPED.

        Returns ``(ckpt, background_thread_or_None)``.  Only the copy
        to host runs before this returns (it must precede the world's
        teardown); the crc fingerprint and the durable spill run on the
        returned thread, which the caller joins before the resize ends.
        A background failure is recorded on the thread (``edl_error``),
        not in the store, so it never degrades a later resize.  A step
        already stored returns its checkpoint with no work; a save of
        the same step in flight is waited out."""
        t0 = time.perf_counter()
        step_val = int(state.step)
        for _ in range(2):
            with self._lock:
                ckpt = self._checkpoints.get(step_val)
                inflight = step_val in self._inflight_steps
            if ckpt is not None:
                return ckpt, None
            if not inflight:
                break
            self.wait()
        with self._lock:
            self._inflight_steps.add(step_val)
            self._save_seq += 1
            save_id = self._save_seq
        try:
            if self.chaos is not None:
                # chaos[checkpoint.save_thread]: the flush dies before
                # its copy; the resize degrades to the interval
                # checkpoint and replay.
                self.chaos.maybe_raise("checkpoint.save_thread")
            host, copied = self._copy_to_host(state.leaves(), snapshot=False)
            copied()
        except BaseException:
            with self._lock:
                self._inflight_steps.discard(step_val)
            raise
        ckpt = HostCheckpoint(
            step=step_val,
            generation=generation,
            leaves=host,
            created_at=time.time(),
            save_seconds=time.perf_counter() - t0,
        )
        self._publish(ckpt)
        self._m_saves.inc(kind="flush")
        self._m_save_bytes.inc(ckpt.nbytes(), kind="flush")
        self._m_save_seconds.observe(ckpt.save_seconds, kind="flush")
        self.recorder.record(
            "checkpoint.save", {"step": step_val, "kind": "flush"},
            step=step_val, generation=generation,
        )

        def finish():
            t1 = time.perf_counter()
            try:
                if self.chaos is not None:
                    # chaos[flush.spill.slow]: the background hash and
                    # spill stall; the resize window overlaps the stall
                    # and joins it before it ends.
                    for ev in self.chaos.due("flush.spill.slow"):
                        time.sleep(float(ev.arg or 0.05))
                self._reserve_like(host)
                ckpt.digest()
                if self.spill_dir:
                    self._spill(ckpt)
            except BaseException as e:
                th.edl_error = e
            finally:
                th.edl_seconds = time.perf_counter() - t1
                with self._lock:
                    self._inflight_steps.discard(step_val)

        th = threading.Thread(target=finish, daemon=True, name=f"ckpt-flush-{step_val}")
        th.edl_save_id = save_id
        th.edl_error = None
        th.edl_seconds = 0.0
        self._track(th)
        th.start()
        return ckpt, th

    def wait(self, timeout: Optional[float] = None):
        """Block until all in-flight saves have landed; re-raise their
        errors.  ``timeout``: total seconds; saves still running then
        are marked abandoned and their later errors discarded."""
        deadline = None if timeout is None else time.monotonic() + timeout
        still_alive: List[threading.Thread] = []
        while not still_alive:
            # A save worker hands its checkpoint to the spill worker on
            # its way out: go round until no thread is left.
            with self._lock:
                pending = list(self._pending)
                self._pending.clear()
            if not pending:
                break
            for th in pending:
                if deadline is None:
                    th.join()
                else:
                    th.join(max(0.0, deadline - time.monotonic()))
                    if th.is_alive():
                        still_alive.append(th)
        with self._lock:
            if still_alive:
                self._pending.extend(still_alive)
                for th in still_alive:
                    sid = getattr(th, "edl_save_id", None)
                    if sid is not None:
                        self._abandoned_saves.add(sid)
            live = [(sid, e) for sid, e in self._save_errors if sid not in self._abandoned_saves]
            self._save_errors.clear()
            if live:
                raise RuntimeError("async checkpoint save failed") from live[0][1]

    def put(self, ckpt: HostCheckpoint) -> None:
        """Adopt an externally produced checkpoint (e.g. one assembled
        by the restore transfer when joining a multi-member world)."""
        ckpt.digest()
        self._publish(ckpt)

    # -- query ----------------------------------------------------------------
    def latest(self) -> Optional[HostCheckpoint]:
        with self._lock:
            if not self._checkpoints:
                return None
            return self._checkpoints[max(self._checkpoints)]

    def get(self, step: int) -> Optional[HostCheckpoint]:
        with self._lock:
            return self._checkpoints.get(step)

    def latest_verified(self) -> Optional[HostCheckpoint]:
        """Newest checkpoint whose bytes still match the digest recorded
        at save time; a corrupted one is dropped (with a stderr note)
        and the next-oldest is tried."""
        while True:
            with self._lock:
                if not self._checkpoints:
                    return None
                step = max(self._checkpoints)
                ckpt = self._checkpoints[step]
            if ckpt.verify():
                return ckpt
            print(
                f"[edl] checkpoint step {step} failed CRC verification "
                "(corrupted in store); discarding and falling back to "
                "the next-oldest snapshot",
                file=sys.stderr,
            )
            with self._lock:
                if self._checkpoints.get(step) is ckpt:
                    del self._checkpoints[step]

    def steps(self) -> List[int]:
        with self._lock:
            return sorted(self._checkpoints)

    # -- restore --------------------------------------------------------------
    def restore(self, ckpt: HostCheckpoint, device: DeviceLike = None) -> List[torch.Tensor]:
        """The checkpoint's leaves as tensors on ``device`` (CUDA unless
        the caller names another).  Each is an owned copy, never a view
        of the checkpoint's host buffers: the state is updated in place
        by later steps, and the checkpoint must not follow it."""
        device = resolve_device(device)
        out = []
        for leaf in ckpt.leaves:
            t = torch.from_numpy(np.ascontiguousarray(leaf)).reshape(leaf.shape)
            if device.type == "cuda":
                out.append(t.to(device, non_blocking=t.is_pinned()))
            else:
                out.append(t.clone())
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        return out

    # -- durable spill ----------------------------------------------------------
    def _spill(self, ckpt: HostCheckpoint) -> None:
        if self.chaos is not None:
            # chaos[checkpoint.spill]: durable-volume I/O error (full
            # disk, detached volume) — it surfaces through wait() while
            # the DRAM copy stays warm and restorable.
            self.chaos.maybe_raise("checkpoint.spill", OSError)
        os.makedirs(self.spill_dir, exist_ok=True)
        with self._lock:
            self._tmp_counter += 1
            tag = f"{os.getpid()}-{self._tmp_counter}"
        path = os.path.join(self.spill_dir, f"ckpt-{ckpt.step:012d}")
        tmp_npz = f"{path}.{tag}.tmp.npz"
        np.savez(tmp_npz, **{f"leaf_{i}": a for i, a in enumerate(ckpt.leaves)})
        os.replace(tmp_npz, path + ".npz")
        manifest = {
            "step": ckpt.step,
            "generation": ckpt.generation,
            "created_at": ckpt.created_at,
            "n_leaves": len(ckpt.leaves),
            "digest": ckpt.digest(),
            "digest_v": 2,
            "leaf_digests": ckpt.leaf_digests(),
        }
        tmp_json = f"{path}.{tag}.tmp.json"
        with open(tmp_json, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp_json, path + ".json")
        # Keep the newest ``keep`` spills (best-effort: several members
        # may share the directory and prune concurrently).
        try:
            for name in self._spill_names()[: -self.keep]:
                base = os.path.join(self.spill_dir, name[: -len(".json")])
                for suffix in (".json", ".npz"):
                    try:
                        os.unlink(base + suffix)
                    except OSError:
                        pass
        except OSError:  # pragma: no cover - listdir race
            pass

    def _spill_names(self) -> List[str]:
        return sorted(
            f
            for f in os.listdir(self.spill_dir)
            if f.endswith(".json") and ".tmp." not in f and ".shard-r" not in f
        )

    def load_from_disk(
        self, template: Optional[Sequence[Any]] = None, step: Optional[int] = None
    ) -> HostCheckpoint:
        """Rehydrate a spilled checkpoint (the newest intact one, or
        ``step``).  ``template``: optional leaves or ``LeafSpec``s the
        spill must match (count, shape, dtype).  Raises
        ``FileNotFoundError`` when nothing was spilled; a spill whose
        bytes fail their recorded digest is skipped for the next-oldest
        (or raises, when ``step`` names it or every spill is corrupt)."""
        if not self.spill_dir:
            raise ValueError("store has no spill_dir")
        corrupt: set = set()
        race_retries = 0
        while True:
            names = self._spill_names()
            if step is None:
                intact = [n for n in names if n not in corrupt]
                if not intact:
                    if corrupt:
                        raise RuntimeError(
                            f"all {len(corrupt)} durable checkpoint(s) in "
                            f"{self.spill_dir} failed CRC verification "
                            "(corrupt volume?); refusing to silently "
                            "restart from step 0"
                        )
                    raise FileNotFoundError(f"no checkpoints in {self.spill_dir}")
                name = intact[-1]
            else:
                name = f"ckpt-{step:012d}.json"
                if name not in names:
                    raise FileNotFoundError(f"no checkpoint for step {step}")
            try:
                with open(os.path.join(self.spill_dir, name)) as f:
                    manifest = json.load(f)
                with np.load(os.path.join(self.spill_dir, name[: -len(".json")] + ".npz")) as z:
                    leaves = [z[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
            except OSError:
                # A peer pruned it under us (retry the scan) or the
                # bytes are gone (raise rather than restart at step 0).
                race_retries += 1
                if race_retries >= 3:
                    raise RuntimeError(
                        f"durable checkpoint {name} in {self.spill_dir} has "
                        "a manifest but unreadable bytes (corrupt volume?); "
                        "refusing to silently restart from step 0"
                    ) from None
                time.sleep(0.2)
                continue
            if template is not None and leaf_specs(template) != leaf_specs(leaves):
                raise ValueError(
                    f"durable checkpoint {name} does not match the model's "
                    f"leaves ({len(leaves)} leaves spilled, "
                    f"{len(template)} expected, or shapes/dtypes differ)"
                )
            ckpt = HostCheckpoint(
                step=manifest["step"],
                generation=manifest["generation"],
                leaves=leaves,
                created_at=manifest["created_at"],
            )
            if manifest.get("digest_v") == 2:
                ckpt._digest = manifest.get("digest")
                if manifest.get("leaf_digests") is not None:
                    ckpt._leaf_digests = [int(d) for d in manifest["leaf_digests"]]
                ok = ckpt.verify()
            elif manifest.get("digest") is not None:
                ok = _legacy_chained_crc(leaves) == manifest["digest"]
                if ok:
                    ckpt.digest()
            else:
                ok = ckpt.verify()
            if ok:
                break
            if step is not None:
                raise RuntimeError(
                    f"durable checkpoint {name} in {self.spill_dir} "
                    "failed CRC verification (corrupt volume?)"
                )
            print(
                f"[edl] durable checkpoint {name} failed CRC "
                "verification; falling back to the next-oldest spill",
                file=sys.stderr,
            )
            corrupt.add(name)
        self._publish(ckpt)
        return ckpt


__all__ = ["HostCheckpoint", "HostDRAMStore", "LeafSpec", "PINNED", "PinnedPool", "leaf_specs"]
