"""The port's host-DRAM store and restore transfer
(``edl_tpu_torch/checkpoint``) on the CPU.

- ``HostDRAMStore``: dedup of a save of a step already in flight,
  ``keep`` pruning, ``latest_verified`` skipping a checkpoint whose
  bytes were flipped, restores that never alias the checkpoint, and the
  durable spill read across packages: a spill the JAX ``HostDRAMStore``
  wrote loads in the port with the same step, generation, leaf bytes and
  digest, and a spill the port wrote loads in JAX.
- ``stream_restore`` on the port's ``LoopbackFabric``, with the real TCP
  data plane on loopback (the cases of ``tests/test_restore_transfer.py``):
  a joiner moves only the leaves it lacks, identical stores move
  nothing, a torn leaf fails the restore on every member, and large
  leaves stream in chunks.
"""

import sys
import threading
import time
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from edl_tpu.checkpoint import HostDRAMStore as JaxStore
from edl_tpu_torch.checkpoint import transfer as tx
from edl_tpu_torch.checkpoint.hostdram import (
    HostCheckpoint,
    HostDRAMStore,
    LeafSpec,
    leaf_specs,
)


class _State:
    """The least a store saves: an int ``step`` and ``leaves()``."""

    def __init__(self, step, leaves):
        self.step = step
        self._leaves = leaves

    def leaves(self):
        return self._leaves


def _leaves(seed=0):
    g = torch.Generator().manual_seed(seed)
    return [
        torch.randn(64, 32, generator=g),
        torch.randn(257, 16, generator=g),  # odd row count
        torch.tensor(float(seed)),  # a 0-d step count
        torch.randn(1000, generator=g, dtype=torch.float64),
    ]


# ---- HostDRAMStore ------------------------------------------------------------


def test_save_copies_and_dedups_a_step_in_flight():
    store = HostDRAMStore(keep=2)
    leaves = _leaves()
    first = store.save_async(_State(4, leaves), generation=1)
    # The same step again, while the first save may still be in flight
    # (or has landed): no second checkpoint, no second worker.
    again = store.save_async(_State(4, leaves), generation=1)
    assert again is not first
    store.wait()
    assert store.steps() == [4]
    ckpt = store.latest()
    assert ckpt.step == 4 and ckpt.generation == 1
    for got, want in zip(ckpt.leaves, leaves):
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want.numpy())
    leaves[0].add_(1.0)  # the live state moves on; the checkpoint must not
    assert not np.array_equal(ckpt.leaves[0], leaves[0].numpy())
    # A flush of a stored step returns it with no work.
    flushed, bg = store.flush_sync(_State(4, leaves))
    assert flushed is ckpt and bg is None


def test_keep_prunes_oldest_and_flush_publishes():
    store = HostDRAMStore(keep=2)
    for step in (2, 4, 6):
        store.save_async(_State(step, _leaves(step)))
        store.wait()
    assert store.steps() == [4, 6]
    ckpt, bg = store.flush_sync(_State(7, _leaves(7)), generation=3)
    bg.join()
    assert bg.edl_error is None and bg.edl_seconds >= 0.0
    assert store.steps() == [6, 7] and store.latest() is ckpt
    assert ckpt.generation == 3 and ckpt.verify()


def test_interval_spills_coalesce_to_the_newest(tmp_path, monkeypatch):
    """While one spill is being written, newer saves queue behind it and
    only the newest is written next: host memory holds a bounded number
    of checkpoints however fast the saves come."""
    store = HostDRAMStore(keep=2, spill_dir=str(tmp_path))
    real, started, gate, spilled = store._spill, threading.Event(), threading.Event(), []

    def slow(ckpt):
        started.set()
        gate.wait(30)
        spilled.append(ckpt.step)
        real(ckpt)

    monkeypatch.setattr(store, "_spill", slow)
    store.save_async(_State(1, _leaves(1)))
    assert started.wait(30)
    for step in (2, 4, 3):
        store.save_async(_State(step, _leaves(step)))
    deadline = time.monotonic() + 30
    while store.steps() != [3, 4] or store._spill_next[1].step != 4:
        assert time.monotonic() < deadline, (store.steps(), store._spill_next)
        time.sleep(0.01)
    gate.set()
    store.wait()
    assert spilled == [1, 4]
    assert HostDRAMStore(spill_dir=str(tmp_path)).load_from_disk().step == 4


def test_concurrent_saves_keep_the_newest_and_spill_it(tmp_path):
    """Stress: more saving threads than cores, a short switch interval.
    However the saves interleave, the store keeps the ``keep`` newest
    steps, each with its own bytes, and the spill ends at the newest."""
    store = HostDRAMStore(keep=2, spill_dir=str(tmp_path))
    steps = list(range(1, 33))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [
            threading.Thread(target=lambda k=k: store.save_async(_State(k, _leaves(k))))
            for k in steps
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        store.wait(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert store.steps() == steps[-2:]
    for k in steps[-2:]:
        np.testing.assert_array_equal(store.get(k).leaves[0], _leaves(k)[0].numpy())
        assert store.get(k).verify()
    assert HostDRAMStore(spill_dir=str(tmp_path)).load_from_disk().step == steps[-1]


def test_latest_verified_skips_flipped_bytes():
    store = HostDRAMStore(keep=2)
    for step in (3, 5):
        store.save_async(_State(step, _leaves(step)))
        store.wait()
    store.latest().leaves[1].reshape(-1).view(np.uint8)[5] ^= 0xFF
    good = store.latest_verified()
    assert good.step == 3 and store.steps() == [3]


def test_restore_is_an_owned_copy_on_the_device():
    store = HostDRAMStore()
    leaves = _leaves(1)
    store.save_async(_State(2, leaves))
    store.wait()
    ckpt = store.latest()
    out = store.restore(ckpt, "cpu")
    for got, want in zip(out, leaves):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    out[0].add_(5.0)  # training on the restored state ...
    np.testing.assert_array_equal(ckpt.leaves[0], leaves[0].numpy())  # ... leaves the checkpoint
    assert leaf_specs(out) == leaf_specs(ckpt.leaves)


class _JaxState(NamedTuple):
    step: np.ndarray
    w: np.ndarray
    b: np.ndarray
    moments: np.ndarray


def test_spill_format_is_shared_with_the_jax_store(tmp_path):
    """A JAX spill loads in the port, and a port spill in JAX: same
    step, generation, leaf bytes and digest."""
    rng = np.random.RandomState(0)
    jstate = _JaxState(
        np.asarray(7, np.int32),
        rng.randn(16, 8).astype(np.float32),
        rng.randn(8).astype(np.float32),
        rng.randn(3, 5).astype(np.float64),
    )
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jstore = JaxStore(spill_dir=str(jax_dir))
    jstore.save_async(jstate, generation=3)
    jstore.wait()
    jckpt = jstore.latest()

    got = HostDRAMStore(spill_dir=str(jax_dir)).load_from_disk(leaf_specs(jckpt.leaves))
    assert (got.step, got.generation) == (7, 3)
    assert got.digest() == jckpt.digest() and got.leaf_digests() == jckpt.leaf_digests()
    for a, b in zip(got.leaves, jckpt.leaves):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()

    leaves = [torch.from_numpy(np.asarray(x).copy()) for x in jax.tree_util.tree_leaves(jstate)]
    pstore = HostDRAMStore(spill_dir=str(port_dir))
    pstore.save_async(_State(9, leaves), generation=4)
    pstore.wait()
    pckpt = pstore.latest()
    back = JaxStore(spill_dir=str(port_dir)).load_from_disk(jstate)
    assert (back.step, back.generation) == (9, 4)
    assert back.digest() == pckpt.digest()
    for a, b in zip(back.leaves, pckpt.leaves):
        assert a.tobytes() == b.tobytes()

    with pytest.raises(ValueError, match="does not match"):
        HostDRAMStore(spill_dir=str(jax_dir)).load_from_disk([LeafSpec((1,), np.float32)])
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        HostDRAMStore(spill_dir=str(tmp_path / "empty")).load_from_disk()


# ---- stream_restore -------------------------------------------------------------


def _ckpt(leaves, step):
    return HostCheckpoint(step=step, generation=1, leaves=list(leaves))


def _np_leaves(seed):
    return [t.numpy().copy() for t in _leaves(seed)]


def _run_world(member_fns):
    """One ``stream_restore`` agreement across in-process members, each
    on its own thread.  Returns (results, errors)."""
    world = tx.LoopbackWorld(len(member_fns))
    results = [None] * len(member_fns)
    errors = [None] * len(member_fns)

    def runner(rank, fn):
        try:
            results[rank] = fn(world.fabric(rank))
        except BaseException as e:  # noqa: BLE001 - returned to the test
            errors[rank] = e

    threads = [threading.Thread(target=runner, args=(r, fn), daemon=True) for r, fn in enumerate(member_fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "member thread hung"
    return results, errors


def test_single_joiner_moves_only_missing_leaves():
    leaves = _np_leaves(0)
    stale = [leaves[0], leaves[1] + 1.0, np.asarray(leaves[2] - 5.0), leaves[3]]
    template = leaf_specs(leaves)
    missing = leaves[1].nbytes + leaves[2].nbytes
    placed = []
    (r0, r1), errors = _run_world([
        lambda f: tx.stream_restore(f, template, _ckpt(leaves, 20)),
        lambda f: tx.stream_restore(f, template, _ckpt(stale, 15), on_leaf=lambda i, a: placed.append(i)),
    ])
    assert errors == [None, None]
    assert r0.stats.mode == r1.stats.mode == "delta"
    assert r0.stats.step == r1.stats.step == 20
    assert r1.stats.bytes_received == r0.stats.bytes_sent == r0.stats.bytes_scheduled == missing
    assert (r1.stats.leaves_received, r1.stats.leaves_skipped) == (2, 2)
    assert sorted(placed) == [0, 1, 2, 3]
    for got, want in zip(r1.leaves, leaves):
        assert got.tobytes() == want.tobytes()
    assert r1.leaves[0] is stale[0] and r1.leaves[3] is stale[3]  # adopted, not copied


def test_identical_stores_move_nothing():
    leaves = _np_leaves(2)
    template = leaf_specs(leaves)
    (r0, r1), errors = _run_world([
        lambda f: tx.stream_restore(f, template, _ckpt([x.copy() for x in leaves], 5)),
        lambda f: tx.stream_restore(f, template, _ckpt([x.copy() for x in leaves], 5)),
    ])
    assert errors == [None, None]
    for r in (r0, r1):
        assert r.stats.mode == "local"
        assert r.stats.bytes_received == r.stats.bytes_sent == r.stats.bytes_scheduled == 0
    (n0, n1), _ = _run_world([lambda f: tx.stream_restore(f, template, None)] * 2)
    assert n0.stats.mode == n1.stats.mode == "init"


def test_torn_leaf_fails_the_restore_on_every_member():
    """Bytes that rotted on the source after it hashed them carry
    self-consistent chunk CRCs; the receiver catches them against the
    source's advertised digest, and the confirmation gather fails the
    restore on EVERY member.  The rotted leaf never reaches placement."""
    leaves = _np_leaves(7)
    src = _ckpt(leaves, 6)
    src.leaf_digests()  # what the agreement advertises ...
    rotted = leaves[1].copy()
    rotted.reshape(-1).view(np.uint8)[7] ^= 0xFF
    src.leaves[1] = rotted  # ... and what the wire carries
    placed = []
    _, errors = _run_world([
        lambda f: tx.stream_restore(f, leaf_specs(leaves), src),
        lambda f: tx.stream_restore(f, leaf_specs(leaves), None, on_leaf=lambda i, a: placed.append(i)),
    ])
    assert all(isinstance(e, tx.TornTransferError) for e in errors), errors
    assert "member(s) [1]" in str(errors[0])
    assert 1 not in placed and len(placed) == len(leaves) - 1


def test_chunked_transfer_splits_large_leaves():
    leaves = _np_leaves(4)
    template = leaf_specs(leaves)
    chunks = sum(max(1, -(-x.nbytes // 1024)) for x in leaves)
    (_, r1), errors = _run_world([
        lambda f: tx.stream_restore(f, template, _ckpt(leaves, 3), chunk_bytes=1024),
        lambda f: tx.stream_restore(f, template, None, chunk_bytes=1024),
    ])
    assert errors == [None, None]
    assert r1.stats.bytes_received == sum(x.nbytes for x in leaves)
    assert r1.stats.chunks_received == chunks
    for got, want in zip(r1.leaves, leaves):
        assert got.tobytes() == want.tobytes()
    merged = _ckpt(r1.leaves, 3)
    merged.adopt_digests(r1.leaf_digests)
    assert merged.verify()
