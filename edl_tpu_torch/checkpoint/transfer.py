"""Streaming delta-aware restore transfer — the joiner recovery path
(counterpart of ``edl_tpu/checkpoint/transfer.py``).

A joiner's state moves the way in-memory checkpointing systems (Gemini
SOSP'23, CheckFreq FAST'21) structure peer recovery traffic: chunked,
overlapped, and minimized to what the joiner actually lacks.  So:

1. **Delta-aware agreement.**  Members all-gather a tiny int64 vector:
   (msg-tag, have, step, digest, ip, port) + one crc32 PER LEAF
   (``HostCheckpoint.leaf_digests``).  Everyone derives the same
   source (newest checkpoint, ties to lowest rank) and the same
   need-matrix: member r needs leaf i iff its leaf digest differs from
   the source's.  A graceful resize with one fresh joiner therefore
   moves only the joiner's missing leaves; a partially-diverged store
   moves only the diverged leaves; identical stores move nothing.
2. **Chunked pipelined transfer.**  State bytes move over plain TCP
   between hosts (recovery traffic stays out of the training
   collectives), in fixed-size chunks (default 64MB).  The source
   serves each receiver from a background thread and sends only that
   receiver's missing leaves; the receiver ``recv_into``s straight
   into the destination leaf buffer and hands each completed leaf to
   ``on_leaf`` immediately, so device placement of received leaves
   overlaps the remaining network transfer.  Peak host memory is ~1x
   state + socket buffers (the old path peaked near 3x).
3. **Zero-copy adoption.**  No zeros template, no post-transfer
   ``np.asarray`` pass, no re-hash: every chunk carries a crc32 the
   receiver verifies on arrival, so the assembled checkpoint adopts
   the source's advertised digests directly
   (``HostCheckpoint.adopt_digests``) and feeds the
   corruption-fallback machinery (``verify``/``latest_verified``)
   unchanged.  A torn chunk surfaces as ``TornTransferError`` after
   the stream drains (collective-safe: the socket is consumed either
   way) and the caller degrades to the next-oldest verified snapshot
   instead of poisoning the joiner.

The collective fabric is abstracted (``TorchProcessFabric`` over a gloo
``all_gather`` of the live ``torch.distributed`` world;
``LoopbackWorld`` barriers N threads in-process for tests) but the TCP
data plane is the REAL one in both — unit tests count actual bytes on
the wire.  Chaos (``chaos=``, a ``FaultSchedule``): ``transfer.chunk.slow``
stalls the source before a chunk send, ``transfer.chunk.torn`` flips a
byte of one received chunk, which the CRCs must catch.  The JAX
package's retired ``monolithic_broadcast_restore`` is not ported.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from edl_tpu_torch.checkpoint.hostdram import HostCheckpoint

#: default transfer chunk: large enough that header/CRC overhead is
#: noise, small enough that placement overlap is fine-grained and the
#: staging cost stays "one chunk", not "one state".
DEFAULT_CHUNK_BYTES = 64 << 20

#: wire protocol magic (hello + chunk headers); bump on layout change.
_MAGIC = 0xED15_7EA3

#: chunk header: magic u32, leaf u32, offset u64, length u64, crc u32.
_CHUNK_HDR = struct.Struct("<IIQQI")
#: receiver hello: magic u32, rank u32.
_HELLO = struct.Struct("<II")
#: leaf sentinel marking end-of-stream.
_DONE_LEAF = 0xFFFF_FFFF

#: agreement vector layout: [msg, have, step, digest, ip, port,
#: crc_0..n-1].  The confirmation round gathers the SAME-SHAPE vector
#: with a different msg tag: collectives pair positionally, so if one
#: member fails early and retries a fresh agreement while a peer still
#: sits in the previous round's confirmation, the rows pair up instead
#: of shape-exploding — and the tag check turns the desync into a
#: typed, retryable TransferError on every member that sees it.
_SUMMARY_HDR = 6
_MSG_AGREE = 101
_MSG_CONFIRM = 102
#: leaf-digest slot for "I cannot supply/skip this leaf" (no
#: checkpoint, leaf count/size mismatch): never equals a real crc32.
_NO_LEAF = -1


class TransferError(RuntimeError):
    """Restore transfer failed (peer unreachable, protocol violation).
    The caller's normal broken-world machinery handles it: the resize
    fails, the coordinator re-plans, the transfer re-runs."""


class TornTransferError(TransferError):
    """Some member's received chunks failed their CRC.  Raised on
    EVERY member (a post-transfer confirmation all-gather makes the
    verdict world-consistent): nobody adopts the assembled state, the
    resize attempt fails as one unit, and the caller holds-and-retries
    — a fresh agreement re-runs ``latest_verified`` on the source, so
    genuine source-side corruption degrades the WHOLE world to the
    next-oldest verified snapshot together, while a transient wire
    flip simply re-transfers.  A lone member quietly restoring an
    older step instead would diverge the step counter across a live
    world and hang the next collective."""


@dataclass
class TransferStats:
    """What the restore agreement decided and what actually moved."""

    #: "init" (nobody has state), "local" (identical bytes everywhere,
    #: nothing moves), "delta" (the streaming transfer ran)
    mode: str
    source_rank: int = -1
    step: int = -1
    #: total payload the agreement scheduled across ALL receivers
    bytes_scheduled: int = 0
    #: payload bytes THIS member pushed onto / pulled off the wire
    bytes_sent: int = 0
    bytes_received: int = 0
    leaves_received: int = 0
    #: leaves this member already held with source-matching bytes
    leaves_skipped: int = 0
    chunks_received: int = 0
    seconds: float = 0.0


@dataclass
class TransferResult:
    stats: TransferStats
    #: assembled leaves (local where digests matched, received
    #: elsewhere); None for mode "init"
    leaves: Optional[List[np.ndarray]] = None
    #: the source's advertised per-leaf digests (for zero-copy
    #: adoption); None for mode "init"
    leaf_digests: Optional[List[int]] = None


# ---------------------------------------------------------------------------
# collective fabrics (the tiny agreement round; bulk data never rides these)
# ---------------------------------------------------------------------------


class TorchProcessFabric:
    """Agreement fabric over the live ``torch.distributed`` world: the
    ``allgather`` of an int64 vector is one ``all_gather`` on a gloo
    group (the world's own group when its backend is gloo; a gloo group
    beside an NCCL world otherwise)."""

    def __init__(self, group=None, advertise_host: str = "127.0.0.1"):
        import torch.distributed as dist

        self._group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.advertise_host = advertise_host or "127.0.0.1"

    def allgather(self, vec: np.ndarray) -> np.ndarray:
        import torch
        import torch.distributed as dist

        t = torch.from_numpy(np.ascontiguousarray(vec, np.int64))
        out = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(out, t, group=self._group)
        return np.stack([o.numpy() for o in out])


class LoopbackWorld:
    """N in-process "members" sharing a barrier-based allgather — the
    test fabric.  The TCP data plane stays real (127.0.0.1), so wire
    accounting in tests measures the production transport."""

    def __init__(self, world: int):
        self.world = world
        self._barrier = threading.Barrier(world)
        self._slots: List[Optional[np.ndarray]] = [None] * world
        self._lock = threading.Lock()

    def fabric(self, rank: int) -> "LoopbackFabric":
        return LoopbackFabric(self, rank)


class LoopbackFabric:
    def __init__(self, world: LoopbackWorld, rank: int):
        self._world = world
        self.rank = rank
        self.world = world.world
        self.advertise_host = "127.0.0.1"

    def allgather(self, vec: np.ndarray) -> np.ndarray:
        w = self._world
        with w._lock:
            w._slots[self.rank] = np.asarray(vec)
        w._barrier.wait(timeout=120)
        with w._lock:
            out = np.stack([np.asarray(s) for s in w._slots])
        # Second barrier: nobody may reuse the slots for a subsequent
        # gather until everyone has read this one.
        w._barrier.wait(timeout=120)
        return out


# ---------------------------------------------------------------------------
# agreement
# ---------------------------------------------------------------------------


def _ip_to_int(host: str) -> int:
    """IPv4 (dotted or resolvable name) -> u32 for the int64 agreement
    vector; unresolvable names degrade to loopback (single-host runs —
    the only place an unresolvable advertise host can work anyway)."""
    try:
        return struct.unpack("!I", socket.inet_aton(host))[0]
    except OSError:
        try:
            return struct.unpack(
                "!I", socket.inet_aton(socket.gethostbyname(host))
            )[0]
        except OSError:
            return struct.unpack("!I", socket.inet_aton("127.0.0.1"))[0]


def _int_to_ip(ip: int) -> str:
    return socket.inet_ntoa(struct.pack("!I", int(ip)))


def _leaf_sizes(template_leaves: Sequence[Any]) -> List[int]:
    out = []
    for t in template_leaves:
        n = 1
        for s in t.shape:
            n *= int(s)
        out.append(n * np.dtype(t.dtype).itemsize)
    return out


def _summary(
    ckpt: Optional[HostCheckpoint],
    sizes: List[int],
    ip: int,
    port: int,
) -> np.ndarray:
    """This member's agreement vector.  A leaf digest is advertised
    only when the local leaf's byte size matches the model template —
    a structurally incompatible checkpoint can neither skip nor source
    a leaf."""
    n = len(sizes)
    vec = np.full(_SUMMARY_HDR + n, _NO_LEAF, np.int64)
    vec[0] = _MSG_AGREE
    vec[1] = 0 if ckpt is None else 1
    vec[2] = -1 if ckpt is None else int(ckpt.step)
    vec[3] = -1 if ckpt is None else int(ckpt.digest())
    vec[4] = ip
    vec[5] = port
    if ckpt is not None and len(ckpt.leaves) == n:
        digs = ckpt.leaf_digests()
        for i, (leaf, dig) in enumerate(zip(ckpt.leaves, digs)):
            if leaf.nbytes == sizes[i]:
                vec[_SUMMARY_HDR + i] = int(dig)
    return vec


def _gather(fabric, vec: np.ndarray, expect_msg: int) -> np.ndarray:
    """One agreement-fabric all-gather, hardened: any collective
    failure (world torn down mid-gather, peer process death) and any
    round desync (a row tagged with the WRONG message type — a peer
    retrying a fresh agreement while we sit in the previous round's
    confirmation, or vice versa) surfaces as a typed TransferError the
    caller holds-and-retries on, never a raw collective exception or
    silently mispaired data."""
    try:
        world = fabric.allgather(vec)
    except TransferError:
        raise
    except Exception as e:  # noqa: BLE001 - typed boundary
        raise TransferError(
            f"restore transfer: agreement gather failed: {e}"
        ) from e
    if world.ndim != 2 or world.shape[1] != len(vec) or not (
        world[:, 0] == expect_msg
    ).all():
        raise TransferError(
            "restore transfer: agreement round desync (a member "
            "restarted the protocol mid-round); retrying the resize"
        )
    return world


# ---------------------------------------------------------------------------
# TCP data plane
# ---------------------------------------------------------------------------


def tune_socket(sock: socket.socket) -> None:
    """Bulk-transfer socket tuning: no Nagle (chunk headers must not
    wait behind payload), generous kernel buffers (64MB application
    chunks over default ~200KB buffers thrash context switches)."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4 << 20)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
    except OSError:  # pragma: no cover - platform-dependent caps
        pass


def _recv_exact(sock: socket.socket, view: memoryview) -> None:
    got = 0
    while got < len(view):
        n = sock.recv_into(view[got:], len(view) - got)
        if n == 0:
            raise TransferError("restore transfer peer closed mid-stream")
        got += n


def _serve_receiver(
    conn: socket.socket,
    ckpt: HostCheckpoint,
    need: List[int],
    chunk_bytes: int,
    chaos,
    stats: TransferStats,
    stats_lock: threading.Lock,
) -> None:
    """Stream one receiver's missing leaves over ``conn``.  Runs on a
    daemon thread so all receivers are served concurrently; the
    checkpoint leaves are immutable numpy.  ``stats.bytes_sent``
    counts bytes actually handed to the socket (under the lock —
    several receiver threads share the counter), so the source's
    telemetry reports real traffic, not the schedule."""
    try:
        with conn:
            for i in need:
                buf = np.ascontiguousarray(ckpt.leaves[i])
                mv = memoryview(buf).cast("B")
                nbytes = len(mv)
                off = 0
                while off < nbytes or (nbytes == 0 and off == 0):
                    part = mv[off : off + chunk_bytes]
                    if chaos is not None:
                        # chaos[transfer.chunk.slow]: a stalled link —
                        # one chunk send delayed by arg seconds.
                        for ev in chaos.due("transfer.chunk.slow"):
                            time.sleep(float(ev.arg or 0.05))
                    conn.sendall(
                        _CHUNK_HDR.pack(
                            _MAGIC, i, off, len(part), zlib.crc32(part)
                        )
                    )
                    conn.sendall(part)
                    with stats_lock:
                        stats.bytes_sent += len(part)
                    off += len(part)
                    if nbytes == 0:
                        break
            conn.sendall(_CHUNK_HDR.pack(_MAGIC, _DONE_LEAF, 0, 0, 0))
    except OSError:
        # The receiver died mid-pull: ITS resize fails and retries
        # through the coordinator; the source must not care.
        pass


def _serve(
    srv: socket.socket,
    ckpt: HostCheckpoint,
    needs: Dict[int, List[int]],
    chunk_bytes: int,
    timeout: float,
    chaos,
    stats: TransferStats,
    stats_lock: threading.Lock,
) -> None:
    """Source accept loop (background): serve every receiver rank in
    ``needs`` concurrently, then close.  A receiver that never
    connects within ``timeout`` is abandoned — its failed resize is
    the coordinator's problem, and blocking the source's accept loop
    on it would turn one dead joiner into a stalled survivor."""

    def loop():
        expected = set(needs)
        threads = []
        srv.settimeout(timeout)
        try:
            while expected:
                try:
                    conn, _ = srv.accept()
                except (socket.timeout, OSError):
                    break
                try:
                    hello = bytearray(_HELLO.size)
                    conn.settimeout(timeout)
                    tune_socket(conn)
                    _recv_exact(conn, memoryview(hello))
                    magic, rank = _HELLO.unpack(bytes(hello))
                    if magic != _MAGIC or rank not in expected:
                        conn.close()
                        continue
                except (TransferError, OSError, struct.error):
                    conn.close()
                    continue
                expected.discard(rank)
                t = threading.Thread(
                    target=_serve_receiver,
                    args=(
                        conn, ckpt, needs[rank], chunk_bytes, chaos,
                        stats, stats_lock,
                    ),
                    daemon=True,
                    name=f"edl-restore-send-r{rank}",
                )
                t.start()
                threads.append(t)
            for t in threads:
                t.join(timeout)
        finally:
            srv.close()

    threading.Thread(
        target=loop, daemon=True, name="edl-restore-serve"
    ).start()


def _receive(
    host: str,
    port: int,
    rank: int,
    need: List[int],
    template_leaves: Sequence[Any],
    sizes: List[int],
    src_digests: List[int],
    timeout: float,
    chaos,
    on_leaf: Optional[Callable[[int, np.ndarray], None]],
    stats: TransferStats,
):
    """Pull this member's missing leaves from the source.  Buffers are
    allocated once per needed leaf and filled in place
    (``recv_into``); completed leaves go to ``on_leaf`` the moment
    their last chunk lands — on a dedicated placement thread, so the
    socket keeps draining at wire speed while device placement runs
    (inline placement would stall the source whenever the kernel
    buffers filled, serializing wire and placement instead of
    overlapping them).  CRC failures are recorded and the stream still
    drains to the DONE marker — tearing the connection down early
    would turn one flipped bit into a source-side error too.  Returns
    (buffers, torn-leaf set); torn leaves never reach ``on_leaf``."""
    import queue

    bufs = {
        i: np.empty(template_leaves[i].shape, np.dtype(template_leaves[i].dtype))
        for i in need
    }
    got = {i: 0 for i in need}
    #: running crc32 per leaf, chained across its in-order chunks: the
    #: completed leaf is checked against the SOURCE'S ADVERTISED digest
    #: (from the agreement), not just the per-chunk CRCs the source
    #: computed at send time — so source-side rot between its
    #: latest_verified() hash pass and the send is caught here, before
    #: adoption, instead of at the NEXT resize's re-hash.
    leaf_crc = {i: 0 for i in need}
    torn: set = set()

    place_q: "queue.Queue" = queue.Queue()
    place_errors: List[BaseException] = []

    def placer():
        while True:
            item = place_q.get()
            if item is None:
                return
            if place_errors:
                continue  # drain; the first error already aborts adoption
            try:
                on_leaf(item, bufs[item])
            except BaseException as e:  # noqa: BLE001 - re-raised below
                place_errors.append(e)

    place_thread = None
    if on_leaf is not None:
        place_thread = threading.Thread(
            target=placer, daemon=True, name="edl-restore-place"
        )
        place_thread.start()
    try:
        try:
            conn = socket.create_connection((host, port), timeout=timeout)
        except OSError as e:
            raise TransferError(
                f"restore transfer: cannot reach source {host}:{port}: {e}"
            ) from e
        try:
            with conn:
                conn.settimeout(timeout)
                tune_socket(conn)
                conn.sendall(_HELLO.pack(_MAGIC, rank))
                hdr = bytearray(_CHUNK_HDR.size)
                while True:
                    _recv_exact(conn, memoryview(hdr))
                    magic, leaf, off, length, crc = _CHUNK_HDR.unpack(
                        bytes(hdr)
                    )
                    if magic != _MAGIC:
                        raise TransferError(
                            "restore transfer: bad chunk magic"
                        )
                    if leaf == _DONE_LEAF:
                        break
                    if leaf not in bufs or off + length > sizes[leaf]:
                        raise TransferError(
                            f"restore transfer: chunk outside leaf {leaf} "
                            f"bounds (off={off} len={length})"
                        )
                    if off != got[leaf]:
                        raise TransferError(
                            f"restore transfer: out-of-order chunk for "
                            f"leaf {leaf} (off={off}, have {got[leaf]})"
                        )
                    region = memoryview(bufs[leaf]).cast("B")[
                        off : off + length
                    ]
                    _recv_exact(conn, region)
                    if chaos is not None and length > 0:
                        # chaos[transfer.chunk.torn]: a bit flip on the
                        # wire — the CRCs below must catch it.
                        for _ in chaos.due("transfer.chunk.torn"):
                            region[0] ^= 0xFF
                    if zlib.crc32(region) != crc:
                        torn.add(leaf)
                    leaf_crc[leaf] = zlib.crc32(region, leaf_crc[leaf])
                    stats.chunks_received += 1
                    stats.bytes_received += length
                    got[leaf] += length
                    if got[leaf] == sizes[leaf]:
                        if leaf_crc[leaf] != src_digests[leaf]:
                            torn.add(leaf)
                        if leaf not in torn:
                            stats.leaves_received += 1
                            if place_thread is not None:
                                place_q.put(leaf)
        except TransferError:
            raise
        except OSError as e:
            # socket.timeout and friends: a stalled/dead source must
            # surface as the transfer's typed error (the caller holds
            # and retries), not as a raw socket exception.
            raise TransferError(
                f"restore transfer: stream from {host}:{port} failed: {e}"
            ) from e
    finally:
        if place_thread is not None:
            place_q.put(None)
            place_thread.join(timeout)
    if place_thread is not None and place_thread.is_alive():
        raise TransferError(
            f"restore transfer: leaf placement still running after "
            f"{timeout}s drain timeout"
        )
    if place_errors:
        raise place_errors[0]
    short = [i for i in need if got[i] != sizes[i]]
    if short:
        raise TransferError(
            f"restore transfer: source closed with {len(short)} leaves "
            f"incomplete (first: leaf {short[0]}, "
            f"{got[short[0]]}/{sizes[short[0]]} bytes)"
        )
    # Torn (CRC-failed) leaves are NOT raised here: the stream drained
    # cleanly, and the verdict must be made world-consistent by the
    # confirmation all-gather in stream_restore before anyone acts.
    return bufs, torn


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def stream_restore(
    fabric,
    template_leaves: Sequence[Any],
    ckpt: Optional[HostCheckpoint],
    *,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    timeout: float = 120.0,
    chaos=None,
    on_leaf: Optional[Callable[[int, np.ndarray], None]] = None,
) -> TransferResult:
    """``_stream_restore`` + telemetry publication: the engine's final
    stats land in the metrics registry (wire-byte counters, the
    ``edl_transfer_seconds`` histogram), so a resize's transfer cost is
    visible on ``/metrics``, and in a ``transfer`` flight event."""
    result = _stream_restore(
        fabric,
        template_leaves,
        ckpt,
        chunk_bytes=chunk_bytes,
        timeout=timeout,
        chaos=chaos,
        on_leaf=on_leaf,
    )
    from edl_tpu_torch import telemetry

    reg = telemetry.get_registry()
    s = result.stats
    if s.bytes_sent:
        reg.counter("edl_transfer_bytes_sent_total").inc(s.bytes_sent)
    if s.bytes_received:
        reg.counter("edl_transfer_bytes_received_total").inc(
            s.bytes_received
        )
    if s.chunks_received:
        reg.counter("edl_transfer_chunks_total").inc(s.chunks_received)
    if s.leaves_skipped:
        reg.counter("edl_transfer_leaves_skipped_total").inc(
            s.leaves_skipped
        )
    reg.histogram("edl_transfer_seconds").observe(s.seconds)
    telemetry.get_recorder().record(
        "transfer",
        {
            "mode": s.mode,
            "source_rank": s.source_rank,
            "step": s.step,
            "bytes_scheduled": s.bytes_scheduled,
            "bytes_sent": s.bytes_sent,
            "bytes_received": s.bytes_received,
            "leaves_received": s.leaves_received,
            "leaves_skipped": s.leaves_skipped,
        },
        step=s.step,
        timing={"seconds": round(s.seconds, 6)},
    )
    return result


def _stream_restore(
    fabric,
    template_leaves: Sequence[Any],
    ckpt: Optional[HostCheckpoint],
    *,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    timeout: float = 120.0,
    chaos=None,
    on_leaf: Optional[Callable[[int, np.ndarray], None]] = None,
) -> TransferResult:
    """Agree on one state across the world and move only the deltas.

    ``fabric``: agreement transport (rank, world, allgather,
    advertise_host).  ``template_leaves``: the model's abstract state
    leaves (shape/dtype), the shared schema every member's buffers and
    sizes derive from.  ``ckpt``: this member's newest verified local
    checkpoint, or None (a joiner).  ``on_leaf(i, arr)``: called for
    every leaf of the agreed state as it becomes available — local
    (digest-matched) leaves immediately after the agreement, received
    leaves the moment their last chunk lands — so the caller's device
    placement overlaps the remaining transfer.  Not called for modes
    "init"/"local", where the caller already has a better path.

    Every member of the world must call this in the same resize
    (the agreement is an all-gather).  Returns a TransferResult whose
    stats record the mode and the actual wire traffic."""
    t0 = time.perf_counter()
    sizes = _leaf_sizes(template_leaves)
    n = len(sizes)

    srv = None
    port = 0
    if ckpt is not None:
        # Every potential source listens BEFORE the agreement (the
        # gather doubles as the "server is up" barrier); losers close
        # right after.
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.bind(("0.0.0.0", 0))
        srv.listen(max(8, fabric.world))
        port = srv.getsockname()[1]

    ip = _ip_to_int(getattr(fabric, "advertise_host", "127.0.0.1"))
    try:
        world = _gather(
            fabric, _summary(ckpt, sizes, ip, port), _MSG_AGREE
        )
    except TransferError:
        if srv is not None:
            srv.close()
        raise
    haves, steps = world[:, 1], world[:, 2]

    if not haves.any():
        if srv is not None:
            srv.close()
        return TransferResult(stats=TransferStats(mode="init"))

    # Same deterministic source rule as ever: newest checkpoint, ties
    # to lowest rank — every member derives it from the shared gather.
    src = max(
        range(len(haves)), key=lambda r: (int(haves[r]), int(steps[r]), -r)
    )
    src_digests = [int(d) for d in world[src, _SUMMARY_HDR:]]
    crcs = world[:, _SUMMARY_HDR:]
    # needs[r] = leaves member r must receive (digest mismatch vs src).
    needs: Dict[int, List[int]] = {}
    for r in range(len(haves)):
        if r == src:
            continue
        miss = [i for i in range(n) if int(crcs[r, i]) != src_digests[i]]
        if miss:
            needs[r] = miss

    stats = TransferStats(
        mode="delta" if needs else "local",
        source_rank=src,
        step=int(steps[src]),
        bytes_scheduled=sum(
            sizes[i] for miss in needs.values() for i in miss
        ),
    )

    if not needs:
        # Identical bytes everywhere: nothing moves, every member
        # restores from its own store.
        if srv is not None:
            srv.close()
        if ckpt is None and n > 0:
            # Only reachable when the source advertised _NO_LEAF for
            # every slot (structurally incompatible checkpoint), which
            # "matches" a joiner's empty hand: there is no restore
            # path, and returning mode "local" would send the caller
            # into store.restore(None).
            raise TransferError(
                "source checkpoint cannot supply the model template "
                "(leaf count/size mismatch): no restore path for a "
                "joiner"
            )
        stats.leaves_skipped = n
        stats.seconds = time.perf_counter() - t0
        return TransferResult(
            stats=stats,
            leaves=None if ckpt is None else list(ckpt.leaves),
            leaf_digests=src_digests,
        )

    def confirm(my_torn) -> None:
        """Post-transfer confirmation: one tiny all-gather of per-rank
        ok flags (same vector shape as the agreement, tagged
        _MSG_CONFIRM — see _SUMMARY_HDR).  A torn transfer ANYWHERE
        fails the resize attempt on EVERY member — nobody adopts, the
        caller holds-and-retries, and the next agreement re-verifies
        the source's bytes (``latest_verified``), so persistent source
        corruption degrades the whole world to the next-oldest
        snapshot TOGETHER while a transient wire flip just
        re-transfers.  One member silently restoring an older local
        step instead would diverge the step counter across a live
        world."""
        vec = np.zeros(_SUMMARY_HDR + n, np.int64)
        vec[0] = _MSG_CONFIRM
        vec[1] = 0 if my_torn else 1
        ok = _gather(fabric, vec, _MSG_CONFIRM)[:, 1]
        if not ok.all():
            bad = [r for r in range(len(ok)) if not ok[r]]
            mine = (
                f" (this member's torn leaves: {sorted(my_torn)})"
                if my_torn
                else ""
            )
            raise TornTransferError(
                f"restore transfer: member(s) {bad} received chunk-CRC "
                f"failures{mine}: no member adopts; resize retries"
            )

    me = fabric.rank
    if me == src:
        if len(ckpt.leaves) != n:
            srv.close()
            raise TransferError(
                f"source checkpoint has {len(ckpt.leaves)} leaves but "
                f"the model template expects {n}: checkpoint/model "
                "mismatch cannot source a restore"
            )
        for i, leaf in enumerate(ckpt.leaves):
            if leaf.nbytes != sizes[i]:
                srv.close()
                raise TransferError(
                    f"source checkpoint leaf {i} is {leaf.nbytes} bytes "
                    f"but the model template expects {sizes[i]}: "
                    "checkpoint/model mismatch cannot source a restore"
                )
        # Serve in the background; our own placement proceeds now and
        # the confirmation gather below naturally holds us until every
        # receiver finished pulling (so bytes_sent is complete and the
        # verdict is shared).
        stats_lock = threading.Lock()
        _serve(
            srv, ckpt, needs, chunk_bytes, timeout, chaos,
            stats, stats_lock,
        )
        stats.leaves_skipped = n
        if on_leaf is not None:
            for i, leaf in enumerate(ckpt.leaves):
                on_leaf(i, leaf)
        confirm(set())
        stats.seconds = time.perf_counter() - t0
        return TransferResult(
            stats=stats,
            leaves=list(ckpt.leaves),
            leaf_digests=src_digests,
        )

    if srv is not None:
        srv.close()
    mine = needs.get(me, [])
    keep = [i for i in range(n) if i not in set(mine)]
    if ckpt is None and keep:
        # Only possible when the source itself advertised _NO_LEAF
        # slots (structurally incompatible checkpoint): the source is
        # raising the same diagnosis on its side right now.
        raise TransferError(
            "source checkpoint cannot supply the model template "
            "(leaf count/size mismatch): no restore path for a joiner"
        )
    stats.leaves_skipped = len(keep)
    if on_leaf is not None:
        # Local digest-matched leaves first: their device placement
        # dispatches before (and overlaps) the network pull.
        for i in keep:
            on_leaf(i, ckpt.leaves[i])
    if not mine:
        confirm(set())
        stats.seconds = time.perf_counter() - t0
        return TransferResult(
            stats=stats,
            leaves=list(ckpt.leaves),
            leaf_digests=src_digests,
        )
    bufs, torn = _receive(
        _int_to_ip(world[src, 4]),
        int(world[src, 5]),
        me,
        mine,
        template_leaves,
        sizes,
        src_digests,
        timeout,
        chaos,
        on_leaf,
        stats,
    )
    confirm(torn)
    leaves = [
        bufs[i] if i in bufs else ckpt.leaves[i] for i in range(n)
    ]
    stats.seconds = time.perf_counter() - t0
    return TransferResult(
        stats=stats, leaves=leaves, leaf_digests=src_digests
    )
