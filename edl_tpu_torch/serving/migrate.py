"""Live KV sequence migration: drains that never wait on a generation
(counterpart of ``edl_tpu/serving/migrate.py``).

At a token boundary the token batcher freezes, a sequence's filled KV
blocks are gathered device -> host through its block table
(``DecodeEngine.export_kv``), and a chunked TCP push (per-chunk crc32,
per-leaf digests advertised up front, typed errors) lands them on a
survivor, whose engine imports them into freshly granted pool blocks
(``import_kv``) and resumes decode mid-generation.  Greedy decode is a
pure function of (weights, written K/V, cursor), so the survivor's
remaining tokens equal an unmigrated run's.  Drain latency becomes
O(KV bytes), not the longest generation in flight.

Wire: a JSON hello names the mode, the block count, the pool dtype
(``"bfloat16"`` — numpy has no bf16, so the leaves are raw bytes), the
leaf sizes and crc32s, the cursor, and the source checkpoint's
``(step, digest)`` content key.  Leaf ``j`` is K block ``j`` and leaf
``n + j`` is V block ``j``, each the full-head ``[layers, block_tokens,
heads, head_dim]`` plane of that block.  Chunk frames follow; a DONE
leaf closes the push.

Weights never mix: the dest refuses a skewed key at the offer, and the
batcher checks it again at adoption, so a swap that lands between grant
and adoption sends the sequence to a cold re-prefill.

Every failure degrades down a ladder, never to a hang:

1. **KV push** — blocks and cursor move, decode resumes mid-generation.
2. **Cold re-prefill on the survivor** — torn push, refused offer, a
   pool too small, a weights skew: the sequence restarts as a fresh
   prompt on the dest (streamed tokens voided by a restart event).
3. **Readmit locally** — the survivor is unusable: the sequence goes
   back on the local queue and the drain's bounded wait covers it.

After a handoff the source keeps the client connection: a relay thread
forwards the survivor's token and done events through the original
ticket, so a caller streaming from the draining replica never sees the
move.

Chaos (``chaos=``, by default the engine's schedule):
``serve.migrate.kill`` kills the source mid-push (the dest frees its
grant, the source walks the ladder), ``serve.migrate.torn`` corrupts one
received chunk (the per-chunk crc refuses it and the sequence
re-prefills cold on the survivor), ``serve.migrate.exhausted`` makes the
dest refuse the offer, and ``serve.migrate.swap`` poisons the adoption
key as a hot swap between grant and adoption would, so the sequence
re-prefills instead of mixing weight generations.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from edl_tpu_torch.checkpoint.transfer import tune_socket
from edl_tpu_torch.serving.batcher import (
    DrainingError,
    FreezeTimeoutError,
    GenerateTicket,
    QueueFullError,
)
from edl_tpu_torch.telemetry import span

#: distinct from the checkpoint transfer's magic: a migration socket
#: pointed at a shard receiver must fail loudly, not parse
_MAGIC = 0xED16_0A11
#: JSON control frame: magic, payload length
_FRAME = struct.Struct("<II")
#: KV chunk header: magic, leaf index, offset, length, crc32(payload)
_CHUNK_HDR = struct.Struct("<IIQQI")
_DONE_LEAF = 0xFFFF_FFFF
_CHUNK_BYTES = 1 << 20


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class MigrationError(RuntimeError):
    """A live KV migration failed (peer unreachable, torn stream,
    protocol violation).  Recoverable by construction: the caller walks
    the fallback ladder (cold re-prefill on the survivor, then readmit
    and wait locally)."""


class TornMigrationError(MigrationError):
    """A received KV chunk failed its crc (or a leaf its chained
    digest): the dest refused the import and freed its grant."""


class MigrationRefusedError(MigrationError):
    """The dest refused the offer before any KV bytes moved (draining,
    not ready, generation skew, KV pool exhausted, no decode slot)."""


def _recv_exact(sock: socket.socket, view: memoryview) -> None:
    got = 0
    while got < len(view):
        n = sock.recv_into(view[got:], len(view) - got)
        if n == 0:
            raise MigrationError("migration peer closed mid-stream")
        got += n


def _send_frame(sock: socket.socket, obj: Dict[str, Any]) -> None:
    data = json.dumps(obj, sort_keys=True).encode()
    sock.sendall(_FRAME.pack(_MAGIC, len(data)) + data)


def _recv_frame(sock: socket.socket) -> Dict[str, Any]:
    hdr = bytearray(_FRAME.size)
    _recv_exact(sock, memoryview(hdr))
    magic, length = _FRAME.unpack(hdr)
    if magic != _MAGIC:
        raise MigrationError(f"bad migration frame magic {magic:#x}")
    if length > (64 << 20):
        raise MigrationError(f"oversized migration frame ({length} bytes)")
    body = bytearray(length)
    _recv_exact(sock, memoryview(body))
    return json.loads(bytes(body).decode())


def _seq_meta(t: GenerateTicket) -> Dict[str, Any]:
    """The cursor, the sampled tokens and the budget: everything the
    survivor needs to resume (or restart) the generation.  The remaining
    deadline travels as a relative budget: monotonic clocks do not
    compare across hosts."""
    now = time.monotonic()
    return {
        "prompt": [int(x) for x in t.prompt],
        "tokens": [int(x) for x in t.tokens],
        "length": int(t.length),
        "last_token": int(t.last_token),
        "max_new": int(t.max_new),
        "eos_id": t.eos_id,
        "deadline_left_s": round(max(0.001, t.deadline - now), 6),
        "restarts": int(t.restarts),
        "chunks": int(t.chunks),
        "reused_blocks": int(t.reused_blocks),
        "ttft_s": (
            round(t.first_time - t.enqueued, 6)
            if t.first_time is not None
            else None
        ),
    }


def snapshot_sequence(engine, t: GenerateTicket, weights) -> Dict[str, Any]:
    """Export one decoding sequence's migration image: its filled KV
    blocks gathered device -> host, one leaf per block and plane (leaf
    ``j`` = K block ``j``, leaf ``n + j`` = V block ``j``, each
    contiguous), and the offer frame with the leaf sizes and crc32s.
    Must run with the batcher frozen: the next decode step writes the
    pool.

    Prefix-cache interplay: a sequence may hold shared (refcount > 1)
    prefix blocks.  The export is a host copy, so other claimants on the
    source are untouched, and ``detach`` only drops this sequence's
    references; the dest lands the copies in private blocks that are
    never published into its prefix index."""
    bt = engine.block_tokens
    nblk = max(1, -(-int(t.length) // bt))
    k, v = engine.export_kv(list(t.blocks[:nblk]))
    leaves: List[memoryview] = []
    for plane in (k, v):
        # block-major bytes (export_kv's memory: no copy here): row j
        # is block j's [layers, bt, heads, hd]
        rows = plane.transpose(0, 1).contiguous().reshape(nblk, -1)
        arr = rows.view(torch.uint8).numpy()
        leaves.extend(memoryview(arr[j]) for j in range(nblk))
    hello = {
        "mode": "kv",
        "blocks": nblk,
        "dtype": _dtype_name(k.dtype),
        "weights_step": int(weights.step),
        "weights_digest": int(weights.digest),
        "leaf_sizes": [len(b) for b in leaves],
        "leaf_crcs": [zlib.crc32(b) for b in leaves],
        "seq": _seq_meta(t),
    }
    return {"hello": hello, "leaves": leaves}


def _relay(sock: socket.socket, t: GenerateTicket) -> None:
    """Source-side relay: forward the survivor's stream back through the
    original ticket so the caller never sees the move.  Runs until the
    survivor resolves the sequence (done / error) or the socket dies
    (then the caller's future fails: the request was already off this
    replica's books)."""
    try:
        while True:
            fr = _recv_frame(sock)
            if "token" in fr:
                t.tokens.append(int(fr["token"]))
                t._event(fr)
            elif fr.get("restart"):
                t.tokens = []
                t.restarts += 1
                t._event(fr)
            elif fr.get("done"):
                t.tokens = [int(x) for x in fr.get("tokens", [])]
                meta = {
                    k: v for k, v in fr.items() if k not in ("done", "tokens")
                }
                meta["migrated"] = True
                t._result = (list(t.tokens), meta)
                t._event({"done": True, "tokens": list(t.tokens), **meta})
                t._done.set()
                return
            elif "error" in fr:
                t._reject(MigrationError(str(fr["error"])))
                return
    except Exception as e:
        if not t._done.is_set():
            t._reject(MigrationError(f"migration relay lost: {e}"))
    finally:
        try:
            sock.close()
        except OSError:
            pass


def _start_relay(sock: socket.socket, t: GenerateTicket) -> None:
    sock.settimeout(None)
    threading.Thread(
        target=_relay, args=(sock, t), daemon=True,
        name="edl-migrate-relay",
    ).start()


def _open(host: str, port: int, timeout: float) -> socket.socket:
    try:
        sock = socket.create_connection((host, port), timeout=timeout)
    except OSError as e:
        raise MigrationRefusedError(
            f"migration dest {host}:{port} unreachable: {e}"
        )
    tune_socket(sock)
    sock.settimeout(timeout)
    return sock


def _finish_handoff(
    sock: socket.socket, t: GenerateTicket
) -> Dict[str, Any]:
    """Read the dest's result frame; on acceptance hand the socket to
    the relay thread (the caller keeps streaming from us)."""
    res = _recv_frame(sock)
    if not res.get("ok"):
        reason = str(res.get("reason", "unknown"))
        if reason == "torn":
            raise TornMigrationError(
                f"dest refused import: torn chunks ({res.get('torn', '?')})"
            )
        raise MigrationError(f"dest refused import: {reason}")
    _start_relay(sock, t)
    return res


def push_kv(
    host: str,
    port: int,
    snap: Dict[str, Any],
    t: GenerateTicket,
    chaos=None,
    timeout: float = 10.0,
    stats: Optional[Dict[str, Any]] = None,
) -> int:
    """Rung 1: stream a snapshotted sequence's KV blocks to the survivor
    and leave the socket relaying.  Returns the bytes pushed.  Raises
    ``MigrationRefusedError`` (nothing moved), ``TornMigrationError`` /
    ``MigrationError`` (the push failed; the sequence is intact on the
    host for the next rung).  ``stats`` (optional) receives the dest's
    result frame (its receive and import seconds)."""
    sock = _open(host, port, timeout)
    handed = False
    try:
        try:
            _send_frame(sock, snap["hello"])
            acc = _recv_frame(sock)
            if not acc.get("accept"):
                raise MigrationRefusedError(
                    f"dest refused offer: {acc.get('reason', 'unknown')}"
                )
            crcs = snap["hello"]["leaf_crcs"]
            pushed = 0
            for i, leaf in enumerate(snap["leaves"]):
                mv = memoryview(leaf)
                off = 0
                while off < len(mv):
                    part = mv[off : off + _CHUNK_BYTES]
                    if chaos is not None and chaos.due("serve.migrate.kill"):
                        # chaos[serve.migrate.kill]: the source dies
                        # mid-push — the dest sees the peer vanish
                        # before DONE and frees its grant.
                        raise MigrationError("migration push killed mid-stream (chaos)")
                    # a leaf sent in one chunk reuses its leaf digest
                    crc = crcs[i] if len(part) == len(mv) else zlib.crc32(part)
                    sock.sendall(_CHUNK_HDR.pack(_MAGIC, i, off, len(part), crc))
                    sock.sendall(part)
                    off += len(part)
                    pushed += len(part)
            sock.sendall(_CHUNK_HDR.pack(_MAGIC, _DONE_LEAF, 0, 0, 0))
            res = _finish_handoff(sock, t)
            handed = True
            if stats is not None:
                stats.update(res)
            return pushed
        except OSError as e:
            raise MigrationError(f"migration push failed: {e}")
    finally:
        if not handed:
            try:
                sock.close()
            except OSError:
                pass


def push_cold(
    host: str,
    port: int,
    t: GenerateTicket,
    timeout: float = 10.0,
) -> None:
    """Rung 2: requeue the sequence on the survivor as a cold prompt (no
    KV bytes: the dest prefills under its own weights).  The socket stays
    open as the relay.  Raises ``MigrationRefusedError`` /
    ``MigrationError``; the ticket is untouched on failure."""
    sock = _open(host, port, timeout)
    handed = False
    try:
        try:
            _send_frame(sock, {"mode": "cold", "seq": _seq_meta(t)})
            acc = _recv_frame(sock)
            if not acc.get("accept"):
                raise MigrationRefusedError(
                    f"dest refused cold requeue: {acc.get('reason', 'unknown')}"
                )
            _finish_handoff(sock, t)
            handed = True
        except OSError as e:
            raise MigrationError(f"cold requeue failed: {e}")
    finally:
        if not handed:
            try:
                sock.close()
            except OSError:
                pass


def resolve_endpoint(address: str, timeout: float = 5.0) -> Tuple[str, int]:
    """Resolve a survivor's migration endpoint.  ``tcp://host:port``
    addresses a receiver directly; anything else is the replica's HTTP
    address, whose GET /migrate advertises the port (and whether it is
    accepting).  Raises ``MigrationRefusedError`` when the survivor is
    dark or not accepting: the caller falls back to waiting."""
    if address.startswith("tcp://"):
        host, _, port = address[6:].rpartition(":")
        try:
            return host or "127.0.0.1", int(port)
        except ValueError:
            raise MigrationRefusedError(f"bad migration address {address!r}")
    import urllib.error
    import urllib.parse
    import urllib.request

    url = address if "://" in address else f"http://{address}"
    try:
        with urllib.request.urlopen(
            f"{url.rstrip('/')}/migrate", timeout=timeout
        ) as r:
            info = json.loads(r.read().decode())
        if not info.get("accepting", False):
            raise MigrationRefusedError(f"dest {address} not accepting")
        host = urllib.parse.urlparse(url).hostname or "127.0.0.1"
        return host, int(info["migrate_port"])
    except MigrationRefusedError:
        raise
    except Exception as e:
        raise MigrationRefusedError(
            f"migration endpoint lookup at {address} failed: {e}"
        )


def migrate_out(
    engine,
    batcher,
    dest_address: str,
    replica_id: str = "",
    chaos=None,
    timeout: float = 10.0,
) -> Dict[str, Any]:
    """Drain-side orchestration: freeze the batcher at a token boundary,
    snapshot every decoding sequence to the host and detach it, take
    every queued and half-prefilled sequence cold, resume the worker,
    then walk each sequence down the ladder toward the survivor.
    Returns the summary the drain reports (with the export, push and
    dest import seconds).  Raises ``MigrationRefusedError`` only when
    nothing was detached (the survivor is unreachable, or the worker
    did not park for the freeze): the caller then waits with every
    sequence still local."""
    from edl_tpu_torch import telemetry

    reg = telemetry.get_registry()
    rec = telemetry.get_recorder()
    m_out = reg.counter("edl_serve_migrations_total")
    m_bytes = reg.counter("edl_serve_migrations_bytes_total")
    h_sec = reg.histogram("edl_serve_migrate_seconds")

    host, port = resolve_endpoint(dest_address, timeout=timeout)
    summary: Dict[str, Any] = {
        "dest": dest_address, "attempted": 0, "migrated": 0,
        "cold": 0, "fallback": 0, "failed": 0, "bytes": 0, "blocks": 0,
        "export_s": 0.0, "push_s": 0.0, "import_s": 0.0,
    }
    weights = engine.current_weights()
    if weights is None:
        raise MigrationRefusedError("source has no verified weights")
    hot: List[Tuple[GenerateTicket, Optional[Dict[str, Any]]]] = []
    t_freeze = time.monotonic()
    try:
        with batcher.frozen():
            with span("serve.migrate/export"):
                for t in list(batcher._active):
                    # A swap that raced the drain (the worker has not
                    # bound it yet) makes the cached K/V stale: snapshot
                    # nothing and let the ladder re-prefill it cold.
                    snap = (
                        snapshot_sequence(engine, t, weights)
                        if batcher._bound_gen == weights.generation
                        else None
                    )
                    hot.append((t, snap))
                    batcher.detach(t)
                cold = batcher.take_cold()
    except FreezeTimeoutError as e:
        # The worker never parked, so nothing was read or detached:
        # every sequence is still local.
        raise MigrationRefusedError(f"source could not freeze: {e}")
    summary["export_s"] = round(time.monotonic() - t_freeze, 6)
    t_all = time.monotonic()
    for t, snap in hot:
        summary["attempted"] += 1
        t0 = time.monotonic()
        outcome = "failed"
        try:
            if snap is None:
                raise MigrationError("weights swapped under the drain")
            res: Dict[str, Any] = {}
            with span("serve.migrate/push"):
                pushed = push_kv(
                    host, port, snap, t, chaos=chaos, timeout=timeout, stats=res
                )
            summary["migrated"] += 1
            summary["bytes"] += pushed
            summary["blocks"] += int(snap["hello"]["blocks"])
            summary["push_s"] += round(time.monotonic() - t0, 6)
            summary["import_s"] += float(res.get("import_s", 0.0))
            m_bytes.inc(pushed)
            h_sec.observe(time.monotonic() - t0)
            outcome = "ok"
        except MigrationError:
            # Rung 2: the KV image is unusable on the wire or at the
            # dest: re-prefill cold on the survivor.  Streamed tokens
            # are void (the hot-swap restart contract).
            if t.tokens:
                t.tokens = []
                t.restarts += 1
                t._event({"restart": True, "reason": "migration fallback"})
            try:
                push_cold(host, port, t, timeout=timeout)
                summary["fallback"] += 1
                outcome = "fallback"
            except MigrationError:
                # Rung 3: the survivor is unusable: back on the local
                # books, where the drain's bounded wait covers it.
                batcher.readmit(t)
        m_out.inc(outcome=outcome)
    for t in cold:
        summary["attempted"] += 1
        outcome = "failed"
        try:
            # Cold candidates streamed nothing: a requeue on the
            # survivor with no restart event (nothing to void).
            push_cold(host, port, t, timeout=timeout)
            summary["cold"] += 1
            outcome = "cold"
        except MigrationError:
            batcher.readmit(t)
        m_out.inc(outcome=outcome)
    summary["failed"] = (
        summary["attempted"]
        - summary["migrated"] - summary["fallback"] - summary["cold"]
    )
    rec.record(
        "serve.migrate",
        {
            "phase": "out",
            "replica": replica_id,
            "attempted": summary["attempted"],
            "migrated": summary["migrated"],
            "cold": summary["cold"],
            "fallback": summary["fallback"],
            "failed": summary["failed"],
        },
        # bytes ride the non-identity timing field: the KV volume
        # depends on how many tokens streamed before the freeze
        timing={
            "seconds": round(time.monotonic() - t_all, 6),
            "bytes": summary["bytes"],
        },
    )
    return summary


class MigrationReceiver:
    """Survivor-side TCP listener: one connection per migrated sequence.
    KV offers are checked (draining / weights key / dtype / decode slot
    / block grant) before any bytes move; accepted imports are
    crc-checked chunk by chunk, scattered into the granted blocks under
    the batcher's freeze, and handed to the batcher for adoption at a
    token boundary.  Cold offers go straight through
    ``submit_generate``.  Either way the connection stays open as the
    event relay back to the source."""

    def __init__(
        self,
        engine,
        batcher,
        replica_id: str = "",
        chaos=None,
        host: str = "127.0.0.1",
        timeout: float = 30.0,
    ):
        self.engine = engine
        self.batcher = batcher
        self.replica_id = replica_id
        self.chaos = chaos if chaos is not None else engine.chaos
        self.timeout = float(timeout)
        self.accepting = True
        self._stop = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, 0))
        self._srv.listen(16)
        self._srv.settimeout(0.5)
        self.port = self._srv.getsockname()[1]
        self._accept_thread: Optional[threading.Thread] = None

        from edl_tpu_torch import telemetry

        self.recorder = telemetry.get_recorder()

    def start(self) -> "MigrationReceiver":
        if self._accept_thread is not None and self._accept_thread.is_alive():
            return self
        self._stop = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="edl-migrate-recv"
        )
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stop = True
        try:
            self._srv.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(
                target=self._handle, args=(conn,), daemon=True,
                name="edl-migrate-import",
            ).start()

    # -- per-connection import ----------------------------------------------
    def _refusal(self, hello: Dict[str, Any]) -> Optional[str]:
        eng, bat = self.engine, self.batcher
        if self._stop or not self.accepting or bat.draining:
            return "draining"
        w = eng.current_weights()
        if w is None:
            return "not_ready"
        if hello.get("mode") == "kv":
            if (
                int(hello.get("weights_step", -1)) != w.step
                or int(hello.get("weights_digest", -1)) != w.digest
            ):
                return "generation_skew"
            if hello.get("dtype") != _dtype_name(eng.pool._dtype):
                return "dtype_mismatch"
            if (
                bat.active_count + bat.prefilling_count + bat.adopted_count
                >= eng.max_seqs
            ):
                return "no_slot"
            if self.chaos is not None and self.chaos.due("serve.migrate.exhausted"):
                # chaos[serve.migrate.exhausted]: the dest pool reports
                # exhaustion at the offer; the source re-prefills cold.
                return "kv_exhausted"
        return None

    def _handle(self, conn: socket.socket) -> None:
        granted: Optional[List[int]] = None
        handed = False
        try:
            tune_socket(conn)
            conn.settimeout(self.timeout)
            hello = _recv_frame(conn)
            mode = str(hello.get("mode", ""))
            if mode not in ("kv", "cold"):
                _send_frame(conn, {"accept": False, "reason": "bad_mode"})
                return
            refuse = self._refusal(hello)
            if refuse is None and mode == "kv":
                nblk = int(hello["blocks"])
                if nblk < 1 or nblk > self.engine.blocks_per_seq:
                    refuse = "bad_blocks"
                else:
                    granted = self.engine.pool.alloc(nblk)
                    if granted is None:
                        refuse = "kv_exhausted"
            if refuse is not None:
                self._record(mode, "refused", reason=refuse)
                _send_frame(conn, {"accept": False, "reason": refuse})
                return
            _send_frame(conn, {"accept": True})
            # The forwarder must not write an event frame before the
            # result frame is on the wire (the worker can adopt and emit
            # within microseconds): the gate orders the socket.
            gate = threading.Event()
            try:
                if mode == "cold":
                    handed = self._import_cold(conn, hello, gate)
                else:
                    handed = self._import_kv(conn, hello, granted, gate)
                    if handed:
                        granted = None  # ownership passed to the ticket
            finally:
                gate.set()
        except (MigrationError, OSError, ValueError, KeyError):
            # Torn peer or protocol violation: nothing was adopted, the
            # grant (if any) goes back to the pool below.
            self._record("kv", "aborted")
        finally:
            if granted is not None:
                self.engine.pool.free(granted)
            if not handed:
                try:
                    conn.close()
                except OSError:
                    pass

    def _forwarder(self, conn: socket.socket, gate: threading.Event):
        lock = threading.Lock()

        def fwd(ev: Dict[str, Any]) -> None:
            # Adoption can start streaming before _handle sent its
            # result frame: event frames queue behind it, or the source
            # would read an event as the result.
            gate.wait(timeout=60.0)
            with lock:
                _send_frame(conn, ev)
            if ev.get("done") or "error" in ev:
                try:
                    conn.close()
                except OSError:
                    pass

        return fwd

    def _ticket_from(
        self,
        seq: Dict[str, Any],
        conn: socket.socket,
        gate: threading.Event,
    ) -> GenerateTicket:
        return GenerateTicket(
            np.asarray(seq["prompt"], np.int32),
            int(seq["max_new"]),
            time.monotonic() + float(seq["deadline_left_s"]),
            seq.get("eos_id"),
            on_event=self._forwarder(conn, gate),
        )

    def _import_cold(
        self,
        conn: socket.socket,
        hello: Dict[str, Any],
        gate: threading.Event,
    ) -> bool:
        seq = hello["seq"]
        try:
            self.batcher.submit_generate(
                {"tokens": seq["prompt"]},
                max_new_tokens=int(seq["max_new"]),
                deadline_s=float(seq["deadline_left_s"]),
                eos_id=seq.get("eos_id"),
                on_event=self._forwarder(conn, gate),
            )
        except (DrainingError, QueueFullError) as e:
            _send_frame(conn, {"ok": False, "reason": type(e).__name__})
            self._record("cold", "refused", reason=type(e).__name__)
            return False
        _send_frame(conn, {"ok": True})
        self._record("cold", "adopted")
        return True

    def _import_kv(
        self,
        conn: socket.socket,
        hello: Dict[str, Any],
        granted: List[int],
        gate: threading.Event,
    ) -> bool:
        eng = self.engine
        nblk = int(hello["blocks"])
        sizes = [int(s) for s in hello["leaf_sizes"]]
        crcs = [int(c) for c in hello["leaf_crcs"]]
        layers, _, bt, heads, hd = eng.pool._shape
        dtype = eng.pool._dtype
        expect = layers * bt * heads * hd * torch.empty((), dtype=dtype).element_size()
        if len(sizes) != 2 * nblk or any(s != expect for s in sizes):
            _send_frame(conn, {"ok": False, "reason": "shape_mismatch"})
            self._record("kv", "refused", reason="shape_mismatch")
            return False
        t_recv = time.monotonic()
        # The leaves land straight in one (pinned, on CUDA) host buffer,
        # row i = leaf i, which the import copies to the device as is.
        buf = torch.empty(
            (2 * nblk, expect), dtype=torch.uint8,
            pin_memory=eng.device.type == "cuda",
        )
        rows = buf.numpy()
        got = [0] * len(sizes)
        leaf_crc = [0] * len(sizes)
        torn: set = set()
        hdr = bytearray(_CHUNK_HDR.size)
        while True:
            _recv_exact(conn, memoryview(hdr))
            magic, leaf, off, length, crc = _CHUNK_HDR.unpack(hdr)
            if magic != _MAGIC:
                raise MigrationError(f"bad chunk magic {magic:#x}")
            if leaf == _DONE_LEAF:
                break
            if leaf >= len(sizes) or off + length > sizes[leaf]:
                raise MigrationError(f"chunk out of bounds (leaf {leaf}, off {off})")
            if off != got[leaf]:
                raise MigrationError(
                    f"out-of-order chunk for leaf {leaf} "
                    f"(expected {got[leaf]}, got {off})"
                )
            region = memoryview(rows[leaf])[off : off + length]
            _recv_exact(conn, region)
            if self.chaos is not None and self.chaos.due("serve.migrate.torn"):
                # chaos[serve.migrate.torn]: one chunk corrupted in
                # flight — the per-chunk crc must catch it.
                region[0] ^= 0xFF
            c = zlib.crc32(region)
            if c != crc:
                torn.add(leaf)
            # the leaf digest chains over its chunks; a first chunk's
            # crc is the chain's start
            leaf_crc[leaf] = c if off == 0 else zlib.crc32(region, leaf_crc[leaf])
            got[leaf] += length
        for i in range(len(sizes)):
            if got[i] != sizes[i] or leaf_crc[i] != crcs[i]:
                torn.add(i)
        if torn:
            _send_frame(conn, {"ok": False, "reason": "torn", "torn": len(torn)})
            self._record("kv", "refused", reason="torn")
            return False
        recv_s = time.monotonic() - t_recv
        planes = buf.view(dtype).view(2, nblk, layers, bt, heads, hd)
        # The freeze parks the worker at a token boundary: the grant,
        # the scatter and the adoption below are ordered before any
        # decode step that reads the adopted table.
        t_imp = time.monotonic()
        try:
            with self.batcher.frozen():
                eng.import_kv(
                    granted, planes[0].transpose(0, 1), planes[1].transpose(0, 1)
                )
                epoch = eng.cache_epoch
        except FreezeTimeoutError:
            # The worker is inside a call that may read or write the
            # pools: importing now could race it.  Refuse; the source
            # re-prefills the sequence cold.
            _send_frame(conn, {"ok": False, "reason": "freeze_timeout"})
            self._record("kv", "refused", reason="freeze_timeout")
            return False
        import_s = time.monotonic() - t_imp
        seq = hello["seq"]
        t = self._ticket_from(seq, conn, gate)
        t.blocks = list(granted)
        t.table = np.zeros(eng.blocks_per_seq, np.int32)
        t.table[: len(granted)] = granted
        t.length = int(seq["length"])
        t.last_token = int(seq["last_token"])
        t.tokens = [int(x) for x in seq["tokens"]]
        t.restarts = int(seq.get("restarts", 0))
        t.chunks = int(seq.get("chunks", 0))
        # Source-side prefix reuse is part of the client-visible meta;
        # the granted blocks themselves land private here.
        t.reused_blocks = int(seq.get("reused_blocks", 0))
        if seq.get("ttft_s") is not None:
            # TTFT was observed at the source: pin first_time so the
            # adoption never samples it again and the finish meta
            # reports the source's enqueue -> first-token span.
            t.first_time = t.enqueued + float(seq["ttft_s"])
        digest = int(hello["weights_digest"])
        if self.chaos is not None and self.chaos.due("serve.migrate.swap"):
            # chaos[serve.migrate.swap]: a hot swap lands between grant
            # and adoption — the poisoned key routes the sequence to
            # re-prefill instead of mixing weight generations.
            digest ^= 1
        try:
            self.batcher.adopt(t, int(hello["weights_step"]), digest, epoch)
        except RuntimeError as e:
            _send_frame(conn, {"ok": False, "reason": str(e)})
            self._record("kv", "refused", reason="stopped")
            return False
        _send_frame(conn, {
            "ok": True, "blocks": nblk,
            "recv_s": round(recv_s, 6), "import_s": round(import_s, 6),
        })
        # the block count depends on scheduling (tokens streamed before
        # the source froze): journal it as timing, not identity
        self._record("kv", "adopted", _timing={"blocks": nblk})
        return True

    def _record(self, mode: str, outcome: str, _timing=None, **data) -> None:
        payload = {
            "phase": "in", "replica": self.replica_id,
            "mode": mode, "outcome": outcome,
        }
        payload.update(data)
        self.recorder.record("serve.migrate", payload, timing=_timing)
