"""HTTP serving front and replica driver (counterpart of
``edl_tpu/serving/server.py``).

One stdlib ``ThreadingHTTPServer`` per replica:

- ``POST /predict``  — ``{"inputs": {...}, "deadline_ms": 500}`` ->
  ``{"outputs": {...}, "weights_step": N, ...}``; 429 + ``Retry-After``
  on admission backpressure, 503 + ``Retry-After`` while draining, 503
  before weights load, 504 past deadline, 400 on a malformed request.
- ``POST /generate`` — autoregressive decode on the token batcher:
  ``{"inputs": {"tokens": [...]}, "max_new_tokens": 16,
  "deadline_ms": 30000, "eos_id": 1, "stream": true}``.  Non-stream
  replies one JSON object with the admission receipts
  (``prefill_chunks``, ``reused_blocks``, ``ttft_ms``); ``stream:
  true`` replies chunked ``application/x-ndjson`` — one line per token
  as it decodes, a ``{"restart": true}`` line when new weights void
  prior tokens, and a final ``{"done": true, "tokens": [...]}`` line
  that is the authoritative output.  A prompt over the context cap is
  a 400; the same 429/503/504 mapping as /predict.
- ``POST /drain``    — ``{"budget_ms": 30000, "wait": true,
  "migrate_to": "HOST:PORT"}``: close admission; with ``migrate_to``
  hand every in-flight decode sequence to that survivor first (its KV
  blocks move and decode resumes there mid-generation; queued and
  half-prefilled prompts requeue there cold); let what stayed finish,
  free its KV blocks, deregister from the serving coordinator.  The
  reply is the drain's ack (``drained``, ``in_flight``, ``progress``
  and the ``migrate`` summary).
- ``GET /migrate``   — the migration receiver's TCP port, and whether
  it is accepting (a draining source asks before its push).
- ``GET /healthz``   — readiness: weights step, queue depths and
  saturation, drain posture, decode pool occupancy and the
  chunked-prefill / prefix-cache posture.
- ``GET /metrics``   — Prometheus exposition of the process registry.

``ServingReplica`` drives one replica's control plane: load the newest
checkpoint, warm, start serving and the migration receiver, register
with the serving coordinator, heartbeat (re-registering after an
eviction) and ship its registry snapshot and flight-recorder events on
the telemetry cadence, and drain.  The pod entry point, ``python -m
edl_tpu_torch.serving.server --checkpoint-dir D [--coordinator
HOST:PORT]``, goes through ``serve_run`` and drains then exits on
SIGTERM.  ``build_replica`` starts a replica on seeded weights instead
(no checkpoint, no coordinator).

Chaos: the replica's own schedule (``ServingReplica(chaos=)``, per pod)
carries ``serve.replica.die`` (the heartbeat loop calls ``die``) and
``serve.coord.unreachable`` (a ``blackout`` of arg seconds: no beats,
no reports, serving goes on); the drain consults ``serve.drain.slow``
on that schedule or else the engine's.
"""

from __future__ import annotations

import json
import queue
import socket
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from edl_tpu_torch.serving.batcher import (
    ContinuousBatcher,
    DeadlineExceededError,
    DrainingError,
    QueueFullError,
)
from edl_tpu_torch.serving.engine import NotReadyError


class FrontServer(ThreadingHTTPServer):
    """The HTTP front of a replica or a router.  socketserver's listen
    backlog of 5 drops the SYNs of a burst of concurrent clients, and
    each dropped SYN costs its client a 1 s retransmit."""

    daemon_threads = True
    request_queue_size = 128


def _deadline_s(req) -> Optional[float]:
    ms = req.get("deadline_ms")
    return float(ms) / 1000.0 if ms is not None else None


class ServingServer:
    """Serve one ContinuousBatcher (and, for decode-capable models, a
    TokenContinuousBatcher on ``/generate``) over HTTP."""

    def __init__(
        self,
        batcher: ContinuousBatcher,
        host: str = "127.0.0.1",
        port: int = 0,
        gen_batcher=None,
    ):
        self.batcher = batcher
        self.gen_batcher = gen_batcher
        #: the ServingReplica driving this server (set by its start):
        #: POST /drain runs the replica's whole contract through it;
        #: without one the handler drains the batchers directly
        self.replica = None
        #: the MigrationReceiver advertised on GET /migrate (set by
        #: ServingReplica.start for decode-capable replicas)
        self.migration = None
        #: open client connections, so a kill can sever them
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        engine = batcher.engine
        self_server = self
        from edl_tpu_torch import telemetry

        registry = telemetry.get_registry()

        class Handler(BaseHTTPRequestHandler):
            # Streaming /generate uses Transfer-Encoding: chunked, which
            # only HTTP/1.1 defines; every response here carries
            # Content-Length or chunked framing, so keep-alive is safe.
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def setup(self):
                super().setup()
                with self_server._conns_lock:
                    self_server._conns.add(self.connection)

            def finish(self):
                with self_server._conns_lock:
                    self_server._conns.discard(self.connection)
                try:
                    super().finish()
                except OSError:
                    pass  # a severed connection has nothing to flush

            def _reply(self, obj, code=200, headers=()):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _reply_429(self, e: QueueFullError):
                self._reply(
                    {"error": str(e), "retry_after_s": e.retry_after},
                    429,
                    headers=(("Retry-After", f"{e.retry_after:.3f}"),),
                )

            def _reply_draining(self, e: DrainingError):
                # 503 + Retry-After, distinct from the 429 of a full
                # queue: this replica is leaving, retry elsewhere.
                self._reply(
                    {"error": str(e), "draining": True,
                     "retry_after_s": e.retry_after},
                    503,
                    headers=(("Retry-After", f"{e.retry_after:.3f}"),),
                )

            def _read_json(self):
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def do_GET(self):
                if self.path == "/healthz":
                    gen = self_server.gen_batcher
                    health = {
                        "ok": engine.ready,
                        "model": engine.model.name,
                        "device": str(engine.device),
                        "weights_step": engine.weights_step,
                        "weights_generation": engine.weights_generation,
                        "warm": engine.warmed,
                        "queue_depth": batcher.depth,
                        "queue_limit": batcher.queue_limit,
                        # how close admission is to the 429 wall: the
                        # router's least-loaded score reads it
                        "saturation": round(batcher.depth / max(1, batcher.queue_limit), 4),
                        # drain posture: admission state and what is
                        # still in flight (a scale-down polls these)
                        "draining": batcher.draining
                        or (gen is not None and gen.draining),
                        "in_flight": batcher.in_flight
                        + (gen.in_flight if gen is not None else 0),
                    }
                    if gen is not None:
                        pool = engine.pool
                        health["decode"] = {
                            "max_seqs": engine.max_seqs,
                            "max_context": engine.max_context,
                            "block_tokens": engine.block_tokens,
                            "active_sequences": gen.active_count,
                            "decode_queue_depth": gen.depth,
                            "queue_limit": gen.queue_limit,
                            "saturation": round(gen.depth / max(1, gen.queue_limit), 4),
                            "kv_occupancy": round(pool.occupancy(), 4),
                            "kv_pool_bytes": pool.nbytes(),
                            "kv_used_blocks": pool.used_blocks,
                            "kv_cached_blocks": pool.cached_blocks,
                            # how admission shares iterations with decode
                            "chunked_prefill": gen.chunked_prefill,
                            "prefill_token_budget": gen.prefill_token_budget,
                            "max_chunk_tokens": engine.max_chunk_tokens,
                            "prefilling_sequences": gen.prefilling_count,
                            "queued_prefill_tokens": gen.queued_prefill_tokens,
                            "prefix_cache": (
                                None if gen.prefix is None
                                else {"entries": len(gen.prefix), **gen.prefix.stats}
                            ),
                        }
                    self._reply(health, 200 if engine.ready else 503)
                elif self.path == "/migrate":
                    # The migration endpoint: the KV bytes move over
                    # their own TCP port, never through JSON.
                    mig = self_server.migration
                    gen = self_server.gen_batcher
                    if mig is None:
                        self._reply({"error": "no migration receiver"}, 404)
                        return
                    self._reply(
                        {
                            "migrate_port": mig.port,
                            "accepting": bool(
                                mig.accepting and engine.ready
                                and not (gen is not None and gen.draining)
                            ),
                        }
                    )
                elif self.path == "/metrics":
                    body = registry.render().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._reply({"error": "not found"}, 404)

            def do_POST(self):
                if self.path == "/generate":
                    self._do_generate()
                elif self.path == "/predict":
                    self._do_predict()
                elif self.path == "/drain":
                    self._do_drain()
                else:
                    self._reply({"error": "not found"}, 404)

            def _do_predict(self):
                try:
                    req = self._read_json()
                except ValueError:
                    self._reply({"error": "bad json"}, 400)
                    return
                deadline_s = _deadline_s(req)
                t0 = time.monotonic()
                try:
                    ticket = batcher.submit(
                        req.get("inputs") or {}, deadline_s=deadline_s
                    )
                    outputs, meta = ticket.result(
                        timeout=(deadline_s or batcher.default_deadline_s) + 1.0
                    )
                except QueueFullError as e:
                    self._reply_429(e)
                    return
                except DrainingError as e:
                    self._reply_draining(e)
                    return
                except (DeadlineExceededError, TimeoutError) as e:
                    self._reply({"error": str(e)}, 504)
                    return
                except NotReadyError as e:
                    self._reply({"error": str(e)}, 503)
                    return
                except ValueError as e:
                    self._reply({"error": str(e)}, 400)
                    return
                except Exception as e:
                    self._reply({"error": str(e)}, 500)
                    return
                self._reply(
                    {
                        "outputs": {k: v.tolist() for k, v in outputs.items()},
                        "weights_step": meta["weights_step"],
                        "weights_generation": meta["weights_generation"],
                        "latency_ms": round((time.monotonic() - t0) * 1000.0, 3),
                    }
                )

            def _do_generate(self):
                gen = self_server.gen_batcher
                if gen is None:
                    self._reply(
                        {
                            "error": f"model {engine.model.name!r} has no "
                            "decode path (single-shot /predict only)"
                        },
                        404,
                    )
                    return
                try:
                    req = self._read_json()
                except ValueError:
                    self._reply({"error": "bad json"}, 400)
                    return
                deadline_s = _deadline_s(req)
                stream = bool(req.get("stream"))
                t0 = time.monotonic()
                events = queue.Queue() if stream else None
                try:
                    ticket = gen.submit_generate(
                        req.get("inputs") or {},
                        max_new_tokens=req.get("max_new_tokens"),
                        deadline_s=deadline_s,
                        eos_id=req.get("eos_id"),
                        on_event=events.put if stream else None,
                    )
                except QueueFullError as e:
                    self._reply_429(e)
                    return
                except DrainingError as e:
                    self._reply_draining(e)
                    return
                except ValueError as e:
                    self._reply({"error": str(e)}, 400)
                    return
                budget = (deadline_s or gen.default_deadline_s) + 1.0
                if stream:
                    self._stream(events, budget)
                    return
                try:
                    tokens, meta = ticket.result(timeout=budget)
                except (DeadlineExceededError, TimeoutError) as e:
                    self._reply({"error": str(e)}, 504)
                    return
                except NotReadyError as e:
                    self._reply({"error": str(e)}, 503)
                    return
                except Exception as e:
                    self._reply({"error": str(e)}, 500)
                    return
                self._reply(
                    {
                        "tokens": tokens,
                        "weights_step": meta["weights_step"],
                        "weights_generation": meta["weights_generation"],
                        "restarts": meta["restarts"],
                        # admission receipts: prefill calls the prompt
                        # took, and the KV blocks it reused from the
                        # prefix cache instead of prefilling
                        "prefill_chunks": meta.get("prefill_chunks", 0),
                        "reused_blocks": meta.get("reused_blocks", 0),
                        "ttft_ms": (
                            round(meta["ttft_s"] * 1000.0, 3)
                            if meta.get("ttft_s") is not None
                            else None
                        ),
                        "latency_ms": round((time.monotonic() - t0) * 1000.0, 3),
                    }
                )

            def _do_drain(self):
                """POST /drain: the graceful-shutdown contract.  With
                ``wait`` (the default) the reply is the drain's ack."""
                try:
                    req = self._read_json()
                except ValueError:
                    self._reply({"error": "bad json"}, 400)
                    return
                budget_ms = req.get("budget_ms")
                budget_s = float(budget_ms) / 1000.0 if budget_ms is not None else None
                wait = bool(req.get("wait", True))
                kw = {
                    "budget_s": budget_s,
                    "migrate_to": req.get("migrate_to") or None,
                    "trace": req.get("trace") or None,
                }
                rep = self_server.replica
                if rep is not None:
                    if wait:
                        self._reply(rep.drain(**kw))
                    else:
                        threading.Thread(
                            target=rep.drain, kwargs=kw,
                            daemon=True, name="edl-serve-drain",
                        ).start()
                        self._reply({"draining": True, "drained": False})
                    return
                # No replica attached: close admission and wait the
                # batchers out under the budget.
                gens = [b for b in (batcher, self_server.gen_batcher) if b is not None]
                for b in gens:
                    b.close_admission()
                deadline = time.monotonic() + (budget_s if budget_s is not None else 30.0)
                left = sum(b.in_flight for b in gens)
                while wait and left and time.monotonic() < deadline:
                    time.sleep(0.005)
                    left = sum(b.in_flight for b in gens)
                self._reply({"draining": True, "drained": left == 0, "in_flight": left})

            def _stream(self, events, budget: float):
                """Chunked JSON lines: one object per event as the
                worker emits it; the final done/error line is the
                authoritative result."""
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(obj):
                    data = (json.dumps(obj) + "\n").encode()
                    self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                    self.wfile.flush()

                end = time.monotonic() + budget
                try:
                    while True:
                        try:
                            ev = events.get(timeout=max(0.05, end - time.monotonic()))
                        except queue.Empty:
                            chunk({"error": "generation timed out"})
                            break
                        chunk(ev)
                        if "done" in ev or "error" in ev:
                            break
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    # the client went away (or a kill severed us); the
                    # worker resolves the ticket anyway
                    pass

        self._server = FrontServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "ServingServer":
        # a short poll: a stop (or a kill) takes effect within 0.1 s
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name="edl-serve",
        )
        self._thread.start()
        return self

    def _sever(self) -> None:
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def stop(self, sever: bool = False) -> None:
        """Stop accepting.  ``sever``: also cut every open connection
        mid-response, as a dead process would (a stream in flight ends
        without its terminal line)."""
        if sever:
            self._sever()  # at once: the accept loop may take a poll to stop
        self._server.shutdown()
        if sever:
            self._sever()  # and whatever it accepted meanwhile
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)


class ServingReplica:
    """One serving replica's control plane: load -> warm -> serve ->
    register -> heartbeat and report until drained or stopped.

    ``coordinator`` is the serving world's coordinator (a
    ``LocalCoordinator`` or an ``HTTPCoordinator``: the same membership
    and telemetry machinery the training world runs).  Warm before
    register: by the time the replica appears among the members, its
    first request builds and loads nothing.  A heartbeat that finds the
    replica evicted (``KeyError``) registers it again.  Every
    ``telemetry_interval`` seconds the heartbeat thread also ships the
    registry snapshot and the new flight-recorder events (the
    ``serve.drain`` events a router steers on among them)."""

    def __init__(
        self,
        engine,
        batcher: Optional[ContinuousBatcher] = None,
        server: Optional[ServingServer] = None,
        coordinator=None,
        replica_id: str = "",
        address: str = "",
        heartbeat_interval: float = 2.0,
        telemetry_interval: float = 5.0,
        gen_batcher=None,
        drain_budget_s: float = 30.0,
        chaos=None,
    ):
        """``drain_budget_s``: how long a drain lets in-flight work
        finish before it gives up (``EDL_SERVE_DRAIN_MS`` through
        ``serve_run``).  ``telemetry_interval`` <= 0 ships no reports.
        ``chaos``: a per-pod fault schedule for the replica-level points
        (``serve.replica.die``, ``serve.coord.unreachable``), kept apart
        from the engine's: those points name a whole replica, so a
        schedule shared by replicas in one process would misroute
        them."""
        self.engine = engine
        self.batcher = batcher or ContinuousBatcher(engine)
        if gen_batcher is None and getattr(engine, "spec", None) is not None:
            from edl_tpu_torch.serving.batcher import TokenContinuousBatcher

            gen_batcher = TokenContinuousBatcher(engine)
        self.gen_batcher = gen_batcher
        self.server = server
        self.coordinator = coordinator
        self.replica_id = replica_id or f"serve-{uuid.uuid4().hex[:8]}"
        self.address = address
        self.heartbeat_interval = float(heartbeat_interval)
        self.telemetry_interval = float(telemetry_interval)
        self.drain_budget_s = float(drain_budget_s)
        self.chaos = chaos
        #: serve.coord.unreachable: until this monotonic time every beat
        #: and report is skipped; serving goes on, and the beat's
        #: KeyError -> register path reconverges on return
        self._blackout_until = 0.0
        self.loaded = False
        self._stop_evt: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        self._deregistered = False
        self._dead = False
        #: telemetry report sequence, the last event shipped, and this
        #: incarnation's nonce (a restart's reports supersede the old)
        self._seq = 0
        self._events_sent_seq = 0
        self._boot = uuid.uuid4().hex[:12]
        #: the drain's state machine: None (serving) -> "running" ->
        #: "drained" (terminal) or "incomplete" (budget missed:
        #: admission stays closed, the replica stays registered and
        #: heartbeating, a later drain retries)
        self._drain_lock = threading.Lock()
        self._drain_state: Optional[str] = None
        self._drain_evt: Optional[threading.Event] = None
        self._drain_result: Optional[dict] = None
        #: causal-trace id the drain journals under (the actuator's
        #: decision trace, when the POST /drain body carried one)
        self._drain_trace: Optional[str] = None
        #: generation tickets on the books when the drain began; a
        #: retried drain waits only for those still unresolved and local
        self._drain_pending: Optional[list] = None
        self._drain_total = 0
        self._drain_migrated = 0
        #: the live-migration receiver (decode-capable replicas; started
        #: by start, advertised on GET /migrate)
        self.migration = None
        from edl_tpu_torch import telemetry

        self.telemetry = telemetry.get_registry()
        self.recorder = telemetry.get_recorder()
        self._m_reports = self.telemetry.counter("edl_telemetry_reports_total")
        self._g_draining = self.telemetry.gauge("edl_serve_draining")
        self._m_drains = self.telemetry.counter("edl_serve_drains_total")
        self._h_drain = self.telemetry.histogram("edl_serve_drain_seconds")

    def start(self) -> "ServingReplica":
        self.loaded = self.engine.load()
        # Warm before register (see the class doc).
        self.engine.warm()
        self.batcher.start()
        if self.gen_batcher is not None:
            self.gen_batcher.start()
            if self.server is not None and self.server.gen_batcher is None:
                self.server.gen_batcher = self.gen_batcher
            # Survivors import drained replicas' sequences here (their
            # own TCP port, not HTTP).
            from edl_tpu_torch.serving.migrate import MigrationReceiver

            self.migration = MigrationReceiver(
                self.engine, self.gen_batcher, replica_id=self.replica_id,
                chaos=getattr(self.engine, "chaos", None),
            ).start()
        if self.server is not None:
            self.server.replica = self  # POST /drain comes here
            self.server.migration = self.migration
            self.server.start()
        if self.coordinator is not None:
            self.coordinator.register(self.replica_id, address=self.address)
            self._start_background()
        self._g_draining.set(0, replica=self.replica_id)
        self.recorder.record(
            "serve.replica",
            {
                "replica": self.replica_id,
                "model": self.engine.model.name,
                "loaded": bool(self.loaded),
            },
            step=max(0, self.engine.weights_step),
        )
        return self

    def stop(self) -> None:
        self._stop_heartbeats()
        if self.coordinator is not None and not self._deregistered:
            try:
                self.coordinator.deregister(self.replica_id)
                self._deregistered = True
            except Exception:
                pass
        if self.server is not None:
            self.server.stop()
        self.batcher.stop()
        if self.gen_batcher is not None:
            self.gen_batcher.stop()
        if self.migration is not None:
            self.migration.stop()

    def die(self) -> None:
        """The ungraceful exit, the death a drain exists to avoid: the
        HTTP front stops and severs its open connections (a stream in
        flight ends without a terminal line), the batchers stop (queued
        and running requests fail; their clients retry elsewhere), and
        heartbeats stop without a deregister, so the coordinator learns
        only at lease expiry."""
        self._dead = True
        self._stop_heartbeats()
        if self.server is not None:
            self.server.stop(sever=True)
        self.batcher.stop()
        if self.gen_batcher is not None:
            self.gen_batcher.stop()
        if self.migration is not None:
            self.migration.stop()

    def blackout(self, seconds: float) -> None:
        """chaos[serve.coord.unreachable]: the serving coordinator
        vanishes for ``seconds`` — beats and reports are skipped, the
        replica keeps serving its last verified weights, and afterwards
        the heartbeat (or its KeyError -> register rejoin) reconverges
        the membership."""
        self._blackout_until = time.monotonic() + float(seconds)

    # -- graceful drain -----------------------------------------------------
    def _in_flight(self) -> int:
        n = self.batcher.in_flight
        if self.gen_batcher is not None:
            n += self.gen_batcher.in_flight
        return n

    def drain(
        self,
        budget_s: Optional[float] = None,
        migrate_to: Optional[str] = None,
        trace: Optional[str] = None,
    ) -> dict:
        """The graceful-shutdown contract, in order: (1) close admission
        (later requests get 503 + Retry-After: this replica is leaving);
        (2) with ``migrate_to`` (a survivor's HTTP address, or a
        ``tcp://host:port`` receiver) hand every in-flight decode
        sequence to the survivor first: its KV blocks move and decode
        resumes there mid-generation, while queued and half-prefilled
        prompts requeue there cold, so the drain costs O(KV bytes), not
        the longest generation; (3) let what stayed (and every
        single-shot request) finish under ``budget_s``, their finish
        paths freeing the KV blocks; (4) only once in-flight work has
        settled, stop heartbeating and deregister (heartbeats first, or
        the eviction-rejoin path would register the leaving replica
        again); (5) return the ack.  The caller owns the exit
        (``stop``); a drained replica still answers /healthz and
        /metrics until then.

        One drain runs at a time; concurrent callers (POST /drain racing
        SIGTERM) wait for it and share its result.  A drain that misses
        its budget is ``incomplete``, not final: admission stays closed,
        but the replica stays registered and heartbeating, and a later
        drain waits out only the sequences still unresolved and local
        (``progress`` carries the count across attempts).  Only a
        finished drain deregisters."""
        budget = self.drain_budget_s if budget_s is None else float(budget_s)
        give_up = time.monotonic() + budget + 10.0
        while True:
            with self._drain_lock:
                if self._drain_state == "drained":
                    return dict(self._drain_result)
                if self._drain_state in (None, "incomplete"):
                    first = self._drain_state is None
                    self._drain_state = "running"
                    evt = self._drain_evt = threading.Event()
                    break  # this caller owns the (re)attempt
                evt = self._drain_evt  # one is running: wait for it
            evt.wait(timeout=max(0.05, give_up - time.monotonic()))
            if time.monotonic() >= give_up:
                return dict(self._drain_result or {"draining": True, "drained": False})
        t0 = time.monotonic()
        self._g_draining.set(1, replica=self.replica_id)
        if trace:
            self._drain_trace = trace
        if first:
            self._m_drains.inc()  # drains, not attempts
            self.recorder.record(
                "serve.drain",
                {"replica": self.replica_id, "phase": "start"},
                trace=self._drain_trace,
            )
        self.batcher.close_admission()
        if self.gen_batcher is not None:
            self.gen_batcher.close_admission()
        chaos = self.chaos if self.chaos is not None else getattr(self.engine, "chaos", None)
        if self._drain_pending is None:
            self._drain_pending = (
                self.gen_batcher.pending() if self.gen_batcher is not None else []
            )
            self._drain_total = len(self._drain_pending)
        else:
            self._drain_pending = [
                t for t in self._drain_pending if not t._done.is_set() and not t.migrated
            ]
        migrate_summary = None
        if migrate_to and self.gen_batcher is not None:
            from edl_tpu_torch.serving.migrate import MigrationError, migrate_out

            try:
                migrate_summary = migrate_out(
                    self.engine, self.gen_batcher, migrate_to,
                    replica_id=self.replica_id, chaos=chaos,
                )
                self._drain_migrated += (
                    migrate_summary["migrated"] + migrate_summary["fallback"]
                    + migrate_summary["cold"]
                )
            except MigrationError as e:
                # The survivor is dark or refusing before anything
                # moved: everything is still local, so the bounded wait
                # below covers it.
                migrate_summary = {"error": type(e).__name__}
                self.recorder.record(
                    "serve.migrate",
                    {"phase": "abort", "replica": self.replica_id,
                     "reason": type(e).__name__},
                )
        deadline = t0 + budget
        while time.monotonic() < deadline:
            if chaos is not None:
                for ev in chaos.due("serve.drain.slow"):
                    # chaos[serve.drain.slow]: a slow drain eats into
                    # the budget (the bounded-budget path).
                    time.sleep(float(ev.arg or 0.05))
            if self._in_flight() == 0:
                break
            time.sleep(0.005)
        leftover = self._in_flight()
        drained = leftover == 0
        self._drain_pending = [
            t for t in self._drain_pending if not t._done.is_set() and not t.migrated
        ]
        if drained:
            self._stop_heartbeats()
            if self.coordinator is not None and not self._deregistered:
                try:
                    self.coordinator.deregister(self.replica_id)
                    self._deregistered = True
                except Exception:
                    pass
        dt = time.monotonic() - t0
        self._h_drain.observe(dt)
        self._g_draining.set(2 if drained else 1, replica=self.replica_id)
        if drained:
            self.recorder.record(
                "serve.drain",
                {
                    "replica": self.replica_id,
                    "phase": "done",
                    "drained": True,
                    "migrated": self._drain_migrated,
                },
                timing={"seconds": round(dt, 6), "in_flight": leftover},
                trace=self._drain_trace,
            )
        result = {
            "draining": True,
            "drained": drained,
            "in_flight": leftover,
            "seconds": round(dt, 6),
            "progress": {
                "total": self._drain_total,
                "migrated": self._drain_migrated,
                "remaining": len(self._drain_pending),
            },
        }
        if migrate_summary is not None:
            result["migrate"] = migrate_summary
        with self._drain_lock:
            self._drain_result = result
            self._drain_state = "drained" if drained else "incomplete"
            evt.set()
        return dict(result)

    # -- heartbeats and telemetry reports -------------------------------------
    def _start_background(self) -> None:
        self._stop_evt = threading.Event()

        def loop():
            last_report = 0.0
            while not self._stop_evt.wait(max(self.heartbeat_interval, 0.05)):
                if self.chaos is not None:
                    # Replica-level chaos: a kill takes the whole replica
                    # down ungracefully; a blackout mutes the control
                    # plane while serving goes on.
                    if self.chaos.due("serve.replica.die"):
                        self.die()
                        return
                    for ev in self.chaos.due("serve.coord.unreachable"):
                        self.blackout(float(ev.arg or 1.0))
                if self._blackout_until > time.monotonic():
                    continue  # coordinator unreachable: keep serving
                self._beat_once()
                now = time.monotonic()
                if self.telemetry_interval > 0 and now - last_report >= self.telemetry_interval:
                    last_report = now
                    self._report_telemetry()

        self._thread = threading.Thread(
            target=loop, daemon=True, name="edl-serve-heartbeat"
        )
        self._thread.start()

    def _stop_heartbeats(self) -> None:
        if self._stop_evt is not None:
            self._stop_evt.set()
        if (
            self._thread is not None and self._thread.is_alive()
            and self._thread is not threading.current_thread()
        ):
            self._thread.join(timeout=10)

    def _beat_once(self) -> None:
        try:
            self.coordinator.heartbeat(self.replica_id)
        except KeyError:
            # Evicted while alive (a lease outlived): rejoin, as a
            # trainer does.
            try:
                self.coordinator.register(self.replica_id, address=self.address)
            except Exception:
                pass
        except Exception:
            pass  # coordinator unreachable: retry at the next beat

    def _report_telemetry(self) -> None:
        """Ship the cumulative registry snapshot and the flight-recorder
        events not shipped yet (at most 64 a report).  Best effort, like
        the trainer's cadence: a dark coordinator costs one report."""
        rep = getattr(self.coordinator, "report_telemetry", None)
        if rep is None:
            return
        events = self.recorder.events_since(self._events_sent_seq)[:64]
        self._seq += 1
        try:
            rep(
                self.replica_id,
                snapshot=self.telemetry.snapshot(),
                seq=self._seq,
                events=[e.to_dict() for e in events],
                boot=self._boot,
            )
        except Exception:
            return
        if events:
            self._events_sent_seq = events[-1].seq
        self._m_reports.inc()

    def tick(self) -> None:
        """One synchronous heartbeat and report (tests, single-threaded
        drivers)."""
        self._beat_once()
        self._report_telemetry()


def build_replica(
    entrypoint: str = "transformer_lm",
    device=None,
    seed: int = 0,
    port: int = 0,
    host: str = "127.0.0.1",
    max_seqs: int = 8,
    block_tokens: int = 16,
    max_batch: int = 8,
    queue_limit: int = 256,
    **model_kwargs,
):
    """Build and start one replica: engine with seeded weights, the
    single-shot and token batchers, and the HTTP front.  Returns
    ``(engine, batcher, gen_batcher, server)``; the caller stops them."""
    from edl_tpu_torch.models.base import get_model
    from edl_tpu_torch.serving.batcher import TokenContinuousBatcher
    from edl_tpu_torch.serving.engine import DecodeEngine, InferenceEngine

    model = get_model(entrypoint, **model_kwargs)
    if model.decode is not None:
        engine = DecodeEngine(
            model, device=device, max_batch=max_batch, max_seqs=max_seqs,
            block_tokens=block_tokens,
        )
    else:
        engine = InferenceEngine(model, device=device, max_batch=max_batch)
    engine.install_seeded(seed)
    batcher = ContinuousBatcher(engine, queue_limit=queue_limit).start()
    gen = None
    if model.decode is not None:
        gen = TokenContinuousBatcher(
            engine, queue_limit=queue_limit, chunked_prefill=False
        ).start()
    server = ServingServer(batcher, host=host, port=port, gen_batcher=gen).start()
    return engine, batcher, gen, server


def serve_run(
    entrypoint: str = "",
    coordinator_addr: str = "",
    checkpoint_dir: str = "",
    port: int = 0,
    max_batch: int = 0,
    queue_limit: int = 0,
    deadline_ms: int = 0,
    pod_address: str = "",
    replica_id: str = "",
    device=None,
    host: str = "0.0.0.0",
    **model_kwargs,
) -> ServingReplica:
    """Build and start one checkpoint-backed replica from the arguments
    and the ``EDL_SERVE_*`` pod env contract (``launcher.env_config``):
    a ``HostDRAMStore`` over the durable checkpoint directory, the
    engine (``DecodeEngine`` for a model with a decode contract; an
    unregistered entrypoint loads from ``EDL_WORKSPACE``), both
    batchers and the HTTP front, registered with the serving
    coordinator when an address is given.  ``device`` defaults to CUDA
    and raises where there is none.  Returns the started replica; the
    caller owns its lifetime."""
    from edl_tpu_torch.checkpoint import HostDRAMStore
    from edl_tpu_torch.launcher import env_config
    from edl_tpu_torch.models.base import get_model
    from edl_tpu_torch.runtime.coord_service import HTTPCoordinator
    from edl_tpu_torch.serving.batcher import TokenContinuousBatcher
    from edl_tpu_torch.serving.engine import DecodeEngine, InferenceEngine

    cfg = env_config()
    model = get_model(entrypoint or cfg["entrypoint"] or "transformer_lm",
                      workspace=cfg["workspace"], **model_kwargs)
    spill = checkpoint_dir or cfg["checkpoint_dir"]
    store = HostDRAMStore(spill_dir=spill or None)
    max_batch = max_batch or cfg["serve_max_batch"]
    if model.decode is not None:
        engine = DecodeEngine(model, device=device, max_batch=max_batch, store=store)
    else:
        engine = InferenceEngine(model, device=device, max_batch=max_batch, store=store)
    queue_limit = queue_limit or cfg["serve_queue_limit"]
    batcher = ContinuousBatcher(
        engine, queue_limit=queue_limit,
        default_deadline_s=(deadline_ms or cfg["serve_deadline_ms"]) / 1000.0,
    )
    gen = None
    if model.decode is not None:
        gen = TokenContinuousBatcher(engine, queue_limit=queue_limit)
    server = ServingServer(batcher, host=host, port=port or cfg["serve_port"], gen_batcher=gen)
    coordinator = None
    if coordinator_addr or cfg["coordinator_addr"]:
        coordinator = HTTPCoordinator(coordinator_addr or cfg["coordinator_addr"])
    replica = ServingReplica(
        engine, batcher, server, coordinator=coordinator,
        replica_id=replica_id or cfg["pod_name"],
        address=pod_address or cfg["pod_address"],
        telemetry_interval=cfg["telemetry_interval"],
        gen_batcher=gen,
        drain_budget_s=cfg["serve_drain_ms"] / 1000.0,
    )
    return replica.start()


def main(argv=None):  # pragma: no cover - pod entrypoint
    import argparse
    import signal
    import sys

    p = argparse.ArgumentParser(description="edl_tpu_torch serving replica")
    p.add_argument("--entrypoint", default="", help="registered model name")
    p.add_argument("--coordinator", default="", help="serving coordinator host:port")
    p.add_argument("--checkpoint-dir", default="", help="the trainer's durable checkpoint dir")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--max-batch", type=int, default=0)
    p.add_argument("--queue-limit", type=int, default=0)
    p.add_argument("--deadline-ms", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true", help="the model's tiny configuration")
    args = p.parse_args(argv)
    replica = serve_run(
        entrypoint=args.entrypoint, coordinator_addr=args.coordinator,
        checkpoint_dir=args.checkpoint_dir, port=args.port, host=args.host,
        max_batch=args.max_batch, queue_limit=args.queue_limit,
        deadline_ms=args.deadline_ms, device=args.device,
        **({"tiny": True} if args.tiny else {}),
    )
    print(
        f"edl_tpu_torch serving replica {replica.replica_id} "
        f"({replica.engine.model.name}, weights step "
        f"{replica.engine.weights_step}) on {replica.engine.device} "
        f"port {replica.server.port}",
        flush=True,
    )
    # SIGTERM (a pod's deletion): drain — close admission, finish what
    # is in flight, free the KV blocks, deregister — then exit.  The
    # drain runs once, on its own thread: a second signal must not
    # re-enter it from inside the first one's frame.
    done = threading.Event()
    leaving = threading.Event()

    def _leave():
        replica.drain()
        replica.stop()
        done.set()

    def _terminate(signum, frame):
        if not leaving.is_set():
            leaving.set()
            threading.Thread(target=_leave, name="edl-serve-leave").start()

    signal.signal(signal.SIGTERM, _terminate)
    signal.signal(signal.SIGINT, _terminate)
    done.wait()
    sys.exit(0)


if __name__ == "__main__":  # pragma: no cover
    main()
