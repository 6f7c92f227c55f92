"""HTTP serving front (counterpart of ``edl_tpu/serving/server.py``).

One stdlib ``ThreadingHTTPServer`` per replica:

- ``POST /predict``  — ``{"inputs": {...}, "deadline_ms": 500}`` ->
  ``{"outputs": {...}, "weights_step": N, ...}``; 429 + ``Retry-After``
  on admission backpressure, 503 before weights are installed, 504 past
  deadline, 400 on a malformed request.
- ``POST /generate`` — autoregressive decode on the token batcher:
  ``{"inputs": {"tokens": [...]}, "max_new_tokens": 16,
  "deadline_ms": 30000, "eos_id": 1, "stream": true}``.  Non-stream
  replies one JSON object; ``stream: true`` replies chunked
  ``application/x-ndjson`` — one line per token as it decodes, a
  ``{"restart": true}`` line when new weights void prior tokens, and a
  final ``{"done": true, "tokens": [...]}`` line that is the
  authoritative output.  A prompt over the context cap is a 400.
- ``GET /healthz``   — readiness: weights step, queue depths, decode
  pool occupancy.
- ``GET /metrics``   — Prometheus exposition of the process registry.

``python -m edl_tpu_torch.serving.server --entrypoint transformer_lm
--port P [--seed S] [--device cuda]`` runs one replica serving seeded
weights.  ``ServingReplica`` (coordinator registration, heartbeats),
``POST /drain`` and the router come with later slices.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from edl_tpu_torch.serving.batcher import (
    ContinuousBatcher,
    DeadlineExceededError,
    QueueFullError,
)
from edl_tpu_torch.serving.engine import NotReadyError


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
        engine = batcher.engine
        from edl_tpu_torch import telemetry

        registry = telemetry.get_registry()

        class Handler(BaseHTTPRequestHandler):
            # Streaming /generate uses Transfer-Encoding: chunked, which
            # only HTTP/1.1 defines; every response here carries
            # Content-Length or chunked framing, so keep-alive is safe.
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

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

            def _read_json(self):
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def do_GET(self):
                if self.path == "/healthz":
                    health = {
                        "ok": engine.ready,
                        "model": engine.model.name,
                        "device": str(engine.device),
                        "weights_step": engine.weights_step,
                        "weights_generation": engine.weights_generation,
                        "queue_depth": batcher.depth,
                        "queue_limit": batcher.queue_limit,
                    }
                    gen = gen_batcher
                    if gen is not None:
                        health["decode"] = {
                            "max_seqs": engine.max_seqs,
                            "max_context": engine.max_context,
                            "block_tokens": engine.block_tokens,
                            "active_sequences": gen.active_count,
                            "decode_queue_depth": gen.depth,
                            "queue_limit": gen.queue_limit,
                            "kv_occupancy": round(engine.pool.occupancy(), 4),
                            "kv_pool_bytes": engine.pool.nbytes(),
                            "chunked_prefill": gen.chunked_prefill,
                        }
                    self._reply(health, 200 if engine.ready else 503)
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
                gen = gen_batcher
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
                        "ttft_ms": (
                            round(meta["ttft_s"] * 1000.0, 3)
                            if meta.get("ttft_s") is not None
                            else None
                        ),
                        "latency_ms": round((time.monotonic() - t0) * 1000.0, 3),
                    }
                )

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
                except (BrokenPipeError, ConnectionError):
                    pass  # client went away; the worker resolves anyway

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "ServingServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="edl-serve"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)


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


def main(argv=None):  # pragma: no cover - pod entrypoint
    import argparse
    import signal
    import sys

    p = argparse.ArgumentParser(description="edl_tpu_torch serving replica")
    p.add_argument("--entrypoint", default="transformer_lm", help="registered model name")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--seed", type=int, default=0, help="seed of the served weights")
    p.add_argument("--device", default="cuda")
    p.add_argument("--max-seqs", type=int, default=8)
    p.add_argument("--block-tokens", type=int, default=16)
    args = p.parse_args(argv)
    engine, batcher, gen, server = build_replica(
        args.entrypoint, device=args.device, seed=args.seed, port=args.port,
        host=args.host, max_seqs=args.max_seqs, block_tokens=args.block_tokens,
    )
    print(
        f"edl_tpu_torch serving {engine.model.name} on {engine.device} "
        f"port {server.port}",
        flush=True,
    )
    done = threading.Event()

    def _terminate(signum, frame):
        done.set()

    signal.signal(signal.SIGTERM, _terminate)
    signal.signal(signal.SIGINT, _terminate)
    done.wait()
    server.stop()
    if gen is not None:
        gen.stop()
    batcher.stop()
    sys.exit(0)


if __name__ == "__main__":  # pragma: no cover
    main()
