"""Coordinator as a service: HTTP front-end over ``LocalCoordinator``
(a copy of ``edl_tpu/runtime/coord_service.py``).

One tiny JSON-over-HTTP service (stdlib only) exposing exactly the
``LocalCoordinator`` interface; the ``HTTPCoordinator`` client is
interface-compatible with ``LocalCoordinator``, so ``ElasticTrainer``
works with either (in-process for tests/local mode, over the network in
a cluster).

Run as a pod: ``python -m edl_tpu_torch.runtime.coord_service --port
7164 --min-world 1 --max-world 8``.

``GET /metrics`` serves Prometheus text (the coordinator snapshot as
gauges merged with the members' telemetry); ``GET /metrics?format=json``
serves the snapshot dict, which ``HTTPCoordinator.metrics()`` asks for.
``POST /telemetry`` ingests a member's cumulative report and ``GET
/telemetry`` serves the merge.
"""

from __future__ import annotations

import argparse
import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from edl_tpu_torch.runtime.coordinator import ElasticPlan, LocalCoordinator


def _plan_to_dict(plan: Optional[ElasticPlan]) -> Optional[dict]:
    if plan is None:
        return None
    return {
        "generation": plan.generation,
        "world_size": plan.world_size,
        "members": list(plan.members),
        "restore_step": plan.restore_step,
        "addresses": list(plan.addresses),
        "alive": list(plan.alive),
        "prewarm": plan.prewarm,
        "stop_step": plan.stop_step,
        "trace_id": plan.trace_id,
        "prewarm_trace": plan.prewarm_trace,
    }


def _plan_from_dict(d: Optional[dict]) -> Optional[ElasticPlan]:
    if not d:
        return None
    return ElasticPlan(
        generation=d["generation"],
        world_size=d["world_size"],
        members=tuple(d["members"]),
        restore_step=d.get("restore_step", -1),
        addresses=tuple(d.get("addresses", ())),
        alive=tuple(d.get("alive", ())),
        prewarm=int(d.get("prewarm", 0)),
        stop_step=int(d.get("stop_step", -1)),
        trace_id=str(d.get("trace_id", "")),
        prewarm_trace=str(d.get("prewarm_trace", "")),
    )


class CoordinatorServer:
    """Serve a LocalCoordinator over HTTP.  One POST endpoint per
    coordinator method; GET /plan for the hot-path poll."""

    def __init__(self, coordinator: LocalCoordinator, host: str = "0.0.0.0", port: int = 7164):
        self.coordinator = coordinator
        coord = coordinator

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _reply(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _reply_text(self, text: str, code=200):
                body = text.encode()
                self.send_response(code)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                from urllib.parse import parse_qs, urlparse

                u = urlparse(self.path)
                query = parse_qs(u.query)
                if u.path == "/plan":
                    self._reply({"plan": _plan_to_dict(coord.plan())})
                elif u.path == "/members":
                    self._reply({"members": coord.members()})
                elif u.path == "/target":
                    self._reply({"world": coord.target_world()})
                elif u.path == "/metrics":
                    # Prometheus text by default; ?format=json keeps the
                    # snapshot dict (HTTPCoordinator.metrics reads it).
                    if query.get("format", [""])[0] == "json":
                        self._reply(coord.metrics())
                    else:
                        self._reply_text(coord.metrics_text())
                elif u.path == "/telemetry":
                    self._reply(coord.telemetry())
                elif u.path == "/healthz":
                    self._reply({"ok": True})
                else:
                    self._reply({"error": "not found"}, 404)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                try:
                    if self.path == "/register":
                        plan = coord.register(
                            req["trainer_id"],
                            address=req.get("address", ""),
                            replica=req.get("replica"),
                            host=req.get("host"),
                        )
                        self._reply({"plan": _plan_to_dict(plan)})
                    elif self.path == "/deregister":
                        coord.deregister(req["trainer_id"])
                        self._reply({"ok": True})
                    elif self.path == "/heartbeat":
                        # The reply carries the server's wall clock:
                        # with the client's t0/t1 stamps it is one
                        # NTP-style offset sample for the merged
                        # timeline's clock alignment (zero extra
                        # round-trips).  Coordinator doubles without
                        # the return value simply reply without it.
                        r = coord.heartbeat(
                            req["trainer_id"], step=int(req.get("step", -1))
                        )
                        self._reply(
                            {"ok": True, **(r if isinstance(r, dict) else {})}
                        )
                    elif self.path == "/ack":
                        coord.ack_generation(req["trainer_id"], req["generation"])
                        self._reply({"ok": True})
                    elif self.path == "/target":
                        # trace_id: the autoscaler decision's causal
                        # trace, stamped into the retargeted plan.
                        try:
                            coord.set_target_world(
                                req["world"],
                                trace_id=str(req.get("trace_id", "")),
                            )
                        except TypeError:
                            # pre-tracing coordinator double
                            coord.set_target_world(req["world"])
                        self._reply({"ok": True})
                    elif self.path == "/prewarm":
                        # Advisory pre-actuation announcement: trainers
                        # AOT-warm the hinted world size's step before
                        # the retarget lands (zero-stall resize).  The
                        # decision's trace id rides the hint.
                        try:
                            coord.set_prewarm(
                                req["world"],
                                trace_id=str(req.get("trace_id", "")),
                            )
                        except TypeError:
                            coord.set_prewarm(req["world"])
                        self._reply({"ok": True})
                    elif self.path == "/telemetry":
                        # A member's cumulative snapshot and an event
                        # tail, idempotent by (trainer_id, boot, seq).
                        coord.report_telemetry(
                            req["trainer_id"],
                            snapshot=req.get("snapshot"),
                            seq=int(req.get("seq", 0)),
                            events=req.get("events"),
                            boot=str(req.get("boot", "")),
                            clock=req.get("clock"),
                        )
                        self._reply({"ok": True})
                    elif self.path == "/checkpoint":
                        coord.report_checkpoint(req["step"])
                        self._reply({"ok": True})
                    elif self.path == "/complete":
                        coord.report_complete(req.get("step", -1))
                        self._reply({"ok": True})
                    elif self.path == "/evict_dead":
                        self._reply({"evicted": coord.evict_dead()})
                    else:
                        self._reply({"error": "not found"}, 404)
                except KeyError as e:
                    self._reply({"error": f"unknown trainer: {e}"}, 404)
                except ValueError as e:
                    self._reply({"error": str(e)}, 400)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None
        self._evict_stop: Optional[threading.Event] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self, evict: bool = True):
        """``evict``: also run the heartbeat-lease reaper (failure
        detection is live only if someone drives ``evict_dead``)."""
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="edl-coord"
        )
        self._thread.start()
        if evict:
            self._evict_stop = threading.Event()
            period = max(self.coordinator._heartbeat_timeout / 2, 0.5)

            def evict_loop():
                while not self._evict_stop.wait(period):
                    self.coordinator.evict_dead()

            threading.Thread(
                target=evict_loop, daemon=True, name="edl-evict"
            ).start()
        return self

    def stop(self):
        if self._evict_stop is not None:
            self._evict_stop.set()
        self._server.shutdown()
        self._server.server_close()


class HTTPCoordinator:
    """Client-side twin of ``LocalCoordinator`` — same methods, same
    types, network underneath.  Injected into ``ElasticTrainer`` by the
    launcher when ``EDL_COORDINATOR_ADDR`` is set."""

    def __init__(
        self,
        address: str,
        timeout: float = 5.0,
        retries: int = 3,
        retry_base_delay: float = 0.2,
        retry_deadline: Optional[float] = None,
        retry_policy=None,
    ):
        """``retries``/``retry_base_delay``/``retry_deadline``
        parameterize the transient-failure backoff (previously
        hardcoded ``0.2 * 2**attempt`` with no deadline): callers
        inside a bounded control tick pass a deadline, the step loop
        keeps the default.  ``retry_policy`` overrides wholesale."""
        from edl_tpu_torch.telemetry.trace import ClockOffsetEstimator
        from edl_tpu_torch.utils.retry import RetryPolicy

        if "://" not in address:
            address = f"http://{address}"
        self.address = address.rstrip("/")
        self.timeout = timeout
        self.retries = retries
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=retries,
            base_delay=retry_base_delay,
            max_delay=2.0,
            deadline=retry_deadline,
        )
        #: NTP-style estimate of the coordinator's clock vs ours, fed
        #: by heartbeat request/response pairs (min-RTT filtered) —
        #: what lets the merged cluster timeline causally order events
        #: across members with skewed wall clocks
        self.clock_estimator = ClockOffsetEstimator()

    def _open(self, req) -> bytes:
        """One raw HTTP round-trip (the seam a fault-injecting
        transport overrides)."""
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return r.read()

    def _request(self, req) -> dict:
        """All coordinator calls are idempotent (register/heartbeat/ack/
        target re-apply cleanly), so transient network failures retry
        under ``retry_policy`` instead of raising into the step loop."""
        import urllib.error

        from edl_tpu_torch.utils.retry import GiveUpError

        import zlib

        try:
            return self.retry_policy.run(
                lambda: json.loads(self._open(req)),
                # An HTTPError means the server answered: not transient.
                retryable=lambda e: not isinstance(e, urllib.error.HTTPError),
                # Per-client jitter stream (stable, so replays are
                # deterministic; distinct, so N clients retrying after
                # a coordinator restart don't re-hit it in lockstep).
                seed=zlib.crc32(self.address.encode()),
                describe="coordinator request",
            )
        except GiveUpError as e:
            raise ConnectionError(
                f"coordinator unreachable after {e.attempts} tries"
            ) from e.last_error

    def _get(self, path: str) -> dict:
        return self._request(f"{self.address}{path}")

    def _post(self, path: str, **payload) -> dict:
        return self._request(
            urllib.request.Request(
                f"{self.address}{path}",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
        )

    # -- LocalCoordinator interface -----------------------------------------
    def register(
        self,
        trainer_id: str,
        address: str = "",
        replica=None,
        host=None,
    ) -> Optional[ElasticPlan]:
        return _plan_from_dict(
            self._post(
                "/register",
                trainer_id=trainer_id,
                address=address,
                replica=replica,
                host=host,
            )["plan"]
        )

    def deregister(self, trainer_id: str):
        self._post("/deregister", trainer_id=trainer_id)

    def heartbeat(self, trainer_id: str, step: int = -1):
        import time as _time
        import urllib.error

        try:
            t0 = _time.time()
            r = self._post("/heartbeat", trainer_id=trainer_id, step=step)
            t1 = _time.time()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                # same contract as LocalCoordinator.heartbeat
                raise KeyError(trainer_id) from None
            raise
        # One free clock-offset sample per beat (retries inflate the
        # apparent RTT; the estimator's min-RTT filter discards them).
        st = r.get("server_time")
        if st is not None:
            self.clock_estimator.add(t0, float(st), t1)

    def ack_generation(self, trainer_id: str, generation: int):
        self._post("/ack", trainer_id=trainer_id, generation=generation)

    def set_target_world(self, n: int, trace_id: str = ""):
        self._post("/target", world=n, trace_id=trace_id)

    def set_prewarm(self, n: int, trace_id: str = ""):
        """Announce the autoscaler's planned next parallelism so
        trainers warm that world size's compiled step ahead of the
        actual retarget (see ``LocalCoordinator.set_prewarm``).  The
        decision's causal-trace id rides the hint."""
        self._post("/prewarm", world=n, trace_id=trace_id)

    def get_target_world(self) -> int:
        return self._get("/target")["world"]

    def report_checkpoint(self, step: int):
        self._post("/checkpoint", step=step)

    def report_complete(self, step: int = -1):
        self._post("/complete", step=step)

    def completed(self) -> bool:
        return bool(self.metrics()["completed"])

    def metrics(self) -> dict:
        """The coordinator snapshot as a dict (``GET
        /metrics?format=json``; the bare path serves Prometheus text)."""
        return self._get("/metrics?format=json")

    def metrics_text(self) -> str:
        """Prometheus text exposition (``GET /metrics``)."""
        import urllib.error
        import zlib

        from edl_tpu_torch.utils.retry import GiveUpError

        url = f"{self.address}/metrics"
        try:
            return self.retry_policy.run(
                lambda: self._open(url).decode(),
                retryable=lambda e: not isinstance(e, urllib.error.HTTPError),
                seed=zlib.crc32(self.address.encode()),
                describe="coordinator metrics scrape",
            )
        except GiveUpError as e:
            raise ConnectionError(
                f"coordinator unreachable after {e.attempts} tries"
            ) from e.last_error

    def report_telemetry(
        self,
        trainer_id: str,
        snapshot: Optional[dict] = None,
        seq: int = 0,
        events: Optional[list] = None,
        boot: str = "",
        clock: Optional[dict] = None,
    ):
        """One attempt, no backoff (unlike every other call): the report
        is cumulative and sent again every cadence anyway, and it runs
        on the member's heartbeat thread, where a retry storm could
        outlast the membership lease.  ``clock`` defaults to this
        client's own heartbeat-fed offset estimate."""
        if clock is None:
            off = self.clock_estimator.offset()
            if off is not None:
                clock = {"offset": off, "rtt": self.clock_estimator.rtt()}
        payload = {
            "trainer_id": trainer_id,
            "snapshot": snapshot,
            "seq": seq,
            "events": events,
            "boot": boot,
            "clock": clock,
        }
        req = urllib.request.Request(
            f"{self.address}/telemetry",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        json.loads(self._open(req))

    def telemetry(self) -> dict:
        return self._get("/telemetry")

    def evict_dead(self) -> List[str]:
        return self._post("/evict_dead")["evicted"]

    def plan(self) -> Optional[ElasticPlan]:
        return _plan_from_dict(self._get("/plan")["plan"])

    def members(self) -> List[str]:
        return self._get("/members")["members"]


def main(argv=None):  # pragma: no cover - pod entrypoint
    p = argparse.ArgumentParser(description="edl_tpu_torch coordinator service")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7164)
    p.add_argument("--min-world", type=int, default=1)
    p.add_argument("--max-world", type=int, default=1)
    p.add_argument("--heartbeat-timeout", type=float, default=10.0)
    p.add_argument(
        "--target-steps",
        type=int,
        default=0,
        help="steps after which the job is complete (0 = open-ended; "
        "trainers may still POST /complete explicitly)",
    )
    p.add_argument(
        "--legal-sizes",
        default=None,
        help=(
            "comma-separated legal world sizes; absent = every size legal, "
            "explicitly empty = NO legal size (trainers hold at the barrier)"
        ),
    )
    p.add_argument(
        "--hosts",
        type=int,
        default=1,
        help=(
            "pods per trainer replica (multi-host slice topologies: one "
            "replica = an Indexed Job of this many pods)"
        ),
    )
    args = p.parse_args(argv)
    legal = (
        None
        if args.legal_sizes is None
        else [int(s) for s in args.legal_sizes.split(",") if s]
    )
    coord = LocalCoordinator(
        target_world=args.min_world,
        max_world=args.max_world,
        heartbeat_timeout=args.heartbeat_timeout,
        legal_sizes=legal,
        hosts_per_replica=args.hosts,
    )
    if args.target_steps:
        coord.set_target_steps(args.target_steps)
    server = CoordinatorServer(coord, host=args.host, port=args.port)
    server.start(evict=True)
    print(f"edl_tpu_torch coordinator listening on {args.host}:{server.port}")
    threading.Event().wait()  # serve until killed


if __name__ == "__main__":  # pragma: no cover
    main()
