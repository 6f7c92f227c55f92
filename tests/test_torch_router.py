"""The port's serving fleet front door, on the CPU.

- ``RetryingClient``'s contract, each case run on the port's client and
  on the JAX package's side by side (same attempts, same outcomes, same
  back-off sleeps): 429 backs off here, 503 goes elsewhere, a refused
  connection is dead, a 4xx is never retried, and exhaustion is typed,
  saturated against broken;
- ``RequestRouter`` fed the same ``plan()`` and ``telemetry()`` as the
  JAX package's gives the same candidate order and ``routing_table()``;
- the router against scriptable stub replicas: a drain intent steers
  before the 503, the healthz draining bit and the journal's
  ``serve.drain`` events steer, passive eject with probe-only readmit,
  503 + Retry-After for a saturated fleet against 502 for a broken one,
  advisory prefix affinity;
- live port replicas: a stream cut by killing a replica's server is
  re-driven on a survivor with no token duplicated or dropped, and
  restarts when the survivor's weights differ; the replicas' telemetry
  reports reach the coordinator's merge.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu import telemetry as jax_telemetry
from edl_tpu.models.transformer_lm import TransformerLM as FlaxLM
from edl_tpu.serving import RequestRouter as JaxRouter
from edl_tpu.serving import client as jax_client
from edl_tpu_torch import telemetry
from edl_tpu_torch.convert import params_from_flax
from edl_tpu_torch.models import get_model
from edl_tpu_torch.runtime import LocalCoordinator
from edl_tpu_torch.serving import (
    ContinuousBatcher,
    DecodeEngine,
    RequestRouter,
    RouterServer,
    ServingReplica,
    ServingServer,
    TokenContinuousBatcher,
)
from edl_tpu_torch.serving import client as port_client

V, D, FF, H, LAYERS, L = 256, 64, 256, 4, 2, 64
BT = 16

# -- RetryingClient: the port's and the JAX package's, side by side -------------


class _FakeWire:
    """Deterministic clock and sleep for the retry loop."""

    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def clock(self):
        return self.t

    def sleep(self, d):
        self.sleeps.append(round(d, 6))
        self.t += d


class _Scripted:
    """A target that raises or returns from a per-call script."""

    def __init__(self, name, script):
        self.name = name
        self.script = list(script)
        self.calls = 0

    def __call__(self, request):
        self.calls += 1
        step = self.script.pop(0) if self.script else None
        if isinstance(step, BaseException):
            raise step
        return step


def _client_case(mod, name):
    """One client scenario on ``mod`` (the port's client module or the
    JAX package's).  Returns what the caller observes: the result or
    the typed exhaustion, every attempt's outcome, every sleep."""
    wire = _FakeWire()
    full = lambda ra: mod.QueueFullError("full", retry_after=ra)  # noqa: E731
    scripts = {
        "queue_full_backs_off_here": [[full(0.07), full(0.07), {"ok": "a"}]],
        "draining_goes_elsewhere": [[mod.DrainingError("leaving", retry_after=0.5)],
                                    [{"ok": "b"}]],
        "refused_is_dead": [[ConnectionError("refused")], [{"ok": "b"}]],
        "client_error_never_retried": [[mod.UpstreamClientError(400, {"error": "bad"})],
                                       [{"ok": "b"}]],
        "saturated_exhaustion": [[full(0.2)] * 20, [full(0.2)] * 20],
        "broken_exhaustion": [[ConnectionError("refused")] * 20],
        "empty_fleet": [],
    }[name]
    targets = [_Scripted(chr(97 + i), s) for i, s in enumerate(scripts)]
    outcomes = []
    client = mod.RetryingClient(
        targets, budget_s=2.0, attempts=12, sleep=wire.sleep, clock=wire.clock,
        on_attempt=lambda t, o, e: outcomes.append((t.name, o)),
    )
    try:
        got = ("ok", client.call({}))
    except mod.RetryBudgetExhausted as e:
        got = ("exhausted", e.saturated, e.retry_after, e.attempts)
    except mod.UpstreamClientError as e:
        got = ("client_error", e.status)
    return got, outcomes, wire.sleeps, [t.calls for t in targets]


@pytest.mark.parametrize("name", [
    "queue_full_backs_off_here", "draining_goes_elsewhere", "refused_is_dead",
    "client_error_never_retried", "saturated_exhaustion", "broken_exhaustion",
    "empty_fleet",
])
def test_retrying_client_contract_equals_the_jax_package(name):
    got, outcomes, sleeps, calls = _client_case(port_client, name)
    assert (got, outcomes, sleeps, calls) == _client_case(jax_client, name)
    if name == "queue_full_backs_off_here":
        assert calls == [3] and sleeps == [0.07, 0.07] and got == ("ok", {"ok": "a"})
    elif name in ("draining_goes_elsewhere", "refused_is_dead"):
        assert calls == [1, 1] and sleeps == [] and got == ("ok", {"ok": "b"})
    elif name == "client_error_never_retried":
        assert calls == [1, 0] and got == ("client_error", 400)
    elif name == "saturated_exhaustion":
        assert got[:2] == ("exhausted", True) and got[2] >= 0.2
    else:
        assert got[:2] == ("exhausted", False)


def test_http_status_contract_is_typed(tmp_path):
    """``http_call`` maps 429 to QueueFullError (with the Retry-After
    hint), 503 to DrainingError, another 4xx to UpstreamClientError and
    a refused connection to ConnectionError."""
    stubs = [
        _StubReplica("c429", predict=lambda r: (429, {"error": "full"}, [("Retry-After", "0.250")])),
        _StubReplica("c503", predict=lambda r: (503, {"error": "leaving", "retry_after_s": 0.7})),
        _StubReplica("c400", predict=lambda r: (400, {"error": "bad prompt"})),
    ]
    try:
        with pytest.raises(port_client.QueueFullError) as e:
            port_client.http_call(stubs[0].address, "/predict", {})
        assert e.value.retry_after == 0.25
        with pytest.raises(port_client.DrainingError) as e:
            port_client.http_call(stubs[1].address, "/predict", {})
        assert e.value.retry_after == 0.7
        with pytest.raises(port_client.UpstreamClientError) as e:
            port_client.http_call(stubs[2].address, "/predict", {})
        assert e.value.status == 400
        dead = stubs[2].address
        stubs[2].stop()
        with pytest.raises(ConnectionError):
            port_client.http_call(dead, "/predict", {}, timeout=5)
    finally:
        for s in stubs:
            s.stop()


# -- stub replicas: router logic without an engine ---------------------------------


class _StubReplica:
    """A scriptable fake serving replica: /healthz vitals plus /predict
    and /generate behaviours returning (code, body[, headers])."""

    def __init__(self, rid, healthz=None, predict=None, generate=None):
        self.rid = rid
        self.healthz = healthz or {}
        self.predict = predict or (lambda req: (200, {"outputs": {"y": [1.0]}, "weights_step": 1}))
        self.generate = generate
        self.hits = []
        self._srv = None
        self._bind(0)

    def _handler(self):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _reply(self, code, body, headers=()):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    base = {"ok": True, "weights_step": 1, "weights_generation": 0,
                            "queue_depth": 0, "queue_limit": 8, "saturation": 0.0,
                            "in_flight": 0, "draining": False}
                    base.update(outer.healthz)
                    self._reply(200 if base.get("ok") else 503, base)
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                outer.hits.append((self.path, req))
                if self.path == "/predict":
                    out = outer.predict(req)
                elif self.path == "/generate" and outer.generate:
                    out = outer.generate(req)
                else:
                    out = (404, {"error": "not found"})
                self._reply(out[0], out[1], out[2] if len(out) > 2 else ())

        return Handler

    def _bind(self, port):
        self._srv = ThreadingHTTPServer(("127.0.0.1", port), self._handler())
        self.port = self._srv.server_address[1]
        self.address = f"127.0.0.1:{self.port}"
        threading.Thread(target=self._srv.serve_forever, daemon=True).start()

    def stop(self):
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None

    def restart(self):
        """Come back on the same address (a restarted pod)."""
        self.stop()
        self._bind(self.port)


class _Plan:
    def __init__(self, members, addresses, generation=1):
        self.generation = generation
        self.members = tuple(members)
        self.addresses = tuple(addresses)


class _StubCoord:
    """A plan and telemetry double."""

    def __init__(self, members, addresses, events=None, gauges=None, hists=None):
        self.members, self.addresses = list(members), list(addresses)
        self.events = list(events or [])
        self.gauges = gauges or {}
        self.hists = hists or {}

    @classmethod
    def of(cls, stubs, **kw):
        return cls([s.rid for s in stubs], [s.address for s in stubs], **kw)

    def plan(self):
        return _Plan(self.members, self.addresses)

    def telemetry(self):
        return {"merged": {"counters": {}, "gauges": self.gauges, "histograms": self.hists},
                "events": list(self.events)}


def test_router_order_and_routing_table_equal_the_jax_router():
    """Same plan, labeled gauges, TTFT histogram and drain events into
    both routers (no probes): the same candidate order, with and without
    prefix affinity, and the same routing table."""
    ids = [f"r-{i}" for i in range(4)]
    gauges = {
        "edl_serve_queue_depth": {"replica=r-0": 5.0, "replica=r-1": 1.0, "replica=r-3": 2.0},
        "edl_serve_decode_queue_depth": {"replica=r-1": 1.0, "replica=r-2": 0.0},
        "edl_serve_kv_occupancy": {"replica=r-2": 0.75, "replica=r-3": 0.1},
    }
    reg = telemetry.MetricsRegistry()
    for x in (0.01, 0.02, 0.04, 0.2, 0.3):
        reg.histogram("edl_serve_ttft_seconds").observe(x)
    hists = reg.snapshot()["histograms"]
    events = [{"seq": 3, "kind": "serve.drain", "data": {"replica": "r-3", "phase": "start"}}]
    prompt = list(range(3, 3 + 40))
    out = []
    for Router, tel in ((RequestRouter, telemetry), (JaxRouter, jax_telemetry)):
        with tel.scoped():
            coord = _StubCoord(ids, [f"127.0.0.1:{9 + i}" for i in range(4)],
                               events=events, gauges=gauges, hists=hists)
            r = Router(coord)
            r.sync()
            r._block_tokens = BT
            hashes = r._chain_hashes({"inputs": {"tokens": prompt}})
            plain = [v.replica_id for v in r._order(generate=True)]
            r._remember_affinity(hashes, "r-2")
            affine = [v.replica_id for v in r._order(generate=True, hashes=hashes)]
            r.mark_draining(["r-0"])
            after = [v.replica_id for v in r._order()]
            out.append((hashes, plain, affine, after, r.routing_table()))
    assert out[0] == out[1]
    hashes, plain, affine, after, table = out[0]
    assert len(hashes) == 2 and plain == ["r-1", "r-2", "r-0"]
    assert affine == ["r-2", "r-1", "r-0"] and after == ["r-1", "r-2"]
    assert {r["replica"]: r["health"] for r in table["replicas"]}["r-3"] == "draining"
    assert table["ttft_p95_s"] is not None


def test_router_least_loaded_pick_and_drain_intent_steers_before_the_503():
    """The least-loaded replica takes the admission; a drain intent
    takes the victim out of rotation at once, so it never has to 503
    anyone, and journals route.steer under the decision's trace."""
    with telemetry.scoped() as (reg, rec):
        stubs = [_StubReplica(f"st-{i}") for i in range(3)]
        try:
            router = RequestRouter(_StubCoord.of(stubs))
            router.sync()
            router.probe_all()
            with router._lock:
                router._replicas["st-0"].queue_depth = 6.0
                router._replicas["st-1"].queue_depth = 1.0
                router._replicas["st-2"].kv_occupancy = 0.9
            assert [v.replica_id for v in router._order()] == ["st-1", "st-2", "st-0"]
            router.predict({"inputs": {}})
            assert [len(s.hits) for s in stubs] == [0, 1, 0]
            router.mark_draining(["st-1"], trace="tr-drain")
            for _ in range(3):
                router.predict({"inputs": {}})
            assert [len(s.hits) for s in stubs] == [0, 1, 3]
            steers = [e for e in rec.events() if e.kind == "route.steer"]
            assert steers[0].data == {"replica": "st-1", "source": "intent"}
            assert steers[0].trace == "tr-drain"
            assert reg.counter("edl_route_steers_total").value() == 3
            assert reg.counter("edl_route_retries_total").value(reason="draining") == 0
        finally:
            for s in stubs:
                s.stop()


def test_router_healthz_bit_and_journal_events_steer():
    with telemetry.scoped() as (_, rec):
        stubs = [_StubReplica("hz-0", healthz={"draining": True}), _StubReplica("hz-1"),
                 _StubReplica("hz-2")]
        try:
            coord = _StubCoord.of(stubs)
            router = RequestRouter(coord)
            router.sync()
            router.probe_all()
            assert [v.replica_id for v in router._routable()] == ["hz-1", "hz-2"]
            coord.events = [{"seq": 7, "kind": "serve.drain", "trace": "tr-j",
                             "data": {"replica": "hz-2", "phase": "start"}}]
            router.sync()
            router.sync()  # the same tail again: the watermark dedupes
            assert [v.replica_id for v in router._routable()] == ["hz-1"]
            steers = [(e.data["replica"], e.data["source"]) for e in rec.events()
                      if e.kind == "route.steer"]
            assert steers == [("hz-0", "healthz"), ("hz-2", "journal")]
        finally:
            for s in stubs:
                s.stop()


def test_router_passive_eject_and_probe_only_readmit():
    """Consecutive refused attempts eject; a good request cannot bring
    the replica back, only a clean active /healthz probe can."""
    with telemetry.scoped() as (reg, rec):
        dead, live = _StubReplica("ej-0"), _StubReplica("ej-1")
        try:
            router = RequestRouter(_StubCoord.of([dead, live]), eject_after=3)
            router.sync()
            router.probe_all()
            dead.stop()  # connection refused from now on
            for _ in range(3):
                assert router.predict({"inputs": {}})["weights_step"] == 1
            assert [e.data for e in rec.events() if e.kind == "route.eject"] == [
                {"replica": "ej-0", "consecutive_failures": 3}]
            router.predict({"inputs": {}})  # the ejected one is not tried
            assert len(live.hits) == 4
            assert reg.counter("edl_route_retries_total").value(reason="refused") == 3
            router.probe("ej-0")
            health = {r["replica"]: r["health"] for r in router.routing_table()["replicas"]}
            assert health["ej-0"] == "ejected"
            dead.restart()
            assert router.probe("ej-0")
            health = {r["replica"]: r["health"] for r in router.routing_table()["replicas"]}
            assert health["ej-0"] == "healthy"
            assert reg.counter("edl_route_readmits_total").value() == 1
        finally:
            dead.stop()
            live.stop()


def test_router_server_answers_503_when_saturated_and_502_when_broken():
    with telemetry.scoped():
        full = _StubReplica("sat-0", predict=lambda req: (
            429, {"error": "queue full", "retry_after_s": 0.01}, [("Retry-After", "0.010")]))
        router = RequestRouter(_StubCoord.of([full]), retry_budget_s=0.4, attempts=6,
                               base_backoff_s=0.005, max_backoff_s=0.02)
        router.sync()
        router.probe_all()
        server = RouterServer(router, host="127.0.0.1", sync_interval_s=30.0).start()
        base = f"http://127.0.0.1:{server.port}"

        def post(path, payload):
            req = urllib.request.Request(f"{base}{path}", data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"},
                                         method="POST")
            return urllib.request.urlopen(req, timeout=15)

        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                post("/predict", {"inputs": {}})
            assert ei.value.code == 503 and ei.value.headers.get("Retry-After") is not None
            body = json.loads(ei.value.read())
            assert body["saturated"] is True and body["retry_after_s"] >= 0.01
            full.stop()  # now the fleet is gone, not busy
            with pytest.raises(urllib.error.HTTPError) as ei:
                post("/predict", {"inputs": {}})
            assert ei.value.code == 502 and ei.value.headers.get("Retry-After") is None
            with urllib.request.urlopen(f"{base}/routes", timeout=5) as r:
                assert json.loads(r.read())["replicas"][0]["replica"] == "sat-0"
            with router._lock:
                router._replicas["sat-0"].health = "ejected"
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"{base}/healthz", timeout=5)
            assert ei.value.code == 503
        finally:
            server.stop()
            full.stop()


def test_router_prefix_affinity_is_advisory():
    with telemetry.scoped() as (reg, _):
        hz = {"decode": {"block_tokens": 8, "decode_queue_depth": 0, "kv_occupancy": 0.0}}
        stubs = [_StubReplica(f"aff-{i}", healthz=dict(hz), generate=lambda req: (
            200, {"tokens": [1, 2], "weights_step": 1})) for i in range(2)]
        try:
            router = RequestRouter(_StubCoord.of(stubs))
            router.sync()
            router.probe_all()
            prompt = list(range(1, 17))  # two full 8-token blocks
            assert router.generate({"inputs": {"tokens": prompt}, "max_new_tokens": 2})[
                "tokens"] == [1, 2]
            assert len(stubs[0].hits) == 1  # a tie picks aff-0
            hashes = router._chain_hashes({"inputs": {"tokens": prompt}})
            with router._lock:
                router._replicas["aff-0"].queue_depth = 3.0  # within the bound
            assert router._order(generate=True, hashes=hashes)[0].replica_id == "aff-0"
            with router._lock:
                router._replicas["aff-0"].queue_depth = 10.0  # beyond it
            assert router._order(generate=True, hashes=hashes)[0].replica_id == "aff-1"
            assert reg.counter("edl_route_affinity_total").value(outcome="hit") == 1
        finally:
            for s in stubs:
                s.stop()


# -- live port replicas --------------------------------------------------------------


@pytest.fixture(scope="module")
def lm_weights():
    """Two weight sets of the tiny LM (float32): a flax init with every
    matrix scaled 8x (greedy decode then varies its tokens), and the
    same with the embedding scaled again (the purity-skew survivor)."""
    fm = FlaxLM(V, D, FF, H, LAYERS, L, dtype=jnp.float32)
    params = fm.init(jax.random.key(0), jnp.zeros((1, L), jnp.int32))["params"]
    params = jax.tree_util.tree_map(lambda x: np.asarray(x) * 8.0 if x.ndim >= 2 else
                                    np.asarray(x), params)
    sd = params_from_flax(params)
    return {1: sd, 2: {k: v * 1.5 if k == "embed.weight" else v for k, v in sd.items()}}


def _engine(sd, step):
    model = get_model("transformer_lm", tiny=True, dtype=torch.float32)
    eng = DecodeEngine(model, device="cpu", max_seqs=4, block_tokens=BT)
    eng.install(sd, step=step)
    return eng


def _replica(coord, eng, rid):
    server = ServingServer(ContinuousBatcher(eng), port=0)
    return ServingReplica(
        eng, server=server, coordinator=coord, replica_id=rid,
        address=f"127.0.0.1:{server.port}", heartbeat_interval=0.05,
        telemetry_interval=0, gen_batcher=TokenContinuousBatcher(eng, refresh=False),
    ).start()


def _ref(eng, prompt, n):
    b = TokenContinuousBatcher(eng, refresh=False).start()
    try:
        return b.submit_generate({"tokens": prompt}, max_new_tokens=n).result(timeout=60)[0]
    finally:
        b.stop()


PROMPT = [int(x) for x in np.random.RandomState(8).randint(3, V, size=19)]


@pytest.mark.parametrize("survivor_step", [1, 2], ids=["resume", "restart_on_purity_skew"])
def test_stream_cut_by_a_killed_replica_is_redriven(lm_weights, survivor_step):
    """The first replica dies (its server severs the stream) after the
    third token.  On a survivor with the same weights the router
    resumes from prompt + emitted tokens: every reference token once,
    indices contiguous, no restart line.  On a survivor with other
    weights the resumed leg's first-token stamp differs: one restart
    line, then the survivor's own sequence."""
    n = 12
    with telemetry.scoped() as (reg, rec):
        ea, eb = _engine(lm_weights[1], 1), _engine(lm_weights[survivor_step], survivor_step)
        want = _ref(eb, PROMPT, n)
        real = ea.decode_step  # slow the first replica: the kill lands mid-stream
        ea.decode_step = lambda *a: (time.sleep(0.02), real(*a))[1]
        coord = LocalCoordinator(target_world=2, max_world=4, heartbeat_timeout=1e9)
        ra, rb = _replica(coord, ea, "lm-a"), _replica(coord, eb, "lm-b")
        try:
            router = RequestRouter(coord)
            router.sync()
            router.probe_all()
            events = []

            def emit(ev):
                events.append(ev)
                if sum("token" in e for e in events) == 3 and not ra._dead:
                    ra.die()

            router.generate_stream({"inputs": {"tokens": PROMPT}, "max_new_tokens": n}, emit)
        finally:
            if not ra._dead:
                ra.stop()
            rb.stop()
        done = events[-1]
        assert done.get("done") and done["tokens"] == want and done["redriven"] == 1
        # a streamed session teaches affinity: the prompt's one full block
        assert router.routing_table()["affinity_entries"] == 1
        redrives = [e.data["outcome"] for e in rec.events() if e.kind == "route.redrive"]
        restarts = [e for e in events if e.get("restart")]
        if survivor_step == 1:
            toks = [e for e in events if "token" in e]
            assert [e["i"] for e in toks] == list(range(n))
            assert [e["token"] for e in toks] == want
            assert not restarts and redrives == ["resume"]
            assert reg.counter("edl_route_redrives_total").value(outcome="resume") == 1
        else:
            assert len(restarts) == 1 and restarts[0]["redrive"] is True
            after = [e for e in events[events.index(restarts[0]) + 1:] if "token" in e]
            assert [e["i"] for e in after] == list(range(n))
            assert [e["token"] for e in after] == want and after[0]["weights_step"] == 2
            assert redrives == ["resume", "restart"]
        assert len(set(want)) > 2


def test_replica_reports_reach_the_coordinator_merge_and_its_metrics(lm_weights):
    """A replica's telemetry report carries its registry snapshot and
    its recorder's events (``serve.replica``, ``serve.drain``) into the
    coordinator's merge, which the coordinator serves as Prometheus
    text beside its own gauges."""
    with telemetry.scoped() as (reg, _):
        coord = LocalCoordinator(target_world=1, max_world=2, heartbeat_timeout=1e9)
        rep = _replica(coord, _engine(lm_weights[1], 1), "tel-a")
        try:
            rep.tick()
            tel = coord.telemetry()
            assert tel["sources"] == {"tel-a": 1}
            kinds = [(e["kind"], e["data"].get("origin")) for e in tel["events"]]
            assert ("serve.replica", "tel-a") in kinds
            assert "edl_serve_kv_pool_bytes_per_device" in tel["merged"]["gauges"]
            rep.drain(budget_s=5.0)
            rep._report_telemetry()  # a drained replica beats no more
            phases = [e["data"]["phase"] for e in coord.telemetry()["events"]
                      if e["kind"] == "serve.drain"]
            assert phases == ["start", "done"]
            text = coord.metrics_text()
            assert "# TYPE edl_generation gauge" in text
            assert "edl_serve_drains_total 1" in text
            assert reg.counter("edl_telemetry_reports_total").value() == 2
        finally:
            rep.stop()
