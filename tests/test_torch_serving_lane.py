"""The port's serving lane (``edl_tpu_torch.autoscaler.serving``) against
the JAX package's, on the CPU.

- The same sequence of merged-telemetry snapshots goes through both
  lanes: ``observe()`` and ``desired_replicas`` agree at every tick
  (p95 over the window delta, stale rejections, TTFT and the decode
  queue, hysteresis), as ``tests/test_serving.py``,
  ``tests/test_decode_serving.py`` and ``tests/test_serving_drain.py``
  hold the JAX lane.
- With tiny port replicas behind a router: a scale-down drains its
  rank-tail victim (handing its live generation to the survivor, passed
  as ``migrate_to``) before the retarget and the patch, the router hears
  the drain intent before the victim hears the drain, and a victim that
  cannot drain inside its budget blocks the patch.
"""

import time

import numpy as np
import pytest
import torch

from edl_tpu import telemetry as jax_telemetry
from edl_tpu.autoscaler.serving import ServingLane as JaxLane
from edl_tpu_torch import telemetry
from edl_tpu_torch.autoscaler.serving import ServingLane
from edl_tpu_torch.models import get_model
from edl_tpu_torch.runtime import LocalCoordinator
from edl_tpu_torch.serving import (
    ContinuousBatcher,
    DecodeEngine,
    RequestRouter,
    ServingReplica,
    ServingServer,
    TokenContinuousBatcher,
)

# ---- observe() and the band against the JAX lane -------------------------------


class _Scripted:
    """A coordinator whose merged telemetry is the next snapshot of a
    script and whose target follows the lane's proposals."""

    def __init__(self, snaps, target=1):
        self.snaps, self.target, self.i = snaps, target, -1

    def telemetry(self):
        self.i += 1
        return self.snaps[self.i]

    def metrics(self):
        return {"target_world": self.target}


def _merged(reg):
    snap = reg.snapshot()
    return {"merged": {k: snap[k] for k in ("counters", "gauges", "histograms")}}


def _script(name, ticks=14):
    """Cumulative merged snapshots of one traffic story, one per tick."""
    reg = telemetry.MetricsRegistry()
    lat = reg.histogram("edl_serve_latency_seconds")
    ttft = reg.histogram("edl_serve_ttft_seconds")
    reqs = reg.counter("edl_serve_requests_total")
    depth = reg.gauge("edl_serve_queue_depth")
    dq = reg.gauge("edl_serve_decode_queue_depth")
    kv = reg.gauge("edl_serve_kv_occupancy")
    rs = np.random.RandomState(len(name))
    out = []
    for k in range(ticks):
        if name == "p95_window":  # a slow morning, then fast traffic: p95 forgets it
            for v in rs.exponential(1.5 if k < 4 else 0.01, size=20):
                lat.observe(float(v))
                reqs.inc(status="ok")
            depth.set(int(rs.randint(0, 12)) if k < 4 else 0)
        elif name == "stale_rejections":  # a lifetime total, then a fresh burst
            reqs.inc(5 if k == 0 else (3 if k == 6 else 0), status="rejected")
            lat.observe(0.01)
        elif name == "ttft_decode_queue":
            for v in rs.exponential(1.2 if 3 <= k < 7 else 0.02, size=10):
                ttft.observe(float(v))
            dq.set(int(rs.randint(0, 10)) if k < 9 else 0)
            kv.set(float(np.round(rs.rand(), 3)))
        elif name == "hysteresis":  # busy, idle, one blip, idle to the floor
            depth.set(9 if k in (0, 1, 7) else 0)
        out.append(_merged(reg))
    return out


@pytest.mark.parametrize("name", ["p95_window", "stale_rejections", "ttft_decode_queue",
                                  "hysteresis"])
def test_observe_and_band_equal_the_jax_lane_tick_for_tick(name):
    snaps = _script(name)

    def run(lane_cls, tel):
        with tel.scoped():
            coord = _Scripted(snaps, target=2)
            lane = lane_cls(coord, min_replicas=1, max_replicas=4, hold_ticks=2,
                            ttft_high_s=0.5 if name == "ttft_decode_queue" else None)
            out = []
            for _ in snaps:
                obs = lane.observe()
                current = lane.current_replicas()
                proposed, reason = lane.desired_replicas(obs, current)
                coord.target = proposed
                out.append((obs, current, proposed, reason))
        return out

    got = run(ServingLane, telemetry)
    assert got == run(JaxLane, jax_telemetry)
    proposals = [p for _, _, p, _ in got]
    assert len(set(proposals)) > 1, proposals  # the story moves the band
    if name == "stale_rejections":
        assert got[0][0]["rejected_total"] is None and got[6][0]["rejected_total"] == 3


# ---- the kube glue and the autoscaler tick, against the JAX package's ---------------


def _glue_story(jax):
    """A serving job's lane rides a training ``Autoscaler``'s tick
    (``attach_serving_lane``) with ``kube_replica_glue`` as its
    ``on_scale``, on a FakeKube holding the job's serving Deployment: a
    deep queue for three ticks, then an idle one for three.  Returns,
    per tick, the Deployment's replicas, the coordinator's target and
    the tick's decision entry in the autoscaler's log."""
    from torch_vocab import tpu_to_gpu

    if jax:
        from edl_tpu import telemetry as tel
        from edl_tpu.autoscaler import serving as lanes
        from edl_tpu.autoscaler.scaler import Autoscaler
        from edl_tpu.cluster.cluster import Cluster
        from edl_tpu.cluster.kube import FakeKube, NodeInfo
        from edl_tpu.controller.jobparser import parse_to_serving_manifests
        from edl_tpu.resource.training_job import TrainingJob
    else:
        from edl_tpu_torch import telemetry as tel
        from edl_tpu_torch.autoscaler import serving as lanes
        from edl_tpu_torch.autoscaler.scaler import Autoscaler
        from edl_tpu_torch.cluster.cluster import Cluster
        from edl_tpu_torch.cluster.kube import FakeKube, NodeInfo
        from edl_tpu_torch.controller.jobparser import parse_to_serving_manifests
        from edl_tpu_torch.resource.training_job import TrainingJob
    manifest = {"apiVersion": "edl.tpu.dev/v1", "kind": "TrainingJob",
                "metadata": {"name": "serve-glue"},
                "spec": {"fault_tolerant": True, "global_batch_size": 64,
                         "checkpoint_dir": "/ckpts",
                         "trainer": {"entrypoint": "transformer_lm", "min_instance": 1,
                                     "max_instance": 4, "slice_topology": "v5e-1"},
                         "serving": {"min_replicas": 1, "max_replicas": 4}}}
    job = TrainingJob.from_manifest(manifest if jax else tpu_to_gpu(manifest)).validate()
    node = {"tpu_chips": 8} if jax else {"gpus": 8}
    kube = FakeKube([NodeInfo(name="n0", cpu_milli=64000, memory_mega=262144, **node)])
    cluster = Cluster(kube)
    kube.apply_manifests(parse_to_serving_manifests(job))

    class Coord:
        target, depth = 1, 50

        def telemetry(self):
            return {"merged": {"counters": {}, "histograms": {},
                               "gauges": {"edl_serve_queue_depth": {"": self.depth}}}}

        def metrics(self):
            return {"target_world": self.target}

        def set_prewarm(self, n, trace_id=""):
            pass

        def set_target_world(self, n, trace_id=""):
            self.target = n

    out = []
    with tel.scoped():
        coord = Coord()
        scaler = Autoscaler(cluster, coord_client_factory=lambda j: None)
        lanes.attach_serving_lane(scaler, lanes.ServingLane(
            coord, min_replicas=1, max_replicas=4, hold_ticks=1,
            on_scale=lanes.kube_replica_glue(cluster, job)))
        for depth in (50, 50, 50, 0, 0, 0):
            coord.depth = depth
            assert scaler.run_once() is None  # no training job in the lane
            e = scaler.decision_log[-1]
            out.append((kube.get_workload(job.serving_name(), kind="Deployment").parallelism,
                        coord.target, e["lane"], e["dry_run"], e["actuated"], e["reason"]))
    return out


def test_kube_replica_glue_moves_the_deployment_on_the_autoscaler_tick_as_in_jax():
    got = _glue_story(jax=False)
    assert got == _glue_story(jax=True)
    assert [(dep, target) for dep, target, *_ in got] == [
        (2, 2), (3, 3), (4, 4), (3, 3), (2, 2), (1, 1)]
    assert {lane for _, _, lane, *_ in got} == {"serving"}


# ---- tiny port replicas -------------------------------------------------------------------

V = 256
BT = 16
PROMPT = [int(x) for x in np.random.RandomState(5).randint(3, V, size=21)]


@pytest.fixture(scope="module")
def lm_weights():
    """The tiny LM's seeded init with every matrix scaled 8x (greedy
    tokens then vary)."""
    model = get_model("transformer_lm", tiny=True, dtype=torch.float32)
    sd = model.init_params(torch.Generator().manual_seed(0))
    return {k: v * 8.0 if v.ndim >= 2 else v for k, v in sd.items()}


def _engine(sd, slow=0.0):
    model = get_model("transformer_lm", tiny=True, dtype=torch.float32)
    eng = DecodeEngine(model, device="cpu", max_seqs=4, block_tokens=BT)
    eng.install(sd, step=1)
    if slow:
        real = eng.decode_step
        eng.decode_step = lambda *a: (time.sleep(slow), real(*a))[1]
    return eng


def _replica(coord, eng, rid, address=True):
    server = ServingServer(ContinuousBatcher(eng), port=0)
    return ServingReplica(
        eng, server=server, coordinator=coord, replica_id=rid,
        address=f"127.0.0.1:{server.port}" if address else "", heartbeat_interval=60.0,
        telemetry_interval=0, gen_batcher=TokenContinuousBatcher(eng, refresh=False),
    ).start()


def _recording(coord, log):
    """Log the coordinator's prewarm and retarget calls in order, each
    with the flight recorder's newest sequence number at the call."""
    for name in ("set_prewarm", "set_target_world"):
        real = getattr(coord, name)

        def call(n, trace_id="", real=real, name=name):
            evs = telemetry.get_recorder().events(1)
            log.append((name, n, trace_id, evs[-1].seq if evs else -1))
            return real(n, trace_id=trace_id)

        setattr(coord, name, call)


def test_scale_down_drains_the_tail_into_the_survivor_before_the_retarget(lm_weights):
    """An idle fleet of two sheds one.  The router hears the drain
    intent first (``route.steer``), then the rank-tail victim drains
    with the survivor as ``migrate_to``, handing over its live
    generation, and only then come the prewarm, the retarget and the
    patch, all under the decision's trace id.  The migrated generation
    equals the same generation run unmigrated."""
    n = 40
    with telemetry.scoped() as (_, rec):
        ref = TokenContinuousBatcher(_engine(lm_weights), refresh=False).start()
        try:
            want = ref.submit_generate({"tokens": PROMPT}, max_new_tokens=n).result(timeout=60)[0]
        finally:
            ref.stop()
        coord = LocalCoordinator(target_world=2, max_world=4, heartbeat_timeout=1e9)
        survivor = _replica(coord, _engine(lm_weights), "lane-a")
        victim = _replica(coord, _engine(lm_weights, slow=0.02), "lane-b")
        calls, patches = [], []
        _recording(coord, calls)
        try:
            router = RequestRouter(coord)
            router.sync()
            router.probe_all()
            assert list(coord.plan().members) == ["lane-a", "lane-b"]
            live = victim.gen_batcher.submit_generate({"tokens": PROMPT}, max_new_tokens=n)
            deadline = time.monotonic() + 30
            while victim.gen_batcher.active_count < 1:
                assert time.monotonic() < deadline, "the generation never started"
                time.sleep(0.005)
            lane = ServingLane(coord, router=router, min_replicas=1, max_replicas=4,
                               hold_ticks=1, victim_drain_timeout=20.0,
                               on_scale=lambda old, new: patches.append((old, new, len(rec))))
            n_before = len(rec)
            entry = lane.run_once()
            tokens = live.result(timeout=60)[0]
        finally:
            survivor.stop()
            victim.stop()
    assert entry["actuated"] and entry["dry_run"]["proposed"] == 1
    drain = entry["drain"]
    assert drain["acked"] and [v["replica"] for v in drain["victims"]] == ["lane-b"]
    assert drain["migrate_to"] == survivor.address
    assert drain["victims"][0]["migrated"] == 1
    assert tokens == want  # the handed-over generation is bit-identical
    tid = entry["trace_id"]
    assert tid and [c[0] for c in calls] == ["set_prewarm", "set_target_world"]
    assert {c[2] for c in calls} == {tid} and patches and patches[0][:2] == (2, 1)
    evs = rec.events()[n_before:]
    steer = [e.seq for e in evs if e.kind == "route.steer" and e.data.get("replica") == "lane-b"]
    start = [e for e in evs if e.kind == "serve.drain" and e.data.get("phase") == "start"]
    done = [e for e in evs if e.kind == "serve.drain" and e.data.get("phase") == "done"]
    assert steer and start and done
    assert steer[0] < start[0].seq < done[-1].seq <= calls[0][3]
    assert start[0].trace == tid
    decision = [e for e in evs if e.kind == "autoscaler.decision"]
    assert decision and decision[0].seq > done[-1].seq and decision[0].trace == tid


def test_a_victim_that_cannot_drain_blocks_the_patch(lm_weights):
    """With no addressed survivor there is no migration: the victim's
    long generation cannot finish inside the lane's budget, so nothing
    is retargeted or patched this tick, and the next tick after the
    generation ends sheds it."""
    with telemetry.scoped():
        coord = LocalCoordinator(target_world=2, max_world=4, heartbeat_timeout=1e9)
        survivor = _replica(coord, _engine(lm_weights), "blk-a", address=False)
        victim = _replica(coord, _engine(lm_weights, slow=0.02), "blk-b")
        calls, patches = [], []
        _recording(coord, calls)
        try:
            live = victim.gen_batcher.submit_generate({"tokens": PROMPT}, max_new_tokens=60)
            deadline = time.monotonic() + 30
            while victim.gen_batcher.active_count < 1:
                assert time.monotonic() < deadline, "the generation never started"
                time.sleep(0.005)
            lane = ServingLane(coord, min_replicas=1, max_replicas=4, hold_ticks=1,
                               victim_drain_timeout=0.3,
                               on_scale=lambda old, new: patches.append((old, new)))
            blocked = lane.run_once()
            target_while_blocked = coord.target_world()
            live.result(timeout=60)
            shed = lane.run_once()
        finally:
            survivor.stop()
            victim.stop()
    assert not blocked["actuated"] and "drain not acked" in blocked["reason"]
    assert "migrate_to" not in blocked["drain"]
    assert not blocked["drain"]["victims"][0]["acked"]
    assert target_while_blocked == 2
    assert shed["actuated"] and shed["drain"]["acked"]
    assert [c[0] for c in calls] == ["set_prewarm", "set_target_world"] and patches == [(2, 1)]


def test_serving_bidder_scale_down_rides_the_same_drain(lm_weights):
    """The market's serving scale-down (``ServingBidder.actuate``) runs
    the lane's drain before its retarget; an idle victim acks at once."""
    from edl_tpu_torch.fleet import ServingBidder

    with telemetry.scoped() as (_, rec):
        coord = LocalCoordinator(target_world=2, max_world=4, heartbeat_timeout=1e9)
        reps = [_replica(coord, _engine(lm_weights), f"mk-{i}") for i in range(2)]
        calls = []
        _recording(coord, calls)
        try:
            lane = ServingLane(coord, min_replicas=1, max_replicas=2, victim_drain_timeout=10.0)
            bidder = ServingBidder("api", lane, priority=100)
            n_before = len(rec)
            assert bidder.actuate(1, "trace-x")
            assert bidder.wait_drain(1.0)
            members = coord.members()
        finally:
            for r in reps:
                r.stop()
    done = [e.seq for e in rec.events()[n_before:]
            if e.kind == "serve.drain" and e.data.get("phase") == "done"]
    assert done and [c[:3] for c in calls] == [("set_prewarm", 1, "trace-x"),
                                               ("set_target_world", 1, "trace-x")]
    assert calls[0][3] >= done[-1]
    assert members == ["mk-0"]  # the drained victim deregistered
