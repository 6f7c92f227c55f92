"""The port's GPU market (``edl_tpu_torch.fleet``) against the JAX
package's (``edl_tpu.fleet``), on the CPU.

- ``arbitrate`` on every golden scenario of ``tests/test_fleet.py`` and
  on 200 seeded random bid sets gives exactly the JAX fixed point:
  ``targets``, ``preemptions``, ``unmet``, ``free_chips``,
  ``iterations``;
- the arbiter's tick loop on fake coordinators: prewarm before retarget with
  one trace id per transition, downs before ups, the decision log (its
  entries equal the JAX arbiter's on the same coordinators), the
  ``fleet.*`` events and gauges, the blind-coordinator freeze, a failed
  actuation keeping its holding, stale outside holdings cleared;
- ``attach_fleet``, the serving bidder's band, ``TrainingBidder.from_job``
  and ``ChipInventory.from_cluster_resource`` on ``gpu_total`` /
  ``free_gpus``;
- the ``fleet`` CLI's table, JSON and refusal with no bidders;
- the storm of ``tests/test_fleet_process.py`` on real launcher
  processes in gloo worlds: a scripted serving spike takes a GPU from
  the lowest-priority trainer at one agreed stop step and gives it back.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from edl_tpu import fleet as jax_fleet
from edl_tpu import telemetry as jax_telemetry
from edl_tpu_torch import fleet as port_fleet
from edl_tpu_torch import telemetry
from edl_tpu_torch.fleet import (
    ChipInventory,
    FleetArbiter,
    ServingBidder,
    TrainingBidder,
    attach_fleet,
)
from torch_vocab import tpu_to_gpu

ROOT = Path(__file__).resolve().parents[1]

# ---- the pure fixed point: the port's against the JAX package's -------------


def _bid(pkg, spec):
    """One ``Bid`` of ``pkg`` from a plain spec tuple."""
    kind, name, pri, cur, mn, mx, chips, util, legal, req = spec
    return pkg.Bid(
        name=name, kind=kind, priority=pri, chips_per_unit=chips, min_units=mn,
        max_units=mx, current_units=cur, legal_units=list(legal or []),
        required_units=req, utility=util, elastic=mn < mx,
    )


def T(name, pri=0, cur=1, mn=1, mx=4, chips=1, util=None, legal=None):
    return ("training", name, pri, cur, mn, mx, chips, util, legal, None)


def S(name, cur=1, req=1, mn=1, mx=4, chips=1):
    return ("serving", name, 100, cur, mn, mx, chips, None, None, req)


#: every golden scenario of tests/test_fleet.py: (bids, total chips)
GOLDEN = {
    "calm_full_inventory": ([T("lo", 0, 2, mx=2), T("hi", 10, 1, mx=1), S("s", 1, 1, mx=2)], 4),
    "starved_low_priority": ([T("lo", 0, 1, mx=4), T("hi", 10, 1, mx=4)], 5),
    "max_capped": ([T("a", 0, 1, mx=3)], 8),
    "inventory_exhaustion": ([T("a", 5, 1, mx=8, chips=2), T("b", 3, 1, mx=8, chips=2),
                              T("c", 0, 1, mx=8, chips=2)], 9),
    "spike_preempts_lowest": ([T("lo", 0, 2, mx=2), T("hi", 10, 2, mx=2), S("api", 1, 2, mx=2)], 5),
    "chips_return": ([T("lo", 0, 1, mx=2), T("hi", 10, 1, mx=1), S("api", 2, 1, mx=2)], 4),
    "preemption_stops_at_min": ([T("lo", 0, 1, mx=2), S("api", 1, 4, mx=4)], 2),
    "oscillation_first": ([T("lo", 0, 2, mx=4), T("hi", 10, 1, mx=4), S("api", 1, 2, mx=2)], 6),
    "goodput_orders_growth": ([T("meh", 0, 1, mx=4, util=0.05), T("good", 0, 1, mx=4, util=0.8),
                               T("blind", 0, 1, mx=4)], 4),
    "diminishing_utility": ([T("a", 0, 1, mx=4, util=0.9), T("b", 0, 1, mx=4, util=0.8)], 6),
    "rotating_victims": ([T("a", 0, 4, mx=4), T("b", 0, 4, mx=4), S("api", 1, 5, mx=5)], 9),
    "legal_size_quantized": ([T("lo", 0, 4, mx=4, legal=[1, 2, 4]), S("api", 1, 2, mx=2)], 5),
    "oversubscription": ([T("lo", 0, 4, mx=4), T("hi", 9, 4, mx=4)], 5),
}


def _outcome(pkg, specs, total):
    r = pkg.arbitrate([_bid(pkg, s) for s in specs], total)
    return {"targets": r.targets, "preemptions": r.preemptions, "unmet": r.unmet,
            "free_chips": r.free_chips, "iterations": r.iterations}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_scenario_equals_the_jax_arbiter(name):
    specs, total = GOLDEN[name]
    got = _outcome(port_fleet, specs, total)
    assert got == _outcome(jax_fleet, specs, total)
    if name == "spike_preempts_lowest":
        assert got["targets"] == {"lo": 1, "hi": 2, "api": 2}
        assert [p["victim"] for p in got["preemptions"]] == ["lo"]
    if name == "rotating_victims":
        assert [p["victim"] for p in got["preemptions"]] == ["a", "b", "a", "b"]


def test_oscillation_free_convergence_equals_the_jax_arbiter():
    """A fixed point's targets fed back as currents: no diff, no
    preemption, one iteration, in both packages."""
    specs, total = GOLDEN["oscillation_first"]
    first = _outcome(port_fleet, specs, total)["targets"]
    again = [T("lo", 0, first["lo"], mx=4), T("hi", 10, first["hi"], mx=4),
             S("api", first["api"], 2, mx=2)]
    got = _outcome(port_fleet, again, total)
    assert got == _outcome(jax_fleet, again, total)
    assert got["targets"] == first and not got["preemptions"] and got["iterations"] == 1


def test_duplicate_bid_names_rejected_as_in_the_jax_arbiter():
    for pkg in (port_fleet, jax_fleet):
        with pytest.raises(ValueError):
            pkg.arbitrate([_bid(pkg, T("x")), _bid(pkg, T("x"))], 4)


def _random_market(seed):
    """2-6 bidders of mixed kinds, priorities, bounds, legal sizes,
    utilities and requirements, and an inventory from short to slack."""
    rs = np.random.RandomState(seed)
    specs = []
    for i in range(rs.randint(2, 7)):
        mn = int(rs.randint(1, 3))
        mx = mn + int(rs.randint(0, 5))
        cur = int(rs.randint(mn, mx + 1))
        chips = int(rs.choice([1, 1, 2, 4]))
        if rs.rand() < 0.35:
            req, pri = int(rs.randint(0, mx + 2)), int(rs.randint(0, 200))
            specs.append(("serving", f"s{i}", pri, cur, mn, mx, chips, None, None, req))
            continue
        legal = None
        if rs.rand() < 0.4:
            legal = sorted({int(x) for x in rs.randint(mn, mx + 1, size=3)} | {mn})
        util = None if rs.rand() < 0.3 else float(np.round(rs.rand(), 3))
        specs.append(T(f"t{i}", int(rs.randint(0, 4)), cur, mn, mx, chips, util, legal))
    need = sum(s[3] * s[6] for s in specs)
    return specs, int(rs.randint(max(0, need - 6), need + 10))


@pytest.mark.parametrize("block", range(8))
def test_random_bid_sets_equal_the_jax_arbiter(block):
    """200 seeded random markets (25 per case)."""
    for seed in range(block * 25, block * 25 + 25):
        specs, total = _random_market(seed)
        assert _outcome(port_fleet, specs, total) == _outcome(jax_fleet, specs, total), seed


# ---- the ledger and the resource model ---------------------------------------


def test_chip_inventory_accounting():
    inv = ChipInventory(total_chips=8)
    inv.set_holding("a", 3)
    inv.set_holding("b", 2)
    assert inv.free() == 3 and inv.allocated() == 5
    inv.set_holding("a", 0)
    assert "a" not in inv.holdings and inv.free() == 6
    assert inv.snapshot() == {"total_chips": 8, "free_chips": 6, "holdings": {"b": 2}}
    with pytest.raises(ValueError):
        inv.set_holding("c", -1)


def test_inventory_from_cluster_resource_reads_gpus():
    from edl_tpu.cluster.resources import ClusterResource as JaxResource
    from edl_tpu_torch.cluster.resources import ClusterResource

    r = ClusterResource(gpu_total=16, gpu_limit=6)
    assert r.free_gpus() == 10
    inv = ChipInventory.from_cluster_resource(r)
    want = jax_fleet.ChipInventory.from_cluster_resource(JaxResource(tpu_total=16, tpu_limit=6))
    assert inv.snapshot() == want.snapshot()
    assert inv.total_chips == 16 and inv.holdings == {"(scheduled)": 6} and inv.free() == 10


def _jobs(priority=7, mn=1, mx=8):
    from edl_tpu.resource.training_job import TrainingJob as JaxJob
    from edl_tpu_torch.resource.training_job import TrainingJob

    m = {"apiVersion": "edl.tpu.dev/v1", "kind": "TrainingJob", "metadata": {"name": "j"},
         "spec": {"fault_tolerant": True, "priority": priority, "global_batch_size": 96,
                  "trainer": {"min_instance": mn, "max_instance": mx, "slice_topology": "v5e-4"}}}
    return TrainingJob.from_manifest(tpu_to_gpu(m)).validate(), JaxJob.from_manifest(m).validate()


def test_training_bidder_from_job_reads_the_gpu_spec():
    job, jax_job = _jobs()
    b = TrainingBidder.from_job(job, coordinator=None)
    want = jax_fleet.TrainingBidder.from_job(jax_job, coordinator=None)
    assert job.gpu_per_trainer() == 4
    for k in ("name", "priority", "chips_per_unit", "min_units", "max_units", "legal_units"):
        assert getattr(b, k) == getattr(want, k), k
    assert b.legal_units == [1, 2, 3, 4, 6, 8]


# ---- the arbiter's tick loop ------------------------------------------------------


class FakeCoord:
    """Coordinator double shared across bidders; every call lands in a
    common sequenced log so cross-job ordering is assertable."""

    def __init__(self, world, seq, name, goodput=None):
        self.world, self.seq, self.name, self.goodput = world, seq, name, goodput

    def metrics(self):
        return {"target_world": self.world, "world_size": self.world,
                "world_acked": True, "acked_members": 1}

    def telemetry(self):
        if self.goodput is None:
            return {}
        return {"goodput": {"frac": self.goodput}, "step_rate": 5.0}

    def set_prewarm(self, n, trace_id=""):
        self.seq.append((self.name, "prewarm", n, trace_id))

    def set_target_world(self, n, trace_id=""):
        self.seq.append((self.name, "target", n, trace_id))
        self.world = n


class FakeLane:
    """A ``ServingLane`` stand-in: a fixed requirement, real bounds."""

    def __init__(self, coord, required, mn=1, mx=2):
        self.coordinator, self.required = coord, required
        self.min_replicas, self.max_replicas = mn, mx
        self.on_scale = None

    def observe(self):
        return {"p95_latency_s": None, "queue_depth": 0}

    def current_replicas(self):
        return self.coordinator.world

    def desired_replicas(self, obs, current):
        return self.required, "scripted"


def _market(pkg, seq, required=1, lo_cls=FakeCoord):
    lo = lo_cls(2, seq, "lo", goodput=0.9)
    hi = FakeCoord(1, seq, "hi", goodput=0.8)
    api = FakeCoord(1, seq, "api")
    arbiter = pkg.FleetArbiter(
        4,
        trainers=[pkg.TrainingBidder("lo", lo, priority=0, min_units=1, max_units=2),
                  pkg.TrainingBidder("hi", hi, priority=10, min_units=1, max_units=1)],
        fleets=[pkg.ServingBidder("api", FakeLane(api, required))],
    )
    return arbiter, lo, hi, api


def test_arbiter_prewarm_before_retarget_per_transition_with_own_trace():
    with telemetry.scoped():
        seq = []
        arbiter, lo, hi, api = _market(port_fleet, seq, required=2)
        assert arbiter.run_once() is not None
    lo_ops = [op for op in seq if op[0] == "lo"]
    api_ops = [op for op in seq if op[0] == "api"]
    assert [op[1] for op in lo_ops] == ["prewarm", "target"]
    assert [op[1] for op in api_ops] == ["prewarm", "target"]
    lo_traces, api_traces = {op[3] for op in lo_ops}, {op[3] for op in api_ops}
    assert len(lo_traces) == 1 and len(api_traces) == 1
    assert lo_traces != api_traces and "" not in lo_traces | api_traces
    assert seq.index(lo_ops[0]) < seq.index(api_ops[0])  # downs first
    assert lo.world == 1 and api.world == 2 and hi.world == 1


def _scrub(entry):
    """A decision entry with its random trace id reduced to its presence."""
    return {**entry, "trace_id": bool(entry["trace_id"])}


def test_arbiter_decision_log_equals_the_jax_arbiter():
    with telemetry.scoped():
        arbiter, *_ = _market(port_fleet, [], required=2)
        rec = arbiter.run_once()
    with jax_telemetry.scoped():
        jax_arbiter, *_ = _market(jax_fleet, [], required=2)
        want = jax_arbiter.run_once()
    assert [_scrub(d) for d in rec["decisions"]] == [_scrub(d) for d in want["decisions"]]
    for d, w in zip(rec["decisions"], want["decisions"]):
        assert set(d) == set(w) and set(d["dry_run"]) == {"current", "proposed", "diff"}
    assert {k: v for k, v in rec.items() if k != "decisions"} == {
        k: v for k, v in want.items() if k != "decisions"}
    entries = {d["job"]: d for d in rec["decisions"]}
    assert entries["lo"]["preempted"] and entries["lo"]["preempted_by"] == "api"
    assert entries["lo"]["drained"] is True and entries["lo"]["actuated"]
    assert entries["hi"]["trace_id"] == "" and entries["api"]["required_units"] == 2
    assert arbiter.decision_log[-3:] == rec["decisions"]


def test_arbiter_journals_fleet_events_and_gauges_as_the_jax_arbiter():
    def run(pkg, tel):
        with tel.scoped() as (reg, rec):
            _market(pkg, [], required=2)[0].run_once()
            events = [(e.kind, {k: v for k, v in e.data.items() if not k.endswith("trace")})
                      for e in rec.events()]
            traces = [e.data for e in rec.events() if e.kind == "fleet.preempt"]
            snap = reg.snapshot()
        fleet = {k: v for kind in ("gauges", "counters") for k, v in snap[kind].items()
                 if k.startswith("edl_fleet_")}
        return events, traces, fleet

    events, traces, fleet = run(port_fleet, telemetry)
    want_events, _, want_fleet = run(jax_fleet, jax_telemetry)
    assert events == want_events and fleet == want_fleet
    assert [k for k, _ in events].count("fleet.decision") == 3
    assert traces[0]["victim"] == "lo" and traces[0]["victim_trace"]
    assert traces[0]["beneficiary_trace"]
    assert fleet["edl_fleet_chips_total"][""] == 4 and fleet["edl_fleet_chips_free"][""] == 0
    assert fleet["edl_fleet_chips_allocated"] == {"job=lo": 1, "job=hi": 1, "job=api": 2}
    assert fleet["edl_fleet_preemptions_total"]["job=lo"] == 1
    assert len(set(fleet)) == 7


def test_unreachable_coordinator_freezes_its_holding():
    class DeadCoord:
        def metrics(self):
            raise ConnectionError("down")

    with telemetry.scoped():
        arbiter, lo, hi, api = _market(port_fleet, [], required=2)
        arbiter.trainers[0] = TrainingBidder("lo", DeadCoord(), priority=0, min_units=1,
                                             max_units=2)
        arbiter.inventory.set_holding("lo", 2)  # its pods still hold 2 GPUs
        rec = arbiter.run_once()
    assert rec["blind"] == ["lo"] and "lo" not in {d["job"] for d in rec["decisions"]}
    assert api.world == 1 and hi.world == 1 and rec["unmet"] == {"api": 1}


def test_failed_actuation_keeps_the_physical_holding():
    class FlakyCoord(FakeCoord):
        def set_target_world(self, n, trace_id=""):
            raise ConnectionError("retarget lost")

    with telemetry.scoped():
        arbiter, *_ = _market(port_fleet, [], required=2, lo_cls=FlakyCoord)
        rec = arbiter.run_once()
    entry = next(d for d in rec["decisions"] if d["job"] == "lo")
    assert not entry["actuated"] and entry["drained"] is False
    assert arbiter.inventory.holdings["lo"] == 2


def test_market_clears_stale_non_fleet_holdings():
    src = {"inv": ChipInventory(total_chips=4)}
    src["inv"].set_holding("(scheduled)", 2)
    with telemetry.scoped():
        lo = FakeCoord(1, [], "lo", goodput=0.5)
        arbiter = FleetArbiter(lambda: src["inv"], trainers=[
            TrainingBidder("lo", lo, priority=0, min_units=1, max_units=4)])
        assert arbiter.run_once()["inventory"]["holdings"] == {"(scheduled)": 2, "lo": 2}
        src["inv"] = ChipInventory(total_chips=4)  # the outside workload is done
        assert arbiter.run_once()["inventory"]["holdings"] == {"lo": 4}


def test_attach_fleet_rides_the_autoscaler_tick():
    from edl_tpu_torch.autoscaler.scaler import Autoscaler

    class NullCluster:
        def update_parallelism(self, job, n):
            pass

        def delete_pod(self, name):
            return True

    with telemetry.scoped():
        sc = Autoscaler(NullCluster(), coord_client_factory=lambda j: None)
        arbiter, *_ = _market(port_fleet, [], required=2)
        attach_fleet(sc, arbiter)
        assert sc.run_once() is None  # no single-cluster jobs registered
        assert {d["job"] for d in sc.decision_log if d.get("lane") == "fleet"} == {
            "lo", "hi", "api"}
        with pytest.raises(ValueError):
            attach_fleet(sc, arbiter)


def test_serving_bidder_band_equals_the_jax_bidder():
    """The real ``ServingLane`` band (p95 window, hysteresis) drives the
    bid's hard requirement, tick for tick as in the JAX package."""
    from edl_tpu.autoscaler.serving import ServingLane as JaxLane
    from edl_tpu.runtime.coordinator import LocalCoordinator as JaxCoord
    from edl_tpu_torch.autoscaler.serving import ServingLane
    from edl_tpu_torch.runtime.coordinator import LocalCoordinator

    def run(pkg, lane_cls, coord_cls, tel):
        with tel.scoped():
            coord = coord_cls(target_world=1, max_world=2)
            sig = {"p95_latency_s": 0.01, "queue_depth": 0}
            bidder = pkg.ServingBidder("api", lane_cls(coord, min_replicas=1, max_replicas=2,
                                                       hold_ticks=2),
                                       signals=lambda: dict(sig))
            out = [bidder.collect()]
            sig["p95_latency_s"] = 3.0
            out.append(bidder.collect())
            sig["p95_latency_s"] = 0.001
            coord.set_target_world(2)
            out += [bidder.collect(), bidder.collect()]
        return [(b.required_units, b.current_units, b.observed["slo_reason"]) for b in out]

    got = run(port_fleet, ServingLane, LocalCoordinator, telemetry)
    assert got == run(jax_fleet, JaxLane, JaxCoord, jax_telemetry)
    assert [g[0] for g in got] == [1, 2, 2, 1]  # grow, hold 1/2, shed on tick 2
    assert "overloaded" in got[1][2]


# ---- the fleet CLI -------------------------------------------------------------


def test_fleet_cli_table_and_json(capsys):
    from edl_tpu_torch.cli import main
    from edl_tpu_torch.runtime.coord_service import CoordinatorServer
    from edl_tpu_torch.runtime.coordinator import LocalCoordinator

    coord = LocalCoordinator(target_world=2, max_world=2)
    coord.register("t0")
    coord.register("t1")
    server = CoordinatorServer(coord, host="127.0.0.1", port=0).start()
    try:
        url = f"127.0.0.1:{server.port}"
        assert main(["fleet", "--job", f"lo={url},chips=4,priority=2", "--chips", "16"]) == 0
        out = capsys.readouterr().out
        assert "lo" in out and "training" in out
        assert "chips allocated: 8 / 16 total" in out
        assert main(["fleet", "--job", f"lo={url},chips=4", "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["bidders"][0]["chips"] == 8 and doc["chips_allocated"] == 8
        assert doc["bidders"][0]["world"] == 2 and doc["chips_total"] is None
    finally:
        server.stop()


def test_fleet_cli_requires_bidders(capsys):
    from edl_tpu_torch.cli import main

    assert main(["fleet"]) == 2
    assert "no bidders" in capsys.readouterr().err


# ---- the storm on real processes ----------------------------------------------------

#: per-wait bound, seconds (each process wait carries its own)
STORM_WAIT_S = 60


def _lines(path):
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                pass  # a line still being written
    return out


def _steps_at(path, world):
    return [r["step"] for r in _lines(path) if "step" in r and r["world_size"] == world]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(pred, what, procs, timeout=STORM_WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        for p in procs:
            if p.poll() is not None:
                raise AssertionError(f"a launcher exited ({p.returncode}) waiting for {what}:\n"
                                     + p.stdout.read().decode(errors="replace")[-3000:])
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


def test_fleet_spike_steals_gpus_from_lowest_priority_and_returns(tmp_path):
    """``tests/test_fleet_process.py`` on the port: ``lo-a``/``lo-b``
    (priority 0, a gloo world of 2) and ``hi-a`` (priority 10) are
    launcher processes at the tiny configuration, the serving fleet's
    SLO signals are scripted, and the arbiter owns a 4-GPU inventory
    (lo 2 + hi 1 + api 1: calm is full).  The spike is absorbed only by
    preempting lo at one agreed stop step; the GPU comes back when it
    clears; hi is never touched; each transition has its own trace id,
    and lo's coordinator formed each of lo's worlds under its decision's
    id.  (The JAX test's compile count has no counterpart: eager
    PyTorch compiles nothing per world size.)"""
    from edl_tpu_torch.autoscaler.serving import ServingLane
    from edl_tpu_torch.runtime.coord_service import CoordinatorServer, HTTPCoordinator
    from edl_tpu_torch.runtime.coordinator import LocalCoordinator

    lo_coord = LocalCoordinator(target_world=2, max_world=2, heartbeat_timeout=60.0,
                                legal_sizes=[1, 2])
    hi_coord = LocalCoordinator(target_world=1, max_world=1, heartbeat_timeout=60.0,
                                legal_sizes=[1])
    serve_coord = LocalCoordinator(target_world=1, max_world=2)
    servers = {n: CoordinatorServer(c, host="127.0.0.1", port=0).start()
               for n, c in (("lo", lo_coord), ("hi", hi_coord))}
    hist = {n: str(tmp_path / f"{n}.jsonl") for n in ("lo-a", "lo-b", "hi-a")}
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               EDL_TELEMETRY_INTERVAL="0.5")
    procs = []
    try:
        for name, job in (("lo-a", "lo"), ("lo-b", "lo"), ("hi-a", "hi")):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "edl_tpu_torch.launcher", "--entrypoint", "transformer_lm",
                 "--device", "cpu", "--tiny", "--steps", "200000", "--global-batch-size", "8",
                 "--checkpoint-interval", "25", "--coordinator", f"127.0.0.1:{servers[job].port}",
                 "--address", f"127.0.0.1:{_free_port()}", "--history-file", hist[name]],
                env=dict(env, EDL_POD_NAME=name), cwd=str(ROOT),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        _wait(lambda: all(len(_steps_at(hist[n], 2)) >= 3 for n in ("lo-a", "lo-b")),
              "the lo world stepping at 2", procs)
        _wait(lambda: len(_steps_at(hist["hi-a"], 1)) >= 3, "hi-a stepping", procs)

        scripted = {"p95_latency_s": 0.01, "queue_depth": 0, "rejected_total": None}
        lane = ServingLane(serve_coord, min_replicas=1, max_replicas=2, hold_ticks=2)
        with telemetry.scoped() as (_, rec):
            arbiter = FleetArbiter(
                4,
                trainers=[TrainingBidder("lo", HTTPCoordinator(f"127.0.0.1:{servers['lo'].port}"),
                                         priority=0, min_units=1, max_units=2, legal_units=[1, 2]),
                          TrainingBidder("hi", HTTPCoordinator(f"127.0.0.1:{servers['hi'].port}"),
                                         priority=10, min_units=1, max_units=1)],
                fleets=[ServingBidder("api", lane, priority=100, signals=lambda: dict(scripted))],
                victim_drain_timeout=STORM_WAIT_S,
            )
            timeline = []

            def tick(phase):
                r = arbiter.run_once()
                timeline.append((phase, r))
                return r

            calm = [tick("calm") for _ in range(2)]
            hi_gen = hi_coord.generation()

            scripted["p95_latency_s"] = 2.0  # the spike
            spike = tick("spike")
            down_plan = lo_coord.plan()
            survivor = down_plan.members[0]  # whichever member registered first
            _wait(lambda: any(s > max(_steps_at(hist[survivor], 2)) for s in
                              _steps_at(hist[survivor], 1)),
                  "the lo survivor stepping at 1", procs)
            for _ in range(2):
                tick("spike-hold")
            last2 = {n: max(_steps_at(hist[n], 2)) for n in ("lo-a", "lo-b")}
            assert serve_coord.target_world() == 2

            scripted["p95_latency_s"] = 0.001  # the spike clears
            recover = []
            for _ in range(4):
                recover.append(tick("recover"))
                if serve_coord.target_world() == 1:
                    break
            up_plan = lo_coord.plan()
            mark = len(_lines(hist[survivor]))
            _wait(lambda: any(r.get("world_size") == 2 for r in _lines(hist[survivor])[mark:]),
                  "lo restored to 2", procs)
            hi_stable = hi_coord.generation() == hi_gen
            fleet_events = [e for e in rec.events() if e.kind.startswith("fleet.")]
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(timeout=STORM_WAIT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=STORM_WAIT_S)
        for s in servers.values():
            s.stop()

    def entry(r, job):
        return next(d for d in r["decisions"] if d["job"] == job)

    # the market: calm is a fixed point, the victim is the lowest priority
    assert sum(abs(d["dry_run"]["diff"]) for r in calm for d in r["decisions"]) == 0
    preemptions = [p for _, r in timeline for p in r["preemptions"]]
    assert preemptions and all(p["victim"] == "lo" and p["beneficiary"] == "api"
                               for p in preemptions)
    spiked = [r["inventory"]["holdings"] for ph, r in timeline if ph.startswith("spike")]
    assert spiked and all(h == {"api": 2, "hi": 1, "lo": 1} for h in spiked)
    assert timeline[-1][1]["inventory"]["holdings"] == {"api": 1, "hi": 1, "lo": 2}
    assert serve_coord.target_world() == 1
    # every storm tick covered the serving requirement
    assert all((d["required_units"] or 0) <= d["dry_run"]["proposed"]
               for ph, r in timeline if ph != "calm" for d in r["decisions"]
               if d["kind"] == "serving")

    # consensus-clean scale-down: one agreed stop step, drained before api grew
    assert last2["lo-a"] == last2["lo-b"] > 0
    sizes = [x["resize"] for x in _lines(hist[survivor]) if "resize" in x]
    down = [r for prev, r in zip(sizes, sizes[1:])
            if prev["world_size"] == 2 and r["world_size"] == 1]
    assert len(down) == 1 and down[0]["stop_step"] == last2[survivor] + 1
    lo_spike = entry(spike, "lo")
    assert lo_spike["preempted"] and lo_spike["preempted_by"] == "api"
    assert lo_spike["priority"] == 0 and entry(spike, "hi")["priority"] == 10
    assert lo_spike["drained"] is True

    # one trace id per transition; lo's coordinator formed each world under its id
    restore = next(r for r in recover if entry(r, "lo")["dry_run"]["diff"] > 0)
    ids = [entry(spike, "lo")["trace_id"], entry(spike, "api")["trace_id"],
           entry(restore, "lo")["trace_id"], entry(restore, "api")["trace_id"]]
    assert all(ids) and len(set(ids)) == 4
    assert down_plan.trace_id == ids[0] and down_plan.world_size == 1
    assert up_plan.trace_id == ids[2] and up_plan.world_size == 2
    preempt_ev = [e for e in fleet_events if e.kind == "fleet.preempt"]
    assert preempt_ev and preempt_ev[0].data["victim_trace"] == ids[0]
    assert preempt_ev[0].data["beneficiary_trace"] == ids[1]

    # the protected high-priority job was never touched
    assert hi_stable
    assert sorted({x["resize"]["world_size"] for x in _lines(hist["hi-a"]) if "resize" in x}) == [1]
