"""The port's chaos harness (``edl_tpu_torch.chaos``) against the JAX
package's, on the CPU.

- **The schedule**: ``FaultSchedule`` of the port and of the JAX package
  on the same seed and events give the same ``due`` order, one-shot
  delivery, ``pending`` / ``fired``, 1000 ``roll`` draws over several
  points, ``rng`` streams, ``maybe_raise`` and journal; ``KNOWN_POINTS``
  is the JAX tuple without exactly its four ``fabric.*`` points.
- **The 200-step soak** of ``tests/test_chaos.py`` (grow with restarts,
  refused and torn RPCs, a kill, two deaths with state loss, a corrupted
  checkpoint, timeouts, a coordinator restart, a slow RPC, a shrink)
  over the real HTTP transport, rebuilt on the port's public API with
  the port's ``fit_a_line`` started from the JAX init, beside the JAX
  soak: equal resize tuples, monkey log and injected counts, nothing
  pending, the losses at the float32 tolerance of
  ``tests/test_torch_zoo.py::test_fit_a_line_matches_jax_in_float32``
  (1e-4); two port runs of one seed bit-identical in history, resizes,
  monkey log and the final checkpoint's digest.
- **One case per injection point**: every point of ``KNOWN_POINTS`` has
  a consult site in the port and a case here that fires it, after the
  JAX unit tests of ``tests/test_chaos.py``, ``tests/test_serving*.py``,
  ``tests/test_prefix.py``, ``tests/test_router.py`` and
  ``tests/test_consensus.py``.  The membership, transport, kube and
  serving cases (engine, batchers, replica, prefix cache, migration,
  router) run on both packages side by side, the serving ones on one
  set of weights (the tiny LM's flax init carried over with
  ``convert.py``, float32), and what each observes must be equal: the
  tokens, the journaled serving kinds and prefix outcomes, the restart,
  re-drive, retry, rejection and injection counts, the verdicts.
- **EDL_CHAOS_SPEC**: ``launcher.run`` in a 2-member gloo world whose
  joiner carries ``consensus.vote.delayed`` (it keeps stepping, and
  both leave the old world at the one agreed stop step) and
  ``consensus.watchdog.trip`` (the guarded harvest trips, the world is
  buried and re-formed, no step is lost).
- **The serving soak** of ``chip_smoke.py``'s phase 15 at tiny width,
  twice: the flight recorder's ``digest()`` and the soak log
  bit-identical.
"""

import ast
import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import edl_tpu.chaos as jax_chaos
from edl_tpu import telemetry as jax_telemetry
from edl_tpu.checkpoint import HostDRAMStore as JaxStore
from edl_tpu.models import get_model as jax_get_model
from edl_tpu.models.transformer_lm import TransformerLM as FlaxLM
from edl_tpu.runtime import ShardedDataIterator as JaxIterator
from edl_tpu.runtime.coord_service import CoordinatorServer as JaxServer
from edl_tpu.runtime.coordinator import LocalCoordinator as JaxCoordinator
from edl_tpu.runtime.data import synthetic_dataset as jax_synthetic_dataset
from edl_tpu.runtime.elastic import ElasticTrainer as JaxElasticTrainer
import edl_tpu_torch.chaos as port_chaos
from edl_tpu_torch import telemetry
from edl_tpu_torch.chaos import (
    KNOWN_POINTS,
    ChaosCoordinator,
    ChaosHTTPCoordinator,
    ChaosKube,
    ChaosMonkey,
    FaultEvent,
    FaultSchedule,
    corrupt_newest,
)
from edl_tpu_torch.checkpoint import HostCheckpoint, HostDRAMStore
from edl_tpu_torch.checkpoint import transfer as tx
from edl_tpu_torch.checkpoint.hostdram import leaf_specs
from edl_tpu_torch.convert import fit_a_line_from_flax, params_from_flax
from edl_tpu_torch.models import get_model
from edl_tpu_torch.runtime import (
    BatchStager,
    ElasticTrainer,
    LocalCoordinator,
    ShardedDataIterator,
    synthetic_dataset,
)
from edl_tpu_torch.runtime.coord_service import CoordinatorServer

ROOT = Path(__file__).resolve().parents[1]
#: the float32 tolerance of test_fit_a_line_matches_jax_in_float32
F32 = 1e-4
SOAK_STEPS = 200
SOAK_SEED = 1234


def _events(mod, evs):
    return [mod.FaultEvent(*e) for e in evs]


def _tuples(evs):
    return [(e.step, e.point, e.arg) for e in evs]


# ---- (a) the schedule against the JAX package's ---------------------------------

_EVENTS = [
    (5, "member.kill", "b"),
    (3, "member.kill", "a"),
    (3, "scale.target", 4),
    (3, "transport.refuse", 2),
    (0, "checkpoint.spill", None),
    (7, "member.kill", "c"),
    (7, "serve.queue.full", None),
]
_POINTS = ("member.kill", "scale.target", "transport.refuse", "checkpoint.spill",
           "serve.queue.full")


def _schedule_case(mod, case):
    """What ``case`` observes of package ``mod``'s FaultSchedule."""
    if case == "due":
        s = mod.FaultSchedule(7, _events(mod, _EVENTS))
        out = [_tuples(s.due(p)) for p in _POINTS]  # clock at -1: nothing due
        for step in (0, 3, 4, 5, 9):
            s.advance(step)
            out.append([(step, p, _tuples(s.due(p))) for p in _POINTS])
            out.append([(p, _tuples(s.due(p))) for p in _POINTS])  # one-shot
        s.advance(2)  # the clock never goes back
        out.append((s.now, _tuples(s.pending()), _tuples(s.fired())))
        s2 = mod.FaultSchedule(7, _events(mod, _EVENTS))
        out.append([_tuples(s2.due(p, step=4)) for p in _POINTS])  # an explicit step
        out.append((_tuples(s2.pending()), _tuples(s2.fired())))
        return out
    if case == "roll":
        out = []
        for seed in (0, 7, 1234):
            s = mod.FaultSchedule(seed)
            points = ("transport.refuse", "transport.torn", "serve.request.slow", "member.kill")
            out.append([s.roll(points[i % 4], (i % 10) / 10) for i in range(1000)])
        return out
    if case == "rng":
        return [[mod.FaultSchedule(seed).rng(p).random() for _ in range(3)]
                for seed in (0, 7, 1234) for p in ("transport.slow", "serve.drain.slow")]
    if case == "maybe_raise":
        s = mod.FaultSchedule(0, _events(mod, [(1, "checkpoint.spill"), (1, "stage.batch.failed")]))
        out = []
        for step in (0, 1, 2):
            s.advance(step)
            for point, exc in (("checkpoint.spill", OSError), ("stage.batch.failed", RuntimeError)):
                try:
                    s.maybe_raise(point, exc)
                    out.append((step, point, None))
                except BaseException as e:  # noqa: BLE001 - compared across packages
                    out.append((step, point, type(e).__name__, str(e)))
        return out
    if case == "journal":
        tel = jax_telemetry if mod is jax_chaos else telemetry
        with tel.scoped() as (reg, rec):
            s = mod.FaultSchedule(3, _events(mod, _EVENTS))
            for step in (3, 7):
                s.advance(step)
                for p in _POINTS:
                    s.due(p)
            counts = {p: reg.counter("edl_chaos_injections_total").value(point=p)
                      for p in _POINTS}
            events = [(e.kind, e.step, sorted(e.data.items())) for e in rec.events()]
        return counts, events
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["due", "roll", "rng", "maybe_raise", "journal"])
def test_fault_schedule_matches_the_jax_package(case):
    assert _schedule_case(port_chaos, case) == _schedule_case(jax_chaos, case)


def test_known_points_are_the_jax_points_less_the_fabric_and_strict_rejects_the_rest():
    fabric = [p for p in jax_chaos.KNOWN_POINTS if p.startswith("fabric.")]
    assert len(fabric) == 4
    assert KNOWN_POINTS == tuple(p for p in jax_chaos.KNOWN_POINTS if p not in fabric)
    for point in fabric + ["not.a.point"]:
        with pytest.raises(ValueError, match="unknown injection point"):
            FaultSchedule(0, [FaultEvent(0, point)])
        assert FaultSchedule(0, [FaultEvent(0, point)], strict=False).pending()
    FaultSchedule(0, [FaultEvent(0, p) for p in KNOWN_POINTS])


def _consulted_points():
    """Every point literal the port passes to ``due`` or ``maybe_raise``."""
    found = set()
    for path in sorted((ROOT / "edl_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("due", "maybe_raise") and node.args
                    and isinstance(node.args[0], ast.Constant)):
                found.add(node.args[0].value)
    return found


def test_every_known_point_has_a_consult_site_and_a_case():
    assert _consulted_points() == set(KNOWN_POINTS)
    assert set(POINT_CASES) == set(KNOWN_POINTS)


# ---- (b) the 200-step soak beside the JAX package's ------------------------------


def _soak_events(mod):
    return [mod.FaultEvent(*e) for e in [
        (20, "member.restart", "tr2"),
        (20, "member.restart", "tr3"),
        (20, "scale.target", 4),
        (45, "transport.refuse", 2),
        (50, "member.kill", "tr3"),
        (60, "transport.torn", 2),
        (70, "member.die_with_state", "tr1"),
        (90, "checkpoint.corrupt"),
        (92, "member.die_with_state", "tr2"),
        (110, "scale.target", 4),
        (110, "member.restart", "tr1"),
        (110, "member.restart", "tr2"),
        (110, "member.restart", "tr3"),
        (130, "transport.timeout", 2),
        (140, "coord.restart"),
        (150, "transport.slow", 0.05),
        (160, "scale.target", 2),
        (180, "transport.refuse", 2),
    ]]


@pytest.fixture(scope="module")
def jax_line():
    model = jax_get_model("fit_a_line")
    init = model.init_params(jax.random.key(0))
    return model, jax.tree_util.tree_map(np.asarray, init)


def _port_line(jax_line):
    """The port's fit_a_line, started from the JAX ElasticTrainer's
    initial weights (the JAX model's init at seed 0)."""
    sd = fit_a_line_from_flax(jax_line[1])
    return dataclasses.replace(get_model("fit_a_line"),
                               init_params=lambda g: {k: v.clone() for k, v in sd.items()})


def _soak_result(schedule, history, et, monkey, client, store):
    store.wait()
    final = store.get(SOAK_STEPS)
    assert final is not None, "final-step checkpoint missing"
    return {
        "digest": final.digest(),
        "history": [(r.step, r.generation, r.world_size, float(r.loss)) for r in history],
        "resizes": [(e.generation, e.world_size, e.restored_step, e.replayed_steps,
                     e.graceful, e.restore_source) for e in et.resize_events],
        "monkey_log": list(monkey.log),
        "injected": dict(client.injected),
        "pending": _tuples(schedule.pending()),
        "fired_points": sorted(e.point for e in schedule.fired()),
    }


def _coordinator(cls, target):
    return cls(target_world=target, max_world=4, legal_sizes=[1, 2, 4], heartbeat_timeout=1e9)


def _run_port_soak(model, seed):
    """The soak on the port's public API: a ChaosCoordinator over a
    LocalCoordinator behind a CoordinatorServer, reached through a
    ChaosHTTPCoordinator, driven by a ChaosMonkey."""
    schedule = FaultSchedule(seed, _soak_events(port_chaos))
    it = ShardedDataIterator(synthetic_dataset(model.synth_batch, 512, seed=0), 64, seed=0)
    coord = ChaosCoordinator(_coordinator(LocalCoordinator, 2), schedule)
    coord.register("tr0")
    coord.register("tr1")
    server = CoordinatorServer(coord, host="127.0.0.1", port=0).start(evict=False)
    try:
        client = ChaosHTTPCoordinator(f"127.0.0.1:{server.port}", schedule, timeout=10.0,
                                      retries=5, retry_base_delay=0.02)
        store = HostDRAMStore(keep=3, chaos=schedule)
        et = ElasticTrainer(model, it, client, store=store, lr=1e-2, device="cpu",
                            checkpoint_interval=10, seed=0)
        monkey = ChaosMonkey(schedule, et, coordinator=coord, store=store,
                             coordinator_factory=lambda: _coordinator(LocalCoordinator, 4))
        monkey.track(["tr0", "tr1"])
        history = et.run(SOAK_STEPS, on_step=monkey.on_step)
        return _soak_result(schedule, history, et, monkey, client, store)
    finally:
        server.stop()


def _run_jax_soak(seed):
    """``tests/test_chaos.py``'s soak, built from the JAX package's
    public API."""
    schedule = jax_chaos.FaultSchedule(seed, _soak_events(jax_chaos))
    model = jax_get_model("fit_a_line")
    it = JaxIterator(jax_synthetic_dataset(model.synth_batch, 512, seed=0), global_batch_size=64,
                     seed=0)
    coord = jax_chaos.ChaosCoordinator(_coordinator(JaxCoordinator, 2), schedule)
    coord.register("tr0")
    coord.register("tr1")
    server = JaxServer(coord, host="127.0.0.1", port=0).start(evict=False)
    try:
        client = jax_chaos.ChaosHTTPCoordinator(f"127.0.0.1:{server.port}", schedule,
                                                timeout=10.0, retries=5, retry_base_delay=0.02)
        store = JaxStore(keep=3, chaos=schedule)
        et = JaxElasticTrainer(model, optax.adam(1e-2), it, client, store=store,
                               checkpoint_interval=10, seed=0)
        monkey = jax_chaos.ChaosMonkey(
            schedule, et, coordinator=coord, store=store,
            coordinator_factory=lambda: _coordinator(JaxCoordinator, 4)).track(["tr0", "tr1"])
        history = et.run(SOAK_STEPS, on_step=monkey.on_step)
        return _soak_result(schedule, history, et, monkey, client, store)
    finally:
        server.stop()


def _last_loss_by_step(result):
    out = {}
    for step, _, _, loss in result["history"]:
        out[step] = loss  # replays re-run earlier steps: the last one counts
    return out


def test_the_200_step_soak_matches_the_jax_soak_and_is_bit_reproducible(jax_line):
    model = _port_line(jax_line)
    with telemetry.scoped():
        p1 = _run_port_soak(model, SOAK_SEED)
    with jax_telemetry.scoped():
        j = _run_jax_soak(SOAK_SEED)
    assert p1["pending"] == j["pending"] == []
    assert p1["injected"] == j["injected"] == {"refuse": 4, "timeout": 2, "slow": 1, "torn": 2}
    assert p1["resizes"] == j["resizes"]
    assert p1["monkey_log"] == j["monkey_log"]
    assert p1["fired_points"] == j["fired_points"]
    # the invariants of tests/test_chaos.py: graceful resizes replay
    # nothing; the step-90 corruption falls back to step 80 and replays
    for _, _, restored, replayed, graceful, _ in p1["resizes"]:
        assert replayed == 0 or not graceful
    assert any(r == 80 and not g and n == 13 for _, _, r, n, g, _ in p1["resizes"])
    ports, jaxs = _last_loss_by_step(p1), _last_loss_by_step(j)
    assert sorted(ports) == sorted(jaxs) == list(range(SOAK_STEPS))
    np.testing.assert_allclose([ports[s] for s in range(SOAK_STEPS)],
                               [jaxs[s] for s in range(SOAK_STEPS)], rtol=F32)
    with telemetry.scoped():
        p2 = _run_port_soak(model, SOAK_SEED)
    for key in ("digest", "history", "resizes", "monkey_log", "injected"):
        assert p1[key] == p2[key], key


# ---- (c) one case per injection point --------------------------------------------


def _armed(*events, seed=0, at=0, mod=port_chaos):
    s = mod.FaultSchedule(seed, [mod.FaultEvent(*e) for e in events])
    s.advance(at)
    return s


def _fired(s, point):
    assert point in {e.point for e in s.fired()}, (point, s.fired())
    assert not [e for e in s.pending() if e.point == point]


def _line_world(store, target=2, trainers=2, interval=5, model=None):
    model = model or get_model("fit_a_line")
    it = ShardedDataIterator(synthetic_dataset(model.synth_batch, 512, seed=0), 64, seed=0)
    coord = LocalCoordinator(target_world=target, max_world=8)
    for i in range(trainers):
        coord.register(f"tr{i}")
    et = ElasticTrainer(model, it, coord, store=store, lr=1e-2, device="cpu",
                        checkpoint_interval=interval, seed=0)
    return et, coord


def _state(step, seed=0):
    class _S:
        pass

    s = _S()
    s.step = step
    g = torch.Generator().manual_seed(seed)
    leaves = [torch.randn(64, generator=g), torch.randn(3, 5, generator=g)]
    s.leaves = lambda: leaves
    return s


# -- the two packages: a case that the JAX package can run as well runs
#    on both, and what each observes must agree

V, D, FF, H, LAYERS, L, BT = 256, 64, 256, 4, 2, 64, 16
#: 37 tokens: two full blocks for the prefix cache and a tail; on these
#: weights greedy decode varies its tokens
PROMPT = [int(x) for x in np.random.RandomState(2).randint(3, V, size=37)]


def _pkg_port(sd):
    from edl_tpu_torch import serving
    from edl_tpu_torch.cluster.cluster import Cluster, ParallelismUpdateError
    from edl_tpu_torch.cluster.kube import FakeKube, NodeInfo
    from edl_tpu_torch.resource.training_job import TrainingJob
    from edl_tpu_torch.runtime import Trainer
    from edl_tpu_torch.serving.router import REFUSED
    from edl_tpu_torch.utils.retry import RetryPolicy

    model = get_model("transformer_lm", tiny=True, dtype=torch.float32)

    def lm_state(step):
        state = Trainer(model, device="cpu", seed=0).init_state(sd)
        state.step = step
        return state

    weights = HostDRAMStore()
    weights.save_async(lm_state(0), generation=0)
    weights.wait()

    def lm_engine(chaos=None, store=None):
        """A decode engine loaded with the shared weights (given a
        ``store``, one that the caller loads)."""
        eng = serving.DecodeEngine(model, device="cpu", max_seqs=4, block_tokens=BT,
                                   store=store or weights, chaos=chaos)
        if store is None:
            assert eng.load()
        return eng

    def line_engine(chaos):
        eng = serving.InferenceEngine(get_model("fit_a_line"), device="cpu", max_batch=4,
                                      chaos=chaos)
        eng.install_seeded(0)
        return eng

    def kube():
        return FakeKube([NodeInfo(name=f"gpu-{i}", cpu_milli=8000, memory_mega=32768, gpus=4)
                         for i in range(2)])

    return SimpleNamespace(
        name="port", chaos=port_chaos, tel=telemetry, serving=serving, REFUSED=REFUSED,
        Coordinator=LocalCoordinator, Server=CoordinatorServer, Store=HostDRAMStore,
        lm_engine=lm_engine, lm_state=lm_state, line_engine=line_engine, kube=kube,
        topology="h100-1", TrainingJob=TrainingJob, Cluster=Cluster,
        ParallelismUpdateError=ParallelismUpdateError, RetryPolicy=RetryPolicy)


def _pkg_jax(fm, params):
    from edl_tpu import serving
    from edl_tpu.cluster.cluster import Cluster, ParallelismUpdateError
    from edl_tpu.cluster.kube import FakeKube, NodeInfo
    from edl_tpu.models.transformer_lm import lm_decode_spec
    from edl_tpu.resource.training_job import TrainingJob
    from edl_tpu.runtime.train import TrainState
    from edl_tpu.serving.router import REFUSED
    from edl_tpu.utils.retry import RetryPolicy

    model = dataclasses.replace(jax_get_model("transformer_lm", tiny=True),
                                decode=lm_decode_spec(fm, H, D, L))
    opt = optax.adam(1e-3)

    def state(step, p):
        return TrainState(step=jnp.asarray(step, jnp.int32), params=p, opt_state=opt.init(p))

    def lm_state(step):
        return state(step, params)

    weights = JaxStore()
    weights.save_async(lm_state(0), generation=0)
    weights.wait()

    def lm_engine(chaos=None, store=None):
        eng = serving.DecodeEngine(model, store or weights, devices=jax.devices()[:1],
                                   max_batch=1, max_seqs=4, block_tokens=BT, chaos=chaos)
        if store is None:
            assert eng.load()
        return eng

    line = JaxStore()
    line.save_async(state(1, {"w": jnp.full((13,), 1.0, jnp.float32),
                              "b": jnp.asarray(1.0, jnp.float32)}), generation=0)
    line.wait()

    def line_engine(chaos):
        eng = serving.InferenceEngine(jax_get_model("fit_a_line"), line,
                                      devices=jax.devices()[:1], max_batch=4, chaos=chaos)
        assert eng.load()
        return eng

    def kube():
        return FakeKube([NodeInfo(name=f"pool-{i}", cpu_milli=8000, memory_mega=32768,
                                  tpu_chips=4, tpu_topology="v5e-4") for i in range(2)])

    return SimpleNamespace(
        name="jax", chaos=jax_chaos, tel=jax_telemetry, serving=serving, REFUSED=REFUSED,
        Coordinator=JaxCoordinator, Server=JaxServer, Store=JaxStore,
        lm_engine=lm_engine, lm_state=lm_state, line_engine=line_engine, kube=kube,
        topology="v5e-4", TrainingJob=TrainingJob, Cluster=Cluster,
        ParallelismUpdateError=ParallelismUpdateError, RetryPolicy=RetryPolicy)


@pytest.fixture(scope="module")
def pkgs():
    """Both packages on one set of weights: the tiny LM's flax init with
    every matrix scaled 8x (at the plain init greedy decode repeats one
    token, which would hide a dropped or duplicated token), carried into
    the port with ``convert.py``; float32 on both sides."""
    fm = FlaxLM(V, D, FF, H, LAYERS, L, dtype=jnp.float32)
    params = jax.jit(fm.init)(jax.random.key(0), jnp.zeros((1, L), jnp.int32))["params"]
    params = jax.tree_util.tree_map(lambda x: x * 8.0 if x.ndim >= 2 else x, params)
    sd = params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    return {"port": _pkg_port(sd), "jax": _pkg_jax(fm, params)}


def _on_both(pkgs, fn, point):
    """``fn(P, point)`` on the port and on the JAX package, side by side
    (each package journals into its own telemetry; the cases mostly wait
    on timers): the two observations must be equal.  Returns the
    port's."""
    with ThreadPoolExecutor(len(pkgs)) as pool:
        futures = {name: pool.submit(fn, P, point) for name, P in pkgs.items()}
        got = {name: f.result(timeout=120) for name, f in futures.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


def _gen(P, eng, prompt=PROMPT, n=12, **kw):
    b = P.serving.TokenContinuousBatcher(eng, refresh=False, **kw).start()
    try:
        return b.submit_generate({"tokens": prompt}, max_new_tokens=n).result(timeout=60)
    finally:
        b.stop()


@pytest.fixture(scope="module")
def lm_ref(pkgs):
    """The fault-free run's 12 tokens, the same from both packages."""
    refs = []
    for P in pkgs.values():
        with P.tel.scoped():
            refs.append(_gen(P, P.lm_engine())[0])
    assert refs[0] == refs[1] and len(set(refs[0])) > 2, refs
    return refs[0]


# -- coordinator membership


def _heartbeat(P, point):
    fake_now = [0.0]
    inner = P.Coordinator(target_world=2, heartbeat_timeout=5.0, clock=lambda: fake_now[0])
    s = _armed((0, point, 2 if point.endswith("drop") else 3.0), mod=P.chaos)
    coord = P.chaos.ChaosCoordinator(inner, s)
    coord.register("a")
    fake_now[0] = 4.0
    coord.heartbeat("a")
    if point.endswith("drop"):
        coord.heartbeat("a")
        fake_now[0] = 6.0  # last heard at 0: past the 5 s lease
    else:
        fake_now[0] = 6.1  # the beat at 4 landed as if at 1
    _fired(s, point)
    return {"dropped": coord.dropped_heartbeats, "evicted": coord.evict_dead()}


def case_heartbeat(point, pkgs):
    got = _on_both(pkgs, _heartbeat, point)
    assert got == {"dropped": 2 if point.endswith("drop") else 0, "evicted": ["a"]}


def _coord_restart(P, point):
    """The restart verb touches the coordinator alone: the monkey gets
    no trainer, only the coordinator and a store."""
    s = _armed((0, point), mod=P.chaos)
    coord = P.chaos.ChaosCoordinator(P.Coordinator(target_world=2, max_world=2), s)
    coord.register("tr0")
    coord.register("tr1")
    monkey = P.chaos.ChaosMonkey(
        s, None, coordinator=coord, store=P.Store(),
        coordinator_factory=lambda: P.Coordinator(target_world=2, max_world=2))
    monkey.track(["tr0", "tr1"])
    monkey.on_step(SimpleNamespace(step=0))
    _fired(s, point)
    return {"restarts": coord.restarts, "members": coord.members(), "log": list(monkey.log)}


def case_coord_restart(point, pkgs):
    assert _on_both(pkgs, _coord_restart, point) == {
        "restarts": 1, "members": ["tr0", "tr1"], "log": [(0, "coord.restart", None)]}


def case_monkey_verbs(point):
    """The monkey's step-boundary verbs on a small world: grow to 4 with
    restarts, a kill, a death with state loss (replay), a corruption
    caught at the next fallback, a shrink."""
    s = FaultSchedule(0, [FaultEvent(*e) for e in [
        (4, "member.restart", "tr2"), (4, "member.restart", "tr3"), (4, "scale.target", 4),
        (8, "member.kill", "tr3"), (12, "checkpoint.corrupt"),
        (13, "member.die_with_state", "tr1"), (16, "scale.target", 1)]])
    store = HostDRAMStore(keep=3, chaos=s)
    et, coord = _line_world(store, interval=5)
    monkey = ChaosMonkey(s, et).track(["tr0", "tr1"])
    hist = et.run(24, on_step=monkey.on_step)
    assert s.pending() == []
    got = [(e.world_size, e.restored_step, e.replayed_steps, e.graceful) for e in et.resize_events]
    # Each verb lands where its step is harvested (the drain before an
    # interval save, or the pipeline's lag) and resizes at the next
    # poll.  The death of step 13 is harvested in the drain before the
    # step-15 save, which it leaves nothing to take: the restore skips
    # the corrupted step-10 snapshot for step 5, and 9 steps replay.
    assert got == [(2, 0, 0, False), (4, 5, 0, True), (3, 10, 0, True), (2, 5, 9, False),
                   (1, 19, 0, True)], got
    # the monkey applies one step's verbs in its own order (retarget,
    # kills, deaths, restarts, corruption, coordinator restart)
    assert monkey.log == [(4, "scale.target", 4), (4, "member.restart", "tr2"),
                          (4, "member.restart", "tr3"), (8, "member.kill", "tr3"),
                          (12, "checkpoint.corrupt", 10), (13, "member.die_with_state", "tr1"),
                          (16, "scale.target", 1)]
    assert sorted({r.step for r in hist}) == list(range(24))
    _fired(s, point)


# -- the coord_service transport


def _stop_all(objs):
    """Stop servers, replicas and receivers side by side (each waits out
    its accept loop's poll)."""
    with ThreadPoolExecutor(max(1, len(objs))) as pool:
        list(pool.map(lambda o: o.stop(), objs))


@pytest.fixture(scope="module")
def coord_servers(pkgs):
    """Each package's coordinator (one member, world 1) behind its HTTP
    server, shared by the transport cases."""
    servers = {}
    try:
        for name, P in pkgs.items():
            inner = P.Coordinator(target_world=1)
            inner.register("t0")
            servers[name] = P.Server(inner, host="127.0.0.1", port=0).start(evict=False)
        yield {name: f"127.0.0.1:{server.port}" for name, server in servers.items()}
    finally:
        _stop_all(list(servers.values()))


def _transport(P, point, addr):
    s = _armed((0, point, 0.02 if point.endswith("slow") else 2), mod=P.chaos)
    client = P.chaos.ChaosHTTPCoordinator(addr, s, retries=4, retry_base_delay=0.01)
    got = {"members": client.members(), "world": client.plan().world_size,
           "injected": dict(client.injected)}
    _fired(s, point)
    if point == "transport.refuse":
        # a storm past the retry budget surfaces as ConnectionError
        dead = P.chaos.ChaosHTTPCoordinator(addr, _armed((0, point, 50), mod=P.chaos),
                                            retries=2, retry_base_delay=0.0)
        with pytest.raises(ConnectionError, match="unreachable"):
            dead.members()
        got["storm_injected"] = dict(dead.injected)
    return got


def case_transport(point, pkgs, coord_servers):
    got = _on_both(pkgs, lambda P, p: _transport(P, p, coord_servers[P.name]), point)
    kind = point.split(".")[1]
    assert got["members"] == ["t0"] and got["world"] == 1
    assert got["injected"] == {k: (1 if kind == "slow" else 2) if k == kind else 0
                               for k in ("refuse", "timeout", "slow", "torn")}


# -- the checkpoint store


def case_save_thread(point):
    s = _armed((0, point))
    store = HostDRAMStore(chaos=s)
    store.save_async(_state(2))
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        store.wait()
    assert store.latest() is None
    store.save_async(_state(2))  # one-shot: the next save lands
    store.wait()
    assert store.latest().step == 2
    _fired(s, point)
    # a flush that dies degrades the resize to the interval checkpoint
    # and a replay (elastic._resize's flush guard)
    s2 = FaultSchedule(0, [FaultEvent(0, point)])
    et, coord = _line_world(HostDRAMStore(chaos=s2))
    et.run(8)  # interval checkpoint at step 5
    et.store.wait()
    s2.advance(0)
    coord.set_target_world(1)
    hist = et.run(12)
    ev = et.resize_events[-1]
    assert (ev.graceful, ev.restored_step, ev.replayed_steps) == (False, 5, 3)
    assert [r.step for r in hist][-7:] == list(range(5, 12))


def case_spill(point, tmp_path):
    s = _armed((0, point))
    store = HostDRAMStore(spill_dir=str(tmp_path), chaos=s)
    store.save_async(_state(2))
    with pytest.raises(RuntimeError, match="async checkpoint save failed") as ei:
        store.wait()
    assert isinstance(ei.value.__cause__, OSError)
    ckpt = store.latest_verified()  # the DRAM copy landed before the spill failed
    assert ckpt is not None and ckpt.step == 2
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    _fired(s, point)


def case_flush_spill_slow(point, tmp_path):
    s = FaultSchedule(0, [FaultEvent(0, point, 0.5)])
    et, coord = _line_world(HostDRAMStore(spill_dir=str(tmp_path), chaos=s))
    et.run(8)
    et.store.wait()
    s.advance(0)  # arm the stall for the resize flush
    coord.set_target_world(1)
    hist = et.run(12)
    ev = et.resize_events[-1]
    assert ev.graceful
    assert ev.phase_seconds["flush_bg"] >= 0.5 > ev.phase_seconds["flush"], ev.phase_seconds
    assert (tmp_path / f"ckpt-{8:012d}.npz").exists()  # joined before the resize returned
    assert [r.step for r in hist][-4:] == list(range(8, 12))
    _fired(s, point)


def case_checkpoint_corrupt(point):
    s = _armed((0, point))
    store = HostDRAMStore(keep=3)
    for step in (3, 6):
        store.save_async(_state(step, seed=step))
    store.wait()
    et, _ = _line_world(store)
    monkey = ChaosMonkey(s, et, store=store)
    monkey.on_step(type("R", (), {"step": 0})())
    assert monkey.log == [(0, "checkpoint.corrupt", 6)]
    assert not store.get(6).verify()
    assert store.latest_verified().step == 3 and store.steps() == [3]
    # the flip is the JAX helper's: the same byte of the same leaf
    fresh = HostCheckpoint(step=6, generation=0, leaves=[x.numpy().copy()
                                                         for x in _state(6, seed=6).leaves()])
    jfresh = [x.copy() for x in fresh.leaves]
    corrupt_newest(type("S", (), {"latest": lambda self: fresh})())
    jax_chaos.corrupt_checkpoint(type("C", (), {"leaves": jfresh})())
    assert all(a.tobytes() == b.tobytes() for a, b in zip(fresh.leaves, jfresh))
    _fired(s, point)


# -- the restore transfer


def _run_world(fns):
    world = tx.LoopbackWorld(len(fns))
    results, errors = [None] * len(fns), [None] * len(fns)

    def runner(rank, fn):
        try:
            results[rank] = fn(world.fabric(rank))
        except BaseException as e:  # noqa: BLE001 - returned to the test
            errors[rank] = e

    threads = [threading.Thread(target=runner, args=(r, fn), daemon=True)
               for r, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "member thread hung"
    return results, errors


def case_transfer(point):
    leaves = [x.numpy().copy() for x in _state(4, seed=4).leaves()]
    template = leaf_specs(leaves)
    s = _armed((0, point, 0.3))
    src = HostCheckpoint(step=4, generation=1, leaves=list(leaves))
    t0 = time.perf_counter()
    results, errors = _run_world([
        lambda f: tx.stream_restore(f, template, src, chaos=s),
        lambda f: tx.stream_restore(f, template, None, chaos=s),
    ])
    _fired(s, point)
    if point == "transfer.chunk.torn":
        # the flipped byte fails the chunk's crc on the receiver, and
        # every member raises the same verdict
        assert all(isinstance(e, tx.TornTransferError) for e in errors), errors
    else:
        assert errors == [None, None] and time.perf_counter() - t0 >= 0.3
        for got, want in zip(results[1].leaves, leaves):
            assert got.tobytes() == want.tobytes()


# -- kube actuation


def _kube_job(P, name):
    return P.TrainingJob.from_manifest({
        "apiVersion": "edl.tpu.dev/v1", "kind": "TrainingJob", "metadata": {"name": name},
        "spec": {"fault_tolerant": True, "trainer": {
            "min_instance": 1, "max_instance": 4, "slice_topology": P.topology,
            "resources": {"requests": {"cpu": "1", "memory": "1Gi"}}}}}).validate()


def _kube_conflict(P, point):
    out = []
    for budget, attempts in ((2, 5), (50, 3)):
        kube = P.kube()
        ck = P.chaos.ChaosKube(kube, _armed((0, point, budget), mod=P.chaos))
        cluster = P.Cluster(ck, conflict_retry=P.RetryPolicy(max_attempts=attempts,
                                                             base_delay=0.0))
        job = _kube_job(P, "jk")
        cluster.create_trainer_workload(job)
        try:
            done = bool(cluster.update_parallelism(job, 3))
        except P.ParallelismUpdateError as e:
            done = ("gave up after", e.attempts)
        out.append((done, kube.get_workload(job.trainer_job_name()).parallelism,
                    ck.injected_conflicts))
        _fired(ck.schedule, point)
    return out


def case_kube_conflict(point, pkgs):
    # under the retry budget the update lands; past it, it gives up
    assert _on_both(pkgs, _kube_conflict, point) == [(True, 3, 2), (("gave up after", 3), 1, 3)]


def _kube_hold(P, point):
    s = _armed((0, "kube.hold", "jh"), (1, "kube.release", "jh"), mod=P.chaos)
    ck = P.chaos.ChaosKube(P.kube(), s)
    cluster = P.Cluster(ck)
    ck.list_pods()  # the hold lands before the job exists
    job = _kube_job(P, "jh")
    cluster.create_trainer_workload(job)
    held = tuple(cluster.job_pods(job))
    s.advance(1)
    ck.list_pods()  # release + retry scheduling
    _fired(s, point)
    return [held, tuple(cluster.job_pods(job))]


def case_kube_hold(point, pkgs):
    # stuck Pending, then running
    assert _on_both(pkgs, _kube_hold, point) == [(1, 0, 1, 0), (1, 1, 0, 0)]


# -- the elastic loop and its stager


def case_prewarm_dropped(point):
    s = _armed((0, point))
    et, coord = _line_world(HostDRAMStore(chaos=s), target=2, trainers=4)
    with telemetry.scoped() as (_, rec):
        et.run(3)
        coord.set_prewarm(4)
        et.maybe_resize()  # the first poll sees the hint: dropped
        assert et.dropped_prewarm_hints == 1 and et.prewarm_hints == []
        assert "prewarm.hint" not in [e.kind for e in rec.events()]
        et.maybe_resize()  # the next poll delivers it again
        assert et.prewarm_hints == [4]
        et.run(6)
        coord.set_target_world(4)
        et.run(9)
    grow = et.resize_events[-1]
    assert grow.world_size == 4 and grow.graceful
    assert [r.step for r in et.history] == list(range(9))
    _fired(s, point)


def case_stager(point):
    model = get_model("fit_a_line")
    it = ShardedDataIterator(synthetic_dataset(model.synth_batch, 512, seed=0), 64, seed=0)
    s = _armed((2, point, 0.2))
    stager = BatchStager(it, depth=2, device="cpu", chaos=s)
    stager.rebind(0)
    t0 = time.perf_counter()
    for step in range(6):
        s.advance(step)
        got = stager.get(step, horizon=6)
        want = it.device_batch(step, "cpu")
        assert all(torch.equal(got[k], want[k]) for k in want), step
        with stager._cv:  # the worker stages what get() queued (and consults the schedule)
            assert stager._cv.wait_for(
                lambda: not stager._queue and stager._inflight is None, timeout=30)
    _fired(s, point)
    if point == "stage.batch.failed":
        assert stager.stats["failures"] == 1 and stager.stats["misses"] >= 1
    else:
        assert time.perf_counter() - t0 >= 0.2
    # through the loop: the stream equals a run without chaos, bit for bit
    s2 = FaultSchedule(0, [FaultEvent(3, point, 0.05)])
    et, _ = _line_world(HostDRAMStore(chaos=s2), target=1, trainers=1)
    ref, _ = _line_world(HostDRAMStore(), target=1, trainers=1)
    hist = et.run(10, on_step=lambda r: s2.advance(r.step))
    assert [(r.step, r.loss) for r in hist] == [(r.step, r.loss) for r in ref.run(10)]


def case_watchdog_trip(point):
    from edl_tpu_torch.consensus import CollectiveTimeout, CollectiveWatchdog

    s = _armed((0, point))
    with telemetry.scoped() as (reg, rec):
        wd = CollectiveWatchdog(timeout=0.0, chaos=s, registry=reg, recorder=rec)
        called = []
        t0 = time.perf_counter()
        with pytest.raises(CollectiveTimeout, match="chaos"):
            wd.fetch(lambda: called.append(1))
        assert time.perf_counter() - t0 < 1.0 and not called  # no wait, no fetch
        assert wd.fetch(lambda: 7) == 7  # one-shot
        assert wd.trips == 1
        assert reg.counter("edl_consensus_watchdog_trips_total").value() == 1
        assert "consensus.watchdog" in [e.kind for e in rec.events()]
    _fired(s, point)
    # the elastic loop hands its store's schedule to its watchdog
    s2 = _armed((0, point))
    et, _ = _line_world(HostDRAMStore(chaos=s2), target=1, trainers=1)
    with pytest.raises(CollectiveTimeout):
        et.run(3)
    _fired(s2, point)


# -- serving: engine, batchers, replica, prefix cache, migration, router


def _until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline
        time.sleep(0.01)


def _swap_torn(P, point):
    s = P.chaos.FaultSchedule(0, [P.chaos.FaultEvent(1, point)])
    store = P.Store()
    store.save_async(P.lm_state(0), generation=0)
    store.wait()
    with P.tel.scoped() as (reg, rec):
        eng = P.lm_engine(store=store, chaos=s)
        seen = [(eng.load(), eng.weights_step)]
        store.save_async(P.lm_state(3), generation=1)
        store.wait()
        s.advance(1)
        seen.append((eng.refresh(), eng.weights_step, list(store.steps())))
        seen.append((eng.refresh(), eng.weights_step))
        rejected = reg.counter("edl_serve_swap_rejected_total").value()
        store.save_async(P.lm_state(5), generation=2)
        store.wait()
        seen.append((eng.refresh(), eng.weights_step))
        kinds = [e.kind for e in rec.events() if e.kind.startswith("serve.swap")]
    _fired(s, point)
    return {"seen": seen, "rejected": rejected, "kinds": kinds}


def case_swap_torn(point, pkgs):
    # the rotted candidate is rejected (and dropped), once; the good one
    # then swaps in
    assert _on_both(pkgs, _swap_torn, point) == {
        "seen": [(True, 0), (False, 0, [0]), (False, 0), (True, 5)], "rejected": 1,
        "kinds": ["serve.swap", "serve.swap.rejected", "serve.swap"]}


def _queue_full(P, point):
    x = {"x": np.zeros((1, 13), np.float32)}
    with P.tel.scoped() as (reg, _):
        for submit in (
            lambda s: P.serving.ContinuousBatcher(P.line_engine(s)).submit(x),
            lambda s: P.serving.TokenContinuousBatcher(
                P.lm_engine(chaos=s), refresh=False).submit_generate(
                    {"tokens": PROMPT}, max_new_tokens=2),
        ):
            s = _armed((0, point), mod=P.chaos)
            with pytest.raises(P.serving.QueueFullError):
                submit(s)  # forced, with an empty queue
            _fired(s, point)
        return reg.counter("edl_serve_requests_total").value(status="rejected")


def case_queue_full(point, pkgs):
    assert _on_both(pkgs, _queue_full, point) == 2


def _request_slow(P, point):
    with P.tel.scoped():
        s = _armed((0, point, 0.3), mod=P.chaos)
        b = P.serving.ContinuousBatcher(P.line_engine(s)).start()
        try:
            t0 = time.perf_counter()
            b.submit({"x": np.zeros((1, 13), np.float32)}).result(timeout=30)
            slow = [time.perf_counter() - t0 >= 0.3]
        finally:
            b.stop()
        _fired(s, point)
        s = _armed((0, point, 0.3), mod=P.chaos)
        t0 = time.perf_counter()
        tokens, _ = _gen(P, P.lm_engine(chaos=s), n=4)
        slow.append(time.perf_counter() - t0 >= 0.3)
        _fired(s, point)
    return {"slow": slow, "tokens": tokens}


def case_request_slow(point, pkgs, lm_ref):
    assert _on_both(pkgs, _request_slow, point) == {"slow": [True, True], "tokens": lm_ref[:4]}


def _serve_kinds(rec):
    """The journal's serving and chaos events, in order, each kind once
    where it repeats back to back."""
    out = []
    for e in rec.events():
        if (e.kind.startswith("serve.") or e.kind == "chaos") and out[-1:] != [e.kind]:
            out.append(e.kind)
    return out


def _dispatch_wedged(P, point):
    s = P.chaos.FaultSchedule(0, [P.chaos.FaultEvent(1, point)])
    with P.tel.scoped() as (reg, rec):
        b = P.serving.TokenContinuousBatcher(P.lm_engine(chaos=s), refresh=False).start()
        try:
            t = b.submit_generate({"tokens": PROMPT}, max_new_tokens=12, deadline_s=60.0,
                                  on_event=lambda ev: ev.get("i") == 3 and s.advance(1))
            tokens, meta = t.result(timeout=60)
        finally:
            b.stop()
        wedged = reg.counter("edl_serve_dispatch_wedged_total").value()
        kinds = _serve_kinds(rec)
    _fired(s, point)
    return {"tokens": tokens, "restarts": meta["restarts"], "wedged": wedged, "kinds": kinds}


def case_dispatch_wedged(point, pkgs, lm_ref):
    got = _on_both(pkgs, _dispatch_wedged, point)
    assert got["restarts"] == 1 and got["tokens"] == lm_ref  # re-prefilled, pure
    assert got["wedged"] == 1 and "serve.watchdog" in got["kinds"]


def _replica(P, eng, coord=None, rid="r0", chaos=None):
    return P.serving.ServingReplica(
        eng, P.serving.ContinuousBatcher(eng), coordinator=coord, replica_id=rid,
        heartbeat_interval=0.05, telemetry_interval=0,
        gen_batcher=P.serving.TokenContinuousBatcher(eng, refresh=False), chaos=chaos).start()


def _drain_slow(P, point):
    s = _armed((0, point, 0.3), mod=P.chaos)
    with P.tel.scoped():
        rep = _replica(P, P.lm_engine(chaos=s))
        try:
            t = rep.gen_batcher.submit_generate({"tokens": PROMPT}, max_new_tokens=6)
            t0 = time.perf_counter()
            r = rep.drain(budget_s=30.0)
            slow = time.perf_counter() - t0 >= 0.3
            tokens = t.result(timeout=5)[0]
        finally:
            rep.stop()
    _fired(s, point)
    return {"drained": r["drained"], "slow": slow, "tokens": tokens}


def case_drain_slow(point, pkgs, lm_ref):
    assert _on_both(pkgs, _drain_slow, point) == {"drained": True, "slow": True,
                                                  "tokens": lm_ref[:6]}


def _replica_level(P, point):
    coord = P.Coordinator(target_world=4, max_world=4, heartbeat_timeout=1e9)
    s = P.chaos.FaultSchedule(0, [P.chaos.FaultEvent(1, point, 0.5)])
    with P.tel.scoped():
        eng = P.lm_engine()
        rep = _replica(P, eng, coord, rid="r0", chaos=s)
        seen = [coord.members()]
        try:
            if point == "serve.replica.die":
                held = threading.Event()

                def hold(ev):  # the stream stays mid-flight until the death
                    if ev.get("i") == 3:
                        held.set()
                        _until(lambda: rep._dead)

                t = rep.gen_batcher.submit_generate({"tokens": PROMPT}, max_new_tokens=12,
                                                    on_event=hold)
                assert held.wait(30)
                s.advance(1)
                _until(lambda: rep._dead)
                with pytest.raises(Exception) as ei:
                    t.result(timeout=10)
                seen += [type(ei.value).__name__, coord.members()]
            else:
                coord.deregister("r0")  # the coordinator lost it ...
                s.advance(1)
                _until(lambda: [e for e in s.fired() if e.point == point])
                time.sleep(0.25)
                # ... hears nothing in the blackout, while serving goes on
                seen += [coord.members(), len(_gen(P, eng, n=3)[0])]
                _until(lambda: coord.members() == ["r0"])  # the rejoin after it
        finally:
            if not rep._dead:
                rep.stop()
    _fired(s, point)
    return seen


def case_replica_level(point, pkgs):
    got = _on_both(pkgs, _replica_level, point)
    if point == "serve.replica.die":
        # the stream fails; a dead pod never deregisters
        assert got == [["r0"], "RuntimeError", ["r0"]], got
    else:
        assert got == [["r0"], [], 3]


def _prefix(P, point):
    s = P.chaos.FaultSchedule(0, [P.chaos.FaultEvent(1, point, 99)])
    with P.tel.scoped() as (_, rec):
        b = P.serving.TokenContinuousBatcher(P.lm_engine(chaos=s), refresh=False).start()
        try:
            first = b.submit_generate({"tokens": PROMPT}, max_new_tokens=12).result(timeout=60)
            s.advance(1)
            if point == "serve.prefix.evicted":
                deadline = time.monotonic() + 10  # fires at the next token boundary
                while s.pending():
                    assert time.monotonic() < deadline
                    b.submit_generate({"tokens": [7]}, max_new_tokens=1).result(timeout=60)
            again = b.submit_generate({"tokens": PROMPT}, max_new_tokens=12).result(timeout=60)
        finally:
            b.stop()
        outcomes = [e.data["outcome"] for e in rec.events() if e.kind == "serve.prefix"]
    _fired(s, point)
    return {"tokens": [first[0], again[0]],
            "reused": [first[1]["reused_blocks"], again[1]["reused_blocks"]],
            "outcomes": outcomes}


def case_prefix(point, pkgs, lm_ref):
    assert _on_both(pkgs, _prefix, point) == {
        "tokens": [lm_ref, lm_ref], "reused": [0, 0],
        "outcomes": ["chaos_evicted" if point.endswith("evicted") else "hash_skew_rejected"]}


def _migrate(P, point):
    s = _armed((0, point), mod=P.chaos)
    kill = point.endswith("kill")
    with P.tel.scoped():
        src, dst = P.lm_engine(), P.lm_engine()
        sb = P.serving.TokenContinuousBatcher(src, refresh=False).start()
        db = P.serving.TokenContinuousBatcher(dst, refresh=False).start()
        recv = P.serving.MigrationReceiver(dst, db, chaos=None if kill else s).start()
        try:
            at = threading.Event()

            def on_event(ev):
                if ev.get("i") == 3 and not at.is_set():  # (a re-prefill streams i 3 again)
                    at.set()
                    end = time.monotonic() + 20
                    while not sb._freeze_req.is_set() and time.monotonic() < end:
                        time.sleep(0.001)

            t = sb.submit_generate({"tokens": PROMPT}, max_new_tokens=12, deadline_s=60.0,
                                   on_event=on_event)
            assert at.wait(30)
            summary = P.serving.migrate_out(src, sb, f"tcp://127.0.0.1:{recv.port}",
                                            chaos=s if kill else None)
            tokens, _ = t.result(timeout=60)
        finally:
            _stop_all([recv, sb, db])
    _fired(s, point)
    return {"tokens": tokens, "src_used": src.pool.used_blocks,
            "summary": {k: summary[k] for k in ("attempted", "migrated", "cold", "fallback",
                                                "failed")}}


def case_migrate(point, pkgs, lm_ref):
    """A drain with migration under one migration fault: the sequence
    falls back to a cold re-prefill on the survivor (or, for a swap
    between grant and adoption, re-prefills there) and finishes with
    the unmigrated run's tokens."""
    got = _on_both(pkgs, _migrate, point)
    assert got["tokens"] == lm_ref and got["src_used"] == 0
    if point.endswith("swap"):
        assert got["summary"]["migrated"] == 1  # moved, then re-prefilled there
    else:
        assert got["summary"]["migrated"] == 0 and got["summary"]["fallback"] == 1, got


@pytest.fixture(scope="module")
def lm_fleets(pkgs):
    """Each package's two tiny replicas registered with its coordinator
    (the router cases share them; each case builds its own router)."""
    fleets, reps = {}, []
    try:
        for name, P in pkgs.items():
            coord = P.Coordinator(target_world=4, max_world=4, heartbeat_timeout=1e9)
            for rid in ("ra", "rb"):
                eng = P.lm_engine()
                server = P.serving.ServingServer(P.serving.ContinuousBatcher(eng),
                                                 host="127.0.0.1", port=0)
                reps.append(P.serving.ServingReplica(
                    eng, server=server, coordinator=coord, replica_id=rid,
                    address=f"127.0.0.1:{server.port}", heartbeat_interval=0.05,
                    telemetry_interval=0, gen_batcher=P.serving.TokenContinuousBatcher(eng),
                ).start())
            fleets[name] = coord
        yield fleets
    finally:
        _stop_all(reps)


def _router(P, point, coord):
    with P.tel.scoped() as (reg, _):
        s = _armed((0, point), mod=P.chaos)
        router = P.serving.RequestRouter(coord, chaos=s, eject_after=1)
        router.sync()
        req = {"inputs": {"tokens": PROMPT}, "max_new_tokens": 12}
        if point == "route.probe.fail":
            victim = router._order(generate=True)[0]
            router._on_attempt(victim, P.REFUSED, ConnectionError("x"))  # ejected
            # the forced failure keeps it out; a real probe re-admits
            got = [router.probe(victim.replica_id), router.probe(victim.replica_id)]
        elif point == "route.backend.refused":
            got = {"tokens": router.generate(req)["tokens"],
                   "retries": reg.counter("edl_route_retries_total").value(reason=P.REFUSED)}
        else:
            lines = []
            router.generate_stream(dict(req, stream=True), lines.append)
            got = {"tokens": [ev["token"] for ev in lines if "token" in ev],
                   "i": [ev["i"] for ev in lines if "token" in ev],
                   "done": lines[-1]["done"], "redriven": lines[-1]["redriven"],
                   "restarts": len([ev for ev in lines if ev.get("restart")])}
        _fired(s, point)
    return got


def case_router(point, pkgs, lm_fleets, lm_ref):
    got = _on_both(pkgs, lambda P, p: _router(P, p, lm_fleets[P.name]), point)
    if point == "route.probe.fail":
        assert got == [False, True]
    elif point == "route.backend.refused":
        assert got == {"tokens": lm_ref, "retries": 1}
    else:
        assert got == {"tokens": lm_ref, "i": list(range(12)), "done": True, "redriven": 1,
                       "restarts": 0}


#: injection point -> the case that fires it
POINT_CASES = {
    "coord.heartbeat.drop": case_heartbeat,
    "coord.heartbeat.delay": case_heartbeat,
    "coord.restart": case_coord_restart,
    "member.kill": case_monkey_verbs,
    "member.die_with_state": case_monkey_verbs,
    "member.restart": case_monkey_verbs,
    "scale.target": case_monkey_verbs,
    "transport.refuse": case_transport,
    "transport.timeout": case_transport,
    "transport.slow": case_transport,
    "transport.torn": case_transport,
    "checkpoint.save_thread": case_save_thread,
    "checkpoint.corrupt": case_checkpoint_corrupt,
    "checkpoint.spill": case_spill,
    "flush.spill.slow": case_flush_spill_slow,
    "transfer.chunk.torn": case_transfer,
    "transfer.chunk.slow": case_transfer,
    "kube.conflict": case_kube_conflict,
    "kube.hold": case_kube_hold,
    "kube.release": case_kube_hold,
    "prewarm.hint.dropped": case_prewarm_dropped,
    "stage.batch.slow": case_stager,
    "stage.batch.failed": case_stager,
    # a retarget quiesces at an agreed stop only on a live world of
    # several processes: fired through EDL_CHAOS_SPEC by
    "consensus.vote.delayed": "test_edl_chaos_spec_in_a_gloo_world",
    "consensus.watchdog.trip": case_watchdog_trip,
    "serve.swap.torn": case_swap_torn,
    "serve.request.slow": case_request_slow,
    "serve.queue.full": case_queue_full,
    "serve.replica.die": case_replica_level,
    "serve.dispatch.wedged": case_dispatch_wedged,
    "serve.drain.slow": case_drain_slow,
    "serve.coord.unreachable": case_replica_level,
    "serve.migrate.kill": case_migrate,
    "serve.migrate.torn": case_migrate,
    "serve.migrate.exhausted": case_migrate,
    "serve.migrate.swap": case_migrate,
    "serve.prefix.evicted": case_prefix,
    "serve.prefix.hash.skew": case_prefix,
    "route.backend.refused": case_router,
    "route.probe.fail": case_router,
    "route.stream.cut": case_router,
}


@pytest.mark.parametrize("point", [p for p in KNOWN_POINTS if callable(POINT_CASES.get(p))])
def test_the_point_fires_and_the_port_recovers(point, request):
    fn = POINT_CASES[point]
    names = fn.__code__.co_varnames[1:fn.__code__.co_argcount]
    fn(point, *[request.getfixturevalue(n) for n in names])


# ---- (d) EDL_CHAOS_SPEC in a gloo world of two launcher pods ----------------------

WAIT_S = 60
#: ``python -m edl_tpu_torch.launcher`` with the process groups' timeout
#: cut from 30 s to 4 s: the tripped member's peer is blocked in its
#: next step's all-reduce until gloo gives up on it
_POD = r"""
import datetime, os, runpy, sys, time
import torch.distributed as dist
import edl_tpu_torch.launcher
# started beside its peer: join only once the test says so
while not os.path.exists(os.environ["CHAOS_TEST_GO"]):
    time.sleep(0.01)
_init = dist.init_process_group
def init_process_group(*a, **k):
    k["timeout"] = datetime.timedelta(seconds=4)
    return _init(*a, **k)
dist.init_process_group = init_process_group
sys.argv[0] = "edl_tpu_torch.launcher"
runpy.run_module("edl_tpu_torch.launcher", run_name="__main__", alter_sys=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _lines(path):
    if not path.exists():
        return []
    out = []
    for ln in path.read_text().splitlines():
        try:
            out.append(json.loads(ln))
        except ValueError:
            pass  # a line still being written
    return out


def _steps(path):
    return [r for r in _lines(path) if "step" in r and "loss" in r]


def _kinds(path, kind):
    return [e for e in _lines(path) if e.get("kind") == kind]


def _wait_for(what, pred, procs):
    deadline = time.monotonic() + WAIT_S
    while not pred():
        for p in procs:
            assert p.poll() is None, f"{what}: a pod exited with {p.returncode}"
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def test_edl_chaos_spec_in_a_gloo_world(tmp_path):
    """Two ``python -m edl_tpu_torch.launcher`` pods (tiny LM on the CPU,
    gloo) behind a coordinator hosted here; the joiner ``p2`` carries
    ``EDL_CHAOS_SPEC`` with ``consensus.watchdog.trip`` and
    ``consensus.vote.delayed`` (1 s).  At world 2 the joiner's guarded
    harvest trips: it buries the world (``world.broken``), its peer's
    collective fails and buries it too; the coordinator drops and
    re-admits ``p2`` (the reaper's move), the world re-forms at 2.  Then
    the target goes to 1: ``p2``'s plan poll is suppressed, yet both
    members journal one agreed stop step and leave the old world at it.
    ``p1`` never loses a step."""
    coord = LocalCoordinator(target_world=1, max_world=2, heartbeat_timeout=60.0,
                             legal_sizes=[1, 2])
    server = CoordinatorServer(coord, host="127.0.0.1", port=0).start()
    spec = {"seed": 0, "events": [
        {"step": 0, "point": "consensus.watchdog.trip"},
        {"step": 0, "point": "consensus.vote.delayed", "arg": 1.0}]}
    hist = {n: tmp_path / f"{n}.jsonl" for n in ("p1", "p2")}
    journal = {n: tmp_path / f"{n}.events.jsonl" for n in ("p1", "p2")}
    addr = {n: f"127.0.0.1:{_free_port()}" for n in ("p1", "p2")}
    procs = {}

    def spawn(name, extra=()):
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   EDL_COORDINATOR_ADDR=f"127.0.0.1:{server.port}", EDL_POD_NAME=name,
                   EDL_POD_ADDRESS=addr[name], EDL_HISTORY_FILE=str(hist[name]),
                   EDL_FLIGHT_RECORDER_FILE=str(journal[name]), EDL_CHECKPOINT_INTERVAL="4",
                   EDL_TELEMETRY_INTERVAL="0", CHAOS_TEST_GO=str(tmp_path / f"{name}.go"),
                   **dict(extra))
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", _POD, "--entrypoint", "transformer_lm",
             "--steps", "100000", "--device", "cpu", "--tiny"],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    try:
        spawn("p1")
        spawn("p2", {"EDL_CHAOS_SPEC": json.dumps(spec)})
        (tmp_path / "p1.go").touch()
        _wait_for("p1 registered", lambda: "p1" in coord.members(), procs.values())
        (tmp_path / "p2.go").touch()  # rank 1: it registers second
        _wait_for("p2 registered", lambda: "p2" in coord.members(), procs.values())
        coord.set_target_world(2)
        _wait_for("the trip burying both members' world",
                  lambda: _kinds(journal["p1"], "world.broken")
                  and _kinds(journal["p2"], "world.broken"), procs.values())
        coord.deregister("p2")  # the reaper: drop the tripped member ...
        coord.register("p2", address=addr["p2"])  # ... and re-admit it
        gen = coord.plan().generation
        _wait_for("the world of two re-formed",
                  lambda: all(any(r["world_size"] == 2 and r["generation"] >= gen
                                  for r in _steps(hist[n])) for n in ("p1", "p2")),
                  procs.values())
        coord.set_target_world(1)
        down = coord.plan().generation
        _wait_for("p1 alone again", lambda: any(
            r["world_size"] == 1 and r["generation"] >= down for r in _steps(hist["p1"])),
            procs.values())
        for name in ("p2", "p1"):
            procs[name].terminate()
            procs[name].wait(timeout=WAIT_S)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait(timeout=WAIT_S)
        server.stop()
    chaos = [(e["data"]["point"], e["data"]["scheduled_step"]) for e in _kinds(journal["p2"],
                                                                                "chaos")]
    assert chaos == [("consensus.watchdog.trip", 0), ("consensus.vote.delayed", 0)], chaos
    assert [e["data"]["what"] for e in _kinds(journal["p2"], "consensus.watchdog")] == [
        "step metrics"]
    # one agreed stop step: both journal it, and both old-world streams
    # end just before it
    (s1,), (s2,) = (_kinds(journal[n], "consensus.stop")[-1:] for n in ("p1", "p2"))
    assert s1["data"] == s2["data"], (s1, s2)
    stop = s1["data"]["stop_step"]
    at2 = {n: [r["step"] for r in _steps(hist[n]) if r["world_size"] == 2
               and r["generation"] >= gen] for n in ("p1", "p2")}
    assert max(at2["p1"]) == max(at2["p2"]) == stop - 1, (at2, stop)
    # p1 lost no step: every step up to its last, the world-1 ones after
    # the stop among them
    h1 = _steps(hist["p1"])
    done = sorted({r["step"] for r in h1})
    assert done == list(range(done[-1] + 1)) and done[-1] >= stop
    assert all(np.isfinite(r["loss"]) for r in h1)


# ---- (e) the serving soak of chip_smoke.py's phase 15 at tiny width, twice -------

#: the soak's sizes cut to the tiny LM's 64-token context
TINY_SERVE = {"prefix_blocks": 2, "tails": (4, 9), "new": 8, "prompt": 24,
              "stream_new": 36, "at": 6, "trainer_steps": (1, 2, 3)}


def test_the_serving_soak_is_bit_reproducible(monkeypatch):
    """``chip_smoke._chaos_serving_soak`` on the CPU with the tiny LM
    (float32), twice with one seed: the flight recorder's ``digest()``
    and the soak's log (every served stream's tokens, held to the full
    recompute, and each fault's outcome) are bit-identical.  Each decode
    step is slowed by 10 ms, so the drain and the kill land mid-stream."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    from edl_tpu_torch.serving import DecodeEngine

    real = DecodeEngine.decode_step

    def slow(self, *a, **k):
        time.sleep(0.01)
        return real(self, *a, **k)

    monkeypatch.setattr(DecodeEngine, "decode_step", slow)
    runs = [chip_smoke._chaos_serving_soak(
        device="cpu", model_kwargs={"tiny": True, "dtype": torch.float32}, sizes=TINY_SERVE)
        for _ in range(2)]
    (out1, log1, digest1), (_, log2, digest2) = runs
    assert out1["pending"] == [] and out1["swap"]["steps"] == [1, 2, 3]
    assert log1 == log2
    assert digest1 == digest2
