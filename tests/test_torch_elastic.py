"""The port's elastic runtime against the JAX package's, on the CPU.

The tiny LM of ``tests/test_torch_train.py`` (V 256, D 64, FF 256, H 4,
2 layers, L 64, float32 compute), global batch 8, Adam at lr 1e-3.

- **Against the JAX ``ElasticTrainer``**, in one process: 12 steps with
  a graceful generation bump at step 6 (a standby ``tr1`` registers
  beside ``tr0`` at target world 1, then ``tr0`` leaves) and
  ``inject_failure`` at step 8.  Both restore the newest checkpoint —
  the bump's step-6 flush, not the step-5 interval save — and replay
  steps 6 and 7.  The loss streams agree at 1e-4 (the tolerance of
  ``test_trainer_matches_jax_trainer_with_optax_adam``) and the resize
  events report the same ``graceful``, ``restored_step`` and
  ``replayed_steps``.
- **The port's own invariants, bit for bit** (``==`` on the float
  stream, by step number), against a fixed-world run with the pipeline
  at depth 2: depth 0; the bump and the kill/replay at depth 2 and 0;
  a cold start from the spill dir as it stood at the kill.
- **1 -> 2 -> 1 on gloo**: two worker processes, each an
  ``ElasticTrainer`` with an ``HTTPCoordinator`` and
  ``launcher.make_world_builder``, behind a ``CoordinatorServer`` hosted
  here.  The target goes 1 -> 2 at step 4 (the joiner pulls its state
  through ``stream_restore``) and 2 -> 1 at step 8 (both members leave
  at the ``StepBus``-agreed stop step).  The stream equals a fixed
  world-1 run's at 1e-5 (``test_dp2_on_gloo_equals_dp1``'s tolerance)
  and the JAX ``ElasticTrainer``'s 1 -> 2 -> 1 run on virtual CPU
  devices at 1e-4; no formation finds a process group left.
- **The journal**: the bump-and-replay run journals the JAX run's
  (step, generation, kind) sequence of ``resize``, ``step.first`` and
  ``checkpoint.save``; in the gloo run every member journals the
  ``StepBus`` agreement (vote, stop, quiesce) the JAX bus defines,
  which the JAX in-process world never journals (it has no world
  builder, so its retargets do not quiesce).
- ``BatchStager``, the coordinator, its HTTP service and the watchdog.
"""

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu import telemetry as jax_telemetry
from edl_tpu.models import get_model as jax_get_model
from edl_tpu.models.transformer_lm import TransformerLM as FlaxLM
from edl_tpu.ops.losses import best_vocab_xent as jax_best_vocab_xent
from edl_tpu.runtime import ShardedDataIterator as JaxIterator
from edl_tpu.runtime.coordinator import LocalCoordinator as JaxCoordinator
from edl_tpu.runtime.data import synthetic_dataset as jax_synthetic_dataset
from edl_tpu.runtime.elastic import ElasticTrainer as JaxElasticTrainer
from edl_tpu_torch import telemetry
from edl_tpu_torch.checkpoint import HostDRAMStore
from edl_tpu_torch.consensus import CollectiveTimeout, CollectiveWatchdog
from edl_tpu_torch.convert import params_from_flax
from edl_tpu_torch.models import get_model
from edl_tpu_torch.runtime import BatchStager, ElasticTrainer, LocalCoordinator, ShardedDataIterator
from edl_tpu_torch.runtime.coord_service import CoordinatorServer, HTTPCoordinator

ROOT = Path(__file__).resolve().parents[1]
V, D, FF, H, LAYERS, L = 256, 64, 256, 4, 2, 64
LR = 1e-3
BATCH = 8
STEPS = 12
JAX_RTOL = 1e-4
DP_RTOL = 1e-5


def _jax_model():
    """The registered JAX tiny LM in float32 compute (its own init, the
    reference's ``loss_fn`` body)."""
    base = jax_get_model("transformer_lm", tiny=True)
    module = FlaxLM(V, D, FF, H, LAYERS, L, dtype=jnp.float32)

    def loss_fn(params, batch, rng):
        tokens = batch["tokens"]
        labels = tokens[:, 1:]
        x = module.apply({"params": params}, tokens[:, :-1], return_features=True)
        loss, _ = jax_best_vocab_xent(x, params["embed"]["embedding"], labels, labels != 0)
        return loss, {"loss": loss}

    return dataclasses.replace(base, loss_fn=loss_fn)


@pytest.fixture(scope="module")
def dataset():
    return jax_synthetic_dataset(_jax_model().synth_batch, 64, seed=0)


@pytest.fixture(scope="module")
def port_model():
    """The port's tiny LM (float32 compute) starting from the JAX
    ElasticTrainer's initial weights (the JAX model's init at seed 0),
    converted by ``convert.py``."""
    init = jax.tree_util.tree_map(np.asarray, _jax_model().init_params(jax.random.key(0)))
    sd = params_from_flax(init)
    base = get_model("transformer_lm", tiny=True, dtype=torch.float32)
    return dataclasses.replace(base, init_params=lambda g: {k: v.clone() for k, v in sd.items()})


def _stream(history):
    return [(r.step, r.loss) for r in history]


def _by_step(history):
    return {r.step: r.loss for r in history}


def _port_et(model, ds, depth=2, interval=5, spill=None, target=1):
    coord = LocalCoordinator(target_world=target, max_world=2)
    coord.register("tr0")
    et = ElasticTrainer(
        model,
        ShardedDataIterator(ds, BATCH, seed=0),
        coord,
        store=HostDRAMStore(spill_dir=spill),
        lr=LR,
        device="cpu",
        checkpoint_interval=interval,
    )
    et.pipeline_depth = depth
    return et, coord


def _bump_and_kill(et, coord, bump_at, kill_at, steps=STEPS, on_kill=None):
    """Graceful generation bump at ``bump_at`` (the active member swaps
    at world 1), device state lost at ``kill_at``, run to ``steps``."""
    et.run(bump_at)
    coord.register("tr1")
    coord.deregister("tr0")
    et.run(kill_at)
    et.store.wait()
    if on_kill is not None:
        on_kill(et)
    et.inject_failure()
    et.run(steps)
    return et


def _events(et):
    return [(e.graceful, e.restored_step, e.replayed_steps) for e in et.resize_events]


# ---- against the JAX ElasticTrainer ------------------------------------------


#: the lifecycle kinds whose (step, generation, kind) sequence both
#: packages journal alike on the bump-and-replay run
LIFECYCLE = ("resize", "step.first", "checkpoint.save")


def _journal(events, kinds):
    return [(e.step, e.generation, e.kind) for e in events if e.kind in kinds]


@pytest.fixture(scope="module")
def jax_bump_kill_run(dataset):
    with jax_telemetry.scoped() as (_, rec):
        coord = JaxCoordinator(target_world=1, max_world=2)
        coord.register("tr0")
        et = JaxElasticTrainer(
            _jax_model(), optax.adam(LR), JaxIterator(dataset, BATCH, seed=0), coord,
            devices=jax.devices("cpu")[:2], checkpoint_interval=5, seed=0,
        )
        _bump_and_kill(et, coord, bump_at=6, kill_at=8)
        et.store.wait()
        return _stream(et.history), _events(et), rec.events()


@pytest.fixture(scope="module")
def jax_bump_kill(jax_bump_kill_run):
    return jax_bump_kill_run[:2]


def test_elastic_matches_jax_elastic_trainer_with_bump_and_replay(port_model, dataset, jax_bump_kill):
    want_stream, want_events = jax_bump_kill
    et, coord = _port_et(port_model, dataset, depth=2, interval=5)
    _bump_and_kill(et, coord, bump_at=6, kill_at=8)
    got = _stream(et.history)
    assert [s for s, _ in got] == [s for s, _ in want_stream] == list(range(8)) + list(range(6, 12))
    np.testing.assert_allclose([x for _, x in got], [x for _, x in want_stream], rtol=JAX_RTOL)
    assert _events(et) == want_events == [(False, 0, 0), (True, 6, 0), (False, 6, 2)]
    assert got[-1][1] < got[0][1]


def test_bump_and_replay_journal_the_jax_lifecycle(port_model, dataset, jax_bump_kill_run):
    """The same (step, generation, kind) sequence of resizes, first
    steps and checkpoint saves as the JAX run's journal, and the same
    deterministic resize payloads."""
    want = jax_bump_kill_run[2]
    with telemetry.scoped() as (_, rec):
        et, coord = _port_et(port_model, dataset, depth=2, interval=5)
        _bump_and_kill(et, coord, bump_at=6, kill_at=8)
        et.store.wait()
        got = rec.events()
    assert _journal(got, LIFECYCLE) == _journal(want, LIFECYCLE)
    assert [e.kind for e in got if e.kind in LIFECYCLE].count("step.first") == 3
    resize = [{k: e.data[k] for k in ("world_size", "restored_step", "replayed_steps",
                                       "graceful", "stop_step")}
              for e in got if e.kind == "resize"]
    assert resize == [{k: e.data[k] for k in resize[0]} for e in want if e.kind == "resize"]


# ---- the port's own invariants, bit for bit ------------------------------------


@pytest.fixture(scope="module")
def fixed_world(port_model, dataset):
    """12 steps at world 1, depth 2, checkpoint interval 4: the stream
    every other run is held to."""
    et, _ = _port_et(port_model, dataset, depth=2, interval=4)
    return _by_step(et.run(STEPS))


def _run_variant(variant, model, ds, tmp_path):
    if variant == "depth0":
        et, _ = _port_et(model, ds, depth=0, interval=4)
        et.run(STEPS)
        return et
    if variant in ("bump_replay_depth2", "bump_replay_depth0"):
        et, coord = _port_et(model, ds, depth=int(variant[-1]), interval=4, spill=str(tmp_path / "spill"))
        _bump_and_kill(et, coord, bump_at=6, kill_at=9)
        assert _events(et) == [(False, 0, 0), (True, 6, 0), (False, 8, 1)]
        assert [e.compiles for e in et.resize_events] == [0, 0, 0]
        return et
    # cold start: a new process-like trainer over the spill dir as it
    # stood when the device state was lost (steps 6 and 8 spilled)
    kept = tmp_path / "at_kill"
    et, coord = _port_et(model, ds, depth=2, interval=4, spill=str(tmp_path / "spill"))
    _bump_and_kill(et, coord, 6, 9, on_kill=lambda e: shutil.copytree(e.store.spill_dir, kept))
    cold, _ = _port_et(model, ds, depth=2, interval=4, spill=str(kept))
    cold.run(STEPS)
    assert _events(cold) == [(False, 8, 0)] and cold.resize_events[0].restore_source == "local"
    assert [r.step for r in cold.history] == list(range(8, STEPS))
    return cold


@pytest.mark.parametrize(
    "variant", ["depth0", "bump_replay_depth2", "bump_replay_depth0", "cold_start"]
)
def test_stream_bit_identical_to_fixed_world(port_model, dataset, fixed_world, variant, tmp_path):
    et = _run_variant(variant, port_model, dataset, tmp_path)
    assert [(r.step, r.loss) for r in et.history] == [(r.step, fixed_world[r.step]) for r in et.history]
    if variant == "depth0":
        assert et.pipeline_stats["max_in_flight"] == 0


# ---- 1 -> 2 -> 1 on gloo -----------------------------------------------------------

_WORKER = r"""
import json, os, sys, threading, time
import torch, torch.distributed as dist
from edl_tpu_torch.checkpoint import HostDRAMStore
from edl_tpu_torch.launcher import make_world_builder
from edl_tpu_torch.telemetry import get_recorder
from edl_tpu_torch.models import get_model
from edl_tpu_torch.runtime import ElasticTrainer, ShardedDataIterator
from edl_tpu_torch.runtime.coord_service import HTTPCoordinator
import dataclasses

name, addr, base, data, init, out, role = sys.argv[1:8]
torch.set_num_threads(1)  # a tiny model; keep the suite's cores for the others
ds = {"tokens": torch.load(data).numpy()}
sd = torch.load(init)
model = dataclasses.replace(get_model("transformer_lm", tiny=True, dtype=torch.float32),
                            init_params=lambda g: {k: v.clone() for k, v in sd.items()})
coord = HTTPCoordinator(addr)
forms = []
et = ElasticTrainer(model, ShardedDataIterator(ds, %d, seed=0), coord, store=HostDRAMStore(),
                    lr=%r, device="cpu", checkpoint_interval=4,
                    world_builder=make_world_builder(name, "cpu", formation_log=forms.append))
et.heartbeat_ids = [name]
et.register_address = f"127.0.0.1:{base}"
coord.register(name, address=et.register_address)

def dump():
    with open(out, "w") as f:
        json.dump({"history": [[r.step, r.loss, r.world_size] for r in et.history],
                   "events": [[e.world_size, e.restored_step, e.restore_source, e.stop_step,
                               (e.transfer or {}).get("bytes_received", 0)]
                              for e in et.resize_events],
                   "formations": forms, "initialized": dist.is_initialized(),
                   "journal": [e.to_dict() for e in get_recorder().events()]}, f)

if role == "lead":
    et.run(4)
    while len(coord.members()) < 2:
        time.sleep(0.02)
    coord.set_target_world(2)
    et.run(8)
    coord.set_target_world(1)
    et.run(%d)
    et.stop_heartbeat()
    et.world_builder.teardown()
    dump()
    coord.report_complete(et.history[-1].step)
else:
    def finish():
        while not coord.completed():
            time.sleep(0.05)
        dump()
        os._exit(0)
    threading.Thread(target=finish, daemon=True).start()
    et.run(%d)
""" % (BATCH, LR, STEPS, STEPS)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_1_2_1(port_model, dataset, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo121")
    torch.save(torch.from_numpy(dataset["tokens"]), tmp / "tokens.pt")
    torch.save(port_model.init_params(None), tmp / "init.pt")
    coord = LocalCoordinator(target_world=1, max_world=2, heartbeat_timeout=60.0, legal_sizes=[1, 2])
    server = CoordinatorServer(coord, host="127.0.0.1", port=0).start()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = []
    try:
        for name, role in (("w1", "lead"), ("w2", "join")):
            args = [name, f"127.0.0.1:{server.port}", str(_free_port()), str(tmp / "tokens.pt"),
                    str(tmp / "init.pt"), str(tmp / f"{name}.json"), role]
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER, *args], cwd=str(ROOT), env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            ))
            deadline = time.monotonic() + 60
            while name not in coord.members():  # w1 is rank 0 of every world
                assert procs[-1].poll() is None and time.monotonic() < deadline, name
                time.sleep(0.02)
        logs = [p.communicate(timeout=120)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            p.kill()
        server.stop()
    assert all(p.returncode == 0 for p in procs), logs
    return [json.loads((tmp / f"{n}.json").read_text()) for n in ("w1", "w2")]


@pytest.fixture(scope="module")
def jax_1_2_1_run(dataset):
    with jax_telemetry.scoped() as (_, rec):
        coord = JaxCoordinator(target_world=1, max_world=2)
        coord.register("tr0")
        coord.register("tr1")
        et = JaxElasticTrainer(
            _jax_model(), optax.adam(LR), JaxIterator(dataset, BATCH, seed=0), coord,
            devices=jax.devices("cpu")[:2], checkpoint_interval=4, seed=0,
        )
        et.run(4)
        coord.set_target_world(2)
        et.run(8)
        coord.set_target_world(1)
        et.run(STEPS)
        assert [r.world_size for r in et.history] == [1] * 4 + [2] * 4 + [1] * 4
        return _by_step(et.history), rec.events()


@pytest.fixture(scope="module")
def jax_1_2_1(jax_1_2_1_run):
    return jax_1_2_1_run[0]


def test_gloo_1_2_1_equals_fixed_world_and_jax(gloo_1_2_1, jax_1_2_1, fixed_world):
    w1, w2 = gloo_1_2_1
    h1 = {s: (loss, w) for s, loss, w in w1["history"]}
    assert sorted(h1) == list(range(STEPS)), w1["history"]
    worlds = [h1[s][1] for s in range(STEPS)]
    assert worlds[:4] == [1] * 4 and 2 in worlds and worlds[-1] == 1, worlds
    losses = [h1[s][0] for s in range(STEPS)]
    np.testing.assert_allclose(losses, [fixed_world[s] for s in range(STEPS)], rtol=DP_RTOL)
    np.testing.assert_allclose(losses, [jax_1_2_1[s] for s in range(STEPS)], rtol=JAX_RTOL)
    # One world, one stream: the joiner's world-2 steps are the lead's.
    shared = [(s, loss) for s, loss, w in w2["history"] if w == 2]
    assert shared and all(h1[s] == (loss, 2) for s, loss in shared)
    # The joiner pulled the whole state at the 1 -> 2 resize; both left
    # the world-2 generation at one agreed stop step.
    join = [e for e in w2["events"] if e[0] == 2]
    assert join and join[0][2] == "broadcast" and join[0][4] > 0, w2["events"]
    down = [e for e in w1["events"] if e[0] == 1 and e[3] >= 0]
    assert down and down[0][3] == max(s for s, _, w in w1["history"] if w == 2) + 1
    # No formation found a process group left, and none is left now.
    forms = w1["formations"] + w2["formations"]
    assert forms and not any(f["group_left_after_teardown"] for f in forms)
    assert not w1["initialized"] and not w2["initialized"]


def test_gloo_1_2_1_journals_the_step_bus_agreement(gloo_1_2_1, jax_1_2_1_run):
    """The 2 -> 1 retarget hits a live world of two: each member
    journals at most one vote (proposing its vote step + depth + 1),
    the same agreement learned from the same word and its quiesce at
    that stop step, in that order; the lead's resize honors it.  The JAX
    in-process world has no world builder, so its retargets never
    quiesce and it journals none of these."""
    consensus = ("consensus.vote", "consensus.stop", "consensus.quiesce")
    assert not [e for e in jax_1_2_1_run[1] if e.kind in consensus]
    stops = []
    for member in gloo_1_2_1:
        journal = member["journal"]
        kinds = [e["kind"] for e in journal if e["kind"] in consensus]
        votes = [e for e in journal if e["kind"] == "consensus.vote"]
        (stop,) = [e for e in journal if e["kind"] == "consensus.stop"]
        (quiesce,) = [e for e in journal if e["kind"] == "consensus.quiesce"]
        assert kinds == ["consensus.vote"] * len(votes) + ["consensus.stop", "consensus.quiesce"]
        assert len(votes) <= 1
        for v in votes:
            assert v["data"]["proposed_stop"] == v["step"] + 3  # pipeline depth 2, + 1
        stop_step = stop["data"]["stop_step"]
        assert quiesce["data"]["stop_step"] == stop_step
        assert stop["data"]["for_generation"] == quiesce["data"]["for_generation"]
        # the lead resizes into world 1 at the agreed stop; the joiner
        # leaves the world there and stands by
        after = [e for e in journal if e["kind"] == "resize" and e["seq"] > quiesce["seq"]]
        if member is gloo_1_2_1[0]:
            assert [e["data"]["stop_step"] for e in after] == [stop_step]
        else:
            assert after == []
        stops.append((stop["step"], stop_step))
    # one agreement: the first word with a vote, decoded alike by both
    assert stops[0] == stops[1]
    first_vote = min(e["step"] for m in gloo_1_2_1 for e in m["journal"]
                     if e["kind"] == "consensus.vote")
    assert stops[0] == (first_vote, first_vote + 3)


# ---- BatchStager --------------------------------------------------------------------


def test_stager_gives_the_synchronous_bytes_across_an_epoch():
    ds = {"x": np.arange(128, dtype=np.float32)[:, None]}
    it = ShardedDataIterator(ds, global_batch_size=32, seed=3)
    stager = BatchStager(it, depth=3, device="cpu")
    stager.rebind(0)
    for step in range(2, 7):  # crosses the epoch boundary at step 4
        torch.testing.assert_close(stager.get(step)["x"], it.device_batch(step, "cpu")["x"])
    stager.rebind(1, world=2, rank=1)
    torch.testing.assert_close(stager.get(3)["x"], it.device_batch(3, "cpu", 2, 1)["x"])


def test_stager_rebind_invalidates_staged_batches():
    ds = {"x": np.arange(64, dtype=np.float32)[:, None]}
    it = ShardedDataIterator(ds, global_batch_size=16, seed=0)
    stager = BatchStager(it, depth=2, device="cpu")
    stager.rebind(1)
    stager.get(0)  # schedules 1, 2
    stager.rebind(2)  # a resize: staged batches must drop
    with stager._cv:
        assert stager._ready == {} and not stager._queue
    torch.testing.assert_close(stager.get(1)["x"], it.device_batch(1, "cpu")["x"])


def test_stager_worker_failure_falls_back_synchronously(monkeypatch):
    """A worker that dies on every build must not lose steps or hang the
    consumer: get() builds the batch itself."""
    ds = {"x": np.arange(64, dtype=np.float32)[:, None]}
    it = ShardedDataIterator(ds, global_batch_size=16, seed=0)
    stager = BatchStager(it, depth=2, device="cpu")
    stager.rebind(1)
    real = it.host_batch

    def flaky(step, world=1, rank=0):
        if threading.current_thread().name == "edl-batch-stager":
            raise RuntimeError("worker build failed")
        return real(step, world, rank)

    monkeypatch.setattr(it, "host_batch", flaky)
    for step in range(4):
        torch.testing.assert_close(stager.get(step)["x"], torch.from_numpy(real(step)["x"]))
        time.sleep(0.05)  # let the worker fail its staged steps
    assert stager.stats["failures"] >= 1
    assert stager.stats["hits"] == 0


# ---- coordinator, its HTTP service, the watchdog -----------------------------------


def test_coordinator_membership_generations_and_legal_sizes():
    c = LocalCoordinator(target_world=2, max_world=4)
    p1 = c.register("a")
    p2 = c.register("b")
    assert (p1.world_size, p2.world_size, p2.members) == (1, 2, ("a", "b"))
    assert p2.generation > p1.generation
    p3 = c.register("c")  # beyond the target: standby, same generation
    assert p3.members == ("a", "b") and p3.generation == p2.generation
    c.deregister("a")  # the standby is promoted
    assert c.plan().members == ("b", "c")
    g = c.plan().generation
    c.set_target_world(2)  # a no-op retarget does not bump
    assert c.plan().generation == g
    c.set_prewarm(3)  # advisory: same generation
    assert c.plan().prewarm == 3 and c.plan().generation == g
    q = LocalCoordinator(target_world=4, legal_sizes=[1, 2, 4])
    for t in "xyz":
        q.register(t)
    assert q.plan().world_size == 2
    none = LocalCoordinator(target_world=4, legal_sizes=[4])
    none.register("x")
    assert none.plan().world_size == 0  # hold at the barrier


def test_coordinator_evicts_a_member_that_stopped_beating():
    now = [0.0]
    c = LocalCoordinator(target_world=2, heartbeat_timeout=5.0, clock=lambda: now[0])
    c.register("a")
    c.register("b")
    now[0] = 3.0
    c.heartbeat("a", step=7)
    now[0] = 7.0
    assert c.evict_dead() == ["b"]
    assert c.plan().members == ("a",) and c.plan().stop_step == 7 + c.stop_margin
    with pytest.raises(KeyError):
        c.heartbeat("b")


def test_http_coordinator_round_trip():
    c = LocalCoordinator(target_world=1, max_world=2)
    server = CoordinatorServer(c, host="127.0.0.1", port=0).start(evict=False)
    try:
        h = HTTPCoordinator(f"127.0.0.1:{server.port}")
        plan = h.register("a", address="127.0.0.1:9")
        assert plan == c.plan() and plan.addresses == ("127.0.0.1:9",)
        h.heartbeat("a", step=3)
        assert h.clock_estimator.offset() is not None
        h.ack_generation("a", plan.generation)
        h.report_checkpoint(4)
        h.set_target_world(2)
        h.register("b")
        assert h.plan() == c.plan() and h.plan().world_size == 2
        assert h.members() == ["a", "b"] and h.get_target_world() == 2
        m = h.metrics()
        assert (m["latest_checkpoint_step"], m["members"]) == (4, 2)
        assert not h.completed()
        h.report_complete(9)
        assert h.completed()
        with pytest.raises(KeyError):
            h.heartbeat("nobody")
    finally:
        server.stop()


def test_watchdog_trips_on_a_wedged_fetch():
    wd = CollectiveWatchdog(timeout=0.2)
    assert wd.fetch(lambda: 5) == 5
    gate = threading.Event()
    with pytest.raises(CollectiveTimeout):
        wd.fetch(gate.wait)
    gate.set()
    assert wd.trips == 1 and wd.fetch(lambda: 6) == 6
    assert CollectiveWatchdog(timeout=0).fetch(lambda: 7) == 7


# ---- the launcher's entry point --------------------------------------------------


def test_launcher_run_alone_then_cold_start_from_its_checkpoint_dir(tmp_path, monkeypatch):
    """``launcher.run`` with no coordinator address trains alone; a
    second run into the same checkpoint dir with more steps restores the
    first run's final state and continues, and the env contract sets
    the pipeline depth and the pod address."""
    from edl_tpu_torch import launcher

    monkeypatch.setenv("EDL_PIPELINE_DEPTH", "0")
    monkeypatch.setenv("EDL_POD_IP", "10.0.0.7")
    monkeypatch.setenv("EDL_DIST_PORT", "9000")
    cfg = launcher.env_config()
    assert (cfg["pipeline_depth"], cfg["pod_address"]) == (0, "10.0.0.7:9000")
    monkeypatch.delenv("EDL_POD_IP")
    kw = dict(model_kwargs={"tiny": True, "dtype": torch.float32}, device="cpu",
              dataset_examples=64, checkpoint_dir=str(tmp_path / "ckpt"),
              history_file=str(tmp_path / "hist.jsonl"))
    first = launcher.run("transformer_lm", steps=3, **kw)
    assert [r.step for r in first.history] == [0, 1, 2] and first.pipeline_depth == 0
    again = launcher.run("transformer_lm", steps=5, **kw)
    assert again.resize_events[0].restored_step == 3
    assert [r.step for r in again.history] == [3, 4]
    fresh = launcher.run("transformer_lm", steps=5, **{**kw, "checkpoint_dir": ""})
    assert _stream(again.history) == _stream(fresh.history)[3:]
    lines = [json.loads(x) for x in (tmp_path / "hist.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines if "step" in x] == [0, 1, 2, 3, 4, 0, 1, 2, 3, 4]
    assert sum("resize" in x for x in lines) == 3
    assert not torch.distributed.is_initialized()


def test_array_store_staged_by_either_package_resolves_to_the_same_bytes(port_model, tmp_path):
    """A store the JAX package staged and one the port staged load as the
    same memory-mapped arrays as the synthetic set they were staged from;
    a store of the wrong shape fails before any step."""
    from edl_tpu.runtime.datasets import stage_synthetic as jax_stage
    from edl_tpu_torch.runtime import synthetic_dataset
    from edl_tpu_torch.runtime.datasets import resolve_dataset, save_array_store, stage_synthetic

    want = synthetic_dataset(port_model.synth_batch, 32, seed=0)["tokens"]
    jax_stage(str(tmp_path / "jax"), port_model.synth_batch, 32, seed=0)
    stage_synthetic(str(tmp_path / "port"), port_model.synth_batch, 32, seed=0)
    for which in ("jax", "port"):
        got = resolve_dataset(port_model, str(tmp_path / which), 0)["tokens"]
        assert isinstance(got, np.memmap) and got.tobytes() == want.tobytes()
    assert resolve_dataset(port_model, "", 32)["tokens"].tobytes() == want.tobytes()
    save_array_store(str(tmp_path / "bad"), {"tokens": want[:, :10]})
    with pytest.raises(ValueError, match="per-example shape"):
        resolve_dataset(port_model, str(tmp_path / "bad"), 0)
