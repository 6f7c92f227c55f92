"""The port's checkpoint-backed serving replica, on the CPU.

- the port's trainer spills and the engine ``load()``s the spill; the
  served weights are the trained float32 parameters, by name;
- ``refresh()`` swaps to a newer checkpoint in DRAM and to a newer
  spill on disk; a torn candidate is rejected once and the old weights
  keep serving; a spill written by the JAX package (another leaf
  schema) is rejected and counted, never installed;
- tokens served after ``load()`` equal the JAX ``DecodeEngine``'s on
  the converted weights;
- the drain contract of ``tests/test_serving_drain.py``: 503 +
  Retry-After while draining against 429 for a full queue, in-flight
  work finishes, the KV pool is freed, the replica deregisters; a drain
  that misses its budget stays registered, and a retry succeeds;
- ``serve_run`` from the ``EDL_*`` env keys, registered over
  ``HTTPCoordinator`` with a ``CoordinatorServer``.
"""

import dataclasses
import json
import os
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.checkpoint import HostDRAMStore as JaxStore
from edl_tpu.models.base import get_model as jax_get_model
from edl_tpu.models.transformer_lm import TransformerLM as FlaxLM
from edl_tpu.models.transformer_lm import lm_decode_spec as jax_decode_spec
from edl_tpu.runtime.train import TrainState as JaxTrainState
from edl_tpu.serving import DecodeEngine as JaxDecodeEngine
from edl_tpu.serving import TokenContinuousBatcher as JaxBatcher
from edl_tpu_torch import telemetry
from edl_tpu_torch.checkpoint import HostDRAMStore
from edl_tpu_torch.convert import params_from_flax
from edl_tpu_torch.models import get_model
from edl_tpu_torch.runtime import LocalCoordinator, ShardedDataIterator, Trainer, synthetic_dataset
from edl_tpu_torch.runtime.coord_service import CoordinatorServer
from edl_tpu_torch.serving import (
    ContinuousBatcher,
    DecodeEngine,
    DrainingError,
    QueueFullError,
    ServingReplica,
    ServingServer,
    TokenContinuousBatcher,
    serve_run,
)

V, D, FF, H, LAYERS, L = 256, 64, 256, 4, 2, 64
BT = 16


@pytest.fixture(scope="module")
def trained():
    """The tiny model (float32 compute) trained 4 steps on the CPU, the
    state saved after steps 2 and 4 (float32 parameters by name)."""
    model = get_model("transformer_lm", tiny=True, dtype=torch.float32)
    trainer = Trainer(model, device="cpu", seed=0)
    it = ShardedDataIterator(synthetic_dataset(model.synth_batch, 16, seed=0), 4, seed=0)
    state = trainer.init_state()
    stores, params = {}, {}
    for step in range(4):
        state, _ = trainer.step(state, it.device_batch(step, "cpu"))
        if state.step in (2, 4):
            host = HostDRAMStore()
            host.save_async(state)
            host.wait()
            stores[state.step] = host.latest()
            params[state.step] = {n: p.detach().clone() for n, p in state.params.named_parameters()}
    return {"model": model, "ckpts": stores, "params": params}


def _engine(model, store, **kw):
    return DecodeEngine(model, device="cpu", max_seqs=4, block_tokens=BT, store=store, **kw)


def _spill(ckpt, spill_dir):
    store = HostDRAMStore(spill_dir=str(spill_dir))
    store.put(ckpt)
    store._spill(ckpt)


def _served_equals(engine, params):
    served = dict(engine.current_weights().params.named_parameters())
    assert set(served) == set(params)
    for name, p in params.items():
        assert torch.equal(served[name], p), name


def test_trainer_spill_loads_into_the_engine(trained, tmp_path):
    with telemetry.scoped() as (_, rec):
        _spill(trained["ckpts"][2], tmp_path)
        eng = _engine(trained["model"], HostDRAMStore(spill_dir=str(tmp_path)))
        assert not eng.ready
        assert eng.load()
        assert eng.weights_step == 2 and eng.weights_generation == 1
        _served_equals(eng, trained["params"][2])
        swap = [e for e in rec.events() if e.kind.startswith("serve.swap")][-1]
        assert swap.kind == "serve.swap" and swap.data == {"step": 2, "initial": True}
        # an empty store and no spill dir: nothing to serve
        assert not _engine(trained["model"], HostDRAMStore()).load()


def test_refresh_swaps_to_newer_dram_and_disk_checkpoints(trained, tmp_path):
    with telemetry.scoped() as (reg, _):
        store = HostDRAMStore()
        store.put(trained["ckpts"][2])
        eng = _engine(trained["model"], store)
        assert eng.load() and not eng.refresh()
        store.put(trained["ckpts"][4])  # a newer DRAM checkpoint
        assert eng.refresh() and eng.weights_step == 4
        _served_equals(eng, trained["params"][4])
        # a replica in another process: only the spill directory
        _spill(trained["ckpts"][2], tmp_path)
        disk = _engine(trained["model"], HostDRAMStore(spill_dir=str(tmp_path)))
        disk.spill_poll_interval = 0.0
        assert disk.load() and disk.weights_step == 2
        assert not disk.refresh()
        _spill(trained["ckpts"][4], tmp_path)
        assert disk.refresh() and disk.weights_step == 4
        _served_equals(disk, trained["params"][4])
        assert reg.counter("edl_serve_hot_swaps_total").value() == 2
        assert reg.counter("edl_serve_swap_rejected_total").value() == 0


def test_torn_candidate_rejected_once_old_weights_keep_serving(trained):
    with telemetry.scoped() as (reg, rec):
        store = HostDRAMStore()
        store.put(trained["ckpts"][2])
        eng = _engine(trained["model"], store)
        assert eng.load()
        good = trained["ckpts"][4]
        torn = dataclasses.replace(good, leaves=[x.copy() for x in good.leaves])
        torn.adopt_digests(good.leaf_digests())
        torn.leaves[0].reshape(-1).view(np.uint8)[0] ^= 0xFF  # rots after the digest
        store.put(torn)
        for _ in range(4):  # four polls, one torn candidate
            assert not eng.refresh()
        assert reg.counter("edl_serve_swap_rejected_total").value() == 1
        assert [e.kind for e in rec.events()].count("serve.swap.rejected") == 1
        assert eng.weights_step == 2
        _served_equals(eng, trained["params"][2])
        fresh = dataclasses.replace(good, step=5, leaves=[x.copy() for x in good.leaves])
        store.put(fresh)  # a newer clean save still swaps in
        assert eng.refresh() and eng.weights_step == 5


def _jax_params():
    fm = FlaxLM(V, D, FF, H, LAYERS, L, dtype=jnp.float32)
    return fm, fm.init(jax.random.key(0), jnp.zeros((1, L), jnp.int32))["params"]


def _jax_state(params, step):
    return JaxTrainState(step=jnp.asarray(step, jnp.int32), params=params,
                         opt_state=optax.adam(1e-3).init(params))


def test_jax_written_spill_is_rejected(trained, tmp_path):
    """The JAX package's spill of a tiny transformer_lm TrainState has
    another leaf schema (its own count and order): the port refuses to
    install it, at load and at refresh, and counts it once."""
    _, params = _jax_params()
    jstore = JaxStore(spill_dir=str(tmp_path))
    jstore.save_async(_jax_state(params, 7), generation=0)
    jstore.wait()
    assert os.path.exists(tmp_path / "ckpt-000000000007.json")
    with telemetry.scoped() as (reg, _):
        eng = _engine(trained["model"], HostDRAMStore(spill_dir=str(tmp_path)))
        assert not eng.load() and not eng.ready
        assert reg.counter("edl_serve_swap_rejected_total").value() == 1
        # serving step 2 from DRAM, the JAX spill at step 7 on disk
        eng.store.put(trained["ckpts"][2])
        eng.spill_poll_interval = 0.0
        assert eng.load() and eng.weights_step == 2
        for _ in range(3):
            assert not eng.refresh()
        assert eng.weights_step == 2
        assert reg.counter("edl_serve_swap_rejected_total").value() == 2


def test_tokens_after_load_equal_the_jax_engine(tmp_path):
    """A flax init carried over with ``convert.py`` into the port's
    trainer state, spilled and loaded: the replica's tokens (chunked,
    prefix cache on) equal the JAX ``DecodeEngine``'s (monolithic) on
    the flax params, float32 on both sides."""
    from edl_tpu import telemetry as jax_telemetry

    fm, params = _jax_params()
    model = get_model("transformer_lm", tiny=True, dtype=torch.float32)
    state = Trainer(model, device="cpu").init_state(
        params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    store = HostDRAMStore(spill_dir=str(tmp_path))
    store.save_async(state)
    store.wait()
    rng = np.random.RandomState(4)
    prompts = [rng.randint(3, V, size=n).astype(np.int32) for n in (5, 21, 40)]
    prompts.append(prompts[-1])  # the second claims the first's blocks
    with telemetry.scoped():
        eng = _engine(model, HostDRAMStore(spill_dir=str(tmp_path)))
        assert eng.load() and eng.weights_step == 0
        gen = TokenContinuousBatcher(eng).start()
        try:
            tout = [gen.submit_generate({"tokens": p.tolist()}, max_new_tokens=6).result(timeout=60)
                    for p in prompts]
        finally:
            gen.stop()
    assert tout[3][1]["reused_blocks"] == 2
    jmodel = dataclasses.replace(jax_get_model("transformer_lm", tiny=True),
                                 decode=jax_decode_spec(fm, H, D, L))
    jstore = JaxStore()
    jstore.save_async(_jax_state(params, 0), generation=0)
    jstore.wait()
    with jax_telemetry.scoped():
        jeng = JaxDecodeEngine(jmodel, jstore, devices=jax.devices()[:1], max_batch=1,
                               max_seqs=4, block_tokens=BT)
        assert jeng.load()
        jb = JaxBatcher(jeng, refresh=False, chunked_prefill=False).start()
        try:
            jout = [jb.submit_generate({"tokens": p}, max_new_tokens=6).result(timeout=120)[0]
                    for p in prompts]
        finally:
            jb.stop()
    assert [t for t, _ in tout] == jout
    assert len({tuple(t) for t in jout}) > 1


# -- drain ----------------------------------------------------------------------


def _post(url, body, timeout=30):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


@pytest.fixture()
def ready_engine(trained):
    store = HostDRAMStore()
    store.put(trained["ckpts"][2])
    return _engine(trained["model"], store)


def test_http_drain_is_503_with_retry_after_and_full_queue_is_429(ready_engine):
    with telemetry.scoped() as (reg, _):
        eng = ready_engine
        assert eng.load()
        batcher = ContinuousBatcher(eng, queue_limit=1)  # not started: fills
        gen = TokenContinuousBatcher(eng, queue_limit=1, refresh=False)
        server = ServingServer(batcher, port=0, gen_batcher=gen).start()
        base = f"http://127.0.0.1:{server.port}"
        try:
            gen.submit_generate({"tokens": [5, 6]})
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + "/generate", {"inputs": {"tokens": [5, 6]}})
            assert e.value.code == 429
            gen.start()
            batcher.start()
            r = _post(base + "/drain", {"budget_ms": 10000})
            assert r["draining"] and r["drained"] and r["in_flight"] == 0
            for path, body in (("/generate", {"inputs": {"tokens": [5, 6]}}),
                               ("/predict", {"inputs": {"tokens": [[5, 6]]}})):
                with pytest.raises(urllib.error.HTTPError) as e:
                    _post(base + path, body)
                assert e.value.code == 503, path
                assert float(e.value.headers["Retry-After"]) > 0
                assert json.loads(e.value.read())["draining"] is True
            with pytest.raises(DrainingError) as de:
                gen.submit_generate({"tokens": [5, 6]})
            assert not isinstance(de.value, QueueFullError)
            with urllib.request.urlopen(base + "/healthz", timeout=10) as h:
                health = json.loads(h.read())
            assert health["draining"] is True and health["in_flight"] == 0
            assert reg.counter("edl_serve_requests_total").value(status="draining") == 3
        finally:
            server.stop()
            gen.stop()
            batcher.stop()
    assert eng.pool.used_blocks == 0


def test_replica_drain_finishes_in_flight_frees_kv_deregisters(ready_engine):
    with telemetry.scoped() as (reg, _):
        eng = ready_engine
        coord = LocalCoordinator(target_world=2, max_world=4)
        replica = ServingReplica(eng, coordinator=coord, replica_id="serve-0",
                                 heartbeat_interval=60.0).start()
        try:
            assert replica.loaded and eng.warmed and coord.members() == ["serve-0"]
            rng = np.random.RandomState(0)
            tickets = [
                replica.gen_batcher.submit_generate(
                    {"tokens": rng.randint(3, V, size=5 + 7 * i).tolist()},
                    max_new_tokens=24, deadline_s=30.0)
                for i in range(3)
            ]
            r = replica.drain(budget_s=30.0)
            assert r["drained"] and r["in_flight"] == 0
            assert r["progress"] == {"total": 3, "migrated": 0, "remaining": 0}
            for t in tickets:
                assert len(t.result(timeout=1.0)[0]) == 24  # none cut short
            assert eng.pool.used_blocks == 0
            assert coord.members() == []
            assert replica.drain()["drained"]  # a second call shares the result
            assert reg.counter("edl_serve_drains_total").value() == 1
            assert reg.gauge("edl_serve_draining").value(replica="serve-0") == 2
        finally:
            replica.stop()


def test_budget_missed_drain_stays_registered_and_retries(ready_engine):
    with telemetry.scoped() as (reg, _):
        eng = ready_engine
        coord = LocalCoordinator(target_world=2, max_world=4)
        replica = ServingReplica(eng, coordinator=coord, replica_id="serve-slow",
                                 heartbeat_interval=0.05).start()
        try:
            t = replica.gen_batcher.submit_generate(
                {"tokens": [5, 6, 7, 8]}, max_new_tokens=48, deadline_s=60.0)
            deadline = time.monotonic() + 10
            while not t.tokens and time.monotonic() < deadline:
                time.sleep(0.002)
            r1 = replica.drain(budget_s=0.001)
            assert not r1["drained"] and r1["in_flight"] >= 1
            assert "serve-slow" in coord.members() and replica._thread.is_alive()
            with pytest.raises(DrainingError):
                replica.gen_batcher.submit_generate({"tokens": [5, 6]})
            r2 = replica.drain(budget_s=60.0)
            assert r2["drained"] and r2["in_flight"] == 0
            assert len(t.result(timeout=1.0)[0]) == 48
            assert "serve-slow" not in coord.members()
            assert reg.counter("edl_serve_drains_total").value() == 1
        finally:
            replica.stop()
    assert eng.pool.used_blocks == 0


def test_heartbeat_rejoins_after_eviction(ready_engine):
    with telemetry.scoped():
        coord = LocalCoordinator(target_world=2, max_world=4)
        replica = ServingReplica(ready_engine, coordinator=coord, replica_id="serve-e",
                                 heartbeat_interval=60.0).start()
        try:
            coord.deregister("serve-e")  # evicted while alive
            replica.tick()
            assert coord.members() == ["serve-e"]
        finally:
            replica.stop()
        assert coord.members() == []


def test_serve_run_from_env_over_http_coordinator(trained, tmp_path, monkeypatch):
    _spill(trained["ckpts"][4], tmp_path)
    coord = LocalCoordinator(target_world=2, max_world=4)
    cserver = CoordinatorServer(coord, host="127.0.0.1", port=0).start(evict=False)
    for key, val in {
        "EDL_CHECKPOINT_DIR": str(tmp_path),
        "EDL_COORDINATOR_ADDR": f"127.0.0.1:{cserver.port}",
        "EDL_POD_NAME": "serve-env",
        "EDL_POD_ADDRESS": "127.0.0.1:0",
        "EDL_SERVE_PORT": "0",
        "EDL_SERVE_QUEUE_LIMIT": "7",
        "EDL_SERVE_DRAIN_MS": "20000",
    }.items():
        monkeypatch.setenv(key, val)
    with telemetry.scoped():
        replica = serve_run("transformer_lm", device="cpu", host="127.0.0.1",
                            tiny=True, dtype=torch.float32)
        base = f"http://127.0.0.1:{replica.server.port}"
        try:
            assert coord.members() == ["serve-env"]
            assert replica.drain_budget_s == 20.0
            assert replica.gen_batcher.queue_limit == 7
            with urllib.request.urlopen(base + "/healthz", timeout=10) as h:
                health = json.loads(h.read())
            assert health["weights_step"] == 4 and health["warm"]
            assert health["decode"]["chunked_prefill"] is True
            assert health["decode"]["prefix_cache"]["hits"] == 0
            prompt = list(range(3, 40))
            first = _post(base + "/generate", {"inputs": {"tokens": prompt}, "max_new_tokens": 4})
            again = _post(base + "/generate", {"inputs": {"tokens": prompt}, "max_new_tokens": 4})
            assert first["weights_step"] == 4 and first["reused_blocks"] == 0
            assert again["reused_blocks"] == 2 and again["tokens"] == first["tokens"]
            r = _post(base + "/drain", {})
            assert r["drained"] and coord.members() == []
        finally:
            replica.stop()
            cserver.stop()


def test_swap_and_retry_reach_the_coordinator_merged_telemetry(trained):
    """The replica's hot swap (``serve.swap``) and its coordinator
    client's absorbed transient failure (``retry``) are journaled in the
    flight recorder, and one report carries both into the events of the
    coordinator's merged ``/telemetry``."""
    import urllib.error

    from edl_tpu_torch.runtime.coord_service import HTTPCoordinator

    coord = LocalCoordinator(target_world=1, max_world=2)
    cserver = CoordinatorServer(coord, host="127.0.0.1", port=0).start(evict=False)
    with telemetry.scoped():
        store = HostDRAMStore()
        store.put(trained["ckpts"][2])
        eng = _engine(trained["model"], store)
        assert eng.load()
        store.put(trained["ckpts"][4])
        assert eng.refresh() and eng.weights_step == 4
        client = HTTPCoordinator(f"127.0.0.1:{cserver.port}", retry_base_delay=0.01)
        real_open, faults = client._open, [urllib.error.URLError("connection reset")]

        def flaky_open(req):
            if faults:
                raise faults.pop()
            return real_open(req)

        client._open = flaky_open
        server = ServingServer(ContinuousBatcher(eng), port=0)
        rep = ServingReplica(eng, server=server, coordinator=client, replica_id="c4-a",
                             address=f"127.0.0.1:{server.port}", heartbeat_interval=60.0,
                             telemetry_interval=0,
                             gen_batcher=TokenContinuousBatcher(eng, refresh=False)).start()
        try:
            rep.tick()
            events = HTTPCoordinator(f"127.0.0.1:{cserver.port}").telemetry()["events"]
        finally:
            rep.stop()
            cserver.stop()
    mine = [e for e in events if e["data"].get("origin") == "c4-a"]
    swaps = [e["data"] for e in mine if e["kind"] == "serve.swap"]
    # the engine's load and swap, then the replica's own load at start
    assert [(s["step"], s.get("initial"), s.get("from_step")) for s in swaps] == [
        (2, True, None), (4, None, 2), (4, True, None)]
    retries = [e["data"] for e in mine if e["kind"] == "retry"]
    assert retries and retries[0]["op"] == "coordinator request"
    assert retries[0]["error"] == "URLError"
