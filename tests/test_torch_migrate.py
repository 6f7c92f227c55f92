"""The port's live KV migration, its telemetry and the dispatch watchdog,
on the CPU.

- parity with the JAX package, both sides built from one flax init
  (``convert.py``): the same prompt migrated at token 10 gives the same
  tokens in the port and in the JAX package (``MigrationReceiver``,
  ``migrate_out``), and both equal the unmigrated run; ``export_kv`` of
  one prefilled sequence agrees with the JAX engine's;
  ``histogram_quantile`` and ``TelemetryAggregator.merged()`` give equal
  results on the same snapshots; ``FlightRecorder.digest()`` is equal
  over the same events;
- every rung of the fallback ladder, each driven by a planted fault: a
  torn push, a survivor pool too small, a weights skew, a swap between
  grant and adoption, an unreachable survivor, a half-prefilled
  sequence, a worker that does not park for the freeze (on either end),
  a drain that acks before a long generation ends, a drain that misses
  its budget and is retried;
- the dispatch watchdog: a call wedged past its deadline rebuilds the
  pool and the live sequences re-prefill.
"""

import dataclasses
import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu import telemetry as jax_telemetry
from edl_tpu.checkpoint import HostDRAMStore as JaxStore
from edl_tpu.models.base import get_model as jax_get_model
from edl_tpu.models.transformer_lm import TransformerLM as FlaxLM
from edl_tpu.models.transformer_lm import lm_decode_spec as jax_decode_spec
from edl_tpu.runtime.train import TrainState as JaxTrainState
from edl_tpu.serving import DecodeEngine as JaxDecodeEngine
from edl_tpu.serving import MigrationReceiver as JaxReceiver
from edl_tpu.serving import TokenContinuousBatcher as JaxBatcher
from edl_tpu.serving import migrate_out as jax_migrate_out
from edl_tpu.telemetry import FlightRecorder as JaxRecorder
from edl_tpu.telemetry import TelemetryAggregator as JaxAggregator
from edl_tpu.telemetry.aggregate import histogram_quantile as jax_quantile
from edl_tpu_torch import telemetry
from edl_tpu_torch.convert import params_from_flax
from edl_tpu_torch.models import get_model
from edl_tpu_torch.serving import (
    DecodeEngine,
    DispatchWedgedError,
    FreezeTimeoutError,
    MigrationReceiver,
    MigrationRefusedError,
    ServingReplica,
    TokenContinuousBatcher,
    migrate,
    migrate_out,
)
from edl_tpu_torch.telemetry import FlightRecorder, TelemetryAggregator, histogram_quantile

V, D, FF, H, LAYERS, L = 256, 64, 256, 4, 2, 64
BT = 16
PROMPT = [int(x) for x in np.random.RandomState(5).randint(3, V, size=21)]
N = 18


def _wait(cond, timeout=20.0, what=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.002)
    raise AssertionError(f"wait timed out: {what}")


@pytest.fixture(scope="module")
def flax_init():
    """The tiny LM's flax init with every matrix scaled up 8x: at the
    plain init greedy decode repeats one token, which would make a
    dropped, duplicated or reordered token invisible."""
    fm = FlaxLM(V, D, FF, H, LAYERS, L, dtype=jnp.float32)
    params = fm.init(jax.random.key(0), jnp.zeros((1, L), jnp.int32))["params"]
    params = jax.tree_util.tree_map(lambda x: x * 8.0 if x.ndim >= 2 else x, params)
    return fm, params


def _port_engine(sd, step=0, **kw):
    model = get_model("transformer_lm", tiny=True, dtype=torch.float32)
    eng = DecodeEngine(model, device="cpu", max_seqs=4, block_tokens=BT, **kw)
    eng.install(sd, step=step)
    return eng


@pytest.fixture(scope="module")
def port_sd(flax_init):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, flax_init[1]))


@pytest.fixture(scope="module")
def pair(port_sd):
    """A source and a survivor engine on the same weights; every test
    mounts fresh batchers and receivers and leaves both pools empty."""
    return _port_engine(port_sd), _port_engine(port_sd)


def _generate(eng, prompt=PROMPT, n=N, **kw):
    b = TokenContinuousBatcher(eng, refresh=False, **kw).start()
    try:
        return b.submit_generate({"tokens": prompt}, max_new_tokens=n).result(timeout=60)[0]
    finally:
        b.stop()


@pytest.fixture(scope="module")
def reference(pair):
    """The unmigrated run's tokens."""
    with telemetry.scoped():
        return _generate(pair[0])


def _submit_held(b, at, prompt=PROMPT, n=N, events=None):
    """Submit a generation whose stream holds the worker after its
    ``at``-th token until a freeze is requested, so a migration lands
    exactly at that token boundary (``at`` = 0: no hold)."""
    reached = threading.Event()

    def on_event(ev):
        if events is not None:
            events.append(ev)
        if at and ev.get("i") == at - 1 and not reached.is_set():
            reached.set()
            end = time.monotonic() + 20
            while not b._freeze_req.is_set() and time.monotonic() < end:
                time.sleep(0.001)

    t = b.submit_generate({"tokens": prompt}, max_new_tokens=n, deadline_s=60.0,
                          on_event=on_event)
    if at:
        assert reached.wait(30), "generation never reached the migration point"
    return t


# -- parity with the JAX package -------------------------------------------------


def _jax_engines(fm, params, n):
    jmodel = dataclasses.replace(jax_get_model("transformer_lm", tiny=True),
                                 decode=jax_decode_spec(fm, H, D, L))
    store = JaxStore()
    store.save_async(JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                                   opt_state=optax.adam(1e-3).init(params)), generation=0)
    store.wait()
    engines = []
    with jax_telemetry.scoped():
        for _ in range(n):
            e = JaxDecodeEngine(jmodel, store, devices=jax.devices()[:1], max_batch=1,
                                max_seqs=4, block_tokens=BT)
            assert e.load()
            engines.append(e)
    return engines


@pytest.fixture(scope="module")
def jax_pair(flax_init):
    return _jax_engines(*flax_init, 2)


def test_migration_at_token_10_matches_the_jax_package_and_the_unmigrated_run(
    pair, reference, jax_pair
):
    src, dst = pair
    with telemetry.scoped() as (reg, _):
        sb = TokenContinuousBatcher(src, refresh=False).start()
        db = TokenContinuousBatcher(dst, refresh=False).start()
        recv = MigrationReceiver(dst, db, replica_id="dst").start()
        events = []
        try:
            t = _submit_held(sb, 10, events=events)
            sb.close_admission()
            s = migrate_out(src, sb, f"tcp://127.0.0.1:{recv.port}", replica_id="src")
            # 21 prompt + 9 decoded positions written: two blocks move
            assert (s["migrated"], s["failed"], s["blocks"]) == (1, 0, 2)
            assert s["bytes"] == 2 * 2 * LAYERS * BT * H * (D // H) * 4
            assert t.migrated and sb.in_flight == 0
            port_tokens, meta = t.result(timeout=60)
            assert meta["migrated"] is True and meta["restarts"] == 0
            assert db.stats["prefills"] == 0  # resumed off the imported KV
            assert [e["i"] for e in events if "token" in e] == list(range(N))
            assert reg.counter("edl_serve_migrations_total").value(outcome="ok") == 1
            assert reg.counter("edl_serve_migrations_bytes_total").value() == s["bytes"]
        finally:
            sb.stop()
            db.stop()
            recv.stop()
    assert src.pool.used_blocks == 0 and dst.pool.used_blocks == 0
    jsrc, jdst = jax_pair
    with jax_telemetry.scoped():
        jsb = JaxBatcher(jsrc, refresh=False, chunked_prefill=False).start()
        jdb = JaxBatcher(jdst, refresh=False, chunked_prefill=False).start()
        jrecv = JaxReceiver(jdst, jdb).start()
        try:
            jt = _submit_held(jsb, 10)
            jsb.close_admission()
            js = jax_migrate_out(jsrc, jsb, f"tcp://127.0.0.1:{jrecv.port}")
            assert (js["migrated"], js["bytes"]) == (1, s["bytes"])
            jax_tokens, _ = jt.result(timeout=120)
        finally:
            jsb.stop()
            jdb.stop()
            jrecv.stop()
    assert port_tokens == jax_tokens == reference
    assert len(set(reference)) > 2


def test_export_kv_agrees_with_the_jax_engine_and_round_trips(pair):
    """One prompt prefilled on both engines, from the plain flax init
    (values of order 1): the exported K/V planes agree to 1e-5; and the
    port's export -> import -> export moves the bytes exactly."""
    fm = FlaxLM(V, D, FF, H, LAYERS, L, dtype=jnp.float32)
    params = fm.init(jax.random.key(0), jnp.zeros((1, L), jnp.int32))["params"]
    src = _port_engine(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    dst = pair[1]
    jeng = _jax_engines(fm, params, 1)[0]
    prompt = np.asarray(PROMPT, np.int32)
    ids = src.pool.alloc(2)
    jids = jeng.pool.alloc(2)
    back = dst.pool.alloc(2)
    try:
        table = np.zeros(src.blocks_per_seq, np.int32)
        table[:2] = ids
        src.prefill(src.current_weights(), prompt, table)
        jtable = np.zeros(jeng.blocks_per_seq, np.int32)
        jtable[:2] = jids
        jeng.prefill(jeng.current_weights(), prompt, jtable)
        k, v = src.export_kv(ids)
        jk, jv = jeng.export_kv(jids)
        assert tuple(k.shape) == jk.shape == (LAYERS, 2, BT, H, D // H)
        # positions past the prompt (21 of 32) hold no K/V on either side
        np.testing.assert_allclose(k.numpy().reshape(LAYERS, -1, H, D // H)[:, :21],
                                   jk.reshape(LAYERS, -1, H, D // H)[:, :21], atol=1e-5)
        np.testing.assert_allclose(v.numpy().reshape(LAYERS, -1, H, D // H)[:, :21],
                                   jv.reshape(LAYERS, -1, H, D // H)[:, :21], atol=1e-5)
        dst.import_kv(back, k, v)
        k2, v2 = dst.export_kv(back)
        assert k2.numpy().tobytes() == k.numpy().tobytes()
        assert v2.numpy().tobytes() == v.numpy().tobytes()
        with pytest.raises(ValueError, match="does not fit"):
            dst.import_kv(back, k[:, :1], v[:, :1])
    finally:
        src.pool.free(ids)
        jeng.pool.free(list(jids))
        dst.pool.free(back)


def _snapshots():
    rng = np.random.RandomState(3)
    snaps = []
    for i in range(3):
        reg = telemetry.MetricsRegistry()
        for x in rng.exponential(0.05, size=40):
            reg.histogram("edl_serve_ttft_seconds").observe(float(x))
        reg.counter("edl_serve_tokens_total").inc(int(rng.randint(1, 100)))
        reg.gauge("edl_serve_decode_queue_depth").set(float(i))
        snaps.append(reg.snapshot())
    return snaps


def test_quantile_and_aggregator_merge_equal_the_jax_package():
    snaps = _snapshots()
    agg, jagg = TelemetryAggregator(), JaxAggregator()
    for i, s in enumerate(snaps):
        for a in (agg, jagg):
            assert a.report(f"r{i}", s, seq=1, boot="b")
            assert not a.report(f"r{i}", s, seq=1, boot="b")  # idempotent
    merged, jmerged = agg.merged(), jagg.merged()
    assert json.dumps(merged, sort_keys=True) == json.dumps(jmerged, sort_keys=True)
    hist = merged["histograms"]["edl_serve_ttft_seconds"]
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert histogram_quantile(hist, q) == jax_quantile(hist, q)
        assert histogram_quantile(hist[""], q) == jax_quantile(hist[""], q)
    assert histogram_quantile(None, 0.5) is None
    agg.drop_source("r0")
    assert set(agg.sources()) == {"r1", "r2"}


def test_flight_recorder_digest_equals_the_jax_recorder():
    rec, jrec = FlightRecorder(), JaxRecorder()
    events = [("serve.drain", {"replica": "a", "phase": "start"}),
              ("serve.migrate", {"phase": "out", "migrated": 1}),
              ("serve.drain", {"replica": "a", "phase": "done", "drained": True})]
    for r in (rec, jrec):
        r.set_context(4, 2)
        for kind, data in events:
            r.record(kind, data, timing={"seconds": time.monotonic()})
    assert rec.digest() == jrec.digest()
    # order-independent: the same multiset in another order
    other = FlightRecorder()
    other.set_context(4, 2)
    for kind, data in reversed(events):
        other.record(kind, data)
    assert other.digest() == rec.digest()
    assert [e.to_dict()["kind"] for e in rec.events_since(1)] == ["serve.migrate", "serve.drain"]


# -- the fallback ladder, rung by rung ---------------------------------------------


def _case(pair, at=4, dest_engine=None, before=None):
    """One migration of PROMPT at token ``at`` toward a receiver on
    ``dest_engine`` (the pair's survivor by default).  ``before(db)``
    plants a fault after the batchers start.  Returns (summary, tokens,
    events, survivor prefills)."""
    src, dst = pair
    dst = dest_engine or dst
    sb = TokenContinuousBatcher(src, refresh=False).start()
    db = TokenContinuousBatcher(dst, refresh=False).start()
    recv = MigrationReceiver(dst, db).start()
    events = []
    try:
        undo = before(db) if before else None
        t = _submit_held(sb, at, events=events)
        sb.close_admission()
        s = migrate_out(src, sb, f"tcp://127.0.0.1:{recv.port}")
        if undo:
            undo()
        tokens, _ = t.result(timeout=60)
        prefills = db.stats["prefills"]
    finally:
        sb.stop()
        db.stop()
        recv.stop()
    assert src.pool.used_blocks == 0, "source leaked KV blocks"
    assert dst.pool.used_blocks == 0, "survivor leaked KV blocks"
    return s, tokens, events, prefills


def test_torn_push_falls_back_to_a_cold_prefill(pair, reference, monkeypatch):
    """The push's socket closes mid-leaf: the survivor frees its grant,
    and the sequence re-prefills cold there (a restart event voids the
    streamed tokens)."""
    real_open = migrate._open
    calls = []

    class Torn:
        def __init__(self, sock):
            self.sock = sock

        def sendall(self, data):
            if len(data) >= 4096:  # the first leaf's payload: cut it
                self.sock.sendall(bytes(data)[: len(data) // 2])
                self.sock.close()
                raise OSError("planted: connection closed mid-leaf")
            self.sock.sendall(data)

        def __getattr__(self, name):
            return getattr(self.sock, name)

    def opener(host, port, timeout):
        sock = real_open(host, port, timeout)
        calls.append(port)
        return Torn(sock) if len(calls) == 1 else sock

    monkeypatch.setattr(migrate, "_open", opener)
    with telemetry.scoped() as (_, rec):
        s, tokens, events, prefills = _case(pair)
        aborted = [e for e in rec.events() if e.data.get("outcome") == "aborted"]
    assert (s["fallback"], s["migrated"], s["failed"]) == (1, 0, 0)
    assert sum(1 for e in events if e.get("restart")) == 1
    assert prefills == 1 and len(calls) == 2 and aborted
    assert tokens == reference


def test_survivor_pool_too_small_is_refused_at_the_offer_then_cold(pair, reference):
    """The survivor cannot grant the blocks: refused before any byte
    moves; the sequence requeues cold and prefills once blocks free."""
    held = []

    def hog(db):
        pool = db.engine.pool
        held.extend(pool.alloc(pool.free_blocks))
        return lambda: pool.free(held)

    with telemetry.scoped() as (_, rec):
        s, tokens, _, prefills = _case(pair, before=hog)
        reasons = [e.data.get("reason") for e in rec.events() if e.kind == "serve.migrate"]
    assert (s["fallback"], s["bytes"]) == (1, 0)
    assert "kv_exhausted" in reasons
    assert prefills == 1 and tokens == reference


def test_weights_skew_is_refused_and_never_mixed(pair, port_sd):
    """A survivor on other weights refuses the KV offer: the sequence
    re-prefills cold under the survivor's weights, and its tokens are
    the survivor's own run, never a mix."""
    sd2 = {k: v * 1.5 if k == "embed.weight" else v for k, v in port_sd.items()}
    skew = _port_engine(sd2, step=2)
    with telemetry.scoped():
        want = _generate(skew)
        s, tokens, _, prefills = _case(pair, dest_engine=skew)
    assert (s["fallback"], s["migrated"], s["bytes"]) == (1, 0, 0)
    assert prefills == 1 and tokens == want


def test_swap_between_grant_and_adoption_reprefills(pair, port_sd, reference):
    """The wire transfer is clean, but a weight swap lands between the
    import and the adoption: the worker's check at the token boundary
    sends the sequence to a cold re-prefill (a restart event, never a
    token computed under other weights than its prefix)."""
    dst = pair[1]
    real = dst.import_kv
    swapped = []

    def import_then_swap(ids, k, v):
        real(ids, k, v)
        swapped.append(dst.install(port_sd, step=7))  # same values, new step

    dst.import_kv = import_then_swap
    try:
        with telemetry.scoped():
            s, tokens, events, prefills = _case(pair)
    finally:
        del dst.import_kv
        dst.install(port_sd, step=0)
    assert swapped and s["migrated"] == 1
    assert sum(1 for e in events if e.get("restart")) == 1
    assert prefills == 1 and tokens == reference


def test_unreachable_survivor_readmits_locally(pair, reference):
    src = pair[0]
    with telemetry.scoped():
        sb = TokenContinuousBatcher(src, refresh=False).start()
        events = []
        try:
            t = _submit_held(sb, 4, events=events)
            sb.close_admission()
            s = migrate_out(src, sb, "tcp://127.0.0.1:9")
            assert (s["failed"], s["migrated"]) == (1, 0)
            assert not t.migrated  # back on the local books
            tokens, meta = t.result(timeout=60)
        finally:
            sb.stop()
    assert tokens == reference and meta["restarts"] == 1
    assert any(e.get("restart") for e in events)
    assert src.pool.used_blocks == 0


def _hold_worker(b, gate):
    """Park ``b``'s worker inside a call (a token callback blocked on
    ``gate``) where no freeze can reach it.  Returns the holding ticket."""
    held = threading.Event()

    def on_event(ev):
        if "token" in ev and not held.is_set():
            held.set()
            gate.wait(30)

    t = b.submit_generate({"tokens": PROMPT[:5]}, max_new_tokens=2, deadline_s=60.0,
                          on_event=on_event)
    assert held.wait(30), "the holding generation never streamed"
    return t


def test_source_worker_that_does_not_park_refuses_the_migration(pair, reference):
    """The source's worker is still inside a call when the freeze
    times out: ``frozen()`` raises before its body, ``migrate_out``
    refuses with nothing read or detached, and the sequence finishes
    locally, untouched."""
    src, dst = pair
    gate = threading.Event()
    with telemetry.scoped():
        sb = TokenContinuousBatcher(src, refresh=False).start()
        db = TokenContinuousBatcher(dst, refresh=False).start()
        recv = MigrationReceiver(dst, db).start()
        try:
            t = sb.submit_generate({"tokens": PROMPT}, max_new_tokens=N, deadline_s=60.0)
            holder = _hold_worker(sb, gate)
            sb.freeze_timeout = 0.2
            with pytest.raises(FreezeTimeoutError):
                with sb.frozen():
                    pytest.fail("the body ran without a parked worker")
            with pytest.raises(MigrationRefusedError, match="could not freeze"):
                migrate_out(src, sb, f"tcp://127.0.0.1:{recv.port}")
            gate.set()
            holder.result(timeout=60)
            tokens, meta = t.result(timeout=60)
            assert not t.migrated and meta["restarts"] == 0
            assert db.stats["prefills"] == 0 and dst.pool.used_blocks == 0
            with sb.frozen():  # the handshake still works afterwards
                pass
        finally:
            gate.set()
            sb.stop()
            db.stop()
            recv.stop()
    assert tokens == reference and src.pool.used_blocks == 0


def test_survivor_worker_that_does_not_park_refuses_the_import_then_cold(
    pair, reference
):
    """The survivor's worker is inside a call when the import would
    freeze it: the receiver refuses rather than write pools the call
    may be reading, frees its grant, and the sequence re-prefills cold
    there."""
    gate = threading.Event()
    holder = []

    def hold(db):
        db.freeze_timeout = 0.2
        holder.append(_hold_worker(db, gate))

        def release():
            gate.set()
            holder[0].result(timeout=60)

        return release

    try:
        with telemetry.scoped() as (_, rec):
            s, tokens, events, prefills = _case(pair, before=hold)
            reasons = [e.data.get("reason") for e in rec.events() if e.kind == "serve.migrate"]
    finally:
        gate.set()
    assert (s["fallback"], s["migrated"], s["failed"]) == (1, 0, 0)
    assert "freeze_timeout" in reasons
    assert sum(1 for e in events if e.get("restart")) == 1
    assert prefills == 2 and tokens == reference  # the holder's and the cold one


def test_half_prefilled_sequence_is_requeued_cold(pair):
    """A sequence mid-chunking at the freeze streamed nothing: it
    requeues on the survivor as a cold prompt at once (its local blocks
    free the same moment), with no restart event."""
    src, dst = pair
    prompt = [int(x) for x in np.random.RandomState(11).randint(3, V, size=48)]
    with telemetry.scoped():
        want = _generate(dst, prompt, 8)
        # the worker is not started: the state the chunked scheduler
        # holds mid-prompt (one block written, 16 of 48 prefilled)
        sb = TokenContinuousBatcher(src, refresh=False)
        events = []
        t = sb.submit_generate({"tokens": prompt}, max_new_tokens=8, deadline_s=60.0,
                               on_event=events.append)
        with sb._cv:
            assert sb._queue.popleft() is t
            sb._queued_tokens -= len(prompt)
        got = src.pool.alloc(1)
        t.blocks = list(got)
        t.table = np.zeros(src.blocks_per_seq, np.int32)
        t.table[0] = got[0]
        t.prefilled = 16
        sb._prefilling.append(t)
        sb._prefilling_tokens += len(prompt) - 16
        db = TokenContinuousBatcher(dst, refresh=False).start()
        recv = MigrationReceiver(dst, db).start()
        try:
            s = migrate_out(src, sb, f"tcp://127.0.0.1:{recv.port}")
            assert (s["cold"], s["attempted"]) == (1, 1)
            assert src.pool.used_blocks == 0 and sb.in_flight == 0
            tokens, meta = t.result(timeout=60)
        finally:
            db.stop()
            recv.stop()
    assert tokens == want and meta["restarts"] == 0
    assert not any(e.get("restart") for e in events)
    assert dst.pool.used_blocks == 0


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_drain_with_migrate_to_acks_before_a_long_generation_ends(pair, port_sd):
    """POST /drain {"migrate_to": survivor}: the ack comes back with 0
    in flight while the generation is still decoding on the survivor;
    the caller's stream on the drained replica goes on through the
    relay, with no restart and no drop; the drain is journaled start
    and done, and the survivor advertises GET /migrate."""
    from edl_tpu_torch.serving import ContinuousBatcher, ServingServer

    src, dst = pair
    n = 400  # the 64-token context ends the generation first
    with telemetry.scoped() as (reg, rec):
        want = _generate(src, PROMPT, n)
        reps = []
        for eng, rid in ((src, "victim"), (dst, "survivor")):
            server = ServingServer(ContinuousBatcher(eng), port=0)
            gen = TokenContinuousBatcher(eng, refresh=False)
            reps.append(ServingReplica(eng, server=server, gen_batcher=gen, replica_id=rid,
                                       heartbeat_interval=60.0, telemetry_interval=0).start())
        victim, survivor = reps
        try:
            base = f"http://127.0.0.1:{survivor.server.port}"
            with urllib.request.urlopen(f"{base}/migrate", timeout=10) as r:
                info = json.loads(r.read())
            assert info == {"migrate_port": survivor.migration.port, "accepting": True}
            # slow every decode step of the victim's worker, so the
            # generation is far from done when the drain lands
            real = src.decode_step
            src.decode_step = lambda *a: (time.sleep(0.02), real(*a))[1]
            events = []
            t = victim.gen_batcher.submit_generate(
                {"tokens": PROMPT}, max_new_tokens=n, deadline_s=120.0, on_event=events.append)
            _wait(lambda: len(t.tokens) >= 3, what="tokens before the drain")
            ack = _post(f"http://127.0.0.1:{victim.server.port}/drain",
                        {"budget_ms": 30000, "migrate_to": base})
            at_ack = len(t.tokens)
            del src.decode_step
            assert ack["drained"] and ack["in_flight"] == 0
            assert ack["progress"] == {"total": 1, "migrated": 1, "remaining": 0}
            assert ack["migrate"]["migrated"] == 1 and ack["migrate"]["bytes"] > 0
            tokens, meta = t.result(timeout=60)
        finally:
            for r in reps:
                r.stop()
            src.__dict__.pop("decode_step", None)
        assert at_ack < len(want) and meta["migrated"] is True
        assert tokens == want and not any(e.get("restart") for e in events)
        assert [e["i"] for e in events if "token" in e] == list(range(len(want)))
        phases = [e.data["phase"] for e in rec.events() if e.kind == "serve.drain"]
        assert phases == ["start", "done"]
        assert reg.counter("edl_serve_drains_total").value() == 1


def test_drain_missing_its_budget_is_retried_with_its_progress(pair):
    src, dst = pair
    with telemetry.scoped():
        victim = ServingReplica(src, replica_id="victim", heartbeat_interval=60.0,
                                telemetry_interval=0,
                                gen_batcher=TokenContinuousBatcher(src, refresh=False)).start()
        db = TokenContinuousBatcher(dst, refresh=False).start()
        recv = MigrationReceiver(dst, db).start()
        real = src.decode_step
        src.decode_step = lambda *a: (time.sleep(0.01), real(*a))[1]
        try:
            tickets = [victim.gen_batcher.submit_generate(
                {"tokens": PROMPT[i:]}, max_new_tokens=40, deadline_s=120.0) for i in range(2)]
            _wait(lambda: all(t.tokens for t in tickets), what="both generations in flight")
            r1 = victim.drain(budget_s=0.001)
            assert not r1["drained"]
            assert r1["progress"]["total"] == 2 and r1["progress"]["remaining"] >= 1
            r2 = victim.drain(budget_s=60.0, migrate_to=f"tcp://127.0.0.1:{recv.port}")
            assert r2["drained"]
            assert r2["progress"]["total"] == 2 and r2["progress"]["remaining"] == 0
            assert r2["progress"]["migrated"] >= 1
            for t in tickets:
                tokens, _ = t.result(timeout=60)
                assert len(tokens) == 40
        finally:
            del src.decode_step
            victim.stop()
            db.stop()
            recv.stop()
    assert src.pool.used_blocks == 0 and dst.pool.used_blocks == 0


# -- the dispatch watchdog ---------------------------------------------------------


def test_wedged_dispatch_rebuilds_the_pool_and_live_sequences_reprefill(port_sd, reference):
    wedged = []
    with telemetry.scoped() as (reg, rec):
        eng = _port_engine(port_sd, dispatch_timeout=0.5)
        real = eng.spec.decode_fn

        def decode_fn(*a):
            if not wedged:
                wedged.append(time.monotonic())
                time.sleep(1.5)  # past the deadline: the watchdog abandons it
            return real(*a)

        eng.spec = dataclasses.replace(eng.spec, decode_fn=decode_fn)
        b = TokenContinuousBatcher(eng, refresh=False).start()
        try:
            events = []
            t = b.submit_generate({"tokens": PROMPT}, max_new_tokens=N, deadline_s=60.0,
                                  on_event=events.append)
            tokens, meta = t.result(timeout=60)
        finally:
            b.stop()
        assert wedged and eng.cache_epoch == 1
        assert reg.counter("edl_serve_dispatch_wedged_total").value() == 1
        assert [e.kind for e in rec.events()].count("serve.watchdog") == 1
        assert reg.counter("edl_consensus_watchdog_trips_total").value() == 0
    assert tokens == reference and meta["restarts"] == 1
    assert sum(1 for e in events if e.get("restart")) == 1
    assert eng.pool.used_blocks == 0
    assert issubclass(DispatchWedgedError, RuntimeError)
