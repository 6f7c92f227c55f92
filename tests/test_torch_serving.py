"""The port's serving slice as a whole, on the CPU.

The port's ``DecodeEngine`` + ``TokenContinuousBatcher`` (monolithic
prefill) serve the tiny ``transformer_lm`` with float32 weights carried
over from a flax init.  The greedy tokens must equal, exactly:

- the JAX package's ``prefill_fn`` / ``decode_fn`` reference loop on
  the same weights (the pool layout of ``tests/test_decode_serving.py``),
- the port's own full-recompute greedy loop through ``predict_fn``
  (the KV-cache correctness anchor).

Then the admission semantics (429, 400), join/leave at token
boundaries with every KV block freed, a weight swap mid-generation,
and the HTTP front (``/generate`` plain and streaming, ``/predict``,
``/healthz``, ``/metrics``) over loopback.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models.transformer_lm import TransformerLM as FlaxLM
from edl_tpu.models.transformer_lm import lm_decode_spec as jax_decode_spec
from edl_tpu_torch import telemetry
from edl_tpu_torch.convert import params_from_flax
from edl_tpu_torch.models import get_model
from edl_tpu_torch.serving import (
    BlockOwnershipError,
    ContinuousBatcher,
    DecodeEngine,
    KVBlockPool,
    PromptTooLongError,
    QueueFullError,
    ServingServer,
    TokenContinuousBatcher,
)

V, D, FF, H, LAYERS, L = 256, 64, 256, 4, 2, 64
BT = 16
PROMPT_LENS = (5, 17, 30, 40)
MAX_NEW = 8


@pytest.fixture(scope="module")
def lm():
    """flax f32 module + two param sets (seed 0 and 1), their converted
    state_dicts, and jitted JAX prefill/decode."""
    fm = FlaxLM(V, D, FF, H, LAYERS, L, dtype=jnp.float32)
    sample = jnp.zeros((1, L), jnp.int32)
    params = [fm.init(jax.random.key(s), sample)["params"] for s in (0, 1)]
    sds = [params_from_flax(jax.tree_util.tree_map(np.asarray, p)) for p in params]
    spec = jax_decode_spec(fm, H, D, L)
    return {
        "params": params,
        "sds": sds,
        "prefill": jax.jit(spec.prefill_fn),
        "decode": jax.jit(spec.decode_fn),
        "model": get_model("transformer_lm", tiny=True, dtype=torch.float32),
    }


def _prompts():
    rng = np.random.RandomState(7)
    return [rng.randint(3, V, size=n).astype(np.int32) for n in PROMPT_LENS]


def _jax_reference(lm, which, prompt, n, engine):
    """Greedy tokens through the JAX prefill/decode functions on a fresh
    single-sequence pool (``tests/test_decode_serving.py``'s layout),
    padded to the engine's prompt bucket."""
    mb = engine.blocks_per_seq
    kp = jnp.zeros((LAYERS, mb + 1, BT, H, D // H), jnp.float32)
    vp = jnp.zeros_like(kp)
    tab = np.arange(1, mb + 1, dtype=np.int32)[None]
    plen = len(prompt)
    tok = np.zeros((1, engine.prompt_bucket_for(plen)), np.int32)
    tok[0, :plen] = prompt
    params = lm["params"][which]
    ids, kp, vp = lm["prefill"](params, tok, np.asarray([plen], np.int32), kp, vp, tab)
    out = [int(ids[0])]
    ln = np.asarray([plen], np.int32)
    while len(out) < n:
        ids, kp, vp = lm["decode"](params, np.asarray([out[-1]], np.int32), ln, kp, vp, tab)
        out.append(int(ids[0]))
        ln = ln + 1
    return out


def _full_recompute(model, params, prompt, n):
    """The port's greedy loop that recomputes the whole prefix through
    ``predict_fn`` for every token (no KV cache)."""
    seq = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            row = torch.zeros((1, L + 1), dtype=torch.int32)
            row[0, : len(seq)] = torch.tensor(seq)
            ids = model.predict_fn(params, {"tokens": row})["tokens"]
            seq.append(int(ids[0, len(seq) - 1]))
    return seq[len(prompt):]


def _engine(lm, which=0, **kw):
    eng = DecodeEngine(lm["model"], device="cpu", max_seqs=4, block_tokens=BT, **kw)
    eng.install(lm["sds"][which], step=which)
    return eng


def test_served_tokens_equal_jax_reference_and_full_recompute(lm):
    with telemetry.scoped():
        eng = _engine(lm)
        gen = TokenContinuousBatcher(eng, chunked_prefill=False).start()
        try:
            tickets = [
                gen.submit_generate({"tokens": p.tolist()}, max_new_tokens=MAX_NEW)
                for p in _prompts()
            ]
            served = [t.result(timeout=60)[0] for t in tickets]
        finally:
            gen.stop()
    w = eng.current_weights()
    for prompt, toks in zip(_prompts(), served):
        assert len(toks) == MAX_NEW
        assert toks == _jax_reference(lm, 0, prompt, MAX_NEW, eng)
        assert toks == _full_recompute(lm["model"], w.params, prompt, MAX_NEW)
    # the seeded weights are not degenerate: the streams differ
    assert len({tuple(t) for t in served}) > 1
    assert eng.pool.used_blocks == 0


def test_join_and_leave_at_token_boundaries_free_every_block(lm):
    """Requests with different budgets leave at different iterations; a
    late request joins a running batch; all blocks come back."""
    with telemetry.scoped():
        eng = _engine(lm)
        gen = TokenContinuousBatcher(eng, chunked_prefill=False)
        prompts = _prompts()
        budgets = (2, 9, 5, 12)
        late = {}

        def join_late(ev):
            # arrives while the first wave is mid-generation
            if ev.get("i") == 3 and not late:
                late["t"] = gen.submit_generate(
                    {"tokens": prompts[0].tolist()}, max_new_tokens=4
                )

        tickets = [
            gen.submit_generate(
                {"tokens": p.tolist()}, max_new_tokens=n,
                on_event=join_late if i == 1 else None,
            )
            for i, (p, n) in enumerate(zip(prompts, budgets))
        ]
        gen.start()
        try:
            out = [t.result(timeout=60)[0] for t in tickets]
            late_toks = late["t"].result(timeout=60)[0]
        finally:
            gen.stop()
        assert [len(t) for t in out] == list(budgets)
        # tokens are batch-invariant: equal to the sequence served alone
        assert late_toks == out[0][:2] + late_toks[2:]
        assert late_toks == _jax_reference(lm, 0, prompts[0], 4, eng)
        # one decode iteration served several sequences at once
        total = sum(budgets) + 4
        assert gen.stats["iterations"] < total - len(budgets) - 1
        assert eng.pool.used_blocks == 0
        assert gen.active_count == 0 and gen.depth == 0


def test_new_weights_mid_generation_restart_on_the_new_generation(lm):
    """Installing weights while a sequence decodes: it re-prefills on
    the new generation (a restart event, its earlier tokens void) and
    its final tokens are the new weights' reference."""
    with telemetry.scoped():
        eng = _engine(lm, which=0)
        gen = TokenContinuousBatcher(eng, chunked_prefill=False)
        events = []

        def swap_once(ev):
            events.append(ev)
            if ev.get("i") == 2 and eng.weights_generation == 1:
                eng.install(lm["sds"][1], step=1)

        prompt = _prompts()[2]
        t = gen.submit_generate({"tokens": prompt.tolist()}, max_new_tokens=6,
                                on_event=swap_once)
        gen.start()
        try:
            toks, meta = t.result(timeout=60)
        finally:
            gen.stop()
    assert any(ev.get("restart") for ev in events)
    assert meta["restarts"] == 1 and meta["weights_generation"] == 2
    assert meta["weights_step"] == 1
    assert toks == _jax_reference(lm, 1, prompt, 6, eng)
    assert eng.pool.used_blocks == 0


def test_queue_full_and_prompt_too_long_at_admission(lm):
    with telemetry.scoped():
        eng = _engine(lm)
        gen = TokenContinuousBatcher(eng, queue_limit=1, chunked_prefill=False)
        gen.submit_generate({"tokens": [5, 6, 7]})
        with pytest.raises(QueueFullError) as e:
            gen.submit_generate({"tokens": [5, 6, 7]})
        assert e.value.retry_after > 0
        with pytest.raises(PromptTooLongError):
            eng.coerce_prompt({"tokens": [4] * eng.max_context})
        with pytest.raises(ValueError, match="token ids"):
            eng.coerce_prompt({"tokens": [V]})
        # the JAX batcher's defaults: chunked prefill with the prefix
        # cache when the model declares a chunk_fn; the cache needs it
        default = TokenContinuousBatcher(eng)
        assert default.chunked_prefill and default.prefix is not None
        assert gen.prefix is None
        with pytest.raises(ValueError, match="chunked"):
            TokenContinuousBatcher(eng, chunked_prefill=False, prefix_cache=True)
        gen.stop()


def test_kv_pool_all_or_nothing_refcounts_and_double_free():
    pool = KVBlockPool(2, 4, 16, num_blocks=5, block_tokens=16,
                       dtype=torch.float32, device="cpu")
    assert pool.usable_blocks == 4 and pool.free_blocks == 4
    a = pool.alloc(3)
    assert a is not None and 0 not in a
    assert pool.alloc(2) is None  # only 1 left: no partial grant
    pool.ref(a[0])
    assert pool.refcount(a[0]) == 2
    pool.free(a)
    assert pool.used_blocks == 1  # a[0] still has one owner
    pool.free([a[0]])
    assert pool.used_blocks == 0
    with pytest.raises(BlockOwnershipError):
        pool.free([a[1]])
    with pytest.raises(ValueError):
        pool.free([0])


def _post(url, body, timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    return urllib.request.urlopen(req, timeout=timeout)


def test_http_generate_plain_and_streaming_predict_healthz(lm):
    with telemetry.scoped():
        eng = _engine(lm)
        batcher = ContinuousBatcher(eng).start()
        gen = TokenContinuousBatcher(eng, chunked_prefill=False).start()
        server = ServingServer(batcher, port=0, gen_batcher=gen).start()
        base = f"http://127.0.0.1:{server.port}"
        try:
            prompts = _prompts()
            results = {}

            def plain():
                with _post(base + "/generate",
                           {"inputs": {"tokens": prompts[1].tolist()},
                            "max_new_tokens": MAX_NEW}) as r:
                    results["plain"] = json.loads(r.read())

            th = threading.Thread(target=plain)
            th.start()
            with _post(base + "/generate",
                       {"inputs": {"tokens": prompts[3].tolist()},
                        "max_new_tokens": MAX_NEW, "stream": True}) as r:
                assert r.headers["Content-Type"] == "application/x-ndjson"
                lines = [json.loads(x) for x in r.read().decode().splitlines() if x]
            th.join(timeout=60)
            assert not th.is_alive()
            streamed = [ev["token"] for ev in lines if "token" in ev]
            assert lines[-1]["done"] and lines[-1]["tokens"] == streamed
            assert streamed == _jax_reference(lm, 0, prompts[3], MAX_NEW, eng)
            assert results["plain"]["tokens"] == _jax_reference(
                lm, 0, prompts[1], MAX_NEW, eng
            )
            assert results["plain"]["ttft_ms"] is not None

            with _post(base + "/predict", {"inputs": {"tokens": [prompts[0].tolist()]}}) as r:
                pred = json.loads(r.read())
            assert np.asarray(pred["outputs"]["tokens"]).shape == (1, L)

            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + "/generate", {"inputs": {"tokens": [4] * L}})
            assert e.value.code == 400

            with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
                health = json.loads(r.read())
            assert health["ok"] and health["device"] == "cpu"
            assert health["decode"]["chunked_prefill"] is False
            with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
                metrics = r.read().decode()
            assert "edl_serve_tokens_total" in metrics
            assert 'edl_serve_requests_total{status="ok"}' in metrics
            assert eng.pool.used_blocks == 0
        finally:
            server.stop()
            gen.stop()
            batcher.stop()


def test_http_queue_full_is_429_with_retry_after(lm):
    with telemetry.scoped():
        eng = _engine(lm)
        batcher = ContinuousBatcher(eng, queue_limit=1)  # not started: fills
        gen = TokenContinuousBatcher(eng, queue_limit=1, chunked_prefill=False)
        server = ServingServer(batcher, port=0, gen_batcher=gen).start()
        base = f"http://127.0.0.1:{server.port}"
        try:
            gen.submit_generate({"tokens": [5, 6]})
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + "/generate", {"inputs": {"tokens": [5, 6]}})
            assert e.value.code == 429
            assert float(e.value.headers["Retry-After"]) > 0
        finally:
            server.stop()
            gen.stop()
            batcher.stop()
