"""Chunked prefill in the port, on the CPU, against the JAX package.

- ``write_chunk_kv`` and ``paged_chunk_attention`` against the JAX
  functions on the same numpy-seeded float32 inputs (1e-5);
- ``chunk_fn`` against the JAX ``chunk_fn`` on weights carried over
  with ``convert.py``: ids equal, pools within 2e-2 of their scale in
  bf16 (the bf16 rounding of ``tests/test_torch_transformer_lm.py``);
- the chunked first token equals monolithic prefill's per prompt;
- the scheduler: chunk-boundary prompts, the context cap at admission,
  a long admission beside a running decode, a weight swap mid-chunking,
  expiry of a half-prefilled sequence, the final chunk at the context
  edge, and a failed chunk that loses the cache (the epoch rewind);
- the JAX and port ``TokenContinuousBatcher`` in chunked posture give
  the same tokens and the same chunk count on the same prompts.

The tiny ``transformer_lm`` (2 layers, d_model 64, vocab 256, context
64) with 8-token blocks and a 16-token chunk cap, so short prompts take
several chunks.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.checkpoint import HostDRAMStore as JaxStore
from edl_tpu.models.base import get_model as jax_get_model
from edl_tpu.models.decode import paged_chunk_attention as jax_chunk_attention
from edl_tpu.models.decode import write_chunk_kv as jax_write_chunk_kv
from edl_tpu.models.transformer_lm import TransformerLM as FlaxLM
from edl_tpu.models.transformer_lm import lm_decode_spec as jax_decode_spec
from edl_tpu.runtime.train import TrainState as JaxTrainState
from edl_tpu.serving import DecodeEngine as JaxDecodeEngine
from edl_tpu.serving import TokenContinuousBatcher as JaxBatcher
from edl_tpu_torch import telemetry
from edl_tpu_torch.convert import params_from_flax
from edl_tpu_torch.models import get_model
from edl_tpu_torch.models.decode import paged_chunk_attention, write_chunk_kv
from edl_tpu_torch.serving import (
    DeadlineExceededError,
    DecodeEngine,
    PromptTooLongError,
    TokenContinuousBatcher,
)

V, D, FF, H, LAYERS, L = 256, 64, 256, 4, 2, 64
BT, CHUNK = 8, 16
F32_TOL = 1e-5
BF16_TOL = 2e-2


def _close(got, want, rtol):
    """``rtol`` of the reference's largest magnitude, elementwise."""
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol, atol=rtol * scale)


@pytest.fixture(scope="module")
def lm():
    """Flax params for seeds 0 and 1, their state_dicts, the JAX decode
    spec per dtype, and the port's f32 model."""
    f32 = FlaxLM(V, D, FF, H, LAYERS, L, dtype=jnp.float32)
    bf16 = FlaxLM(V, D, FF, H, LAYERS, L, dtype=jnp.bfloat16)
    sample = jnp.zeros((1, L), jnp.int32)
    params = [f32.init(jax.random.key(s), sample)["params"] for s in (0, 1)]
    sds = [params_from_flax(jax.tree_util.tree_map(np.asarray, p)) for p in params]
    return {
        "params": params,
        "sds": sds,
        "jspec": {"f32": jax_decode_spec(f32, H, D, L), "bf16": jax_decode_spec(bf16, H, D, L)},
        "model": get_model("transformer_lm", tiny=True, dtype=torch.float32),
    }


def _engine(lm, which=0, **kw):
    kw.setdefault("max_chunk_tokens", CHUNK)
    eng = DecodeEngine(lm["model"], device="cpu", max_seqs=4, block_tokens=BT, **kw)
    eng.install(lm["sds"][which], step=which)
    return eng


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(3, V, size=n).astype(np.int32)


def _reference(eng, params, prompt, n):
    """Greedy tokens through the port's monolithic prefill and decode on
    a fresh single-sequence pool, padded to the engine's prompt bucket
    (the pure function a served sequence must equal)."""
    spec = eng.spec
    mb = eng.blocks_per_seq
    shape = (spec.layers, mb + 1, BT, spec.heads, spec.head_dim)
    kp, vp = torch.zeros(shape), torch.zeros(shape)
    tab = torch.arange(1, mb + 1, dtype=torch.int32)[None]
    plen = len(prompt)
    tok = torch.zeros((1, eng.prompt_bucket_for(plen)), dtype=torch.int32)
    tok[0, :plen] = torch.from_numpy(np.asarray(prompt, np.int32))
    ln = torch.tensor([plen], dtype=torch.int32)
    with torch.no_grad():
        ids, _, _ = spec.prefill_fn(params, tok, ln, kp, vp, tab)
        out = [int(ids[0])]
        while len(out) < n:
            ids, _, _ = spec.decode_fn(
                params, torch.tensor([out[-1]], dtype=torch.int32), ln, kp, vp, tab
            )
            out.append(int(ids[0]))
            ln = ln + 1
    return out


def _chunked_first_token(eng, weights, prompt):
    """Drive ``prefill_chunk`` over the prompt (non-final chunks
    block-aligned) and return the last chunk's id."""
    table = np.zeros(eng.blocks_per_seq, np.int32)
    blocks, off, first = [], 0, None
    while off < len(prompt):
        clen = min(eng.max_chunk_tokens, len(prompt) - off)
        if len(prompt) - off > clen:
            clen = (clen // BT) * BT
        need = (off + eng.chunk_bucket_for(clen)) // BT - len(blocks)
        for b in eng.pool.alloc(need) if need > 0 else []:
            table[len(blocks)] = b
            blocks.append(b)
        first = eng.prefill_chunk(weights, prompt[off:off + clen], off, table)
        off += clen
    eng.pool.free(blocks)
    return first


# -- the paged primitives ----------------------------------------------------


def test_write_chunk_kv_and_paged_chunk_attention_match_jax():
    rng = np.random.RandomState(0)
    nb, bt, h, d, b, c, mb = 7, 4, 2, 8, 2, 8, 4
    kpool = rng.randn(nb, bt, h, d).astype(np.float32)
    vpool = rng.randn(nb, bt, h, d).astype(np.float32)
    tables = np.asarray([[1, 2, 3, 0], [4, 5, 6, 0]], np.int32)
    offsets = np.asarray([0, 4], np.int32)  # row 1: one block already filled
    k = rng.randn(b, c, h, d).astype(np.float32)
    v = rng.randn(b, c, h, d).astype(np.float32)
    q = rng.randn(b, c, h, d).astype(np.float32)
    jk, jv = jax_write_chunk_kv(jnp.asarray(kpool), jnp.asarray(vpool), tables, offsets, k, v)
    tk, tv = write_chunk_kv(
        torch.from_numpy(kpool.copy()), torch.from_numpy(vpool.copy()),
        torch.from_numpy(tables), torch.from_numpy(offsets),
        torch.from_numpy(k), torch.from_numpy(v),
    )
    _close(tk.numpy(), jk, F32_TOL)
    _close(tv.numpy(), jv, F32_TOL)
    want = jax_chunk_attention(q, jk, jv, tables[:, :mb], offsets)
    got = paged_chunk_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(tables[:, :mb]), torch.from_numpy(offsets)
    )
    assert got.dtype == torch.float32 and got.shape == (b, c, h, d)
    _close(got.numpy(), want, F32_TOL)


def test_chunk_fn_matches_jax_chunk_fn(lm):
    """A 29-token prompt as chunks of 16 and 13 (the last padded to its
    bucket) through both ``chunk_fn``s in bf16: each chunk's id equal,
    the pools within 2e-2 of their scale."""
    jspec = lm["jspec"]["bf16"]
    model = get_model("transformer_lm", tiny=True)  # bf16, as served
    spec = model.decode
    bound = model.bind_params(lm["sds"][0], "cpu")
    mb = L // BT
    shape = (spec.layers, mb + 1, BT, spec.heads, spec.head_dim)
    jk = jnp.zeros(shape, jnp.bfloat16)
    jv = jnp.zeros_like(jk)
    tk = torch.zeros(shape, dtype=torch.bfloat16)
    tv = torch.zeros(shape, dtype=torch.bfloat16)
    table = np.arange(1, mb + 1, dtype=np.int32)[None]
    prompt = _prompt(3, 29)
    jfn = jax.jit(jspec.chunk_fn)
    for off, clen, bucket in ((0, 16, 16), (16, 13, 16)):
        tok = np.zeros((1, bucket), np.int32)
        tok[0, :clen] = prompt[off:off + clen]
        offs = np.asarray([off], np.int32)
        lens = np.asarray([off + clen], np.int32)
        win = table[:, : (off + bucket) // BT]
        jids, jk, jv = jfn(lm["params"][0], tok, offs, lens, jk, jv, win)
        with torch.no_grad():
            tids, tk, tv = spec.chunk_fn(
                bound, torch.from_numpy(tok), torch.from_numpy(offs), torch.from_numpy(lens),
                tk, tv, torch.from_numpy(win),
            )
        assert int(tids[0]) == int(jids[0]), off
    _close(tk.float().numpy(), np.asarray(jk, np.float32), BF16_TOL)
    _close(tv.float().numpy(), np.asarray(jv, np.float32), BF16_TOL)


def test_chunked_first_token_equals_monolithic(lm):
    """Prompts at, below and above the chunk boundaries, and a
    multi-chunk one: the chunked first token equals monolithic
    prefill's, per prompt."""
    eng = _engine(lm)
    w = eng.current_weights()
    for plen in (15, 16, 17, 31, 32, 33, 50):
        prompt = _prompt(plen, plen)
        blocks = eng.pool.alloc(eng.prompt_bucket_for(plen) // BT)
        table = np.zeros(eng.blocks_per_seq, np.int32)
        table[: len(blocks)] = blocks
        mono = eng.prefill(w, prompt, table)
        eng.pool.free(blocks)
        assert _chunked_first_token(eng, w, prompt) == mono, plen
    assert eng.pool.used_blocks == 0


# -- the scheduler -----------------------------------------------------------


def test_chunk_boundary_prompts_end_to_end(lm):
    with telemetry.scoped():
        eng = _engine(lm)
        gen = TokenContinuousBatcher(eng, prefix_cache=False).start()
        try:
            for plen, want_chunks in ((15, 1), (16, 1), (17, 2), (33, 3)):
                prompt = _prompt(100 + plen, plen)
                toks, meta = gen.submit_generate(
                    {"tokens": prompt.tolist()}, max_new_tokens=4
                ).result(timeout=60)
                assert meta["prefill_chunks"] == want_chunks, plen
                params = eng.current_weights().params
                assert toks == _reference(eng, params, prompt, 4), plen
        finally:
            gen.stop()
    assert eng.pool.used_blocks == 0


def test_prompt_over_context_cap_typed_error_at_admission(lm):
    with telemetry.scoped():
        eng = _engine(lm)
        gen = TokenContinuousBatcher(eng)
        with pytest.raises(PromptTooLongError, match="max_prompt"):
            gen.submit_generate({"tokens": [5] * eng.max_context})
        assert isinstance(PromptTooLongError("x"), ValueError)  # HTTP 400
        assert gen.stats["chunks"] == 0 and eng.pool.used_blocks == 0
        gen.start()
        try:
            toks, _ = gen.submit_generate({"tokens": [5, 6, 7]}, max_new_tokens=2).result(timeout=60)
            assert len(toks) == 2
        finally:
            gen.stop()


def test_long_admission_never_stalls_running_decode(lm):
    """While a 48-token prompt prefills in 16-token chunks, an already
    running sequence keeps emitting tokens, and neither output changes."""
    with telemetry.scoped():
        eng = _engine(lm)
        gen = TokenContinuousBatcher(eng, prefill_token_budget=16).start()
        short, long = _prompt(7, 5), _prompt(8, 48)
        events = []
        try:
            ta = gen.submit_generate(
                {"tokens": short.tolist()}, max_new_tokens=40,
                on_event=lambda e: events.append(("a", time.monotonic(), e)),
            )
            deadline = time.monotonic() + 30
            while not any("token" in e for _, _, e in events):
                assert time.monotonic() < deadline
                time.sleep(0.002)
            tl = gen.submit_generate(
                {"tokens": long.tolist()}, max_new_tokens=3,
                on_event=lambda e: events.append(("l", time.monotonic(), e)),
            )
            toks_l, meta_l = tl.result(timeout=60)
            toks_a, _ = ta.result(timeout=60)
        finally:
            gen.stop()
    assert meta_l["prefill_chunks"] == 3
    t_first = next(t for who, t, e in events if who == "l" and "token" in e)
    t_admit = next(t for who, t, e in events if who == "a" and "token" in e)
    interleaved = sum(1 for who, t, e in events if who == "a" and "token" in e and t_admit < t < t_first)
    assert interleaved >= 2, "the running batch stalled behind the admission"
    params = eng.current_weights().params
    assert toks_l == _reference(eng, params, long, 3)
    assert toks_a == _reference(eng, params, short, 40)
    assert eng.pool.used_blocks == 0


def test_hot_swap_mid_chunking_restarts_from_zero(lm):
    """New weights while a prompt is half prefilled: its chunking starts
    over on them (2 chunks before, 3 after) and its tokens are the new
    weights' reference."""
    with telemetry.scoped():
        eng = _engine(lm)
        gen = TokenContinuousBatcher(eng, prefill_token_budget=16)
        real = eng.prefill_chunk
        swapped = []

        def swapping_chunk(weights, chunk, offset, table_row):
            if offset == 16 and not swapped:
                swapped.append(True)
                eng.install(lm["sds"][1], step=1)
            return real(weights, chunk, offset, table_row)

        eng.prefill_chunk = swapping_chunk
        prompt = _prompt(11, 48)
        gen.start()
        try:
            toks, meta = gen.submit_generate(
                {"tokens": prompt.tolist()}, max_new_tokens=4
            ).result(timeout=60)
        finally:
            gen.stop()
    assert swapped and meta["weights_step"] == 1
    assert meta["prefill_chunks"] == 5 and meta["restarts"] == 0
    assert toks == _reference(eng, eng.current_weights().params, prompt, 4)
    assert eng.pool.used_blocks == 0


def test_expiry_frees_blocks_of_half_prefilled_sequence(lm):
    with telemetry.scoped():
        eng = _engine(lm)
        real = eng.prefill_chunk

        def slow_chunk(*a):
            time.sleep(0.05)
            return real(*a)

        eng.prefill_chunk = slow_chunk
        gen = TokenContinuousBatcher(eng, prefill_token_budget=16).start()
        try:
            t = gen.submit_generate({"tokens": _prompt(13, 48).tolist()}, deadline_s=0.08)
            with pytest.raises(DeadlineExceededError):
                t.result(timeout=30)
            deadline = time.monotonic() + 10
            while eng.pool.used_blocks and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            gen.stop()
    assert eng.pool.used_blocks == 0
    assert gen.queued_prefill_tokens == 0


def test_final_chunk_near_context_edge_cannot_overflow_table(lm):
    """With a 32-token chunk cap, a 57-token prompt's chunk at offset 40
    would bucket to 32 and run past the 64-token window: the engine
    refuses such a chunk loudly and the scheduler caps each chunk to the
    room left (32 @ 0, 8 @ 32 the budget's tail, 16 @ 40, 1 @ 56)."""
    with telemetry.scoped():
        eng = _engine(lm, max_chunk_tokens=32)
        with pytest.raises(ValueError, match="overruns"):
            eng.prefill_chunk(eng.current_weights(), np.zeros(17, np.int32), 40,
                              np.zeros(eng.blocks_per_seq, np.int32))
        gen = TokenContinuousBatcher(eng, prefill_token_budget=40, prefix_cache=False).start()
        prompt = _prompt(23, 57)
        try:
            toks, meta = gen.submit_generate({"tokens": prompt.tolist()}, max_new_tokens=3).result(timeout=60)
        finally:
            gen.stop()
    assert meta["prefill_chunks"] == 4, meta
    assert toks == _reference(eng, eng.current_weights().params, prompt, 3)
    assert eng.pool.used_blocks == 0 and gen.queued_prefill_tokens == 0


def test_failed_chunk_loses_the_cache_and_live_sequences_reprefill(lm):
    """A chunk call that raises rebuilds the pool (its in-place writes
    may be half done) and bumps ``cache_epoch``: that request fails, and
    a sequence already decoding restarts on the fresh cache and still
    finishes with its reference tokens."""
    with telemetry.scoped():
        eng = _engine(lm)
        gen = TokenContinuousBatcher(eng, prefill_token_budget=16)
        spec = eng.spec
        real = spec.chunk_fn
        calls = {"n": 0}

        def failing(params, tokens, offsets, *rest):
            calls["n"] += 1
            if int(offsets[0]) == 16 and calls.setdefault("failed", 0) == 0:
                calls["failed"] = 1
                raise RuntimeError("injected chunk failure")
            return real(params, tokens, offsets, *rest)

        eng.spec = dataclasses.replace(spec, chunk_fn=failing)
        short, long = _prompt(31, 5), _prompt(32, 40)
        gen.start()
        try:
            ta = gen.submit_generate({"tokens": short.tolist()}, max_new_tokens=12)
            deadline = time.monotonic() + 30
            while not ta.tokens and time.monotonic() < deadline:
                time.sleep(0.002)
            tl = gen.submit_generate({"tokens": long.tolist()}, max_new_tokens=2)
            with pytest.raises(RuntimeError, match="injected"):
                tl.result(timeout=60)
            toks_a, meta_a = ta.result(timeout=60)
        finally:
            gen.stop()
            eng.spec = spec
    assert eng.cache_epoch == 1
    assert meta_a["restarts"] == 1
    assert toks_a == _reference(eng, eng.current_weights().params, short, 12)
    assert eng.pool.used_blocks == 0


# -- the JAX batcher and the port's, in chunked posture -----------------------


def test_jax_and_port_batchers_agree_in_chunked_posture(lm):
    """The same prompts (one twice, so the second claims its prefix)
    through the JAX ``TokenContinuousBatcher`` over a checkpoint of the
    flax params and through the port's over the converted weights, both
    float32, both in their default chunked posture with the prefix
    cache: the same tokens, chunk counts and reused blocks."""
    from edl_tpu import telemetry as jax_telemetry

    jmodel = jax_get_model("transformer_lm", tiny=True)
    jmodel = dataclasses.replace(jmodel, decode=lm["jspec"]["f32"])
    params = lm["params"][0]
    store = JaxStore()
    store.save_async(
        JaxTrainState(step=jnp.asarray(3, jnp.int32), params=params,
                      opt_state=optax.adam(1e-3).init(params)),
        generation=0,
    )
    store.wait()
    prompts = [_prompt(41, 5), _prompt(42, 33), _prompt(42, 33), _prompt(43, 50)]
    with jax_telemetry.scoped():
        jeng = JaxDecodeEngine(jmodel, store, devices=jax.devices()[:1], max_batch=1,
                               max_seqs=4, block_tokens=BT, max_chunk_tokens=CHUNK)
        assert jeng.load()
        jb = JaxBatcher(jeng, refresh=False).start()
        try:
            jout = [jb.submit_generate({"tokens": p}, max_new_tokens=5).result(timeout=120)
                    for p in prompts]
        finally:
            jb.stop()
    with telemetry.scoped():
        eng = _engine(lm)
        gen = TokenContinuousBatcher(eng, refresh=False).start()
        try:
            tout = [gen.submit_generate({"tokens": p.tolist()}, max_new_tokens=5).result(timeout=60)
                    for p in prompts]
        finally:
            gen.stop()
    assert jb.chunked_prefill and gen.chunked_prefill
    for (jt, jm), (tt, tm) in zip(jout, tout):
        assert tt == jt
        assert (tm["prefill_chunks"], tm["reused_blocks"]) == (jm["prefill_chunks"], jm["reused_blocks"])
    assert tout[2][1]["reused_blocks"] == 4  # (33 - 1) // 8 blocks claimed
    assert gen.stats["chunks"] == jb.stats["chunks"]
    assert eng.pool.used_blocks == 0
