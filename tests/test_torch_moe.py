"""The port's ``moe_lm`` against the JAX package's, on the CPU.

The flax ``MoELM`` (tiny: vocab 256, d 64, d_ff 128, 4 heads, 2
layers, 4 experts, context 64, routing group 256) is initialized by JAX
once per module; its params are carried over with
``convert.moe_from_flax``; the same numpy inputs go through both.

- ``MoEMlp`` in float32: capacity binding (drops) at G=256, group 1,
  one expert (also against the dense MLP it then is) and capacity
  factor 0.01: outputs within 1e-5 of their scale, the same expert and
  keep mask for every token, aux and drop rate within 1e-6.
- ``MoELM`` features and logits: float32 within 1e-4 of scale; bf16
  within 2e-2 of scale on the tokens routed alike in every layer, and
  at most 2% of the tokens routed differently.
- ``loss_fn`` and every gradient against ``jax.value_and_grad`` in
  float32 within 1e-4 of scale (the tied embedding's, which carries
  the loss's bf16 products, at 2e-3); three ``Trainer`` steps against the JAX
  ``Trainer`` with ``optax.adam`` (``tests/test_torch_train.py``'s
  rules).
- ``predict_fn``, ``prefill_fn``, ``decode_fn`` and ``chunk_fn`` ids
  against JAX's (``lm_decode_spec`` over ``MoELM``).  Serving routes
  per token (group 1) where ``predict_fn`` routes in capacity groups,
  so the full-recompute anchor of KV decode is a per-token-routed
  monolithic prefill of prompt plus generated tokens, never
  ``predict_fn`` (the JAX package leaves ``moe_lm`` out of its
  predict-based anchor for the same reason).  The chunked first token
  equals the monolithic one; a sequence decodes the same alone as in a
  ragged batch.
- ``flops_per_example`` equals JAX's; a world of 2 on gloo steps like a
  world of 1, and each rank reports the global batch's aux loss.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from edl_tpu.models import get_model as jax_get_model
from edl_tpu.models.moe import MoELM as FlaxMoE
from edl_tpu.models.moe import MoEMlp as FlaxMoEMlp
from edl_tpu.models.transformer_lm import lm_decode_spec as jax_decode_spec
from edl_tpu.ops.losses import best_vocab_xent as jax_best_vocab_xent
from edl_tpu.parallel import dp_mesh
from edl_tpu.runtime import ShardedDataIterator as JaxIterator
from edl_tpu.runtime import Trainer as JaxTrainer
from edl_tpu.runtime.data import synthetic_dataset as jax_synthetic_dataset
from edl_tpu_torch.convert import moe_from_flax
from edl_tpu_torch.models import get_model
from edl_tpu_torch.models.base import divisor_at_most
from edl_tpu_torch.models.moe import MoELM, MoEMlp, moe_flops, router_term
from edl_tpu_torch.runtime import ShardedDataIterator, Trainer

ROOT = Path(__file__).resolve().parents[1]
V, D, FF, H, LAYERS, E, L, GROUP = 256, 64, 128, 4, 2, 4, 64, 256
LR = 1e-3
STEPS = 3
BT = 16
#: float32 gradients are held at 1e-4 of each leaf's largest magnitude,
#: but the tied embedding's: its projection share comes out of the
#: tied-vocab cross entropy, whose logits are bf16 x bf16 products in
#: both packages, so it carries bf16 rounding (3.1e-4 of its scale
#: here, 8.0e-5 for ``transformer_lm``'s); it is held at the 2e-3
#: ``tests/test_torch_train.py`` holds the LM's float32 gradients to
GRAD_TOL = {"embed.weight": 2e-3}


def _close(got, want, rtol, what=""):
    """``rtol`` of the reference's largest magnitude, elementwise."""
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * scale, err_msg=what)


def _tokens(seed, n=2, t=40):
    return np.random.RandomState(seed).randint(3, V, size=(n, t)).astype(np.int32)


@pytest.fixture(scope="module")
def moe():
    """The flax modules (float32 and bf16 compute), the JAX params of
    seed 0 (numpy tree) and their state_dict."""
    f32 = FlaxMoE(V, D, FF, H, LAYERS, E, L, group=GROUP, dtype=jnp.float32)
    bf16 = FlaxMoE(V, D, FF, H, LAYERS, E, L, group=GROUP, dtype=jnp.bfloat16)
    params = f32.init(jax.random.key(0), jnp.zeros((1, L), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.array, params)  # host copies: JAX steps donate theirs
    return {"f32": f32, "bf16": bf16, "params": params, "sd": moe_from_flax(params)}


def _port_module(sd, dtype):
    m = MoELM(V, D, FF, H, LAYERS, E, L, group=GROUP, dtype=dtype, param_dtype=torch.float32)
    m.load_state_dict(sd)
    return m.eval()


# -- the expert MLP ------------------------------------------------------------

#: name -> (experts, group, capacity factor, input skew)
MLP_CASES = {
    "capacity_binds": (4, 256, 1.25, 1.5),
    "group_1": (4, 1, 1.25, 0.0),
    "one_expert": (1, 256, 1.25, 0.0),
    "capacity_factor_0.01": (4, 256, 0.01, 0.0),
}


def _np_keep(expert, G, cap, e):
    """The JAX capacity rule on a given expert choice (numpy)."""
    oh = np.eye(e, dtype=np.float32)[expert].reshape(-1, G, e)
    pos = ((np.cumsum(oh, axis=1) - oh) * oh).sum(-1)
    return pos < cap


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_moe_mlp_matches_flax(case):
    e, group, cf, skew = MLP_CASES[case]
    rng = np.random.RandomState(1)
    x = rng.randn(4, 64, D).astype(np.float32) + skew * rng.randn(D).astype(np.float32)
    fm = FlaxMoEMlp(D, FF, e, capacity_factor=cf, group=group, dtype=jnp.float32)
    params = fm.init(jax.random.key(2), x)["params"]
    want, state = fm.apply(
        {"params": params}, x, mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: mdl.name == "router")
    inter = state["intermediates"]
    j_logits = inter["router"]["__call__"][0]
    j_expert = np.asarray(jnp.argmax(jax.nn.softmax(j_logits, -1), -1))

    tm = MoEMlp(D, FF, e, capacity_factor=cf, group=group, dtype=torch.float32)
    with torch.no_grad():
        tm.router.weight.copy_(torch.from_numpy(np.array(params["router"]["kernel"]).T))
        tm.router.bias.copy_(torch.from_numpy(np.array(params["router"]["bias"])))
        tm.wi.copy_(torch.from_numpy(np.array(params["wi"])))
        tm.wo.copy_(torch.from_numpy(np.array(params["wo"])))
        xt = torch.from_numpy(x)
        expert, keep, _, _ = tm.route(xt)
        got = tm(xt)
    n = x.shape[0] * x.shape[1]
    G = divisor_at_most(n, group)
    cap = max(1, int(cf * G / e))
    np.testing.assert_array_equal(expert.numpy(), j_expert)
    np.testing.assert_array_equal(keep.numpy(), _np_keep(j_expert, G, cap, e))
    _close(got.numpy(), np.asarray(want), 1e-5)
    _, metrics = router_term(e, n, G, group)(tm.router_stats[None], 1)
    want_aux = float(inter["aux_loss"][0])
    want_drop = float(inter["drop_rate"][0])
    assert abs(float(metrics["moe_aux_loss"]) - want_aux) <= 1e-6
    assert abs(float(metrics["moe_drop_rate"]) - want_drop) <= 1e-6
    if case == "capacity_binds":
        assert 0.0 < want_drop < 1.0
    elif case == "capacity_factor_0.01":
        assert cap == 1 and want_drop > 0.5
    else:
        assert want_drop == 0.0
    if case == "one_expert":  # the dense MLP with zero biases
        dense = F.linear(F.gelu(xt @ tm.wi[0], approximate="tanh"), tm.wo[0].t())
        _close(got.numpy(), dense.detach().numpy(), 1e-5)


# -- the LM --------------------------------------------------------------------


def _jax_routes(module, params, toks):
    """Features and each layer's expert per token ``[layers, n]``."""
    feats, state = module.apply(
        {"params": params}, toks, mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: mdl.name == "router")
    inter = state["intermediates"]
    experts = [np.asarray(jnp.argmax(inter[f"layer_{i}"]["moe"]["router"]["__call__"][0], -1))
               for i in range(LAYERS)]
    return np.asarray(feats, np.float32), np.stack(experts)


def _port_routes(module, toks):
    experts = []
    hooks = [layer.moe.router.register_forward_hook(
        lambda m, i, out: experts.append(out.argmax(-1).numpy())) for layer in module.layers]
    try:
        with torch.no_grad():
            feats = module(torch.from_numpy(toks), return_features=True)
    finally:
        for h in hooks:
            h.remove()
    return feats.numpy(), np.stack(experts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_lm_features_and_logits_match_flax(moe, dtype):
    jm = moe["f32"] if dtype == "float32" else moe["bf16"]
    tm = _port_module(moe["sd"], getattr(torch, dtype))
    toks = _tokens(1, n=4, t=L)  # 256 tokens: one routing group
    want_f, want_routes = _jax_routes(jm, moe["params"], toks)
    got_f, got_routes = _port_routes(tm, toks)
    want_l = np.asarray(jnp.einsum("btd,vd->btv", want_f, moe["params"]["embed"]["embedding"]))
    with torch.no_grad():
        got_l = (torch.from_numpy(got_f) @ tm.embed.weight.t()).numpy()
    if dtype == "float32":
        np.testing.assert_array_equal(got_routes, want_routes)
        _close(got_f, want_f, 1e-4)
        _close(got_l, want_l, 1e-4)
        return
    alike = (got_routes == want_routes).all(0).reshape(toks.shape)
    assert 1.0 - alike.mean() <= 0.02
    _close(got_f[alike], want_f[alike], 2e-2)
    _close(got_l[alike], want_l[alike], 2e-2)


def _jax_f32_model():
    """The registered JAX tiny ``moe_lm`` with the float32-compute
    module under the reference's own ``loss_fn`` body."""
    base = jax_get_model("moe_lm", tiny=True)
    module = FlaxMoE(V, D, FF, H, LAYERS, E, L, group=GROUP, dtype=jnp.float32)

    def loss_fn(params, batch, rng):
        tokens = batch["tokens"]
        labels = tokens[:, 1:]
        x, inter = module.apply({"params": params}, tokens[:, :-1], mutable=["intermediates"])
        loss, _ = jax_best_vocab_xent(x, params["embed"]["embedding"], labels, labels != 0)

        def _mean_of(key):
            vals = [leaf for path, leaf in jax.tree_util.tree_flatten_with_path(inter)[0]
                    if any(str(getattr(k, "key", k)) == key for k in path)]
            return sum(vals) / len(vals)

        aux, drop = _mean_of("aux_loss"), _mean_of("drop_rate")
        return loss + 0.01 * aux, {"loss": loss, "moe_aux_loss": aux, "moe_drop_rate": drop}

    return dataclasses.replace(base, loss_fn=loss_fn)


def _port_f32_model():
    return get_model("moe_lm", tiny=True, dtype=torch.float32)


def _dataset():
    """The synthetic corpus, some label-0 tokens masked out of the loss."""
    ds = jax_synthetic_dataset(jax_get_model("moe_lm", tiny=True).synth_batch, 64, seed=0)
    ds["tokens"][::3, 10:20] = 0
    return ds


def test_loss_fn_and_grads_match_jax_value_and_grad(moe):
    tokens = _dataset()["tokens"][:8]  # 512 tokens: two routing groups
    (want_total, want_aux), want = jax.jit(jax.value_and_grad(_jax_f32_model().loss_fn, has_aux=True))(
        moe["params"], {"tokens": jnp.asarray(tokens)}, jax.random.key(1))
    model = _port_f32_model()
    params = model.train_params(moe["sd"], "cpu")
    total, aux = model.loss_fn(params, {"tokens": torch.from_numpy(tokens)})
    total.backward()
    np.testing.assert_allclose(total.item(), float(want_total), rtol=1e-4)
    for key in ("loss", "moe_aux_loss", "moe_drop_rate"):
        np.testing.assert_allclose(float(aux[key].detach()), float(want_aux[key]), rtol=1e-4,
                                   atol=1e-6)
    assert 0.0 < float(aux["moe_drop_rate"]) < 1.0
    assert int(aux["valid_tokens"]) == int((tokens[:, 1:] != 0).sum())
    want_sd = moe_from_flax(jax.tree_util.tree_map(np.asarray, want))
    grads = {n: p.grad for n, p in params.named_parameters()}
    assert grads.keys() == want_sd.keys()
    for name, g in grads.items():
        _close(g.numpy(), want_sd[name].numpy(), GRAD_TOL.get(name, 1e-4), name)


def _assert_params_close(got: dict, want: dict):
    """Parameters after ``STEPS`` Adam steps, as
    ``tests/test_torch_train.py`` holds them: every element within 2 x
    steps x lr, and all but 0.1% of each leaf's within 1e-4; the key
    part of the qkv bias (no gradient in exact arithmetic) only to the
    first bound."""
    for name, w in want.items():
        diff = np.abs(got[name].numpy() - w.numpy())
        assert diff.max() <= 2 * STEPS * LR, name
        if name.endswith("attn.qkv.bias"):
            diff = np.delete(diff.reshape(3, -1), 1, axis=0)
        assert (diff > 1e-4).mean() <= 1e-3, (name, float(diff.max()))


def test_trainer_matches_jax_trainer_with_optax_adam(moe):
    ds = _dataset()
    mesh = dp_mesh(1, jax.devices("cpu")[:1])
    jt = JaxTrainer(_jax_f32_model(), optax.adam(LR), mesh, seed=0)
    jstate = jt.init_state()
    params = jax.tree_util.tree_map(jnp.asarray, moe["params"])
    jstate = jstate.replace(params=params, opt_state=optax.adam(LR).init(params))
    jit = JaxIterator(ds, 8, seed=0)
    want_losses, want_aux = [], []
    for step in range(STEPS):
        jstate, m = jt.step(jstate, jit.device_batch(step, mesh))
        want_losses.append(float(m["loss"]))
        want_aux.append(float(m["moe_aux_loss"]))

    trainer = Trainer(_port_f32_model(), lr=LR, device="cpu", seed=0)
    state = trainer.init_state(moe["sd"])
    it = ShardedDataIterator(ds, 8, seed=0)
    losses, auxes = [], []
    for step in range(STEPS):
        state, m = trainer.step(state, it.device_batch(step, "cpu"))
        losses.append(m["loss"].item())
        auxes.append(float(m["moe_aux_loss"]))
        assert "global_sums" not in m and "global_term" not in m
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    np.testing.assert_allclose(auxes, want_aux, rtol=1e-5)
    assert losses[-1] < losses[0]
    adam = jstate.opt_state[0]
    for key, moment in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want = moe_from_flax(jax.tree_util.tree_map(np.asarray, moment))
        for name, p in state.params.named_parameters():
            _close(state.opt_state.state[p][key].numpy(), want[name].numpy(), 2e-3,
                   f"{key} {name}")
    _assert_params_close(dict(state.params.state_dict()),
                         moe_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params)))


def test_predict_fn_ids_match_jax(moe):
    """Capacity-group routing (G = 256 over 3 x 64 tokens: 192) in
    float32: the greedy ids equal the JAX predict path's."""
    model = _port_f32_model()
    bound = model.bind_params(moe["sd"], "cpu")
    toks = _tokens(2, n=3, t=L + 1)
    x, _ = moe["f32"].apply({"params": moe["params"]}, toks[:, :L], mutable=["intermediates"])
    logits = jnp.einsum("btd,vd->btv", x.astype(jnp.bfloat16),
                        moe["params"]["embed"]["embedding"].astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)
    want = np.asarray(jnp.argmax(logits, -1))
    with torch.no_grad():
        got = model.predict_fn(bound, {"tokens": torch.from_numpy(toks)})["tokens"]
    np.testing.assert_array_equal(got.numpy(), want)


# -- serving paths ---------------------------------------------------------------


def _pools(spec, blocks, dtype=torch.float32):
    shape = (spec.layers, blocks, BT, spec.heads, spec.head_dim)
    return torch.zeros(shape, dtype=dtype), torch.zeros(shape, dtype=dtype)


def test_prefill_decode_and_chunk_match_jax_decode_spec(moe):
    """Float32: ``prefill_fn`` and six ``decode_fn`` steps, then a
    29-token prompt as chunks of 16 and 13 through ``chunk_fn``: every
    id equal to JAX's, the pools to 1e-4 of their scale."""
    jspec = jax_decode_spec(moe["f32"], H, D, L)
    model = _port_f32_model()
    spec = model.decode
    bound = model.bind_params(moe["sd"], "cpu")
    params = moe["params"]
    mb = L // BT
    tk, tv = _pools(spec, mb + 1)
    jk, jv = jnp.zeros(tk.shape, jnp.float32), jnp.zeros(tv.shape, jnp.float32)
    tab = np.arange(1, mb + 1, dtype=np.int32)[None]
    tok = np.zeros((1, 32), np.int32)
    tok[0, :20] = _tokens(3, n=1, t=20)[0]
    ln = np.asarray([20], np.int32)
    jids, jk, jv = jax.jit(jspec.prefill_fn)(params, tok, ln, jk, jv, tab)
    with torch.no_grad():
        tids, tk, tv = spec.prefill_fn(bound, torch.from_numpy(tok), torch.from_numpy(ln),
                                       tk, tv, torch.from_numpy(tab))
    assert int(tids[0]) == int(jids[0])
    dec = jax.jit(jspec.decode_fn)
    last = int(jids[0])
    for _ in range(6):
        t = np.asarray([last], np.int32)
        jids, jk, jv = dec(params, t, ln, jk, jv, tab)
        with torch.no_grad():
            tids, tk, tv = spec.decode_fn(bound, torch.from_numpy(t), torch.from_numpy(ln),
                                          tk, tv, torch.from_numpy(tab))
        assert int(tids[0]) == int(jids[0])
        last = int(jids[0])
        ln = ln + 1
    _close(tk.numpy(), np.asarray(jk), 1e-4)
    _close(tv.numpy(), np.asarray(jv), 1e-4)

    tk, tv = _pools(spec, mb + 1)
    jk, jv = jnp.zeros(tk.shape, jnp.float32), jnp.zeros(tv.shape, jnp.float32)
    prompt = _tokens(4, n=1, t=29)[0]
    jfn = jax.jit(jspec.chunk_fn)
    for off, clen, bucket in ((0, 16, 16), (16, 13, 16)):
        tok = np.zeros((1, bucket), np.int32)
        tok[0, :clen] = prompt[off:off + clen]
        offs = np.asarray([off], np.int32)
        lens = np.asarray([off + clen], np.int32)
        win = tab[:, : (off + bucket) // BT]
        jids, jk, jv = jfn(params, tok, offs, lens, jk, jv, win)
        with torch.no_grad():
            tids, tk, tv = spec.chunk_fn(bound, torch.from_numpy(tok), torch.from_numpy(offs),
                                         torch.from_numpy(lens), tk, tv, torch.from_numpy(win))
        assert int(tids[0]) == int(jids[0]), off
    _close(tk.numpy(), np.asarray(jk), 1e-4)
    _close(tv.numpy(), np.asarray(jv), 1e-4)


def _engine(moe, **kw):
    from edl_tpu_torch.serving import DecodeEngine

    eng = DecodeEngine(get_model("moe_lm", tiny=True), device="cpu", max_seqs=4,
                       block_tokens=8, **kw)
    eng.install(moe["sd"], step=0)
    return eng


def test_chunked_first_token_equals_monolithic(moe):
    """The registered (bf16) model behind ``DecodeEngine`` with 16-token
    chunks: per-token routing makes the chunk split invisible, so the
    chunked first token equals monolithic prefill's for prompts at,
    below and above the chunk boundaries and over several chunks."""
    eng = _engine(moe, max_chunk_tokens=16)
    w = eng.current_weights()
    for plen in (15, 16, 17, 31, 32, 33, 50):
        prompt = _tokens(plen, n=1, t=plen)[0]
        blocks = eng.pool.alloc(eng.prompt_bucket_for(plen) // 8)
        table = np.zeros(eng.blocks_per_seq, np.int32)
        table[: len(blocks)] = blocks
        mono = eng.prefill(w, prompt, table)
        eng.pool.free(blocks)
        table = np.zeros(eng.blocks_per_seq, np.int32)
        got, off, first = [], 0, None
        while off < plen:
            clen = min(16, plen - off)
            if plen - off > clen:
                clen = (clen // 8) * 8
            need = (off + eng.chunk_bucket_for(clen)) // 8 - len(got)
            for b in eng.pool.alloc(need) if need > 0 else []:
                table[len(got)] = b
                got.append(b)
            first = eng.prefill_chunk(w, prompt[off:off + clen], off, table)
            off += clen
        eng.pool.free(got)
        assert first == mono, plen
    assert eng.pool.used_blocks == 0


def _decode(spec, bound, prompts, steps, batch_rows=None):
    """Prefill each prompt alone into its own blocks, then decode
    ``steps`` tokens for the rows in ``batch_rows`` as one batch."""
    mb = L // BT
    kp, vp = _pools(spec, len(prompts) * mb + 1, spec.cache_dtype)
    tabs = np.stack([np.arange(1 + i * mb, 1 + (i + 1) * mb, dtype=np.int32)
                     for i in range(len(prompts))])
    seqs, lens = [], np.zeros(len(prompts), np.int32)
    with torch.no_grad():
        for i, pr in enumerate(prompts):
            tok = np.zeros((1, 32), np.int32)
            tok[0, :len(pr)] = pr
            ids, _, _ = spec.prefill_fn(bound, torch.from_numpy(tok),
                                        torch.tensor([len(pr)], dtype=torch.int32), kp, vp,
                                        torch.from_numpy(tabs[i:i + 1]))
            lens[i] = len(pr)
            seqs.append([int(ids[0])])
        rows = list(range(len(prompts))) if batch_rows is None else batch_rows
        ln = lens[rows].copy()
        for _ in range(steps):
            t = np.asarray([seqs[r][-1] for r in rows], np.int32)
            ids, _, _ = spec.decode_fn(bound, torch.from_numpy(t), torch.from_numpy(ln),
                                       kp, vp, torch.from_numpy(tabs[rows]))
            for j, r in enumerate(rows):
                seqs[r].append(int(ids[j]))
            ln = ln + 1
    return [seqs[r] for r in rows]


def test_decode_batch_invariant_ragged_lengths(moe):
    """Three prompts of 9, 17 and 30 tokens decode 6 tokens as one
    batch; the middle one decoded alone from its own prefill emits the
    same tokens (``tests/test_decode_serving.py``'s MoE invariance)."""
    model = get_model("moe_lm", tiny=True)
    bound = model.bind_params(moe["sd"], "cpu")
    rng = np.random.RandomState(2)
    prompts = [model.synth_batch(rng, 1)["tokens"][0, :n] for n in (9, 17, 30)]
    together = _decode(model.decode, bound, prompts, 6)
    alone = _decode(model.decode, bound, prompts, 6, batch_rows=[1])
    assert alone[0] == together[1]


def test_kv_decode_equals_per_token_routed_full_recompute(moe):
    """KV decode's 12 tokens equal a full recompute: one monolithic
    (per-token-routed) prefill of prompt + generated tokens on a fresh
    pool, its greedy id read at every position.  Not ``predict_fn``:
    that routes in capacity groups."""
    model = get_model("moe_lm", tiny=True)
    spec = model.decode
    bound = model.bind_params(moe["sd"], "cpu")
    prompt = model.synth_batch(np.random.RandomState(0), 1)["tokens"][0, :20]
    served = _decode(spec, bound, [prompt], 11)[0]
    seq = np.concatenate([prompt, served[:-1]]).astype(np.int32)
    mb = L // BT
    kp, vp = _pools(spec, mb + 1, spec.cache_dtype)
    tok = np.zeros((1, 32), np.int32)
    tok[0, :len(seq)] = seq
    with torch.no_grad():
        feats, _, _ = bound(torch.from_numpy(tok), kv=(
            kp, vp, torch.arange(1, mb + 1, dtype=torch.int32)[None],
            torch.tensor([len(seq)], dtype=torch.int32), True))
        logits = feats[0].to(torch.bfloat16).float() @ bound.logit_weight(torch.bfloat16).t()
    naive = logits.argmax(-1)[len(prompt) - 1:len(seq)].tolist()
    assert served == naive


def test_flops_and_registry_match_jax():
    for tiny in (True, False):
        got, want = get_model("moe_lm", tiny=tiny), jax_get_model("moe_lm", tiny=tiny)
        assert got.flops_per_example == want.flops_per_example
        assert got.tokens_per_example == want.tokens_per_example
    assert get_model("moe_lm").flops_per_example == 1_650_072_748_032
    assert moe_flops(V, D, FF, LAYERS, L, GROUP) == jax_get_model("moe_lm", tiny=True).flops_per_example
    full = get_model("moe_lm").decode
    assert (full.layers, full.heads, full.head_dim, full.max_len, full.vocab_size) == (
        12, 12, 64, 2048, 32000)
    with pytest.raises(ValueError, match="A-8"):
        get_model("moe_lm", tiny=True, ep_mesh=object())
    # the experts' init follows flax's lecun_normal: fan-in E x d_model
    sd = get_model("moe_lm", tiny=True).init_params(torch.Generator().manual_seed(0))
    assert sd["layers.0.moe.wi"].shape == (E, D, FF)
    assert abs(float(sd["layers.0.moe.wi"].std()) - (E * D) ** -0.5) < 0.1 * (E * D) ** -0.5


def test_a_slice_must_begin_on_a_routing_group_boundary():
    """At 63 tokens a rank the whole batch of 126 groups by 126, a rank
    by 63: the term refuses rather than group differently."""
    term = router_term(E, 63, divisor_at_most(63, GROUP), GROUP)
    sums = torch.zeros(LAYERS, 2 * E + 1)
    term(sums, 1)
    with pytest.raises(ValueError, match="routing groups"):
        term(sums, 2)
    router_term(E, 256, 256, GROUP)(sums, 2)  # 512 tokens group by 256: aligned


_WORKER = """
import sys, torch, torch.distributed as dist
from edl_tpu_torch.models import get_model
from edl_tpu_torch.runtime import ShardedDataIterator, Trainer
rank, port, data, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)  # a tiny model; keep the test suite's cores for the others
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
ds = {"tokens": torch.load(data).numpy()}
trainer = Trainer(get_model("moe_lm", tiny=True, dtype=torch.float32),
                  lr=%r, device="cpu", seed=0, process_group=dist.group.WORLD)
state = trainer.init_state()
it = ShardedDataIterator(ds, 8, seed=0)
losses, auxes, drops, grads = [], [], [], None
for step in range(%d):
    state, m = trainer.step(state, it.device_batch(step, "cpu", world=2, rank=rank))
    losses.append(m["loss"].item())
    auxes.append(float(m["moe_aux_loss"]))
    drops.append(float(m["moe_drop_rate"]))
    if grads is None:
        grads = {n: p.grad.clone() for n, p in state.params.named_parameters()}
torch.save({"losses": losses, "auxes": auxes, "drops": drops, "grads": grads,
            "params": state.params.state_dict()}, out + str(rank))
dist.destroy_process_group()
""" % (LR, STEPS)


def test_dp2_on_gloo_equals_dp1(tmp_path):
    """Two processes, each with half of every global batch (one routing
    group of 256 tokens each), step like one process with all of it:
    the loss stream to 1e-5, the first step's gradients to 2e-3 of each
    leaf's largest, the parameters as ``_assert_params_close`` says
    (``tests/test_torch_train.py``'s tolerances); the aux loss and drop
    rate each rank reports equal dp=1's to 1e-5 relative.  A per-rank
    aux loss (the halves' own frac x prob) fails the aux check."""
    ds = _dataset()
    data = tmp_path / "tokens.pt"
    torch.save(torch.from_numpy(ds["tokens"]), data)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp_path / "dp2.pt"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(r), str(port), str(data), str(out)],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for r in range(2)
    ]
    try:
        logs = [p.communicate(timeout=120)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    ranks = [torch.load(f"{out}{r}") for r in range(2)]

    trainer = Trainer(_port_f32_model(), lr=LR, device="cpu", seed=0)
    state = trainer.init_state()
    it = ShardedDataIterator(ds, 8, seed=0)
    losses, auxes, drops, grads = [], [], [], None
    for step in range(STEPS):
        state, m = trainer.step(state, it.device_batch(step, "cpu"))
        losses.append(m["loss"].item())
        auxes.append(float(m["moe_aux_loss"]))
        drops.append(float(m["moe_drop_rate"]))
        if grads is None:
            grads = {n: p.grad.clone() for n, p in state.params.named_parameters()}
    assert max(drops) > 0.0
    for dp2 in ranks:
        np.testing.assert_allclose(dp2["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(dp2["auxes"], auxes, rtol=1e-5)
        np.testing.assert_allclose(dp2["drops"], drops, rtol=1e-5)
    for name, g in grads.items():
        _close(ranks[0]["grads"][name].numpy(), g.numpy(), 2e-3, name)
    _assert_params_close(ranks[0]["params"], dict(state.params.state_dict()))
