"""The port's ``TransformerLM`` against the flax module, on the CPU.

The flax ``TransformerLM`` (tiny config) is initialized by JAX; its
params are carried over with ``convert.params_from_flax``; the same
numpy tokens go through both.  Float32 agrees to float32 rounding
(rtol 1e-4 of the output's scale).  bf16 is held at 2e-2 of the
output's scale: the two frameworks round bf16 at different places
(torch's addmm rounds the matmul+bias once, XLA rounds the dot then
the bias add; torch's CPU GELU computes in f32 and rounds once), and
the differences compound through the layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from edl_tpu.models.transformer_lm import (
    TransformerLM as FlaxLM,
    lm_decode_spec as jax_decode_spec,
    lm_synth_batch as jax_synth_batch,
)
from edl_tpu_torch.convert import flax_from_params, params_from_flax
from edl_tpu_torch.models import get_model, registered_models
from edl_tpu_torch.models.decode import greedy_from_features
from edl_tpu_torch.models.transformer_lm import (
    LN_EPS,
    LMBlock,
    TransformerLM,
    lm_synth_batch,
)

V, D, FF, H, LAYERS, L = 256, 64, 256, 4, 2, 64
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(scope="module")
def models():
    """Per dtype: (flax module, flax params, state_dict, torch module)."""
    out = {}
    for name, (jd, td, _) in DTYPES.items():
        fm = FlaxLM(V, D, FF, H, LAYERS, L, dtype=jd)
        params = fm.init(jax.random.key(0), jnp.zeros((1, L), jnp.int32))["params"]
        tree = jax.tree_util.tree_map(np.asarray, params)
        sd = params_from_flax(tree)
        tm = TransformerLM(V, D, FF, H, LAYERS, L, dtype=td)
        tm.load_state_dict(sd)
        out[name] = (fm, params, sd, tm.eval())
    return out


def _close(got, want, rtol):
    """``rtol`` of the reference's largest magnitude, elementwise."""
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _tokens(seed, n=2, t=40):
    return np.random.RandomState(seed).randint(0, V, size=(n, t)).astype(np.int32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_features_and_logits_match_flax(models, dtype):
    fm, params, _, tm = models[dtype]
    rtol = DTYPES[dtype][2]
    toks = _tokens(1)
    want_f = np.asarray(fm.apply({"params": params}, toks, return_features=True), np.float32)
    want_l = np.asarray(fm.apply({"params": params}, toks), np.float32)
    with torch.no_grad():
        got_f = tm(torch.from_numpy(toks), return_features=True)
        got_l = tm(torch.from_numpy(toks))
    assert got_f.dtype == torch.float32 and got_l.dtype == torch.float32
    _close(got_f.numpy(), want_f, rtol)
    _close(got_l.numpy(), want_l, rtol)


def test_predict_fn_ids_match_flax(models):
    """``predict_fn``'s greedy ids equal the JAX predict path's
    (features -> bf16 x bf16 -> f32 logits -> argmax) at f32 weights."""
    fm, params, sd, _ = models["float32"]
    model = get_model("transformer_lm", tiny=True, dtype=torch.float32)
    bound = model.bind_params(sd, "cpu")
    toks = _tokens(2, n=3, t=L + 1)  # the corpus's L+1 row layout
    x = fm.apply({"params": params}, toks[:, :L], return_features=True)
    logits = jnp.einsum(
        "btd,vd->btv", x.astype(jnp.bfloat16),
        params["embed"]["embedding"].astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )
    want = np.asarray(jnp.argmax(logits, -1))
    with torch.no_grad():
        got = model.predict_fn(bound, {"tokens": torch.from_numpy(toks)})["tokens"]
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_spec_prefill_and_decode_match_flax(models):
    """``prefill_fn`` / ``decode_fn``: ids exact and pools to float32
    rounding, over the pool layout and table setup of the JAX decode
    tests (one sequence, blocks 1..mb, trash block 0)."""
    fm, params, sd, _ = models["float32"]
    jspec = jax_decode_spec(fm, H, D, L)
    model = get_model("transformer_lm", tiny=True, dtype=torch.float32)
    spec = model.decode
    bound = model.bind_params(sd, "cpu")
    bt = 16
    mb = L // bt
    shape = (spec.layers, mb + 1, bt, spec.heads, spec.head_dim)
    jk = jnp.zeros(shape, jnp.float32)
    jv = jnp.zeros_like(jk)
    tk = torch.zeros(shape)
    tv = torch.zeros(shape)
    tab = np.arange(1, mb + 1, dtype=np.int32)[None]
    prompt = _tokens(3, n=1, t=20)[0]
    tok = np.zeros((1, 32), np.int32)
    tok[0, :20] = prompt
    ln = np.asarray([20], np.int32)
    jids, jk, jv = jax.jit(jspec.prefill_fn)(params, tok, ln, jk, jv, tab)
    with torch.no_grad():
        tids, tk, tv = spec.prefill_fn(
            bound, torch.from_numpy(tok), torch.from_numpy(ln), tk, tv,
            torch.from_numpy(tab),
        )
    assert int(tids[0]) == int(jids[0])
    _close(tk.numpy(), np.asarray(jk), 1e-4)
    _close(tv.numpy(), np.asarray(jv), 1e-4)
    dec = jax.jit(jspec.decode_fn)
    seq = [int(jids[0])]
    for _ in range(6):
        last = np.asarray([seq[-1]], np.int32)
        jids, jk, jv = dec(params, last, ln, jk, jv, tab)
        with torch.no_grad():
            tids, tk, tv = spec.decode_fn(
                bound, torch.from_numpy(last), torch.from_numpy(ln), tk, tv,
                torch.from_numpy(tab),
            )
        assert int(tids[0]) == int(jids[0])
        seq.append(int(jids[0]))
        ln = ln + 1
    _close(tk.numpy(), np.asarray(jk), 1e-4)
    _close(tv.numpy(), np.asarray(jv), 1e-4)


def test_greedy_from_features_matches_jax(models):
    from edl_tpu.models.decode import greedy_from_features as jax_greedy

    _, params, _, tm = models["float32"]
    feats = np.random.RandomState(4).randn(3, 5, D).astype(np.float32)
    pos = np.asarray([0, 4, 2], np.int32)
    emb = params["embed"]["embedding"]
    want = np.asarray(jax_greedy(jnp.asarray(feats), emb, positions=jnp.asarray(pos)))
    got = greedy_from_features(
        torch.from_numpy(feats), tm.logit_weight(torch.bfloat16),
        positions=torch.from_numpy(pos),
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_convert_round_trips_both_ways(models):
    fm, params, sd, _ = models["float32"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    back = flax_from_params(sd, H)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    sd2 = params_from_flax(back)
    assert sd2.keys() == sd.keys()
    for k in sd:
        assert torch.equal(sd2[k], sd[k]), k
    # and the port module's own state_dict has exactly these keys
    assert set(TransformerLM(V, D, FF, H, LAYERS, L).state_dict()) == set(sd)


def test_layernorm_eps_is_flax_default():
    """Trap: flax LayerNorm eps is 1e-6, torch's default 1e-5.  On a
    low-variance input the difference is far outside float32 noise, so
    this input tells the two apart."""
    x = (np.random.RandomState(5).randn(4, D) * 3e-3).astype(np.float32)
    ln = nn.LayerNorm(dtype=jnp.float32)
    want = np.asarray(ln.apply(ln.init(jax.random.key(0), x), x))
    block = LMBlock(H, D, FF, torch.float32)
    assert block.ln1.eps == LN_EPS == 1e-6
    got = block.ln1(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    wrong = F.layer_norm(torch.from_numpy(x), (D,), eps=1e-5).numpy()
    assert np.abs(wrong - want).max() > 1e-2


def test_gelu_is_the_tanh_approximation():
    """Trap: flax ``nn.gelu`` is the tanh approximation; torch's
    default is erf.  The port's MLP matches flax, and erf would not."""
    x = np.linspace(-4, 4, D).astype(np.float32)
    want = np.asarray(nn.gelu(jnp.asarray(x)))
    # Reduce the block to its activation: no attention, no ln2, wi and
    # wo identity embeddings, so block(x) - x == gelu(x).
    block = LMBlock(H, D, FF, torch.float32)
    block.attn = _Zero()
    block.ln2 = torch.nn.Identity()
    with torch.no_grad():
        block.wi.weight.copy_(torch.eye(FF, D))
        block.wi.bias.zero_()
        block.wo.weight.copy_(torch.eye(D, FF))
        block.wo.bias.zero_()
        h = torch.from_numpy(x)[None, None]
        got = (block(h) - h)[0, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    erf = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


class _Zero(torch.nn.Module):
    def forward(self, x, kv=None):
        return torch.zeros_like(x)


def test_synth_batch_and_registry():
    rs_a, rs_b = np.random.RandomState(9), np.random.RandomState(9)
    np.testing.assert_array_equal(
        lm_synth_batch(V, L)(rs_a, 3)["tokens"], jax_synth_batch(V, L)(rs_b, 3)["tokens"]
    )
    assert {"transformer_lm", "longcontext_lm"} <= set(registered_models())
    lc = get_model("longcontext_lm", tiny=True)
    assert lc.name == "longcontext_lm" and lc.decode.max_len == 128
    full = get_model("transformer_lm")
    assert (full.decode.layers, full.decode.heads, full.decode.head_dim,
            full.decode.max_len, full.decode.vocab_size) == (12, 12, 64, 2048, 32000)
