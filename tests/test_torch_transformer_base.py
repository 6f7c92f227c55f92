"""The port's ``transformer_base`` (encoder-decoder) against the JAX
package's, on the CPU, at the JAX tests' tiny shape (vocab 256, d 64,
d_ff 256, 4 heads, 2 + 2 layers, T 32).

JAX initializes the params (``jax.random.key(0)``); ``convert.py``
carries them across; the same numpy ``synth_batch`` (padded source and
target rows of unequal lengths) goes through both.  Compared: the loss
and its aux, every gradient and ``predict_fn``'s greedy tokens.  bf16
(the model's compute dtype) at 2e-2 of the reference's scale, as
``test_torch_transformer_lm.py`` states it; the float32 modules (the
tied logits and the loss in float32 too) at 1e-4 of scale.  Tokens are
held where the reference's top-2 margin exceeds 2e-2 of the row's
largest |logit|.

Also: the masked attention paths the model takes (causal under a key
padding mask, the kernels' plain versions against the Pallas kernels in
interpret mode), and a data-parallel world of 2 on gloo against a world
of 1.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import get_model as jax_get_model
from edl_tpu.models.transformer import Transformer as FlaxTransformer
from edl_tpu.ops.flash_attention import flash_attention_with_lse as jax_flash
from edl_tpu_torch.convert import transformer_from_flax
from edl_tpu_torch.models import get_model
from edl_tpu_torch.models.transformer import Transformer
from edl_tpu_torch.ops.flash_attention import flash_attention_with_lse, flash_bwd_plain
from edl_tpu_torch.runtime import ShardedDataIterator, Trainer

ROOT = Path(__file__).resolve().parents[1]
F32, BF16 = 1e-4, 2e-2
N = 4
ARCH = dict(vocab_size=256, d_model=64, d_ff=256, num_heads=4, num_layers=2, max_len=32)


def _close(got, want, tol, what=""):
    """``tol`` of the reference's largest magnitude, elementwise."""
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX tiny model's params and batch; its bf16 loss, aux,
    gradients, logits and tokens; the float32 module's loss, logits and
    gradients."""
    jm = jax_get_model("transformer_base", tiny=True)
    params = jax.jit(jm.init_params)(jax.random.key(0))
    batch = jm.synth_batch(np.random.RandomState(1), N)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, batch, jax.random.key(0)), has_aux=True))(params)
    tokens = jax.jit(jm.predict_fn)(params, {k: batch[k] for k in jm.predict_inputs})["tokens"]
    bf16_module = FlaxTransformer(**ARCH)
    logits = jax.jit(bf16_module.apply)({"params": params}, batch["src"], batch["tgt"])
    f32_module = FlaxTransformer(**ARCH, dtype=jnp.float32)

    def f32_loss(p):
        logits = f32_module.apply({"params": p}, batch["src"], batch["tgt"])
        labels = batch["tgt"][:, 1:]
        lse = jax.nn.logsumexp(logits[:, :-1], axis=-1)
        label_logit = jnp.take_along_axis(logits[:, :-1], labels[..., None], -1)[..., 0]
        valid = labels != 0
        return jnp.sum((lse - label_logit) * valid) / jnp.sum(valid), logits

    (f32_l, f32_logits), f32_g = jax.jit(jax.value_and_grad(f32_loss, has_aux=True))(params)
    return {
        "params": _np_tree(params), "batch": batch, "loss": float(loss),
        "aux": {k: float(v) for k, v in aux.items()}, "grads": _np_tree(grads),
        "tokens": np.asarray(tokens), "logits": np.asarray(logits, np.float32),
        "f32": (float(f32_l), np.asarray(f32_logits), _np_tree(f32_g)),
    }


def test_loss_aux_and_grads_match_jax_in_bf16(jax_side):
    model = get_model("transformer_base", tiny=True)
    params = model.train_params(transformer_from_flax(jax_side["params"]), "cpu")
    batch = _tensors(jax_side["batch"])
    loss, aux = model.loss_fn(params, batch)
    loss.backward()
    assert set(aux) == set(jax_side["aux"]) | {"valid_tokens"}
    assert int(aux["valid_tokens"]) == int((jax_side["batch"]["tgt"][:, 1:] != 0).sum())
    np.testing.assert_allclose(loss.item(), jax_side["loss"], rtol=BF16)
    np.testing.assert_allclose(aux["token_accuracy"].item(), jax_side["aux"]["token_accuracy"],
                               atol=BF16)
    want = transformer_from_flax(jax_side["grads"])
    got = {n: p.grad for n, p in params.named_parameters()}
    assert set(got) == set(want) and all(g.dtype == torch.float32 for g in got.values())
    for n, g in got.items():
        _close(g.numpy(), want[n].numpy(), BF16, n)


def test_float32_module_matches_flax_at_float32_rounding(jax_side):
    """The same architecture in float32 on both sides, the tied logits
    included, and the same next-token loss written out in each: logits,
    loss and every gradient at 1e-4 of scale."""
    module = Transformer(**ARCH, dtype=torch.float32)
    module.load_state_dict(transformer_from_flax(jax_side["params"]))
    batch = _tensors(jax_side["batch"])
    logits = module(batch["src"], batch["tgt"])
    labels = batch["tgt"][:, 1:].long()
    lse = torch.logsumexp(logits[:, :-1], dim=-1)
    label_logit = logits[:, :-1].gather(-1, labels[..., None])[..., 0]
    valid = labels != 0
    loss = ((lse - label_logit) * valid).sum() / valid.sum()
    loss.backward()
    want_loss, want_logits, want_grads = jax_side["f32"]
    _close(logits.detach().numpy(), want_logits, F32, "logits")
    np.testing.assert_allclose(loss.item(), want_loss, rtol=F32)
    want = transformer_from_flax(want_grads)
    for n, p in module.named_parameters():
        _close(p.grad.numpy(), want[n].numpy(), F32, n)


def test_predict_fn_gives_the_jax_greedy_tokens(jax_side):
    model = get_model("transformer_base", tiny=True)
    params = model.bind_params(transformer_from_flax(jax_side["params"]), "cpu")
    inputs = {k: torch.from_numpy(jax_side["batch"][k]) for k in model.predict_inputs}
    with torch.no_grad():
        got = model.predict_fn(params, inputs)["tokens"].numpy()
        logits = params(inputs["src"], inputs["tgt"]).numpy()
    want = jax_side["logits"]
    _close(logits, want, BF16, "logits")
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > BF16 * np.abs(want).max(axis=-1)
    assert sure.mean() > 0.5
    np.testing.assert_array_equal(got[sure], jax_side["tokens"][sure])
    assert model.predict_inputs == ("src", "tgt")


@pytest.mark.parametrize("causal", [True, False], ids=["decoder-self", "encoder-self"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_attention_matches_the_jax_kernels(causal, dtype):
    """Attention under the model's own padding masks (``tgt != 0`` under
    the causal mask in the decoder, ``src != 0`` elsewhere): the port's
    CPU path (``flash_attention_with_lse``'s plain versions) and
    ``flash_bwd_plain`` against the Pallas forward and merged backward in
    interpret mode, at the tiny model's head shape."""
    batch = get_model("transformer_base", tiny=True).synth_batch(np.random.RandomState(5), 2)
    mask = (batch["tgt"] if causal else batch["src"]) != 0
    rng = np.random.RandomState(6)
    b, t, h, d = 2, 32, 4, 16
    q, k, v, do = (rng.randn(b, t, h, d).astype(np.float32) for _ in range(4))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = F32 * 10 if dtype == "float32" else 3e-2

    def f(q, k, v):
        return jax_flash(q, k, v, causal=causal, kv_mask=jnp.asarray(mask), block_q=16,
                         block_k=16, interpret=True)

    (o, lse), vjp = jax.vjp(f, *(jnp.asarray(x, jd) for x in (q, k, v)))
    want = vjp((jnp.asarray(do, jd), jnp.zeros_like(lse)))
    tq, tk, tv = (torch.from_numpy(x).to(td).requires_grad_(True) for x in (q, k, v))
    tmask = torch.from_numpy(mask)
    got_o, got_lse = flash_attention_with_lse(tq, tk, tv, causal, None, tmask)
    _close(got_o.detach().float().numpy(), np.asarray(o, np.float32), tol, "o")
    _close(got_lse.detach().numpy(), np.asarray(lse, np.float32), F32 * 10, "lse")
    plain = flash_bwd_plain(tq.detach(), tk.detach(), tv.detach(), got_o.detach(),
                            got_lse.detach(), torch.from_numpy(do).to(td), None, tmask, causal,
                            d ** -0.5)
    for name, g, w in zip(("dq", "dk", "dv"), plain, want):
        _close(g.float().numpy(), np.asarray(w, np.float32), tol, name)


def test_training_contract_and_flops():
    model = get_model("transformer_base", tiny=True)
    sd = model.init_params(torch.Generator().manual_seed(0))
    train = model.train_params(sd, "cpu")
    assert all(p.dtype == torch.float32 and p.requires_grad for p in train.parameters())
    serve = model.bind_params(sd, "cpu")
    assert serve.encoder[0].mlp.wi.weight.dtype == torch.bfloat16
    assert serve.embed.weight.dtype == torch.float32
    assert not any(p.requires_grad for p in serve.parameters())
    full, jfull = get_model("transformer_base"), jax_get_model("transformer_base")
    assert full.flops_per_example == jfull.flops_per_example
    assert full.tokens_per_example == jfull.tokens_per_example == 256
    # about 98.9 GFLOP an example by the JAX formula: 6.3 TFLOP a 64 x 256 step
    assert abs(full.flops_per_example / 98.9e9 - 1) < 1e-3


# -- data parallelism ---------------------------------------------------------

LR, STEPS, GBS = 1e-3, 3, 8

_WORKER = """
import sys, numpy as np, torch, torch.distributed as dist
from edl_tpu_torch.models import get_model
from edl_tpu_torch.runtime import ShardedDataIterator, Trainer
rank, port, data, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
ds = dict(np.load(data))
trainer = Trainer(get_model("transformer_base", tiny=True, dtype=torch.float32),
                  lr=%r, device="cpu", seed=0, process_group=dist.group.WORLD)
state = trainer.init_state()
it = ShardedDataIterator(ds, %d, seed=0)
losses, grads, valid = [], None, []
for step in range(%d):
    batch = it.device_batch(step, "cpu", world=2, rank=rank)
    valid.append(int((batch["tgt"][:, 1:] != 0).sum()))
    state, m = trainer.step(state, batch)
    losses.append(m["loss"].item())
    if grads is None:
        grads = {n: p.grad.clone() for n, p in state.params.named_parameters()}
torch.save({"losses": losses, "grads": grads, "valid": valid}, out + str(rank))
dist.destroy_process_group()
""" % (LR, GBS, STEPS)


def test_dp2_on_gloo_equals_dp1(tmp_path):
    """Two processes, each with half of every global batch, step like one
    process with all of it.  The halves carry unequal valid-token counts
    (the rows' lengths differ), so an unweighted mean of the two losses
    would differ: the loss stream agrees to 1e-5 and the first step's
    gradients to 2e-3 of each leaf's largest (float32 compute)."""
    model = get_model("transformer_base", tiny=True, dtype=torch.float32)
    ds = model.synth_batch(np.random.RandomState(0), 64)
    data = tmp_path / "data.npz"
    np.savez(data, **ds)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "dp2-")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(port), str(data), out],
                              cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    ranks = [torch.load(out + str(r)) for r in range(2)]
    assert any(a != b for a, b in zip(ranks[0]["valid"], ranks[1]["valid"]))

    trainer = Trainer(model, lr=LR, device="cpu", seed=0)
    state = trainer.init_state()
    it = ShardedDataIterator(ds, GBS, seed=0)
    losses, grads = [], None
    for step in range(STEPS):
        state, m = trainer.step(state, it.device_batch(step, "cpu"))
        losses.append(m["loss"].item())
        if grads is None:
            grads = {n: p.grad.clone() for n, p in state.params.named_parameters()}
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        for n, g in grads.items():
            _close(r["grads"][n].numpy(), g.numpy(), 2e-3, n)
