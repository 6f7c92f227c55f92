"""The port's training slice against the JAX package's, on the CPU.

- The tiny LM's loss and gradients at converted weights against flax,
  leaf by leaf (``flax_from_params`` maps the port's gradients onto the
  flax tree): float32 compute at 2e-3 of each leaf's largest magnitude
  (as ``tests/test_ring_attention.py`` holds the LM loss), bf16 compute
  (the registered model) at 2e-2, the bf16 tolerance of the forward
  parity tests.  Label 0 is masked out of the loss.
- Three ``Trainer`` steps against the JAX ``Trainer`` with
  ``optax.adam`` on a one-device mesh, from the same converted weights
  and the same batches: the loss stream, Adam's moments and the
  parameters.
- ``ShardedDataIterator`` gives the reference's bytes.
- A world of 2 on gloo (two processes) steps like a world of 1.

Adam divides each gradient element by its own running magnitude, so an
element whose gradient is zero in exact arithmetic moves by up to lr
per step in a direction set by rounding noise.  The query-key bias is
such a parameter: softmax is invariant to a shift shared by a query's
scores, so the key part of the qkv bias has no gradient.  Its elements
are held only to the bound 2 x steps x lr; every other parameter
element to 1e-4, bar at most 0.1% of a leaf's elements (float32
rounding noise that Adam amplifies the same way).
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

from edl_tpu.models import get_model as jax_get_model
from edl_tpu.models.transformer_lm import TransformerLM as FlaxLM
from edl_tpu.models.transformer_lm import lm_flops as jax_lm_flops
from edl_tpu.ops.losses import best_vocab_xent as jax_best_vocab_xent
from edl_tpu.parallel import dp_mesh
from edl_tpu.runtime import ShardedDataIterator as JaxIterator
from edl_tpu.runtime import Trainer as JaxTrainer
from edl_tpu.runtime.data import synthetic_dataset as jax_synthetic_dataset
from edl_tpu_torch.convert import flax_from_params, params_from_flax
from edl_tpu_torch.models import get_model
from edl_tpu_torch.models.transformer_lm import lm_flops
from edl_tpu_torch.runtime import ShardedDataIterator, Trainer, synthetic_dataset

ROOT = Path(__file__).resolve().parents[1]
V, D, FF, H, LAYERS, L = 256, 64, 256, 4, 2, 64
LR = 1e-3
STEPS = 3
GRAD_TOL = {"float32": 2e-3, "bfloat16": 2e-2}


def _jax_model(dtype: str):
    """The registered JAX tiny LM (bf16 compute), or the same model in
    float32 compute with the reference's own ``loss_fn`` body."""
    base = jax_get_model("transformer_lm", tiny=True)
    if dtype == "bfloat16":
        return base
    module = FlaxLM(V, D, FF, H, LAYERS, L, dtype=jnp.float32)

    def loss_fn(params, batch, rng):
        tokens = batch["tokens"]
        labels = tokens[:, 1:]
        x = module.apply({"params": params}, tokens[:, :-1], return_features=True)
        loss, _ = jax_best_vocab_xent(x, params["embed"]["embedding"], labels, labels != 0)
        return loss, {"loss": loss}

    return dataclasses.replace(base, loss_fn=loss_fn)


def _port_model(dtype: str):
    return get_model("transformer_lm", tiny=True, dtype=getattr(torch, dtype))


def _dataset():
    """The synthetic corpus with some label-0 tokens (masked out of the
    loss), unevenly over the rows."""
    ds = jax_synthetic_dataset(_jax_model("bfloat16").synth_batch, 64, seed=0)
    ds["tokens"][::3, 10:20] = 0
    return ds


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_to_scale(got, want, tol, what=""):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


def _assert_params_close(got: dict, want: dict):
    """Parameters after ``STEPS`` Adam steps (see the module docstring)."""
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        assert diff.max() <= 2 * STEPS * LR, name
        if name.endswith("['attn']['qkv']['bias']"):
            diff = np.delete(diff, 1, axis=0)  # [3, H, Dh]: q, k, v
        assert (diff > 1e-4).mean() <= 1e-3, (name, float(diff.max()))


@pytest.fixture(scope="module")
def jax_init():
    """The JAX tiny LM's initial params (numpy tree), made once."""
    params = _jax_model("bfloat16").init_params(jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("dtype", sorted(GRAD_TOL))
def test_lm_loss_and_grads_match_flax(jax_init, dtype):
    tokens = _dataset()["tokens"][:4]
    jm = _jax_model(dtype)
    (want_loss, _), want = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jax_init, {"tokens": jnp.asarray(tokens)}, jax.random.key(1)
    )
    model = _port_model(dtype)
    params = model.train_params(params_from_flax(jax_init), "cpu")
    loss, aux = model.loss_fn(params, {"tokens": torch.from_numpy(tokens)})
    loss.backward()
    assert int(aux["valid_tokens"]) == int((tokens[:, 1:] != 0).sum())
    tol = GRAD_TOL[dtype]
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=tol)
    grads = {n: p.grad for n, p in params.named_parameters()}
    assert all(g.dtype == torch.float32 for g in grads.values())
    got, want = _flat(flax_from_params(grads, H)), _flat(want)
    assert got.keys() == want.keys()
    for name in want:
        _close_to_scale(got[name], want[name], tol, name)


def _run_jax_trainer(dtype, init, ds):
    jm = _jax_model(dtype)
    mesh = dp_mesh(1, jax.devices("cpu")[:1])
    trainer = JaxTrainer(jm, optax.adam(LR), mesh, seed=0)
    state = trainer.init_state()
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, init))
    state = state.replace(opt_state=optax.adam(LR).init(state.params))
    it = JaxIterator(ds, 8, seed=0)
    losses = []
    for step in range(STEPS):
        state, metrics = trainer.step(state, it.device_batch(step, mesh))
        losses.append(float(metrics["loss"]))
    return losses, state


def _run_port_trainer(dtype, init, ds):
    trainer = Trainer(_port_model(dtype), lr=LR, device="cpu", seed=0)
    state = trainer.init_state(params_from_flax(init))
    it = ShardedDataIterator(ds, 8, seed=0)
    losses = []
    for step in range(STEPS):
        state, metrics = trainer.step(state, it.device_batch(step, "cpu"))
        losses.append(metrics["loss"].item())
    assert state.step == STEPS
    return losses, state


def _port_tree(state, key=None):
    """The port's params (or an Adam moment) as the flat flax tree."""
    if key is None:
        sd = state.params.state_dict()
    else:
        sd = {n: state.opt_state.state[p][key] for n, p in state.params.named_parameters()}
    return _flat(flax_from_params(sd, H))


def test_trainer_matches_jax_trainer_with_optax_adam(jax_init):
    """Float32 compute: the loss stream to 1e-4, Adam's moments to 2e-3
    of each leaf's largest, the parameters as ``_assert_params_close``
    says."""
    ds = _dataset()
    want_losses, jstate = _run_jax_trainer("float32", jax_init, ds)
    losses, state = _run_port_trainer("float32", jax_init, ds)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    assert losses[-1] < losses[0]
    adam = jstate.opt_state[0]
    for key, moment in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        got, want = _port_tree(state, key), _flat(moment)
        for name in want:
            _close_to_scale(got[name], want[name], 2e-3, f"{key} {name}")
    _assert_params_close(_port_tree(state), _flat(jstate.params))


def test_trainer_bf16_loss_stream_tracks_jax_trainer(jax_init):
    """The registered (bf16 compute) model: bf16 rounding leaves the
    loss stream within 5e-3."""
    ds = _dataset()
    want_losses, _ = _run_jax_trainer("bfloat16", jax_init, ds)
    losses, state = _run_port_trainer("bfloat16", jax_init, ds)
    np.testing.assert_allclose(losses, want_losses, rtol=5e-3)
    assert all(p.dtype == torch.float32 for p in state.params.parameters())


def test_data_iterator_bytes_equal_the_reference():
    ds = _dataset()
    want, got = JaxIterator(ds, 16, seed=7), ShardedDataIterator(ds, 16, seed=7)
    for step in (0, 1, 3, 4, 9):  # 4 batches per epoch: crosses epochs
        np.testing.assert_array_equal(got.global_indices(step), want.global_indices(step))
        for world in (1, 2, 4):
            for rank in range(world):
                a = got.host_batch(step, world, rank)["tokens"]
                b = want.host_batch(step, world, rank)["tokens"]
                assert a.tobytes() == b.tobytes()
        t = got.device_batch(step, "cpu", world=2, rank=1)["tokens"]
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), want.host_batch(step, 2, 1)["tokens"])
    a = synthetic_dataset(_port_model("float32").synth_batch, 8, seed=3)["tokens"]
    b = jax_synthetic_dataset(_jax_model("bfloat16").synth_batch, 8, seed=3)["tokens"]
    assert a.tobytes() == b.tobytes()
    with pytest.raises(ValueError):
        got.host_batch(0, world=3, rank=0)


def test_training_contract_of_the_model():
    """Trainable parameters are float32 (flax's param_dtype) while the
    serving bind keeps bf16 weights; FLOP accounting is the
    reference's."""
    model = get_model("transformer_lm", tiny=True)
    sd = model.init_params(torch.Generator().manual_seed(0))
    train = model.train_params(sd, "cpu")
    assert all(p.dtype == torch.float32 and p.requires_grad for p in train.parameters())
    serve = model.bind_params(sd, "cpu")
    assert serve.layers[0].wi.weight.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in serve.parameters())
    full = get_model("transformer_lm")
    jfull = jax_get_model("transformer_lm")
    assert full.flops_per_example == jfull.flops_per_example == lm_flops(32000, 768, 3072, 12, 2048)
    assert full.tokens_per_example == jfull.tokens_per_example == 2048
    assert lm_flops(V, D, FF, LAYERS, L) == jax_lm_flops(V, D, FF, LAYERS, L)
    with pytest.raises(ValueError, match="no training"):
        Trainer(dataclasses.replace(model, loss_fn=None), device="cpu")


_WORKER = """
import sys, torch, torch.distributed as dist
from edl_tpu_torch.models import get_model
from edl_tpu_torch.runtime import ShardedDataIterator, Trainer
rank, port, data, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)  # a tiny model; keep the test suite's cores for the others
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
ds = {"tokens": torch.load(data).numpy()}
trainer = Trainer(get_model("transformer_lm", tiny=True, dtype=torch.float32),
                  lr=%r, device="cpu", seed=0, process_group=dist.group.WORLD)
state = trainer.init_state()
it = ShardedDataIterator(ds, 8, seed=0)
losses, grads = [], None
for step in range(%d):
    state, m = trainer.step(state, it.device_batch(step, "cpu", world=2, rank=rank))
    losses.append(m["loss"].item())
    if grads is None:
        grads = {n: p.grad.clone() for n, p in state.params.named_parameters()}
if rank == 0:
    torch.save({"losses": losses, "grads": grads, "params": state.params.state_dict()}, out)
dist.destroy_process_group()
""" % (LR, STEPS)


def test_dp2_on_gloo_equals_dp1(tmp_path):
    """Two processes, each with half of every global batch (uneven
    valid-token counts), step like one process with all of it: the
    loss stream to 1e-5; the first step's averaged gradients to 2e-3 of
    each leaf's largest (the tied projection's share of the embedding
    gradient is a bf16 gradient, rounded on each rank before the sum);
    the parameters as ``_assert_params_close`` says."""
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
    dp2 = torch.load(out)

    trainer = Trainer(_port_model("float32"), lr=LR, device="cpu", seed=0)
    state = trainer.init_state()
    it = ShardedDataIterator(ds, 8, seed=0)
    losses, grads = [], None
    for step in range(STEPS):
        state, m = trainer.step(state, it.device_batch(step, "cpu"))
        losses.append(m["loss"].item())
        if grads is None:
            grads = {n: p.grad.clone() for n, p in state.params.named_parameters()}
    np.testing.assert_allclose(dp2["losses"], losses, rtol=1e-5)
    for name, g in grads.items():
        _close_to_scale(dp2["grads"][name].numpy(), g.numpy(), GRAD_TOL["float32"], name)
    _assert_params_close(
        _flat(flax_from_params(dp2["params"], H)),
        _flat(flax_from_params(state.params.state_dict(), H)),
    )
