"""The port's tied-vocab cross entropy against the JAX package's.

The same numpy inputs go through the JAX functions on the CPU and the
port's on CPU tensors:

- the Pallas kernels of ``edl_tpu/ops/fused_xent.py`` in interpret mode
  (``_fwd`` -> B4, ``_bwd`` -> B5 and B6, at 16-row x 32-vocab tiles so
  the vocab is padded) against ``xent_fwd_plain``, ``xent_dy_plain``
  and ``xent_de_plain``;
- JAX ``fused_vocab_xent`` (value and gradients) against the port's
  autograd function, with padding rows, ``valid = 0`` rows and the tie
  semantics of its accuracy;
- ``losses.tied_vocab_xent`` against the port's chunked version.

Float32 statistics agree to 1e-5 (both take bf16 x bf16 products summed
in float32, in another order).  dY and dL are rounded to bf16 on both
sides from float32 values that can differ in the last bits, so a
rounding may land one bf16 ulp apart: gradients are held at 1e-2 of
their largest magnitude.  The CUDA kernels are held against the plain
versions on the card (``tests/test_torch_cuda_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.ops import fused_xent as jfx
from edl_tpu.ops.losses import tied_vocab_xent as jax_tied
from edl_tpu_torch.ops import best_vocab_xent, tied_vocab_xent
from edl_tpu_torch.ops import fused_xent as fx

STAT_TOL = 1e-5
GRAD_TOL = 1e-2
N, V, D = 48, 75, 64  # V is not a multiple of the 32-entry vocab tile


def _close_to_scale(got, want, tol):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol, atol=tol * scale)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.fixture(scope="module")
def kernels():
    """The JAX kernels' outputs, built once: y [N, D], e [V, D] (bf16),
    labels, row scales with some rows at 0, and B4/B5/B6's results."""
    rng = np.random.RandomState(0)
    y = (rng.randn(N, D) * 0.3).astype(np.float32)
    e = rng.randn(V, D).astype(np.float32)
    labels = rng.randint(0, V, size=N).astype(np.int32)
    scale = (rng.rand(N) / N).astype(np.float32)
    scale[::5] = 0.0
    yb = jnp.asarray(y, jnp.bfloat16)
    vp = 96
    e_pad = jnp.pad(jnp.asarray(e, jnp.bfloat16), ((0, vp - V), (0, 0)))
    lab2 = jnp.asarray(labels)[:, None]
    lse3, label3, max3 = jfx._fwd(yb, e_pad, lab2, V, 16, 32)
    scale3 = jnp.broadcast_to(jnp.asarray(scale)[:, None], (N, jfx.STAT_LANES))
    dy, de = jfx._bwd(yb, e_pad, lab2, lse3, scale3, V, 16, 32)
    want = {
        "lse": np.asarray(lse3[:, 0]), "label": np.asarray(label3[:, 0]),
        "max": np.asarray(max3[:, 0]), "dy": np.asarray(dy, np.float32),
        "de": np.asarray(de, np.float32),
    }
    return y, e, labels, scale, want


def test_xent_fwd_plain_matches_the_pallas_forward(kernels):
    y, e, labels, _, want = kernels
    lse, label, row_max = fx.xent_fwd_plain(_bf16(y), _bf16(e), torch.from_numpy(labels))
    for got, name in ((lse, "lse"), (label, "label"), (row_max, "max")):
        assert got.dtype == torch.float32 and got.shape == (N,)
        np.testing.assert_allclose(got.numpy(), want[name], rtol=STAT_TOL, atol=STAT_TOL)


def test_out_of_range_label_has_label_logit_zero():
    """No valid label is outside [0, V); the port defines its label
    logit as 0 (the kernel's ``v < V`` guard, ROADMAP section C) and
    subtracts no one-hot for it."""
    rng = np.random.RandomState(5)
    y, e = _bf16(rng.randn(4, D).astype(np.float32)), _bf16(rng.randn(V, D).astype(np.float32))
    labels = torch.tensor([-1, V, V + 40, 3], dtype=torch.int32)
    lse, label, _ = fx.xent_fwd_plain(y, e, labels)
    logits = y.float() @ e.float().t()
    assert label[:3].tolist() == [0.0, 0.0, 0.0] and label[3] == logits[3, 3]
    scale = torch.ones(4)
    dl = fx.xent_de_plain(y, e, labels, lse, scale)
    want = (torch.softmax(logits, dim=1).to(torch.bfloat16).float()[:3].t() @ y.float()[:3])
    np.testing.assert_allclose(
        (dl - fx.xent_de_plain(y[3:], e, labels[3:], lse[3:], scale[3:])).numpy(),
        want.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL * float(want.abs().max()),
    )


@pytest.mark.parametrize("which", ["dy", "de"])
def test_xent_backward_plain_matches_the_pallas_kernels(kernels, which):
    """B5 (dY, bf16) and B6 (dE, float32, first V rows) from the same
    lse and row scales."""
    y, e, labels, scale, want = kernels
    args = (_bf16(y), _bf16(e), torch.from_numpy(labels),
            torch.tensor(want["lse"]), torch.from_numpy(scale))
    if which == "dy":
        got = fx.xent_dy_plain(*args)
        assert got.dtype == torch.bfloat16 and got.shape == (N, D)
    else:
        got = fx.xent_de_plain(*args)
        assert got.dtype == torch.float32 and got.shape == (V, D)
    _close_to_scale(got.float().numpy(), want[which], GRAD_TOL)
    # rows with scale 0 contribute nothing
    if which == "dy":
        assert np.all(got.float().numpy()[::5] == 0.0)


def _loss_inputs(seed, b=2, t=23):
    """features [b, t, D] (b*t rows: not a multiple of either package's
    row tile), embedding, labels with some 0 (masked out)."""
    rng = np.random.RandomState(seed)
    feats = (rng.randn(b, t, D) * 0.3).astype(np.float32)
    emb = rng.randn(V, D).astype(np.float32)
    labels = rng.randint(1, V, size=(b, t)).astype(np.int32)
    labels[:, ::4] = 0
    return feats, emb, labels


def _jax_loss_and_grads(fn, feats, emb, labels):
    def f(x, w):
        loss, acc = fn(x, w, jnp.asarray(labels), jnp.asarray(labels) != 0)
        return loss, acc

    (loss, acc), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(feats), jnp.asarray(emb)
    )
    return float(loss), float(acc), [np.asarray(g) for g in grads]


def _port_loss_and_grads(fn, feats, emb, labels):
    x = torch.from_numpy(feats).requires_grad_(True)
    w = torch.from_numpy(emb).requires_grad_(True)
    lab = torch.from_numpy(labels).long()
    loss, acc = fn(x, w, lab, lab != 0)
    loss.backward()
    assert x.grad.dtype == torch.float32 and w.grad.dtype == torch.float32
    return loss.item(), acc.item(), [x.grad.numpy(), w.grad.numpy()]


def test_fused_vocab_xent_matches_jax():
    feats, emb, labels = _loss_inputs(1)
    jfn = lambda x, w, l, v: jfx.fused_vocab_xent(x, w, l, v, block_rows=16, block_vocab=32)  # noqa: E731
    want = _jax_loss_and_grads(jfn, feats, emb, labels)
    got = _port_loss_and_grads(fx.fused_vocab_xent, feats, emb, labels)
    np.testing.assert_allclose(got[0], want[0], rtol=STAT_TOL)
    assert got[1] == want[1]
    for g, w in zip(got[2], want[2]):
        _close_to_scale(g, w, GRAD_TOL)
    # masked (label 0) rows get no feature gradient
    assert np.all(got[2][0][:, ::4] == 0.0)


def test_fused_accuracy_counts_ties_as_hits():
    """Two identical embedding rows give the label's logit and another
    equal: the fused path counts the row as a hit (label_logit >=
    row_max), the chunked path's argmax picks the first index."""
    feats, emb, labels = _loss_inputs(2, b=1, t=8)
    emb[7] = emb[5]
    labels[:] = 7
    feats[0, :] = emb[7] * 0.5  # row max is the label's (and its twin's) logit
    jfn = lambda x, w, l, v: jfx.fused_vocab_xent(x, w, l, v, block_rows=16, block_vocab=32)  # noqa: E731
    want = _jax_loss_and_grads(jfn, feats, emb, labels)
    got = _port_loss_and_grads(fx.fused_vocab_xent, feats, emb, labels)
    assert got[1] == want[1] == 1.0
    chunked = _port_loss_and_grads(tied_vocab_xent, feats, emb, labels)
    assert chunked[1] == 0.0


def test_tied_vocab_xent_matches_the_reference():
    feats, emb, labels = _loss_inputs(3)
    want = _jax_loss_and_grads(jax_tied, feats, emb, labels)
    got = _port_loss_and_grads(tied_vocab_xent, feats, emb, labels)
    np.testing.assert_allclose(got[0], want[0], rtol=STAT_TOL)
    assert got[1] == want[1]
    for g, w in zip(got[2], want[2]):
        _close_to_scale(g, w, GRAD_TOL)
    # a chunk size that splits the rows (with padding) gives the same;
    # the bf16 embedding's gradient is summed over chunks in bf16
    split = _port_loss_and_grads(
        lambda *a: tied_vocab_xent(*a, chunk_rows=16), feats, emb, labels
    )
    np.testing.assert_allclose(split[0], got[0], rtol=STAT_TOL)
    for g, w in zip(split[2], got[2]):
        _close_to_scale(g, w, GRAD_TOL)


def test_best_vocab_xent_takes_the_chunked_path_on_cpu_and_kernels_refuse_cpu():
    feats, emb, labels = _loss_inputs(4)
    args = (torch.from_numpy(feats), torch.from_numpy(emb),
            torch.from_numpy(labels).long())
    a = best_vocab_xent(*args, args[2] != 0)
    b = tied_vocab_xent(*args, args[2] != 0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    y = torch.zeros((64, D), dtype=torch.bfloat16)
    e = torch.zeros((V, D), dtype=torch.bfloat16)
    lab = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fx.xent_fwd_cuda(y, e, lab)
    with pytest.raises(ValueError, match="CUDA"):
        fx.xent_de_cuda(y, e, lab, torch.zeros(64), torch.zeros(64))


@pytest.mark.parametrize("n,v", [(1, 63), (33, 64), (65, 65)])
def test_xent_de_plain_matches_the_pallas_de_kernel_at_ragged_sizes(n, v):
    """B6's plain version, which the card holds the wgmma kernel to, against
    the Pallas ``_de_kernel`` in interpret mode at N and V off the
    kernel's 32-row Y tile and 64-row vocab tile.  The JAX side gets the
    rows padded to its 16-row tile (zero features, row scale 0)."""
    rng = np.random.RandomState(n * 1000 + v)
    y = (rng.randn(n, D) * 0.3).astype(np.float32)
    e = rng.randn(v, D).astype(np.float32)
    labels = rng.randint(0, v, size=n).astype(np.int32)
    scale = (rng.rand(n) / n).astype(np.float32)
    scale[::5] = 0.0
    n_pad, v_pad = -(-n // 16) * 16, -(-v // 32) * 32
    yb = jnp.pad(jnp.asarray(y, jnp.bfloat16), ((0, n_pad - n), (0, 0)))
    e_pad = jnp.pad(jnp.asarray(e, jnp.bfloat16), ((0, v_pad - v), (0, 0)))
    lab2 = jnp.pad(jnp.asarray(labels), (0, n_pad - n))[:, None]
    lse3, _, _ = jfx._fwd(yb, e_pad, lab2, v, 16, 32)
    scale3 = jnp.broadcast_to(
        jnp.pad(jnp.asarray(scale), (0, n_pad - n))[:, None], (n_pad, jfx.STAT_LANES))
    _, want = jfx._bwd(yb, e_pad, lab2, lse3, scale3, v, 16, 32)
    got = fx.xent_de_plain(_bf16(y), _bf16(e), torch.from_numpy(labels),
                           torch.tensor(np.asarray(lse3[:n, 0])), torch.from_numpy(scale))
    assert got.dtype == torch.float32 and got.shape == (v, D)
    _close_to_scale(got.numpy(), np.asarray(want, np.float32), GRAD_TOL)


def test_de_kernel_is_its_own_wgmma_library():
    """B4, B5 and B6 each build from their own source on the Hopper
    header (``csrc/xent_fwd.cu``, ``xent_dy.cu``, ``xent_de.cu``), each
    exporting its own entry point; the WMMA ``fused_xent.cu`` is gone."""
    from pathlib import Path

    from edl_tpu_torch.ops import _build

    csrc = Path(_build.CSRC)
    assert not (csrc / "fused_xent.cu").exists() and "fused_xent" not in _build.KERNELS
    for name in ("xent_fwd", "xent_dy", "xent_de"):
        assert name in _build.KERNELS
        text = (csrc / f"{name}.cu").read_text()
        assert f'extern "C" int edl_{name}(' in text and '#include "hopper.cuh"' in text
        others = {"xent_fwd", "xent_dy", "xent_de"} - {name}
        assert not any(f"edl_{o}(" in text for o in others)


@pytest.mark.parametrize("name,label", [
    ("void (anonymous namespace)::flash_bwd_dkdv_kernel<__nv_bfloat16, 64>"
     "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "(anonymous namespace)::BwdArgs)", "flash_bwd (B2)"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel<__nv_bfloat16, 64>"
     "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "(anonymous namespace)::BwdArgs)", "flash_bwd (B2)"),
    ("void (anonymous namespace)::xent_de_kernel<768>"
     "(CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::DeArgs)", "xent_de (B6)"),
    ("void (anonymous namespace)::xent_fwd_kernel<768>"
     "(CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::FwdArgs)", "xent_fwd (B4)"),
    ("void (anonymous namespace)::xent_dy_kernel<1024>"
     "(CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::DyArgs)", "xent_dy (B5)"),
])
def test_training_profile_files_each_kernel_under_its_own_item(name, label):
    """``profile_training`` files B2's two kernels and each of B4, B5
    and B6's own kernels under its item."""
    from edl_tpu_torch.tools.profile_training import _kernel_class

    assert _kernel_class(name) == label
