"""The port's flash attention against the JAX package's Pallas kernels.

The same numpy inputs (``np.random.RandomState``) go through
``edl_tpu.ops.flash_attention_with_lse`` in interpret mode (16x16
tiles, as ``tests/test_flash_attention.py`` runs it on the CPU) and
through the port's ``flash_attention_plain`` / ``flash_attention_with_lse``
on CPU tensors; the backward through ``jax.vjp`` (the merged
``_bwd_kernel``) and through the port's ``flash_bwd_plain`` and CPU
autograd.  Forward tolerances are ``tests/test_flash_attention.py``'s:
2e-5 for float32, 3e-2 for bf16; gradients are held at 1e-4 (float32)
and 3e-2 (bf16) of their largest magnitude.  The CUDA kernels
themselves are held against the plain versions on the card
(``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.ops.flash_attention import flash_attention_with_lse as jax_flash
from edl_tpu.ops.ring_attention import reference_attention as jax_reference
from edl_tpu_torch.ops import fused_attention
from edl_tpu_torch.ops.flash_attention import (
    bwd_impl,
    flash_attention,
    flash_attention_plain,
    flash_attention_with_lse,
    flash_bwd_cuda,
    flash_bwd_plain,
    flash_bwd_streamk_cuda,
    flash_fwd_cuda,
    merged_bwd_fits,
)
from edl_tpu_torch.ops.ring_attention import reference_attention

F32_TOL = 2e-5
BF16_TOL = 3e-2
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _inputs(seed, B=2, T=64, H=2, D=16, Tk=None):
    rng = np.random.RandomState(seed)
    Tk = Tk or T
    q = rng.randn(B, T, H, D).astype(np.float32)
    k = rng.randn(B, Tk, H, D).astype(np.float32)
    v = rng.randn(B, Tk, H, D).astype(np.float32)
    return q, k, v


def _jax(q, k, v, causal, mask=None, dtype=jnp.float32):
    o, lse = jax_flash(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        causal=causal,
        kv_mask=None if mask is None else jnp.asarray(mask),
        block_q=16, block_k=16, interpret=True,
    )
    return np.asarray(o, np.float32), np.asarray(lse, np.float32)


def _torch(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize(
    "causal,T,masked",
    [(True, 64, False), (False, 64, False), (True, 96, False), (False, 48, True)],
    ids=["causal", "full", "causal-T96", "kv_mask"],
)
def test_flash_matches_jax_kernel_f32(causal, T, masked):
    """O and lse of both port functions match the Pallas kernel; T=96
    is not a multiple of the 64-row tile the CUDA kernel uses."""
    q, k, v = _inputs(T, T=T)
    mask = None
    if masked:
        mask = np.random.RandomState(1).rand(2, T) > 0.3
    want_o, want_lse = _jax(q, k, v, causal, mask)
    tm = None if mask is None else torch.from_numpy(mask)
    for fn in (flash_attention_plain, flash_attention_with_lse):
        o, lse = fn(_torch(q), _torch(k), _torch(v), causal, None, tm)
        assert o.shape == (2, T, 2, 16) and lse.shape == (2, 2, T)
        assert lse.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), want_o, atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(lse.numpy(), want_lse, atol=F32_TOL, rtol=F32_TOL)


def test_fully_masked_row_gives_zero_output_and_log_tiny_lse():
    """A batch row whose keys are all masked: O = 0 and lse =
    log(1e-30), as the Pallas kernel's _safe/l_safe give (not NaN, not
    the reference oracle's uniform weights)."""
    q, k, v = _inputs(3, T=32)
    mask = np.ones((2, 32), bool)
    mask[1] = False
    want_o, want_lse = _jax(q, k, v, False, mask)
    o, lse = flash_attention_with_lse(
        _torch(q), _torch(k), _torch(v), False, None, torch.from_numpy(mask)
    )
    np.testing.assert_allclose(o.numpy(), want_o, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=F32_TOL, rtol=F32_TOL)
    assert np.all(o.numpy()[1] == 0.0)
    np.testing.assert_allclose(lse.numpy()[1], np.log(np.float32(1e-30)), rtol=1e-6)


def test_flash_bf16_matches_jax_kernel():
    q, k, v = _inputs(4, T=64)
    want_o, want_lse = _jax(q, k, v, True, dtype=jnp.bfloat16)
    o, lse = flash_attention_with_lse(
        _torch(q, torch.bfloat16), _torch(k, torch.bfloat16),
        _torch(v, torch.bfloat16), causal=True,
    )
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(), want_o, atol=BF16_TOL, rtol=BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_attention_matches_jax(dtype):
    """The oracle, causal and with a fully masked row (uniform weights
    there, unlike flash)."""
    q, k, v = _inputs(5, T=32)
    mask = np.ones((2, 32), bool)
    mask[0, 5:9] = False
    mask[1] = False
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for causal in (True, False):
        want = np.asarray(
            jax_reference(
                jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                causal=causal, kv_mask=jnp.asarray(mask),
            ),
            np.float32,
        )
        got = reference_attention(
            _torch(q, td), _torch(k, td), _torch(v, td), causal=causal,
            kv_mask=torch.from_numpy(mask),
        )
        assert got.dtype == td
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def test_fused_attention_cpu_is_the_reference_path():
    q, k, v = (_torch(x) for x in _inputs(6, T=32))
    np.testing.assert_array_equal(
        fused_attention(q, k, v, causal=True).numpy(),
        reference_attention(q, k, v, causal=True).numpy(),
    )
    np.testing.assert_array_equal(
        flash_attention(q, k, v, causal=True).numpy(),
        flash_attention_plain(q, k, v, causal=True)[0].numpy(),
    )


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """The wrapper launches only on CUDA tensors it can take; it never
    falls back to the plain version."""
    q, k, v = (_torch(x, torch.bfloat16) for x in _inputs(7, T=32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_cuda(q, k, v, True, 0.25)
    with pytest.raises(ValueError, match="square"):
        flash_attention_with_lse(q, k[:, :16], v[:, :16], causal=True)


def test_backward_dispatches_past_the_merged_range_to_streamk():
    """Where the JAX package takes its streaming-K backward (B3), so
    does the port, on CUDA and CPU alike; the model's own T=2048, D=64
    and T=16384, D=64 stay on the merged one (B2).  The CUDA wrappers
    of both backwards refuse CPU tensors rather than fall back."""
    assert bwd_impl(2048, 64) == bwd_impl(16384, 64) == "merged"
    for t, d in ((16385, 16), (14400, 128)):
        assert not merged_bwd_fits(t, d)
        assert bwd_impl(t, d) == "streamk"
    q = torch.zeros((1, 32, 1, 16), dtype=torch.bfloat16)
    lse = torch.zeros((1, 1, 32))
    args = (q, q, q, q, lse, q, None, None, True, 0.25)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_cuda(*args)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_streamk_cuda(*args, 16)


def _jax_grads(q, k, v, do, g_lse, causal, mask, dtype):
    def f(q, k, v):
        return jax_flash(
            q, k, v, causal=causal,
            kv_mask=None if mask is None else jnp.asarray(mask),
            block_q=16, block_k=16, interpret=True,
        )

    jd = getattr(jnp, dtype)
    (o, lse), vjp = jax.vjp(f, *(jnp.asarray(x, jd) for x in (q, k, v)))
    grads = vjp((jnp.asarray(do, jd), jnp.asarray(g_lse, jnp.float32)))
    return [np.asarray(g, np.float32) for g in grads]


def _close_to_scale(got, want, tol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize(
    "causal,masked,dtype",
    [(True, False, "float32"), (False, True, "float32"), (True, False, "bfloat16")],
    ids=["causal-f32", "kv_mask-f32", "causal-bf16"],
)
def test_backward_matches_jax_merged_kernel(causal, masked, dtype):
    """dQ, dK, dV of ``flash_bwd_plain`` and of the port's CPU autograd
    against ``jax.vjp`` through the Pallas merged backward, with a
    nonzero lse cotangent; the masked case has a batch row with every
    key masked, whose gradients are exactly 0."""
    T = 48
    q, k, v = _inputs(11, T=T)
    rng = np.random.RandomState(12)
    do = rng.randn(*q.shape).astype(np.float32)
    g_lse = rng.randn(2, 2, T).astype(np.float32)
    mask = None
    if masked:
        mask = rng.rand(2, T) > 0.3
        mask[1] = False
    want = _jax_grads(q, k, v, do, g_lse, causal, mask, dtype)
    td = getattr(torch, dtype)
    tm = None if mask is None else torch.from_numpy(mask)
    tq, tk, tv = (_torch(x, td).requires_grad_(True) for x in (q, k, v))
    o, lse = flash_attention_with_lse(tq, tk, tv, causal, None, tm)
    autograd = torch.autograd.grad(
        (o, lse), (tq, tk, tv), (_torch(do, td), torch.from_numpy(g_lse))
    )
    plain = flash_bwd_plain(
        tq.detach(), tk.detach(), tv.detach(), o.detach(), lse.detach(),
        _torch(do, td), torch.from_numpy(g_lse), tm, causal, 16 ** -0.5,
    )
    for grads in (autograd, plain):
        for g, w in zip(grads, want):
            assert g.dtype == td
            _close_to_scale(g.float().numpy(), w, GRAD_TOL[dtype])
            if masked:
                assert np.all(g.float().numpy()[1] == 0.0)
