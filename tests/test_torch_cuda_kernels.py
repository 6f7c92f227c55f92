"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one.  They import no JAX, so they run on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py -m cuda
"""

import pytest
import torch

from edl_tpu_torch.ops import fused_attention
from edl_tpu_torch.ops.flash_attention import (
    LAUNCHES,
    flash_attention_plain,
    flash_attention_with_lse,
    flash_fwd_cuda,
)

#: bf16/f16 tolerance of the repo's flash tests
TOL = 3e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _rand(g, shape, dtype):
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,T,Tk,H,D,causal,dtype",
    [
        (1, 16, 16, 12, 64, True, torch.bfloat16),
        (2, 200, 200, 3, 64, True, torch.bfloat16),
        (1, 100, 37, 2, 128, False, torch.bfloat16),
        (2, 65, 65, 4, 32, True, torch.float16),
        (3, 64, 64, 4, 16, True, torch.bfloat16),
    ],
)
def test_flash_fwd_matches_plain(cuda, B, T, Tk, H, D, causal, dtype):
    q = _rand(cuda, (B, T, H, D), dtype)
    k = _rand(cuda, (B, Tk, H, D), dtype)
    v = _rand(cuda, (B, Tk, H, D), dtype)
    o, lse = flash_fwd_cuda(q, k, v, causal, D ** -0.5)
    torch.cuda.synchronize()
    po, plse = flash_attention_plain(q, k, v, causal, D ** -0.5)
    torch.testing.assert_close(o.float(), po.float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, plse, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
def test_flash_fwd_key_mask_and_fully_masked_row(cuda):
    q, k, v = (_rand(cuda, (2, 130, 3, 64), torch.bfloat16) for _ in range(3))
    mask = torch.rand((2, 130), generator=cuda, device="cuda") > 0.3
    mask[1] = False
    o, lse = flash_attention_with_lse(q, k, v, causal=False, kv_mask=mask)
    torch.cuda.synchronize()
    po, plse = flash_attention_plain(q, k, v, False, None, mask)
    torch.testing.assert_close(o.float(), po.float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, plse, atol=1e-3, rtol=1e-4)
    assert o[1].abs().max().item() == 0.0


@pytest.mark.cuda
def test_fused_attention_takes_the_kernel_on_strided_qkv_views(cuda):
    """The model hands the kernel q/k/v as views into one fused QKV
    projection ([B, T, 3, H, D]); no copy, one launch."""
    qkv = _rand(cuda, (1, 96, 3, 12, 64), torch.bfloat16)
    q, k, v = qkv.unbind(2)
    before = LAUNCHES["flash_fwd"]
    out = fused_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_fwd"] == before + 1
    want = flash_attention_plain(q, k, v, True)[0]
    torch.testing.assert_close(out.float(), want.float(), atol=TOL, rtol=TOL)
