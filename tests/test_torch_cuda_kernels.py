"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one.  They import no JAX, so they run on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py -m cuda
"""

import pytest
import torch

from edl_tpu_torch.ops import fused_attention
from edl_tpu_torch.ops import fused_xent as fx
from edl_tpu_torch.ops.flash_attention import (
    LAUNCHES,
    flash_attention_plain,
    flash_attention_with_lse,
    flash_bwd_cuda,
    flash_bwd_plain,
    flash_bwd_streamk_cuda,
    flash_bwd_streamk_plain,
    flash_fwd_cuda,
    streamk_slot_width,
)

#: bf16/f16 tolerance of the repo's flash tests
TOL = 3e-2
#: gradients in bf16/f16: kernel and plain round dS and P to the input
#: type at the same points from float32 sums taken in another order, so
#: a rounding can land one ulp apart; held at this fraction of the
#: gradient's largest magnitude
GRAD_TOL = 2e-2


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


def _close_to_scale(got, want, tol):
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=tol * scale, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,T,Tk,H,D,causal,dtype,with_glse,masked",
    [
        (1, 16, 16, 12, 64, True, torch.bfloat16, False, False),
        (2, 200, 200, 3, 64, True, torch.bfloat16, True, False),
        (1, 100, 37, 2, 128, False, torch.bfloat16, True, False),
        (2, 65, 65, 4, 32, True, torch.float16, False, False),
        (3, 64, 64, 4, 16, True, torch.bfloat16, True, False),
        (2, 130, 130, 3, 64, False, torch.bfloat16, True, True),
    ],
)
def test_flash_bwd_matches_plain(cuda, B, T, Tk, H, D, causal, dtype, with_glse, masked):
    q = _rand(cuda, (B, T, H, D), dtype)
    k = _rand(cuda, (B, Tk, H, D), dtype)
    v = _rand(cuda, (B, Tk, H, D), dtype)
    do = _rand(cuda, (B, T, H, D), dtype)
    mask = None
    if masked:
        mask = torch.rand((B, Tk), generator=cuda, device="cuda") > 0.3
        mask[-1] = False  # a batch row with every key masked
    g_lse = _rand(cuda, (B, H, T), torch.float32) if with_glse else None
    scale = D ** -0.5
    o, lse = flash_fwd_cuda(q, k, v, causal, scale, mask)
    got = flash_bwd_cuda(q, k, v, o, lse, do, g_lse, mask, causal, scale)
    torch.cuda.synchronize()
    want = flash_bwd_plain(q, k, v, o, lse, do, g_lse, mask, causal, scale)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        _close_to_scale(g, w, GRAD_TOL)
    if masked:
        for g in got:
            assert g[-1].abs().max().item() == 0.0


@pytest.mark.cuda
def test_flash_backward_through_autograd_on_strided_views(cuda):
    """The model's q/k/v are views into one fused QKV projection; the
    autograd node saves them as they are, launches the backward once
    per call, and the lse output's gradient reaches the kernel."""
    qkv = _rand(cuda, (2, 96, 3, 4, 64), torch.bfloat16).requires_grad_(True)
    q, k, v = qkv.unbind(2)
    w_o = _rand(cuda, (2, 96, 4, 64), torch.bfloat16)
    w_l = _rand(cuda, (2, 4, 96), torch.float32)
    before = LAUNCHES["flash_bwd"]
    o, lse = flash_attention_with_lse(q, k, v, causal=True)
    ((o.float() * w_o.float()).sum() + (lse * w_l).sum()).backward()
    torch.cuda.synchronize()
    assert LAUNCHES["flash_bwd"] == before + 1
    want = flash_bwd_plain(
        q.detach(), k.detach(), v.detach(), o.detach(), lse.detach(), w_o,
        w_l, None, True, 64 ** -0.5,
    )
    for got, w in zip(qkv.grad.unbind(2), want):
        _close_to_scale(got, w, GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,T,H,D,causal,slot_w,dtype,with_glse,masked",
    [
        (2, 256, 3, 64, True, 64, torch.bfloat16, False, False),
        (2, 300, 2, 64, False, 48, torch.bfloat16, True, True),
        (1, 200, 2, 128, True, 70, torch.bfloat16, True, False),
        (2, 130, 4, 32, True, 16, torch.float16, False, False),
        (3, 64, 4, 16, True, 16, torch.bfloat16, True, False),
    ],
)
def test_flash_bwd_streamk_matches_plain(cuda, B, T, H, D, causal, slot_w, dtype,
                                         with_glse, masked):
    """B3 against its plain version: slots narrower than, wider than and
    not a multiple of the 64-key tile, ragged T, a key mask with a fully
    masked batch row; two runs bit-identical (no atomics)."""
    q, k, v, do = (_rand(cuda, (B, T, H, D), dtype) for _ in range(4))
    mask = None
    if masked:
        mask = torch.rand((B, T), generator=cuda, device="cuda") > 0.3
        mask[-1] = False
    g_lse = _rand(cuda, (B, H, T), torch.float32) if with_glse else None
    scale = D ** -0.5
    o, lse = flash_fwd_cuda(q, k, v, causal, scale, mask)
    args = (q, k, v, o, lse, do, g_lse, mask, causal, scale, slot_w)
    got = flash_bwd_streamk_cuda(*args)
    again = flash_bwd_streamk_cuda(*args)
    torch.cuda.synchronize()
    want = flash_bwd_streamk_plain(*args)
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, a)
        _close_to_scale(g, w, GRAD_TOL)
    if masked:
        for g in got:
            assert g[-1].abs().max().item() == 0.0


@pytest.mark.cuda
def test_autograd_takes_the_streamk_kernel_past_the_merged_range(cuda):
    """T=16385 is past ``merged_bwd_fits``: the autograd node launches
    B3 (not B2) at the default slot width, JAX's divisor pick 565."""
    q, k, v = (_rand(cuda, (1, 16385, 1, 16), torch.bfloat16).requires_grad_(True)
               for _ in range(3))
    w_o = _rand(cuda, (1, 16385, 1, 16), torch.bfloat16)
    before = dict(LAUNCHES)
    o, lse = flash_attention_with_lse(q, k, v, causal=True)
    (o.float() * w_o.float()).sum().backward()
    torch.cuda.synchronize()
    assert LAUNCHES["flash_bwd_streamk"] == before["flash_bwd_streamk"] + 1
    assert LAUNCHES["flash_bwd"] == before["flash_bwd"]
    assert streamk_slot_width(16385) == 565
    want = flash_bwd_streamk_plain(
        q.detach(), k.detach(), v.detach(), o.detach(), lse.detach(), w_o, None,
        None, True, 0.25, 565,
    )
    for got, w in zip((q.grad, k.grad, v.grad), want):
        _close_to_scale(got, w, GRAD_TOL)


def _xent_inputs(g, n, v, d, pad_rows=0):
    """Features at 0.1 and the embedding at 1, an out-of-range label,
    every 7th row at scale 0, the last ``pad_rows`` rows the padding
    ``fused_vocab_xent`` adds, and the plain version's lse."""
    y = (_rand(g, (n, d), torch.float32) * 0.1).to(torch.bfloat16)
    e = _rand(g, (v, d), torch.bfloat16)
    labels = torch.randint(0, v, (n,), generator=g, device="cuda", dtype=torch.int32)
    if n > 1:
        labels[1] = v  # out of range: label logit 0, no one-hot (ROADMAP section C)
    scale = torch.rand((n,), generator=g, device="cuda") / n
    scale[::7] = 0.0  # rows with valid 0
    if pad_rows:
        y[n - pad_rows:] = 0
        labels[n - pad_rows:] = 0
        scale[n - pad_rows:] = 0.0
    lse, _, _ = fx.xent_fwd_plain(y, e, labels)
    return y, e, labels, lse, scale


@pytest.mark.cuda
@pytest.mark.parametrize("N,V,D", [(300, 1001, 64), (256, 4096, 768), (64, 32001, 128)])
def test_xent_kernels_match_plain(cuda, N, V, D):
    y, e, labels, lse, scale = _xent_inputs(cuda, N, V, D)
    got = fx.xent_fwd_cuda(y, e, labels)
    torch.cuda.synchronize()
    for g, w in zip(got, fx.xent_fwd_plain(y, e, labels)):
        torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-4)
    _close_to_scale(fx.xent_dy_cuda(y, e, labels, lse, scale),
                    fx.xent_dy_plain(y, e, labels, lse, scale), GRAD_TOL)
    _close_to_scale(fx.xent_de_cuda(y, e, labels, lse, scale),
                    fx.xent_de_plain(y, e, labels, lse, scale), GRAD_TOL)


@pytest.mark.cuda
def test_fused_vocab_xent_on_the_card_matches_the_cpu_path(cuda):
    """The autograd function on CUDA (kernels) and on CPU (plain) from
    the same inputs: loss, accuracy, dY and dE; rows padded to the row
    tile and label-0 rows masked out."""
    feats = _rand(cuda, (3, 50, 64), torch.float32) * 0.1
    emb = _rand(cuda, (1001, 64), torch.float32)
    labels = torch.randint(0, 1001, (3, 50), generator=cuda, device="cuda")
    labels[:, ::5] = 0
    out = {}
    for dev in ("cuda", "cpu"):
        f = feats.detach().to(dev, copy=True).requires_grad_(True)
        w = emb.detach().to(dev, copy=True).requires_grad_(True)
        lab = labels.to(dev)
        before = dict(fx.LAUNCHES)
        loss, acc = fx.fused_vocab_xent(f, w, lab, lab != 0)
        loss.backward()
        if dev == "cuda":
            assert all(fx.LAUNCHES[k] == before[k] + 1 for k in before)
        out[dev] = [loss.detach().cpu(), acc.cpu(), f.grad.cpu(), w.grad.cpu()]
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-4, rtol=1e-4)
    assert abs(out["cuda"][1].item() - out["cpu"][1].item()) <= 1.0 / 120
    for g, w in zip(out["cuda"][2:], out["cpu"][2:]):
        _close_to_scale(g, w, GRAD_TOL)


# -- the wgmma/TMA kernels' tile edges (192-row Q tiles at D <= 64 and
# 128-key K/V tiles of B1; 128-key tiles and 64-row Q tiles of B3) --------------------

#: a kernel whose mbarrier pipeline hangs would stall the run; past this
#: many seconds a test ends the process with a traceback instead (the
#: kernels' own barrier watchdog traps after 10 s)
CARD_TEST_SECONDS = 300


@pytest.fixture
def watchdog():
    import faulthandler

    faulthandler.dump_traceback_later(CARD_TEST_SECONDS, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _fwd_twice_against_plain(q, k, v, causal, mask=None):
    scale = q.shape[-1] ** -0.5
    o, lse = flash_fwd_cuda(q, k, v, causal, scale, mask)
    o2, lse2 = flash_fwd_cuda(q, k, v, causal, scale, mask)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)  # no atomics
    po, plse = flash_attention_plain(q, k, v, causal, scale, mask)
    torch.testing.assert_close(o.float(), po.float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, plse, atol=1e-3, rtol=1e-4)
    return o, lse


@pytest.mark.cuda
@pytest.mark.parametrize("T", [127, 128, 129, 130, 191, 192, 193])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_ragged_tile_edges(cuda, watchdog, T, causal):
    """Ragged 128-key K/V tiles and ragged Q tiles (192 rows at D = 64:
    TMA's zero fill past the end, masked keys, rows not written), two
    runs bit-identical."""
    q, k, v = (_rand(cuda, (2, T, 3, 64), torch.bfloat16) for _ in range(3))
    _fwd_twice_against_plain(q, k, v, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("Tk", [1, 50, 127])
def test_flash_fwd_keys_shorter_than_one_tile(cuda, watchdog, Tk):
    """Not causal, Tq != Tk, every key in one ragged K/V tile."""
    q = _rand(cuda, (2, 300, 2, 64), torch.bfloat16)
    k, v = (_rand(cuda, (2, Tk, 2, 64), torch.bfloat16) for _ in range(2))
    _fwd_twice_against_plain(q, k, v, False)


@pytest.mark.cuda
def test_flash_fwd_head_dim_128_at_4096(cuda, watchdog):
    """D = 128: two 64-column panels per tile (two TMA boxes per row)."""
    q, k, v = (_rand(cuda, (1, 4096, 2, 128), torch.bfloat16) for _ in range(3))
    _fwd_twice_against_plain(q, k, v, True)


@pytest.mark.cuda
def test_flash_fwd_f16_head_dim_32(cuda, watchdog):
    """f16 with 64-byte rows (the 64-byte swizzle), a key mask with a
    fully masked batch row."""
    q, k, v = (_rand(cuda, (2, 1000, 3, 32), torch.float16) for _ in range(3))
    mask = torch.rand((2, 1000), generator=cuda, device="cuda") > 0.3
    mask[-1] = False
    o, _ = _fwd_twice_against_plain(q, k, v, False, mask)
    assert o[-1].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,T,H,D,causal,slot_w,masked",
    [
        (1, 700, 2, 64, True, 200, False),
        (2, 512, 2, 64, False, 130, True),
        (1, 1000, 3, 64, True, 333, True),
        (2, 600, 2, 32, True, 257, False),
    ],
)
def test_flash_bwd_streamk_slots_off_the_key_tile(cuda, watchdog, B, T, H, D, causal,
                                                  slot_w, masked):
    """B3 with slot widths that are not a multiple of its 128-key tile
    (a key tile crosses into the next slot and is masked there), a key
    mask with a fully masked batch row, two runs bit-identical."""
    q, k, v, do = (_rand(cuda, (B, T, H, D), torch.bfloat16) for _ in range(4))
    mask = None
    if masked:
        mask = torch.rand((B, T), generator=cuda, device="cuda") > 0.3
        mask[-1] = False
    g_lse = _rand(cuda, (B, H, T), torch.float32)
    scale = D ** -0.5
    o, lse = flash_fwd_cuda(q, k, v, causal, scale, mask)
    args = (q, k, v, o, lse, do, g_lse, mask, causal, scale, slot_w)
    got = flash_bwd_streamk_cuda(*args)
    again = flash_bwd_streamk_cuda(*args)
    torch.cuda.synchronize()
    want = flash_bwd_streamk_plain(*args)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        _close_to_scale(g, w, GRAD_TOL)
    if masked:
        for g in got:
            assert g[-1].abs().max().item() == 0.0


# -- the redesigned B2 (dK/dV kernel: 128-key tiles over 64-row Q tiles;
# dQ kernel: 128-row Q tiles over 128-key tiles) and B6 (64 vocab rows
# per block over 32-row Y tiles) -----------------------------------------


def _bwd_twice_against_plain(q, k, v, causal, mask=None, with_glse=True, g=None):
    """B2 from B1's O and lse, run twice (bit-identical: no atomics) and
    held against its plain version."""
    b, tq, h, d = q.shape
    do = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
    g_lse = torch.randn((b, h, tq), generator=g, device="cuda") if with_glse else None
    scale = d ** -0.5
    o, lse = flash_fwd_cuda(q, k, v, causal, scale, mask)
    got = flash_bwd_cuda(q, k, v, o, lse, do, g_lse, mask, causal, scale)
    again = flash_bwd_cuda(q, k, v, o, lse, do, g_lse, mask, causal, scale)
    torch.cuda.synchronize()
    want = flash_bwd_plain(q, k, v, o, lse, do, g_lse, mask, causal, scale)
    for x, y, w in zip(got, again, want):
        assert x.dtype == q.dtype and x.shape == w.shape
        assert torch.equal(x, y)
        _close_to_scale(x, w, GRAD_TOL)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("T", [63, 64, 65, 127, 128, 129, 191, 192, 193])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_ragged_tile_edges(cuda, watchdog, T, causal):
    """B2 at the edges of its 64-row and 128-row Q tiles and 128-key
    tiles: TMA's zero fill past the end, masked keys and rows, rows not
    written."""
    q, k, v = (_rand(cuda, (2, T, 3, 64), torch.bfloat16) for _ in range(3))
    _bwd_twice_against_plain(q, k, v, causal, g=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("T,Tk", [(300, 50), (65, 129), (200, 1)])
def test_flash_bwd_keys_unlike_queries(cuda, watchdog, T, Tk):
    """Not causal, Tq != Tk: fewer keys than one tile, more keys than
    query rows, a single key."""
    q = _rand(cuda, (2, T, 2, 64), torch.bfloat16)
    k, v = (_rand(cuda, (2, Tk, 2, 64), torch.bfloat16) for _ in range(2))
    _bwd_twice_against_plain(q, k, v, False, g=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "D,dtype,causal,masked",
    [
        (16, torch.bfloat16, True, False),
        (32, torch.float16, False, True),
        (128, torch.bfloat16, True, False),
        (128, torch.float16, False, True),
        (64, torch.float16, True, False),
    ],
)
def test_flash_bwd_head_dims_f16_and_key_mask(cuda, watchdog, D, dtype, causal, masked):
    """B2 at D 16/32/128 (32-, 64-byte and two 128-byte panels), f16, the
    lse cotangent, and a key mask with a fully masked batch row (its
    gradients exactly 0)."""
    T = 1000 if D < 128 else 600
    q, k, v = (_rand(cuda, (2, T, 3, D), dtype) for _ in range(3))
    mask = None
    if masked:
        mask = torch.rand((2, T), generator=cuda, device="cuda") > 0.3
        mask[-1] = False
    got = _bwd_twice_against_plain(q, k, v, causal, mask, g=cuda)
    if masked:
        for x in got:
            assert x[-1].abs().max().item() == 0.0


def _de_twice_against_plain(g, n, v, d, pad_rows=0):
    """B6 run twice (bit-identical) and held against its plain version at
    the whole tensor's scale and row by row (each dE row against its own
    norm, floored at 1e-3 of the largest row's).  The features are at
    the scale of ``_xent_inputs`` (0.1); unit features are held against
    float64 in ``test_xent_grads_unit_features_against_float64``."""
    y, e, labels, lse, scale = _xent_inputs(g, n, v, d, pad_rows)
    got = fx.xent_de_cuda(y, e, labels, lse, scale)
    again = fx.xent_de_cuda(y, e, labels, lse, scale)
    torch.cuda.synchronize()
    want = fx.xent_de_plain(y, e, labels, lse, scale)
    assert got.dtype == torch.float32 and got.shape == (v, d)
    assert torch.equal(got, again)
    _close_to_scale(got, want, GRAD_TOL)
    ref = want.norm(dim=-1)
    floor = 1e-3 * ref.max().clamp_min(1e-30)
    row_err = ((got - want).norm(dim=-1) / torch.maximum(ref, floor)).max().item()
    assert row_err <= 1e-2, row_err


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 63, 65, 300])
@pytest.mark.parametrize("V", [63, 64, 65, 1001, 32001])
def test_xent_de_ragged_rows_and_vocab(cuda, watchdog, N, V):
    """B6 at D = 768 with N and V off its 32-row Y tile and 64-row vocab
    tile: TMA's zero fill, vocab rows past V neither summed nor written."""
    _de_twice_against_plain(cuda, N, V, 768)


@pytest.mark.cuda
@pytest.mark.parametrize("D", list(fx._DIMS))
def test_xent_de_every_width(cuda, watchdog, D):
    """B6 at every width it is built for: one 64-column panel (D = 64),
    the dE columns split over two blocks (D = 1024), padding rows."""
    _de_twice_against_plain(cuda, 300, 1001, D, pad_rows=20)


# -- B4 (xent_fwd.cu) and B5 (xent_dy.cu): ragged N and V, every width,
# run twice bit-identical, as B6's ------------------------------------------------


def _fwd_stats_twice_against_plain(g, n, v, d, pad_rows=0):
    """B4 run twice (bit-identical) and held against its plain version:
    lse, label logit and row max."""
    y, e, labels, _, _ = _xent_inputs(g, n, v, d, pad_rows)
    got = fx.xent_fwd_cuda(y, e, labels)
    again = fx.xent_fwd_cuda(y, e, labels)
    torch.cuda.synchronize()
    want = fx.xent_fwd_plain(y, e, labels)
    for x, x2, w in zip(got, again, want):
        assert x.dtype == torch.float32 and x.shape == (n,)
        assert torch.equal(x, x2)
        torch.testing.assert_close(x, w, atol=1e-3, rtol=1e-4)
    if n > 1:
        assert got[1][1].item() == 0.0  # the out-of-range label


def _dy_twice_against_plain(g, n, v, d, pad_rows=0):
    """B5 run twice (bit-identical) and held against its plain version at
    the whole tensor's scale and row by row (each dY row against its own
    norm, floored at 1e-3 of the largest row's); rows at scale 0 are
    exactly 0."""
    y, e, labels, lse, scale = _xent_inputs(g, n, v, d, pad_rows)
    got = fx.xent_dy_cuda(y, e, labels, lse, scale)
    again = fx.xent_dy_cuda(y, e, labels, lse, scale)
    torch.cuda.synchronize()
    want = fx.xent_dy_plain(y, e, labels, lse, scale)
    assert got.dtype == torch.bfloat16 and got.shape == (n, d)
    assert torch.equal(got, again)
    assert got[scale == 0].abs().max().item() == 0.0
    _close_to_scale(got, want, GRAD_TOL)
    ref = want.float().norm(dim=-1)
    floor = 1e-3 * ref.max().clamp_min(1e-30)
    row_err = ((got.float() - want.float()).norm(dim=-1) / torch.maximum(ref, floor)).max().item()
    assert row_err <= 1e-2, row_err


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 63, 65, 300])
@pytest.mark.parametrize("V", [63, 64, 65, 1001, 32001])
def test_xent_fwd_ragged_rows_and_vocab(cuda, watchdog, N, V):
    """B4 at D = 768 with N and V off its 128-row Y tile and 256-row
    vocab tile: TMA's zero fill, vocab rows past V masked, rows past N
    not written."""
    _fwd_stats_twice_against_plain(cuda, N, V, 768)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 63, 65, 300])
@pytest.mark.parametrize("V", [63, 64, 65, 1001, 32001])
def test_xent_dy_ragged_rows_and_vocab(cuda, watchdog, N, V):
    """B5 at D = 768 with N and V off its 64-row Y tile and 32-row vocab
    tile: TMA's zero fill, vocab rows past V neither summed nor read."""
    _dy_twice_against_plain(cuda, N, V, 768)


@pytest.mark.cuda
@pytest.mark.parametrize("D", list(fx._DIMS))
def test_xent_fwd_every_width(cuda, watchdog, D):
    """B4 at every width it is built for (1 to 16 panels a tile), with
    padding rows."""
    _fwd_stats_twice_against_plain(cuda, 300, 1001, D, pad_rows=20)


@pytest.mark.cuda
@pytest.mark.parametrize("D", list(fx._DIMS))
def test_xent_dy_every_width(cuda, watchdog, D):
    """B5 at every width it is built for: one 64-column panel (D = 64),
    the dY columns split over two blocks (D = 1024), padding rows."""
    _dy_twice_against_plain(cuda, 300, 1001, D, pad_rows=20)


@pytest.mark.cuda
def test_xent_fwd_label_that_is_the_argmax_is_a_hit(cuda, watchdog):
    """Accuracy is ``label_logit >= row_max``: where each row's label is
    its argmax (features along their label's embedding row), B4 takes
    both from the same f32 logit, so they tie exactly, in every vocab
    tile and at the ragged last one."""
    n, v, d = 300, 1001, 768
    e = _rand(cuda, (v, d), torch.bfloat16)
    labels = torch.randint(0, v, (n,), generator=cuda, device="cuda", dtype=torch.int32)
    labels[-1] = v - 1
    noise = _rand(cuda, (n, d), torch.float32) * 0.05
    y = (e[labels.long()].float() * 0.1 + noise).to(torch.bfloat16)
    assert torch.equal((y.float() @ e.float().t()).argmax(dim=1), labels.long())
    lse, label_logit, row_max = fx.xent_fwd_cuda(y, e, labels)
    torch.cuda.synchronize()
    assert torch.equal(label_logit, row_max)
    assert bool((label_logit >= row_max).all())
    assert bool((lse >= row_max).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["xent_dy", "xent_de"])
@pytest.mark.parametrize("D", [768, 1024])
def test_xent_grads_unit_features_against_float64(cuda, watchdog, kernel, D):
    """B5 and B6 with unit bf16 features (logits spread by ~28-32),
    run twice bit-identical and held, like their plain versions, row by
    row against the float64 evaluation of the same function
    (``tools/xent_precision.py``).  Seed 0 at D = 1024 has a row whose
    label is its argmax: p - 1 there is ~1e-5, the ill-conditioned case
    of ROADMAP C-1."""
    from edl_tpu_torch.tools import xent_precision as xp

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    y, e, labels, lse, scale = xp.xent_inputs(g, 300, 1001, D, 1.0)
    run, plain = {"xent_dy": (fx.xent_dy_cuda, fx.xent_dy_plain),
                  "xent_de": (fx.xent_de_cuda, fx.xent_de_plain)}[kernel]
    got = run(y, e, labels, lse, scale)
    again = run(y, e, labels, lse, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = xp.float64_grads(y, e, labels, lse, scale)[0 if kernel == "xent_dy" else 1]
    kernel_err = xp.row_errors(got, ref).max().item()
    plain_err = xp.row_errors(plain(y, e, labels, lse, scale), ref).max().item()
    assert kernel_err <= 1e-2, (kernel_err, plain_err)
