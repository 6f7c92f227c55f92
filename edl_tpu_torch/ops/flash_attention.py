"""Flash attention forward (counterpart of
``edl_tpu/ops/flash_attention.py``).

Public functions take and return the JAX package's layout:
``q, k, v`` are ``[B, T, H, D]``; ``flash_attention_with_lse`` returns
``(o [B, Tq, H, D], lse [B, H, Tq] float32)``.

- On a CUDA tensor they launch the hand-written kernel
  ``csrc/flash_fwd.cu`` (built at first use, see ``_build``), which
  replaces the TPU kernel ``_fwd_kernel``.  Anything the kernel does
  not take raises; nothing falls back to the plain version.
- On a CPU tensor they run ``flash_attention_plain``, the plain PyTorch
  version of the same function (what the CPU tests check against the
  JAX kernel in interpret mode).

The backward kernels (``_bwd_kernel``, ``_bwd_streamk_kernel``) come
with the training slice: the autograd function's backward raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from edl_tpu_torch.ops import _build
from edl_tpu_torch.ops.ring_attention import NEG_INF

#: launches of each kernel wrapper in this process.  A wrapper adds one
#: where it launches its kernel and nowhere else; a run that resets the
#: counts before a path and reads them after shows which kernels the
#: path went through.
LAUNCHES: Dict[str, int] = {"flash_fwd": 0}

_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_BLOCKS_Y = 65535

_fn = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _safe(m: torch.Tensor) -> torch.Tensor:
    """Row maxima still at NEG_INF (fully masked rows) count as 0, so
    their probabilities are exp(NEG_INF) == 0, not exp(0) == 1."""
    return torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, in one pass instead of
    by tiles: float32 scores scaled after the product, masked keys at
    NEG_INF, probabilities cast to ``v.dtype`` before the PV product
    (float32 accumulation), and a fully masked row giving O = 0 and
    lse = log(1e-30).  Returns ``(o [B,Tq,H,D] in q.dtype,
    lse [B,H,Tq] float32)``."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    tq, tk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask.bool()[:, None, None, :], NEG_INF)
    m = _safe(s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def _kernel_fn():
    """The kernel's C entry point, built and declared on first use."""
    global _fn
    if _fn is None:
        lib = _build.load("flash_fwd")
        fn = lib.edl_flash_fwd
        ptr = ctypes.c_void_p
        i32 = ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [
            i32, ptr, ptr, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i32,
            strides, strides, strides,
            ctypes.c_float, i32, ptr,
        ]
        fn.restype = i32
        _fn = fn
    return _fn


def _check_operand(name: str, x: torch.Tensor, ref: torch.Tensor) -> None:
    if x.device != ref.device:
        raise ValueError(f"{name} is on {x.device}, q on {ref.device}")
    if x.dtype != ref.dtype:
        raise ValueError(f"{name} is {x.dtype}, q is {ref.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name} must be [B, T, H, D], got {tuple(x.shape)}")
    if x.stride(-1) != 1:
        raise ValueError(f"{name}'s head dim must be contiguous")
    if any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(
            f"{name}'s rows must be 16-byte aligned (strides "
            f"{x.stride()} in elements must be multiples of 8)"
        )


def flash_fwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool,
    scale: float,
    kv_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on PyTorch's current stream.  Checks
    device, dtype, shape and layout and raises on anything the kernel
    does not take; raises if the launch returns a CUDA error."""
    if not q.is_cuda:
        raise ValueError(f"flash_fwd_cuda needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_fwd_cuda takes bf16 or f16, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if k.shape != (b, tk, h, d) or v.shape != k.shape:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)}"
        )
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    if b * h > _MAX_BLOCKS_Y:
        raise ValueError(f"B*H = {b * h} exceeds {_MAX_BLOCKS_Y}")
    if causal and tq != tk:
        raise ValueError(f"causal requires square attention, got {tq=} {tk=}")
    mask_ptr = None
    if kv_mask is not None:
        if (
            kv_mask.dtype != torch.bool
            or kv_mask.shape != (b, tk)
            or kv_mask.device != q.device
            or not kv_mask.is_contiguous()
        ):
            raise ValueError(
                "kv_mask must be a contiguous bool [B, Tk] tensor on q's "
                f"device, got {kv_mask.dtype} {tuple(kv_mask.shape)}"
            )
        mask_ptr = kv_mask.data_ptr()
    fn = _kernel_fn()
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    strides = [
        (ctypes.c_longlong * 3)(*x.stride()[:3]) for x in (q, k, v)
    ]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask_ptr, o.data_ptr(), lse.data_ptr(),
            b, h, tq, tk, d, *strides, float(scale), int(bool(causal)),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


class _FlashFwd(torch.autograd.Function):
    """The kernel as an autograd node.  Its backward is the TPU
    package's merged/streaming-K backward kernels, not ported yet."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale):
        return flash_fwd_cuda(q, k, v, causal, scale, kv_mask)

    @staticmethod
    def backward(ctx, g_o, g_lse):
        raise NotImplementedError(
            "flash attention backward is not ported yet (ROADMAP queue B "
            "items 2-3: _bwd_kernel / _bwd_streamk_kernel)"
        )


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention over ``[B, T, H, D]`` that also returns the
    per-row logsumexp: ``(o [B, Tq, H, D], lse [B, H, Tq] float32)``.
    ``kv_mask``: optional ``[B, Tk]`` bool (True = attend).  CUDA
    tensors launch the kernel; CPU tensors run the plain version."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            f"causal requires square attention, got {q.shape[1]=} "
            f"{k.shape[1]=}"
        )
    if q.is_cuda:
        if kv_mask is not None:
            kv_mask = kv_mask.to(torch.bool).contiguous()
        return _FlashFwd.apply(q, k, v, kv_mask, causal, scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale, kv_mask)
    raise ValueError(f"flash attention has no path for device {q.device}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``flash_attention_with_lse`` without the lse."""
    return flash_attention_with_lse(q, k, v, causal, scale, kv_mask)[0]


__all__ = [
    "LAUNCHES",
    "flash_attention",
    "flash_attention_plain",
    "flash_attention_with_lse",
    "flash_fwd_cuda",
    "reset_launch_counts",
]
