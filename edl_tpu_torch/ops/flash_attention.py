"""Flash attention forward and backward (counterpart of
``edl_tpu/ops/flash_attention.py``).

Public functions take and return the JAX package's layout:
``q, k, v`` are ``[B, T, H, D]``; ``flash_attention_with_lse`` returns
``(o [B, Tq, H, D], lse [B, H, Tq] float32)``, both differentiable.

- On a CUDA tensor the forward launches the hand-written kernel
  ``csrc/flash_fwd.cu`` (replacing the TPU kernel ``_fwd_kernel``) and
  the backward one of two, picked as the JAX package's ``_bwd_common``
  picks (``bwd_impl``): ``csrc/flash_bwd.cu`` (replacing the merged
  backward ``_bwd_kernel``) where ``merged_bwd_fits``, else
  ``csrc/flash_bwd_streamk.cu`` (replacing the streaming-K backward
  ``_bwd_streamk_kernel``, dQ as per-slot partials).  All are built at
  first use (see ``_build``).  Anything the kernels do not take raises;
  nothing falls back to the plain versions.
- On a CPU tensor they run ``flash_attention_plain`` and
  ``flash_bwd_plain`` / ``flash_bwd_streamk_plain``, the plain PyTorch
  versions of the same functions (what the CPU tests check against the
  JAX kernels in interpret mode).
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
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd": 0, "flash_bwd_streamk": 0}

_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_BLOCKS_Y = 65535

#: the JAX package's switch from its merged backward to the streaming-K
#: one (``_merged_bwd_fits``: ``_MERGED_BWD_MAX_T``, the residency
#: estimate of ``_merged_bwd_residency`` against ``_VMEM_CAP_BYTES``)
_MERGED_BWD_MAX_T = 16384
_VMEM_CAP_BYTES = 100 * 1024 * 1024

#: test hook, as the JAX package's: force the backward ("merged" |
#: "streamk"); None picks by ``merged_bwd_fits``
_BWD_IMPL_OVERRIDE: Optional[str] = None

#: the streaming-K backward's slot width (keys per dQ partial): the JAX
#: package's ``_prep`` policy ``min(max(2048, tk // 8), 16384)``, so
#: about 8 partials at any long T
_STREAMK_BLOCK_K = 2048
_STREAMK_MAX_BLOCK_K = 16384
#: a slot narrower than this from the JAX package's divisor pick is not
#: taken (a prime T would give 1-key slots); see ``streamk_slot_width``
_STREAMK_MIN_DIVISOR_SLOT = 512
#: query chunks per (batch*head, slot) of the streaming-K kernel: its
#: blocks, and its dK/dV partials per key.  8 at T=32768: 432 blocks,
#: 2.42 GB of partials; 16 chunks (864 blocks, 4.03 GB) and 32 were no
#: faster for the wgmma kernel on the H100 (PERF.md section 6)
_STREAMK_Q_CHUNKS = 8

_PTR = ctypes.c_void_p
_I32 = ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
#: C signatures: dtype code, tensor pointers, (b, h, tq, tk, d), the
#: [B, T, H] strides of each strided operand, scale, causal, stream
_FWD_ARGS = [_I32, *[_PTR] * 6, *[_I32] * 5, *[_STRIDES] * 3, ctypes.c_float, _I32, _PTR]
_BWD_ARGS = [_I32, *[_PTR] * 12, *[_I32] * 5, *[_STRIDES] * 5, ctypes.c_float, _I32, _PTR]
#: as _BWD_ARGS plus the three partial buffers, the slot width and the
#: query rows per chunk
_STREAMK_ARGS = [
    _I32, *[_PTR] * 15, *[_I32] * 7, *[_STRIDES] * 5, ctypes.c_float, _I32, _PTR,
]


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
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = _keep_mask(q.shape[1], k.shape[1], causal, kv_mask, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    m = _safe(s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def _keep_mask(tq, tk, causal, kv_mask, device):
    """``[B or 1, 1, Tq, Tk]`` bool of the attended (query, key) pairs,
    or None when every pair is attended."""
    keep = None
    if causal:
        keep = torch.ones((tq, tk), dtype=torch.bool, device=device).tril()[None, None]
    if kv_mask is not None:
        km = kv_mask.bool()[:, None, None, :]
        keep = km if keep is None else keep & km
    return keep


def flash_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    g_lse: Optional[torch.Tensor],
    kv_mask: Optional[torch.Tensor],
    causal: bool,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's function in plain PyTorch, in one pass:
    float32 scores; ``P = exp(S - lse)`` with masked keys giving exactly
    0; ``delta = rowsum(dO * O) - g_lse`` from the stored O, in float32;
    ``dS = P * (dP - delta)`` cast to the input dtype before the dK and
    dQ products, P cast before the dV product; dQ and dK multiplied by
    ``scale`` after float32 accumulation.  ``lse``/``g_lse``:
    ``[B, H, Tq]``.  Returns ``(dq, dk, dv)`` in the inputs' dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = _keep_mask(q.shape[1], k.shape[1], causal, kv_mask, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - lse[..., None])
    delta = torch.einsum("bqhd,bqhd->bhq", do.float(), o.float())
    if g_lse is not None:
        delta = delta - g_lse.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_streamk_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    g_lse: Optional[torch.Tensor],
    kv_mask: Optional[torch.Tensor],
    causal: bool,
    scale: float,
    slot_w: int,
    by_head: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The streaming-K backward's function in plain PyTorch, slot by
    slot (``slot_w`` keys each, the last one ragged): per slot, float32
    scores of Q against the slot's keys, masked keys at NEG_INF,
    ``P = exp(S - lse)``; ``delta = rowsum(dO * O) - g_lse`` once per
    row; ``dS = P * (dP - delta)`` cast to the input dtype before the dK
    and dQ products, P cast before the dV product; the slot's dK, dV in
    float32 then cast, dK times ``scale``; its dQ partial in float32
    times ``scale``, the partials summed in slot order, then cast.  Under
    a causal mask the rows above a slot's first key see none of its keys
    and are left out.  ``by_head`` runs one head at a time, which bounds
    the float32 temporaries to one head's ``[Tq, slot_w]`` scores."""
    if by_head:
        parts = [
            flash_bwd_streamk_plain(
                q[:, :, h:h + 1], k[:, :, h:h + 1], v[:, :, h:h + 1],
                o[:, :, h:h + 1], lse[:, h:h + 1], do[:, :, h:h + 1],
                None if g_lse is None else g_lse[:, h:h + 1], kv_mask,
                causal, scale, slot_w,
            )
            for h in range(q.shape[2])
        ]
        return tuple(torch.cat(p, dim=2) for p in zip(*parts))
    tq, tk = q.shape[1], k.shape[1]
    qf, dof = q.float(), do.float()
    delta = torch.einsum("bqhd,bqhd->bhq", dof, o.float())
    if g_lse is not None:
        delta = delta - g_lse.float()
    dq = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for k0 in range(0, tk, slot_w):
        k1 = min(k0 + slot_w, tk)
        q0 = k0 if causal else 0
        kj, vj = k[:, k0:k1].float(), v[:, k0:k1].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf[:, q0:], kj) * scale
        keep = None
        if causal:
            rows = torch.arange(q0, tq, device=q.device)[:, None]
            keep = (rows >= torch.arange(k0, k1, device=q.device)[None])[None, None]
        if kv_mask is not None:
            km = kv_mask[:, k0:k1].bool()[:, None, None, :]
            keep = km if keep is None else keep & km
        if keep is not None:
            s = s.masked_fill(~keep, NEG_INF)
        p = torch.exp(s - lse[:, :, q0:, None])
        dp = torch.einsum("bqhd,bkhd->bhqk", dof[:, q0:], vj)
        ds = (p * (dp - delta[:, :, q0:, None])).to(q.dtype).float()
        dv[:, k0:k1] = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), dof[:, q0:])
        dk[:, k0:k1] = torch.einsum("bhqk,bqhd->bkhd", ds, qf[:, q0:]) * scale
        dq[:, q0:] += torch.einsum("bhqk,bkhd->bqhd", ds, kj) * scale
    return dq.to(q.dtype), dk, dv


def merged_bwd_fits(tk: int, d: int) -> bool:
    """Whether the JAX package runs its merged backward (B2) at this
    key length and head dim, rather than the streaming-K one (B3):
    ``_merged_bwd_fits`` of ``edl_tpu/ops/flash_attention.py``."""
    residency = 16 * 1024 * 1024 + 4 * tk * d * 12
    return tk <= _MERGED_BWD_MAX_T and residency <= _VMEM_CAP_BYTES


def bwd_impl(tk: int, d: int) -> str:
    """The backward the port runs at this key length and head dim,
    ``"merged"`` (B2) or ``"streamk"`` (B3), as the JAX package's
    ``_bwd_common`` picks it: ``_BWD_IMPL_OVERRIDE`` when set, else by
    ``merged_bwd_fits``.  The same on CUDA and on the CPU."""
    return _BWD_IMPL_OVERRIDE or ("merged" if merged_bwd_fits(tk, d) else "streamk")


def streamk_slot_width(tk: int, bwd_block_k: Optional[int] = None) -> int:
    """Keys per dQ partial of the streaming-K backward.  The wanted
    width is ``bwd_block_k`` when the caller names one, else the JAX
    package's ``min(max(2048, tk // 8), 16384)``, capped at ``tk``.
    Where the JAX package's pick (``_pick_block``: the largest divisor
    of ``tk`` not above the wanted width) is at least 512 keys, or is
    the wanted width itself, it is taken, so the partials are summed in
    the JAX package's grouping.  Otherwise (a ``tk`` with no such
    divisor, e.g. a prime) the wanted width is taken with a ragged last
    slot, where the JAX pick would give slots of a few keys and as many
    partials (ROADMAP section C)."""
    want = bwd_block_k or min(max(_STREAMK_BLOCK_K, tk // 8), _STREAMK_MAX_BLOCK_K)
    want = max(1, min(int(want), tk))
    for width in range(want, min(want, _STREAMK_MIN_DIVISOR_SLOT) - 1, -1):
        if tk % width == 0:
            return width
    return want


def _readable_in_place(x: torch.Tensor) -> bool:
    """Whether the kernels read ``x`` ([B, T, H, D]) where it lies: a
    contiguous head dim and 16-byte aligned rows."""
    return (
        x.stride(-1) == 1
        and not any(s % 8 for s in x.stride()[:3])
        and x.data_ptr() % 16 == 0
    )


def _check_operand(name: str, x: torch.Tensor, ref: torch.Tensor) -> None:
    if x.device != ref.device:
        raise ValueError(f"{name} is on {x.device}, q on {ref.device}")
    if x.dtype != ref.dtype:
        raise ValueError(f"{name} is {x.dtype}, q is {ref.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name} must be [B, T, H, D], got {tuple(x.shape)}")
    if not _readable_in_place(x):
        raise ValueError(
            f"{name} must have a contiguous head dim and 16-byte aligned "
            f"rows (strides {x.stride()} in elements must be multiples of 8)"
        )


def _mask_ptr(kv_mask: Optional[torch.Tensor], b: int, tk: int, q: torch.Tensor):
    """Device pointer of a ``[B, Tk]`` bool key mask (None for none)."""
    if kv_mask is None:
        return None
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
    return kv_mask.data_ptr()


def _check_qkv(name: str, q, k, v, causal: bool, extra=()) -> Tuple[int, int, int, int, int]:
    """Raise on q, k, v (and ``extra``: (name, tensor) pairs shaped like
    q) that the kernels do not take; returns ``(b, tq, tk, h, d)``."""
    if not q.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name} takes bf16 or f16, got {q.dtype}")
    for what, x in (("q", q), ("k", k), ("v", v), *extra):
        _check_operand(what, x, q)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if k.shape != (b, tk, h, d) or v.shape != k.shape:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)}"
        )
    for what, x in extra:
        if x.shape != q.shape:
            raise ValueError(f"{what} {tuple(x.shape)} must match q {tuple(q.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    if b * h > _MAX_BLOCKS_Y:
        raise ValueError(f"B*H = {b * h} exceeds {_MAX_BLOCKS_Y}")
    if causal and tq != tk:
        raise ValueError(f"causal requires square attention, got {tq=} {tk=}")
    return b, tq, tk, h, d


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
    b, tq, tk, h, d = _check_qkv("flash_fwd_cuda", q, k, v, causal)
    mask_ptr = _mask_ptr(kv_mask, b, tk, q)
    fn = _build.entry("flash_fwd", "edl_flash_fwd", _FWD_ARGS)
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


def _check_stat(name: str, x: torch.Tensor, shape, ref: torch.Tensor) -> None:
    if (
        x.dtype != torch.float32
        or tuple(x.shape) != shape
        or x.device != ref.device
        or not x.is_contiguous()
    ):
        raise ValueError(
            f"{name} must be a contiguous float32 {shape} tensor on q's "
            f"device, got {x.dtype} {tuple(x.shape)}"
        )


def flash_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    g_lse: Optional[torch.Tensor],
    kv_mask: Optional[torch.Tensor],
    causal: bool,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the merged backward's kernels (delta, dK/dV, dQ) on
    PyTorch's current stream; returns ``(dq, dk, dv)`` contiguous
    ``[B, T, H, D]``.  Runs at any T (it keeps no T-sized scratch);
    ``bwd_impl`` decides when the autograd node calls it.  Raises on
    anything the kernels do not take and if a launch returns a CUDA
    error."""
    b, tq, tk, h, d = _check_qkv(
        "flash_bwd_cuda", q, k, v, causal, (("o", o), ("do", do)))
    _check_stat("lse", lse, (b, h, tq), q)
    if g_lse is not None:
        _check_stat("g_lse", g_lse, (b, h, tq), q)
    mask_ptr = _mask_ptr(kv_mask, b, tk, q)
    fn = _build.entry("flash_bwd", "edl_flash_bwd", _BWD_ARGS)
    delta = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, tk, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, tk, h, d), dtype=q.dtype, device=q.device)
    strides = [
        (ctypes.c_longlong * 3)(*x.stride()[:3]) for x in (q, k, v, o, do)
    ]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            None if g_lse is None else g_lse.data_ptr(), mask_ptr,
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, tq, tk, d, *strides, float(scale), int(bool(causal)),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_bwd kernel launch failed: cudaError {err}")
    LAUNCHES["flash_bwd"] += 1
    return dq, dk, dv


def streamk_chunk_rows(tq: int) -> int:
    """Query rows per block of the streaming-K kernel: a multiple of its
    64-row tile, at most ``_STREAMK_Q_CHUNKS`` chunks."""
    return 64 * max(1, -(-tq // (64 * _STREAMK_Q_CHUNKS)))


def streamk_geometry(b: int, h: int, tq: int, tk: int, d: int, slot_w: int,
                     causal: bool) -> Dict[str, int]:
    """The streaming-K kernel's work split and workspace, as
    ``csrc/flash_bwd_streamk.cu`` lays them out (its ``live_slots``):

    - ``chunk_rows``, ``n_slots``, ``n_chunks``, ``tq_pad``;
    - ``live_pairs``: the (slot, Q chunk) blocks of one batch*head that
      the causal mask leaves live, and ``blocks`` of the launch;
    - ``dq_partial_bytes``, ``dkv_partial_bytes`` (dK and dV together)
      and ``delta_bytes``: the float32 workspace the wrapper allocates."""
    chunk_rows = streamk_chunk_rows(tq)
    n_slots, n_chunks = -(-tk // slot_w), -(-tq // chunk_rows)
    live_pairs = sum(
        min((min((c + 1) * chunk_rows, tq) - 1) // slot_w + 1, n_slots)
        if causal else n_slots
        for c in range(n_chunks))
    tq_pad = -(-tq // 64) * 64
    return {
        "chunk_rows": chunk_rows, "n_slots": n_slots, "n_chunks": n_chunks,
        "tq_pad": tq_pad,
        "live_pairs": live_pairs, "blocks": b * h * live_pairs,
        "dq_partial_bytes": b * h * n_slots * tq_pad * d * 4,
        "dkv_partial_bytes": 2 * b * h * n_chunks * tk * d * 4,
        "delta_bytes": b * h * tq * 4,
    }


def flash_bwd_streamk_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    g_lse: Optional[torch.Tensor],
    kv_mask: Optional[torch.Tensor],
    causal: bool,
    scale: float,
    slot_w: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the streaming-K backward's kernels (delta, the (slot, Q
    chunk) pairs, the reduce of the partials) on PyTorch's current
    stream, with ``slot_w`` keys per dQ partial; returns ``(dq, dk, dv)``
    contiguous ``[B, T, H, D]``.  Allocates the float32 partial buffers
    (``csrc/flash_bwd_streamk.cu`` states their size).  Raises on
    anything the kernels do not take and if a launch returns a CUDA
    error."""
    b, tq, tk, h, d = _check_qkv(
        "flash_bwd_streamk_cuda", q, k, v, causal, (("o", o), ("do", do)))
    _check_stat("lse", lse, (b, h, tq), q)
    if g_lse is not None:
        _check_stat("g_lse", g_lse, (b, h, tq), q)
    if not 1 <= slot_w <= max(tk, 1):
        raise ValueError(f"slot width {slot_w} must be in [1, Tk={tk}]")
    mask_ptr = _mask_ptr(kv_mask, b, tk, q)
    geo = streamk_geometry(b, h, tq, tk, d, slot_w, causal)
    if geo["live_pairs"] > _MAX_BLOCKS_Y:
        raise ValueError(f"{geo['live_pairs']} (slot, Q chunk) pairs exceed {_MAX_BLOCKS_Y}")
    fn = _build.entry("flash_bwd_streamk", "edl_flash_bwd_streamk", _STREAMK_ARGS)
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty((b, h, tq), **f32)
    dqp = torch.empty((b * h, geo["n_slots"], geo["tq_pad"], d), **f32)
    dkp = torch.empty((b * h, geo["n_chunks"], tk, d), **f32)
    dvp = torch.empty((b * h, geo["n_chunks"], tk, d), **f32)
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, tk, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, tk, h, d), dtype=q.dtype, device=q.device)
    strides = [
        (ctypes.c_longlong * 3)(*x.stride()[:3]) for x in (q, k, v, o, do)
    ]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            None if g_lse is None else g_lse.data_ptr(), mask_ptr,
            delta.data_ptr(), dqp.data_ptr(), dkp.data_ptr(), dvp.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, tq, tk, d, int(slot_w), geo["chunk_rows"], *strides,
            float(scale), int(bool(causal)), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_bwd_streamk kernel launch failed: cudaError {err}")
    LAUNCHES["flash_bwd_streamk"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Flash attention as an autograd node: the kernels on CUDA
    tensors, the plain versions on CPU tensors; the backward is the
    merged or the streaming-K one as ``bwd_impl`` picks, with
    ``bwd_block_k`` (or the default policy) for the streaming-K slot
    width.  The lse output is differentiable: its cotangent enters the
    backward as ``delta - g_lse`` (``d lse / d s = p``), as in the JAX
    package."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale, bwd_block_k):
        if q.is_cuda:
            o, lse = flash_fwd_cuda(q, k, v, causal, scale, kv_mask)
        else:
            o, lse = flash_attention_plain(q, k, v, causal, scale, kv_mask)
        ctx.save_for_backward(q, k, v, o, lse, kv_mask)
        ctx.causal, ctx.scale, ctx.bwd_block_k = causal, scale, bwd_block_k
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g_o, g_lse):
        q, k, v, o, lse, kv_mask = ctx.saved_tensors
        if g_o is None:
            g_o = torch.zeros_like(o)
        if q.is_cuda:
            if g_lse is not None:
                g_lse = g_lse.float().contiguous()
            g_o = g_o.to(q.dtype)
            if not _readable_in_place(g_o):
                g_o = g_o.contiguous()
        args = (q, k, v, o, lse, g_o, g_lse, kv_mask, ctx.causal, ctx.scale)
        if bwd_impl(k.shape[1], q.shape[-1]) == "streamk":
            slot_w = streamk_slot_width(k.shape[1], ctx.bwd_block_k)
            run = flash_bwd_streamk_cuda if q.is_cuda else flash_bwd_streamk_plain
            dq, dk, dv = run(*args, slot_w)
        else:
            run = flash_bwd_cuda if q.is_cuda else flash_bwd_plain
            dq, dk, dv = run(*args)
        return dq, dk, dv, None, None, None, None


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
    bwd_block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention over ``[B, T, H, D]`` that also returns the
    per-row logsumexp: ``(o [B, Tq, H, D], lse [B, H, Tq] float32)``,
    both differentiable.  ``kv_mask``: optional ``[B, Tk]`` bool (True =
    attend).  ``bwd_block_k``: keys per dQ partial of the streaming-K
    backward (the JAX API's keyword; ``streamk_slot_width`` says how it
    is used), ignored by the merged one.  CUDA tensors launch the
    kernels; CPU tensors run the plain versions."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            f"causal requires square attention, got {q.shape[1]=} "
            f"{k.shape[1]=}"
        )
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention has no path for device {q.device}")
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.bool).contiguous()
    if bwd_block_k is not None and bwd_block_k < 1:
        raise ValueError(f"bwd_block_k must be positive, got {bwd_block_k}")
    return _FlashAttention.apply(q, k, v, kv_mask, causal, scale, bwd_block_k)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
    bwd_block_k: Optional[int] = None,
) -> torch.Tensor:
    """``flash_attention_with_lse`` without the lse."""
    return flash_attention_with_lse(q, k, v, causal, scale, kv_mask, bwd_block_k)[0]


__all__ = [
    "LAUNCHES",
    "bwd_impl",
    "flash_attention",
    "flash_attention_plain",
    "flash_attention_with_lse",
    "flash_bwd_cuda",
    "flash_bwd_plain",
    "flash_bwd_streamk_cuda",
    "flash_bwd_streamk_plain",
    "flash_fwd_cuda",
    "merged_bwd_fits",
    "reset_launch_counts",
    "streamk_geometry",
    "streamk_slot_width",
]
