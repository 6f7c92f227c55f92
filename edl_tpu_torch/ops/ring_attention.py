"""Single-device exact attention (counterpart of
``edl_tpu/ops/ring_attention.py::reference_attention``).

Only the oracle is ported in this slice; the sequence-parallel ring
(``ring_attention``) comes with the ``sp`` layouts.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact attention over ``[B, T, H, D]`` tensors (the correctness
    oracle).

    Scores are float32 (the JAX version's ``preferred_element_type``:
    a product of two bf16 values is exact in f32, so upcasting first
    gives the same sums).  The weights are cast to ``v.dtype`` before
    the PV product.  ``kv_mask``: optional ``[B, Tk]`` bool (True =
    attend).  A fully masked row gets UNIFORM weights (softmax of equal
    -1e30 scores), unlike flash attention, which returns 0 there."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t = q.shape[1]
        keep = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask.bool()[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


__all__ = ["NEG_INF", "reference_attention"]
