"""Tied-vocab cross entropy (counterpart of ``edl_tpu/ops/losses.py``).

``tied_vocab_xent`` is the plain chunked version: per chunk of rows,
the bf16 x bf16 -> float32 vocab projection, the logsumexp and the
label gather, each chunk under ``torch.utils.checkpoint`` so its
``[rows, V]`` logits are recomputed in the backward instead of kept.
``best_vocab_xent`` picks the fused kernels on CUDA tensors and this
version on CPU tensors, as the JAX package picks its Pallas kernels on
a TPU and the chunked path elsewhere.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from edl_tpu_torch.ops.fused_xent import fused_vocab_xent


def _chunk(yc, lc, vc, emb):
    logits = yc.to(torch.bfloat16).float() @ emb.float().t()  # [c, V]
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(1, lc[:, None])[:, 0]
    loss_sum = ((lse - label_logit) * vc).sum()
    hit = (torch.argmax(logits, dim=-1) == lc).float()
    return loss_sum, (hit * vc).sum()


def tied_vocab_xent(
    features: torch.Tensor,
    embedding: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    chunk_rows: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax cross entropy against a weight-tied vocab projection.

    features ``[B, T, D]``, embedding ``[V, D]``, labels ``[B, T]`` int,
    valid ``[B, T]`` bool/float (1 where the token counts).  Returns
    ``(mean_nll, mean_accuracy)`` over valid tokens; accuracy is the
    argmax's.  The product runs on bf16 operands with float32 sums,
    ``chunk_rows`` rows at a time."""
    b, t, d = features.shape
    n = b * t
    y = features.reshape(n, d)
    lab = labels.reshape(n).long()
    val = valid.reshape(n).float()
    c = min(chunk_rows, n)
    pad = (-n) % c
    if pad:
        y = F.pad(y, (0, 0, 0, pad))
        lab = F.pad(lab, (0, pad))
        val = F.pad(val, (0, pad))  # pads are invalid -> contribute 0
    emb = embedding.to(torch.bfloat16)
    loss_sum = correct_sum = 0.0
    for i in range(0, n + pad, c):
        ls, cs = checkpoint(
            _chunk, y[i : i + c], lab[i : i + c], val[i : i + c], emb,
            use_reentrant=False,
        )
        loss_sum = loss_sum + ls
        correct_sum = correct_sum + cs
    denom = val.sum().clamp_min(1.0)
    return loss_sum / denom, correct_sum / denom


def best_vocab_xent(
    features: torch.Tensor,
    embedding: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused kernels for CUDA tensors (the logits never reach
    device memory), ``tied_vocab_xent`` for CPU tensors."""
    if features.is_cuda:
        return fused_vocab_xent(features, embedding, labels, valid)
    if features.device.type == "cpu":
        return tied_vocab_xent(features, embedding, labels, valid)
    raise ValueError(f"best_vocab_xent has no path for device {features.device}")


__all__ = ["best_vocab_xent", "tied_vocab_xent"]
