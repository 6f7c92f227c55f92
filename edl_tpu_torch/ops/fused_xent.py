"""Fused tied-vocab softmax cross entropy (counterpart of
``edl_tpu/ops/fused_xent.py``).

The loss of ``softmax(Y E^T)`` against labels, with the vocab
projection's ``[N, V]`` logits never stored: three kernels, built at
first use (see ``_build``):

- ``xent_fwd_cuda`` (replaces the TPU kernel ``_fwd_kernel``): per row,
  the logsumexp, the label's logit and the row max
  (``csrc/xent_fwd.cu``);
- ``xent_dy_cuda`` (``_dy_kernel``): ``dY = dL E`` (``csrc/xent_dy.cu``);
- ``xent_de_cuda`` (``_de_kernel``): ``dE = dL^T Y`` in float32
  (``csrc/xent_de.cu``);

each its own library on ``csrc/hopper.cuh`` (wgmma and TMA), with
``dL = ((softmax - onehot) * row_scale)`` cast to bf16.  Each has a
plain PyTorch version (``xent_*_plain``) that the CPU runs and the card
checks the kernel against.  ``fused_vocab_xent`` is the loss as an
autograd function, following the JAX package's ``fused_vocab_xent``.

A label outside ``[0, V)`` has label logit 0.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from edl_tpu_torch.ops import _build

#: launches of each kernel wrapper in this process (see
#: ``flash_attention.LAUNCHES``)
LAUNCHES: Dict[str, int] = {"xent_fwd": 0, "xent_dy": 0, "xent_de": 0}

#: rows of Y are padded to a multiple of this (label 0, valid 0), as the
#: JAX package pads to its row tile; the kernels' row tiles divide it
ROW_TILE = 64
#: feature widths the kernels are built for
_DIMS = (64, 128, 256, 512, 768, 1024)

_PTR = ctypes.c_void_p
_I32 = ctypes.c_int
#: C signatures: y, e, labels, [lse, row_scale,] (n, v, d), outputs,
#: stream
_ARGS = {
    "xent_fwd": [_PTR, _PTR, _PTR, _I32, _I32, _I32, _PTR, _PTR, _PTR, _PTR],
    "xent_dy": [_PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _PTR, _PTR],
}
_ARGS["xent_de"] = _ARGS["xent_dy"]


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- plain versions -------------------------------------------------------


def _logits(y: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> float32 logits ``[N, V]`` (products exact in
    float32, float32 sums)."""
    return y.float() @ e.float().t()


def _label_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    vocab = logits.shape[1]
    lab = labels.long()
    ok = (lab >= 0) & (lab < vocab)
    got = logits.gather(1, lab.clamp(0, vocab - 1)[:, None])[:, 0]
    return torch.where(ok, got, torch.zeros_like(got))


def xent_fwd_plain(
    y: torch.Tensor, e: torch.Tensor, labels: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(lse, label_logit, row_max)``, each ``[N]`` float32, of the
    logits ``y e^T`` (``y`` ``[N, D]``, ``e`` ``[V, D]``, bf16)."""
    logits = _logits(y, e)
    m = logits.amax(dim=1)
    lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=1).clamp_min(1e-30))
    return lse, _label_logit(logits, labels), m


def _dl_plain(y, e, labels, lse, row_scale) -> torch.Tensor:
    """``((softmax - onehot) * row_scale)`` rounded to bf16, held in
    float32, ``[N, V]``."""
    p = torch.exp(_logits(y, e) - lse[:, None])
    lab = labels.long()
    ok = (lab >= 0) & (lab < e.shape[0])
    rows = torch.arange(lab.shape[0], device=lab.device)[ok]
    p[rows, lab[ok]] -= 1.0  # softmax - onehot
    return (p * row_scale[:, None]).to(torch.bfloat16).float()


def xent_dy_plain(y, e, labels, lse, row_scale) -> torch.Tensor:
    """``dY = dL e`` ``[N, D]`` in ``y``'s dtype (float32 sums)."""
    return (_dl_plain(y, e, labels, lse, row_scale) @ e.float()).to(y.dtype)


def xent_de_plain(y, e, labels, lse, row_scale) -> torch.Tensor:
    """``dE = dL^T y`` ``[V, D]`` float32."""
    return _dl_plain(y, e, labels, lse, row_scale).t() @ y.float()


# -- kernel wrappers ------------------------------------------------------


def _check(name: str, y, e, labels, stats=()) -> Tuple[int, int, int]:
    if not y.is_cuda:
        raise ValueError(f"{name}_cuda needs CUDA tensors, got {y.device}")
    if y.dim() != 2 or e.dim() != 2 or y.shape[1] != e.shape[1]:
        raise ValueError(
            f"{name}: y must be [N, D] and e [V, D], got {tuple(y.shape)} "
            f"{tuple(e.shape)}"
        )
    n, d = y.shape
    v = e.shape[0]
    for what, x in (("y", y), ("e", e)):
        if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.device != y.device:
            raise ValueError(f"{name}: {what} must be contiguous bf16 on y's device")
    if labels.dtype != torch.int32 or labels.shape != (n,) or not labels.is_contiguous():
        raise ValueError(f"{name}: labels must be contiguous int32 [N]")
    for x in stats:
        if x.dtype != torch.float32 or x.shape != (n,) or not x.is_contiguous():
            raise ValueError(f"{name}: lse and row_scale must be contiguous float32 [N]")
    if labels.device != y.device or any(x.device != y.device for x in stats):
        raise ValueError(f"{name}: every operand must be on y's device")
    if d not in _DIMS:
        raise ValueError(f"{name}: feature width {d} not in {_DIMS}")
    if y.data_ptr() % 16 or e.data_ptr() % 16:
        raise ValueError(f"{name}: y and e must start 16-byte aligned (TMA)")
    return n, v, d


def _launch(name: str, *args) -> None:
    fn = _build.entry(name, f"edl_{name}", _ARGS[name])
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
            stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def xent_fwd_cuda(
    y: torch.Tensor, e: torch.Tensor, labels: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch B4; returns ``(lse, label_logit, row_max)`` ``[N]``
    float32.  Raises on anything the kernel does not take."""
    n, v, d = _check("xent_fwd", y, e, labels)
    out = [torch.empty(n, dtype=torch.float32, device=y.device) for _ in range(3)]
    _launch("xent_fwd", y, e, labels, n, v, d, *out)
    return out[0], out[1], out[2]


def xent_dy_cuda(y, e, labels, lse, row_scale) -> torch.Tensor:
    """Launch B5; returns ``dY`` ``[N, D]`` bf16."""
    n, v, d = _check("xent_dy", y, e, labels, (lse, row_scale))
    dy = torch.empty((n, d), dtype=torch.bfloat16, device=y.device)
    _launch("xent_dy", y, e, labels, lse, row_scale, n, v, d, dy)
    return dy


def xent_de_cuda(y, e, labels, lse, row_scale) -> torch.Tensor:
    """Launch B6; returns ``dE`` ``[V, D]`` float32."""
    n, v, d = _check("xent_de", y, e, labels, (lse, row_scale))
    de = torch.empty((v, d), dtype=torch.float32, device=y.device)
    _launch("xent_de", y, e, labels, lse, row_scale, n, v, d, de)
    return de


def _pick(cuda_fn, plain_fn, y: torch.Tensor):
    if y.is_cuda:
        return cuda_fn
    if y.device.type == "cpu":
        return plain_fn
    raise ValueError(f"fused_vocab_xent has no path for device {y.device}")


# -- the loss -------------------------------------------------------------


class _FusedVocabXent(torch.autograd.Function):
    """``(mean_nll, mean_accuracy)`` over valid rows, with the JAX
    package's ``_xent`` custom_vjp as its model: Y and E cast to bf16
    inside; rows padded to ``ROW_TILE`` with label 0 and valid 0;
    ``denom = max(sum(valid), 1)``; accuracy is ``label_logit >=
    row_max`` (a tie counts as a hit); the backward's ``row_scale =
    g * valid / denom``; dY comes back in the features' dtype and dE in
    float32 for the V rows.  Accuracy carries no gradient."""

    @staticmethod
    def forward(ctx, features, embedding, labels, valid):
        b, t, d = features.shape
        n = b * t
        y = features.reshape(n, d).to(torch.bfloat16)
        lab = labels.reshape(n).to(torch.int32)
        val = valid.reshape(n).to(torch.float32)
        pad = (-n) % ROW_TILE
        if pad:
            y = F.pad(y, (0, 0, 0, pad))
            lab = F.pad(lab, (0, pad))
            val = F.pad(val, (0, pad))
        y = y.contiguous()
        e = embedding.to(torch.bfloat16).contiguous()
        lse, label_logit, row_max = _pick(xent_fwd_cuda, xent_fwd_plain, y)(y, e, lab)
        denom = val.sum().clamp_min(1.0)
        loss = ((lse - label_logit) * val).sum() / denom
        acc = ((label_logit >= row_max) & (val > 0)).float().sum() / denom
        ctx.save_for_backward(y, e, lab, val, denom, lse)
        ctx.shape, ctx.dtypes = features.shape, (features.dtype, embedding.dtype)
        ctx.mark_non_differentiable(acc)
        return loss, acc

    @staticmethod
    def backward(ctx, g_loss, g_acc):
        y, e, lab, val, denom, lse = ctx.saved_tensors
        b, t, d = ctx.shape
        row_scale = (g_loss * val / denom).float().contiguous()
        dy = de = None
        if ctx.needs_input_grad[0]:
            dy = _pick(xent_dy_cuda, xent_dy_plain, y)(y, e, lab, lse, row_scale)
            dy = dy[: b * t].to(ctx.dtypes[0]).reshape(b, t, d)
        if ctx.needs_input_grad[1]:
            de = _pick(xent_de_cuda, xent_de_plain, y)(y, e, lab, lse, row_scale)
            de = de.to(ctx.dtypes[1])
        return dy, de, None, None


def fused_vocab_xent(
    features: torch.Tensor,
    embedding: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused equivalent of ``losses.tied_vocab_xent``: features
    ``[B, T, D]``, embedding ``[V, D]``, labels ``[B, T]`` int, valid
    ``[B, T]`` bool/float -> ``(mean_nll, mean_accuracy)`` over valid
    tokens.  CUDA tensors launch the kernels; CPU tensors run the plain
    versions."""
    return _FusedVocabXent.apply(features, embedding, labels, valid)


__all__ = [
    "LAUNCHES",
    "ROW_TILE",
    "fused_vocab_xent",
    "reset_launch_counts",
    "xent_de_cuda",
    "xent_de_plain",
    "xent_dy_cuda",
    "xent_dy_plain",
    "xent_fwd_cuda",
    "xent_fwd_plain",
]
