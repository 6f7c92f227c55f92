"""Hot-path ops of the port: attention and the tied-vocab loss, with
their hand-written kernels."""

from edl_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_with_lse,
)
from edl_tpu_torch.ops.losses import best_vocab_xent, tied_vocab_xent
from edl_tpu_torch.ops.ring_attention import reference_attention


def fused_attention(q, k, v, causal=False, scale=None, kv_mask=None):
    """Single-device attention over ``[B, T, H, D]`` tensors.

    A CUDA tensor always takes the flash kernel, at every T (the JAX
    package's 512-token threshold was measured on a TPU v5e and does
    not carry over).  A CPU tensor takes ``reference_attention``,
    exactly as the JAX package's CPU path does.

    ``kv_mask``: optional ``[B, Tk]`` bool (True = attend)."""
    if q.is_cuda:
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               kv_mask=kv_mask)
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal=causal, scale=scale,
                                   kv_mask=kv_mask)
    raise ValueError(f"fused_attention has no path for device {q.device}")


__all__ = [
    "best_vocab_xent",
    "flash_attention",
    "flash_attention_with_lse",
    "fused_attention",
    "reference_attention",
    "tied_vocab_xent",
]
