"""Convolution layers with flax's numerics, for the conv families
(``mnist``, ``resnet50``).

- ``Conv`` is flax ``nn.Conv(padding="SAME", dtype=...)`` on NCHW
  tensors: kernel, bias and input cast to the compute dtype inside the
  product, as ``models/transformer_lm.py``'s ``Dense`` does.  SAME
  padding puts the odd pixel after the image (``same_pads``): under
  stride 2 it is asymmetric (the 7x7/2 stem on 224 pads (2, 3), a 3x3/2
  on 56 pads (0, 1)), which ``nn.Conv2d(padding=k // 2)`` does not
  reproduce, so such a pad is an explicit ``F.pad``.
- ``GroupNorm`` computes in float32 on its (bf16) input with flax's
  epsilon, 1e-6 (torch's default is 1e-5), and outputs float32.
- ``max_pool_same`` is flax ``nn.max_pool(padding="SAME")``: the pad
  is -inf, placed as ``same_pads`` places it.

The port keeps the JAX package's NHWC images at its interface; a model
permutes them to NCHW views in channels-last memory, which cuDNN takes
as they are.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

#: flax ``nn.GroupNorm``'s epsilon (torch's default is 1e-5)
GN_EPS = 1e-6


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) of XLA's SAME padding for one spatial axis: the
    output is ``ceil(size / stride)`` and the odd pixel goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0):
    """``x`` ``[B, C, H, W]`` padded as SAME pads it, and the padding
    left for the op itself: ``(x, (ph, pw))`` where a symmetric pad is
    left to the op and an asymmetric one is applied here."""
    (t, b), (l, r) = same_pads(x.shape[2], k, stride), same_pads(x.shape[3], k, stride)
    if t == b and l == r and value == 0.0:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


class Conv(nn.Conv2d):
    """A square SAME convolution whose product runs in ``dtype`` whatever
    its parameters' dtype.  Weight ``[out, in, k, k]``."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 bias: bool = True, dtype=torch.bfloat16, param_dtype=torch.float32):
        super().__init__(in_ch, out_ch, k, stride, bias=bias, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        k, s = self.kernel_size[0], self.stride[0]
        x, pad = _pad_same(x.to(dt), k, s)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x, self.weight.to(dt), bias, s, pad)


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm(dtype=float32)``: float32 statistics and
    output, eps 1e-6."""

    def __init__(self, groups: int, channels: int):
        super().__init__(groups, channels, eps=GN_EPS)

    def forward(self, x):
        return super().forward(x.float())


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """flax ``nn.max_pool(x, (k, k), (stride, stride), padding="SAME")``
    on ``[B, C, H, W]``: the pad is -inf."""
    x, _ = _pad_same(x, k, stride, value=float("-inf"))
    return F.max_pool2d(x, k, stride)


__all__ = ["Conv", "GN_EPS", "GroupNorm", "max_pool_same", "same_pads"]
