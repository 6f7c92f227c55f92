"""ResNet-50 (counterpart of ``edl_tpu/models/resnet.py``, BASELINE
config 3): bottleneck stages 3-4-6-3 of width 64 on 224 x 224 x 3
images, 1000 classes.

As in the JAX package: GroupNorm (32 groups) instead of BatchNorm, so
the loss is a pure function of the parameters and a resize changes no
batch statistics; bf16 convolutions (cuDNN), float32 norms, pooling
and head.  Images arrive NHWC as the JAX package's; the convolutions
run on NCHW views of channels-last memory (``models/layers.py``, which
also holds the SAME padding that stride 2 makes asymmetric).

``flops_per_example`` is counted from the layer shapes
(``resnet_flops``: 2 FLOPs per multiply-add, x3 for fwd+bwd; 24.5 G at
224).  The JAX formula (``edl_tpu/models/resnet.py:120``) takes
ResNet-50's ~4.1 G multiply-adds as FLOPs, half the work; the port's
MFU is its own (ROADMAP, differences by design).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch.models.base import ModelDef, StateDict, materialize, register_model
from edl_tpu_torch.models.layers import Conv, GroupNorm, max_pool_same
from edl_tpu_torch.models.mnist import classifier_predict, xent_loss
from edl_tpu_torch.models.transformer_lm import Dense, lecun_normal

GROUPS = 32


class BottleneckBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int, dtype, param_dtype):
        super().__init__()

        def conv(cin, cout, k, s=1):
            return Conv(cin, cout, k, s, bias=False, dtype=dtype, param_dtype=param_dtype)

        self.conv1 = conv(in_ch, features, 1)
        self.norm1 = GroupNorm(GROUPS, features)
        self.conv2 = conv(features, features, 3, stride)
        self.norm2 = GroupNorm(GROUPS, features)
        self.conv3 = conv(features, 4 * features, 1)
        self.norm3 = GroupNorm(GROUPS, 4 * features)
        # flax adds the projection where the residual's shape differs
        self.has_proj = in_ch != 4 * features or stride != 1
        if self.has_proj:
            self.proj = conv(in_ch, 4 * features, 1, stride)
            self.norm_proj = GroupNorm(GROUPS, 4 * features)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        residual = self.norm_proj(self.proj(x)) if self.has_proj else x
        return F.relu(residual + y)


def _stages(stage_sizes: Sequence[int], width: int):
    """(name, in channels, features, stride) of every block, in order."""
    cin = width
    for i, n in enumerate(stage_sizes):
        for j in range(n):
            f = width * 2**i
            yield f"stage{i}_block{j}", cin, f, 2 if i > 0 and j == 0 else 1
            cin = 4 * f


class ResNet(nn.Module):
    """On ``[B, H, W, 3]`` float32 images; returns float32 logits.
    Submodule names follow the flax module's (``stem``, ``stem_norm``,
    ``stage{i}_block{j}``, ``head``)."""

    def __init__(self, stage_sizes=(3, 4, 6, 3), num_classes: int = 1000, width: int = 64,
                 dtype=torch.bfloat16, param_dtype=torch.float32):
        super().__init__()
        self.stem = Conv(3, width, 7, 2, bias=False, dtype=dtype, param_dtype=param_dtype)
        self.stem_norm = GroupNorm(GROUPS, width)
        self.blocks = []
        for name, cin, f, s in _stages(stage_sizes, width):
            self.add_module(name, BottleneckBlock(cin, f, s, dtype, param_dtype))
            self.blocks.append(name)
        feats = 4 * width * 2 ** (len(stage_sizes) - 1)
        self.head = Dense(feats, num_classes, torch.float32, torch.float32)

    def forward(self, image):
        x = image.permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        x = F.relu(self.stem_norm(self.stem(x)))
        x = max_pool_same(x, 3, 2)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.head(x.mean(dim=(2, 3)))  # global average pool


def resnet_flops(image_size: int, num_classes: int, stage_sizes, width: int) -> int:
    """fwd+bwd FLOPs of one example from the layer shapes: 2 per
    multiply-add of every convolution and the head, x3 for the
    backward."""
    h = -(-image_size // 2)  # the stem's output
    macs = 7 * 7 * 3 * width * h * h
    h = -(-h // 2)  # the max pool's
    for _, cin, f, s in _stages(stage_sizes, width):
        out = -(-h // s)
        macs += cin * f * h * h + 9 * f * f * out * out + f * 4 * f * out * out
        if cin != 4 * f or s != 1:
            macs += cin * 4 * f * out * out
        h = out
    macs += 4 * width * 2 ** (len(stage_sizes) - 1) * num_classes
    return 3 * 2 * macs


def _make(image_size: int, num_classes: int, stage_sizes, width: int, name: str) -> ModelDef:
    arch = dict(stage_sizes=tuple(stage_sizes), num_classes=num_classes, width=width)

    def init_params(g: torch.Generator) -> StateDict:
        """flax's initializers: lecun normal kernels, zero biases, norm
        scale 1 and bias 0."""
        with torch.device("meta"):
            shapes = {k: v.shape for k, v in ResNet(**arch).state_dict().items()}
        sd: StateDict = {}
        for key, shape in shapes.items():
            if key.endswith("weight") and len(shape) > 1:
                sd[key] = lecun_normal(shape, int(np.prod(shape[1:])), g)
            elif ("norm" in key.split(".")[-2]) and key.endswith("weight"):
                sd[key] = torch.ones(shape)
            else:
                sd[key] = torch.zeros(shape)
        return sd

    def bind_params(state_dict: StateDict, device) -> ResNet:
        return materialize(lambda: ResNet(**arch, param_dtype=torch.bfloat16), state_dict,
                           device).eval().requires_grad_(False)

    def train_params(state_dict: StateDict, device) -> ResNet:
        return materialize(lambda: ResNet(**arch), state_dict, device).train()

    def loss_fn(params, batch, generator=None):
        return xent_loss(params(batch["image"]), batch["label"])

    def synth_batch(rng: np.random.RandomState, n: int):
        """Class-dependent spatial stripes (a brightness-only signal
        would be erased by normalization; spatial structure survives)."""
        label = rng.randint(0, num_classes, size=(n,))
        img = 0.5 * rng.randn(n, image_size, image_size, 3).astype(np.float32)
        band = max(2, image_size // num_classes)
        for c in range(num_classes):
            idx = label == c
            if idx.any():
                row = (c * image_size) // num_classes
                img[idx, row : row + band, :, :] += 2.0
        return {"image": img, "label": label.astype(np.int32)}

    return ModelDef(
        name=name,
        init_params=init_params,
        bind_params=bind_params,
        synth_batch=synth_batch,
        predict_fn=classifier_predict,
        predict_inputs=("image",),
        train_params=train_params,
        loss_fn=loss_fn,
        flops_per_example=resnet_flops(image_size, num_classes, stage_sizes, width),
    )


@register_model("resnet50")
def resnet50(tiny: bool = False) -> ModelDef:
    """ResNet-50.  ``tiny=True`` gives the JAX package's test shape: one
    block per stage in three stages of width 32, 32 x 32 images, 10
    classes (the same code path)."""
    if tiny:
        return _make(32, 10, (1, 1, 1), 32, "resnet50")
    return _make(224, 1000, (3, 4, 6, 3), 64, "resnet50")
