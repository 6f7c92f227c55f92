"""MNIST ConvNet (counterpart of ``edl_tpu/models/mnist.py``, BASELINE
config 2): two 5x5 SAME convolutions with 2x2 average pools, a
256-wide dense layer and a 10-way head; bf16 compute, float32
parameters, a float32 head.

The flax module flattens its NHWC activations, so ``Dense_0``'s 3136
input rows are in (h, w, c) order.  The port convolves NCHW views of
channels-last memory and permutes back to NHWC before the flatten
(free in that memory), so the flax kernel carries over as it is.

``flops_per_example`` is counted from the layer shapes: 68,806,656
(conv1 28x28x32 from 1 channel, conv2 14x14x64 from 32, dense
3136x256 and 256x10, times 3 for fwd+bwd).  The JAX formula
(``edl_tpu/models/mnist.py:111-112``) counts VALID-shaped outputs
(24x24, 8x8) and a 1024-wide dense layer: 24,013,824.  The port's
MFU is its own (ROADMAP, differences by design).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch.models.base import ModelDef, StateDict, materialize, register_model
from edl_tpu_torch.models.layers import Conv
from edl_tpu_torch.models.transformer_lm import Dense, lecun_normal

NUM_CLASSES = 10


class ConvNet(nn.Module):
    """LeNet-ish ConvNet on ``[B, 28, 28, 1]`` float32 images; returns
    float32 logits.  Weight names follow the flax module's."""

    def __init__(self, dtype=torch.bfloat16, param_dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(1, 32, 5, dtype=dtype, param_dtype=param_dtype)
        self.Conv_1 = Conv(32, 64, 5, dtype=dtype, param_dtype=param_dtype)
        self.Dense_0 = Dense(7 * 7 * 64, 256, dtype, param_dtype)
        self.Dense_1 = Dense(256, NUM_CLASSES, torch.float32, torch.float32)

    def forward(self, image):
        x = image.permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        x = F.avg_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.avg_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's (h, w, c) order
        return self.Dense_1(F.relu(self.Dense_0(x)))


def mnist_flops() -> int:
    """fwd+bwd FLOPs of one example, from the layer shapes (2 per MAC,
    x3 for the backward)."""
    fwd = 2 * (5 * 5 * 1 * 32 * 28 * 28 + 5 * 5 * 32 * 64 * 14 * 14
               + 7 * 7 * 64 * 256 + 256 * NUM_CLASSES)
    return 3 * fwd


def xent_loss(logits: torch.Tensor, label: torch.Tensor):
    """Mean softmax cross entropy and accuracy of float32 logits."""
    label = label.long()
    loss = F.cross_entropy(logits, label)
    acc = (torch.argmax(logits, -1) == label).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


def classifier_predict(params, inputs) -> Dict[str, torch.Tensor]:
    logits = params(inputs["image"])
    return {"logits": logits, "label": torch.argmax(logits, -1)}


@register_model("mnist")
def mnist(tiny: bool = False) -> ModelDef:
    """``tiny`` is accepted so that every family takes ``--tiny``; the
    model has one size."""

    def init_params(g: torch.Generator) -> StateDict:
        """flax's initializers: lecun normal kernels, zero biases."""
        sd: StateDict = {}
        for name, (out_c, in_c) in {"Conv_0": (32, 1), "Conv_1": (64, 32)}.items():
            sd[f"{name}.weight"] = lecun_normal((out_c, in_c, 5, 5), 25 * in_c, g)
            sd[f"{name}.bias"] = torch.zeros(out_c)
        for name, (out_f, in_f) in {"Dense_0": (256, 3136), "Dense_1": (10, 256)}.items():
            sd[f"{name}.weight"] = lecun_normal((out_f, in_f), in_f, g)
            sd[f"{name}.bias"] = torch.zeros(out_f)
        return sd

    def bind_params(state_dict: StateDict, device) -> ConvNet:
        return materialize(lambda: ConvNet(param_dtype=torch.bfloat16), state_dict, device) \
            .eval().requires_grad_(False)

    def train_params(state_dict: StateDict, device) -> ConvNet:
        return materialize(ConvNet, state_dict, device).train()

    def loss_fn(params, batch, generator=None):
        return xent_loss(params(batch["image"]), batch["label"])

    def synth_batch(rng: np.random.RandomState, n: int):
        label = rng.randint(0, NUM_CLASSES, size=(n,))
        # Digit-dependent blob: mean brightness pattern per class.
        base = np.zeros((n, 28, 28, 1), np.float32)
        for c in range(NUM_CLASSES):
            idx = label == c
            if not idx.any():
                continue
            patt = np.zeros((28, 28, 1), np.float32)
            patt[2 + 2 * c : 6 + 2 * c, 4:24, 0] = 1.0
            base[idx] = patt
        img = base + 0.3 * rng.randn(n, 28, 28, 1).astype(np.float32)
        return {"image": img, "label": label.astype(np.int32)}

    return ModelDef(
        name="mnist",
        init_params=init_params,
        bind_params=bind_params,
        synth_batch=synth_batch,
        predict_fn=classifier_predict,
        predict_inputs=("image",),
        train_params=train_params,
        loss_fn=loss_fn,
        flops_per_example=mnist_flops(),
    )
