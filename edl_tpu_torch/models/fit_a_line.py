"""fit_a_line: linear regression on the UCI-housing-shaped problem
(counterpart of ``edl_tpu/models/fit_a_line.py``, BASELINE config 1).

The smallest model that runs the whole elastic runtime.  Synthetic data
is drawn from a fixed affine map, so the loss has a floor near the
noise variance; ``synth_batch`` is the JAX package's, line for line.
Parameters ``w`` ``[features]`` and ``b`` ``[]``, float32 throughout.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from edl_tpu_torch.models.base import ModelDef, StateDict, materialize, register_model

FEATURES = 13  # UCI housing feature count


class LinearRegression(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(features))
        self.b = nn.Parameter(torch.empty(()))

    def forward(self, x):
        return x @ self.w + self.b


@register_model("fit_a_line")
def fit_a_line(features: int = FEATURES, noise: float = 0.01, tiny: bool = False) -> ModelDef:
    """``tiny`` is accepted so that every family takes ``--tiny``; this
    model is small at every size."""
    rng_w = np.random.RandomState(0)
    true_w = rng_w.randn(features).astype(np.float32)
    true_b = np.float32(0.5)

    def init_params(g: torch.Generator) -> StateDict:
        return {"w": torch.randn(features, generator=g) * 0.01, "b": torch.zeros(())}

    def bind_params(state_dict: StateDict, device) -> LinearRegression:
        return materialize(lambda: LinearRegression(features), state_dict, device).eval() \
            .requires_grad_(False)

    def train_params(state_dict: StateDict, device) -> LinearRegression:
        return materialize(lambda: LinearRegression(features), state_dict, device).train()

    def loss_fn(params, batch, generator=None):
        pred = params(batch["x"])
        loss = torch.mean((pred - batch["y"]) ** 2)
        return loss, {"mse": loss}

    def predict_fn(params, inputs) -> Dict[str, torch.Tensor]:
        return {"pred": params(inputs["x"])}

    def synth_batch(rng: np.random.RandomState, n: int):
        x = rng.randn(n, features).astype(np.float32)
        y = x @ true_w + true_b + noise * rng.randn(n).astype(np.float32)
        return {"x": x, "y": y.astype(np.float32)}

    return ModelDef(
        name="fit_a_line",
        init_params=init_params,
        bind_params=bind_params,
        synth_batch=synth_batch,
        predict_fn=predict_fn,
        predict_inputs=("x",),
        train_params=train_params,
        loss_fn=loss_fn,
        flops_per_example=6 * features,  # fwd 2F + bwd 4F
    )
