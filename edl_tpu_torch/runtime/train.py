"""The data-parallel train step (counterpart of
``edl_tpu/runtime/train.py``).

One ``Trainer`` runs one model on one device per process: forward,
backward, the data-parallel gradient average over a
``torch.distributed`` process group, and Adam.  The JAX package
compiles the whole step into one XLA program per mesh; here PyTorch
runs it eagerly, the hot operations in the port's CUDA kernels
(attention forward and backward, the fused tied-vocab loss).

The JAX ``Trainer.warm_step`` (AOT-compiling the step from abstract
shapes so that a resize pays no compile) has no counterpart: eager
PyTorch compiles nothing per shape, so there is nothing to warm.  (A
CUDA graph of the step, for its launch overhead, is later work.)

Unlike the JAX package's immutable ``TrainState`` pytree, the state is
updated in place (``step`` returns the same object): the parameters,
gradients and both Adam moments exist once, not twice, on the card.
Its flat form, the counterpart of flattening the pytree, is
``TrainState.leaves()``; ``Trainer.state_from_leaves`` builds a fresh
state from such leaves (a checkpoint restore).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from edl_tpu_torch import DeviceLike, generator, resolve_device
from edl_tpu_torch.models.base import Batch, ModelDef, StateDict


def leaf_template(params: List[torch.Tensor]) -> List[torch.Tensor]:
    """Tensors with the shapes and dtypes of ``TrainState.leaves()`` for
    these parameters (each parameter stands for its moments too)."""
    step = torch.empty((), dtype=torch.float32, device="meta")
    return list(params) + [x for p in params for x in (p, p, step)]


@dataclass
class TrainState:
    """Step counter, the trainable module (float32 parameters, their
    ``.grad`` the last step's gradients) and its optimizer, whose state
    holds Adam's moments."""

    step: int
    params: nn.Module
    opt_state: torch.optim.Optimizer

    def leaves(self) -> List[torch.Tensor]:
        """The state as a flat list in a fixed order: the float32
        parameters (``named_parameters`` order), then Adam's
        ``exp_avg``, ``exp_avg_sq`` and ``step`` for each parameter.
        Before the first step Adam holds no state; its leaves are then
        the zeros (and step 0) Adam starts from.  The step counts are
        the optimizer's own 0-d float32 host tensors."""
        params = list(self.params.parameters())
        out: List[torch.Tensor] = [p.detach() for p in params]
        for p in params:
            st = self.opt_state.state.get(p)
            if st:
                out += [st["exp_avg"], st["exp_avg_sq"], st["step"]]
            else:
                out += [torch.zeros_like(p), torch.zeros_like(p), torch.tensor(0.0)]
        return out


class Trainer:
    """Runs the train step of one model on one device.

    - Adam with optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8,
      eps_root 0, bias-corrected) on the float32 parameters.
      ``torch.optim.Adam`` computes the same update,
      ``lr * m_hat / (sqrt(v_hat) + eps)``, so it is used as it is.
    - With a ``process_group`` of more than one member, each rank's
      loss is weighted by its share of the global count of valid
      tokens (the loss's ``valid_tokens`` aux; equal shares without
      one) and the weighted gradients are summed with ``all_reduce``:
      the gradient of the loss over the global batch, whose denominator
      is the global valid count, so a world of 2 steps like a world of
      1 on the same global batch.
    - A loss may hold a term that is a function of sums over the whole
      global batch (``moe_lm``'s load-balancing loss, ``E * sum_e
      frac_e * mean_prob_e``: the halves' terms do not add up to the
      whole's).  Its aux then carries ``global_sums`` (this rank's sums,
      with their gradient), ``global_term`` (``(sums, world) -> (term,
      metrics)``) and ``loss`` (the rest), and the returned loss is
      ``aux["loss"] + global_term(global_sums, 1)[0]``.  At a world of
      more than one the trainer sums the sums over the group in the
      same ``all_reduce`` as the valid-token count (one collective
      after the forward, none at world 1), evaluates the term at the
      global sums ``G`` as ``global_term(G + (s - s.detach()), world)``
      (the global value, whose gradient reaches this rank's own sums
      ``s`` with the global coefficients), and adds it to the weighted
      rest unweighted: the value and the gradient of the global batch.
      The term's metrics (``moe_aux_loss``, ``moe_drop_rate``) are the
      global ones on every rank.  Ranks hold equal slices of the batch.
    - Each step's ``torch.Generator`` is seeded from ``(seed, step)``,
      in place of ``jax.random.fold_in``.
    """

    def __init__(
        self,
        model: ModelDef,
        lr: float = 1e-3,
        device: DeviceLike = None,
        seed: int = 0,
        process_group: Optional[Any] = None,
    ):
        if model.train_params is None or model.loss_fn is None:
            raise ValueError(f"model {model.name!r} has no training functions")
        self.model = model
        self.lr = lr
        self.device = resolve_device(device)
        self.seed = seed
        self.process_group = process_group
        self.world = 1 if process_group is None else dist.get_world_size(process_group)

    def init_state(self, state_dict: Optional[StateDict] = None) -> TrainState:
        """State at step 0 from ``state_dict`` (e.g. weights converted
        from flax), or from the model's seeded init — the same on every
        rank."""
        if state_dict is None:
            state_dict = self.model.init_params(generator(self.seed))
        params = self.model.train_params(state_dict, self.device)
        opt = torch.optim.Adam(
            params.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8
        )
        return TrainState(step=0, params=params, opt_state=opt)

    def state_from_leaves(
        self, step: int, leaves: List[torch.Tensor], names: List[str]
    ) -> TrainState:
        """A fresh state (new module, new optimizer) at ``step`` from
        tensors in ``TrainState.leaves()`` order, e.g. a restored
        checkpoint's; ``names`` are the parameters' names in that
        order.  The moments are adopted as given (float32 on this
        trainer's device); the step counts go to the host, where
        ``torch.optim.Adam`` keeps them."""
        n = len(names)
        if len(leaves) != 4 * n:
            raise ValueError(f"{len(leaves)} leaves for {n} parameters (want {4 * n})")
        state = self.init_state(dict(zip(names, leaves[:n])))
        steps = torch.stack([leaves[n + 3 * i + 2].reshape(()) for i in range(n)])
        steps = steps.to("cpu", torch.float32)
        sd = state.opt_state.state_dict()
        sd["state"] = {
            i: {
                "step": steps[i].clone(),
                "exp_avg": leaves[n + 3 * i],
                "exp_avg_sq": leaves[n + 3 * i + 1],
            }
            for i in range(n)
        }
        state.opt_state.load_state_dict(sd)
        state.step = int(step)
        return state

    def step_generator(self, step: int) -> torch.Generator:
        """The generator handed to the loss at ``step``: a pure function
        of ``(seed, step)``."""
        return generator((self.seed * 1_000_003 + step) % (2**63), self.device.type)

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=self.process_group)
        return x

    def loss_and_grads(
        self, state: TrainState, batch: Batch
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Forward and backward of the loss at ``state``: the gradients
        (averaged over the process group) land in the parameters'
        ``.grad``; returns the global loss and the loss's aux."""
        params = state.params
        state.opt_state.zero_grad(set_to_none=True)
        loss, aux = self.model.loss_fn(params, batch, self.step_generator(state.step))
        sums, term = aux.pop("global_sums", None), aux.pop("global_term", None)
        if self.world == 1:
            loss.backward()
            return loss.detach(), aux
        count = aux.get("valid_tokens")
        parts = [] if count is None else [count.detach().float().reshape(1)]
        if sums is not None:
            parts.append(sums.detach().reshape(-1))
        reduced = self._all_reduce(torch.cat(parts)) if parts else None
        if count is None:
            weight = torch.tensor(1.0 / self.world, device=loss.device)
        else:
            weight = count.detach().float() / reduced[0].clamp_min(1.0)
        unweighted = None
        if sums is not None:
            total = reduced[-sums.numel():].reshape(sums.shape)
            unweighted, metrics = term(total + (sums - sums.detach()), self.world)
            aux.update(metrics)
            loss = aux["loss"]
        weighted = loss * weight
        (weighted if unweighted is None else weighted + unweighted).backward()
        for p in params.parameters():
            if p.grad is not None:
                self._all_reduce(p.grad)
        out = self._all_reduce(weighted.detach())
        return (out if unweighted is None else out + unweighted.detach()), aux

    def step(self, state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, Any]]:
        """One Adam step on ``batch`` (this rank's slice of the global
        batch); returns the updated state and the step's metrics."""
        loss, aux = self.loss_and_grads(state, batch)
        state.opt_state.step()
        state.step += 1
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in aux.items()}
        metrics["loss"] = loss
        return state, metrics

    def eval_loss(self, state: TrainState, batch: Batch) -> torch.Tensor:
        """The loss at ``state`` on ``batch``, without gradients."""
        with torch.no_grad():
            return self.model.loss_fn(state.params, batch, generator(0, self.device.type))[0]


__all__ = ["TrainState", "Trainer", "leaf_template"]
