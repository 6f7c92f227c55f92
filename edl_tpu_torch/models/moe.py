"""Mixture-of-Experts LM (counterpart of ``edl_tpu/models/moe.py``):
training and serving.

Static-shape, capacity-based top-1 routing (the Switch-Transformer
recipe), written as the JAX package writes it, in products:

- a float32 router ``Dense(d, E)`` on the float32 LayerNorm output,
  softmax, the top expert per token (``argmax``: the first index on
  ties) and the winner's probability as its gate;
- tokens route within groups of ``G = divisor_at_most(n, group)``
  flattened tokens; a token's slot in its expert's per-group buffer is
  an exclusive cumulative sum, and tokens past the capacity ``cap =
  max(1, int(1.25 * G / E))`` are dropped (their residual passes
  through unchanged);
- the one-hot ``dispatch`` ``[g, G, E, C]`` copies tokens into the
  expert buffers, every expert runs its MLP (``[E, d, d_ff]`` and
  ``[E, d_ff, d]`` weights, no bias, tanh GELU) on its buffer, and the
  gate-weighted ``combine`` (rounded to the compute dtype, as the JAX
  ``combine.astype``) gathers the outputs back.

The dispatch and combine products are XLA einsums in the JAX package,
not Pallas kernels, so they are ``torch.einsum`` here; attention and the
loss go through the port's kernels as ``transformer_lm``'s do
(``MoELM`` is a ``TransformerLM`` whose blocks are ``MoEBlock``).

The one-hots are comparisons with ``arange``: a dropped token's slot
index ``cap`` matches no column and gives the all-zero row that
``jax.nn.one_hot`` gives an out-of-range index.  The gate is ``probs``
times the one-hot summed over experts (bit-identical to the maximum);
its gradient is an elementwise product.  No product or gradient of the
layer scatters with accumulation, so a step replays bit for bit.

Every ``kv`` path (prefill, chunk, decode) routes per token (group 1,
where capacity never binds), as the JAX ``MoEBlock`` does: a sequence's
tokens then depend neither on its batch-mates nor on where a chunked
prefill cut its prompt.  It runs the same products at ``G = 1``: each
token goes through all E experts and the one-hot keeps its own, E times
the expert FLOPs of a gather per expert, but with no data-dependent
shape and so no device-to-host sync in a decode step.  ``predict_fn``
routes in capacity groups, as JAX's does, so serving's full-recompute
anchor is a per-token-routed prefill, never ``predict_fn``.

The load-balancing loss (``E * sum_e frac_e * mean_prob_e``) is a
function of sums over the whole batch.  Each layer records its sums
(``MoEMlp.router_stats``: tokens per expert, probability per expert,
tokens kept), the counterpart of flax's ``sow``; ``loss_fn`` hands them
to the ``Trainer`` as a global-batch term (``runtime/train.py``), so a
world of several ranks takes the JAX global batch's value and
gradient.

Expert parallelism (the JAX ``ep_mesh``) comes with the parallel
layouts (ROADMAP A-8).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch.models.base import (
    ModelDef,
    StateDict,
    divisor_at_most,
    materialize,
    register_model,
)
from edl_tpu_torch.models.transformer_lm import (
    LN_EPS,
    CausalSelfAttention,
    Dense,
    TransformerLM,
    lecun_normal,
    lm_decode_spec,
    lm_synth_batch,
)
from edl_tpu_torch.ops import best_vocab_xent

#: the routing capacity factor and the aux loss's weight in the total
CAPACITY_FACTOR = 1.25
AUX_WEIGHT = 0.01


def top1(probs: torch.Tensor) -> torch.Tensor:
    """Each token's expert: the first index of its largest probability."""
    return torch.argmax(probs, dim=-1)


class MoEMlp(nn.Module):
    """Top-1 capacity-routed expert MLP over ``num_experts`` experts."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int,
                 capacity_factor: float = CAPACITY_FACTOR, group: int = 256,
                 dtype=torch.bfloat16, param_dtype=None):
        super().__init__()
        param_dtype = param_dtype or dtype
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.group = group
        self.dtype = dtype
        # The router stays float32 in every binding: small, and it
        # decides the routes.
        self.router = Dense(d_model, num_experts, torch.float32, torch.float32)
        self.wi = nn.Parameter(torch.empty(num_experts, d_model, d_ff, dtype=param_dtype))
        self.wo = nn.Parameter(torch.empty(num_experts, d_ff, d_model, dtype=param_dtype))
        #: the last forward's ``[2E + 1]`` float32 sums: tokens per
        #: expert, probability per expert (with its gradient), tokens kept
        self.router_stats: Optional[torch.Tensor] = None

    def route(self, x, group: Optional[int] = None):
        """The routing of ``x`` ``[b, t, d]`` in groups of ``group``
        (default ``self.group``): ``(expert [n], keep [g, G], dispatch
        [g, G, E, C], combine [g, G, E, C])``; records
        ``router_stats``."""
        b, t, d = x.shape
        n = b * t
        e = self.num_experts
        G = divisor_at_most(n, self.group if group is None else group)
        g = n // G
        cap = max(1, int(self.capacity_factor * G / e))
        logits = self.router(x.reshape(n, d).float())  # [n, E]
        probs = torch.softmax(logits, dim=-1)
        expert = top1(probs)  # [n]
        onehot = (expert[:, None] == torch.arange(e, device=x.device)).float()
        gate = (probs * onehot).sum(-1)  # [n], the winner's probability
        oh_g = onehot.reshape(g, G, e)
        pos = torch.cumsum(oh_g, dim=1) - oh_g  # exclusive, [g, G, E]
        pos_in_expert = (pos * oh_g).sum(-1).long()  # [g, G]
        keep = pos_in_expert < cap
        slot_idx = torch.where(keep, pos_in_expert, torch.full_like(pos_in_expert, cap))
        slot = (slot_idx[..., None] == torch.arange(cap, device=x.device)).float()
        dispatch = oh_g[..., None] * slot[:, :, None, :]  # [g, G, E, C]
        combine = dispatch * gate.reshape(g, G)[..., None, None]
        self.router_stats = torch.cat(
            [onehot.sum(0), probs.sum(0), keep.sum().float().reshape(1)])
        return expert, keep, dispatch, combine

    def forward(self, x, group: Optional[int] = None):
        """``x``: the float32 LayerNorm output ``[b, t, d]``; returns the
        experts' combined output in the compute dtype."""
        b, t, d = x.shape
        _, _, dispatch, combine = self.route(x, group)
        g, G = dispatch.shape[:2]
        dt = self.dtype
        tok_g = x.reshape(g, G, d).to(dt)
        buffers = torch.einsum("gnec,gnd->gecd", dispatch.to(dt), tok_g)
        h = torch.einsum("gecd,edf->gecf", buffers, self.wi.to(dt))
        h = F.gelu(h, approximate="tanh")
        out_buffers = torch.einsum("gecf,efd->gecd", h, self.wo.to(dt))
        out = torch.einsum("gnec,gecd->gnd", combine.to(dt), out_buffers)
        return out.reshape(b, t, d)


class MoEBlock(nn.Module):
    """Attention and the expert MLP: routing group 1 on every ``kv``
    path, ``group`` otherwise (the JAX ``MoEBlock``)."""

    def __init__(self, num_heads: int, d_model: int, d_ff: int,
                 dtype=torch.bfloat16, param_dtype=None, *,
                 num_experts: int, group: int = 256):
        super().__init__()
        param_dtype = param_dtype or dtype
        self.group = group
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn = CausalSelfAttention(num_heads, d_model, dtype, param_dtype)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.moe = MoEMlp(d_model, d_ff, num_experts, group=group, dtype=dtype,
                          param_dtype=param_dtype)

    def forward(self, x, kv=None):
        x = x + self.attn(self.ln1(x.float()), kv)
        return x + self.moe(self.ln2(x.float()), group=1 if kv is not None else self.group)


class MoELM(TransformerLM):
    """``TransformerLM`` with ``MoEBlock`` layers: the same forward,
    ``kv`` paths and tied logits."""

    def __init__(self, vocab_size: int, d_model: int, d_ff: int, num_heads: int,
                 num_layers: int, num_experts: int, max_len: int, group: int = 256,
                 dtype=torch.bfloat16, param_dtype=None):
        super().__init__(
            vocab_size, d_model, d_ff, num_heads, num_layers, max_len, dtype, param_dtype,
            block=functools.partial(MoEBlock, num_experts=num_experts, group=group))
        self.num_experts = num_experts
        self.group = group


def router_term(num_experts: int, n: int, group_width: int, group: int):
    """The global-batch term of ``MoELM``'s loss: ``term(sums, world)``
    of the ``[layers, 2E + 1]`` router sums over ``world`` equal slices
    of ``n`` tokens each -> ``(AUX_WEIGHT * aux, {"moe_aux_loss",
    "moe_drop_rate"})``, both averaged over layers.  A world of several
    slices must group as the whole batch does: a slice has to begin on
    a routing-group boundary."""
    e = num_experts

    def term(sums, world: int = 1):
        if world > 1 and divisor_at_most(n * world, group) != group_width:
            raise ValueError(
                f"routing groups of {divisor_at_most(n * world, group)} tokens over "
                f"{world} slices of {n} do not begin at the slices' first tokens "
                f"(a slice groups by {group_width}); choose a batch whose tokens per "
                "rank are a multiple of the group width")
        N = float(n * world)
        counts, prob_sums, kept = sums[:, :e], sums[:, e:2 * e], sums[:, 2 * e]
        aux = (e * ((counts / N) * (prob_sums / N)).sum(-1)).mean()
        drop = (1.0 - kept / N).mean()
        return AUX_WEIGHT * aux, {"moe_aux_loss": aux, "moe_drop_rate": drop}

    return term


def moe_loss_fn(params, batch, generator=None):
    """Next-token loss of an ``MoELM`` plus ``AUX_WEIGHT`` x the
    load-balancing loss (``generator`` unused).  Returns ``(total,
    {"loss", "moe_aux_loss", "moe_drop_rate", "valid_tokens",
    "global_sums", "global_term"})``: ``loss`` the cross entropy,
    ``total = loss + global_term(global_sums, 1)[0]``."""
    tokens = batch["tokens"]
    labels = tokens[:, 1:]
    x = params(tokens[:, :-1], return_features=True)
    valid = labels != 0
    loss, _ = best_vocab_xent(x, params.embed.weight, labels, valid)
    sums = torch.stack([layer.moe.router_stats for layer in params.layers])
    n = labels.numel()
    term = router_term(params.num_experts, n, divisor_at_most(n, params.group), params.group)
    weighted_aux, metrics = term(sums, 1)
    return loss + weighted_aux, {
        "loss": loss, **metrics, "valid_tokens": valid.sum(),
        "global_sums": sums, "global_term": term,
    }


def moe_flops(vocab: int, d_model: int, d_ff: int, layers: int, L: int, group: int) -> int:
    """Active FLOPs per example (fwd+bwd), the JAX package's formula:
    attention projections as a dense LM, one expert's MLP per token, the
    dispatch and combine products (``2 * int(1.25 * G) * d_model`` a
    token, G the routing group) and the tied vocab projection."""
    att_proj = 4 * d_model * d_model
    G = min(group, L)
    route = 2 * int(CAPACITY_FACTOR * G) * d_model
    return (
        6 * (layers * (att_proj + 2 * d_model * d_ff + route) + vocab * d_model) * L
        + 12 * layers * L * L * d_model // 2
    )


def init_state_dict(vocab: int, d_model: int, d_ff: int, num_layers: int,
                    num_experts: int, max_len: int, g: torch.Generator) -> StateDict:
    """Seeded float32 weights with flax's initializer distributions
    (``transformer_lm.init_state_dict``'s, and for the experts flax's
    ``lecun_normal`` on ``[E, in, out]``, whose fan-in counts the
    expert axis: E x in)."""
    sd: Dict[str, torch.Tensor] = {
        "embed.weight": torch.randn(vocab, d_model, generator=g),
        "pos_embed": torch.randn(max_len, d_model, generator=g) * 0.02,
    }
    dense = {"attn.qkv": (3 * d_model, d_model), "attn.out": (d_model, d_model),
             "moe.router": (num_experts, d_model)}
    for i in range(num_layers):
        p = f"layers.{i}."
        for ln in ("ln1", "ln2"):
            sd[p + ln + ".weight"] = torch.ones(d_model)
            sd[p + ln + ".bias"] = torch.zeros(d_model)
        for name, (out_f, in_f) in dense.items():
            sd[p + name + ".weight"] = lecun_normal((out_f, in_f), in_f, g)
            sd[p + name + ".bias"] = torch.zeros(out_f)
        sd[p + "moe.wi"] = lecun_normal((num_experts, d_model, d_ff), num_experts * d_model, g)
        sd[p + "moe.wo"] = lecun_normal((num_experts, d_ff, d_model), num_experts * d_ff, g)
    sd["ln_f.weight"] = torch.ones(d_model)
    sd["ln_f.bias"] = torch.zeros(d_model)
    return sd


@register_model("moe_lm")
def moe_lm(
    tiny: bool = False,
    seq_len: Optional[int] = None,
    num_experts: Optional[int] = None,
    group_size: Optional[int] = None,
    dtype=torch.bfloat16,
    ep_mesh=None,
) -> ModelDef:
    if ep_mesh is not None:
        raise ValueError(
            "moe_lm: expert parallelism (ep_mesh) comes with the parallel layouts "
            "(ROADMAP A-8); the port runs the experts on one device")
    if tiny:
        vocab, d_model, d_ff, heads, layers = 256, 64, 128, 4, 2
        experts = num_experts or 4
        L = seq_len or 64
    else:
        vocab, d_model, d_ff, heads, layers = 32000, 768, 3072, 12, 12
        experts = num_experts or 8
        L = seq_len or 2048
    group = group_size or 256
    arch = dict(vocab_size=vocab, d_model=d_model, d_ff=d_ff, num_heads=heads,
                num_layers=layers, num_experts=experts, max_len=L, group=group)

    def init_params(g: torch.Generator) -> StateDict:
        return init_state_dict(vocab, d_model, d_ff, layers, experts, L, g)

    def _module(state_dict: StateDict, device, param_dtype) -> MoELM:
        return materialize(
            lambda: MoELM(**arch, dtype=dtype, param_dtype=param_dtype), state_dict, device)

    def bind_params(state_dict: StateDict, device) -> MoELM:
        return _module(state_dict, device, dtype).eval().requires_grad_(False)

    def train_params(state_dict: StateDict, device) -> MoELM:
        return _module(state_dict, device, torch.float32).train()

    def predict_fn(params, inputs) -> Dict[str, torch.Tensor]:
        """Forward-only greedy ids, routed in capacity groups as the
        train step routes (the router's sums are not read)."""
        tokens = inputs["tokens"][:, :L]
        x = params(tokens, return_features=True)
        logits = x.to(torch.bfloat16).float() @ params.logit_weight(torch.bfloat16).t()
        return {"tokens": torch.argmax(logits, dim=-1)}

    return ModelDef(
        name="moe_lm",
        init_params=init_params,
        bind_params=bind_params,
        synth_batch=lm_synth_batch(vocab, L),
        predict_fn=predict_fn,
        predict_inputs=("tokens",),
        decode=lm_decode_spec(heads, d_model, layers, L, vocab, dtype),
        train_params=train_params,
        loss_fn=moe_loss_fn,
        flops_per_example=moe_flops(vocab, d_model, d_ff, layers, L, group),
        tokens_per_example=L,
    )


__all__ = ["MoEBlock", "MoELM", "MoEMlp", "moe_flops", "moe_loss_fn", "router_term"]
