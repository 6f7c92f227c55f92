"""Decoder-only transformer LM (counterpart of
``edl_tpu/models/transformer_lm.py``): serving and training.

The modules take a ``dtype`` and a ``param_dtype`` like the flax ones
and reproduce their numerics:

- LayerNorms compute in float32 with eps 1e-6 (flax's default; torch's
  is 1e-5);
- the MLP activation is the tanh approximation of GELU (flax
  ``nn.gelu``'s default; torch's default is erf);
- Dense layers run in ``dtype``: kernel, bias and input are cast to
  ``dtype`` inside the product, as flax does, so the parameters can
  stay in ``param_dtype`` (float32 for training, ``train_params``);
  serving's ``bind_params`` stores them in ``dtype`` and the casts are
  no-ops.  The residual stream is carried in ``dtype``;
- the tied logits are ``dtype`` x ``dtype`` products summed in float32.

The weight layout is torch's (``nn.Linear``: ``[out, in]``);
``convert.py`` maps the flax tree (qkv kernel ``[D, 3, H, Dh]``, out
kernel ``[H, Dh, D]``) onto it.  On CUDA, attention goes through the
flash kernels at every length (``ops.fused_attention``) and the loss
through the fused cross-entropy kernels (``ops.best_vocab_xent``); the
embedding's gradient is the lookup's plus the tied projection's dE.
The sequence-parallel ring comes with a later slice.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch.models.base import (
    DecodeSpec,
    ModelDef,
    StateDict,
    materialize,
    register_model,
)
from edl_tpu_torch.models.decode import LayerKV, greedy_from_features
from edl_tpu_torch.ops import best_vocab_xent, fused_attention

#: flax ``nn.LayerNorm``'s epsilon (torch's default is 1e-5)
LN_EPS = 1e-6


class Dense(nn.Linear):
    """``nn.Linear`` whose product runs in ``dtype`` whatever its
    parameters' dtype (flax ``nn.Dense(dtype=...)``: kernel, bias and
    input cast to ``dtype``)."""

    def __init__(self, in_features: int, out_features: int, dtype, param_dtype):
        super().__init__(in_features, out_features, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class CausalSelfAttention(nn.Module):
    def __init__(self, num_heads: int, d_model: int, dtype=torch.bfloat16,
                 param_dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.dtype = dtype
        param_dtype = param_dtype or dtype
        self.qkv = Dense(d_model, 3 * d_model, dtype, param_dtype)
        self.out = Dense(d_model, d_model, dtype, param_dtype)

    def forward(self, x, kv: Optional[LayerKV] = None):
        b, t, _ = x.shape
        qkv = self.qkv(x).view(
            b, t, 3, self.num_heads, self.head_dim
        )
        q, k, v = qkv.unbind(2)  # [B, T, H, Dh] strided views, no copy
        if kv is not None:
            # Incremental decode: this layer's K/V go into the paged
            # pool.  Prefill keeps the module's own causal attention;
            # a prefill chunk and decode attend over the cache.
            kv.write(k, v)
            out = fused_attention(q, k, v, causal=True) if kv.prefill else kv.attend(q)
        else:
            out = fused_attention(q, k, v, causal=True)
        return self.out(out.to(self.dtype).reshape(b, t, -1))


class LMBlock(nn.Module):
    def __init__(self, num_heads: int, d_model: int, d_ff: int,
                 dtype=torch.bfloat16, param_dtype=None):
        super().__init__()
        param_dtype = param_dtype or dtype
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn = CausalSelfAttention(num_heads, d_model, dtype, param_dtype)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.wi = Dense(d_model, d_ff, dtype, param_dtype)
        self.wo = Dense(d_ff, d_model, dtype, param_dtype)

    def forward(self, x, kv: Optional[LayerKV] = None):
        x = x + self.attn(self.ln1(x.float()), kv)
        h = F.gelu(self.wi(self.ln2(x.float())), approximate="tanh")
        return x + self.wo(h)


class TransformerLM(nn.Module):
    """The decoder-only LM.  ``block`` builds each layer from
    ``(num_heads, d_model, d_ff, dtype, param_dtype)`` and is called as
    ``block(x, kv)``: ``LMBlock`` here, ``MoEBlock`` for the MoE family
    (``models/moe.py``), which so shares this forward and its ``kv``
    paths."""

    def __init__(self, vocab_size: int, d_model: int, d_ff: int,
                 num_heads: int, num_layers: int, max_len: int,
                 dtype=torch.bfloat16, param_dtype=None,
                 block: Callable[..., nn.Module] = LMBlock):
        super().__init__()
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.max_len = max_len
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, d_model)
        self.pos_embed = nn.Parameter(torch.empty(max_len, d_model))
        self.layers = nn.ModuleList(
            block(num_heads, d_model, d_ff, dtype, param_dtype)
            for _ in range(num_layers)
        )
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS)
        self._logit_cache = None

    def logit_weight(self, dtype) -> torch.Tensor:
        """The tied embedding rounded through ``dtype`` and held in
        float32, so ``features.to(dtype).float() @ w.t()`` is the
        ``dtype`` x ``dtype`` -> float32 logits product.  Cached until
        the embedding's storage or version changes (a weight load)."""
        w = self.embed.weight
        if dtype == torch.float32:
            return w
        key = (dtype, w.data_ptr(), w._version)
        cache = self._logit_cache
        if cache is None or cache[0] != key:
            with torch.no_grad():
                cache = (key, w.detach().to(dtype).float())
            self._logit_cache = cache
        return cache[1]

    def forward(self, tokens, return_features: bool = False, kv=None):
        """``tokens``: ``[B, T]`` int.  Returns ``[B, T, V]`` float32
        logits, or the float32 pre-projection ``[B, T, D]`` features
        when ``return_features``.

        ``kv`` (incremental decode): ``(kpool, vpool, tables, lengths,
        prefill)`` — pools ``[L, nb, bt, H, D]``, per-row block tables
        and lengths (models/decode.py).  Prefill runs the causal
        forward over the prompt while writing every layer's K/V into
        the pool; decode takes ``tokens`` ``[B]`` (one token per row,
        at position ``lengths[i]``) and attends through the block
        table.  The six-tuple ``(kpool, vpool, tables, lengths,
        offsets, "chunk")`` is chunked prefill: ``tokens`` ``[B, C]``
        is one block-aligned prompt slice at positions ``offsets[i] +
        c``, written at its offset and attending causally over every
        filled position.  Returns ``(features, kpool, vpool)``; the
        pools are written in place."""
        if kv is not None:
            offsets = None
            if len(kv) == 6:
                kpool, vpool, tables, lengths, offsets, prefill = kv
            else:
                kpool, vpool, tables, lengths, prefill = kv
            if prefill == "chunk":
                t = tokens.shape[1]
                cpos = offsets.long()[:, None] + torch.arange(t, device=tokens.device)[None, :]
                x = self.embed(tokens) + self.pos_embed[cpos]
            elif prefill:
                t = tokens.shape[1]
                x = self.embed(tokens) + self.pos_embed[None, :t]
            else:
                x = self.embed(tokens[:, None]) + self.pos_embed[lengths.long()][:, None]
            x = x.to(self.dtype)
            for i, layer in enumerate(self.layers):
                x = layer(x, LayerKV(kpool[i], vpool[i], tables, lengths, prefill, offsets))
            return self.ln_f(x.float()), kpool, vpool
        t = tokens.shape[1]
        x = (self.embed(tokens) + self.pos_embed[None, :t]).to(self.dtype)
        for layer in self.layers:
            x = layer(x)
        x = self.ln_f(x.float())
        if return_features:
            return x
        return x.to(self.dtype).float() @ self.logit_weight(self.dtype).t()


def lm_synth_batch(vocab: int, L: int):
    """Deterministic periodic token stream (a copy of the JAX
    package's numpy generator: same ``RandomState`` -> same bytes)."""

    def synth_batch(rng: np.random.RandomState, n: int):
        start = rng.randint(3, vocab - 8, size=(n, 1))
        t = np.arange(L + 1)[None, :]
        tokens = 3 + ((start - 3) + t) % (vocab - 3)
        return {"tokens": tokens.astype(np.int32)}

    return synth_batch


def lm_flops(vocab: int, d_model: int, d_ff: int, layers: int, L: int) -> int:
    """Executed matmul FLOPs per example for a decoder LM (fwd+bwd): the
    per-token layer matmuls, the causal attention score/PV terms (causal
    halves the T^2 work) and the tied vocab projection (a copy of the
    JAX package's formula, so MFU is counted the same way)."""
    params_per_layer = 4 * d_model * d_model + 2 * d_model * d_ff
    return (
        6 * (layers * params_per_layer + vocab * d_model) * L
        + 12 * layers * L * L * d_model // 2
    )


def lm_loss_fn(params, batch, generator=None):
    """Next-token loss of a ``TransformerLM`` on ``batch["tokens"]``
    ``[B, L+1]``: features of ``tokens[:, :-1]``, labels
    ``tokens[:, 1:]``, label 0 masked out, tied-vocab cross entropy
    (``best_vocab_xent``).  The model is deterministic, so
    ``generator`` is unused.  Returns ``(loss, {"loss", "valid_tokens"})``."""
    tokens = batch["tokens"]
    labels = tokens[:, 1:]
    x = params(tokens[:, :-1], return_features=True)
    valid = labels != 0
    loss, _ = best_vocab_xent(x, params.embed.weight, labels, valid)
    return loss, {"loss": loss, "valid_tokens": valid.sum()}


def lecun_normal(shape, fan_in: int, g: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=g)
    return t


def init_state_dict(vocab: int, d_model: int, d_ff: int, num_layers: int,
                    max_len: int, g: torch.Generator) -> StateDict:
    """Seeded float32 weights with flax's initializer distributions
    (embedding N(0, 1), positions N(0, 0.02), Dense kernels lecun
    normal, biases 0, LayerNorm scale 1).  The numbers differ from
    ``jax.random``'s for the same seed; the parity tests carry JAX
    weights over with ``convert.py`` instead."""
    sd: Dict[str, torch.Tensor] = {
        "embed.weight": torch.randn(vocab, d_model, generator=g),
        "pos_embed": torch.randn(max_len, d_model, generator=g) * 0.02,
    }
    dense = {
        "attn.qkv": (3 * d_model, d_model),
        "attn.out": (d_model, d_model),
        "wi": (d_ff, d_model),
        "wo": (d_model, d_ff),
    }
    for i in range(num_layers):
        p = f"layers.{i}."
        for ln in ("ln1", "ln2"):
            sd[p + ln + ".weight"] = torch.ones(d_model)
            sd[p + ln + ".bias"] = torch.zeros(d_model)
        for name, (out_f, in_f) in dense.items():
            sd[p + name + ".weight"] = lecun_normal((out_f, in_f), in_f, g)
            sd[p + name + ".bias"] = torch.zeros(out_f)
    sd["ln_f.weight"] = torch.ones(d_model)
    sd["ln_f.bias"] = torch.zeros(d_model)
    return sd


def lm_decode_spec(heads: int, d_model: int, num_layers: int, L: int,
                   vocab: int, dtype) -> DecodeSpec:
    """KV-cached prefill, chunk and decode functions for a
    ``TransformerLM`` (the ``params`` argument is the bound module)."""

    def prefill_fn(params, tokens, lengths, kpool, vpool, tables):
        feats, kp, vp = params(tokens, kv=(kpool, vpool, tables, lengths, True))
        last = (lengths.long() - 1).clamp(0, tokens.shape[1] - 1)
        ids = greedy_from_features(
            feats, params.logit_weight(torch.bfloat16), positions=last
        )
        return ids, kp, vp

    def decode_fn(params, tokens, lengths, kpool, vpool, tables):
        feats, kp, vp = params(tokens, kv=(kpool, vpool, tables, lengths, False))
        ids = greedy_from_features(feats, params.logit_weight(torch.bfloat16))
        return ids, kp, vp

    def chunk_fn(params, tokens, offsets, lengths, kpool, vpool, tables):
        # ``lengths`` counts the filled positions after this chunk, so
        # on the prompt's final chunk the read lands on its last real
        # position: the first generated token.
        feats, kp, vp = params(
            tokens, kv=(kpool, vpool, tables, lengths, offsets, "chunk")
        )
        last = (lengths.long() - 1 - offsets.long()).clamp(0, tokens.shape[1] - 1)
        ids = greedy_from_features(
            feats, params.logit_weight(torch.bfloat16), positions=last
        )
        return ids, kp, vp

    return DecodeSpec(
        layers=num_layers,
        heads=heads,
        head_dim=d_model // heads,
        max_len=L,
        cache_dtype=dtype,
        prefill_fn=prefill_fn,
        decode_fn=decode_fn,
        vocab_size=vocab,
        chunk_fn=chunk_fn,
    )


@register_model("transformer_lm")
def transformer_lm(
    tiny: bool = False,
    seq_len: Optional[int] = None,
    dtype=torch.bfloat16,
) -> ModelDef:
    if tiny:
        vocab, d_model, d_ff, heads, layers = 256, 64, 256, 4, 2
        L = seq_len or 64
    else:
        vocab, d_model, d_ff, heads, layers = 32000, 768, 3072, 12, 12
        L = seq_len or 2048
    arch = dict(vocab_size=vocab, d_model=d_model, d_ff=d_ff,
                num_heads=heads, num_layers=layers, max_len=L)

    def init_params(g: torch.Generator) -> StateDict:
        return init_state_dict(vocab, d_model, d_ff, layers, L, g)

    def _module(state_dict: StateDict, device, param_dtype) -> TransformerLM:
        return materialize(
            lambda: TransformerLM(**arch, dtype=dtype, param_dtype=param_dtype), state_dict, device)

    def bind_params(state_dict: StateDict, device) -> TransformerLM:
        return _module(state_dict, device, dtype).eval().requires_grad_(False)

    def train_params(state_dict: StateDict, device) -> TransformerLM:
        return _module(state_dict, device, torch.float32).train()

    def predict_fn(params, inputs) -> Dict[str, torch.Tensor]:
        """Forward-only next-token prediction.  Request rows may carry
        the training corpus's L+1 layout; the slice keeps the
        positional table in range.  Greedy ids only."""
        tokens = inputs["tokens"][:, :L]
        x = params(tokens, return_features=True)
        logits = x.to(torch.bfloat16).float() @ params.logit_weight(torch.bfloat16).t()
        return {"tokens": torch.argmax(logits, dim=-1)}

    return ModelDef(
        name="transformer_lm",
        init_params=init_params,
        bind_params=bind_params,
        synth_batch=lm_synth_batch(vocab, L),
        predict_fn=predict_fn,
        predict_inputs=("tokens",),
        decode=lm_decode_spec(heads, d_model, layers, L, vocab, dtype),
        train_params=train_params,
        loss_fn=lm_loss_fn,
        flops_per_example=lm_flops(vocab, d_model, d_ff, layers, L),
        tokens_per_example=L,
    )


@register_model("longcontext_lm")
def longcontext_lm(
    tiny: bool = False,
    seq_len: Optional[int] = None,
    dtype=torch.bfloat16,
) -> ModelDef:
    """The same decoder-only family at the long-context length (4k
    default, 128 tiny), registered under its own name."""
    import dataclasses

    base = transformer_lm(
        tiny=tiny, seq_len=seq_len or (128 if tiny else 4096), dtype=dtype
    )
    return dataclasses.replace(base, name="longcontext_lm")
