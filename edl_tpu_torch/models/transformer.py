"""Transformer-base, encoder-decoder (counterpart of
``edl_tpu/models/transformer.py``, BASELINE config 4, the JAX package's
flagship model): vocab 32000, d 512, d_ff 2048, 8 heads, 6 encoder and
6 decoder layers, T 256, a tied vocab projection.

The numerics are the flax module's, as in ``models/transformer_lm.py``:
Dense layers run in bf16 whatever their parameters' dtype; the
residual stream is bf16 (``embed + pos_embed`` cast to bf16); the
LayerNorms compute in float32 with eps 1e-6 and output float32; the
MLP's GELU is the tanh form.  Attention goes through
``ops.fused_attention`` with the padding masks (``src != 0`` for the
encoder's self attention and the decoder's cross attention,
``tgt != 0`` under the causal mask for the decoder's self attention):
kernels B1 and B2 on CUDA, ``reference_attention`` on the CPU.  The
loss is ``best_vocab_xent`` of the decoder features against the tied
embedding (kernels B4-B6 on CUDA); its aux carries ``valid_tokens``,
the label count the trainer weights data-parallel gradients by.

Weight layout is torch's; ``convert.transformer_from_flax`` maps the
flax tree (``qkv`` ``[D, 3, H, Dh]``, ``query`` ``[D, H, Dh]``, ``kv``
``[D, 2, H, Dh]``, ``out`` ``[H, Dh, D]``) onto it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch.models.base import ModelDef, StateDict, materialize, register_model
from edl_tpu_torch.models.transformer_lm import LN_EPS, Dense, lecun_normal
from edl_tpu_torch.ops import best_vocab_xent, fused_attention


class MlpBlock(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype, param_dtype):
        super().__init__()
        self.wi = Dense(d_model, d_ff, dtype, param_dtype)
        self.wo = Dense(d_ff, d_model, dtype, param_dtype)

    def forward(self, x):
        return self.wo(F.gelu(self.wi(x), approximate="tanh"))


class MultiHeadAttention(nn.Module):
    """Self attention (one fused ``qkv`` product) or cross attention
    (``query`` from the decoder, ``kv`` from the encoder), under a key
    padding mask and optionally causal."""

    def __init__(self, num_heads: int, d_model: int, dtype, param_dtype, cross: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.dtype = dtype
        self.cross = cross
        if cross:
            self.query = Dense(d_model, d_model, dtype, param_dtype)
            self.kv = Dense(d_model, 2 * d_model, dtype, param_dtype)
        else:
            self.qkv = Dense(d_model, 3 * d_model, dtype, param_dtype)
        self.out = Dense(d_model, d_model, dtype, param_dtype)

    def forward(self, q_in, kv_in, kv_mask, causal: bool = False):
        b, t, _ = q_in.shape
        h, dh = self.num_heads, self.head_dim
        if self.cross:
            q = self.query(q_in).view(b, t, h, dh)
            k, v = self.kv(kv_in).view(b, kv_in.shape[1], 2, h, dh).unbind(2)
        else:
            q, k, v = self.qkv(q_in).view(b, t, 3, h, dh).unbind(2)
        out = fused_attention(q, k, v, causal=causal, kv_mask=kv_mask)
        return self.out(out.to(self.dtype).reshape(b, t, -1))


class EncoderLayer(nn.Module):
    def __init__(self, num_heads, d_model, d_ff, dtype, param_dtype):
        super().__init__()
        self.ln_attn = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn = MultiHeadAttention(num_heads, d_model, dtype, param_dtype)
        self.ln_mlp = nn.LayerNorm(d_model, eps=LN_EPS)
        self.mlp = MlpBlock(d_model, d_ff, dtype, param_dtype)

    def forward(self, x, src_pad):
        h = self.ln_attn(x.float())
        x = x + self.attn(h, h, src_pad)
        return x + self.mlp(self.ln_mlp(x.float()))


class DecoderLayer(nn.Module):
    def __init__(self, num_heads, d_model, d_ff, dtype, param_dtype):
        super().__init__()
        self.ln_self = nn.LayerNorm(d_model, eps=LN_EPS)
        self.self_attn = MultiHeadAttention(num_heads, d_model, dtype, param_dtype)
        self.ln_cross = nn.LayerNorm(d_model, eps=LN_EPS)
        self.cross_attn = MultiHeadAttention(num_heads, d_model, dtype, param_dtype, cross=True)
        self.ln_mlp = nn.LayerNorm(d_model, eps=LN_EPS)
        self.mlp = MlpBlock(d_model, d_ff, dtype, param_dtype)

    def forward(self, y, enc, tgt_pad, src_pad):
        h = self.ln_self(y.float())
        y = y + self.self_attn(h, h, tgt_pad, causal=True)
        y = y + self.cross_attn(self.ln_cross(y.float()), enc, src_pad)
        return y + self.mlp(self.ln_mlp(y.float()))


class Transformer(nn.Module):
    """Encoder-decoder; ``features(src, tgt)`` gives the float32
    pre-projection decoder features ``[B, Tt, D]``."""

    def __init__(self, vocab_size: int = 32000, d_model: int = 512, d_ff: int = 2048,
                 num_heads: int = 8, num_layers: int = 6, max_len: int = 256,
                 dtype=torch.bfloat16, param_dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, d_model)
        self.pos_embed = nn.Parameter(torch.empty(max_len, d_model))
        self.encoder = nn.ModuleList(
            EncoderLayer(num_heads, d_model, d_ff, dtype, param_dtype) for _ in range(num_layers))
        self.decoder = nn.ModuleList(
            DecoderLayer(num_heads, d_model, d_ff, dtype, param_dtype) for _ in range(num_layers))
        self.ln_out = nn.LayerNorm(d_model, eps=LN_EPS)

    def features(self, src, tgt):
        """``src``, ``tgt``: ``[B, T]`` int, 0 = pad."""
        src_pad, tgt_pad = src != 0, tgt != 0
        x = (self.embed(src) + self.pos_embed[None, : src.shape[1]]).to(self.dtype)
        for layer in self.encoder:
            x = layer(x, src_pad)
        y = (self.embed(tgt) + self.pos_embed[None, : tgt.shape[1]]).to(self.dtype)
        for layer in self.decoder:
            y = layer(y, x, tgt_pad, src_pad)
        return self.ln_out(y.float())

    def forward(self, src, tgt):
        """``[B, Tt, V]`` float32 logits: the features against the tied
        embedding, both rounded to the compute dtype, summed in float32."""
        return tied_logits(self.features(src, tgt), self.embed.weight, self.dtype)


def tied_logits(y: torch.Tensor, embedding: torch.Tensor, dtype) -> torch.Tensor:
    """``y @ embedding.T`` of ``dtype`` operands summed in float32 (the
    flax einsum's ``preferred_element_type``)."""
    return y.to(dtype).float() @ embedding.to(dtype).float().t()


def transformer_loss_fn(params, batch, generator=None):
    """Next-token loss of the decoder: position i predicts ``tgt[i+1]``
    (the last position's output is dropped), label 0 masked out.  The
    features are cast to bf16 once into a contiguous copy, which the
    fused loss takes as it is.  Returns ``(loss, {"loss",
    "token_accuracy", "valid_tokens"})``."""
    src, tgt = batch["src"], batch["tgt"]
    labels = tgt[:, 1:]
    y = params.features(src, tgt)
    valid = labels != 0
    loss, acc = best_vocab_xent(y[:, :-1].to(torch.bfloat16), params.embed.weight, labels, valid)
    return loss, {"loss": loss, "token_accuracy": acc, "valid_tokens": valid.sum()}


def _make(vocab_size: int, d_model: int, d_ff: int, num_heads: int, num_layers: int,
          seq_len: int, name: str, dtype=torch.bfloat16) -> ModelDef:
    arch = dict(vocab_size=vocab_size, d_model=d_model, d_ff=d_ff, num_heads=num_heads,
                num_layers=num_layers, max_len=seq_len, dtype=dtype)

    def init_params(g: torch.Generator) -> StateDict:
        """flax's initializers: embedding N(0, 1), positions N(0, 0.02),
        Dense kernels lecun normal (fan in: the input width), zero
        biases, LayerNorm scale 1."""
        with torch.device("meta"):
            shapes = {k: v.shape for k, v in Transformer(**arch).state_dict().items()}
        sd: StateDict = {}
        for key, shape in shapes.items():
            if key == "embed.weight":
                sd[key] = torch.randn(shape, generator=g)
            elif key == "pos_embed":
                sd[key] = torch.randn(shape, generator=g) * 0.02
            elif key.endswith("weight") and len(shape) == 2:
                sd[key] = lecun_normal(shape, shape[1], g)
            elif key.endswith("weight"):
                sd[key] = torch.ones(shape)
            else:
                sd[key] = torch.zeros(shape)
        return sd

    def bind_params(state_dict: StateDict, device) -> Transformer:
        return materialize(lambda: Transformer(**arch, param_dtype=dtype), state_dict,
                           device).eval().requires_grad_(False)

    def train_params(state_dict: StateDict, device) -> Transformer:
        return materialize(lambda: Transformer(**arch), state_dict, device).train()

    def predict_fn(params, inputs) -> Dict[str, torch.Tensor]:
        """Forward-only translation scoring: the greedy next-token ids
        of the tied-vocab logits."""
        y = params.features(inputs["src"], inputs["tgt"])
        return {"tokens": torch.argmax(tied_logits(y, params.embed.weight, torch.bfloat16), -1)}

    def synth_batch(rng: np.random.RandomState, n: int):
        """Synthetic translation task: tgt is a deterministic function
        of src (reversal with vocab offset), so the model can actually
        learn and loss continuity is observable."""
        L = seq_len
        lengths = rng.randint(L // 2, L, size=(n,))
        src = np.zeros((n, L), np.int32)
        tgt = np.zeros((n, L), np.int32)
        body = rng.randint(3, vocab_size, size=(n, L))
        for i, ln in enumerate(lengths):
            src[i, :ln] = body[i, :ln]
            rev = body[i, :ln][::-1]
            mapped = 3 + ((rev - 3 + 1) % (vocab_size - 3))
            tgt[i, 0] = 1  # BOS
            tgt[i, 1 : ln + 1] = mapped[: L - 1]
        return {"src": src, "tgt": tgt}

    # The JAX package's count: matmul FLOPs per example, fwd+bwd (6 per
    # MAC), the attention score/PV terms (decoder self attention causal
    # at half) and the tied projection
    T = seq_len
    enc_tok = 4 * d_model * d_model + 2 * d_model * d_ff
    dec_tok = 8 * d_model * d_model + 2 * d_model * d_ff
    layer_flops = 6 * T * num_layers * (enc_tok + dec_tok)
    attn_flops = (12 * 2 + 6) * num_layers * T * T * d_model
    logits_flops = 6 * T * vocab_size * d_model

    return ModelDef(
        name=name,
        init_params=init_params,
        bind_params=bind_params,
        synth_batch=synth_batch,
        predict_fn=predict_fn,
        predict_inputs=("src", "tgt"),
        train_params=train_params,
        loss_fn=transformer_loss_fn,
        flops_per_example=layer_flops + attn_flops + logits_flops,
        tokens_per_example=seq_len,
    )


@register_model("transformer_base")
def transformer_base(tiny: bool = False, seq_len: Optional[int] = None,
                     dtype=torch.bfloat16) -> ModelDef:
    """Transformer-base (WMT en-de scale).  ``tiny=True`` gives the JAX
    package's test shape (vocab 256, d 64, d_ff 256, 4 heads, 2 layers,
    T 32; the same code path).  ``dtype``: the compute dtype."""
    if tiny:
        return _make(256, 64, 256, 4, 2, seq_len or 32, "transformer_base", dtype)
    return _make(32000, 512, 2048, 8, 6, seq_len or 256, "transformer_base", dtype)
