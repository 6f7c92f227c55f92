"""Weights carried across from the JAX package: the flax parameter tree
of each family -> the port's ``state_dict`` (``TransformerLM`` both
ways; ``MoELM`` by ``moe_from_flax``).

The flax tree is taken as nested dicts of numpy arrays (``jax.device_get``
of the params, or a checkpoint's leaves), so this module imports no JAX.

Layout map, per layer ``i`` (``layer_i`` -> ``layers.{i}.``):

- ``attn/qkv/kernel`` ``[D, 3, H, Dh]`` -> ``attn.qkv.weight``
  ``[3*H*Dh, D]`` (flattened, transposed); bias ``[3, H, Dh]`` ->
  ``[3*H*Dh]``
- ``attn/out/kernel`` ``[H, Dh, D]`` -> ``attn.out.weight``
  ``[D, H*Dh]``
- Dense ``kernel`` ``[in, out]`` -> ``weight`` ``[out, in]``
- LayerNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``
- ``embed/embedding`` -> ``embed.weight``; ``pos_embed`` as is.

The other families (``fit_a_line_from_flax``, ``mnist_from_flax``,
``resnet_from_flax``, ``transformer_from_flax``) use the same maps and:

- Conv ``kernel`` ``[kh, kw, in, out]`` -> ``weight`` ``[out, in, kh,
  kw]``; GroupNorm ``scale`` -> ``weight``;
- cross attention's ``query/kernel`` ``[D, H, Dh]`` and ``kv/kernel``
  ``[D, 2, H, Dh]`` -> ``[H*Dh, D]`` and ``[2*H*Dh, D]``, their biases
  flattened;
- ``enc_i`` / ``dec_i`` -> ``encoder.{i}.`` / ``decoder.{i}.``.

A gradient tree has its parameters' structure, so the same functions
carry JAX gradients across for comparison.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_LNS = ("ln1", "ln2")
_DENSE = ("wi", "wo")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _np(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.numpy().copy()


def _dense(leaf, prefix: str) -> Dict[str, torch.Tensor]:
    """A flax Dense or DenseGeneral -> ``{prefix.weight [out, in],
    prefix.bias [out]}``.  The kernel's input axes come first (one of
    them) and its output axes last, except an attention output's
    (``prefix`` ending in ``out``: ``[H, Dh, D]``, two input axes)."""
    k = np.asarray(leaf["kernel"])
    bias = np.asarray(leaf["bias"]).reshape(-1)
    k = k.reshape(-1, bias.shape[0]) if prefix.endswith("out") else k.reshape(k.shape[0], -1)
    return {prefix + ".weight": _t(k.T), prefix + ".bias": _t(bias)}


def _norm(leaf, prefix: str) -> Dict[str, torch.Tensor]:
    return {prefix + ".weight": _t(leaf["scale"]), prefix + ".bias": _t(leaf["bias"])}


def _conv(leaf, prefix: str) -> Dict[str, torch.Tensor]:
    out = {prefix + ".weight": _t(np.transpose(np.asarray(leaf["kernel"]), (3, 2, 0, 1)))}
    if "bias" in leaf:
        out[prefix + ".bias"] = _t(leaf["bias"])
    return out


def _lm_from_flax(tree: Dict[str, Any], mlp) -> Dict[str, torch.Tensor]:
    """A decoder LM's tree: embeddings, per layer the norms, attention
    and ``mlp(layer_tree, prefix)``, and the final norm."""
    sd = {
        "embed.weight": _t(tree["embed"]["embedding"]),
        "pos_embed": _t(tree["pos_embed"]),
    }
    i = 0
    while f"layer_{i}" in tree:
        lp, p = tree[f"layer_{i}"], f"layers.{i}."
        for ln in _LNS:
            sd.update(_norm(lp[ln], p + ln))
        for name in ("qkv", "out"):
            sd.update(_dense(lp["attn"][name], p + "attn." + name))
        sd.update(mlp(lp, p))
        i += 1
    sd.update(_norm(tree["ln_f"], "ln_f"))
    return sd


def params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax ``TransformerLM`` params tree -> the port's state_dict
    (same dtype as the tree's leaves)."""
    def mlp(lp, p):
        return {k: v for name in _DENSE for k, v in _dense(lp[name], p + name).items()}

    return _lm_from_flax(tree, mlp)


def moe_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax ``MoELM`` params tree -> the port's state_dict: as
    ``params_from_flax``, with each layer's ``moe/router`` a Dense
    (``moe.router``) and the raw expert weights ``moe/wi`` ``[E, d,
    d_ff]`` and ``moe/wo`` ``[E, d_ff, d]`` as they are."""

    def mlp(lp, p):
        moe = lp["moe"]
        return {**_dense(moe["router"], p + "moe.router"),
                p + "moe.wi": _t(moe["wi"]), p + "moe.wo": _t(moe["wo"])}

    return _lm_from_flax(tree, mlp)


def flax_from_params(state_dict: Dict[str, torch.Tensor], num_heads: int) -> Dict[str, Any]:
    """The inverse of ``params_from_flax``: a state_dict -> the flax
    params tree (numpy leaves; bf16 tensors come back as float32)."""
    sd = state_dict
    tree: Dict[str, Any] = {
        "embed": {"embedding": _np(sd["embed.weight"])},
        "pos_embed": _np(sd["pos_embed"]),
    }
    d = sd["embed.weight"].shape[1]
    dh = d // num_heads
    i = 0
    while f"layers.{i}.ln1.weight" in sd:
        p = f"layers.{i}."
        layer: Dict[str, Any] = {}
        for ln in _LNS:
            layer[ln] = {"scale": _np(sd[p + ln + ".weight"]),
                         "bias": _np(sd[p + ln + ".bias"])}
        layer["attn"] = {
            "qkv": {
                "kernel": _np(sd[p + "attn.qkv.weight"]).T.reshape(d, 3, num_heads, dh).copy(),
                "bias": _np(sd[p + "attn.qkv.bias"]).reshape(3, num_heads, dh),
            },
            "out": {
                "kernel": _np(sd[p + "attn.out.weight"]).T.reshape(num_heads, dh, d).copy(),
                "bias": _np(sd[p + "attn.out.bias"]),
            },
        }
        for name in _DENSE:
            layer[name] = {"kernel": _np(sd[p + name + ".weight"]).T.copy(),
                           "bias": _np(sd[p + name + ".bias"])}
        tree[f"layer_{i}"] = layer
        i += 1
    tree["ln_f"] = {"scale": _np(sd["ln_f.weight"]), "bias": _np(sd["ln_f.bias"])}
    return tree


def fit_a_line_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"w", "b"}`` as they are."""
    return {"w": _t(tree["w"]), "b": _t(tree["b"])}


def mnist_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The ConvNet: ``Conv_0``, ``Conv_1``, ``Dense_0``, ``Dense_1``.
    ``Dense_0``'s rows stay in flax's (h, w, c) order: the port
    flattens NHWC activations (``models/mnist.py``)."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("Conv_0", "Conv_1"):
        sd.update(_conv(tree[name], name))
    for name in ("Dense_0", "Dense_1"):
        sd.update(_dense(tree[name], name))
    return sd


def resnet_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``stem``, ``stem_norm``, every ``stage{i}_block{j}`` (``conv1-3``,
    ``norm1-3``, ``proj``, ``norm_proj``) and ``head``."""
    sd = {**_conv(tree["stem"], "stem"), **_norm(tree["stem_norm"], "stem_norm"),
          **_dense(tree["head"], "head")}
    for block, leaves in tree.items():
        if not block.startswith("stage"):
            continue
        for name, leaf in leaves.items():
            p = f"{block}.{name}"
            sd.update(_norm(leaf, p) if name.startswith("norm") else _conv(leaf, p))
    return sd


def transformer_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The encoder-decoder: ``embed``, ``pos_embed``, ``enc_i`` ->
    ``encoder.{i}``, ``dec_i`` -> ``decoder.{i}``, ``ln_out``."""
    sd = {"embed.weight": _t(tree["embed"]["embedding"]), "pos_embed": _t(tree["pos_embed"]),
          **_norm(tree["ln_out"], "ln_out")}
    for layer, leaves in tree.items():
        for flax_prefix, torch_prefix in (("enc_", "encoder."), ("dec_", "decoder.")):
            if not layer.startswith(flax_prefix):
                continue
            p = torch_prefix + layer[len(flax_prefix):]
            for name, leaf in leaves.items():
                if name.startswith("ln_"):
                    sd.update(_norm(leaf, f"{p}.{name}"))
                else:  # an attention block or the MLP: Dense layers
                    for sub, dense in leaf.items():
                        sd.update(_dense(dense, f"{p}.{name}.{sub}"))
    return sd


__all__ = [
    "fit_a_line_from_flax",
    "flax_from_params",
    "mnist_from_flax",
    "moe_from_flax",
    "params_from_flax",
    "resnet_from_flax",
    "transformer_from_flax",
]
