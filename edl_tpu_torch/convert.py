"""Weights carried across from the JAX package: the flax parameter tree
of ``TransformerLM`` <-> the port's ``state_dict``.

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


def params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax ``TransformerLM`` params tree -> the port's state_dict
    (same dtype as the tree's leaves)."""
    sd = {
        "embed.weight": _t(tree["embed"]["embedding"]),
        "pos_embed": _t(tree["pos_embed"]),
    }
    i = 0
    while f"layer_{i}" in tree:
        lp, p = tree[f"layer_{i}"], f"layers.{i}."
        for ln in _LNS:
            sd[p + ln + ".weight"] = _t(lp[ln]["scale"])
            sd[p + ln + ".bias"] = _t(lp[ln]["bias"])
        qkv = np.asarray(lp["attn"]["qkv"]["kernel"])
        sd[p + "attn.qkv.weight"] = _t(qkv.reshape(qkv.shape[0], -1).T)
        sd[p + "attn.qkv.bias"] = _t(np.asarray(lp["attn"]["qkv"]["bias"]).reshape(-1))
        out = np.asarray(lp["attn"]["out"]["kernel"])
        sd[p + "attn.out.weight"] = _t(out.reshape(-1, out.shape[-1]).T)
        sd[p + "attn.out.bias"] = _t(lp["attn"]["out"]["bias"])
        for name in _DENSE:
            sd[p + name + ".weight"] = _t(np.asarray(lp[name]["kernel"]).T)
            sd[p + name + ".bias"] = _t(lp[name]["bias"])
        i += 1
    sd["ln_f.weight"] = _t(tree["ln_f"]["scale"])
    sd["ln_f.bias"] = _t(tree["ln_f"]["bias"])
    return sd


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


__all__ = ["flax_from_params", "params_from_flax"]
