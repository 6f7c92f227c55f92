"""The model contract (counterpart of ``edl_tpu/models/base.py``).

A model is a ``ModelDef`` of plain functions, looked up by entrypoint
name in a registry.  The JAX package's params are a pytree applied by
``module.apply``; here the device-resident params are the ``nn.Module``
itself, built from a ``state_dict``: by ``bind_params`` for serving
(weights in the compute dtype, no gradients) and by ``train_params``
for training (float32 parameters, as flax keeps them).  Partition
rules and workspace loading come with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

Batch = Dict[str, Any]
StateDict = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class DecodeSpec:
    """A model family's incremental-decode contract: the prefill and
    decode functions the serving engine dispatches per padded bucket,
    plus the cache geometry it allocates the paged KV pool from.

    - ``prefill_fn(params, tokens[B,P], lengths[B], kpool, vpool,
      tables[B,mb]) -> (ids[B], kpool, vpool)`` — run the prompt through
      the normal causal forward once, write every layer's K/V into the
      pool blocks, return the greedy next token read at each row's last
      real position (``lengths - 1``).  ``P`` is a block-aligned padded
      bucket.
    - ``decode_fn(params, tokens[B], lengths[B], kpool, vpool, tables)
      -> (ids[B], kpool, vpool)`` — one token of compute: write the
      token's K/V at position ``lengths[i]``, attend over the cache
      through the block table, return the next greedy id.
    - ``chunk_fn(params, tokens[B,C], offsets[B], lengths[B], kpool,
      vpool, tables) -> (ids[B], kpool, vpool)`` — chunked prefill: one
      block-aligned prompt slice at the block-aligned cache offset
      ``offsets[i]``; writes its K/V there and attends causally over
      every position filled before it and itself, through the
      (window-truncated) block table.  ``lengths`` is the count of
      filled positions after the chunk; the returned id, read at
      ``lengths - 1``, is the first generated token when the chunk is
      the prompt's last (it must equal ``prefill_fn``'s).  None: the
      family serves monolithic prefill only.

    The JAX functions are pure (pools in, pools out, donated by the
    engine).  Here the pools are written in place and the same tensors
    come back.  Pools are ``[layers, num_blocks, block_tokens, heads,
    head_dim]`` of ``cache_dtype``; ``max_len`` bounds prompt +
    generated length (the positional-table range).  ``vocab_size``
    bounds the token ids the engine admits (JAX clamps an out-of-range
    lookup; on the card it is a device-side assert).
    """

    layers: int
    heads: int
    head_dim: int
    max_len: int
    cache_dtype: torch.dtype
    prefill_fn: Callable[..., Tuple[Any, Any, Any]]
    decode_fn: Callable[..., Tuple[Any, Any, Any]]
    vocab_size: int
    chunk_fn: Optional[Callable[..., Tuple[Any, Any, Any]]] = None


@dataclass(frozen=True)
class ModelDef:
    """A model as plain functions.

    - ``init_params(generator)`` -> seeded CPU ``state_dict`` (float32,
      the flax ``param_dtype``; same layout ``convert.params_from_flax``
      produces)
    - ``bind_params(state_dict, device)`` -> the device-resident params
      object ``predict_fn`` and the decode functions take (the module
      with those weights loaded, in eval mode, no gradients)
    - ``synth_batch(rng, n)`` -> host-side numpy batch of size n
    - ``predict_fn(params, inputs)`` -> forward-only outputs dict;
      ``inputs`` holds exactly the ``predict_inputs`` keys as tensors
    - ``decode`` -> the incremental-decode contract, or None
    - ``train_params(state_dict, device)`` -> the trainable module:
      float32 parameters that take gradients, cast to the compute dtype
      inside each product
    - ``loss_fn(params, batch, generator)`` -> (scalar loss, aux metrics
      dict) on a ``train_params`` module and a batch of tensors; aux
      may carry ``valid_tokens``, the count of rows of the loss's
      denominator (the trainer weights data-parallel gradients by it)
    - ``flops_per_example`` (fwd+bwd matmul FLOPs, 0 = unknown) and
      ``tokens_per_example`` (0 = not a token model) for MFU and
      tokens/s accounting
    """

    name: str
    init_params: Callable[[torch.Generator], StateDict]
    bind_params: Callable[[StateDict, Any], Any]
    synth_batch: Callable[[np.random.RandomState, int], Batch]
    predict_fn: Optional[Callable[[Any, Batch], Dict[str, Any]]] = None
    predict_inputs: Tuple[str, ...] = ()
    decode: Optional[DecodeSpec] = None
    train_params: Optional[Callable[[StateDict, Any], Any]] = None
    loss_fn: Optional[
        Callable[[Any, Batch, Optional[torch.Generator]], Tuple[Any, Dict[str, Any]]]
    ] = None
    flops_per_example: int = 0
    tokens_per_example: int = 0


_REGISTRY: Dict[str, Callable[..., ModelDef]] = {}


def register_model(name: str):
    def deco(factory: Callable[..., ModelDef]):
        _REGISTRY[name] = factory
        return factory

    return deco


def get_model(name: str, **kwargs) -> ModelDef:
    """Build a registered model by entrypoint name."""
    import edl_tpu_torch.models  # noqa: F401  (register built-ins)

    factory = _REGISTRY.get(name)
    if factory is None:
        raise ValueError(
            f"unknown model {name!r}; registered: {sorted(_REGISTRY)}"
        )
    model = factory(**kwargs)
    if not isinstance(model, ModelDef):
        raise ValueError(
            f"model factory for {name!r} returned {type(model).__name__}, "
            "not a ModelDef"
        )
    return model


def registered_models():
    import edl_tpu_torch.models  # noqa: F401

    return sorted(_REGISTRY)
