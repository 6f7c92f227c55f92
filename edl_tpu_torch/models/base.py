"""The model contract (counterpart of ``edl_tpu/models/base.py``).

A model is a ``ModelDef`` of plain functions, looked up by entrypoint
name in a registry.  The JAX package's params are a pytree applied by
``module.apply``; here the device-resident params are the ``nn.Module``
itself, built from a ``state_dict``: by ``bind_params`` for serving
(weights in the compute dtype, no gradients) and by ``train_params``
for training (float32 parameters, as flax keeps them).

User code: an entrypoint that is not registered loads from the job's
workspace (``load_workspace_factory``), the reference's whole trainer
interface (an opaque entrypoint run from the user's package,
``pkg/jobparser.go:288-291``).  Partition rules and ``bind_model``'s
mesh kwargs come with the parallel layouts.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

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


def divisor_at_most(n: int, want: int) -> int:
    """Largest divisor of ``n`` that is <= ``want`` — the shared
    quantizer for width-like knobs that must divide a token count (MoE
    routing groups)."""
    m = max(1, min(want, n))
    while n % m != 0:
        m -= 1
    return m


def materialize(make: Callable[[], nn.Module], state_dict: StateDict, device) -> nn.Module:
    """The module ``make()`` builds, on ``device`` with ``state_dict``'s
    weights: built on the meta device and materialized uninitialized,
    so binding pays no throwaway default init; the load casts each
    weight to its parameter's dtype."""
    with torch.device("meta"):
        module = make()
    module = module.to_empty(device=device)
    module.load_state_dict(state_dict)
    return module


_REGISTRY: Dict[str, Callable[..., ModelDef]] = {}


def register_model(name: str):
    def deco(factory: Callable[..., ModelDef]):
        _REGISTRY[name] = factory
        return factory

    return deco


def load_workspace_factory(workspace: str) -> Callable[..., ModelDef]:
    """Load user training code from ``workspace``/model.py.

    The user-code contract: the workspace directory holds a
    ``model.py`` exposing ``build(**kwargs) -> ModelDef`` (this
    package's ``ModelDef``, in PyTorch).  The workspace directory is on
    ``sys.path`` while ``model.py`` runs, so user code may import its
    sibling modules."""
    import importlib.util
    import sys

    path = os.path.join(workspace, "model.py")
    if not os.path.isfile(path):
        raise ValueError(
            f"workspace {workspace!r} has no model.py (the user-code "
            "contract: model.py exposing build(**kwargs) -> ModelDef)"
        )
    modname = f"_edl_workspace_{abs(hash(os.path.abspath(path)))}"
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, workspace)
    try:
        sys.modules[modname] = mod
        spec.loader.exec_module(mod)
    finally:
        try:
            sys.path.remove(workspace)
        except ValueError:
            pass
    build = getattr(mod, "build", None)
    if not callable(build):
        raise ValueError(
            f"{path} defines no callable build(**kwargs) -> ModelDef"
        )
    return build


def _resolve_factory(name: str, workspace: str = "") -> Callable[..., ModelDef]:
    """Registry lookup, falling back to the workspace's ``build`` for
    unregistered entrypoints.  A registered name never loads from the
    workspace."""
    import edl_tpu_torch.models  # noqa: F401  (register built-ins)

    factory = _REGISTRY.get(name)
    if factory is not None:
        return factory
    if workspace:
        return load_workspace_factory(workspace)
    raise ValueError(
        f"unknown model {name!r}; registered: {sorted(_REGISTRY)} "
        "(set trainer.workspace to train user code)"
    )


def get_model(name: str, workspace: str = "", **kwargs) -> ModelDef:
    """Build a model by entrypoint name: a registered family, or, for
    an unregistered name, the ``build`` of ``workspace``/model.py."""
    model = _resolve_factory(name, workspace)(**kwargs)
    if not isinstance(model, ModelDef):
        raise ValueError(
            f"model factory for {name!r} returned {type(model).__name__}, "
            "not a ModelDef"
        )
    return model


def registered_models():
    import edl_tpu_torch.models  # noqa: F401

    return sorted(_REGISTRY)
