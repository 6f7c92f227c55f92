"""Deterministic sharded data iteration (counterpart of
``edl_tpu/runtime/data.py``).

The global batch of step ``k`` is a pure function of ``(seed, step)``,
and each of ``world`` trainers takes the ``rank``-th contiguous slice of
it.  A membership change then re-slices the same batch stream, and a
replay from a checkpointed step sees the same data.  The permutation is
numpy's ``RandomState`` seeded exactly as the JAX package seeds it, so
the two packages give the same bytes for every step.

``BatchStager`` (background prefetch) comes with the elastic slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class ShardedDataIterator:
    """Index-based deterministic iterator over an in-memory dataset.

    ``dataset`` is a dict of host numpy arrays sharing a leading
    dimension.  Epoch shuffles depend on ``seed`` and the epoch number
    only, so two trainers (or one trainer before and after a resize)
    agree on every batch without communicating."""

    def __init__(
        self,
        dataset: Dict[str, np.ndarray],
        global_batch_size: int,
        seed: int = 0,
    ):
        if not dataset:
            raise ValueError("dataset must be non-empty")
        sizes = {k: len(v) for k, v in dataset.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"dataset arrays disagree on length: {sizes}")
        self.dataset = dataset
        self.n = next(iter(sizes.values()))
        if global_batch_size <= 0:
            raise ValueError("global_batch_size must be positive")
        if global_batch_size > self.n:
            raise ValueError(
                f"global_batch_size {global_batch_size} exceeds dataset size {self.n}"
            )
        self.global_batch_size = global_batch_size
        self.seed = seed
        self.batches_per_epoch = self.n // global_batch_size

    def global_indices(self, step: int) -> np.ndarray:
        """Dataset indices of step ``step``'s global batch (pure function)."""
        if step < 0:
            raise ValueError("step must be >= 0")
        epoch, within = divmod(step, self.batches_per_epoch)
        perm = np.random.RandomState(
            (self.seed * 1_000_003 + epoch) % (2**32)
        ).permutation(self.n)
        lo = within * self.global_batch_size
        return perm[lo : lo + self.global_batch_size]

    def host_batch(
        self, step: int, world: int = 1, rank: int = 0
    ) -> Dict[str, np.ndarray]:
        """Rank-local slice of the global batch for ``step``; ``world``
        only sets how the same global batch is cut."""
        if not (0 <= rank < world):
            raise ValueError(f"rank {rank} out of range for world {world}")
        if self.global_batch_size % world != 0:
            raise ValueError(
                f"global batch {self.global_batch_size} not divisible by world {world}"
            )
        idx = self.global_indices(step)
        per = self.global_batch_size // world
        sl = idx[rank * per : (rank + 1) * per]
        return {k: v[sl] for k, v in self.dataset.items()}

    def device_batch(
        self, step: int, device, world: int = 1, rank: int = 0
    ) -> Dict[str, torch.Tensor]:
        """The rank's slice of step ``step``'s global batch as tensors on
        ``device``; a CUDA copy goes through pinned host memory and
        does not block the host."""
        device = torch.device(device)
        out = {}
        for k, v in self.host_batch(step, world, rank).items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.to(device)
            out[k] = t
        return out


def synthetic_dataset(
    model_synth_batch, n_examples: int, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Materialize a fixed synthetic dataset from a ModelDef's batch
    generator (deterministic in ``seed``)."""
    rng = np.random.RandomState(seed)
    return model_synth_batch(rng, n_examples)


__all__ = ["ShardedDataIterator", "synthetic_dataset"]
