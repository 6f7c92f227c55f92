"""``edl_tpu_torch`` — the PyTorch/CUDA port of ``edl_tpu``.

The package mirrors the JAX package's module paths and names so each
part has an obvious counterpart (``edl_tpu.serving.engine`` ->
``edl_tpu_torch.serving.engine``), but it imports nothing of
``edl_tpu``, ``jax``, ``flax`` or ``optax``: what it needs from
framework-free modules there, it keeps as its own copy.

Every entry point takes an explicit ``device`` and defaults to
``"cuda"``.  There is no silent CPU fallback: a caller that wants the
CPU (the parity tests) says ``device="cpu"``, and asking for CUDA on a
machine without it raises.

``torch`` is imported where it is used, not here: the control plane
(``resource``, ``cluster``, ``autoscaler``, ``controller``) runs without
it, and ``cluster.fake_kubectl``, started once per kubectl call, stays
quick.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Union

if TYPE_CHECKING:
    import torch

DeviceLike = Union[str, "torch.device", None]

#: the device every entry point uses unless the caller names another
DEFAULT_DEVICE = "cuda"


def resolve_device(device: DeviceLike = None) -> "torch.device":
    """The ``torch.device`` an entry point runs on: ``device`` as given,
    or CUDA when None.  Raises when CUDA is asked for and absent — the
    port never drops to the CPU behind a caller's back."""
    import torch

    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def generator(seed: int, device: Optional[str] = "cpu") -> "torch.Generator":
    """A seeded ``torch.Generator`` (CPU by default, so seeded weights
    are the same bytes on every machine)."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


__all__ = ["DEFAULT_DEVICE", "generator", "resolve_device"]
