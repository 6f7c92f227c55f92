"""Model zoo of the port (the JAX package's benchmark workloads,
BASELINE.md configs 1-4, and the decoder-only LMs).  Importing this
package registers ``fit_a_line``, ``mnist``, ``resnet50``,
``transformer_base``, ``transformer_lm`` and ``longcontext_lm``."""

from edl_tpu_torch.models.base import (
    DecodeSpec,
    ModelDef,
    get_model,
    load_workspace_factory,
    register_model,
    registered_models,
)
# Built-ins register on import.
from edl_tpu_torch.models import fit_a_line  # noqa: F401
from edl_tpu_torch.models import mnist  # noqa: F401
from edl_tpu_torch.models import resnet  # noqa: F401
from edl_tpu_torch.models import transformer  # noqa: F401
from edl_tpu_torch.models import transformer_lm  # noqa: F401

__all__ = [
    "DecodeSpec",
    "ModelDef",
    "get_model",
    "load_workspace_factory",
    "register_model",
    "registered_models",
]
