"""Model zoo of the port (the JAX package's benchmark workloads,
BASELINE.md configs 1-4, the decoder-only LMs and the MoE LM).  Importing this
package registers ``fit_a_line``, ``mnist``, ``resnet50``,
``transformer_base``, ``transformer_lm``, ``longcontext_lm`` and
``moe_lm``."""

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
from edl_tpu_torch.models import moe  # noqa: F401

__all__ = [
    "DecodeSpec",
    "ModelDef",
    "get_model",
    "load_workspace_factory",
    "register_model",
    "registered_models",
]
