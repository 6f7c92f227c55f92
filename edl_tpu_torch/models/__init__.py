"""Model zoo of the port.  Importing this package registers the
families ported so far (``transformer_lm``, ``longcontext_lm``)."""

from edl_tpu_torch.models.base import (
    DecodeSpec,
    ModelDef,
    get_model,
    register_model,
    registered_models,
)
from edl_tpu_torch.models import transformer_lm  # noqa: F401  (registers)

__all__ = [
    "DecodeSpec",
    "ModelDef",
    "get_model",
    "register_model",
    "registered_models",
]
