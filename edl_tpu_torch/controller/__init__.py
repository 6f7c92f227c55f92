"""L2/L4: job parsing, lifecycle and the controller (counterpart of
``edl_tpu.controller``)."""

from edl_tpu_torch.controller.jobparser import (
    JobParser,
    parse_to_trainer,
    parse_to_trainer_manifests,
    parse_to_trainer_slice,
    parse_to_coordinator,
    pod_env,
)
from edl_tpu_torch.controller.lifecycle import JobLifecycle
from edl_tpu_torch.controller.controller import Controller

__all__ = [
    "JobParser",
    "parse_to_trainer",
    "parse_to_trainer_manifests",
    "parse_to_trainer_slice",
    "parse_to_coordinator",
    "pod_env",
    "JobLifecycle",
    "Controller",
]
