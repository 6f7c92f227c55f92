"""L0 resource model (counterpart of ``edl_tpu.resource``)."""

from edl_tpu_torch.resource.training_job import (
    GROUP,
    VERSION,
    KIND,
    GPU_RESOURCE_KEY,
    JobState,
    ResourceSpec,
    TrainerSpec,
    CoordinatorSpec,
    TrainingJobSpec,
    TrainingJobStatus,
    TrainingJob,
    ValidationError,
)

__all__ = [
    "GROUP",
    "VERSION",
    "KIND",
    "GPU_RESOURCE_KEY",
    "JobState",
    "ResourceSpec",
    "TrainerSpec",
    "CoordinatorSpec",
    "TrainingJobSpec",
    "TrainingJobStatus",
    "TrainingJob",
    "ValidationError",
]
