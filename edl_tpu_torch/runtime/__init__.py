"""Trainer runtime of the port: the deterministic data stream, the
data-parallel train step, the coordinator and the elastic loop."""

from edl_tpu_torch.runtime.coordinator import ElasticPlan, LocalCoordinator
from edl_tpu_torch.runtime.data import BatchStager, ShardedDataIterator, synthetic_dataset
from edl_tpu_torch.runtime.elastic import ElasticTrainer, ResizeEvent, StepRecord
from edl_tpu_torch.runtime.train import Trainer, TrainState

__all__ = [
    "BatchStager",
    "ElasticPlan",
    "ElasticTrainer",
    "LocalCoordinator",
    "ResizeEvent",
    "ShardedDataIterator",
    "StepRecord",
    "TrainState",
    "Trainer",
    "synthetic_dataset",
]
