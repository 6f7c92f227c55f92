"""Trainer runtime of the port: the deterministic data stream and the
data-parallel train step.  The elastic loop (``ElasticTrainer``, the
coordinators, ``HostDRAMStore``, ``BatchStager``) comes with a later
slice."""

from edl_tpu_torch.runtime.data import ShardedDataIterator, synthetic_dataset
from edl_tpu_torch.runtime.train import Trainer, TrainState

__all__ = ["ShardedDataIterator", "TrainState", "Trainer", "synthetic_dataset"]
