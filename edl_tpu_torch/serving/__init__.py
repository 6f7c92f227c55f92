"""Inference serving of the port: engines, batchers and the HTTP front."""

from edl_tpu_torch.serving.batcher import (
    ContinuousBatcher,
    DeadlineExceededError,
    QueueFullError,
    TokenContinuousBatcher,
)
from edl_tpu_torch.serving.engine import (
    BlockOwnershipError,
    DecodeEngine,
    InferenceEngine,
    KVBlockPool,
    NotReadyError,
    PromptTooLongError,
)
from edl_tpu_torch.serving.server import ServingServer

__all__ = [
    "BlockOwnershipError",
    "ContinuousBatcher",
    "DeadlineExceededError",
    "DecodeEngine",
    "InferenceEngine",
    "KVBlockPool",
    "NotReadyError",
    "PromptTooLongError",
    "QueueFullError",
    "ServingServer",
    "TokenContinuousBatcher",
]
