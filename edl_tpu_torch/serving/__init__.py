"""Inference serving of the port: engines, batchers, the KV prefix
cache, the HTTP front and the replica driver."""

from edl_tpu_torch.serving.batcher import (
    ContinuousBatcher,
    DeadlineExceededError,
    DrainingError,
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
from edl_tpu_torch.serving.prefix import PrefixCache, chain_hashes
from edl_tpu_torch.serving.server import ServingReplica, ServingServer, serve_run

__all__ = [
    "BlockOwnershipError",
    "ContinuousBatcher",
    "DeadlineExceededError",
    "DecodeEngine",
    "DrainingError",
    "InferenceEngine",
    "KVBlockPool",
    "NotReadyError",
    "PrefixCache",
    "PromptTooLongError",
    "QueueFullError",
    "ServingReplica",
    "ServingServer",
    "TokenContinuousBatcher",
    "chain_hashes",
    "serve_run",
]
