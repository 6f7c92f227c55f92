"""Inference serving of the port: engines, batchers, the KV prefix
cache, the HTTP front and the replica driver, live KV migration, the
retrying client and the request router."""

from edl_tpu_torch.serving.batcher import (
    ContinuousBatcher,
    DeadlineExceededError,
    DrainingError,
    FreezeTimeoutError,
    QueueFullError,
    TokenContinuousBatcher,
)
from edl_tpu_torch.serving.client import RetryBudgetExhausted, RetryingClient
from edl_tpu_torch.serving.engine import (
    BlockOwnershipError,
    DecodeEngine,
    DispatchWedgedError,
    InferenceEngine,
    KVBlockPool,
    NotReadyError,
    PromptTooLongError,
)
from edl_tpu_torch.serving.migrate import (
    MigrationError,
    MigrationReceiver,
    MigrationRefusedError,
    TornMigrationError,
    migrate_out,
)
from edl_tpu_torch.serving.prefix import PrefixCache, chain_hashes
from edl_tpu_torch.serving.router import RequestRouter, RouterServer, route_run
from edl_tpu_torch.serving.server import ServingReplica, ServingServer, serve_run

__all__ = [
    "BlockOwnershipError",
    "ContinuousBatcher",
    "DeadlineExceededError",
    "DecodeEngine",
    "DispatchWedgedError",
    "DrainingError",
    "FreezeTimeoutError",
    "InferenceEngine",
    "KVBlockPool",
    "MigrationError",
    "MigrationReceiver",
    "MigrationRefusedError",
    "NotReadyError",
    "PrefixCache",
    "PromptTooLongError",
    "QueueFullError",
    "RequestRouter",
    "RetryBudgetExhausted",
    "RetryingClient",
    "RouterServer",
    "ServingReplica",
    "ServingServer",
    "TokenContinuousBatcher",
    "TornMigrationError",
    "chain_hashes",
    "migrate_out",
    "route_run",
    "serve_run",
]
