"""Data-plane step agreement (counterpart of ``edl_tpu/consensus``):
the protocol behind deadlock-free scale-down.

- ``StepBus``: a small control word reduced over the SAME process group
  as the model step — every member learns at the same step boundary
  that a resize is wanted, and all agree on ``stop_step = vote_step +
  agreement_horizon`` (horizon = ``pipeline_depth + 1``), so the async
  pipeline keeps its lagged harvest and run-ahead dispatch is clamped
  at the agreed stop step.
- ``CollectiveWatchdog``: a deadline on in-flight step/control futures
  so a wedged gloo allreduce is detected and buried via the shared
  broken-world recovery path instead of hanging the world.
"""

from edl_tpu_torch.consensus.bus import BusPoisonError, BusWord, StepBus, timing_bucket
from edl_tpu_torch.consensus.watchdog import CollectiveTimeout, CollectiveWatchdog

__all__ = [
    "BusPoisonError",
    "BusWord",
    "StepBus",
    "timing_bucket",
    "CollectiveTimeout",
    "CollectiveWatchdog",
]
