"""The step bus: a per-step int64 control word riding the training
world's process group (counterpart of ``edl_tpu/consensus/bus.py``).

Each step, every member contributes one word and the world reduces the
words with one ``all_reduce`` (MAX) on the SAME process group as the
gradient ``all_reduce``, issued right after the step.  The bus inherits
the data plane's synchronization for free: a member cannot fall a step
behind the bus without falling behind the gradients too.  On a CUDA
(NCCL) world the word is a device tensor and the reduction a device
future; the elastic loop reads it with the step metrics' lag.

Lanes (the JAX word gathers a matrix of per-device rows; a MAX
reduction gives the same agreement when each member writes its own
timing slot):

- ``LANE_GENERATION``: highest coordinator plan generation this member
  has SEEN (polled, or learned from a peer via this very lane).
- ``LANE_STOP``: stop vote / agreement echo.  A member that observed a
  retarget proposes ``dispatch_step + agreement_horizon``; the FIRST
  harvested word with a nonzero stop lane defines the agreement.
- ``LANE_HEALTH``: poison bit — a member that knows it is failing marks
  the word so peers bury the world instead of discovering a hang.
- ``LANE_TIMING + rank``: log2 bucket of member ``rank``'s last step
  seconds (zero in every other member's word) — the per-member
  straggler signal.

Votes, stops and straggler transitions are journaled in the flight
recorder (``consensus.vote``, ``consensus.stop``,
``consensus.straggler``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

LANE_GENERATION = 0
LANE_STOP = 1
LANE_HEALTH = 2
#: first of the per-rank timing slots
LANE_TIMING = 3

#: timing-lane quantization: bucket 0 is <= BUCKET0_SECONDS, each
#: bucket doubles; MAX_BUCKET caps pathological stalls
BUCKET0_SECONDS = 0.001
MAX_BUCKET = 31

#: buckets of spread between the slowest and fastest member before the
#: slowest is counted as a straggler (4 buckets = ~16x the fastest)
STRAGGLER_SPREAD_BUCKETS = 4


def timing_bucket(seconds: float) -> int:
    """Quantize a step duration into the word's log2 timing lane."""
    if seconds <= BUCKET0_SECONDS:
        return 0
    return min(MAX_BUCKET, int(math.log2(seconds / BUCKET0_SECONDS)) + 1)


class BusPoisonError(RuntimeError):
    """A peer marked the word's health lane: some member of this world
    knows it is failing.  Raised at harvest so the broken-world
    recovery buries the world before the failure surfaces as a hang."""


@dataclass
class BusWord:
    """One decoded (harvested) control word."""

    step: int
    max_generation: int
    #: 0 = no stop voted/agreed in this word
    stop_step: int
    poisoned: bool
    #: rank -> timing bucket
    member_buckets: Dict[int, int]
    #: bucket spread between slowest and fastest member
    skew: int
    #: rank of the slowest member when it qualifies as a straggler
    straggler: Optional[int] = None


class StepBus:
    """Dispatch/decode the control word over a process group."""

    def __init__(self, registry=None, recorder=None):
        from edl_tpu_torch import telemetry

        self.registry = registry if registry is not None else telemetry.get_registry()
        self.recorder = recorder if recorder is not None else telemetry.get_recorder()
        self._m_words = self.registry.counter("edl_consensus_words_total")
        self._m_votes = self.registry.counter("edl_consensus_votes_total")
        self._g_stop = self.registry.gauge("edl_consensus_stop_step")
        self._g_skew = self.registry.gauge("edl_consensus_step_skew_buckets")
        self._m_stragglers = self.registry.counter("edl_consensus_stragglers_total")
        self._last_straggler: Optional[int] = None

    def dispatch(
        self,
        group,
        world: int,
        rank: int,
        generation: int,
        stop: int,
        poison: bool,
        bucket: int,
        device: torch.device,
    ) -> torch.Tensor:
        """Reduce this member's word over ``group``; returns the reduced
        word (on ``device``; a device future on CUDA — no host sync)."""
        row = [0] * (LANE_TIMING + world)
        row[LANE_GENERATION] = generation
        row[LANE_STOP] = stop
        row[LANE_HEALTH] = 1 if poison else 0
        row[LANE_TIMING + rank] = bucket
        word = torch.tensor(row, dtype=torch.int64)
        if device.type == "cuda":
            word = word.pin_memory().to(device, non_blocking=True)
        dist.all_reduce(word, op=dist.ReduceOp.MAX, group=group)
        return word

    def decode(self, step: int, values: List[int]) -> BusWord:
        """Decode a harvested word (host ints) and publish its
        telemetry.  Every member decodes the identical reduced word, so
        agreement needs no further communication."""
        buckets = {r: int(b) for r, b in enumerate(values[LANE_TIMING:])}
        skew = (max(buckets.values()) - min(buckets.values())) if buckets else 0
        straggler = None
        if len(buckets) > 1 and skew >= STRAGGLER_SPREAD_BUCKETS:
            straggler = max(buckets, key=buckets.get)
        word = BusWord(
            step=step,
            max_generation=int(values[LANE_GENERATION]),
            stop_step=int(values[LANE_STOP]),
            poisoned=bool(values[LANE_HEALTH] > 0),
            member_buckets=buckets,
            skew=skew,
            straggler=straggler,
        )
        self._m_words.inc()
        self._g_skew.set(skew)
        if straggler is not None:
            self._m_stragglers.inc(rank=str(straggler))
            if straggler != self._last_straggler:
                # Transitions only: a persistent straggler must not
                # flood the ring once per step.
                self.recorder.record(
                    "consensus.straggler",
                    {
                        "rank": straggler,
                        "skew_buckets": skew,
                        "buckets": {str(r): v for r, v in sorted(buckets.items())},
                    },
                    step=step,
                )
        self._last_straggler = straggler
        return word

    def note_vote(self, step: int, generation: int, proposed_stop: int) -> None:
        self._m_votes.inc()
        self.recorder.record(
            "consensus.vote",
            {"proposed_stop": proposed_stop, "for_generation": generation},
            step=step,
        )

    def note_stop(self, vote_step: int, stop_step: int, generation: int) -> None:
        self._g_stop.set(stop_step)
        self.recorder.record(
            "consensus.stop",
            {"vote_step": vote_step, "stop_step": stop_step, "for_generation": generation},
            step=vote_step,
        )
