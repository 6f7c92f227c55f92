"""One GPU inventory, N holders — the market's ledger (a copy of
``edl_tpu/fleet/inventory.py``).

The reference's dry run simulated a whole ``ClusterResource`` because
GPU pods also fought over CPU/memory.  The fleet market deliberately
reduces to the one axis every bidder actually contends on — GPUs —
because serving replicas and trainer replicas on a GPU cluster are
GPU-bounded (their CPU/memory requests ride along with the replica) and
the per-axis machinery already lives in ``autoscaler/algorithm.py`` for
the intra-job fixed point.  The ledger keeps the JAX package's names
(``ChipInventory``, ``total_chips``, ``free_chips``, ``chips_per_unit``):
on this cluster a chip is a GPU, and the shared names let the two
packages' outputs be compared field for field.  Keeping the arbiter's ledger scalar keeps
the cross-job fixed point provably convergent (see
``arbiter.arbitrate``).

``ChipInventory`` is a plain mutable value type like
``ClusterResource``: the arbiter mutates a copy per dry run and tests
fabricate inventories as literals.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from edl_tpu_torch.cluster.resources import ClusterResource


@dataclass
class ChipInventory:
    """Chip totals plus per-holder allocations (name -> chips).

    ``holdings`` tracks what the market has ALLOCATED, which on a live
    cluster equals scheduled pods' chip limits; chips outside any
    holding (e.g. non-fleet workloads) are modeled by seeding a
    holding the arbiter never owns."""

    total_chips: int = 0
    holdings: Dict[str, int] = field(default_factory=dict)

    def allocated(self) -> int:
        return sum(self.holdings.values())

    def free(self) -> int:
        return self.total_chips - self.allocated()

    def set_holding(self, name: str, chips: int) -> None:
        if chips < 0:
            raise ValueError(f"holding must be >= 0: {name}={chips}")
        if chips == 0:
            self.holdings.pop(name, None)
        else:
            self.holdings[name] = chips

    def snapshot(self) -> dict:
        """JSON-safe view (the ``fleet`` command's table + chips-over-
        time series read this shape)."""
        return {
            "total_chips": self.total_chips,
            "free_chips": self.free(),
            "holdings": dict(sorted(self.holdings.items())),
        }

    @staticmethod
    def from_cluster_resource(r: ClusterResource) -> "ChipInventory":
        """Seed the ledger from a live inventory inquiry: everything
        already scheduled outside the fleet's bidders is parked under
        one opaque holding so the market can never hand it out."""
        inv = ChipInventory(total_chips=r.gpu_total)
        used = r.gpu_total - r.free_gpus()
        if used > 0:
            inv.set_holding("(scheduled)", used)
        return inv
