"""edl_tpu_torch.fleet — the multi-job cluster arbiter (counterpart of
``edl_tpu.fleet``).

N elastic trainers + M serving fleets bidding for ONE GPU inventory:
the reference autoscaler's cluster-wide dry-run fixed point
(``pkg/autoscaler.go:296-337``) generalized with per-job priorities,
serving SLOs as hard constraints, observed goodput-per-chip as the
objective, and consensus-clean preemption of the lowest-priority
trainer to absorb serving spikes (chips return when the spike clears).

- ``inventory.ChipInventory`` — the market's GPU ledger (a chip is a GPU)
- ``bidders.TrainingBidder`` / ``bidders.ServingBidder`` — per-job
  observation + actuation adapters (``Bid`` is the tick's message)
- ``arbiter.arbitrate`` — the pure fixed point;
  ``arbiter.FleetArbiter`` — the per-tick loop;
  ``arbiter.attach_fleet`` — ride the training autoscaler's 5s tick
"""

from edl_tpu_torch.fleet.arbiter import (  # noqa: F401
    Arbitration,
    FleetArbiter,
    arbitrate,
    attach_fleet,
)
from edl_tpu_torch.fleet.bidders import (  # noqa: F401
    Bid,
    ServingBidder,
    TrainingBidder,
)
from edl_tpu_torch.fleet.inventory import ChipInventory  # noqa: F401
