"""L3 autoscaler: the decision plane (counterpart of ``edl_tpu.autoscaler``).

Pure algorithm in ``algorithm`` (ref ``pkg/autoscaler.go:201-337``),
event-driven control loop in ``scaler`` (ref ``:451-485``).  The JAX
package's serving lane (``autoscaler/serving.py``) comes with the fleet
market (ROADMAP A-4).
"""

from edl_tpu_torch.autoscaler.algorithm import (
    JobView,
    PendingDemand,
    fulfillment,
    sorted_jobs,
    search_assignable_node,
    scale_dry_run,
    scale_all_jobs_dry_run,
)
from edl_tpu_torch.autoscaler.scaler import Autoscaler, ScalePlan

__all__ = [
    "JobView",
    "PendingDemand",
    "fulfillment",
    "sorted_jobs",
    "search_assignable_node",
    "scale_dry_run",
    "scale_all_jobs_dry_run",
    "Autoscaler",
    "ScalePlan",
]
