"""L3 autoscaler: the decision plane (counterpart of ``edl_tpu.autoscaler``).

Pure algorithm in ``algorithm`` (ref ``pkg/autoscaler.go:201-337``),
event-driven control loop in ``scaler`` (ref ``:451-485``), and the
serving lane in ``serving``.
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
from edl_tpu_torch.autoscaler.serving import (
    ServingLane,
    attach_serving_lane,
    kube_replica_glue,
    post_drain,
)

__all__ = [
    "ServingLane",
    "attach_serving_lane",
    "kube_replica_glue",
    "post_drain",
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
