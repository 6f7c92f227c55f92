"""Cluster resource value types (counterpart of ``edl_tpu/cluster/resources.py``).

Mirrors the reference's ``ClusterResource``/``Nodes`` structs
(``pkg/cluster.go:32-61``); the device axis counts GPUs, as the
reference did, where the JAX package counts TPU chips.
These are plain mutable value types on purpose: the autoscaler's dry-run
simulates scaling decisions by mutating a *copy* of the inventory
(ref ``pkg/autoscaler.go:201-291``), and tests fabricate cluster state
as literals exactly like the reference's test suite does
(``pkg/autoscaler_internal_test.go:104-123``).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict


@dataclass
class Nodes:
    """Per-node idle resources (ref Nodes, pkg/cluster.go:58-61).

    ``gpu_free`` is new: free GPUs per node, so replica assignability
    can be checked per pool (a replica must come from one pool's
    capacity; pools are modelled at GPU granularity)."""

    cpu_idle_milli: Dict[str, int] = field(default_factory=dict)
    memory_free_mega: Dict[str, int] = field(default_factory=dict)
    gpu_free: Dict[str, int] = field(default_factory=dict)
    #: Replica topology each pool schedules (e.g. "h100-8", from the
    #: node's GPU count) — empty/absent = untyped GPU pool (tests, CPU).
    #: A replica must match the pool's topology; a multi-host replica
    #: takes whole nodes of one pool (``autoscaler.algorithm``).
    pool_topology: Dict[str, str] = field(default_factory=dict)
    #: Nodepool identity per node (GKE ``cloud.google.com/gke-nodepool``).
    #: A hosts>1 replica must take all its nodes from ONE pool — hosts
    #: of two different pools share no fabric the replica can rely on.
    node_pool: Dict[str, str] = field(default_factory=dict)


@dataclass
class ClusterResource:
    """Cluster-wide totals/requests/limits (ref ClusterResource,
    pkg/cluster.go:32-54), the device axis in GPUs."""

    node_count: int = 0

    gpu_total: int = 0
    gpu_request: int = 0
    gpu_limit: int = 0

    cpu_total_milli: int = 0
    cpu_request_milli: int = 0
    cpu_limit_milli: int = 0

    memory_total_mega: int = 0
    memory_request_mega: int = 0
    memory_limit_mega: int = 0

    nodes: Nodes = field(default_factory=Nodes)

    def deepcopy(self) -> "ClusterResource":
        return copy.deepcopy(self)

    # -- derived load fractions (used by the dry run's maxLoadDesired
    #    checks, ref pkg/autoscaler.go:259-278) -----------------------------
    def cpu_load(self) -> float:
        if self.cpu_total_milli <= 0:
            return 1.0
        return self.cpu_request_milli / self.cpu_total_milli

    def memory_load(self) -> float:
        if self.memory_total_mega <= 0:
            return 1.0
        return self.memory_request_mega / self.memory_total_mega

    def gpu_load(self) -> float:
        if self.gpu_total <= 0:
            return 1.0
        return self.gpu_limit / self.gpu_total

    def free_gpus(self) -> int:
        """Unclaimed GPUs (total minus the scheduled pods' limits) — the
        single number the fleet arbiter's GPU market opens each tick
        with (``edl_tpu_torch.fleet.inventory``; the JAX package's
        ``free_chips``)."""
        return max(0, self.gpu_total - self.gpu_limit)
