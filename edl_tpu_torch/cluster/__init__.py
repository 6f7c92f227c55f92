"""L1 cluster layer (counterpart of ``edl_tpu.cluster``): inventory, the
Kubernetes boundary, and the GPU replica topologies."""

from edl_tpu_torch.cluster.resources import ClusterResource, Nodes
from edl_tpu_torch.cluster.gpu_topology import (
    topology_gpus,
    legal_topologies,
    ReplicaTopology,
)
from edl_tpu_torch.cluster.kube import (
    KubeAPI,
    FakeKube,
    KubectlAPI,
    NodeInfo,
    PodInfo,
    WorkloadInfo,
    ConflictError,
)
from edl_tpu_torch.cluster.cluster import Cluster

__all__ = [
    "ClusterResource",
    "Nodes",
    "topology_gpus",
    "legal_topologies",
    "ReplicaTopology",
    "KubeAPI",
    "FakeKube",
    "KubectlAPI",
    "NodeInfo",
    "PodInfo",
    "WorkloadInfo",
    "ConflictError",
    "Cluster",
]
