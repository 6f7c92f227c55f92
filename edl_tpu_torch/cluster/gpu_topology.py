"""GPU replica topology model (counterpart of ``edl_tpu/cluster/tpu_topology.py``).

The reference EDL counted NVIDIA GPUs as per-node scalar quantities
(``pkg/cluster.go:224-234`` sums ``alpha.kubernetes.io/nvidia-gpu``).
The JAX package replaced them with TPU slices; the port goes back to
GPUs but keeps the slice vocabulary: a trainer replica owns a fixed
number of H100s, and a data-parallel world grows and shrinks in whole
replicas.  This module is the vocabulary the inventory and the
autoscaler's replica-quantized deltas share.

A host holds 8 GPUs (an 8-GPU H100 node, as a v5e host holds 8
chips), so ``h100-16`` and above span several nodes of one nodepool.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

#: GPUs on one host of an H100 nodepool
GPUS_PER_HOST = 8


@dataclass(frozen=True)
class ReplicaTopology:
    name: str
    gpus: int
    hosts: int  # host machines per replica (8 GPUs a host)


def _mk(gpus: int) -> ReplicaTopology:
    return ReplicaTopology(name=f"h100-{gpus}", gpus=gpus, hosts=max(1, gpus // GPUS_PER_HOST))


#: Legal replica topologies (by name as it appears in TrainerSpec).
_TOPOLOGIES: Dict[str, ReplicaTopology] = {
    t.name: t
    for t in [
        *(_mk(n) for n in (1, 4, 8, 16, 32, 64)),
        # CPU-host "topology" for tests / jobs without GPUs.
        ReplicaTopology(name="cpu", gpus=0, hosts=1),
    ]
}


def get_topology(name: str) -> ReplicaTopology:
    try:
        return _TOPOLOGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown GPU replica topology {name!r}; legal: {sorted(_TOPOLOGIES)}"
        ) from None


def topology_gpus(name: str) -> int:
    return get_topology(name).gpus


def legal_topologies() -> List[str]:
    return sorted(_TOPOLOGIES, key=lambda n: _TOPOLOGIES[n].gpus)


def normalize_topology(name) -> "ReplicaTopology | None":
    """Resolve a topology name ("h100-8") or a node's allocatable GPU
    count ("8", or the int 8) to a ReplicaTopology; None if
    unrecognized.  A node pool's shape is the GPU count of its nodes,
    as the JAX package reads it from the ``gke-tpu-topology`` label."""
    name = str(name)
    if name in _TOPOLOGIES:
        return _TOPOLOGIES[name]
    if name.isdigit():
        for t in _TOPOLOGIES.values():
            if t.gpus and t.gpus == int(name):
                return t
    return None


def largest_topology_fitting(gpus: int) -> ReplicaTopology:
    """Largest legal replica with at most ``gpus`` GPUs."""
    best = _TOPOLOGIES["cpu"]
    for t in _TOPOLOGIES.values():
        if 0 < t.gpus <= gpus and t.gpus > best.gpus:
            best = t
    return best
