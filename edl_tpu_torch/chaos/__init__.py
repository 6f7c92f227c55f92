"""Deterministic chaos injection for the port (counterpart of
``edl_tpu/chaos/``).

One seeded ``FaultSchedule`` drives named injection points through the
layers where real failures happen (coordinator membership, the
coord_service HTTP transport, the checkpoint store and its restore
transfer, kube actuation, the elastic loop, the serving fleet), so
every chaos run is bit-reproducible.  The schedule travels on
``HostDRAMStore.chaos`` (read by the trainer, the batch stager, the
restore transfer and the watchdog) and as ``chaos=`` on the serving
objects; ``EDL_CHAOS_SPEC`` installs one on a launcher pod.
"""

from edl_tpu_torch.chaos.schedule import KNOWN_POINTS, FaultEvent, FaultSchedule
from edl_tpu_torch.chaos.membership import ChaosCoordinator
from edl_tpu_torch.chaos.transport import ChaosHTTPCoordinator
from edl_tpu_torch.chaos.kubeapi import ChaosKube
from edl_tpu_torch.chaos.storage import corrupt_checkpoint, corrupt_newest
from edl_tpu_torch.chaos.monkey import ChaosMonkey

__all__ = [
    "KNOWN_POINTS",
    "FaultEvent",
    "FaultSchedule",
    "ChaosCoordinator",
    "ChaosHTTPCoordinator",
    "ChaosKube",
    "ChaosMonkey",
    "corrupt_checkpoint",
    "corrupt_newest",
]
