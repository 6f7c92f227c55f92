"""Host-DRAM checkpoints and the restore transfer (counterpart of
``edl_tpu/checkpoint``; its peer-to-peer fabric is not ported yet)."""

from edl_tpu_torch.checkpoint.hostdram import HostCheckpoint, HostDRAMStore

__all__ = ["HostCheckpoint", "HostDRAMStore"]
