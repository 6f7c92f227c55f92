"""Checkpoint-store chaos helpers (counterpart of
``edl_tpu/chaos/storage.py``).

The in-store injection points (``checkpoint.save_thread``,
``checkpoint.spill``, ``flush.spill.slow``) live inside
``HostDRAMStore`` itself (pass the ``FaultSchedule`` as its ``chaos``).
What lives here is the fault that strikes from outside the save path:
silent corruption of a stored snapshot (a host-memory bit flip).  The
flip does NOT refresh the recorded digest: ``HostCheckpoint.verify`` and
``HostDRAMStore.latest_verified`` must catch the mismatch at restore
time and fall back to the next-oldest snapshot.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from edl_tpu_torch.checkpoint.hostdram import HostCheckpoint, HostDRAMStore


def corrupt_checkpoint(ckpt: "HostCheckpoint") -> None:
    """Flip one byte in the first non-empty leaf, leaving the recorded
    digest stale (silent corruption).  The leaf is replaced by a
    corrupted copy, so a pinned buffer the leaf may view is never
    written."""
    for i, leaf in enumerate(ckpt.leaves):
        if leaf.nbytes == 0:
            continue
        bad = np.array(leaf, copy=True)
        bad.reshape(-1).view(np.uint8)[0] ^= 0xFF
        ckpt.leaves[i] = bad
        return
    raise ValueError("checkpoint has no bytes to corrupt")


def corrupt_newest(store: "HostDRAMStore") -> Optional[int]:
    """Corrupt the newest stored checkpoint in ``store``; returns its
    step (None when the store is empty).  Callers that need the newest
    interval save to be the victim ``store.wait()`` first."""
    ckpt = store.latest()
    if ckpt is None:
        return None
    # Record the digest BEFORE the flip (the save worker normally did
    # already), so verify() has a clean fingerprint to disagree with.
    ckpt.digest()
    corrupt_checkpoint(ckpt)
    return ckpt.step


__all__ = ["corrupt_checkpoint", "corrupt_newest"]
