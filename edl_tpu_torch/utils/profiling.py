"""Opt-in ``torch.profiler`` windows around the training hot loop (the
counterpart of ``edl_tpu/utils/profiling.py``).

- Set ``EDL_PROFILE_DIR=/some/dir`` (or pass ``profile_dir``) and the
  elastic runtime records a bounded window of ``EDL_PROFILE_STEPS``
  (default 10) steps with ``torch.profiler``: host activity always,
  device activity when the trainer's device is CUDA.  Each closed
  window writes one Chrome-trace file under the directory
  (``files``).  Each step is a ``record_function`` range named
  ``train#<step>``, and each resize phase one named ``resize/<phase>``,
  so the trace separates flush, world formation and restore from
  stepping.  The kernels are loaded through ``ctypes``, so the device
  lanes name them by their ``__global__`` symbols (``flash_fwd_kernel``,
  ``flash_bwd_dkdv_kernel``, ``xent_fwd_kernel``, ...).
- The window opens at the first step by default; ``EDL_PROFILE_AT_STEP=N``
  defers it until the global step counter reaches N, and
  ``EDL_PROFILE_EACH_RESIZE=1`` re-arms after every resize so a bounded
  window opens around each new generation's first steps.  ``rearm()``
  does the same programmatically.
- Each window's open and close journal a ``profile.window`` flight
  event, so the merged cluster timeline (``edl trace``) shows which
  steps the device trace covers.

Nothing here activates unless the variable or the argument is set: the
default path costs one attribute check per call.
"""

from __future__ import annotations

import os
from contextlib import nullcontext
from typing import List, Optional


#: throwaway kernels a device window runs before its first step
#: (``StepProfiler._warm_capture``)
WARM_KERNELS = 64


class StepProfiler:
    """Records bounded ``torch.profiler`` windows of the training loop."""

    def __init__(
        self,
        profile_dir: Optional[str] = None,
        max_steps: Optional[int] = None,
        at_step: Optional[int] = None,
        rearm_on_resize: Optional[bool] = None,
        device=None,
    ):
        self.profile_dir = profile_dir or os.environ.get("EDL_PROFILE_DIR", "")
        self.max_steps = (
            max_steps
            if max_steps is not None
            else int(os.environ.get("EDL_PROFILE_STEPS", "10"))
        )
        #: open the window only once the step counter reaches this
        #: (-1 = immediately); consumed by the NEXT window to open
        self.at_step = (
            at_step
            if at_step is not None
            else int(os.environ.get("EDL_PROFILE_AT_STEP", "-1"))
        )
        self.rearm_on_resize = (
            rearm_on_resize
            if rearm_on_resize is not None
            else os.environ.get("EDL_PROFILE_EACH_RESIZE", "0") == "1"
        )
        #: record device activity too (the trainer's device is CUDA)
        self.cuda = str(device).startswith("cuda")
        self._prof = None
        self._live = False
        self._steps_seen = 0
        #: windows opened so far (a closed window disarms the profiler
        #: until rearm())
        self._windows = 0
        self._armed = True
        #: the Chrome-trace file of each closed window, in order
        self.files: List[str] = []

    @property
    def enabled(self) -> bool:
        return bool(self.profile_dir)

    @property
    def tracing(self) -> bool:
        """Whether a window is live right now (``enabled`` stays true
        for the whole process; a window closes after ``max_steps``)."""
        return self._live

    @property
    def closing(self) -> bool:
        """A live window has seen its last step: the next
        ``maybe_stop`` closes it."""
        return self._live and self._steps_seen >= self.max_steps

    def rearm(self, at_step: Optional[int] = None) -> None:
        """Allow a new bounded window to open.  ``at_step``: defer it
        until that global step (None = open at the next step)."""
        self._armed = True
        self._steps_seen = 0
        self.at_step = -1 if at_step is None else int(at_step)

    def note_resize(self) -> None:
        """A resize completed: under ``EDL_PROFILE_EACH_RESIZE`` a
        profiler whose window has closed re-arms, so the new
        generation's first steps get their own window.  A window still
        waiting for ``at_step`` keeps waiting (the JAX profiler re-arms
        it to open at once, so the start-up resize discards
        ``EDL_PROFILE_AT_STEP``)."""
        if self.enabled and self.rearm_on_resize and not self._live and not self._armed:
            self.rearm()

    def due(self, step: Optional[int] = None) -> bool:
        """Whether ``maybe_start(step)`` opens a window: armed, none
        live, and (with ``at_step`` set) the step counter there."""
        if not self.enabled or self._live or not self._armed or self._steps_seen > 0:
            return False
        return self.at_step < 0 or (step is not None and step >= self.at_step)

    def maybe_start(self, step: Optional[int] = None) -> None:
        """Open the window when armed (and, with ``at_step`` set, once
        the step counter reaches it)."""
        if not self.due(step):
            return
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(self.profile_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()
        self._warm_capture()
        self._live = True
        self._windows += 1
        self._journal("open", step)

    def step(self, step_num: int):
        """Context for one train step (a ``train#<step>`` range)."""
        if not self._live:
            return nullcontext()
        import torch

        self._steps_seen += 1
        return torch.profiler.record_function(f"train#{step_num}")

    def maybe_stop(self) -> None:
        if self.closing:
            self.stop()

    def stop(self) -> None:
        """Close a live window and write its Chrome trace."""
        if not self._live:
            return
        prof, self._prof = self._prof, None
        try:
            prof.stop()
            path = os.path.join(
                self.profile_dir, f"window-{os.getpid()}-{self._windows}.json"
            )
            prof.export_chrome_trace(path)
            self.files.append(path)
        finally:
            self._live = False
            self._armed = False  # one window per arm; rearm() re-opens
            self._journal("close", None)

    def _warm_capture(self) -> None:
        """Run ``WARM_KERNELS`` throwaway kernels through a fresh device
        capture and wait for them.  In a process that had run minutes of
        other CUDA work, the capture lost the records of its first ~20
        kernels on an H100 (a window's first step then showed 11 of its
        12 ``flash_fwd``); neither a 100 ms wait nor one kernel before
        the step kept them.  These kernels take the loss instead."""
        if self.cuda:
            import torch

            x = torch.zeros(1, device=torch.cuda.current_device())
            for _ in range(WARM_KERNELS):
                x.add_(1)
            torch.cuda.synchronize()

    def _journal(self, phase: str, step: Optional[int]) -> None:
        """The flight event that aligns this window with the merged
        cluster timeline."""
        from edl_tpu_torch import telemetry

        data = {"phase": phase, "window": self._windows, "dir": self.profile_dir}
        telemetry.get_recorder().record("profile.window", data, step=step)


def annotate(name: str):
    """A named range in a live ``torch.profiler`` trace (resize phases,
    checkpoint flush, ...)."""
    import torch

    return torch.profiler.record_function(name)


__all__ = ["StepProfiler", "annotate"]
