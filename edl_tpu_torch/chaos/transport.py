"""HTTP transport chaos: the coord_service wire under fault injection
(counterpart of ``edl_tpu/chaos/transport.py``).

Wraps ``HTTPCoordinator`` at its one raw-I/O seam (``_open``), so every
fault passes through the production retry path
(``utils.retry.RetryPolicy``): nothing is mocked above the socket.

Injection points (step-indexed, one-shot, budget-style: the event arg
is "how many of the next requests fault"):

- ``transport.refuse``: connection refused (coordinator pod gone,
  Service not routing yet).
- ``transport.timeout``: socket timeout (network partition, pause).
- ``transport.slow``: the next request is delayed ``arg`` seconds.
- ``transport.torn``: the response body is cut mid-JSON (torn write,
  proxy reset), retried as transient.

Faults budgeted below the client's ``retries`` are invisible to the
training state (the retry absorbs them), which keeps a seeded soak
bit-reproducible although retry counts vary with the wall clock.
"""

from __future__ import annotations

import errno
import socket
import threading
import time
import urllib.error

from edl_tpu_torch.chaos.schedule import FaultSchedule
from edl_tpu_torch.runtime.coord_service import HTTPCoordinator


class ChaosHTTPCoordinator(HTTPCoordinator):
    """Drop-in ``HTTPCoordinator`` whose wire faults come from a
    ``FaultSchedule``; ``ElasticTrainer`` and the control plane take it
    unchanged.

    Budget changes are locked: the trainer's heartbeat thread and the
    step loop share one client, and a budget of N must inject exactly N
    faults whatever the thread interleaving (the soak checks the
    injected counts)."""

    def __init__(self, address: str, schedule: FaultSchedule, **kwargs):
        super().__init__(address, **kwargs)
        self.schedule = schedule
        self._budget_lock = threading.Lock()
        self._refuse_budget = 0
        self._timeout_budget = 0
        self._torn_budget = 0
        self._slow_for = 0.0
        #: faults actually injected, by kind
        self.injected = {"refuse": 0, "timeout": 0, "slow": 0, "torn": 0}

    def _pull_events(self) -> None:
        """Pull the due transport events (caller holds the lock)."""
        for ev in self.schedule.due("transport.refuse"):
            self._refuse_budget += int(ev.arg or 1)
        for ev in self.schedule.due("transport.timeout"):
            self._timeout_budget += int(ev.arg or 1)
        for ev in self.schedule.due("transport.torn"):
            self._torn_budget += int(ev.arg or 1)
        for ev in self.schedule.due("transport.slow"):
            self._slow_for = max(self._slow_for, float(ev.arg or 0.05))

    def _open(self, req) -> bytes:
        with self._budget_lock:
            self._pull_events()
            refuse = timeout = False
            slow = 0.0
            if self._refuse_budget > 0:
                self._refuse_budget -= 1
                self.injected["refuse"] += 1
                refuse = True
            elif self._timeout_budget > 0:
                self._timeout_budget -= 1
                self.injected["timeout"] += 1
                timeout = True
            elif self._slow_for > 0:
                slow, self._slow_for = self._slow_for, 0.0
                self.injected["slow"] += 1
        if refuse:
            raise urllib.error.URLError(
                OSError(errno.ECONNREFUSED, "chaos: connection refused")
            )
        if timeout:
            raise socket.timeout("chaos: request timed out")
        if slow > 0:
            time.sleep(slow)
        body = super()._open(req)
        with self._budget_lock:
            if self._torn_budget > 0:
                self._torn_budget -= 1
                self.injected["torn"] += 1
                # Cut mid-payload: json.loads fails, the retry policy
                # takes it for transient and asks again.
                return body[: max(1, len(body) // 2)]
        return body


__all__ = ["ChaosHTTPCoordinator"]
