"""One retry policy for every control- and data-plane loop (a copy of
``edl_tpu/utils/retry.py``).

- **Capped exponential backoff** with a **deterministic jitter**:
  the jitter for attempt ``k`` is a pure function of ``(seed, k)``
  (crc32-derived), so a seeded run replays the identical delay
  sequence.
- **Deadline**: a total wall-clock budget across all attempts, so a
  caller inside a bounded control tick can bound its worst case.
- **Give-up classification**: ``retryable`` decides which exceptions
  are transient; non-retryable ones surface immediately.  Exhaustion
  raises the typed ``GiveUpError`` so callers can tell "the operation
  failed" from "the operation kept failing transiently".

Every absorbed failure is counted and journaled in the flight recorder
(``retry``; exhaustion journals ``retry.giveup``), so the reports carry
them to the coordinator's merged ``/telemetry``.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass
from typing import Callable, Optional


class GiveUpError(RuntimeError):
    """A retried operation exhausted its attempts or deadline.

    ``last_error`` is the final transient failure (also chained as
    ``__cause__``); ``attempts`` is how many tries ran."""

    def __init__(self, msg: str, last_error: Optional[BaseException] = None,
                 attempts: int = 0):
        super().__init__(msg)
        self.last_error = last_error
        self.attempts = attempts


def _unit_hash(seed: int, attempt: int) -> float:
    """Deterministic uniform-ish value in [0, 1) from (seed, attempt)."""
    return zlib.crc32(f"{seed}:{attempt}".encode()) / 2**32


@dataclass(frozen=True)
class RetryPolicy:
    """Deadline + capped exponential backoff + deterministic jitter.

    ``max_attempts``: total tries (>= 1).
    ``base_delay``: sleep after the first failure, seconds.
    ``max_delay``: backoff cap.
    ``multiplier``: exponential growth per attempt.
    ``deadline``: optional total wall-clock budget (seconds) across all
    attempts; a sleep that would overshoot it gives up instead.
    ``jitter``: fraction of each delay randomized deterministically —
    delay ``d`` becomes ``d * (1 - jitter + 2*jitter*h)`` for a hash
    ``h`` in [0,1) derived from ``(seed, attempt)``.
    """

    max_attempts: int = 3
    base_delay: float = 0.2
    max_delay: float = 5.0
    multiplier: float = 2.0
    deadline: Optional[float] = None
    jitter: float = 0.25

    def delay(self, attempt: int, seed: int = 0) -> float:
        """Backoff to sleep after failed attempt ``attempt`` (0-based)."""
        raw = min(self.base_delay * self.multiplier**attempt, self.max_delay)
        if not self.jitter:
            return raw
        h = _unit_hash(seed, attempt)
        return raw * (1.0 - self.jitter + 2.0 * self.jitter * h)

    def run(
        self,
        fn: Callable,
        retryable: Callable[[BaseException], bool] = lambda e: True,
        seed: int = 0,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
        describe: str = "",
    ):
        """Call ``fn()`` under this policy; return its result.

        Exceptions ``retryable`` rejects re-raise immediately (the
        server answered with a real error — not transient).  When the
        attempts or the deadline run out, raises ``GiveUpError``
        chaining the last transient failure.  ``sleep``/``clock`` are
        injectable so tests and chaos runs never wait on real time."""
        start = clock()
        attempts = max(1, self.max_attempts)
        last: Optional[BaseException] = None
        tried = 0
        what = describe or getattr(fn, "__name__", "operation")
        for attempt in range(attempts):
            tried = attempt + 1
            try:
                return fn()
            # Exception, not BaseException: KeyboardInterrupt/SystemExit
            # must never be classified transient and retried.
            except Exception as e:
                if not retryable(e):
                    raise
                last = e
                # Telemetry: every absorbed transient failure is
                # counted and journaled — "the run retried 40 times
                # before the give-up" is exactly the post-mortem signal
                # that used to vanish (flight-recorder step/generation
                # come from the recorder's ambient context).
                _note_retry(what, attempt, e)
                if attempt + 1 >= attempts:
                    break
                d = self.delay(attempt, seed)
                if (
                    self.deadline is not None
                    and clock() - start + d > self.deadline
                ):
                    break
                sleep(d)
        _note_giveup(what, tried)
        raise GiveUpError(
            f"{what} gave up after {tried} attempt(s): {last}",
            last_error=last,
            attempts=tried,
        ) from last


def _note_retry(op: str, attempt: int, err: BaseException) -> None:
    from edl_tpu_torch import telemetry

    telemetry.get_registry().counter("edl_retry_attempts_total").inc(op=op)
    telemetry.get_recorder().record(
        "retry",
        {"op": op, "attempt": attempt, "error": type(err).__name__},
    )


def _note_giveup(op: str, attempts: int) -> None:
    from edl_tpu_torch import telemetry

    telemetry.get_registry().counter("edl_retry_giveups_total").inc(op=op)
    telemetry.get_recorder().record(
        "retry.giveup", {"op": op, "attempts": attempts}
    )
