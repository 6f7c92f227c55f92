"""The shared retry-against-the-fleet client (counterpart of
``edl_tpu/serving/client.py``).

Every caller of the serving plane needs the same loop: submit against a
replica, and when it answers 503 / DrainingError (it is leaving) go to
another replica, when it answers 429 / QueueFullError (it is full) back
off and retry here, when the connection is refused (it is dead) move
on.  ``RetryingClient`` is that contract once:

- **429 / QueueFullError → back off HERE.**  The replica is the right
  place, it is momentarily full; honor its Retry-After hint and retry
  the same target (a bounded number of times before conceding the
  pass).
- **503 / DrainingError → go ELSEWHERE.**  The replica is leaving;
  retrying it only burns budget.  The draining mark is surfaced via
  ``on_attempt`` so a router can steer future admissions off it.
- **connection refused / reset → dead, go elsewhere.**
- **anything else 5xx-shaped → transient, go elsewhere.**

The loop is bounded by a per-request wall-clock budget and an attempt
cap; spending both raises the typed ``RetryBudgetExhausted``, which
remembers whether the LAST full pass over the fleet saw nothing but
queue-full rejections — that is the "whole fleet is saturated" signal
the router maps to 503 + Retry-After (any other exhaustion means the
fleet is gone, not busy, and advertising a Retry-After would lie).

Backoff between passes is capped exponential and deliberately
unjittered: same-seed runs that go through this client stay
reproducible.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Any, Callable, List, Optional, Sequence, Union

from edl_tpu_torch.serving.batcher import DrainingError, QueueFullError

__all__ = [
    "HTTPTarget",
    "RetryBudgetExhausted",
    "RetryingClient",
    "UpstreamClientError",
    "http_call",
]


class RetryBudgetExhausted(RuntimeError):
    """The per-request retry budget (wall clock and/or attempts) is
    spent without any replica serving the request.  ``saturated`` is
    True when the final pass over every candidate ended in queue-full
    rejections only — the whole fleet is busy, not broken — and
    ``retry_after`` then carries the largest backend hint seen, for
    the router's own Retry-After header."""

    def __init__(
        self,
        msg: str,
        retry_after: float = 1.0,
        saturated: bool = False,
        attempts: int = 0,
    ):
        super().__init__(msg)
        self.retry_after = float(retry_after)
        self.saturated = bool(saturated)
        self.attempts = int(attempts)


class UpstreamClientError(RuntimeError):
    """The backend rejected the REQUEST (4xx), not the attempt: bad
    JSON, prompt too long, unknown path.  Never retried — every
    replica would say the same thing — and passed through with its
    original status."""

    def __init__(self, status: int, body: dict):
        super().__init__(body.get("error") or f"upstream {status}")
        self.status = int(status)
        self.body = body


def _retry_after_of(headers, body: dict, default: float) -> float:
    try:
        h = headers.get("Retry-After") if headers is not None else None
        if h is not None:
            return float(h)
    except (TypeError, ValueError):
        pass
    try:
        return float(body.get("retry_after_s", default))
    except (TypeError, ValueError):
        return default


def http_call(
    address: str,
    path: str,
    payload: dict,
    timeout: float = 30.0,
) -> dict:
    """One POST against a serving replica, with the fleet's status
    contract decoded into the batcher's typed exceptions: 429 ->
    ``QueueFullError`` (back off here), 503 -> ``DrainingError`` (go
    elsewhere; the server marks real drains with ``draining: true``
    but every 503 means "this replica can't take it, another might"),
    4xx -> ``UpstreamClientError`` (never retried), refused/reset ->
    ``ConnectionError`` (dead replica), other 5xx -> ``RuntimeError``
    (transient)."""
    url = address if address.startswith("http") else f"http://{address}"
    req = urllib.request.Request(
        url.rstrip("/") + path,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read() or b"{}")
        except ValueError:
            body = {}
        if e.code == 429:
            raise QueueFullError(
                body.get("error", "queue full"),
                retry_after=_retry_after_of(e.headers, body, 0.05),
            ) from None
        if e.code == 503:
            raise DrainingError(
                body.get("error", "unavailable"),
                retry_after=_retry_after_of(e.headers, body, 0.5),
            ) from None
        if 400 <= e.code < 500:
            raise UpstreamClientError(e.code, body) from None
        raise RuntimeError(body.get("error") or f"upstream {e.code}")
    except urllib.error.URLError as e:
        raise ConnectionError(str(e.reason)) from None
    except (ConnectionError, TimeoutError, OSError) as e:
        raise ConnectionError(str(e)) from None


class HTTPTarget:
    """A replica address as a RetryingClient target: calling it POSTs
    the request to ``path`` and decodes the status contract."""

    __slots__ = ("address", "path", "timeout")

    def __init__(self, address: str, path: str = "/predict",
                 timeout: float = 30.0):
        self.address = address
        self.path = path
        self.timeout = timeout

    def __call__(self, request: dict) -> dict:
        return http_call(
            self.address, self.path, request, timeout=self.timeout
        )

    def __repr__(self):
        return f"HTTPTarget({self.address}{self.path})"


#: per-attempt outcome names surfaced through ``on_attempt`` (and the
#: reasons the router counts under edl_route_retries_total)
OK, QUEUE_FULL, DRAINING, REFUSED, ERROR = (
    "ok", "queue_full", "draining", "refused", "error",
)


class RetryingClient:
    """Submit a request against an ordered fleet of targets until one
    serves it, within a wall-clock + attempt budget.

    ``targets``: a sequence of targets, or a zero-arg callable
    returning the CURRENT ordered candidate list (the router passes
    its live, health-filtered pick order so every pass reflects
    reality, not the admission-time snapshot).  ``submit(target,
    request)`` performs one attempt (default: ``target(request)``);
    it must raise ``QueueFullError`` / ``DrainingError`` /
    ``ConnectionError`` for the typed outcomes — anything else
    non-``UpstreamClientError`` counts as a transient error.

    ``on_attempt(target, outcome, exc)`` observes every attempt
    (outcome is one of ok/queue_full/draining/refused/error) — the
    router's passive-health and retry accounting hang off it.
    """

    def __init__(
        self,
        targets: Union[Sequence[Any], Callable[[], Sequence[Any]]],
        submit: Optional[Callable[[Any, Any], Any]] = None,
        budget_s: float = 15.0,
        attempts: int = 64,
        same_target_retries: int = 2,
        base_backoff_s: float = 0.02,
        max_backoff_s: float = 1.0,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
        on_attempt=None,
    ):
        self._targets = targets
        self._submit = submit or (lambda t, req: t(req))
        self.budget_s = float(budget_s)
        self.max_attempts = int(attempts)
        self.same_target_retries = int(same_target_retries)
        self.base_backoff_s = float(base_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self._sleep = sleep
        self._clock = clock
        self._on_attempt = on_attempt

    def _candidates(self) -> List[Any]:
        t = self._targets
        return list(t() if callable(t) else t)

    def _note(self, target, outcome, exc) -> None:
        if self._on_attempt is not None:
            self._on_attempt(target, outcome, exc)

    def call(self, request: Any) -> Any:
        deadline = self._clock() + self.budget_s
        attempts = 0
        backoff = self.base_backoff_s
        hint = 0.0
        last: Optional[BaseException] = None
        last_pass_saturated = False

        def exhausted(msg: str) -> RetryBudgetExhausted:
            return RetryBudgetExhausted(
                f"{msg} after {attempts} attempts: {last}",
                retry_after=max(hint, backoff),
                saturated=last_pass_saturated,
                attempts=attempts,
            )

        while True:
            order = self._candidates()
            if not order:
                last_pass_saturated = False
                raise exhausted("no routable backend")
            pass_saturated = True
            for target in order:
                full_here = 0
                while True:
                    if attempts >= self.max_attempts:
                        raise exhausted("attempt budget spent")
                    if self._clock() >= deadline:
                        raise exhausted("retry budget spent")
                    attempts += 1
                    try:
                        result = self._submit(target, request)
                    except QueueFullError as e:
                        # back off HERE: the replica is right, just full
                        last, hint = e, max(hint, e.retry_after)
                        self._note(target, QUEUE_FULL, e)
                        full_here += 1
                        if full_here > self.same_target_retries:
                            break  # concede the pass; next target
                        self._sleep(
                            min(e.retry_after, max(0.0,
                                                   deadline - self._clock()))
                        )
                        continue
                    except DrainingError as e:
                        # go ELSEWHERE: the replica is leaving
                        last, hint = e, max(hint, e.retry_after)
                        pass_saturated = False
                        self._note(target, DRAINING, e)
                        break
                    except UpstreamClientError:
                        raise  # the REQUEST is bad; no replica differs
                    except ConnectionError as e:
                        last = e
                        pass_saturated = False
                        self._note(target, REFUSED, e)
                        break
                    except Exception as e:
                        last = e
                        pass_saturated = False
                        self._note(target, ERROR, e)
                        break
                    self._note(target, OK, None)
                    return result
            last_pass_saturated = pass_saturated
            # the whole pass failed; breathe before re-walking the
            # fleet (capped exponential, deterministic on purpose)
            wait = max(backoff, hint if pass_saturated else 0.0)
            if self._clock() + wait >= deadline:
                raise exhausted("retry budget spent")
            self._sleep(wait)
            backoff = min(backoff * 2.0, self.max_backoff_s)
