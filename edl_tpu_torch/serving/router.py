"""The fleet front door (counterpart of ``edl_tpu/serving/router.py``).

A coordinator-fed routing tier that makes replica churn invisible to
clients.  Drains migrate live KV, hot swaps re-prefill, watchdogs
rebuild pools, leases evict the dead; without a router every one of
those shows to callers as a 503 / 429 / refused connection to retry
around.  ``RequestRouter`` owns that loop once, fleet-side:

- **spread** — `/predict` and `/generate` admissions go to the
  least-loaded routable replica, scored by live queue depth, admission
  saturation, KV occupancy and in-flight count (per-replica ``/healthz``
  probes merged with the telemetry aggregator's labeled gauges; the
  fleet TTFT p95 rides the journal and the saturation Retry-After);
- **steer** — drain intents published by the scale-down actuator,
  drain flight events from the coordinator's merged journal, and
  ``/healthz`` draining bits all mark a replica DRAINING, and new work
  stops landing on it BEFORE it would 503;
- **absorb** — per-attempt failures (429 back-off-here, 503
  go-elsewhere, refused = dead) are retried against the live candidate
  order under a per-request budget (``serving.client``); the
  typed ``RetryBudgetExhausted`` reaches the client as 503 +
  Retry-After only when the whole fleet is saturated (a busy fleet
  advertises when to come back; a broken one answers 502);
- **eject** — consecutive passive failures take a replica out of
  rotation; ONLY a successful active ``/healthz`` probe re-admits it
  (flap damping: one good request must not resurrect a dying box);
- **re-drive** — a `/generate` stream cut mid-flight by a replica kill
  is resumed on a survivor without duplicating or dropping a token:
  greedy decode is a pure function of (weights step, prefix), so if
  the survivor serves the SAME weights step that produced the emitted
  prefix (each leg's first token line carries its purity stamp), the
  router re-submits prompt+prefix and splices the continuation;
  any skew and it RESTARTS — a ``{"restart": true}`` line voids the
  prefix, exactly the batcher's own hot-swap contract;
- **affinity** — prefix-sharing `/generate` sessions are steered to
  the replica already holding their cached KV blocks (the prefix
  cache's chain hash computed router-side).  Advisory only: the prefix
  cache is correct on any replica, affinity just turns misses into hits.

``RouterServer`` puts an HTTP front on it (the coordinator service's
idiom), and ``python -m edl_tpu_torch.serving.router --coordinator
HOST:PORT`` (routerd) runs it against a serving coordinator, configured
by the ``EDL_ROUTE_*`` env keys (``EDL_ROUTE_PORT``,
``EDL_ROUTE_RETRY_BUDGET_MS``, ``EDL_ROUTE_PROBE_MS``,
``EDL_ROUTE_EJECT_AFTER``).

Chaos (``chaos=``): ``route.probe.fail`` fails the next active probe,
``route.backend.refused`` refuses the next proxy attempt without
contacting the backend, and ``route.stream.cut`` tears a relayed stream
down after its next token line (re-driven on a survivor).
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import threading
import time
import urllib.error
import urllib.request
import uuid
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from edl_tpu_torch import telemetry
from edl_tpu_torch.serving.batcher import DrainingError, QueueFullError
from edl_tpu_torch.serving.client import (
    DRAINING,
    ERROR,
    OK,
    REFUSED,
    RetryBudgetExhausted,
    RetryingClient,
    UpstreamClientError,
    http_call,
)
from edl_tpu_torch.serving.prefix import chain_hashes
from edl_tpu_torch.telemetry.aggregate import histogram_quantile

HEALTHY = "healthy"
DRAINING_STATE = "draining"
EJECTED = "ejected"

#: scoring weights: queue entries and in-flight requests are work
#: units; KV occupancy and admission saturation are [0,1] fractions
#: scaled to compete (a 90%-full KV pool outweighs a few queued items)
_W_IN_FLIGHT = 0.5
_W_KV = 4.0
_W_SATURATION = 2.0
#: affinity is advisory: follow it only while the affine replica's
#: queue is within this many work units of the best candidate
_AFFINITY_MAX_EXTRA = 4.0


class ReplicaView:
    """The router's book on one replica: identity from the plan,
    vitals from the last /healthz probe (merged with the aggregator's
    labeled gauges), health from passive + active signals."""

    __slots__ = (
        "replica_id", "address", "health", "fails", "probes_failed",
        "queue_depth", "queue_limit", "saturation", "in_flight",
        "kv_occupancy", "decode_depth", "weights_step",
        "weights_generation", "can_generate", "last_probe_s", "ready",
    )

    def __init__(self, replica_id: str, address: str):
        self.replica_id = replica_id
        self.address = address
        self.health = HEALTHY
        self.fails = 0
        self.probes_failed = 0
        self.queue_depth = 0.0
        self.queue_limit = 0
        self.saturation = 0.0
        self.in_flight = 0.0
        self.kv_occupancy = 0.0
        self.decode_depth = 0.0
        self.weights_step: Optional[int] = None
        self.weights_generation: Optional[int] = None
        #: optimistic until a probe or a 404 says otherwise
        self.can_generate = True
        self.last_probe_s = 0.0
        self.ready = True

    def score(self) -> float:
        return (
            self.queue_depth
            + self.decode_depth
            + _W_IN_FLIGHT * self.in_flight
            + _W_KV * self.kv_occupancy
            + _W_SATURATION * self.saturation
        )

    def to_dict(self) -> dict:
        return {
            "replica": self.replica_id,
            "address": self.address,
            "health": self.health,
            "score": round(self.score(), 4),
            "queue_depth": self.queue_depth,
            "queue_limit": self.queue_limit,
            "saturation": self.saturation,
            "in_flight": self.in_flight,
            "kv_occupancy": self.kv_occupancy,
            "decode_queue_depth": self.decode_depth,
            "weights_step": self.weights_step,
            "can_generate": self.can_generate,
            "consecutive_failures": self.fails,
        }


class RequestRouter:
    """The routing core.  Thread-safe; transport is plain urllib so a
    routerd is deployable anywhere the coordinator is reachable."""

    def __init__(
        self,
        coordinator,
        eject_after: int = 3,
        retry_budget_s: float = 10.0,
        attempts: int = 32,
        base_backoff_s: float = 0.02,
        max_backoff_s: float = 0.5,
        probe_timeout_s: float = 5.0,
        request_timeout_s: float = 30.0,
        max_redrives: int = 3,
        affinity_capacity: int = 4096,
        chaos=None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.coordinator = coordinator
        self.eject_after = int(eject_after)
        self.retry_budget_s = float(retry_budget_s)
        self.attempts = int(attempts)
        self.base_backoff_s = float(base_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.request_timeout_s = float(request_timeout_s)
        self.max_redrives = int(max_redrives)
        self.chaos = chaos
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.RLock()
        self._replicas: "OrderedDict[str, ReplicaView]" = OrderedDict()
        self.plan_generation = -1
        #: fleet-level TTFT p95 from the aggregator's merged histogram
        #: (journaled with saturation replies; per-replica spread uses
        #: the labeled gauges, histograms are fleet-wide)
        self.ttft_p95_s: Optional[float] = None
        #: chain hash -> replica_id holding those cached blocks (LRU,
        #: advisory — a wrong entry costs a prefix MISS, never tokens)
        self._affinity: "OrderedDict[int, str]" = OrderedDict()
        self._affinity_capacity = int(affinity_capacity)
        #: coordinator-journal watermark for drain-event consumption
        self._seen_event_seq = -1
        #: fleet-uniform KV block size, learned from any decode
        #: replica's healthz (0 = not learned yet; affinity disabled)
        self._block_tokens = 0

        reg = telemetry.get_registry()
        self.recorder = telemetry.get_recorder()
        self._m_requests = reg.counter("edl_route_requests_total")
        self._m_retries = reg.counter("edl_route_retries_total")
        self._m_steers = reg.counter("edl_route_steers_total")
        self._m_ejections = reg.counter("edl_route_ejections_total")
        self._m_readmits = reg.counter("edl_route_readmits_total")
        self._m_redrives = reg.counter("edl_route_redrives_total")
        self._m_affinity = reg.counter("edl_route_affinity_total")
        self._g_backends = reg.gauge("edl_route_backends")

    # -- plan / telemetry sync ------------------------------------------------
    def sync(self) -> None:
        """One pull of the serving coordinator's plan + telemetry:
        reconcile the replica set, fold labeled per-replica gauges
        into the views, consume drain flight events (steer-before-503
        signal #1), refresh the fleet TTFT p95."""
        try:
            plan = self.coordinator.plan()
        except Exception:
            return  # coordinator dark: keep routing on the last view
        if plan is not None:
            members = list(plan.members)
            addresses = list(plan.addresses)
            with self._lock:
                current = set(self._replicas)
                planned = set(members)
                for gone in current - planned:
                    del self._replicas[gone]
                for rid, addr in zip(members, addresses):
                    v = self._replicas.get(rid)
                    if v is None:
                        self._replicas[rid] = ReplicaView(rid, addr)
                    elif v.address != addr:
                        # restarted under a new port: it earned a
                        # fresh passive-health slate
                        v.address = addr
                        v.fails = 0
                        if v.health == DRAINING_STATE:
                            v.health = HEALTHY
                self.plan_generation = int(plan.generation)
        try:
            tel = self.coordinator.telemetry() or {}
        except Exception:
            tel = {}
        self._fold_telemetry(tel)
        self._consume_drain_events(tel.get("events") or ())
        self._update_census()

    def _fold_telemetry(self, tel: dict) -> None:
        merged = tel.get("merged") or {}
        hists = merged.get("histograms") or {}
        self.ttft_p95_s = histogram_quantile(
            hists.get("edl_serve_ttft_seconds"), 0.95
        )
        gauges = merged.get("gauges") or {}

        def by_replica(name: str) -> Dict[str, float]:
            out = {}
            for labels, val in (gauges.get(name) or {}).items():
                for part in str(labels).split(","):
                    if part.startswith("replica="):
                        out[part[len("replica="):]] = float(val)
            return out

        depth = by_replica("edl_serve_queue_depth")
        decode = by_replica("edl_serve_decode_queue_depth")
        kv = by_replica("edl_serve_kv_occupancy")
        with self._lock:
            for rid, v in self._replicas.items():
                # probes are fresher than report-cadence telemetry;
                # only fill gaps a probe hasn't covered recently
                if self._clock() - v.last_probe_s < 1.0:
                    continue
                if rid in depth:
                    v.queue_depth = depth[rid]
                if rid in decode:
                    v.decode_depth = decode[rid]
                if rid in kv:
                    v.kv_occupancy = kv[rid]

    def _consume_drain_events(self, events: Sequence[dict]) -> None:
        """serve.drain flight events in the coordinator's merged
        journal mark the victim DRAINING here even when nobody told
        the router directly (kubelet preStop drains, manual POST
        /drain) — the router reads the fleet's own evidence."""
        newest = self._seen_event_seq
        for ev in events:
            seq = int(ev.get("seq", -1))
            if seq <= self._seen_event_seq:
                continue
            newest = max(newest, seq)
            if ev.get("kind") != "serve.drain":
                continue
            data = ev.get("data") or {}
            rid = data.get("replica")
            with self._lock:
                v = self._replicas.get(rid)
                if v is not None and v.health == HEALTHY:
                    self._mark_draining_locked(
                        v, trace=ev.get("trace") or None,
                        source="journal",
                    )
        self._seen_event_seq = newest

    def _update_census(self) -> None:
        with self._lock:
            counts = {HEALTHY: 0, DRAINING_STATE: 0, EJECTED: 0}
            for v in self._replicas.values():
                counts[v.health] += 1
        for state, n in counts.items():
            self._g_backends.set(n, state=state)

    # -- health ---------------------------------------------------------------
    def _mark_draining_locked(self, v: ReplicaView, trace=None,
                              source: str = "intent") -> None:
        v.health = DRAINING_STATE
        self.recorder.record(
            "route.steer",
            {"replica": v.replica_id, "source": source},
            trace=trace,
        )

    def mark_draining(self, replica_ids: Sequence[str],
                      trace: Optional[str] = None) -> None:
        """Drain-intent publication (the scale-down actuator calls
        this BEFORE POSTing /drain to the victims): new admissions
        steer off the victims from this moment, so the drain ack
        implies the router already stopped sending work."""
        with self._lock:
            for rid in replica_ids:
                v = self._replicas.get(rid)
                if v is not None and v.health != DRAINING_STATE:
                    self._mark_draining_locked(v, trace=trace)
        self._update_census()

    def probe(self, replica_id: str) -> bool:
        """Active /healthz probe: refresh one replica's vitals; an
        EJECTED replica that answers ok-and-not-draining is re-admitted
        HERE and only here."""
        with self._lock:
            v = self._replicas.get(replica_id)
        if v is None:
            return False
        health: Optional[dict] = None
        if self.chaos is not None and self.chaos.due("route.probe.fail"):
            health = None
        else:
            try:
                with urllib.request.urlopen(
                    f"http://{v.address}/healthz",
                    timeout=self.probe_timeout_s,
                ) as resp:
                    health = json.loads(resp.read())
            except urllib.error.HTTPError as e:
                try:
                    health = json.loads(e.read() or b"{}")
                except ValueError:
                    health = None
                if e.code != 503:
                    health = None
                # a 503 healthz: alive but not ready — the vitals are
                # real, the replica is just not routable yet
            except Exception:
                health = None
        with self._lock:
            if self._replicas.get(replica_id) is not v:
                return False
            if health is None:
                v.probes_failed += 1
                self._passive_failure_locked(v)
                return False
            v.last_probe_s = self._clock()
            v.probes_failed = 0
            v.queue_depth = float(health.get("queue_depth", 0))
            v.queue_limit = int(health.get("queue_limit", 0))
            v.saturation = float(health.get("saturation", 0.0))
            v.in_flight = float(health.get("in_flight", 0))
            v.weights_step = health.get("weights_step")
            v.weights_generation = health.get("weights_generation")
            v.ready = bool(health.get("ok", False))
            decode = health.get("decode")
            v.can_generate = decode is not None
            if decode:
                v.decode_depth = float(
                    decode.get("decode_queue_depth", 0)
                )
                v.kv_occupancy = float(decode.get("kv_occupancy", 0.0))
                if decode.get("block_tokens"):
                    self._block_tokens = int(decode["block_tokens"])
            draining = bool(health.get("draining", False))
            if draining and v.health == HEALTHY:
                self._mark_draining_locked(v, source="healthz")
            elif not draining and v.ready:
                if v.health == EJECTED:
                    v.health = HEALTHY
                    v.fails = 0
                    self._m_readmits.inc()
                    self.recorder.record(
                        "route.readmit", {"replica": v.replica_id}
                    )
                elif v.health == DRAINING_STATE and v.fails == 0:
                    # a drained-then-restarted replica reports clean:
                    # back in rotation
                    v.health = HEALTHY
        self._update_census()
        return health is not None and bool(health.get("ok", False))

    def probe_all(self) -> None:
        with self._lock:
            ids = list(self._replicas)
        for rid in ids:
            self.probe(rid)

    def _passive_failure_locked(self, v: ReplicaView) -> None:
        v.fails += 1
        if v.health != EJECTED and v.fails >= self.eject_after:
            v.health = EJECTED
            self._m_ejections.inc()
            self.recorder.record(
                "route.eject",
                {"replica": v.replica_id, "consecutive_failures": v.fails},
            )

    def _on_attempt(self, view: ReplicaView, outcome: str, exc) -> None:
        """RetryingClient's per-attempt observer: retry accounting +
        passive health."""
        if outcome == OK:
            with self._lock:
                view.fails = 0
            return
        self._m_retries.inc(reason=outcome)
        with self._lock:
            if outcome == DRAINING:
                # the 503 told us what the intent/journal should have:
                # it is leaving — steer everyone else off it
                if view.health == HEALTHY:
                    self._mark_draining_locked(view, source="503")
            elif outcome in (REFUSED, ERROR):
                self._passive_failure_locked(view)
        self._update_census()

    # -- candidate selection --------------------------------------------------
    def _routable(self, generate: bool = False) -> List[ReplicaView]:
        with self._lock:
            views = [
                v for v in self._replicas.values()
                if v.health == HEALTHY and (v.can_generate or not generate)
            ]
        return sorted(views, key=lambda v: (v.score(), v.replica_id))

    def _order(self, generate: bool = False,
               hashes: Optional[List[int]] = None,
               count_steer: bool = False) -> List[ReplicaView]:
        """The live candidate order for one retry pass: least-loaded
        first, prefix affinity promoted to the front while it stays
        advisory-cheap."""
        order = self._routable(generate=generate)
        if count_steer and order:
            with self._lock:
                any_draining = any(
                    v.health == DRAINING_STATE
                    for v in self._replicas.values()
                )
            if any_draining:
                # this admission would have been eligible for a
                # draining replica and went elsewhere instead
                self._m_steers.inc()
        if hashes:
            affine = None
            with self._lock:
                for h in reversed(hashes):  # deepest block first
                    rid = self._affinity.get(h)
                    if rid is not None:
                        affine = rid
                        break
            hit = False
            if affine is not None and order:
                best = order[0].score()
                for i, v in enumerate(order):
                    if v.replica_id == affine:
                        if v.score() <= best + _AFFINITY_MAX_EXTRA:
                            order.insert(0, order.pop(i))
                            hit = True
                        break
            self._m_affinity.inc(outcome="hit" if hit else "miss")
        return order

    def _remember_affinity(self, hashes: Sequence[int], rid: str) -> None:
        if not hashes:
            return
        with self._lock:
            for h in hashes:
                self._affinity.pop(h, None)
                self._affinity[h] = rid
            while len(self._affinity) > self._affinity_capacity:
                self._affinity.popitem(last=False)

    def _chain_hashes(self, req: dict) -> List[int]:
        tokens = (req.get("inputs") or {}).get("tokens")
        if not tokens:
            return []
        bt = self._probe_block_tokens()
        if not bt:
            return []
        try:
            return chain_hashes(np.asarray(tokens, np.int32), bt)
        except Exception:
            return []

    def _probe_block_tokens(self) -> int:
        # block size is fleet-uniform; learn it once from any healthz
        if self._block_tokens:
            return self._block_tokens
        with self._lock:
            addrs = [v.address for v in self._replicas.values()]
        for addr in addrs:
            try:
                with urllib.request.urlopen(
                    f"http://{addr}/healthz", timeout=self.probe_timeout_s
                ) as resp:
                    h = json.loads(resp.read())
                bt = int((h.get("decode") or {}).get("block_tokens", 0))
                if bt:
                    self._block_tokens = bt
                    return bt
            except Exception:
                continue
        return 0

    # -- request paths --------------------------------------------------------
    def _client(self, order: Callable[[], List[ReplicaView]],
                submit) -> RetryingClient:
        return RetryingClient(
            order,
            submit=submit,
            budget_s=self.retry_budget_s,
            attempts=self.attempts,
            base_backoff_s=self.base_backoff_s,
            max_backoff_s=self.max_backoff_s,
            sleep=self._sleep,
            clock=self._clock,
            on_attempt=self._on_attempt,
        )

    def _chaos_refused(self) -> None:
        if self.chaos is not None and self.chaos.due("route.backend.refused"):
            raise ConnectionError("chaos: backend refused")

    def _resolve(self, call: Callable[[], Any]) -> Any:
        try:
            result = call()
        except RetryBudgetExhausted as e:
            self._m_requests.inc(outcome="exhausted")
            self.recorder.record(
                "route.exhausted",
                {"saturated": e.saturated},
                timing={
                    "attempts": e.attempts,
                    "ttft_p95_s": self.ttft_p95_s,
                },
            )
            raise
        except UpstreamClientError:
            self._m_requests.inc(outcome="error")
            raise
        self._m_requests.inc(outcome="ok")
        return result

    def predict(self, req: dict) -> dict:
        def submit(view: ReplicaView, request: dict) -> dict:
            self._chaos_refused()
            return http_call(
                view.address, "/predict", request,
                timeout=self.request_timeout_s,
            )

        client = self._client(
            lambda: self._order(count_steer=True), submit
        )
        return self._resolve(lambda: client.call(req))

    def generate(self, req: dict) -> dict:
        """Non-streaming /generate (stream=false): spread + absorb,
        with prefix affinity."""
        hashes = self._chain_hashes(req)

        def submit(view: ReplicaView, request: dict) -> dict:
            self._chaos_refused()
            try:
                out = http_call(
                    view.address, "/generate", request,
                    timeout=self.request_timeout_s,
                )
            except UpstreamClientError as e:
                if e.status == 404:
                    # no decode path on this replica: remember and
                    # let the retry walk on
                    with self._lock:
                        view.can_generate = False
                    raise RuntimeError("no decode path") from None
                raise
            self._remember_affinity(hashes, view.replica_id)
            return out

        client = self._client(
            lambda: self._order(generate=True, hashes=hashes,
                                count_steer=True),
            submit,
        )
        return self._resolve(lambda: client.call(req))

    # -- streaming /generate with re-drive ------------------------------------
    def _open_stream(self, view: ReplicaView, payload: dict):
        """POST /generate stream=true; returns the live HTTPResponse.
        Raises the typed admission errors exactly like http_call."""
        self._chaos_refused()
        req = urllib.request.Request(
            f"http://{view.address}/generate",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            return urllib.request.urlopen(
                req, timeout=self.request_timeout_s
            )
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read() or b"{}")
            except ValueError:
                body = {}
            if e.code == 429:
                raise QueueFullError(
                    body.get("error", "queue full"),
                    retry_after=float(body.get("retry_after_s", 0.05)),
                ) from None
            if e.code == 503:
                raise DrainingError(
                    body.get("error", "unavailable"),
                    retry_after=float(body.get("retry_after_s", 0.5)),
                ) from None
            if 400 <= e.code < 500:
                raise UpstreamClientError(e.code, body) from None
            raise RuntimeError(body.get("error") or f"upstream {e.code}")
        except urllib.error.URLError as e:
            raise ConnectionError(str(e.reason)) from None
        except (ConnectionError, TimeoutError, OSError) as e:
            raise ConnectionError(str(e)) from None

    def generate_stream(self, req: dict, emit: Callable[[dict], None]):
        """Relay a streaming generation, surviving replica loss.

        The client sees ONE coherent ndjson stream: token lines with
        globally consistent indices, at most the batcher's own restart
        semantics (a ``restart`` line voids prior tokens), and exactly
        one terminal done/error line.  A mid-stream cut re-drives on a
        survivor: RESUME when the survivor's first-token purity stamp
        matches the step that produced the emitted prefix (greedy
        decode continues the prefix exactly — nothing duplicated,
        nothing dropped), RESTART otherwise."""
        prompt = list((req.get("inputs") or {}).get("tokens") or [])
        max_new = req.get("max_new_tokens")
        hashes = self._chain_hashes(req)
        emitted: List[int] = []
        leg_step: Optional[int] = None  # stamp of the emitted prefix
        redrives = 0
        deadline = self._clock() + self.retry_budget_s + (
            float(req.get("deadline_ms", 0) or 0) / 1000.0
        )
        resuming = False

        while True:
            if resuming and max_new is not None:
                remaining = int(max_new) - len(emitted)
                if remaining <= 0:
                    emit({"done": True, "tokens": list(emitted),
                          "redriven": redrives})
                    return
                payload = dict(req)
                payload["inputs"] = {"tokens": prompt + emitted}
                payload["max_new_tokens"] = remaining
            else:
                payload = dict(req)
            payload["stream"] = True

            def submit(view: ReplicaView, _p=payload):
                resp = self._open_stream(view, _p)
                return view, resp

            client = self._client(
                lambda: self._order(
                    generate=True, hashes=hashes, count_steer=True
                ),
                submit,
            )
            try:
                view, resp = client.call(payload)
            except RetryBudgetExhausted as e:
                self._m_requests.inc(outcome="exhausted")
                self.recorder.record(
                    "route.exhausted", {"saturated": e.saturated}
                )
                raise
            except UpstreamClientError as e:
                if resuming:
                    # e.g. prompt+prefix outgrew the context window:
                    # fall back to a clean restart of the original
                    resuming = False
                    emitted = []
                    leg_step = None
                    emit({"restart": True, "redrive": True})
                    self._m_redrives.inc(outcome="restart")
                    self.recorder.record(
                        "route.redrive", {"outcome": "restart"}
                    )
                    continue
                self._m_requests.inc(outcome="error")
                raise

            # a streamed session teaches affinity as a plain one does: the
            # replica that took the leg now holds the prompt's blocks
            self._remember_affinity(hashes, view.replica_id)
            cut = False
            leg_tokens = 0
            abandon_restart = False
            try:
                while True:
                    line = resp.readline()
                    if not line:
                        cut = True  # ended without a terminal line
                        break
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        cut = True  # torn mid-line: the kill shape
                        break
                    if "token" in ev:
                        if int(ev.get("i", -1)) == 0:
                            step = ev.get("weights_step")
                            if resuming and leg_step is not None and (
                                step is None or step != leg_step
                            ):
                                # the survivor swapped between probe
                                # and prefill: resuming would mix
                                # weight generations — abandon the
                                # leg BEFORE forwarding anything
                                abandon_restart = True
                                break
                            leg_step = step
                        leg_tokens += 1
                        tok = int(ev["token"])
                        out = {"token": tok, "i": len(emitted)}
                        if "weights_step" in ev and not emitted:
                            out["weights_step"] = ev["weights_step"]
                        emitted.append(tok)
                        emit(out)
                        if self.chaos is not None and self.chaos.due("route.stream.cut"):
                            # chaos[route.stream.cut]: the replica-kill
                            # shape from the router's seat.
                            cut = True
                            self._on_attempt(view, REFUSED, ConnectionError("cut"))
                            break
                    elif ev.get("restart"):
                        # the replica's own hot-swap restart: prior
                        # tokens are void for the client too
                        emitted = []
                        leg_step = ev.get("weights_step")
                        resuming = False
                        emit(ev)
                    elif "done" in ev:
                        done = dict(ev)
                        done["tokens"] = list(emitted)
                        if redrives:
                            done["redriven"] = redrives
                        emit(done)
                        self._m_requests.inc(outcome="ok")
                        return
                    elif "error" in ev:
                        emit(ev)
                        self._m_requests.inc(outcome="error")
                        return
                    else:
                        emit(ev)
            except (ConnectionError, OSError,
                    http.client.HTTPException) as e:
                cut = True
                self._on_attempt(view, REFUSED, e)
            finally:
                try:
                    resp.close()
                except Exception:
                    pass

            if abandon_restart:
                resuming = False
                emitted = []
                leg_step = None
                emit({"restart": True, "redrive": True})
                self._m_redrives.inc(outcome="restart")
                self.recorder.record(
                    "route.redrive", {"outcome": "restart"}
                )
                continue
            if not cut:
                continue  # defensive: loop re-admits
            redrives += 1
            if redrives > self.max_redrives or self._clock() >= deadline:
                self._m_requests.inc(outcome="exhausted")
                self.recorder.record(
                    "route.exhausted", {"saturated": False}
                )
                raise RetryBudgetExhausted(
                    f"stream cut {redrives}x, budget spent",
                    saturated=False,
                )
            # resume-or-restart: purity decides.  We can only resume
            # when we KNOW the step that produced the emitted prefix
            # and a token budget to subtract from.
            if emitted and leg_step is not None and max_new is not None:
                resuming = True
                self._m_redrives.inc(outcome="resume")
                self.recorder.record(
                    "route.redrive",
                    {"outcome": "resume"},
                    timing={"at_token": len(emitted)},
                )
            else:
                resuming = False
                if emitted or leg_tokens:
                    emit({"restart": True, "redrive": True})
                emitted = []
                leg_step = None
                self._m_redrives.inc(outcome="restart")
                self.recorder.record(
                    "route.redrive", {"outcome": "restart"}
                )

    # -- introspection --------------------------------------------------------
    def routing_table(self) -> dict:
        with self._lock:
            replicas = [v.to_dict() for v in self._replicas.values()]
        return {
            "plan_generation": self.plan_generation,
            "ttft_p95_s": self.ttft_p95_s,
            "replicas": replicas,
            "affinity_entries": len(self._affinity),
        }


class RouterServer:
    """The routerd HTTP front: /predict and /generate proxied through a
    ``RequestRouter``, /routes (the routing table) for operators,
    /drain_intent for a scale-down actuator, /healthz and /metrics for
    the platform."""

    def __init__(self, router: RequestRouter, host: str = "0.0.0.0",
                 port: int = 0, sync_interval_s: float = 0.5):
        from http.server import BaseHTTPRequestHandler

        from edl_tpu_torch.serving.server import FrontServer

        self.router = router
        self.sync_interval_s = float(sync_interval_s)
        self._stop = threading.Event()
        self._boot = uuid.uuid4().hex[:12]
        self._telemetry_seq = 0
        self._started = False
        registry = telemetry.get_registry()
        self_server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _reply(self, obj, code=200, headers=()):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _read_json(self):
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def do_GET(self):
                r = self_server.router
                if self.path == "/healthz":
                    table = r.routing_table()
                    healthy = sum(
                        1 for x in table["replicas"]
                        if x["health"] == HEALTHY
                    )
                    self._reply(
                        {
                            "ok": healthy > 0,
                            "role": "router",
                            "plan_generation": table["plan_generation"],
                            "backends": len(table["replicas"]),
                            "healthy": healthy,
                        },
                        200 if healthy > 0 else 503,
                    )
                elif self.path == "/routes":
                    self._reply(self_server.router.routing_table())
                elif self.path == "/metrics":
                    body = registry.render().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/plain; version=0.0.4"
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._reply({"error": "not found"}, 404)

            def _proxy(self, call):
                try:
                    self._reply(call())
                except RetryBudgetExhausted as e:
                    if e.saturated:
                        # the fleet is BUSY: tell the client when to
                        # come back
                        self._reply(
                            {
                                "error": str(e),
                                "saturated": True,
                                "retry_after_s": e.retry_after,
                            },
                            503,
                            headers=(
                                ("Retry-After", f"{e.retry_after:.3f}"),
                            ),
                        )
                    else:
                        # the fleet is GONE: no Retry-After promises
                        self._reply({"error": str(e)}, 502)
                except UpstreamClientError as e:
                    self._reply(e.body or {"error": str(e)}, e.status)
                except ValueError as e:
                    self._reply({"error": str(e)}, 400)
                except Exception as e:
                    self._reply({"error": str(e)}, 500)

            def do_POST(self):
                r = self_server.router
                if self.path == "/predict":
                    try:
                        req = self._read_json()
                    except ValueError:
                        self._reply({"error": "bad json"}, 400)
                        return
                    self._proxy(lambda: r.predict(req))
                elif self.path == "/generate":
                    try:
                        req = self._read_json()
                    except ValueError:
                        self._reply({"error": "bad json"}, 400)
                        return
                    if not req.get("stream"):
                        self._proxy(lambda: r.generate(req))
                        return
                    self._do_generate_stream(r, req)
                elif self.path == "/drain_intent":
                    try:
                        req = self._read_json()
                    except ValueError:
                        self._reply({"error": "bad json"}, 400)
                        return
                    r.mark_draining(
                        req.get("replicas") or (),
                        trace=req.get("trace") or None,
                    )
                    self._reply({"ok": True})
                else:
                    self._reply({"error": "not found"}, 404)

            def _do_generate_stream(self, r, req):
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(obj):
                    data = (json.dumps(obj) + "\n").encode()
                    self.wfile.write(
                        f"{len(data):x}\r\n".encode() + data + b"\r\n"
                    )
                    self.wfile.flush()

                try:
                    try:
                        r.generate_stream(req, chunk)
                    except RetryBudgetExhausted as e:
                        chunk({"error": str(e),
                               "saturated": e.saturated})
                    except UpstreamClientError as e:
                        chunk(e.body or {"error": str(e)})
                    except Exception as e:
                        chunk({"error": str(e)})
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionError):
                    pass  # client went away

        self._httpd = FrontServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._threads: List[threading.Thread] = []

    def start(self) -> "RouterServer":
        self._started = True
        t = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            daemon=True,
            name="edl-routerd",
        )
        t.start()
        self._threads.append(t)
        m = threading.Thread(
            target=self._maintain, daemon=True, name="edl-routerd-sync"
        )
        m.start()
        self._threads.append(m)
        return self

    def _maintain(self) -> None:
        while not self._stop.is_set():
            try:
                self.router.sync()
                self.router.probe_all()
                self._report_telemetry()
            except Exception:
                pass
            self._stop.wait(self.sync_interval_s)

    def _report_telemetry(self) -> None:
        """Ship the router's own registry to the serving coordinator as
        source \"router\" (the replicas' cumulative-snapshot wire), so
        the coordinator's merge shows steers, retries and ejections
        next to the fleet it fronts.  Best effort: a dark coordinator
        costs one report, never a route."""
        report = getattr(self.router.coordinator, "report_telemetry", None)
        if report is None:
            return
        self._telemetry_seq += 1
        try:
            report(
                "router",
                snapshot=telemetry.get_registry().snapshot(),
                seq=self._telemetry_seq,
                boot=self._boot,
            )
        except Exception:
            pass

    def stop(self) -> None:
        self._stop.set()
        try:
            if self._started:
                # shutdown() blocks on serve_forever's ack — it would
                # hang forever on a constructed-but-never-started server
                self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass


def route_run(
    coordinator_addr: str,
    port: int = 0,
    host: str = "0.0.0.0",
    retry_budget_s: float = 10.0,
    probe_interval_s: float = 0.5,
    eject_after: int = 3,
) -> RouterServer:
    """Build and start a router over the serving coordinator at
    ``coordinator_addr`` (the routerd pod entry point)."""
    from edl_tpu_torch.runtime.coord_service import HTTPCoordinator

    coord = HTTPCoordinator(coordinator_addr)
    router = RequestRouter(
        coord,
        retry_budget_s=retry_budget_s,
        eject_after=eject_after,
    )
    server = RouterServer(
        router, host=host, port=port, sync_interval_s=probe_interval_s
    )
    return server.start()


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="routerd",
        description="edl_tpu_torch serving fleet front door (request router)",
    )
    p.add_argument(
        "--coordinator",
        default=os.environ.get("EDL_COORDINATOR_ADDR", "127.0.0.1:7077"),
    )
    p.add_argument(
        "--port",
        type=int,
        default=int(os.environ.get("EDL_ROUTE_PORT", "7190")),
    )
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument(
        "--retry-budget-ms",
        type=float,
        default=float(os.environ.get("EDL_ROUTE_RETRY_BUDGET_MS", "10000")),
    )
    p.add_argument(
        "--probe-interval-ms",
        type=float,
        default=float(os.environ.get("EDL_ROUTE_PROBE_MS", "500")),
    )
    p.add_argument(
        "--eject-after",
        type=int,
        default=int(os.environ.get("EDL_ROUTE_EJECT_AFTER", "3")),
    )
    args = p.parse_args(argv)
    server = route_run(
        args.coordinator,
        port=args.port,
        host=args.host,
        retry_budget_s=args.retry_budget_ms / 1000.0,
        probe_interval_s=args.probe_interval_ms / 1000.0,
        eject_after=args.eject_after,
    )
    print(
        f"routerd listening on :{server.port} "
        f"(coordinator {args.coordinator})",
        flush=True,
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
