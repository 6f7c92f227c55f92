"""The autoscaler's serving lane: scale inference replicas on observed
p95 latency and queue depth (a copy of ``edl_tpu/autoscaler/serving.py``).

The training lane (``scaler.Autoscaler``) scales on cluster headroom
and goodput; serving load is a different signal with the same
actuation shape.  Each tick reads the serving coordinator's merged
``/telemetry`` (replicas ship their registry
snapshots on the heartbeat cadence), derives:

- ``p95``: the 95th percentile of ``edl_serve_latency_seconds`` over a
  sliding window of merged snapshots (cumulative histograms are
  monotone, so the WINDOW DELTA is the recent-traffic histogram — a
  cold morning's backlog must not pin p95 high all day),
- ``queue_depth``: the max ``edl_serve_queue_depth`` gauge across
  replicas,

and actuates through the SAME handshake as training: mint a trace id,
announce the incoming replica count via ``/prewarm`` (a joining
replica warms its bucketed forwards before taking traffic —
``ServingReplica.start``'s warm-before-register honors the hint's
contract), then retarget.  Every decision journals into the bounded
``decision_log`` and the flight recorder under the minted id, so
the merged timeline reads decision -> plan -> replica-registered ->
first-request chains exactly like training resizes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from edl_tpu_torch.telemetry.aggregate import histogram_quantile


def post_drain(
    address: str,
    budget_s: float,
    timeout: Optional[float] = None,
    migrate_to: Optional[str] = None,
    trace: Optional[str] = None,
) -> dict:
    """POST /drain to one serving replica and block for its ack (the
    reply carries ``drained``).  The scale-down actuators call this
    per victim BEFORE touching the Deployment — drain-victim-ack-then-
    patch, mirroring training's consensus victim-drain wait.
    ``migrate_to`` names a surviving replica: the victim hands its
    live KV sequences over instead of waiting them out, so the ack
    arrives in O(KV transfer) rather than O(longest generation)."""
    import json
    import urllib.request

    if "://" not in address:
        address = f"http://{address}"
    body = {"budget_ms": int(budget_s * 1000.0), "wait": True}
    if migrate_to:
        body["migrate_to"] = migrate_to
    if trace:
        # the decision's causal-trace id: the victim journals its
        # drain under it, so decision -> route steer -> drain ack
        # reads as ONE chain in the merged timeline
        body["trace"] = trace
    req = urllib.request.Request(
        address.rstrip("/") + "/drain",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(
        req, timeout=timeout if timeout is not None else budget_s + 5.0
    ) as r:
        return json.loads(r.read())


class ServingLane:
    """One serving fleet's scaling loop (drive ``run_once`` from the
    controller tick: ``attach_serving_lane``).

    ``coordinator``: the serving world's coordinator client (Local or
    HTTP — anything with ``telemetry``/``metrics``/``set_prewarm``/
    ``set_target_world``).  ``on_scale``: optional hook called with
    (old, new) after a successful retarget — the kube glue point where
    a Deployment's replica count follows the coordinator target (tests
    and local sim drive replica processes directly)."""

    def __init__(
        self,
        coordinator,
        min_replicas: int = 1,
        max_replicas: int = 4,
        p95_high_s: float = 0.5,
        p95_low_s: float = 0.05,
        queue_high: int = 8,
        hold_ticks: int = 2,
        on_scale=None,
        ttft_high_s: Optional[float] = None,
        victim_drain_timeout: float = 10.0,
        router=None,
    ):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"bad replica bounds [{min_replicas}, {max_replicas}]"
            )
        self.coordinator = coordinator
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.p95_high_s = p95_high_s
        self.p95_low_s = p95_low_s
        self.queue_high = queue_high
        #: consecutive low-load ticks required before shedding a
        #: replica (scale-down hysteresis: one quiet tick must not
        #: thrash the fleet a request burst will want back)
        self.hold_ticks = max(1, hold_ticks)
        self.on_scale = on_scale
        #: decode-path overload threshold on the TTFT p95 window delta
        #: (None = TTFT is observed/journaled but does not actuate —
        #: single-shot fleets have no TTFT series at all)
        self.ttft_high_s = ttft_high_s
        #: drain budget per scale-down victim (the serving analog of
        #: the training scaler's victim_drain_timeout): a victim gets
        #: this long to finish its in-flight generations before the
        #: lane gives up for this tick and retries next tick
        self.victim_drain_timeout = victim_drain_timeout
        #: the fleet front door: a RequestRouter-shaped
        #: object (``mark_draining(ids, trace=)``) or a routerd
        #: ``host:port`` string.  The lane publishes drain INTENTS to
        #: it BEFORE POSTing /drain to the victims, so new admissions
        #: steer off a victim before it can 503 a single one — the
        #: drain ack then implies the router stopped sending first.
        self.router = router
        self._low_ticks = 0
        #: cumulative rejected-request count at the previous tick: the
        #: overload signal is the per-tick DELTA, not the lifetime
        #: total (one historical 429 must not pin the fleet at max)
        self._last_rejected: Optional[float] = None
        #: sliding windows of cumulative histogram snapshots, one per
        #: metric name — p95 is computed over the window DELTA
        self._hist_windows: Dict[str, List[dict]] = {}
        self.hist_window_len = 8
        self.decision_log: List[dict] = []
        self.decision_log_max = 256

        from edl_tpu_torch import telemetry

        self._recorder = telemetry.get_recorder()
        reg = telemetry.get_registry()
        self._m_ticks = reg.counter("edl_autoscaler_ticks_total")
        self._m_actuations = reg.counter("edl_autoscaler_actuations_total")

    # -- observation --------------------------------------------------------
    def _window_p95(
        self, hist: Optional[dict], name: str = "edl_serve_latency_seconds"
    ) -> Optional[float]:
        """p95 over the recent window: cumulative histogram now minus
        the oldest snapshot in the window (falls back to the full
        cumulative series until the window fills).  ``name`` keys the
        sliding window (latency and TTFT each keep their own)."""
        if not hist:
            return None
        merged = {"": hist} if "counts" in hist else hist
        # Collapse label-keyed series into one (unlabeled in practice).
        base = None
        for h in merged.values():
            if base is None:
                base = {
                    "buckets": list(h["buckets"]),
                    "counts": list(h["counts"]),
                    "count": h["count"],
                }
            elif list(h["buckets"]) == base["buckets"]:
                base["counts"] = [
                    a + b for a, b in zip(base["counts"], h["counts"])
                ]
                base["count"] += h["count"]
        if base is None:
            return None
        window = self._hist_windows.setdefault(name, [])
        window.append(base)
        del window[: -self.hist_window_len]
        oldest = window[0]
        if oldest is base or list(oldest["buckets"]) != base["buckets"]:
            return histogram_quantile(base, 0.95)
        delta = {
            "buckets": base["buckets"],
            "counts": [
                max(0.0, a - b)
                for a, b in zip(base["counts"], oldest["counts"])
            ],
        }
        delta["count"] = sum(delta["counts"])
        if not delta["count"]:
            return None  # no recent traffic: latency says nothing
        return histogram_quantile(delta, 0.95)

    def observe(self) -> Dict[str, Optional[float]]:
        """One read of the serving coordinator's merged telemetry."""
        tel = self.coordinator.telemetry() or {}
        merged = tel.get("merged") or {}
        hists = merged.get("histograms") or {}
        gauges = merged.get("gauges") or {}
        counters = merged.get("counters") or {}
        depth_series = gauges.get("edl_serve_queue_depth") or {}
        req_series = counters.get("edl_serve_requests_total") or {}
        rejected_cum = sum(
            v for k, v in req_series.items() if "status=rejected" in k
        )
        # Rejections since the LAST tick: the cumulative counter only
        # grows, so its lifetime value says nothing about load NOW.
        # The FIRST tick only records the baseline (a restarted lane
        # reading a fleet's lifetime total must not actuate a spurious
        # scale-up for a burst that happened hours ago).
        rejected_new = (
            max(0.0, rejected_cum - self._last_rejected)
            if self._last_rejected is not None
            else 0.0
        )
        self._last_rejected = rejected_cum
        # Decode-path signals: requests waiting for a decode slot are
        # queue pressure exactly like single-shot depth (max of both
        # drives the band), TTFT keeps its own p95 window, and KV
        # occupancy rides along for the journal/operators.
        decode_depth = gauges.get("edl_serve_decode_queue_depth") or {}
        kv = gauges.get("edl_serve_kv_occupancy") or {}
        depths = list(depth_series.values()) + list(decode_depth.values())
        return {
            "p95_latency_s": self._window_p95(
                hists.get("edl_serve_latency_seconds")
            ),
            "ttft_p95_s": self._window_p95(
                hists.get("edl_serve_ttft_seconds"),
                name="edl_serve_ttft_seconds",
            ),
            "queue_depth": max(depths) if depths else None,
            "decode_queue_depth": (
                max(decode_depth.values()) if decode_depth else None
            ),
            "kv_occupancy": max(kv.values()) if kv else None,
            "requests_total": sum(req_series.values()) or None,
            "rejected_total": rejected_new or None,
        }

    def desired_replicas(self, obs, current: int) -> tuple:
        """The band decision — (proposed, reason) from one observation.
        Mutates only the hysteresis counter.  Factored out of
        ``run_once`` so the fleet market can run the SAME p95-window-
        delta / queue / rejection signals as a bidder's hard
        requirement (``edl_tpu_torch.fleet.bidders.ServingBidder``) while the
        arbiter owns the actuation."""
        p95 = obs.get("p95_latency_s")
        ttft = obs.get("ttft_p95_s")
        depth = obs.get("queue_depth") or 0
        rejected = obs.get("rejected_total")
        ttft_high = (
            self.ttft_high_s is not None
            and ttft is not None
            and ttft > self.ttft_high_s
        )
        overloaded = (
            (p95 is not None and p95 > self.p95_high_s)
            or ttft_high
            or depth >= self.queue_high
            or bool(rejected)
        )
        idle = (
            not overloaded
            and depth == 0
            and (p95 is None or p95 < self.p95_low_s)
        )
        proposed = current
        if overloaded:
            proposed = min(current + 1, self.max_replicas)
            self._low_ticks = 0
            reason = (
                f"overloaded (p95={p95 if p95 is None else round(p95, 4)}s"
                f" ttft={ttft if ttft is None else round(ttft, 4)}s"
                f" queue={depth} rejected={rejected or 0})"
            )
        elif idle:
            self._low_ticks += 1
            if self._low_ticks >= self.hold_ticks:
                proposed = max(current - 1, self.min_replicas)
                reason = (
                    f"idle {self._low_ticks} ticks "
                    f"(p95={p95 if p95 is None else round(p95, 4)}s)"
                )
            else:
                reason = (
                    f"idle tick {self._low_ticks}/{self.hold_ticks} "
                    "(hysteresis hold)"
                )
        else:
            self._low_ticks = 0
            reason = "within band"
        return proposed, reason

    def current_replicas(self) -> int:
        """The fleet's actuated replica target (coordinator view)."""
        snap = self.coordinator.metrics() or {}
        return int(
            snap.get("target_world") or snap.get("world_size") or 0
        ) or self.min_replicas

    # -- graceful scale-down -------------------------------------------------
    def _publish_drain_intent(
        self, victim_ids: List[str], trace: str
    ) -> None:
        """Tell the router who is leaving, before anyone tells the
        victims.  Best-effort on the ROUTER side (a dark router must
        not block a scale-down — the victims' own 503s are the
        fallback steer signal), but ordered strictly BEFORE the
        drains so the victim-ack implies steering already happened."""
        if self.router is None or not victim_ids:
            return
        try:
            if isinstance(self.router, str):
                import json as _json
                import urllib.request as _rq

                addr = self.router
                if "://" not in addr:
                    addr = f"http://{addr}"
                req = _rq.Request(
                    addr.rstrip("/") + "/drain_intent",
                    data=_json.dumps(
                        {"replicas": victim_ids, "trace": trace}
                    ).encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST",
                )
                with _rq.urlopen(req, timeout=5.0):
                    pass
            else:
                self.router.mark_draining(victim_ids, trace=trace or None)
        except Exception:
            pass

    def drain_victims(
        self, current: int, proposed: int, trace: str = ""
    ) -> dict:
        """Drain-victim-ack-then-patch: before a scale-down's retarget
        (and long before its Deployment patch), POST /drain to every
        victim replica and wait for the ack — so the patch can never
        yank a replica with live generations.  Victims are the plan's
        rank-order tail (the members the coordinator drops when the
        target shrinks); a victim with no address (in-process tests,
        pre-drain fleets) or an UNREACHABLE one (already dead — there
        is nothing live to yank) counts as acked.  A reachable victim
        that could NOT finish inside ``victim_drain_timeout`` does
        not: the caller skips the actuation this tick and retries —
        the drain it started keeps running, so the retry usually
        finds it finished."""
        info: dict = {"victims": [], "acked": True}
        if proposed >= current:
            return info
        plan_fn = getattr(self.coordinator, "plan", None)
        plan = plan_fn() if callable(plan_fn) else None
        if plan is None:
            return info
        members = list(plan.members)
        addresses = list(plan.addresses)
        addresses += [""] * (len(members) - len(addresses))
        # Survivor for live KV migration: the first addressed member
        # that STAYS in the plan.  Victims hand their in-flight
        # generations to it instead of waiting them out — the ack
        # latency becomes O(KV transfer); a fleet with no addressed
        # survivor (in-process tests) falls back to the bounded wait.
        migrate_to = next(
            (a for _, a in list(zip(members, addresses))[:proposed] if a),
            None,
        )
        if migrate_to:
            info["migrate_to"] = migrate_to
        victims = list(zip(members, addresses))[proposed:]
        # Front-door ordering: the router hears the drain
        # intent before any victim hears the drain.
        self._publish_drain_intent([rid for rid, _ in victims], trace)
        for rid, addr in victims:
            entry = {"replica": rid, "address": addr, "acked": True}
            if addr:
                try:
                    r = post_drain(
                        addr,
                        self.victim_drain_timeout,
                        migrate_to=migrate_to,
                        trace=trace or None,
                    )
                    entry["acked"] = bool(r.get("drained"))
                    if "migrate" in r:
                        entry["migrated"] = r.get("progress", {}).get(
                            "migrated", 0
                        )
                except Exception as e:
                    # ONLY connection-refused is evidence of death
                    # (nothing listening -> nothing live to yank; the
                    # lease reaper will drop it from the plan).  A
                    # TIMEOUT is evidence of the opposite — a live
                    # replica still draining — and any other error is
                    # unknown: both fail CLOSED (not acked, patch
                    # blocked, retried next tick; a genuinely dead
                    # victim leaves the plan via lease eviction, so
                    # blocking converges either way).
                    reason = getattr(e, "reason", e)
                    entry["acked"] = isinstance(
                        reason, ConnectionRefusedError
                    ) or isinstance(e, ConnectionRefusedError)
                    entry["unreachable"] = True
                    entry["error"] = type(e).__name__
            info["victims"].append(entry)
        info["acked"] = all(v["acked"] for v in info["victims"])
        return info

    # -- one decision cycle -------------------------------------------------
    def run_once(self) -> Optional[dict]:
        """Observe -> propose -> actuate -> journal.  Returns the
        decision entry (None when the coordinator is unreachable)."""
        try:
            obs = self.observe()
            current = self.current_replicas()
        except Exception:
            return None
        self._m_ticks.inc()
        proposed, reason = self.desired_replicas(obs, current)
        actuated = False
        trace_id = ""
        drain = None
        if proposed != current:
            from edl_tpu_torch.telemetry.trace import new_trace_id

            trace_id = new_trace_id()
            blocked = False
            if proposed < current:
                # Scale-down: drain-victim-ack-then-patch.  Victims
                # close admission and finish their generations BEFORE
                # the retarget drops them from the plan and the
                # Deployment patch deletes their pods.  No ack inside
                # the budget -> no actuation this tick (the started
                # drain keeps running; next tick retries and patches).
                try:
                    drain = self.drain_victims(
                        current, proposed, trace=trace_id
                    )
                except Exception as e:
                    # A safety interlock fails CLOSED: if the drain
                    # handshake itself broke (plan fetch raised, a
                    # bug), the patch is blocked this tick — never
                    # "drain skipped, delete anyway".
                    drain = {"victims": [], "acked": False,
                             "error": str(e)}
                if not drain["acked"]:
                    reason += "; victim drain not acked (retry next tick)"
                    blocked = True
            if not blocked:
                # Prewarm FIRST (same ordering as the training lane's
                # zero-stall handshake): a joining replica warms its
                # bucketed forwards before the retarget routes traffic.
                try:
                    self.coordinator.set_prewarm(
                        proposed, trace_id=trace_id
                    )
                except Exception:
                    pass  # advisory; the retarget still scales
                try:
                    self.coordinator.set_target_world(
                        proposed, trace_id=trace_id
                    )
                    actuated = True
                    self._m_actuations.inc(
                        direction="up" if proposed > current else "down"
                    )
                    if self.on_scale is not None:
                        try:
                            self.on_scale(current, proposed)
                        except Exception:
                            pass  # kube glue best-effort; journal stands
                except Exception as e:
                    reason += f"; retarget failed ({e})"
        entry = {
            "lane": "serving",
            "dry_run": {
                "current": current,
                "proposed": proposed,
                "diff": proposed - current,
            },
            "observed": obs,
            "actuated": actuated,
            "reason": reason,
            "trace_id": trace_id,
        }
        if drain is not None:
            entry["drain"] = drain
        self.decision_log.append(entry)
        del self.decision_log[: -self.decision_log_max]
        data = {k: v for k, v in entry.items() if k != "trace_id"}
        self._recorder.record("autoscaler.decision", data, trace=trace_id)
        return entry


def kube_replica_glue(cluster, job):
    """``ServingLane.on_scale`` glue for a deployed fleet: push the
    decided replica count into the serving replica Deployment through
    ``Cluster.update_serving_replicas`` (the bounded-conflict-retry
    ``update_parallelism`` idiom), so a retarget does not only move the coordinator target
    while the pods stay as they were.  Best-effort by the lane's contract (on_scale
    failures are swallowed there; the journal entry stands either
    way), but a retry exhaustion is still logged here so a wedged
    Deployment is visible."""

    def on_scale(old: int, new: int) -> None:
        try:
            if not cluster.update_serving_replicas(job, new):
                print(
                    f"[edl-serving] no serving Deployment for "
                    f"{job.name!r}; replica retarget {old}->{new} only "
                    "moved the coordinator target"
                )
        except Exception as e:
            print(
                f"[edl-serving] serving replica PUT {old}->{new} for "
                f"{job.name!r} failed: {e}"
            )

    return on_scale


def attach_serving_lane(autoscaler, lane: ServingLane) -> ServingLane:
    """Ride a ServingLane on a training ``Autoscaler``'s tick: every
    ``run_once`` of the training lane also ticks the serving lane, so
    one control loop owns both workloads (the Pathways posture —
    training and serving as one substrate).  Decisions flow into the
    AUTOSCALER's decision log too, so operators read
    one journal."""
    lanes = getattr(autoscaler, "serving_lanes", None)
    if lanes is None:
        lanes = autoscaler.serving_lanes = []
        orig = autoscaler.run_once

        def run_once(*args, **kwargs):
            plan = orig(*args, **kwargs)
            for sl in list(autoscaler.serving_lanes):
                try:
                    entry = sl.run_once()
                except Exception:
                    entry = None
                if entry is not None:
                    autoscaler.decision_log.append(entry)
                    del autoscaler.decision_log[
                        : -autoscaler.decision_log_max
                    ]
            return plan

        autoscaler.run_once = run_once
    lanes.append(lane)
    return lane
