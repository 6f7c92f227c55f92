"""The cluster arbiter: one GPU market, iterated to a fixed point (a
copy of ``edl_tpu/fleet/arbiter.py``).

This is the reference's cluster-wide dry run (``scaleAllJobsDryRun``,
``pkg/autoscaler.go:296-337``) generalized to N elastic ``TrainingJob``
bidders + M serving-fleet bidders against ONE GPU inventory, with three
deltas the reference could never have:

- **Serving SLOs are hard constraints.**  A serving bid's
  ``required_units`` (the ``ServingLane`` band decision) is a floor the
  market covers BEFORE any training growth — and when the free pool is
  short, by preempting the lowest-priority elastic trainer one legal
  step at a time (the Varuna/Bamboo/Oobleck posture: training churn is
  steady state, and the consensus bus makes the scale-down safe).
- **Goodput-per-chip is the objective.**  Training growth within a
  priority tier goes to the bid with the best observed
  goodput-per-chip (the goodput ledger, read back through the coordinator's
  merged telemetry) — measured throughput, not declared ranges, breaks
  ties for the marginal chip.
- **GPUs come back.**  When the spike clears (the serving band's
  hysteresis drops its requirement), the serving fleet sheds to its
  requirement and the freed chips flow back to the starved trainers in
  the same fixed point.

``arbitrate`` is a pure function over ``Bid``s (trivially golden-
testable, like ``algorithm.scale_all_jobs_dry_run``); ``FleetArbiter``
is the per-tick loop that collects bids, arbitrates, actuates each
transition under its own minted trace id (prewarm→retarget; training
scale-downs wait for the consensus victim-drain ack before their chips
move), and journals per-job decision entries + ``fleet.*`` flight
events.

Convergence argument (the oscillation-freedom test pins it): within a
tick the serving requirements are fixed inputs, pass 1 only moves
serving allocations TOWARD their requirement (preempting trainers
downward), and pass 2 only grows training into genuinely free chips
AFTER every requirement is satisfied — so no pass can undo another's
work, every pass strictly reduces a bounded potential (unmet serving
chips, then free chips), and the loop reaches a fixed point in
O(total steps) iterations.  The reference's unbounded loop could
livelock at full utilization; ``max_iters`` caps ours anyway.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

from edl_tpu_torch.fleet.bidders import Bid, ServingBidder, TrainingBidder
from edl_tpu_torch.fleet.inventory import ChipInventory


@dataclass
class Arbitration:
    """Outcome of one pure market pass."""

    #: name -> decided unit count (EVERY bid gets an entry)
    targets: Dict[str, int]
    #: chips left unallocated after the fixed point
    free_chips: int
    #: preemption records: lowest-priority trainers stepped down to
    #: cover serving requirements, in decision order
    preemptions: List[dict] = field(default_factory=list)
    #: serving bids whose requirement could NOT be covered even after
    #: exhausting every preemptible trainer: name -> unmet chips
    unmet: Dict[str, int] = field(default_factory=dict)
    iterations: int = 0


def _fulfillment_at(b: Bid, units: int) -> float:
    """Fulfillment against the EVOLVING dry-run allocation (a key
    computed from the stale ``current_units`` would let one job absorb
    the whole free pool / one victim shed to its floor before a peer
    is touched)."""
    if b.min_units >= b.max_units:
        return 1.0
    return (units - b.min_units) / (b.max_units - b.min_units)


def _utility_at(b: Bid, units: int) -> Optional[float]:
    """Goodput-per-chip re-scaled to the evolving allocation: the
    observed ledger fraction is what it is, but the chips dividing it
    grow as the dry run grants steps — the diminishing-returns shape
    that spreads chips instead of feeding one job forever."""
    if b.utility is None:
        return None
    return b.utility * b.current_units / max(1, units)


def _growth_key(b: Bid, units: int):
    """Training growth order: priority tier first, then measured
    goodput-per-chip at the evolving allocation (unmeasured bids sort
    behind measured ones in their tier), then least-fulfilled, then
    name (determinism)."""
    u = _utility_at(b, units)
    return (
        -b.priority,
        0 if u is not None else 1,
        -(u or 0.0),
        _fulfillment_at(b, units),
        b.name,
    )


def _victim_key(b: Bid, units: int):
    """Preemption order: LOWEST priority first, most-fulfilled (at the
    evolving allocation) first — shed from the job farthest above its
    floor, rotating to its peer once they even out — then name."""
    return (b.priority, -_fulfillment_at(b, units), b.name)


def _serving_want(s: Bid) -> int:
    """The units a serving bid's SLO band demands, bounded to its
    [min, max] — THE requirement all three consumers (satisfaction
    pass, growth reservation, unmet report) must agree on."""
    return min(max(s.required_units or s.min_units, s.min_units), s.max_units)


def arbitrate(
    bids: Sequence[Bid],
    total_chips: int,
    max_iters: int = 256,
) -> Arbitration:
    """Iterate allocate/evict to a fixed point over ``total_chips``.

    ``bids``' ``current_units`` seed the allocation (clamped to each
    bid's legal sizes); the returned targets are absolute unit counts.
    Serving requirements are satisfied in priority order before any
    training growth; preemption stops at every trainer's min."""
    bids = list(bids)
    by_name: Dict[str, Bid] = {}
    for b in bids:
        if b.name in by_name:
            raise ValueError(f"duplicate bid name {b.name!r}")
        by_name[b.name] = b
    alloc: Dict[str, int] = {
        b.name: max(b.min_units, b.clamp(b.current_units)) for b in bids
    }
    serving = sorted(
        (b for b in bids if b.kind == "serving"),
        key=lambda b: (-b.priority, b.name),
    )
    training = [b for b in bids if b.kind == "training"]
    free = total_chips - sum(
        alloc[b.name] * b.chips_per_unit for b in bids
    )
    preemptions: List[dict] = []

    def preempt_for(need_chips: int, beneficiary: str) -> int:
        """Shed lowest-priority elastic trainers (one legal step at a
        time) until ``need_chips`` are freed or nothing preemptible is
        left.  Returns chips freed.  Serving requirements are HARD:
        any elastic trainer above its min is a candidate — priority
        only orders who goes first (training growth, by contrast,
        never preempts anyone: it consumes free chips only)."""
        freed = 0
        while freed < need_chips:
            victims = sorted(
                (
                    t
                    for t in training
                    if t.elastic and alloc[t.name] > t.min_units
                ),
                key=lambda t: _victim_key(t, alloc[t.name]),
            )
            if not victims:
                break
            v = victims[0]
            down = v.next_down(alloc[v.name])
            if down is None or down < v.min_units:
                break
            step_chips = (alloc[v.name] - down) * v.chips_per_unit
            preemptions.append(
                {
                    "victim": v.name,
                    "priority": v.priority,
                    "beneficiary": beneficiary,
                    "units_from": alloc[v.name],
                    "units_to": down,
                    "chips_freed": step_chips,
                }
            )
            alloc[v.name] = down
            freed += step_chips
        return freed

    iters = 0
    for iters in range(1, max_iters + 1):
        changed = False

        # -- pass 0: oversubscription (inventory shrank under us) -----------
        while free < 0:
            got = preempt_for(-free, beneficiary="(inventory)")
            free += got
            if got:
                changed = True
            if free < 0 and got == 0:
                # Trainers exhausted: shed serving above min too.
                sheddable = sorted(
                    (s for s in serving if alloc[s.name] > s.min_units),
                    key=lambda s: (s.priority, s.name),
                )
                if not sheddable:
                    break
                s = sheddable[0]
                down = s.next_down(alloc[s.name])
                if down is None:
                    break
                free += (alloc[s.name] - down) * s.chips_per_unit
                alloc[s.name] = down
                changed = True

        # -- pass 1: serving hard constraints, priority order ---------------
        for s in serving:
            want = s.clamp(_serving_want(s))
            # Spike cleared: give chips back down to the requirement.
            while alloc[s.name] > want:
                down = s.next_down(alloc[s.name])
                if down is None or down < want:
                    break
                free += (alloc[s.name] - down) * s.chips_per_unit
                alloc[s.name] = down
                changed = True
            # Spike: grow to the requirement, preempting when short.
            while alloc[s.name] < want:
                up = s.next_up(alloc[s.name])
                if up is None or up > s.max_units:
                    break
                need = (up - alloc[s.name]) * s.chips_per_unit
                if free < need:
                    free += preempt_for(need - free, beneficiary=s.name)
                if free < need:
                    break  # nothing left to evict: requirement unmet
                alloc[s.name] = up
                free -= need
                changed = True

        # -- pass 2: training growth into genuinely free chips --------------
        reserved = sum(
            max(0, (_serving_want(s) - alloc[s.name]) * s.chips_per_unit)
            for s in serving
        )
        # ONE legal step per iteration, to the first bid (strict
        # priority tiers, then goodput-per-chip, then least-fulfilled)
        # whose whole step fits: higher tiers saturate before a lower
        # tier sees a chip ("starved low-priority job" is a designed
        # outcome, not a fairness bug), but a step the leading bid
        # CANNOT take (quantized step bigger than the remaining free)
        # falls through to the next — holding chips no tick can assign
        # is pure waste.  Never eats room an unmet serving requirement
        # is still waiting for.
        for t in sorted(
            training, key=lambda t: _growth_key(t, alloc[t.name])
        ):
            if not t.elastic:
                continue
            up = t.next_up(alloc[t.name])
            if up is None or up > t.max_units:
                continue
            need = (up - alloc[t.name]) * t.chips_per_unit
            if need <= free - reserved:
                alloc[t.name] = up
                free -= need
                changed = True
                break

        if not changed:
            break

    unmet = {}
    for s in serving:
        short = (_serving_want(s) - alloc[s.name]) * s.chips_per_unit
        if short > 0:
            unmet[s.name] = short
    return Arbitration(
        targets=dict(alloc),
        free_chips=free,
        preemptions=preemptions,
        unmet=unmet,
        iterations=iters,
    )


class FleetArbiter:
    """The per-tick market loop.

    ``inventory``: a ``ChipInventory``, an int (total market chips), or
    a zero-arg callable returning either — called every tick so a live
    cluster's inquiry feeds the market fresh
    (``ChipInventory.from_cluster_resource(cluster.inquiry_resource())``
    composed with the non-fleet holding subtraction).

    Ride it on the training autoscaler's 5s tick with
    ``attach_fleet(autoscaler, arbiter)`` (the Pathways shape: one
    control loop owns every workload), or drive ``run_once`` directly.
    """

    def __init__(
        self,
        inventory: Union[ChipInventory, int, Callable],
        trainers: Sequence[TrainingBidder] = (),
        fleets: Sequence[ServingBidder] = (),
        *,
        victim_drain_timeout: float = 20.0,
    ):
        self._inventory_src = inventory
        self.trainers: List[TrainingBidder] = list(trainers)
        self.fleets: List[ServingBidder] = list(fleets)
        self.victim_drain_timeout = victim_drain_timeout
        self.inventory = ChipInventory()
        self.decision_log: List[dict] = []
        self.decision_log_max = 256
        #: tick-indexed chips-over-time series (bounded): one
        #: ``inventory.snapshot()`` per tick — the bench storm's
        #: chips_over_time and the ``fleet`` command read this
        self.history: List[dict] = []
        self.history_max = 512

        from edl_tpu_torch import telemetry

        self._recorder = telemetry.get_recorder()
        reg = telemetry.get_registry()
        self._m_ticks = reg.counter("edl_autoscaler_ticks_total")
        self._m_decisions = reg.counter("edl_fleet_decisions_total")
        self._m_preemptions = reg.counter("edl_fleet_preemptions_total")
        self._g_total = reg.gauge("edl_fleet_chips_total")
        self._g_free = reg.gauge("edl_fleet_chips_free")
        self._g_alloc = reg.gauge("edl_fleet_chips_allocated")
        self._g_target = reg.gauge("edl_fleet_target_units")
        self._g_unmet = reg.gauge("edl_fleet_unmet_demand_chips")

    # -- wiring --------------------------------------------------------------
    def add_trainer(self, bidder: TrainingBidder) -> TrainingBidder:
        self.trainers.append(bidder)
        return bidder

    def add_fleet(self, bidder: ServingBidder) -> ServingBidder:
        self.fleets.append(bidder)
        return bidder

    def _bidders(self) -> list:
        return list(self.trainers) + list(self.fleets)

    def _market_chips(self) -> int:
        src = self._inventory_src
        if callable(src):
            src = src()
        if isinstance(src, ChipInventory):
            mine = {b.name for b in self._bidders()}
            outside = sum(
                h for n, h in src.holdings.items() if n not in mine
            )
            self.inventory.total_chips = src.total_chips
            # Park the non-fleet usage so the snapshot stays honest —
            # including CLEARING holdings the fresh inquiry no longer
            # reports (an outside workload that finished must not
            # haunt chips_over_time as phantom allocation).
            for n in list(self.inventory.holdings):
                if n not in mine and n not in src.holdings:
                    self.inventory.set_holding(n, 0)
            for n, h in src.holdings.items():
                if n not in mine:
                    self.inventory.set_holding(n, h)
            return max(0, src.total_chips - outside)
        self.inventory.total_chips = int(src)
        return int(src)

    # -- one decision cycle ---------------------------------------------------
    def run_once(self) -> Optional[dict]:
        """Collect -> arbitrate -> actuate -> journal.  Returns the
        tick record (None when no bidder was observable)."""
        market_chips = self._market_chips()
        bids: List[Bid] = []
        blind: List[str] = []
        for bidder in self._bidders():
            bid = bidder.collect()
            if bid is None:
                # Unreachable coordinator: its holding is frozen — the
                # market neither grows nor preempts what it can't see.
                # Reserve its LAST-KNOWN holding (the previous tick's
                # actuated allocation, still physically occupied by
                # its pods), floored at min units for a job never yet
                # observed.
                blind.append(bidder.name)
                market_chips -= max(
                    bidder.min_units * bidder.chips_per_unit,
                    self.inventory.holdings.get(bidder.name, 0),
                )
                continue
            bids.append(bid)
        if not bids:
            return None
        self._m_ticks.inc()
        result = arbitrate(bids, market_chips)
        outcome = self._actuate(bids, result)
        record = self._journal(bids, result, outcome, blind)
        return record

    # -- actuation ------------------------------------------------------------
    def _actuate(self, bids: List[Bid], result: Arbitration) -> Dict[str, dict]:
        """Apply the arbitration: every transition gets its OWN minted
        trace id; scale-downs actuate first (training ones wait for the
        consensus victim-drain ack) so the chips a scale-up consumes
        are genuinely free before its retarget lands."""
        from edl_tpu_torch.telemetry.trace import new_trace_id

        by_name = {}
        for b in self._bidders():
            by_name[b.name] = b
        diffs = []
        for bid in bids:
            target = result.targets.get(bid.name, bid.current_units)
            if target != bid.current_units:
                diffs.append((bid, target))
        # downs first; training downs before serving downs (the freed
        # training chips are what the serving growth is waiting for)
        diffs.sort(
            key=lambda bt: (
                0 if bt[1] < bt[0].current_units else 1,
                0 if bt[0].kind == "training" else 1,
                bt[0].name,
            )
        )
        outcome: Dict[str, dict] = {}
        for bid, target in diffs:
            bidder = by_name[bid.name]
            trace_id = new_trace_id()
            ok = bidder.actuate(target, trace_id)
            # drained is only meaningful for an ACTUATED scale-down; a
            # failed retarget never quiesced anything.
            drained = bool(ok)
            if ok and target < bid.current_units:
                drained = bidder.wait_drain(self.victim_drain_timeout)
            outcome[bid.name] = {
                "actuated": ok,
                "drained": drained,
                "trace_id": trace_id,
            }
        return outcome

    # -- journaling -----------------------------------------------------------
    def _journal(
        self,
        bids: List[Bid],
        result: Arbitration,
        outcome: Dict[str, dict],
        blind: List[str],
    ) -> dict:
        preempted_by = {
            p["victim"]: p["beneficiary"] for p in result.preemptions
        }
        decisions = []
        for bid in bids:
            target = result.targets.get(bid.name, bid.current_units)
            out = outcome.get(bid.name, {})
            diff = target - bid.current_units
            # The recorded holding must track what the pods PHYSICALLY
            # occupy: a transition whose retarget failed leaves the
            # old allocation standing (and the blind-coordinator
            # freeze reserves this holding next tick — recording the
            # unactuated target would fabricate free chips).
            held = (
                target
                if (diff == 0 or out.get("actuated"))
                else bid.current_units
            )
            if bid.name in preempted_by:
                reason = (
                    f"preempted by {preempted_by[bid.name]} "
                    "(serving SLO hard constraint)"
                )
            elif bid.kind == "serving" and bid.name in result.unmet:
                reason = (
                    f"SLO requirement unmet by {result.unmet[bid.name]} "
                    "chips (nothing left to evict)"
                )
            elif diff > 0:
                reason = f"market grants +{diff} units"
            elif diff < 0:
                reason = f"market sheds {-diff} units"
            else:
                reason = "at fixed point"
            entry = {
                "lane": "fleet",
                "job": bid.name,
                "kind": bid.kind,
                "priority": bid.priority,
                "dry_run": {
                    "current": bid.current_units,
                    "proposed": target,
                    "diff": diff,
                },
                "observed": dict(bid.observed),
                "required_units": bid.required_units,
                "utility": bid.utility,
                "preempted": bid.name in preempted_by,
                "preempted_by": preempted_by.get(bid.name),
                "actuated": bool(out.get("actuated")),
                "drained": out.get("drained", True),
                "reason": reason,
                "trace_id": out.get("trace_id", ""),
            }
            decisions.append(entry)
            self.decision_log.append(entry)
            self._m_decisions.inc()
            data = {k: v for k, v in entry.items() if k != "trace_id"}
            self._recorder.record(
                "fleet.decision", data, trace=entry["trace_id"]
            )
            self._g_alloc.set(
                held * bid.chips_per_unit, job=bid.name
            )
            self._g_target.set(target, job=bid.name)
            if bid.kind == "serving":
                self._g_unmet.set(
                    result.unmet.get(bid.name, 0), job=bid.name
                )
            self.inventory.set_holding(
                bid.name, held * bid.chips_per_unit
            )
        del self.decision_log[: -self.decision_log_max]
        for p in result.preemptions:
            self._m_preemptions.inc(job=p["victim"])
            self._recorder.record(
                "fleet.preempt",
                dict(
                    p,
                    victim_trace=outcome.get(p["victim"], {}).get(
                        "trace_id", ""
                    ),
                    beneficiary_trace=outcome.get(
                        p["beneficiary"], {}
                    ).get("trace_id", ""),
                ),
            )
        self._g_total.set(self.inventory.total_chips)
        self._g_free.set(result.free_chips)
        record = {
            "decisions": decisions,
            "preemptions": result.preemptions,
            "unmet": result.unmet,
            "free_chips": result.free_chips,
            "iterations": result.iterations,
            "blind": blind,
            "inventory": self.inventory.snapshot(),
        }
        self.history.append(record["inventory"])
        del self.history[: -self.history_max]
        return record


def attach_fleet(autoscaler, arbiter: FleetArbiter) -> FleetArbiter:
    """Host the arbiter on a training ``Autoscaler``'s 5s tick (the
    same shape as ``attach_serving_lane``): every ``run_once`` of the
    scaler also runs the market, and the market's per-job decisions
    flow into the AUTOSCALER's decision log so the merged timeline and
    operators read one journal.  The arbiter supersedes the scaler's
    per-job planning for jobs it owns — don't also register those jobs
    with the single-cluster lane."""
    if getattr(autoscaler, "fleet_arbiter", None) is not None:
        raise ValueError("an arbiter is already attached")
    autoscaler.fleet_arbiter = arbiter
    orig = autoscaler.run_once

    def run_once(*args, **kwargs):
        plan = orig(*args, **kwargs)
        try:
            record = arbiter.run_once()
        except Exception:
            # Keep the scaler tick alive, but NEVER silently: a
            # persistently failing market must not just vanish from
            # the decision log while the autoscaler looks healthy.
            import traceback

            traceback.print_exc()
            record = None
        if record is not None:
            for entry in record["decisions"]:
                autoscaler.decision_log.append(entry)
            del autoscaler.decision_log[: -autoscaler.decision_log_max]
        return plan

    autoscaler.run_once = run_once
    return arbiter
