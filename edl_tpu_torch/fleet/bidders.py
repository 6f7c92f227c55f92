"""Bidders: how jobs present themselves to the GPU market (a copy of
``edl_tpu/fleet/bidders.py``).

The Pathways posture (PAPERS.md): one coordinator substrate, and every
workload — N elastic trainers, M serving fleets — is just a *bidder*
against one GPU inventory.  Each tick a bidder distills its live state
into a ``Bid``:

- **Training** bids carry a *priority* and a *utility* — observed
  goodput-per-chip from the goodput ledger, read back through the job
  coordinator's merged telemetry.  Utility is the market's objective;
  priority orders preemption (lowest tier is preempted first) and
  growth tiers.
- **Serving** bids carry a *hard requirement*: the replica count the
  SLO band demands right now (p95-over-window-delta / queue depth /
  rejections — exactly the ``ServingLane`` signals, reused via
  ``ServingLane.desired_replicas``).  The arbiter satisfies
  requirements before any training growth, preempting trainers when
  the free pool is short.

Bidders also own their *actuation transport* (the job's coordinator
client): the arbiter decides, then each bidder actuates its own
transition with the standard prewarm→retarget handshake under the
decision's minted trace id, and training scale-downs wait for the
consensus victim-drain ack before their chips are considered free.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from edl_tpu_torch.autoscaler.scaler import wait_for_world_ack


@dataclass
class Bid:
    """One bidder's stake in this tick's market, in whole *units*
    (trainer replicas / serving replicas), each worth
    ``chips_per_unit`` chips."""

    name: str
    kind: str  # "training" | "serving"
    priority: int
    chips_per_unit: int
    min_units: int
    max_units: int
    current_units: int
    #: ascending legal unit counts within [min, max]; empty = every
    #: integer (slice/batch quantization, same contract as
    #: ``JobView.legal_sizes``)
    legal_units: List[int] = field(default_factory=list)
    #: serving hard constraint: units the SLO band demands NOW (the
    #: arbiter treats it as a floor it preempts for); None for training
    required_units: Optional[int] = None
    #: training objective: observed goodput-per-chip (None = not yet
    #: observable — falls back behind every measured bid in its tier)
    utility: Optional[float] = None
    #: raw observation inputs (journaled into the decision entry)
    observed: Dict[str, object] = field(default_factory=dict)
    elastic: bool = True

    # -- legal-size stepping (mirrors JobView's) -----------------------------
    def _sizes(self) -> List[int]:
        if self.legal_units:
            return [
                u
                for u in self.legal_units
                if self.min_units <= u <= self.max_units
            ]
        return list(range(self.min_units, self.max_units + 1))

    def next_up(self, units: int) -> Optional[int]:
        for s in self._sizes():
            if s > units:
                return s
        return None

    def next_down(self, units: int) -> Optional[int]:
        for s in reversed(self._sizes()):
            if s < units:
                return s
        return None

    def clamp(self, units: int) -> int:
        sizes = self._sizes()
        if not sizes:
            return units
        best = sizes[0]
        for s in sizes:
            if s <= units:
                best = s
        return best

    def fulfillment(self) -> float:
        if self.min_units >= self.max_units:
            return 1.0
        return (self.current_units - self.min_units) / (
            self.max_units - self.min_units
        )


class TrainingBidder:
    """One elastic training job as a market participant.

    ``coordinator``: the JOB's coordinator client (Local or HTTP —
    ``metrics``/``telemetry``/``set_prewarm``/``set_target_world``).
    Utility = goodput_frac / allocated chips: a job already holding
    many chips needs a proportionally better ledger to out-bid a
    starved one — the diminishing-returns shape that makes the market
    spread chips instead of feeding one job forever.

    ``resize``: moves the job's trainer workload to a unit count (the
    controller's ``_fleet_resize``).  With it, a scale-up PUTs before
    its retarget and a scale-down PUTs once ``wait_drain`` returns, as
    the single-cluster lane orders them; without it (the reference's
    bidder) only the coordinator's target moves."""

    def __init__(
        self,
        name: str,
        coordinator,
        *,
        priority: int = 0,
        chips_per_unit: int = 1,
        min_units: int = 1,
        max_units: int = 1,
        legal_units: Optional[List[int]] = None,
        observe: Optional[Callable[[], dict]] = None,
        resize: Optional[Callable[[int], object]] = None,
    ):
        if min_units < 1 or max_units < min_units:
            raise ValueError(
                f"bad unit bounds [{min_units}, {max_units}] for {name}"
            )
        self.name = name
        self.kind = "training"
        self.coordinator = coordinator
        self.priority = priority
        self.chips_per_unit = max(1, chips_per_unit)
        self.min_units = min_units
        self.max_units = max_units
        self.legal_units = sorted(set(legal_units)) if legal_units else []
        self._observe = observe
        self.resize = resize
        #: units of this bidder's last ``collect`` (what an actuation
        #: moves from); a scale-down's size until ``wait_drain`` PUTs it
        self._held: Optional[int] = None
        self._shrink_to: Optional[int] = None

    @staticmethod
    def from_job(job, coordinator, resize=None) -> "TrainingBidder":
        """Bidder from a validated ``TrainingJob`` spec: priority,
        [min, max], GPUs per trainer, and batch-quantized legal sizes all
        come from the resource model."""
        t = job.spec.trainer
        return TrainingBidder(
            job.name,
            coordinator,
            priority=job.spec.priority,
            chips_per_unit=max(1, job.gpu_per_trainer()),
            min_units=t.min_instance,
            max_units=t.max_instance,
            legal_units=job.legal_world_sizes(),
            resize=resize,
        )

    def _observation(self) -> dict:
        if self._observe is not None:
            return self._observe() or {}
        try:
            tel = self.coordinator.telemetry() or {}
        except Exception:
            return {}
        goodput = tel.get("goodput") or {}
        return {
            "goodput_frac": goodput.get("frac"),
            "step_rate": tel.get("step_rate"),
            "resize_cost_seconds": tel.get("resize_cost_seconds"),
        }

    def collect(self) -> Optional[Bid]:
        """One observation -> Bid; None when the coordinator is
        unreachable (an unobservable job must keep its holding — the
        market never reallocates what it cannot see)."""
        try:
            snap = self.coordinator.metrics() or {}
        except Exception:
            return None
        current = int(
            snap.get("target_world") or snap.get("world_size") or 0
        ) or self.min_units
        self._held = current
        obs = self._observation()
        frac = obs.get("goodput_frac")
        utility = None
        if frac is not None:
            chips = max(1, current * self.chips_per_unit)
            utility = float(frac) / chips
        return Bid(
            name=self.name,
            kind=self.kind,
            priority=self.priority,
            chips_per_unit=self.chips_per_unit,
            min_units=self.min_units,
            max_units=self.max_units,
            current_units=current,
            legal_units=list(self.legal_units),
            utility=utility,
            observed=obs,
            elastic=self.min_units < self.max_units,
        )

    # -- actuation ----------------------------------------------------------
    def actuate(self, units: int, trace_id: str) -> bool:
        """Prewarm-then-retarget under the decision's trace id (the
        same zero-stall handshake as the single-job lanes).  A
        scale-up's workload grows first; a failed PUT is a failed
        actuation."""
        held = self._held if self._held is not None else units
        if self.resize is not None and units > held:
            try:
                self.resize(units)
            except Exception:
                return False
        try:
            hint = getattr(self.coordinator, "set_prewarm", None)
            if hint is not None:
                hint(units, trace_id=trace_id)
        except Exception:
            pass  # advisory; the retarget still scales
        try:
            self.coordinator.set_target_world(units, trace_id=trace_id)
        except Exception:
            return False
        self._shrink_to = units if units < held else None
        return True

    def wait_drain(self, timeout: float) -> bool:
        """Consensus-clean scale-down: block until every member of the
        retargeted world acked the new generation (victims left at the
        data-plane-agreed stop boundary).  The arbiter calls this
        before treating a preempted trainer's chips as free.  Then the
        workload shrinks — after a timeout too, as the single-cluster
        lane deletes its victims then; a failed PUT is left to the
        controller's ``reconcile_targets``."""
        acked = wait_for_world_ack(self.coordinator, timeout)
        units, self._shrink_to = self._shrink_to, None
        if self.resize is not None and units is not None:
            try:
                self.resize(units)
            except Exception:
                pass
        return acked


class ServingBidder:
    """One serving fleet as a market participant: the ``ServingLane``'s
    SLO band becomes a HARD requirement the arbiter must cover.

    ``lane``: an ``autoscaler.serving.ServingLane`` — supplies the
    observation (p95-over-window-delta / queue / rejections), the
    band decision with its hysteresis (``desired_replicas``), the
    replica bounds, and the serving coordinator used for actuation.
    Do NOT also ``attach_serving_lane`` the same lane: in market mode
    the arbiter owns actuation (a lane attached to the plain
    autoscaler tick would race it).

    ``signals``: optional override returning the observation dict
    (scripted storms in tests/bench)."""

    def __init__(
        self,
        name: str,
        lane,
        *,
        priority: int = 0,
        chips_per_unit: int = 1,
        signals: Optional[Callable[[], dict]] = None,
    ):
        self.name = name
        self.kind = "serving"
        self.lane = lane
        self.priority = priority
        self.chips_per_unit = max(1, chips_per_unit)
        self.min_units = lane.min_replicas
        self.max_units = lane.max_replicas
        self._signals = signals

    @property
    def coordinator(self):
        return self.lane.coordinator

    def collect(self) -> Optional[Bid]:
        try:
            obs = (
                self._signals() if self._signals is not None
                else self.lane.observe()
            ) or {}
            current = self.lane.current_replicas()
        except Exception:
            return None
        required, reason = self.lane.desired_replicas(obs, current)
        obs = dict(obs)
        obs["slo_reason"] = reason
        return Bid(
            name=self.name,
            kind=self.kind,
            priority=self.priority,
            chips_per_unit=self.chips_per_unit,
            min_units=self.min_units,
            max_units=self.max_units,
            current_units=current,
            required_units=required,
            observed=obs,
            elastic=self.min_units < self.max_units,
        )

    def actuate(self, units: int, trace_id: str) -> bool:
        try:
            before = self.lane.current_replicas()
        except Exception:
            before = self.min_units
        if units < before:
            # Drain-victim-ack-then-patch: the market's serving
            # scale-downs follow the SAME contract as the lane's — and
            # ride the lane's live KV migration: drain_victims picks a surviving replica and each
            # victim hands its in-flight generations over instead of
            # waiting them out, so a market preemption acks in O(KV
            # transfer), not O(longest generation).  No ack -> no
            # actuation this tick; the arbiter's fixed point
            # re-proposes next tick and the already-started drain is
            # usually finished by then.
            try:
                drain = self.lane.drain_victims(before, units)
            except Exception:
                # fail CLOSED: a broken drain handshake blocks the
                # actuation (the arbiter re-proposes next tick) —
                # never "drain skipped, delete anyway"
                drain = {"acked": False}
            if not drain.get("acked", True):
                return False
        try:
            self.coordinator.set_prewarm(units, trace_id=trace_id)
        except Exception:
            pass  # advisory
        try:
            self.coordinator.set_target_world(units, trace_id=trace_id)
        except Exception:
            return False
        if self.lane.on_scale is not None:
            try:
                self.lane.on_scale(before, units)
            except Exception:
                pass  # kube glue is best-effort; the retarget stands
        return True

    def wait_drain(self, timeout: float) -> bool:
        """Serving scale-downs drain their victims inside ``actuate``
        (drain-ack-then-patch), so by the time the arbiter asks, the
        chips are genuinely free — no extra wait."""
        return True
