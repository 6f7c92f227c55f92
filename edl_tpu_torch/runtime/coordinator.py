"""The elastic coordinator (a copy of ``edl_tpu/runtime/coordinator.py``).

What it keeps is *membership truth*:

- which trainers are alive (heartbeats with a deadline)
- the **generation number** — bumped on every change of the active
  members or the target
- the agreed target world size (written by the autoscaler's actuation)
  and the legal sizes the plan quantizes to
- the checkpoint index (latest durable step)
- the advisory prewarm hint

Trainers poll ``plan()`` between steps; when the plan's generation
differs from theirs they enter the resize barrier (flush, re-form the
world, restore — ``runtime/elastic.py``).  ``LocalCoordinator`` is the
in-process implementation; ``runtime/coord_service.py`` speaks the same
interface over HTTP.

Members also ship cumulative telemetry snapshots and flight-recorder
tails (``report_telemetry``); ``telemetry()`` serves the merge, and
``metrics_text`` renders it with the coordinator snapshot as Prometheus
text.  Plan rebuilds and evictions are journaled in the coordinator's
own flight recorder (``coord.*`` events).  Plans carry causal-trace ids.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from edl_tpu_torch.telemetry import (
    FlightRecorder,
    TelemetryAggregator,
    coord_snapshot_gauges,
    merge_snapshots,
    render_prometheus,
)
from edl_tpu_torch.telemetry.trace import new_trace_id


@dataclass(frozen=True)
class ElasticPlan:
    """What every trainer must agree on to form a world."""

    generation: int
    world_size: int
    #: member trainer ids in rank order (rank = index)
    members: tuple
    #: step to restore from when joining this generation (-1: fresh init)
    restore_step: int = -1
    #: member addresses in rank order (host:port of each trainer pod) —
    #: rank 0's address seeds the ``torch.distributed`` rendezvous when the
    #: world spans processes (the launcher's world_builder)
    addresses: tuple = ()
    #: EVERY registered live member (active + standby) at plan time.
    #: The resize flush reads this to decide whether a collective flush
    #: is safe: model-sharded state can only be gathered if every
    #: old-world member is still alive to dispatch the collective
    #: (an evicted/dead one never would — the flush would hang).
    alive: tuple = ()
    #: ADVISORY world size the autoscaler plans to actuate next (0 =
    #: none).  Announced via ``set_prewarm`` BEFORE the retarget/PUT so
    #: trainers AOT-warm exactly the incoming size's step executable
    #: while still stepping at the current one; it rides the plan the
    #: trainers already poll, so the hint costs zero extra round-trips.
    #: Never changes the generation — an updated hint must not push
    #: trainers through a resize barrier.
    prewarm: int = 0
    #: coordinator-stamped stop step for THIS generation's resize: the
    #: last world step any member reported (heartbeat piggyback /
    #: checkpoint reports) plus ``stop_margin`` at plan-rebuild time;
    #: -1 when no step was ever reported.  ADVISORY/JOURNAL ONLY: the
    #: data-plane agreement is the honored boundary — heartbeat lag
    #: makes this stamp stale by up to one cadence, and honoring a
    #: stale stamp below the agreement would re-introduce the
    #: poll-skew teardown race (min(stamped, agreed) floored at the
    #: agreement reduces to the agreement exactly).  Its job is making
    #: the scale-down timeline reconstructible from the journal alone
    #: (``coord.plan`` events + the autoscaler decision log).
    stop_step: int = -1
    #: causal-trace correlation id of the decision that produced THIS
    #: generation (autoscaler-minted and delivered with the retarget /
    #: prewarm hint; coordinator-minted for join/evict/leave rebuilds).
    #: Every member journals the events of its resize under it
    #: (``edl_tpu_torch.telemetry.trace``).
    trace_id: str = ""
    #: trace id of the UPCOMING decision announced via the prewarm
    #: hint (same generation — advisory, like ``prewarm`` itself), so
    #: the background AOT warm journals under the decision that asked
    #: for it before the retarget even lands
    prewarm_trace: str = ""


@dataclass
class _Member:
    trainer_id: str
    last_heartbeat: float
    joined_generation: int
    acked_generation: int = -1
    address: str = ""
    #: slice-replica index for multi-host topologies (one trainer
    #: replica = ``hosts_per_replica`` pods, the per-replica Indexed
    #: Job's pods); None for single-host replicas
    replica: Optional[int] = None
    #: host index within the replica (the Job completion index) —
    #: fixes intra-replica rank order
    host: Optional[int] = None


class LocalCoordinator:
    """Thread-safe in-process coordinator.

    Heartbeat liveness replaces etcd leases: a member that misses
    ``heartbeat_timeout`` seconds is evicted and the generation bumps
    (failure detection)."""

    def __init__(
        self,
        target_world: int = 1,
        max_world: int = 0,
        heartbeat_timeout: float = 10.0,
        legal_sizes: Optional[List[int]] = None,
        clock: Callable[[], float] = time.monotonic,
        hosts_per_replica: int = 1,
    ):
        """``legal_sizes``: world sizes the runtime may form (from
        ``TrainingJob.legal_world_sizes()`` — divisors of the global
        batch within [min,max]).  The plan quantizes
        down to the largest legal size <= min(members, target); with no
        legal size small enough the plan's world_size is 0 and trainers
        hold at the barrier until membership recovers.

        ``hosts_per_replica``: pods per trainer replica (>1 for
        multi-host slice topologies like v5e-16, where one replica is
        an Indexed Job of ``hosts`` pods).  The plan then counts
        REPLICAS in ``world_size``/targets/legal sizes while
        ``members``/``addresses`` list every pod in replica-major,
        host-minor rank order; only replicas with all their hosts
        registered can join the active world."""
        self._lock = threading.Condition()
        self._members: Dict[str, _Member] = {}
        self._generation = 0
        self._target_world = target_world
        self._max_world = max_world or target_world
        self._heartbeat_timeout = heartbeat_timeout
        # None = every size legal; [] = NO legal size (world_size pins to
        # 0 and trainers hold) — distinct on purpose.
        self._legal_sizes = (
            sorted(set(legal_sizes)) if legal_sizes is not None else None
        )
        if hosts_per_replica < 1:
            raise ValueError("hosts_per_replica must be >= 1")
        self._hosts_per_replica = hosts_per_replica
        self._clock = clock
        self._latest_checkpoint_step = -1
        #: last world step any member reported (heartbeat piggyback or
        #: checkpoint report) — the base of the plan's stop_step stamp
        self._latest_step = -1
        #: steps past the last reported step the stamped stop allows
        #: for in-flight progress (heartbeat-cadence staleness)
        self.stop_margin = 16
        self._prewarm = 0
        #: trace id of the decision currently being actuated (set by
        #: the prewarm announcement and/or the retarget itself;
        #: consumed by the retarget's plan rebuild)
        self._pending_trace = ""
        #: trace id of an actuation still CONVERGING: a scale-up's
        #: retarget rebuild fires before the new pods exist, so the
        #: join rebuilds that grow the world toward the target are part
        #: of the same decision and must journal under the same id —
        #: cleared once the world reaches the target
        self._actuation_trace = ""
        self._plan: Optional[ElasticPlan] = None
        self._resize_log: List[dict] = []
        #: target training steps (passes x batches-per-pass); 0 = open-ended
        self._target_steps = 0
        #: set when a trainer reports the job finished its passes
        self._completed = False
        self._completed_step = -1
        #: cluster-wide telemetry: members POST cumulative registry
        #: snapshots on their heartbeat cadence; the merge is
        #: idempotent, so a restarted coordinator reconverges as soon as
        #: each live member's next report lands
        self._telemetry = TelemetryAggregator(clock=self._clock)
        #: coordinator-side flight recorder: plan rebuilds, evictions,
        #: and the event tails members ship with their reports
        self._recorder = FlightRecorder(capacity=1024)
        #: newest generation whose full ack was journaled
        self._acked_journaled = -1

    # -- membership (trainer-facing) ----------------------------------------
    def register(
        self,
        trainer_id: str,
        address: str = "",
        replica: Optional[int] = None,
        host: Optional[int] = None,
    ) -> ElasticPlan:
        """Join the job.  Bumps the generation; returns the new plan.
        ``address`` is the member's reachable host:port (used to seed
        the JAX process group when the world spans pods).  Multi-host
        pods pass their replica index and host (completion) index; a
        re-register (rejoin after eviction) preserves a previously
        declared placement when the new call omits it."""
        with self._lock:
            now = self._clock()
            prev = self._members.get(trainer_id)
            if prev is not None:
                if replica is None:
                    replica = prev.replica
                if host is None:
                    host = prev.host
            self._members[trainer_id] = _Member(
                trainer_id=trainer_id,
                last_heartbeat=now,
                joined_generation=self._generation + 1,
                address=address,
                replica=replica,
                host=host,
            )
            self._rebuild_plan("join")
            return self._plan

    def deregister(self, trainer_id: str):
        """Graceful leave (scale-down actuation or shutdown)."""
        with self._lock:
            if self._members.pop(trainer_id, None) is not None:
                self._rebuild_plan("leave")

    def heartbeat(self, trainer_id: str, step: int = -1) -> dict:
        """``step``: the member's last completed world step, piggybacked
        on the beat so retarget plans can stamp a stop_step without an
        extra round-trip (-1 = not reported).  Returns the server's
        wall clock: with the client's t0/t1 stamps around the beat it
        is the NTP-style offset sample the merged-timeline clock
        alignment runs on (``telemetry.trace.ClockOffsetEstimator``) —
        piggybacked so alignment costs zero extra round-trips."""
        with self._lock:
            m = self._members.get(trainer_id)
            if m is None:
                raise KeyError(f"unknown trainer {trainer_id}")
            m.last_heartbeat = self._clock()
            if step > self._latest_step:
                self._latest_step = step
        return {"server_time": time.time()}

    def ack_generation(self, trainer_id: str, generation: int):
        """Trainer reports it has re-formed its world into
        ``generation`` (``wait_all_acked`` and ``metrics()``'s
        ``world_acked`` read the acks).  The moment every planned member
        has acked the current generation is journaled once
        (``coord.world_acked``, under the plan's trace): the signal a
        scale-down waits on before it deletes pods."""
        with self._lock:
            m = self._members.get(trainer_id)
            if m is not None:
                m.acked_generation = generation
                self._lock.notify_all()
            plan = self._plan
            if (
                plan is not None
                and plan.generation > self._acked_journaled
                and all(
                    self._members[t].acked_generation >= plan.generation
                    for t in plan.members
                    if t in self._members
                )
            ):
                self._acked_journaled = plan.generation
                self._recorder.record(
                    "coord.world_acked",
                    {"world_size": plan.world_size},
                    generation=plan.generation,
                    trace=plan.trace_id,
                )

    # -- control (autoscaler/controller-facing) -----------------------------
    def set_target_world(self, n: int, trace_id: str = ""):
        """The autoscaler's actuation: declare the desired trainer
        count, clamped to ``max_world``; the plan shrinks immediately
        (members beyond the target drop out of rank order) or grows as
        new trainers register.  ``trace_id``: the autoscaler decision's
        causal-trace id — stamped into the retargeted plan so every
        member journals the whole resize under it."""
        if n < 1:
            raise ValueError("target world must be >= 1")
        with self._lock:
            n = min(n, self._max_world)
            if n == self._target_world:
                # No-op retarget: the decision actuated a target
                # already in place, so no resize will carry its id —
                # drop any pending trace rather than letting a LATER
                # unrelated retarget consume it (mis-attribution).
                self._pending_trace = ""
                return
            if trace_id:
                self._pending_trace = trace_id
            else:
                # A traceless retarget is a DIFFERENT actor (operator
                # CLI, chaos monkey, controller reconcile): a trace
                # staged by an earlier decision — a prewarm whose PUT
                # gave up, a scale-up whose pods never arrived — must
                # not bleed onto this resize or its converging joins.
                self._pending_trace = ""
                self._actuation_trace = ""
            if self._pending_trace:
                # A scale-up retarget usually fires before its pods
                # exist: the active world is unchanged, the rebuild
                # below early-returns, and the decision only LANDS at
                # the later join rebuilds — which must then journal
                # under this id (see _rebuild_plan's join branch).
                self._actuation_trace = self._pending_trace
            self._target_world = n
            self._rebuild_plan("retarget")
            # The pending trace never outlives the retarget call it was
            # staged for: when the rebuild early-returned (active world
            # unchanged — pods not yet registered), leaving it set
            # would hand this decision's id to a LATER unrelated
            # traceless retarget (confirmed mis-attribution); the
            # converging joins use _actuation_trace instead.
            self._pending_trace = ""

    def set_prewarm(self, n: int, trace_id: str = ""):
        """Announce the world size the autoscaler intends to actuate
        next (the prewarm half of the actuation handshake).  Purely
        advisory: the current plan is re-issued with the hint attached
        — SAME generation, so no trainer resizes — and trainers
        background-compile that size's step executable so the upcoming
        retarget's resize window contains zero cold compiles.  ``0``
        clears the hint.  ``trace_id`` rides the hint (and is held for
        the retarget it announces) so the warm-ahead work journals
        under the decision that asked for it."""
        if n < 0:
            raise ValueError("prewarm world must be >= 0")
        with self._lock:
            n = min(n, self._max_world)
            if trace_id:
                self._pending_trace = trace_id
            if n == self._prewarm and not trace_id:
                return
            self._prewarm = n
            if self._plan is not None and (
                self._plan.prewarm != n
                or (trace_id and self._plan.prewarm_trace != trace_id)
            ):
                from dataclasses import replace

                self._plan = replace(
                    self._plan,
                    prewarm=n,
                    prewarm_trace=trace_id or self._plan.prewarm_trace,
                )
            self._lock.notify_all()

    def prewarm_hint(self) -> int:
        with self._lock:
            return self._prewarm

    def evict_dead(self) -> List[str]:
        """Evict members that missed their heartbeat deadline.  Returns
        evicted ids.  Called periodically by whoever hosts the
        coordinator (controller loop or the service's timer)."""
        with self._lock:
            now = self._clock()
            dead = [
                tid
                for tid, m in self._members.items()
                if now - m.last_heartbeat > self._heartbeat_timeout
            ]
            for tid in dead:
                del self._members[tid]
                # Lease expiry evicts the telemetry too: a dead replica's
                # frozen snapshot would otherwise pin the merged gauges
                # and haunt every quantile window.  A live-but-evicted
                # member registers again and re-reports its cumulative
                # snapshot, so the drop always reconverges.
                self._telemetry.drop_source(tid)
            if dead:
                self._recorder.record(
                    "coord.evict",
                    {"members": sorted(dead)},
                    generation=self._generation,
                )
                self._rebuild_plan("evict")
            return dead

    def report_checkpoint(self, step: int):
        with self._lock:
            if step > self._latest_checkpoint_step:
                self._latest_checkpoint_step = step
            if step > self._latest_step:
                self._latest_step = step
            if self._target_steps and step >= self._target_steps:
                self._completed = True
                self._completed_step = max(self._completed_step, step)

    def report_complete(self, step: int = -1):
        """A trainer finished the job's passes (launcher's end-of-run
        signal).  The controller polls ``completed`` and fires
        ``mark_succeeded``."""
        with self._lock:
            self._completed = True
            self._completed_step = max(self._completed_step, step)
            self._lock.notify_all()

    def set_target_steps(self, n: int):
        with self._lock:
            self._target_steps = max(0, n)

    # -- queries ------------------------------------------------------------
    def plan(self) -> Optional[ElasticPlan]:
        with self._lock:
            return self._plan

    def target_world(self) -> int:
        """Current actuation target — lets the controller reconcile the
        handshake level-triggered (POST a new target only on drift)."""
        with self._lock:
            return self._target_world

    def completed(self) -> bool:
        with self._lock:
            return self._completed

    def metrics(self) -> dict:
        """Observability snapshot (served at the coordinator's /metrics)."""
        with self._lock:
            plan = self._plan
            world_acked = bool(plan) and all(
                self._members[t].acked_generation >= plan.generation
                for t in plan.members
                if t in self._members
            )
            return {
                "generation": self._generation,
                "world_size": self._plan.world_size if self._plan else 0,
                #: every current-plan member has re-meshed into this
                #: generation — the scale-down actuation's "victims have
                #: quiesced" signal (the new world cannot form until the
                #: old one fully left the agreed stop boundary)
                "world_acked": world_acked,
                "acked_members": sum(
                    1
                    for m in self._members.values()
                    if m.acked_generation >= 0
                ),
                "members": len(self._members),
                "standby": max(
                    0,
                    len(self._members)
                    - (self._plan.world_size if self._plan else 0),
                ),
                "target_world": self._target_world,
                "prewarm": self._prewarm,
                "target_steps": self._target_steps,
                "latest_checkpoint_step": self._latest_checkpoint_step,
                "resizes": len(self._resize_log),
                "completed": self._completed,
                "completed_step": self._completed_step,
            }

    def metrics_text(self) -> str:
        """Prometheus text exposition: the coordinator snapshot as
        gauges, merged with the members' reported telemetry (the JSON
        shape stays behind ``?format=json``).  The aggregator read holds
        the lock: a scrape can run beside a member's POST /telemetry,
        and the aggregator has no lock of its own."""
        with self._lock:
            members = self._telemetry.merged()
        merged = merge_snapshots([coord_snapshot_gauges(self.metrics()), members])
        return render_prometheus(merged)

    # -- telemetry (member-facing) ------------------------------------------
    def report_telemetry(
        self,
        trainer_id: str,
        snapshot: Optional[dict] = None,
        seq: int = 0,
        events: Optional[List[dict]] = None,
        boot: str = "",
        clock: Optional[dict] = None,
    ) -> None:
        """Ingest one member's cumulative telemetry report: the registry
        snapshot (merged idempotently by (trainer_id, boot, seq): a
        restarted member's fresh boot supersedes its dead incarnation's
        high seq), a tail of its flight-recorder events, and its
        clock-offset estimate."""
        with self._lock:
            fresh = self._telemetry.report(
                trainer_id, snapshot or {}, seq, boot=boot, clock=clock
            )
        if fresh and events:
            self._recorder.record(
                "coord.telemetry",
                {"source": trainer_id, "events": len(events)},
            )
            self._recorder.ingest(events, origin=trainer_id)

    def telemetry(self) -> dict:
        """Merged cluster telemetry, the derived goodput signals, the
        recent flight events and the per-member clock offsets."""
        with self._lock:
            merged = self._telemetry.merged()
            rate = self._telemetry.step_rate()
            cost = self._telemetry.resize_cost_seconds(merged=merged)
            goodput = self._telemetry.goodput(merged=merged)
            sources = self._telemetry.sources()
            offsets = self._telemetry.clock_offsets()
        return {
            "merged": merged,
            "step_rate": rate,
            "resize_cost_seconds": cost,
            "goodput": goodput,
            "sources": sources,
            "clock_offsets": offsets,
            "events": [e.to_dict() for e in self._recorder.events(256)],
        }

    def recorder(self) -> FlightRecorder:
        return self._recorder

    def generation(self) -> int:
        with self._lock:
            return self._generation

    def members(self) -> List[str]:
        with self._lock:
            return list(self._members)

    def latest_checkpoint_step(self) -> int:
        with self._lock:
            return self._latest_checkpoint_step

    def resize_log(self) -> List[dict]:
        with self._lock:
            return list(self._resize_log)

    def wait_all_acked(self, generation: int, timeout: float = 60.0) -> bool:
        """Block until every planned member acked ``generation`` (the
        resize barrier's coordinator side)."""
        deadline = self._clock() + timeout
        with self._lock:
            while True:
                plan = self._plan
                if plan is not None and plan.generation >= generation:
                    acked = all(
                        self._members[tid].acked_generation >= plan.generation
                        for tid in plan.members
                        if tid in self._members
                    )
                    if acked:
                        return True
                remaining = deadline - self._clock()
                if remaining <= 0:
                    return False
                self._lock.wait(timeout=min(remaining, 0.5))

    # -- internals ----------------------------------------------------------
    def _active_members(self) -> tuple:
        """(active_member_ids, world_size_in_replicas) under the current
        membership/target.  Caller holds the lock.

        Single-host (hosts_per_replica == 1): rank order is join order
        (dict preserves insertion); members beyond the target wait in
        standby (they keep heartbeating and join when the target grows
        — the analog of pending pods the kube Job controller folds in).

        Multi-host: members group into replicas by their declared
        replica index; only COMPLETE replicas (all ``hosts`` pods
        present with distinct host indexes) are eligible, taken in
        ascending replica order (the actuation creates/deletes the
        highest-indexed per-replica Jobs, so lowest-indexed survive
        scale-down).  Rank order is replica-major, host-minor — the
        order a multi-host replica's workers expect."""
        hosts = self._hosts_per_replica
        if hosts == 1:
            alive = list(self._members)
            world = min(len(alive), self._target_world, self._max_world)
            if self._legal_sizes is not None:
                fitting = [s for s in self._legal_sizes if s <= world]
                world = fitting[-1] if fitting else 0
            return tuple(alive[:world]), world

        groups: Dict[int, Dict[int, str]] = {}
        for tid, m in self._members.items():
            if m.replica is None or m.host is None:
                continue  # unplaceable pod: cannot join a sliced world
            groups.setdefault(m.replica, {})[m.host] = tid
        complete = sorted(
            r
            for r, g in groups.items()
            if len(g) == hosts and set(g) == set(range(hosts))
        )
        world = min(len(complete), self._target_world, self._max_world)
        if self._legal_sizes is not None:
            fitting = [s for s in self._legal_sizes if s <= world]
            world = fitting[-1] if fitting else 0
        active = tuple(
            groups[r][h] for r in complete[:world] for h in range(hosts)
        )
        return active, world

    def _rebuild_plan(self, reason: str):
        """Recompute the plan after any membership/target change.  Caller
        holds the lock."""
        active, world = self._active_members()
        addresses = tuple(self._members[t].address for t in active)
        if (
            self._plan is not None
            and self._plan.members == active
            and self._plan.addresses == addresses
            and self._plan.world_size == world
        ):
            # The change touched only standby membership (e.g. an extra
            # pod joined beyond the target, or a standby left): the
            # active world is identical, so don't force trainers
            # through a needless resize barrier.
            self._lock.notify_all()
            return
        self._generation += 1
        stop_step = (
            self._latest_step + self.stop_margin
            if self._latest_step >= 0
            else -1
        )
        # The causal-trace id of THIS generation: a retarget consumes
        # the actuation's pending trace (delivered with the prewarm
        # hint and/or the retarget PUT); every other rebuild — join,
        # leave, eviction — mints its own, so membership-churn resizes
        # are just as traceable as autoscaler decisions.  Random, and
        # carried only in non-identity journal fields: chaos-soak
        # digests stay bit-identical.
        prev_world = self._plan.world_size if self._plan else 0
        if reason == "retarget" and self._pending_trace:
            trace = self._pending_trace
            self._pending_trace = ""
        elif (
            reason == "join"
            and self._actuation_trace
            and prev_world < world <= self._target_world
        ):
            # A pod registering while a traced scale-up is still
            # converging IS that actuation landing: the generation the
            # members actually resize into must journal under the
            # decision's id, not a fresh join-minted one.
            trace = self._actuation_trace
        else:
            # Other join/evict/leave rebuilds mint their own id and do
            # NOT consume a pending actuation trace: a pod registering
            # between the prewarm announcement and the retarget must
            # not steal the decision's id from the retarget it tags.
            trace = new_trace_id()
        if world >= self._target_world:
            self._actuation_trace = ""  # actuation converged
        self._plan = ElasticPlan(
            generation=self._generation,
            world_size=world,
            members=active,
            restore_step=self._latest_checkpoint_step,
            addresses=addresses,
            alive=tuple(self._members),
            prewarm=self._prewarm,
            stop_step=stop_step,
            trace_id=trace,
        )
        self._resize_log.append(
            {
                "t": self._clock(),
                "generation": self._generation,
                "reason": reason,
                "world_size": world,
                "members": active,
            }
        )
        self._recorder.record(
            "coord.plan",
            {
                "reason": reason,
                "world_size": world,
                "members": list(active),
                "stop_step": stop_step,
            },
            generation=self._generation,
            trace=trace,
        )
        self._lock.notify_all()
