"""The elastic training loop: re-form, restore, resume (counterpart of
``edl_tpu/runtime/elastic.py``).

1. Between steps, the trainer compares its generation with the
   coordinator's plan.
2. On a generation change it runs the **resize barrier**:
   a. graceful resize: finish the in-flight steps, flush a fresh
      checkpoint to host DRAM (no lost steps); failure recovery: the
      state is gone, so fall back to the last interval checkpoint and
      *replay* — the global batch is a pure function of ``(seed,
      step)``, so the replay is bit-identical;
   b. re-form the world (``world_builder``: a fresh ``torch.distributed``
      group per generation, see ``edl_tpu_torch.launcher``);
   c. restore the state: from the flush, the store, the durable spill,
      or — in a world of several processes — agreed across members,
      with only the leaves a member lacks moving over TCP
      (``checkpoint/transfer.py``);
   d. ack the generation and resume stepping.
3. Every ``checkpoint_interval`` steps it snapshots asynchronously.

One process drives one device.  Without a ``world_builder`` the world
is this process alone (world size 1); a member of a larger world is one
process of a group the builder forms.  The JAX package's in-process
multi-device mesh has no counterpart.

Steady state is a bounded async pipeline (``pipeline_depth``, default
2): a background ``BatchStager`` builds and copies the batches of the
next steps while the device computes, each step's loss is copied to the
host behind the step and read with a lag (waiting for that step alone,
``_HostCopy``), and the host tracks the step counter itself.  The
blocking reads happen only at the sanctioned sync points (harvest lag,
checkpoint interval, resize-barrier entry, hold, run exit), and the loss
stream is bit-identical with the pipeline on or off — including across
resizes and replays.

What the JAX package warms ahead (``precompile``, ``prewarm_async``, the
resize's overlapped step compile) has no counterpart: eager PyTorch
compiles nothing per world size.  A coordinator prewarm hint is
accepted, recorded (``prewarm_hints``) and journaled (``prewarm.hint``,
once per hint and trace id), and does nothing else.
``ResizeEvent.compiles`` counts the kernel libraries ``ops/_build.py``
loaded inside the barrier, the port's form of "a warm resize compiles
nothing".

The heartbeat thread also ships this process's cumulative telemetry
snapshot to the coordinator every ``telemetry_interval`` seconds (the
JAX ``_maybe_report_telemetry`` / ``_report_telemetry``): the step rate
the autoscaler's decision log observes comes from these reports.

The loop journals its lifecycle in the flight recorder (``resize`` with
its phase breakdown, ``step.first``, ``world.broken``,
``consensus.quiesce``, ``prewarm.hint``), and a fresh generation's plan
trace id is the recorder's ambient trace from the plan poll to the
first step of that generation, so every event a member journals on the
way through a resize carries the id of the decision that caused it.
``EDL_PROFILE_DIR`` turns on bounded ``torch.profiler`` windows around
chosen steps and resizes (``utils/profiling.py``).

Chaos rides the store (``store.chaos``, a ``FaultSchedule``): the loop
consults ``prewarm.hint.dropped`` (a dropped hint is counted in
``dropped_prewarm_hints`` and neither recorded nor journaled) and
``consensus.vote.delayed`` (this member's plan polls are suppressed for
arg seconds at a retarget, and the stop must still reach it in-band),
and hands the schedule to the batch stager, the restore transfer and the
watchdog (``consensus.watchdog.trip``).  ``chaos.ChaosMonkey`` drives
the membership and storage faults through ``run(on_step=...)``.

Not ported yet: the sharded checkpoint fabric (``_fabric_*``).
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
import uuid
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from edl_tpu_torch import DeviceLike, generator, resolve_device
from edl_tpu_torch.checkpoint.hostdram import (
    HostCheckpoint,
    HostDRAMStore,
    LeafSpec,
    leaf_specs,
)
from edl_tpu_torch.consensus import (
    BusPoisonError,
    CollectiveWatchdog,
    StepBus,
    timing_bucket,
)
from edl_tpu_torch.models.base import ModelDef
from edl_tpu_torch.runtime.coordinator import ElasticPlan
from edl_tpu_torch.runtime.data import BatchStager, ShardedDataIterator
from edl_tpu_torch.runtime.train import Trainer, TrainState, leaf_template
from edl_tpu_torch.utils.profiling import StepProfiler, annotate


class FatalWorldError(RuntimeError):
    """Unrecoverable world-management failure (e.g. a process group that
    teardown could not remove): the process must exit loudly so the pod
    restarts and rejoins — holding and retrying would only repeat the
    failure.  ``_rebuild_world`` re-raises it where ordinary formation
    errors degrade to hold-and-retry."""


@dataclass
class ResizeEvent:
    generation: int
    world_size: int
    seconds: float
    restored_step: int
    replayed_steps: int
    graceful: bool
    #: how this process got its state: "init" (fresh), "local" (own
    #: store or spill, no cross-member traffic), "broadcast" (this
    #: member moved state over the restore-transfer wire)
    restore_source: str = ""
    #: per-phase breakdown of ``seconds``: flush, world_formation,
    #: restore (serial), and flush_bg / flush_bg_join (the background
    #: hash + spill, and the residual the window waited for it)
    phase_seconds: Dict[str, float] = None
    #: restore-transfer accounting (multi-process resizes)
    transfer: Optional[Dict[str, Any]] = None
    #: the data-plane-agreed stop step this resize honored; -1 when
    #: the resize was immediate (no live multi-member world)
    stop_step: int = -1
    #: kernel libraries loaded (built) inside the barrier
    compiles: int = 0


@dataclass
class StepRecord:
    step: int
    generation: int
    world_size: int
    loss: float
    #: lag-corrected wall seconds attributed to this step: completion
    #: to completion against the previous harvested step (the first
    #: step of a generation: completion minus its own dispatch)
    seconds: float


class _HostCopy:
    """A tensor's value on its way to the host.  On CUDA the copy goes
    into pinned memory on the current stream, right behind the work
    that produces it, and an event marks its arrival: reading it waits
    for that event alone — not for the steps queued after it, as
    ``.item()`` or ``.tolist()`` on the card would (they synchronize the
    whole stream).  This is what lets harvest lag behind dispatch."""

    def __init__(self, t: torch.Tensor):
        t = t.detach()
        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def value(self) -> torch.Tensor:
        """The host tensor, once the copy has landed (blocking)."""
        if self.event is not None:
            self.event.synchronize()
        return self.host


@dataclass
class _InFlightStep:
    """A dispatched-but-unharvested step."""

    step: int
    generation: int
    world_size: int
    t_dispatch: float
    #: the step's loss on its way to the host
    loss: Any = field(repr=False, default=None)
    #: the step's reduced control word, on its way to the host likewise
    bus_word: Any = field(repr=False, default=None)


def _kernel_builds() -> int:
    """Kernel libraries loaded (and built if needed) in this process."""
    from edl_tpu_torch.ops import _build

    return len(_build._libs)


class ElasticTrainer:
    """The elastic runtime of one process driving one device.

    ``world_builder``: optional hook invoked with each new
    ``ElasticPlan`` to (re)form the process group; it returns the
    generation's ``World`` (``edl_tpu_torch.launcher``), or None when
    this process is not a member.  With it, a plan that does not
    include any of this process's ``heartbeat_ids`` puts it in
    *standby*: world torn down, polling until a later plan readmits it.
    Without it the world is this process alone."""

    #: how long run() holds at a barrier with no formable world, and how
    #: often it re-polls meanwhile
    BARRIER_TIMEOUT = 300.0
    BARRIER_POLL_INTERVAL = 0.05
    #: restore transfer: chunk size and how long either side waits on a
    #: silent peer
    TRANSFER_CHUNK_BYTES = 64 << 20
    TRANSFER_TIMEOUT = 120.0
    HEARTBEAT_INTERVAL = 2.0
    #: broken-world recoveries pinned at one step before the error is
    #: taken for a bug, not churn
    MAX_WORLD_FAILURES = 3

    def __init__(
        self,
        model: ModelDef,
        data: ShardedDataIterator,
        coordinator,
        store: Optional[HostDRAMStore] = None,
        lr: float = 1e-3,
        device: DeviceLike = None,
        checkpoint_interval: int = 50,
        seed: int = 0,
        world_builder: Optional[Callable[[ElasticPlan], Any]] = None,
    ):
        self.model = model
        self.data = data
        self.coordinator = coordinator
        self.store = store if store is not None else HostDRAMStore()
        self.lr = lr
        self.device = resolve_device(device)
        self.checkpoint_interval = checkpoint_interval
        self.seed = seed
        self.world_builder = world_builder

        self.generation = -1
        self._standby = False
        self._world_members: tuple = ()
        #: this generation's World (from world_builder), None in-process
        self.world = None
        self.trainer: Optional[Trainer] = None
        self.state: Optional[TrainState] = None
        #: (parameter names, leaf specs) of the model's state
        self._template: Optional[Tuple[List[str], List[LeafSpec]]] = None
        self._last_completed_step = 0
        self._holding = False
        #: max in-flight (dispatched, metrics unharvested) steps; 0 =
        #: the synchronous loop
        self.pipeline_depth: int = 2
        #: host-side step counter, synced from ``restored_step`` at
        #: every resize, advanced at dispatch
        self._host_step = 0
        self._pending: deque = deque()
        self._stager: Optional[BatchStager] = None
        self._on_step: Optional[Callable[[StepRecord], None]] = None
        self._last_harvest_t: Optional[float] = None
        #: the step a failure surfaced at harvest belongs to
        self._harvest_failed_step: Optional[int] = None
        #: set by maybe_resize when a barrier is due but in-flight steps
        #: must drain first (run() drains and re-polls)
        self._defer_for_drain = False
        self.pipeline_stats: Dict[str, float] = {
            "stage_s": 0.0,
            "dispatch_s": 0.0,
            "device_wait_s": 0.0,
            "max_in_flight": 0,
            "dispatched": 0,
        }
        #: member ids this process keeps alive at the coordinator
        self.heartbeat_ids: List[str] = []
        #: re-sent when an evicted member rejoins
        self.register_address: str = ""
        self.register_replica: Optional[int] = None
        self.register_host: Optional[int] = None
        self._leaving = False
        self._last_heartbeat = 0.0
        self._hb_thread = None
        self._hb_stop = None
        #: set when the live process group broke mid-step: hold until
        #: the coordinator bumps the generation
        self._await_new_generation = False
        self._world_failures = 0
        self._last_failed_step = -1
        #: coordinator prewarm hints seen (nothing to warm; see the
        #: module docstring)
        self.prewarm_hints: List[int] = []
        #: prewarm hints dropped by chaos[prewarm.hint.dropped]
        self.dropped_prewarm_hints = 0

        self.resize_events: List[ResizeEvent] = []
        self.history: List[StepRecord] = []
        self.on_resize: Optional[Callable[[ResizeEvent], None]] = None
        #: opt-in device-trace windows (``EDL_PROFILE_DIR``)
        self.profiler = StepProfiler(device=self.device)

        from edl_tpu_torch import telemetry
        from edl_tpu_torch.telemetry.ledger import GoodputLedger

        self.telemetry = telemetry.get_registry()
        self._m_steps = self.telemetry.counter("edl_steps_total")
        self._m_step_seconds = self.telemetry.histogram("edl_step_seconds")
        self._m_resizes = self.telemetry.counter("edl_resizes_total")
        self._m_resize_seconds = self.telemetry.histogram("edl_resize_seconds")
        self._m_resize_phase = self.telemetry.histogram("edl_resize_phase_seconds")
        self._m_replayed = self.telemetry.counter("edl_replayed_steps_total")
        self._m_world_breaks = self.telemetry.counter("edl_world_breaks_total")
        self._m_pipeline_depth = self.telemetry.gauge("edl_pipeline_depth")
        self._m_device_wait = self.telemetry.histogram("edl_device_wait_seconds")
        self._m_quiesce = self.telemetry.histogram("edl_consensus_quiesce_seconds")
        self._m_reports = self.telemetry.counter("edl_telemetry_reports_total")
        self.recorder = telemetry.get_recorder()
        self.ledger = GoodputLedger(registry=self.telemetry)
        #: seconds between telemetry reports on the heartbeat thread
        #: (``EDL_TELEMETRY_INTERVAL``); <= 0 ships none
        self.telemetry_interval: float = 5.0
        self._last_telemetry_report = 0.0
        self._telemetry_seq = 0
        self._events_sent_seq = 0
        #: serializes reports (the heartbeat thread's and a flush from
        #: the step thread): seq order must be snapshot order
        self._report_lock = threading.Lock()
        #: per-process nonce: tells the aggregator a restarted trainer
        #: (fresh seq stream) from a stale replay of the old one's
        self._telemetry_boot = uuid.uuid4().hex
        #: steps below this replay work already completed before a
        #: non-graceful fallback (the ledger's "replaying" bound)
        self._replay_until = 0
        #: causal tracing: the generation whose first harvested step
        #: closes a resize's chain, and that chain's trace id (captured
        #: at resize time: the ambient trace may already belong to a
        #: newer plan when a pending step harvests in the next barrier)
        self._first_step_trace_gen: Optional[int] = None
        self._first_step_trace = ""
        #: (hint, trace) pairs already journaled as prewarm.hint
        self._hint_journaled: set = set()

        # -- data-plane step agreement (edl_tpu_torch.consensus) -------------
        #: reduce the per-step control word on multi-member worlds
        self.consensus_bus: bool = True
        #: watchdog deadline on harvest-time fetches; None = auto: 120 s
        #: under a world_builder, disabled in-process
        self.collective_timeout: Optional[float] = None
        self._bus = StepBus(registry=self.telemetry, recorder=self.recorder)
        self._watchdog: Optional[CollectiveWatchdog] = None
        self._stop_gen = 0
        self._stop_agreed: Optional[int] = None
        self._vote_cast_gen = 0
        self._bus_seen_gen = 0
        self._last_step_bucket = 0
        self._quiesce_t0: Optional[float] = None
        self._quiesce_deadline: Optional[float] = None
        self._quiesce_recorded = False
        #: chaos[consensus.vote.delayed]: plan polls suppressed until
        #: this monotonic deadline (a simulated poll skew)
        self._poll_suppress_until = 0.0

    # -- the world ------------------------------------------------------------
    def _world_size(self) -> int:
        return self.trainer.world if self.trainer is not None else 1

    def _rank(self) -> int:
        return self.world.rank if self.world is not None else 0

    def _new_trainer(self) -> Trainer:
        """This generation's Trainer (the world's group when it has more
        than one member)."""
        group = self.world.group if self.world is not None and self.world.size > 1 else None
        self.trainer = Trainer(
            self.model, lr=self.lr, device=self.device, seed=self.seed, process_group=group
        )
        return self.trainer

    def _clear_world(self) -> None:
        """Drop the trainer and everything staged for this world (the
        stager's in-flight copy is joined first)."""
        if self._stager is not None:
            self._stager.invalidate(join=True)
        self.trainer = None

    def _leaf_template(self) -> Tuple[List[str], List[LeafSpec]]:
        """Parameter names and leaf specs of the model's state (the
        schema checkpoints and the restore agreement share).  From the
        live state when there is one; else from the model's init,
        loaded onto the meta device (no device memory; one host init)."""
        if self._template is None:
            if self.state is not None:
                named = list(self.state.params.named_parameters())
            else:
                with warnings.catch_warnings():
                    # loading into meta tensors copies nothing, as meant
                    warnings.simplefilter("ignore")
                    module = self.model.train_params(
                        self.model.init_params(generator(self.seed)), "meta"
                    )
                named = list(module.named_parameters())
            specs = leaf_specs(leaf_template([p for _, p in named]))
            self._template = ([n for n, _ in named], specs)
        return self._template

    def _state_from_ckpt(self, trainer: Trainer, ckpt: HostCheckpoint) -> TrainState:
        names, _ = self._leaf_template()
        leaves = self.store.restore(ckpt, self.device)
        return trainer.state_from_leaves(ckpt.step, leaves, names)

    # -- fault injection ------------------------------------------------------
    def inject_failure(self):
        """Simulate losing the device state mid-run (e.g. a host dies):
        the module and the optimizer are dropped, and the next resize
        must fall back to the last checkpoint and replay.  In-flight
        pipelined steps are discarded (never harvested into history),
        so the replay accounting is the same with the pipeline on or
        off."""
        self.state = None
        self._pending.clear()
        self._reset_stop_state()
        if self._stager is not None:
            self._stager.invalidate()

    # -- resize barrier -------------------------------------------------------
    def _flush_begin(self, generation: int):
        """The split graceful flush: the device-to-host copy runs here
        (it must precede the world's teardown); crc and spill run on the
        returned background thread."""
        ckpt, bg = self.store.flush_sync(self.state, generation=generation)
        self.coordinator.report_checkpoint(int(ckpt.step))
        return ckpt, bg

    def _flush(self, generation: int) -> None:
        """Fully synchronous flush (standby): begin + join, surfacing a
        background hash/spill error."""
        _, bg = self._flush_begin(generation)
        if bg is not None:
            bg.join()
            if bg.edl_error is not None:
                raise bg.edl_error

    def _my_member_ids(self, plan: ElasticPlan) -> List[str]:
        """The plan members this process answers for: its
        ``heartbeat_ids``, or (none set, in-process) every member."""
        if self.heartbeat_ids:
            return [t for t in plan.members if t in self.heartbeat_ids]
        return list(plan.members)

    def _rebuild_world(self, plan: ElasticPlan) -> bool:
        """Re-form the process group for ``plan``.  False when
        formation failed (the caller holds and retries on the next,
        possibly fresher, plan)."""
        self._clear_world()
        self.world = None
        try:
            world = self.world_builder(plan)
        except FatalWorldError:
            raise
        except Exception:
            if getattr(self, "_last_form_err_gen", None) != plan.generation:
                self._last_form_err_gen = plan.generation
                traceback.print_exc()
            return False
        if world is None:
            return False
        self.world = world
        return True

    def _enter_standby(self, plan: ElasticPlan) -> None:
        """This process is not in ``plan``'s world: flush what it has,
        leave the old world, hold until readmitted."""
        self.ledger.transition("holding")
        self._finish_quiesce()
        self._reset_stop_state()
        if self.state is not None:
            try:
                self._flush(plan.generation)
            except Exception:
                # A peer death between plan and flush: the interval
                # checkpoint + replay covers it; survive to be readmitted.
                traceback.print_exc()
        self.state = None
        self._world_members = ()
        self._clear_world()
        if self.world_builder is not None:
            self.world_builder(plan)  # teardown only: not a member
        self.world = None
        self.generation = plan.generation
        self._standby = True
        # A standby member's chain ends here (it takes no first step).
        self.recorder.set_trace("")

    def _finish_overlap(
        self, flush_bg: Optional[threading.Thread], phases: Dict[str, float]
    ) -> None:
        """Join the flush's background hash/spill and record both its
        own duration and the residual the window waited for it."""
        if flush_bg is None:
            return
        t = time.perf_counter()
        flush_bg.join()
        phases["flush_bg_join"] = round(time.perf_counter() - t, 6)
        phases["flush_bg"] = round(flush_bg.edl_seconds, 6)
        if flush_bg.edl_error is not None:
            # The host copy landed and was restored from: no steps
            # lost, only durability degraded.
            err = flush_bg.edl_error
            print(
                "[edl] background flush hash/spill failed (DRAM "
                f"checkpoint intact; durable spill skipped): {err}",
                file=sys.stderr,
            )
            traceback.print_exception(type(err), err, err.__traceback__)

    def _resize(self, plan: ElasticPlan) -> bool:
        self.ledger.transition("resizing")
        t0 = time.perf_counter()
        builds0 = _kernel_builds()
        phases: Dict[str, float] = {}

        def _mark(name: str, since: float) -> float:
            now = time.perf_counter()
            phases[name] = round(now - since, 6)
            return now

        stop_step = self._effective_stop()
        if stop_step is None:
            stop_step = -1
        self._finish_quiesce()

        graceful = self.state is not None
        flushed: Optional[HostCheckpoint] = None
        flush_bg: Optional[threading.Thread] = None
        if graceful:
            self._leaf_template()  # from the live state, before it goes
            with annotate("resize/flush"):
                try:
                    flushed, flush_bg = self._flush_begin(plan.generation)
                except Exception:
                    # State poisoned by a peer death between the last
                    # step and this resize: degrade to checkpoint + replay.
                    traceback.print_exc()
                    graceful = False
        t_phase = _mark("flush", t0)

        if self.world_builder is not None:
            self.state = None
            with annotate("resize/world_formation"):
                formed = self._rebuild_world(plan)
            if not formed:
                self._finish_overlap(flush_bg, phases)
                return False
            t_phase = _mark("world_formation", t_phase)

        with annotate("resize/remesh"):
            trainer = self._new_trainer()
        # Only a FRESH flush (its background thread exists) restores
        # without the latest_verified() crc pass; a flush that deduped
        # against a stored checkpoint keeps the stored-snapshot check.
        flushed_fresh = flushed if flush_bg is not None else None
        transfer_stats = None
        with annotate("resize/restore"):
            if trainer.world > 1:
                from edl_tpu_torch.checkpoint.transfer import TransferError

                try:
                    state, restored_step, restore_source, transfer_stats = (
                        self._restore_multiprocess(trainer, flushed_fresh)
                    )
                except TransferError:
                    # World-consistent verdict (every member raises): fail
                    # this attempt, hold, retry with a fresh agreement.
                    traceback.print_exc()
                    self._finish_overlap(flush_bg, phases)
                    return False
            else:
                ckpt = flushed_fresh if flushed_fresh is not None else self._latest_or_disk()
                if ckpt is None:
                    state = trainer.init_state()
                    restored_step = 0
                    restore_source = "init"
                else:
                    state = self._state_from_ckpt(trainer, ckpt)
                    restored_step = int(ckpt.step)
                    restore_source = "local"
        self.state = state
        self._leaf_template()
        _mark("restore", t_phase)
        self._finish_overlap(flush_bg, phases)
        replayed = max(0, self._last_completed_step - restored_step)

        self._host_step = restored_step
        self._last_harvest_t = None
        self.ledger.split_resize(phases)
        self._replay_until = restored_step + replayed
        # The first post-resize step closes this plan's causal chain
        # (step.first journals in _harvest_one).
        self._first_step_trace_gen = plan.generation
        self._first_step_trace = plan.trace_id
        # Re-arm the profiler so a window can open around this
        # resize's first steps (EDL_PROFILE_EACH_RESIZE).
        self.profiler.note_resize()
        self.generation = plan.generation
        self._standby = False
        self._world_members = tuple(plan.members)
        seconds = time.perf_counter() - t0
        event = ResizeEvent(
            generation=plan.generation,
            world_size=plan.world_size,
            seconds=seconds,
            restored_step=restored_step,
            replayed_steps=replayed,
            graceful=graceful,
            restore_source=restore_source,
            phase_seconds=phases,
            transfer=transfer_stats,
            stop_step=stop_step,
            compiles=_kernel_builds() - builds0,
        )
        self.resize_events.append(event)
        self._m_resizes.inc(graceful=str(graceful).lower(), source=restore_source)
        self._m_resize_seconds.observe(seconds)
        for ph, s in phases.items():
            self._m_resize_phase.observe(s, phase=ph)
        if replayed:
            self._m_replayed.inc(replayed)
        # The event's identity (no timings) reconstructs a run's
        # resizes; the phase breakdown rides the timing field.
        timing = {"seconds": round(seconds, 6), "phases": phases}
        if transfer_stats:
            timing["transfer_seconds"] = transfer_stats.get("seconds")
        self.recorder.record(
            "resize",
            {
                "world_size": plan.world_size,
                "restored_step": restored_step,
                "replayed_steps": replayed,
                "graceful": graceful,
                "restore_source": restore_source,
                "stop_step": stop_step,
            },
            step=self._last_completed_step,
            generation=plan.generation,
            timing=timing,
        )
        if self.on_resize is not None:
            self.on_resize(event)
        # Ack only the members this process owns: acking for peers
        # would release the barrier before their world re-formed.
        for tid in self._my_member_ids(plan):
            self.coordinator.ack_generation(tid, plan.generation)
        self._reset_stop_state()
        return True

    def _latest_or_disk(self) -> Optional[HostCheckpoint]:
        """Newest verified DRAM checkpoint, else (a cold start: process
        restarted, DRAM empty) the durable spill.  A spill that exists
        but cannot be loaded raises: re-initializing over it would
        destroy the state the volume is there to keep."""
        ckpt = self.store.latest_verified()
        if ckpt is not None or not self.store.spill_dir:
            return ckpt
        try:
            ckpt = self.store.load_from_disk(self._leaf_template()[1])
        except FileNotFoundError:
            return None
        print(
            f"[edl] cold start: restored step {ckpt.step} from durable "
            f"checkpoint dir {self.store.spill_dir}",
            file=sys.stderr,
        )
        # Replays count from the durable step: a restarted process has
        # no memory of its earlier progress.
        self._last_completed_step = max(self._last_completed_step, ckpt.step)
        return ckpt

    def _restore_multiprocess(self, trainer: Trainer, flushed: Optional[HostCheckpoint] = None):
        """Agree on one state across the re-formed world and move ONLY
        the leaves some member lacks (``transfer.stream_restore`` over a
        ``TorchProcessFabric``).  Every member must call this inside the
        same generation's resize.  Returns (state, restored_step,
        restore_source, transfer_stats)."""
        from edl_tpu_torch.checkpoint.transfer import TorchProcessFabric, stream_restore

        ckpt = flushed if flushed is not None else self._latest_or_disk()
        _, specs = self._leaf_template()
        host = self.register_address.rsplit(":", 1)[0] if self.register_address else "127.0.0.1"
        fabric = TorchProcessFabric(self.world.cpu_group, advertise_host=host)
        result = stream_restore(
            fabric,
            specs,
            ckpt,
            chunk_bytes=self.TRANSFER_CHUNK_BYTES,
            timeout=self.TRANSFER_TIMEOUT,
            chaos=self.store.chaos,
        )
        stats = result.stats
        stats_dict = {
            "mode": stats.mode,
            "source_rank": stats.source_rank,
            "bytes_scheduled": stats.bytes_scheduled,
            "bytes_sent": stats.bytes_sent,
            "bytes_received": stats.bytes_received,
            "leaves_received": stats.leaves_received,
            "leaves_skipped": stats.leaves_skipped,
            "chunks_received": stats.chunks_received,
            "seconds": round(stats.seconds, 4),
        }
        if stats.mode == "init":
            return trainer.init_state(), 0, "init", stats_dict
        if stats.bytes_received or ckpt is None or int(ckpt.step) != stats.step:
            # Adopt the assembled checkpoint so this member restores
            # (or sources) locally after a later resize; its digests
            # are the source's verified advertisement.
            ckpt = HostCheckpoint(step=stats.step, generation=self.generation, leaves=result.leaves)
            ckpt.adopt_digests(result.leaf_digests)
            self.store.put(ckpt)
        state = self._state_from_ckpt(trainer, ckpt)
        moved = stats.bytes_received or stats.bytes_sent
        return state, stats.step, "broadcast" if moved else "local", stats_dict

    # -- heartbeats -----------------------------------------------------------
    def _beat_once(self):
        if self._leaving:
            return
        for tid in list(self.heartbeat_ids):
            try:
                # The last completed step rides the beat: retarget
                # plans stamp their advisory stop_step from it.
                self.coordinator.heartbeat(tid, step=self._last_completed_step)
            except KeyError:
                if self._leaving:
                    return  # deregistered on purpose; do not resurrect
                # Evicted while alive (a long pause outlived the lease):
                # rejoin; the generation bump runs the normal barrier.
                try:
                    self.coordinator.register(
                        tid,
                        address=self.register_address,
                        replica=self.register_replica,
                        host=self.register_host,
                    )
                except Exception:
                    pass  # coordinator unreachable; retry next beat
            except Exception:
                pass  # coordinator unreachable; retry next beat

    def _heartbeat(self):
        """Keep this process's members alive at the coordinator,
        throttled to ``heartbeat_interval``.  A background thread does
        the same so a long resize window cannot cause self-eviction."""
        if not self.heartbeat_ids:
            return
        self._ensure_heartbeat_thread()
        now = time.monotonic()
        if now - self._last_heartbeat < self.HEARTBEAT_INTERVAL:
            return
        self._last_heartbeat = now
        self._beat_once()

    def _maybe_report_telemetry(self) -> None:
        """Throttled telemetry report.  Runs only on the heartbeat
        thread: a POST between a member's plan poll and its next step
        dispatch would skew the members' resize-barrier entry."""
        if self.telemetry_interval <= 0:
            return
        now = time.monotonic()
        if now - self._last_telemetry_report < self.telemetry_interval:
            return
        self._last_telemetry_report = now
        self._report_telemetry()

    def flush_telemetry(self) -> None:
        """Ship one report now, outside the cadence: the end of a run,
        so the coordinator's merged view holds the final counts before
        the job reports completion."""
        if self.telemetry_interval > 0:
            self._report_telemetry()

    def _report_telemetry(self) -> None:
        """Ship this process's cumulative registry snapshot and the
        flight-recorder events not shipped yet (oldest first, at most 64
        a report).  Cumulative and sequenced, so idempotent at the
        aggregator; best effort — telemetry never stalls a step."""
        rep = getattr(self.coordinator, "report_telemetry", None)
        if rep is None:
            return  # test doubles without telemetry
        source = self.heartbeat_ids[0] if self.heartbeat_ids else "local"
        with self._report_lock:
            events = self.recorder.events_since(self._events_sent_seq)[:64]
            self._telemetry_seq += 1
            try:
                rep(
                    source,
                    snapshot=self.telemetry.snapshot(),
                    seq=self._telemetry_seq,
                    events=[e.to_dict() for e in events],
                    boot=self._telemetry_boot,
                )
            except Exception:
                return  # unreachable coordinator: the next cadence retries
            if events:
                self._events_sent_seq = events[-1].seq
        self._m_reports.inc()

    def _ensure_heartbeat_thread(self):
        if self._hb_thread is not None and self._hb_thread.is_alive():
            return
        self._hb_stop = threading.Event()
        # Wake often enough for both cadences; beat on the heartbeat's.
        wake = self.HEARTBEAT_INTERVAL
        if self.telemetry_interval > 0:
            wake = min(wake, self.telemetry_interval)

        def loop():
            last_beat = time.monotonic()
            while not self._hb_stop.wait(max(wake, 0.05)):
                if not self.heartbeat_ids:
                    continue
                now = time.monotonic()
                if now - last_beat >= self.HEARTBEAT_INTERVAL - 1e-3:
                    last_beat = now
                    self._beat_once()
                self._maybe_report_telemetry()

        self._hb_thread = threading.Thread(target=loop, daemon=True, name="edl-heartbeat")
        self._hb_thread.start()

    def stop_heartbeat(self):
        """Stop beating before deregistering (an in-flight beat must not
        resurrect the membership); joins the thread."""
        self._leaving = True
        if self._hb_stop is not None:
            self._hb_stop.set()
        if self._hb_thread is not None and self._hb_thread.is_alive():
            self._hb_thread.join(timeout=10)

    def _world_broken(self) -> None:
        """The live process group failed mid-step: drop every handle to
        it and hold for a fresh generation."""
        try:
            self.store.wait(timeout=5.0)
        except Exception:
            pass  # the world the save read is dead; expected
        self._leak_dead_world()
        self._pending.clear()
        self._reset_stop_state()
        self.state = None
        self._world_members = ()
        self._clear_world()
        self.world = None
        self._await_new_generation = True
        self._holding = True
        self.ledger.transition("broken")
        self._m_world_breaks.inc()
        self.recorder.record(
            "world.broken",
            {"failed_step": self._last_failed_step},
            step=self._last_completed_step,
            generation=self.generation,
        )

    # -- data-plane step agreement --------------------------------------------
    def _agreement_horizon(self) -> int:
        """Steps between a stop vote and the agreed boundary: depth+1
        puts the boundary past every member's run-ahead frontier when
        the agreement is learned."""
        return max(0, self.pipeline_depth) + 1

    def _bus_active(self) -> bool:
        return self.consensus_bus and self.trainer is not None and self._world_size() > 1

    def _consensus_stop_active(self) -> bool:
        """Whether a retarget quiesces at the bus-agreed boundary
        (``stop_step = vote_step + pipeline_depth + 1``) instead of
        tearing down on sight of the new plan: on a live world of
        several processes."""
        return self.state is not None and self._bus_active() and self.world_builder is not None

    def _watchdog_fetch(self, fn, what: str = "step metrics"):
        wd = self._watchdog
        if wd is None:
            timeout = self.collective_timeout
            if timeout is None:
                timeout = 120.0 if self.world_builder is not None else 0.0
            wd = self._watchdog = CollectiveWatchdog(
                timeout=timeout,
                chaos=self.store.chaos,
                registry=self.telemetry,
                recorder=self.recorder,
            )
        return wd.fetch(fn, what=what)

    def _dispatch_bus_word(self, step: int):
        """This step's control word, reduced over the world right after
        the step.  The stop lane carries this member's vote (first step
        after it observed a retarget) or echoes the agreement."""
        if not self._bus_active():
            return None
        gen_seen = max(self.generation, self._stop_gen, self._bus_seen_gen)
        stop = 0
        if self._stop_agreed is not None:
            stop = self._stop_agreed
        elif self._stop_gen > self.generation:
            stop = step + self._agreement_horizon()
            if self._vote_cast_gen != self._stop_gen:
                self._vote_cast_gen = self._stop_gen
                self._bus.note_vote(step, self._stop_gen, stop)
        return self._bus.dispatch(
            self.world.group,
            self.world.size,
            self.world.rank,
            gen_seen,
            stop,
            False,  # no member marks itself failing yet (the health lane)
            self._last_step_bucket,
            self.world.device,
        )

    def _absorb_bus_word(self, rec: _InFlightStep) -> None:
        """Harvest-time decode of step ``rec.step``'s word.  Every member
        decodes the same reduced word in the same step order, so the
        agreement needs no further communication."""
        values = self._watchdog_fetch(lambda: rec.bus_word.value().tolist(), what="control word")
        word = self._bus.decode(rec.step, values)
        if word.max_generation > max(self.generation, self._bus_seen_gen):
            # A peer saw a plan we have not polled yet.
            self._bus_seen_gen = word.max_generation
        if word.stop_step and self._stop_agreed is None:
            # The FIRST word with a nonzero stop lane is the agreement.
            self._stop_agreed = word.stop_step
            self._stop_gen = max(self._stop_gen, word.max_generation)
            self._start_quiesce_clock()
            self._bus.note_stop(rec.step, word.stop_step, self._stop_gen)
        if word.poisoned:
            raise BusPoisonError(
                f"a peer marked step {rec.step}'s control word poisoned "
                "(member self-reported failure)"
            )

    def _arm_stop(self, plan: ElasticPlan) -> None:
        if plan.generation > self._stop_gen:
            self._stop_gen = plan.generation
        self._start_quiesce_clock()

    def _effective_stop(self) -> Optional[int]:
        """The boundary this member quiesces at: the data-plane
        agreement (the coordinator's stamped stop is advisory)."""
        return self._stop_agreed

    def _stop_reached(self) -> bool:
        stop = self._effective_stop()
        return stop is not None and self._host_step >= stop

    def _start_quiesce_clock(self) -> None:
        if self._quiesce_t0 is None:
            self._quiesce_t0 = time.perf_counter()
            self._quiesce_deadline = time.monotonic() + self.BARRIER_TIMEOUT

    def _note_quiesced(self) -> None:
        """Journal this member's quiesce at the agreed stop (once per
        agreement)."""
        if self._quiesce_recorded:
            return
        self._quiesce_recorded = True
        self.recorder.record(
            "consensus.quiesce",
            {"stop_step": self._effective_stop(), "for_generation": self._stop_gen},
            step=self._last_completed_step,
            generation=self.generation,
        )

    def _finish_quiesce(self) -> None:
        """Journal and observe the retarget->quiesce latency (once per
        agreement); called on the way into resize or standby."""
        if self._quiesce_t0 is None:
            return
        self._note_quiesced()
        self._m_quiesce.observe(time.perf_counter() - self._quiesce_t0)
        self._quiesce_t0 = None

    def _reset_stop_state(self) -> None:
        self._stop_gen = 0
        self._stop_agreed = None
        self._vote_cast_gen = 0
        self._bus_seen_gen = 0
        self._quiesce_t0 = None
        self._quiesce_deadline = None
        self._quiesce_recorded = False

    def _note_prewarm(self, plan: ElasticPlan) -> None:
        """Accept a prewarm hint for an incoming world size (there is
        nothing to warm) and journal it under the decision that asked
        for it, once per (hint, trace).  A hint of the current world's
        size announces nothing incoming."""
        if plan.prewarm == plan.world_size:
            return
        chaos = self.store.chaos
        if chaos is not None and chaos.due("prewarm.hint.dropped"):
            # chaos[prewarm.hint.dropped]: the hint is lost en route; the
            # retarget still resizes (the port warms nothing anyway).
            self.dropped_prewarm_hints += 1
            return
        if not self.prewarm_hints or self.prewarm_hints[-1] != plan.prewarm:
            self.prewarm_hints.append(plan.prewarm)
        key = (plan.prewarm, plan.prewarm_trace)
        if key not in self._hint_journaled:
            self._hint_journaled.add(key)
            self.recorder.record(
                "prewarm.hint",
                {"world_size": plan.prewarm},
                generation=self.generation,
                trace=plan.prewarm_trace,
            )

    def maybe_resize(self) -> bool:
        self._heartbeat()
        plan = self.coordinator.plan()
        if plan is None or plan.world_size < 1:
            # No formable world: hold at the barrier.
            self._holding = plan is not None and plan.generation != self.generation
            return False
        if plan.generation != self.generation:
            # A fresh generation supersedes any broken-world hold.
            self._await_new_generation = False
            # The plan's trace id becomes the ambient trace: every event
            # this member journals on the way through the resize carries
            # it, until the first post-resize step journals.
            if plan.trace_id:
                self.recorder.set_trace(plan.trace_id)
        if plan.generation == self.generation and (
            self.state is not None or self._standby or self._await_new_generation
        ):
            self._holding = self._standby or self._await_new_generation
            if self.state is not None and not self._holding and plan.prewarm:
                self._note_prewarm(plan)
            return False
        if self._consensus_stop_active():
            # A retarget hit a LIVE multi-member world: vote, agree on
            # stop_step in-band, and keep stepping to that boundary —
            # every member leaves the old world at the same step.
            chaos = self.store.chaos
            if chaos is not None:
                for ev in chaos.due("consensus.vote.delayed"):
                    # chaos[consensus.vote.delayed]: this member's plan
                    # poll is suppressed; it keeps stepping, and the
                    # stop must still reach it in-band.
                    self._poll_suppress_until = time.monotonic() + float(ev.arg or 1.0)
            if time.monotonic() < self._poll_suppress_until:
                return False
            self._arm_stop(plan)
            if not self._stop_reached():
                return False
        if self._pending:
            # Sanctioned sync point: resize-barrier entry.  In-flight
            # steps harvest before anything is torn down; run() drains
            # under its broken-world guard and re-polls.
            self._defer_for_drain = True
            return False
        if self.heartbeat_ids and not self._my_member_ids(plan):
            # Scale-down: this process dropped out of the world.
            self._enter_standby(plan)
            self._holding = True
            return False
        if not self._resize(plan):
            self._holding = True
            return False
        self._holding = False
        return True

    # -- the async step pipeline ----------------------------------------------
    def _next_batch(self, step: int, horizon: int):
        """Step ``step``'s batch on the device: prefetched by the stager
        with the pipeline on, placed inline with it off — the same
        bytes either way."""
        world, rank = self._world_size(), self._rank()
        if self.pipeline_depth <= 0:
            return self.data.device_batch(step, self.device, world, rank)
        if self._stager is None:
            self._stager = BatchStager(
                self.data, depth=self.pipeline_depth, device=self.device, chaos=self.store.chaos
            )
        # Keyed by generation: nothing staged for an old world is used.
        self._stager.rebind(self.generation, world, rank)
        return self._stager.get(step, horizon=horizon)

    def _harvest_pending(self, limit: int) -> None:
        """Harvest (oldest first) until at most ``limit`` steps remain
        in flight (``limit=0``: a full drain)."""
        while len(self._pending) > limit:
            self._harvest_one()

    def _harvest_one(self) -> None:
        """Read the oldest in-flight step's loss and finalize its
        StepRecord.  The blocking read lives HERE, the sanctioned sync
        point (it waits for this step's loss alone, see ``_HostCopy``);
        a failure surfacing in it is attributed to this step."""
        rec = self._pending[0]
        t0 = time.perf_counter()
        try:
            loss = self._watchdog_fetch(lambda: rec.loss.value().item())
        except Exception:
            self._harvest_failed_step = rec.step
            self._pending.popleft()
            raise
        self._pending.popleft()
        if rec.bus_word is not None:
            try:
                self._absorb_bus_word(rec)
            except Exception:
                self._harvest_failed_step = rec.step
                raise
        now = time.perf_counter()
        self._m_device_wait.observe(now - t0)
        self.pipeline_stats["device_wait_s"] += now - t0
        base = rec.t_dispatch
        if self._last_harvest_t is not None:
            base = max(base, self._last_harvest_t)
        self._last_harvest_t = now
        srec = StepRecord(
            step=rec.step,
            generation=rec.generation,
            world_size=rec.world_size,
            loss=loss,
            seconds=now - base,
        )
        self._last_step_bucket = timing_bucket(srec.seconds)
        self.history.append(srec)
        self.recorder.set_context(rec.step, rec.generation)
        self._m_steps.inc()
        self._m_step_seconds.observe(srec.seconds)
        if self._first_step_trace_gen is not None and rec.generation >= self._first_step_trace_gen:
            # The first harvested step of the fresh generation closes the
            # resize's causal chain, under the trace captured at resize
            # time (a pending step harvesting inside the next barrier's
            # drain must not journal under the newer plan's trace).
            self._first_step_trace_gen = None
            self.recorder.record(
                "step.first",
                {"world_size": rec.world_size},
                step=rec.step,
                generation=rec.generation,
                trace=self._first_step_trace,
            )
            if self.recorder.trace_context() == self._first_step_trace:
                self.recorder.set_trace("")
            self._first_step_trace = ""
        self.ledger.touch()
        if self._on_step is not None:
            self._on_step(srec)
        done_step = rec.step + 1
        self._last_completed_step = max(self._last_completed_step, done_step)
        if done_step > self._last_failed_step:
            # Progress PAST the last failing step re-arms the cap.
            self._world_failures = 0

    def _absorb_step_failure(self, dispatch_step: Optional[int]) -> bool:
        """The broken-world recovery decision (call inside ``except``).
        True when the failure was absorbed (world buried, hold for a
        fresh generation); False means the caller re-raises."""
        if self._harvest_failed_step is None and self._pending:
            try:
                self._harvest_pending(0)
            except Exception:
                pass  # _harvest_failed_step now names the earliest
        attempted = self._harvest_failed_step
        self._harvest_failed_step = None
        if attempted is None:
            attempted = dispatch_step if dispatch_step is not None else self._last_completed_step
        self._pending.clear()
        if not (
            self.world_builder is not None
            and self.trainer is not None
            and self._world_size() > 1
            and self._world_failures < self.MAX_WORLD_FAILURES
        ):
            return False
        # A peer died mid-collective: drop the world, await the
        # eviction-bumped generation, resume from the last checkpoint.
        # Capped: repeated failures pinned at one step are a bug.
        traceback.print_exc()
        if attempted != self._last_failed_step:
            self._world_failures = 0
        self._world_failures += 1
        self._last_failed_step = attempted
        self._world_broken()
        return True

    def _drain_guarded(self) -> bool:
        """Full drain under the broken-world guard (barrier entry,
        hold).  False when a failure was absorbed (caller re-polls)."""
        if not self._pending:
            return True
        try:
            self._harvest_pending(0)
        except Exception:
            if self._absorb_step_failure(None):
                return False
            self._leak_dead_world()
            raise
        return True

    # -- the loop -------------------------------------------------------------
    def run(
        self,
        num_steps: int,
        on_step: Optional[Callable[[StepRecord], None]] = None,
    ) -> List[StepRecord]:
        """Run until the global step counter reaches ``num_steps``.

        The counter survives resizes (re-seeded from the restored
        checkpoint), so ``num_steps`` counts completed global steps, not
        loop iterations.  Steady state is the bounded async pipeline
        (``pipeline_depth``); depth 0 is the synchronous loop.  The loss
        stream is bit-identical either way."""
        hold_started: Optional[float] = None
        self._on_step = on_step
        self._m_pipeline_depth.set(self.pipeline_depth)
        try:
            while True:
                self.maybe_resize()
                if self._defer_for_drain:
                    # Sanctioned sync point: resize-barrier entry.
                    self._defer_for_drain = False
                    self._drain_guarded()
                    continue
                if self._holding:
                    self.ledger.transition("broken" if self._await_new_generation else "holding")
                    self.ledger.touch()
                    # Sanctioned sync point: hold.
                    if not self._drain_guarded():
                        continue
                    now = time.monotonic()
                    if self._standby:
                        hold_started = None
                    elif hold_started is None:
                        hold_started = now
                    elif now - hold_started > self.BARRIER_TIMEOUT:
                        self._leak_dead_world()
                        raise RuntimeError(
                            f"held at resize barrier > {self.BARRIER_TIMEOUT}s "
                            "with no formable world"
                        )
                    time.sleep(self.BARRIER_POLL_INTERVAL)
                    continue
                hold_started = None
                if self.state is None:
                    self._leak_dead_world()
                    raise RuntimeError("no plan with world_size >= 1 available")
                if self._stop_agreed is not None and self._stop_reached():
                    # Quiesced at the agreed stop boundary: park
                    # (drained) until this member sees the new plan too.
                    self.ledger.transition("holding")
                    self.ledger.touch()
                    if not self._drain_guarded():
                        continue
                    self._note_quiesced()
                    deadline = self._quiesce_deadline
                    if deadline is not None and time.monotonic() > deadline:
                        self._leak_dead_world()
                        raise RuntimeError(
                            f"quiesced at agreed stop step {self._effective_stop()} "
                            f"but no actionable plan arrived within {self.BARRIER_TIMEOUT}s"
                        )
                    time.sleep(self.BARRIER_POLL_INTERVAL)
                    continue
                step = None
                try:
                    step = self._host_step
                    if step >= num_steps:
                        # Sanctioned sync point: run exit.
                        self._harvest_pending(0)
                        break
                    if self.profiler.due(step):
                        # Sanctioned sync point: a profile window's first
                        # step.  The steps in flight finish first, so the
                        # window's device trace holds its own steps alone.
                        self._harvest_pending(0)
                        self.profiler.maybe_start(step)
                    self.ledger.transition("replaying" if step < self._replay_until else "stepping")
                    t0 = time.perf_counter()
                    with self.profiler.step(step):
                        batch = self._next_batch(step, num_steps)
                        t1 = time.perf_counter()
                        self.state, metrics = self.trainer.step(self.state, batch)
                        bus_word = self._dispatch_bus_word(step)
                    t2 = time.perf_counter()
                    self.pipeline_stats["stage_s"] += t1 - t0
                    self.pipeline_stats["dispatch_s"] += t2 - t1
                    self.pipeline_stats["dispatched"] += 1
                    self.ledger.note_staging(t1 - t0)
                    self._pending.append(
                        _InFlightStep(
                            step=step,
                            generation=self.generation,
                            world_size=self._world_size(),
                            t_dispatch=t0,
                            loss=_HostCopy(metrics["loss"]),
                            bus_word=None if bus_word is None else _HostCopy(bus_word),
                        )
                    )
                    if self.profiler.closing:
                        # Sanctioned sync point: a profile window's last
                        # step.  The window's device work is still in
                        # flight: harvest it before the trace closes.
                        self._harvest_pending(0)
                    self.profiler.maybe_stop()
                    self._host_step = step + 1
                    done_step = step + 1
                    if self.checkpoint_interval > 0 and done_step % self.checkpoint_interval == 0:
                        # Sanctioned sync point: interval checkpoint.
                        self._harvest_pending(0)
                        if self.state is not None:
                            # (an on_step callback of the drain may have
                            # dropped the state: a chaos death; the next
                            # resize replays from the last checkpoint)
                            self.store.save_async(self.state, generation=self.generation)
                            self.coordinator.report_checkpoint(done_step)
                    else:
                        self._harvest_pending(self.pipeline_depth)
                    if len(self._pending) > self.pipeline_stats["max_in_flight"]:
                        self.pipeline_stats["max_in_flight"] = len(self._pending)
                except Exception:
                    if self._absorb_step_failure(step):
                        continue
                    self._leak_dead_world()
                    raise
        finally:
            self._on_step = None
        self.profiler.stop()  # close a live window at the target step
        return self.history

    def _leak_dead_world(self) -> None:
        """Best-effort abandonment of the current world's process group
        (the builder's ``leak_dead_world``); ``FatalWorldError`` keeps
        propagating."""
        leak = getattr(self.world_builder, "leak_dead_world", None)
        if leak is not None:
            try:
                leak()
            except FatalWorldError:
                raise
            except Exception:
                pass


__all__ = ["ElasticTrainer", "FatalWorldError", "ResizeEvent", "StepRecord"]
