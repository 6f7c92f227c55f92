"""Pod launcher (counterpart of ``edl_tpu/launcher.py``).

1. read the ``EDL_*`` env contract (``env_config``),
2. register with the job coordinator (``EDL_COORDINATOR_ADDR``), or run
   alone with an in-process one,
3. build the model named by the entrypoint (a registered family, or
   user code from the workspace) and run the elastic loop,
   each generation's world a fresh ``torch.distributed`` process group
   (``make_world_builder``).

Runnable by hand: ``python -m edl_tpu_torch.launcher --entrypoint
transformer_lm --steps 4`` (on the card; ``--device cpu --tiny`` for a
tiny model on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import threading
import time
import uuid
from dataclasses import asdict, dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from edl_tpu_torch import DeviceLike, resolve_device


def env_config() -> dict:
    """Parse the EDL_* pod env contract into a config dict.

    The JAX launcher's contract, less what has no counterpart here:
    ``EDL_COMPILE_CACHE_DIR`` (the XLA compilation cache),
    ``EDL_JAX_COORD_PORT`` (renamed ``EDL_DIST_PORT``: the base port of
    the per-generation ``torch.distributed`` rendezvous), and keys of
    parts not ported yet:
    ``EDL_SHARD_ONLY`` (the checkpoint fabric) and ``EDL_PARALLELISM``
    (mesh layouts).  ``EDL_CHAOS_SPEC`` (JSON ``{"seed": S, "events":
    [{"step", "point", "arg"}, ...]}``) installs a per-pod chaos
    schedule on the trainer's checkpoint store.
    The serving pod's keys (``serving.server.serve_run``) are ported,
    with ``EDL_SERVE_DRAIN_MS``, the drain budget, which the JAX package
    reads in ``serve_run`` itself; the engine reads
    ``EDL_SERVE_DISPATCH_TIMEOUT`` (the dispatch watchdog) and the
    router pod its ``EDL_ROUTE_*`` keys (``serving.router.main``)."""
    e = os.environ
    return {
        "job_name": e.get("EDL_JOB_NAME", "local"),
        "coordinator_addr": e.get("EDL_COORDINATOR_ADDR", ""),
        "entrypoint": e.get("EDL_ENTRYPOINT", ""),
        "workspace": e.get("EDL_WORKSPACE", ""),
        # the replica's GPU topology ("h100-1"; checked against the
        # pod's visible cards at start)
        "slice_topology": e.get("EDL_SLICE_TOPOLOGY", "h100-1"),
        "min_instance": int(e.get("EDL_MIN_INSTANCE", "1")),
        "max_instance": int(e.get("EDL_MAX_INSTANCE", "1")),
        "num_passes": int(e.get("EDL_NUM_PASSES", "1")),
        "global_batch_size": int(e.get("EDL_GLOBAL_BATCH_SIZE", "0")),
        "checkpoint_interval": int(e.get("EDL_CHECKPOINT_INTERVAL", "100")),
        # steady-state async pipeline depth (0 = synchronous loop)
        "pipeline_depth": int(e.get("EDL_PIPELINE_DEPTH", "2")),
        "fault_tolerant": e.get("EDL_FAULT_TOLERANT", "0") == "1",
        "data_dir": e.get("EDL_DATA_DIR", ""),
        # durable checkpoint volume; "" = host-DRAM only
        "checkpoint_dir": e.get("EDL_CHECKPOINT_DIR", ""),
        "pod_name": e.get("EDL_POD_NAME", ""),
        # This pod's reachable host:port — seeds the per-generation
        # process group.  Explicit EDL_POD_ADDRESS wins; otherwise the
        # downward-API pod IP + the rendezvous base port.
        "pod_address": e.get("EDL_POD_ADDRESS", "")
        or (
            f"{e['EDL_POD_IP']}:{e.get('EDL_DIST_PORT', '8476')}"
            if e.get("EDL_POD_IP")
            else ""
        ),
        "history_file": e.get("EDL_HISTORY_FILE", ""),
        # per-pod deterministic chaos schedule (JSON; "" = none)
        "chaos_spec": e.get("EDL_CHAOS_SPEC", ""),
        # flight-recorder JSONL spill ("" = ring buffer only): every
        # journaled event also appends here, so a crashed pod leaves
        # its last events on disk (``edl trace --journal`` reads it)
        "flight_recorder_file": e.get("EDL_FLIGHT_RECORDER_FILE", ""),
        # seconds between telemetry reports to the coordinator
        "telemetry_interval": float(e.get("EDL_TELEMETRY_INTERVAL", "5.0")),
        # Serving-replica pod contract (serving.server.serve_run)
        "serve_port": int(e.get("EDL_SERVE_PORT", "7180")),
        "serve_max_batch": int(e.get("EDL_SERVE_MAX_BATCH", "64")),
        "serve_queue_limit": int(e.get("EDL_SERVE_QUEUE_LIMIT", "256")),
        "serve_deadline_ms": int(e.get("EDL_SERVE_DEADLINE_MS", "2000")),
        # how long a drain lets in-flight work finish
        "serve_drain_ms": int(e.get("EDL_SERVE_DRAIN_MS", "30000")),
        # collective-watchdog deadline override in seconds ("" = auto:
        # 120 s on multi-process worlds, disabled single-process)
        "collective_timeout": (
            float(e["EDL_COLLECTIVE_TIMEOUT"]) if e.get("EDL_COLLECTIVE_TIMEOUT") else None
        ),
        # per-step consensus control word (EDL_CONSENSUS=0 disables —
        # a diagnostic escape hatch: scale-downs then race again)
        "consensus": e.get("EDL_CONSENSUS", "1") != "0",
        # multi-host replica placement (see LocalCoordinator)
        "replica": int(e["EDL_REPLICA"]) if e.get("EDL_REPLICA") else None,
        "host_index": (
            int(e["EDL_HOST_INDEX"])
            if e.get("EDL_HOST_INDEX")
            else (int(e["JOB_COMPLETION_INDEX"]) if e.get("JOB_COMPLETION_INDEX") else None)
        ),
    }


def check_slice_topology(topology: str, device: torch.device) -> None:
    """Cross-check the pod's visible cards against the declared replica
    topology (the JAX ``_check_slice_topology``): a trainer pod owns one
    host's worth of its replica, so on CUDA the visible device count
    must equal the topology's GPUs per host.  Only warns: spec or
    deployment drift surfaces loudly instead of training at the wrong
    scale.  CPU runs and unknown names are not checked."""
    import sys

    if device.type != "cuda":
        return
    from edl_tpu_torch.cluster.gpu_topology import get_topology

    try:
        topo = get_topology(topology)
    except ValueError:
        return
    per_host = topo.gpus // max(1, topo.hosts)
    local = torch.cuda.device_count()
    if topo.gpus and local != per_host:
        print(
            f"[edl] replica topology {topology} expects {per_host} "
            f"GPUs/host but this pod sees {local} CUDA devices; "
            "check the job's nvidia.com/gpu limit and the node pool",
            file=sys.stderr,
        )


#: Per-generation rendezvous ports rotate through this window above the
#: pod's base port, so a port recurs only after hundreds of generations.
_PORT_WINDOW = 2048
#: Formation attempts per generation.  Every member derives the SAME
#: port sequence f(generation, attempt), so a bind failure on the new
#: rank 0 resolves by all members timing out in lockstep and retrying
#: on the next port — agreement with no extra round-trip.
_FORMATION_ATTEMPTS = 3
_FORMATION_TIMEOUT_S = 30


@dataclass
class World:
    """One generation's process group, as ``make_world_builder`` formed
    it."""

    generation: int
    rank: int
    size: int
    backend: str
    #: the training world's group (gradients and the step bus)
    group: Any
    #: a gloo group over the same members, for host-side agreement (the
    #: world's own group when the backend is gloo)
    cpu_group: Any
    #: where the training group's collectives run (the step bus's word)
    device: torch.device


def rendezvous_port(base: int, generation: int, attempt: int) -> int:
    """The rendezvous port of ``(generation, attempt)`` above ``base``."""
    return base + 1 + ((generation * _FORMATION_ATTEMPTS + attempt) % _PORT_WINDOW)


def make_world_builder(
    trainer_id: str,
    device: DeviceLike = None,
    formation_log: Optional[Callable[[Dict[str, Any]], None]] = None,
) -> Callable:
    """Build the world (re)formation hook.

    Each generation's process group is a fresh ``torch.distributed``
    world: rank 0 is the plan's first member, whose advertised host runs
    the rendezvous on a port derived from ``(generation, attempt)``.
    The backend is ``gloo`` on the CPU and ``nccl`` on CUDA (one card is
    one rank, beside a gloo group for the restore agreement).  The old
    group is destroyed before the new one forms, and teardown leaves no
    group behind: ``dist.is_initialized()`` is false between
    generations (else ``FatalWorldError``).

    ``formation_log``: optional callback receiving a timing dict per
    formation (teardown/init seconds, and whether a group was left
    after teardown)."""
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"

    def teardown() -> None:
        if dist.is_initialized():
            dist.destroy_process_group()
        if dist.is_initialized():
            from edl_tpu_torch.runtime.elastic import FatalWorldError

            raise FatalWorldError("a process group survived its world's teardown")

    def build(plan) -> Optional[World]:
        t0 = time.perf_counter()
        teardown()
        t_teardown = time.perf_counter() - t0
        left = dist.is_initialized()
        if trainer_id not in plan.members:
            return None  # standby: not part of this generation's world
        if not plan.addresses or not all(plan.addresses):
            raise RuntimeError(
                f"plan generation {plan.generation} carries no member "
                "addresses; multi-process world formation needs every "
                "pod registered with EDL_POD_ADDRESS"
            )
        rank = plan.members.index(trainer_id)
        host, base = plan.addresses[0].rsplit(":", 1)
        if device.type == "cuda":
            # an index-less "cuda" means the current card (set_device
            # refuses a device without an index)
            torch.cuda.set_device(
                device.index if device.index is not None else torch.cuda.current_device()
            )
        t1 = time.perf_counter()
        for attempt in range(_FORMATION_ATTEMPTS):
            port = rendezvous_port(int(base), plan.generation, attempt)
            try:
                dist.init_process_group(
                    backend,
                    init_method=f"tcp://{host}:{port}",
                    world_size=len(plan.members),
                    rank=rank,
                    timeout=timedelta(seconds=_FORMATION_TIMEOUT_S),
                )
                break
            except Exception:
                teardown()
                if attempt == _FORMATION_ATTEMPTS - 1:
                    raise
        group = dist.group.WORLD
        cpu_group = group if backend == "gloo" else dist.new_group(backend="gloo")
        if formation_log is not None:
            formation_log(
                {
                    "generation": plan.generation,
                    "world_size": plan.world_size,
                    "rank": rank,
                    "backend": backend,
                    "group_left_after_teardown": left,
                    "teardown_s": round(t_teardown, 4),
                    "init_s": round(time.perf_counter() - t1, 4),
                }
            )
        return World(
            generation=plan.generation,
            rank=rank,
            size=len(plan.members),
            backend=backend,
            group=group,
            cpu_group=cpu_group,
            device=device if backend == "nccl" else torch.device("cpu"),
        )

    # ElasticTrainer calls leak_dead_world before a fatal re-raise and
    # after a broken world; run() calls teardown at its end.
    build.leak_dead_world = teardown
    build.teardown = teardown
    return build


def _chaos_schedule(spec: str):
    """The ``FaultSchedule`` an ``EDL_CHAOS_SPEC`` value describes."""
    from edl_tpu_torch.chaos.schedule import FaultEvent, FaultSchedule

    d = json.loads(spec)
    return FaultSchedule(
        seed=int(d.get("seed", 0)),
        events=[
            FaultEvent(step=int(ev["step"]), point=ev["point"], arg=ev.get("arg"))
            for ev in d.get("events", ())
        ],
    )


def run(
    entrypoint: str = "",
    steps: Optional[int] = None,
    coordinator_addr: str = "",
    global_batch_size: int = 0,
    checkpoint_interval: Optional[int] = None,
    seed: int = 0,
    dataset_examples: int = 4096,
    pod_address: str = "",
    history_file: str = "",
    data_dir: str = "",
    checkpoint_dir: str = "",
    lr: float = 1e-3,
    device: DeviceLike = None,
    model_kwargs: Optional[Dict[str, Any]] = None,
    workspace: str = "",
):
    """Build and run the elastic training loop for a model on ``device``
    (CUDA unless the caller names another).  Returns the ElasticTrainer
    (with its history) for inspection.

    The model is the registered family named by the entrypoint or, for
    an unregistered name, the ``build`` of the workspace's model.py
    (``workspace``, else ``EDL_WORKSPACE``).
    ``model_kwargs``: passed to ``get_model`` (e.g. ``{"tiny": True}``).
    The global batch defaults to 8 rows (one device per process)."""
    from edl_tpu_torch.checkpoint.hostdram import HostDRAMStore
    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.runtime.coord_service import HTTPCoordinator
    from edl_tpu_torch.runtime.coordinator import LocalCoordinator
    from edl_tpu_torch.runtime.data import ShardedDataIterator
    from edl_tpu_torch.runtime.datasets import resolve_dataset
    from edl_tpu_torch.runtime.elastic import ElasticTrainer

    cfg = env_config()
    device = resolve_device(device)
    check_slice_topology(cfg["slice_topology"], device)
    if cfg["flight_recorder_file"]:
        from edl_tpu_torch import telemetry

        telemetry.get_recorder().spill_to(cfg["flight_recorder_file"])
    model = get_model(
        entrypoint or cfg["entrypoint"] or "transformer_lm",
        workspace=workspace or cfg["workspace"],
        **(model_kwargs or {}),
    )
    gbs = global_batch_size or cfg["global_batch_size"] or 8
    pod_address = pod_address or cfg["pod_address"]
    history_file = history_file or cfg["history_file"]
    trainer_id = cfg["pod_name"] or f"trainer-{uuid.uuid4().hex[:8]}"
    addr = coordinator_addr or cfg["coordinator_addr"]
    world_builder = None

    hist_f = open(history_file, "a", buffering=1) if history_file else None

    def log(obj) -> None:
        if hist_f is not None:
            hist_f.write(json.dumps(obj) + "\n")

    if addr:
        coordinator = HTTPCoordinator(addr)
        if pod_address:
            world_builder = make_world_builder(
                trainer_id, device, formation_log=lambda s: log({"formation": s})
            )
        coordinator.register(
            trainer_id, address=pod_address, replica=cfg["replica"], host=cfg["host_index"]
        )
    else:
        # Alone: an in-process coordinator with this one member.
        coordinator = LocalCoordinator(target_world=1, max_world=1)
        coordinator.register(trainer_id)

    dataset = resolve_dataset(model, data_dir or cfg["data_dir"], max(dataset_examples, gbs))
    data = ShardedDataIterator(dataset, global_batch_size=gbs, seed=seed)
    spill_dir = checkpoint_dir or cfg["checkpoint_dir"]
    # Per-pod deterministic chaos (EDL_CHAOS_SPEC): the schedule rides
    # the store's chaos seam, the plumbing the in-process soaks use, so
    # a test can chaos one member of a real multi-process world.
    chaos_sched = _chaos_schedule(cfg["chaos_spec"]) if cfg["chaos_spec"] else None
    et = ElasticTrainer(
        model,
        data,
        coordinator,
        store=HostDRAMStore(spill_dir=spill_dir or None, chaos=chaos_sched),
        lr=lr,
        device=device,
        checkpoint_interval=(
            checkpoint_interval if checkpoint_interval is not None else cfg["checkpoint_interval"]
        ),
        seed=seed,
        world_builder=world_builder,
    )
    et.pipeline_depth = cfg["pipeline_depth"]
    et.consensus_bus = cfg["consensus"]
    et.collective_timeout = cfg["collective_timeout"]
    et.telemetry_interval = cfg["telemetry_interval"]
    et.heartbeat_ids = [trainer_id]
    et.register_address = pod_address
    et.register_replica = cfg["replica"]
    et.register_host = cfg["host_index"]
    et.on_resize = lambda ev: log({"resize": asdict(ev)})

    def _deregister() -> None:
        try:
            coordinator.deregister(trainer_id)
        except Exception as e:
            # os.write is signal-safe; print() can raise inside a handler
            os.write(2, f"[edl] deregister {trainer_id} failed: {e}\n".encode(errors="replace"))

    def _graceful_leave(signum, frame):
        # Scale-down handshake on SIGTERM: flush and deregister at once,
        # so survivors never wait out the heartbeat lease.
        try:
            et.stop_heartbeat()
            if et.state is not None and et._world_size() == 1:
                et.store.save_async(et.state, generation=et.generation)
                et.store.wait()
        except Exception as e:
            os.write(2, f"[edl] graceful-leave flush failed: {e}\n".encode(errors="replace"))
        finally:
            _deregister()
            os._exit(0)

    main_thread = threading.current_thread() is threading.main_thread()
    prev_term = signal.signal(signal.SIGTERM, _graceful_leave) if main_thread else None

    def on_step(rec):
        if chaos_sched is not None:
            # No monkey drives it: the schedule's clock rides the harvested
            # step stream (advance is monotonic).
            chaos_sched.advance(rec.step)
        # "t": the wall clock at the step's harvest
        log({"step": rec.step, "generation": rec.generation,
             "world_size": rec.world_size, "loss": rec.loss, "seconds": rec.seconds,
             "t": time.time()})

    try:
        if steps is None:
            steps = cfg["num_passes"] * data.batches_per_epoch
        et.run(steps, on_step=on_step)
        # The durable dir must hold the FINISHED state.
        if et.state is not None:
            et.store.save_async(et.state, generation=et.generation)
        et.store.wait()
        et.flush_telemetry()
        try:
            coordinator.report_complete(step=et.history[-1].step if et.history else -1)
        except Exception:
            pass
        et.stop_heartbeat()
        _deregister()
    finally:
        if main_thread:
            signal.signal(signal.SIGTERM, prev_term)
        et.stop_heartbeat()
        if world_builder is not None:
            world_builder.teardown()
        if hist_f is not None:
            hist_f.close()
    return et


def main(argv=None):  # pragma: no cover - process entrypoint
    p = argparse.ArgumentParser(description="edl_tpu_torch trainer launcher")
    p.add_argument("--entrypoint", default="",
                   help="registered model name, or user code's with EDL_WORKSPACE")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--coordinator", default="", help="coordinator address")
    p.add_argument(
        "--address",
        default="",
        help="this pod's reachable host:port (enables multi-process world "
        "formation; normally from EDL_POD_ADDRESS)",
    )
    p.add_argument("--global-batch-size", type=int, default=0)
    p.add_argument("--checkpoint-interval", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--history-file", default="", help="append per-step JSONL records here")
    p.add_argument("--checkpoint-dir", default="", help="durable checkpoint directory")
    p.add_argument("--lr", type=float, default=1e-3, help="Adam learning rate")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--tiny", action="store_true", help="the model's tiny configuration")
    args = p.parse_args(argv)
    et = run(
        entrypoint=args.entrypoint,
        steps=args.steps,
        coordinator_addr=args.coordinator,
        global_batch_size=args.global_batch_size,
        checkpoint_interval=args.checkpoint_interval,
        seed=args.seed,
        pod_address=args.address,
        history_file=args.history_file,
        checkpoint_dir=args.checkpoint_dir,
        lr=args.lr,
        device=args.device,
        model_kwargs={"tiny": True} if args.tiny else None,
    )
    last = et.history[-1] if et.history else None
    print(
        f"done: steps={len(et.history)} "
        f"final_loss={last.loss if last else float('nan'):.4f} "
        f"resizes={len(et.resize_events)}"
    )


if __name__ == "__main__":  # pragma: no cover
    main()
