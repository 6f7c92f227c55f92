"""L0 resource model: the TrainingJob API surface (counterpart of
``edl_tpu/resource/training_job.py``).

The reference CRD types in ``pkg/resource/training_job.go``:

- ``TrainingJob{TypeMeta, ObjectMeta, Spec, Status}``    (ref ``:101-106``)
- ``TrainingJobSpec`` image/port/fault_tolerant/passes   (ref ``:110-124``)
- ``TrainerSpec{Entrypoint, Workspace, Min, Max, Res}``  (ref ``:128-134``)
- ``MasterSpec`` -> ``CoordinatorSpec``                  (ref ``:146-149``)
- status states Created/Running/Failed/Succeed           (ref ``:162-167``)
- helpers ``Elastic()`` / ``GPU()`` / ``NeedGPU()``      (ref ``:179-197``)

Departures from the reference, shared with the JAX package:

- **No PserverSpec.** The reference's parameter-server ReplicaSet
  (ref ``:138-142``, ``pkg/jobparser.go:74-112``) exists only to sync
  gradients over TCP; here that is an all-reduce inside the train step,
  so there is no pserver process to declare.
- **``nvidia.com/gpu``.** Device accounting keys on the device plugin's
  resource (the reference used the long-deprecated
  ``alpha.kubernetes.io/nvidia-gpu``, ref ``:74,185``).
- **Replica topology.** A trainer replica owns a fixed number of H100s
  (``"h100-1"`` .. ``"h100-64"``, 8 a host), so scaling deltas are
  quantized to whole replicas.
- **Status is real.** The controller maintains it as a state machine
  Created -> Running -> (Scaling <->) -> Succeed/Failed.

What the port cannot honour yet, ``validate`` refuses with the ROADMAP
item that brings it: a non-trivial ``trainer.parallelism`` (mesh
layouts) and ``shard_only`` (the checkpoint fabric).  Both are still
parsed, and ``ParallelismSpec`` / ``quantized_world_sizes`` are whole.

API group: ``edl.tpu.dev/v1`` (kept from the JAX package, so one CRD
serves both; analog of ``paddlepaddle.org/v1``, ref ``:208-228``).
"""

from __future__ import annotations

import copy
import enum
import time
from dataclasses import dataclass, field, asdict
from typing import Any, Dict, List, Mapping, Optional

from edl_tpu_torch.utils.quantity import (
    parse_cpu_milli,
    parse_memory_mega,
    parse_count,
)

GROUP = "edl.tpu.dev"
VERSION = "v1"
KIND = "TrainingJob"
PLURAL = "trainingjobs"

#: Device resource key used for inventory + limits.
GPU_RESOURCE_KEY = "nvidia.com/gpu"

#: Defaults mirroring DefaultJobParser.Validate (ref pkg/jobparser.go:47-71).
DEFAULT_PORT = 7164
DEFAULT_IMAGE = "edl-tpu-torch/trainer:latest"
DEFAULT_PASSES = 1


class ValidationError(ValueError):
    """Raised when a TrainingJob spec is invalid (ref pkg/jobparser.go:66-68)."""


class JobState(str, enum.Enum):
    """Job lifecycle states (ref pkg/resource/training_job.go:162-167, plus
    SCALING which the reference lacked because it never wrote status)."""

    CREATED = "Created"
    RUNNING = "Running"
    SCALING = "Scaling"
    SUCCEED = "Succeed"
    FAILED = "Failed"


@dataclass
class ResourceSpec:
    """Requests/limits as k8s-style quantity strings.

    Normalized accessors mirror the reference's per-job accessors
    (ref pkg/autoscaler.go:39-52)."""

    requests: Dict[str, Any] = field(default_factory=dict)
    limits: Dict[str, Any] = field(default_factory=dict)

    # -- normalized views ---------------------------------------------------
    def cpu_request_milli(self) -> int:
        return parse_cpu_milli(self.requests.get("cpu", 0))

    def cpu_limit_milli(self) -> int:
        return parse_cpu_milli(self.limits.get("cpu", 0))

    def mem_request_mega(self) -> int:
        return parse_memory_mega(self.requests.get("memory", 0))

    def mem_limit_mega(self) -> int:
        return parse_memory_mega(self.limits.get("memory", 0))

    def gpu_limit(self) -> int:
        """GPUs per replica (ref analog: TrainerGPULimit,
        pkg/autoscaler.go:39-42, reading the device limit)."""
        return parse_count(self.limits.get(GPU_RESOURCE_KEY, 0))

    def normalized(self) -> Dict[str, Dict[str, int]]:
        return {
            "requests": {
                "cpu_milli": self.cpu_request_milli(),
                "memory_mega": self.mem_request_mega(),
            },
            "limits": {
                "cpu_milli": self.cpu_limit_milli(),
                "memory_mega": self.mem_limit_mega(),
                "gpu": self.gpu_limit(),
            },
        }

    @staticmethod
    def from_dict(d: Optional[Mapping[str, Any]]) -> "ResourceSpec":
        d = d or {}
        return ResourceSpec(
            requests=dict(d.get("requests", {}) or {}),
            limits=dict(d.get("limits", {}) or {}),
        )


#: Model-parallel mesh axes a job may request in its layout.  ``dp`` is
#: deliberately NOT here: it is the elastic axis, always the remainder
#: (world x GPUs / product of the requested axes), so the layout stays
#: valid at every legal world size.
LAYOUT_AXES = ("fsdp", "tp", "sp", "ep", "pp")
#: Layout axes that carry batch rows: the global batch shards over
#: dp x fsdp; tp/sp/ep/pp replicate the batch (they split hidden dims,
#: sequence, experts, and stages respectively).
BATCH_LAYOUT_AXES = ("fsdp",)


@dataclass
class ParallelismSpec:
    """Requested parallelism layout: model-axis sizes for the trainer
    mesh (the reference's trainer spec was its whole parallelism
    interface — one flat pool of data-parallel pods,
    ref pkg/resource/training_job.go:128-134; this spec is its
    generalization to dp x fsdp x tp x sp x ep x pp meshes).

    All sizes default to 1 (pure elastic data parallelism — the
    reference's one strategy).  The ``dp`` extent is never declared:
    at world size ``w`` with ``c`` GPUs per replica it is
    ``w*c / product()``, so elasticity resizes dp and leaves the model
    axes fixed."""

    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    def axes(self) -> Dict[str, int]:
        """The non-trivial axis sizes (size > 1) — the dict handed to
        mesh construction and rendered into EDL_PARALLELISM."""
        return {
            a: int(getattr(self, a))
            for a in LAYOUT_AXES
            if int(getattr(self, a)) > 1
        }

    def product(self) -> int:
        """Devices one dp slot spans: the model-axis product."""
        out = 1
        for a in LAYOUT_AXES:
            out *= max(1, int(getattr(self, a)))
        return out

    def nonbatch_product(self) -> int:
        """Product of axes that replicate the batch (tp*sp*ep*pp);
        total devices / this = the batch extent (dp*fsdp)."""
        out = 1
        for a in LAYOUT_AXES:
            if a not in BATCH_LAYOUT_AXES:
                out *= max(1, int(getattr(self, a)))
        return out

    def trivial(self) -> bool:
        return self.product() == 1

    def env_value(self) -> str:
        """Serialized for the EDL_PARALLELISM pod env: "fsdp=2,tp=2"."""
        return ",".join(f"{a}={s}" for a, s in self.axes().items())

    @staticmethod
    def from_env(value: str) -> "ParallelismSpec":
        sizes: Dict[str, int] = {}
        for part in (value or "").split(","):
            part = part.strip()
            if not part:
                continue
            axis, _, size = part.partition("=")
            sizes[axis.strip()] = int(size)
        return ParallelismSpec.from_dict(sizes)

    @staticmethod
    def from_dict(d: Optional[Mapping[str, Any]]) -> "ParallelismSpec":
        d = d or {}
        unknown = set(d) - set(LAYOUT_AXES)
        if unknown:
            raise ValidationError(
                f"unknown parallelism axes {sorted(unknown)}; "
                f"valid: {list(LAYOUT_AXES)} (dp is implicit — it is the "
                "elastic remainder)"
            )
        return ParallelismSpec(**{a: int(s) for a, s in d.items()})


@dataclass
class TrainerSpec:
    """Elastic trainer group (ref TrainerSpec, pkg/resource/training_job.go:128-134).

    ``min_instance``/``max_instance`` count *trainer replicas*; each
    replica owns the GPUs of ``slice_topology``."""

    entrypoint: str = ""
    workspace: str = ""
    min_instance: int = 1
    max_instance: int = 1
    #: Per-replica GPU topology, e.g. "h100-1", "h100-8", "h100-16".
    slice_topology: str = "h100-1"
    resources: ResourceSpec = field(default_factory=ResourceSpec)
    #: Requested mesh layout beyond elastic dp (fsdp/tp/sp/ep/pp).
    parallelism: ParallelismSpec = field(default_factory=ParallelismSpec)

    @staticmethod
    def from_dict(d: Optional[Mapping[str, Any]]) -> "TrainerSpec":
        d = d or {}
        return TrainerSpec(
            entrypoint=d.get("entrypoint", ""),
            workspace=d.get("workspace", ""),
            min_instance=int(d.get("min_instance", d.get("minInstance", 1))),
            max_instance=int(d.get("max_instance", d.get("maxInstance", 1))),
            slice_topology=d.get("slice_topology", d.get("sliceTopology", "h100-1")),
            resources=ResourceSpec.from_dict(d.get("resources")),
            parallelism=ParallelismSpec.from_dict(d.get("parallelism")),
        )


@dataclass
class CoordinatorSpec:
    """Elastic coordinator (replaces the reference's master ReplicaSet +
    etcd v3.2.1 sidecar, ref MasterSpec pkg/resource/training_job.go:146-149
    and pkg/jobparser.go:174-232).  One lightweight process that tracks
    membership generations, assigns data shards, and indexes checkpoints
    (``runtime/coord_service.py``) instead of etcd.  It listens
    on ``TrainingJobSpec.port`` — the job's single port."""

    resources: ResourceSpec = field(default_factory=ResourceSpec)

    @staticmethod
    def from_dict(d: Optional[Mapping[str, Any]]) -> "CoordinatorSpec":
        d = d or {}
        return CoordinatorSpec(
            resources=ResourceSpec.from_dict(d.get("resources")),
        )


@dataclass
class ServingSpec:
    """Elastic inference serving attached to a TrainingJob: a fleet of
    checkpoint-backed replicas (``edl_tpu_torch.serving``) scaled between
    ``[min_replicas, max_replicas]`` by the autoscaler's serving lane
    on observed p95 latency / queue depth.  Replicas serve the newest
    *verified* checkpoint from ``spec.checkpoint_dir`` and hot-swap as
    training spills fresher ones — train and serve as one substrate
    (Pathways, PAPERS.md), sharing image, volumes, and control plane."""

    min_replicas: int = 1
    max_replicas: int = 1
    port: int = 7180
    max_batch: int = 64
    queue_limit: int = 256
    deadline_ms: int = 2000
    resources: ResourceSpec = field(default_factory=ResourceSpec)

    @staticmethod
    def from_dict(d: Optional[Mapping[str, Any]]) -> Optional["ServingSpec"]:
        if not d:
            return None
        return ServingSpec(
            min_replicas=int(d.get("min_replicas", d.get("minReplicas", 1))),
            max_replicas=int(d.get("max_replicas", d.get("maxReplicas", 1))),
            port=int(d.get("port", 7180)),
            max_batch=int(d.get("max_batch", d.get("maxBatch", 64))),
            queue_limit=int(d.get("queue_limit", d.get("queueLimit", 256))),
            deadline_ms=int(d.get("deadline_ms", d.get("deadlineMs", 2000))),
            resources=ResourceSpec.from_dict(d.get("resources")),
        )


@dataclass
class TrainingJobSpec:
    """ref TrainingJobSpec (pkg/resource/training_job.go:110-124).

    Dropped fields, by design: ``ports_num`` / ``ports_num_for_sparse``
    (pserver TCP port ranges, ref ``:114-115`` — no pserver exists here;
    the only port is the coordinator's) and per-pod ``volumes`` (carried
    opaquely in ``volumes`` for manifest passthrough)."""

    image: str = ""
    port: int = 0
    fault_tolerant: bool = False
    passes: int = 0
    #: Fleet-market scheduling priority (higher = more important).
    #: When several jobs bid for one GPU inventory (the JAX package's
    #: ``edl_tpu.fleet``; the port's comes with ROADMAP A-4, and until
    #: then its controller refuses a second live prioritized job),
    #: serving spikes preempt the LOWEST-priority elastic trainer first,
    #: and growth goes to higher priorities first.  0 is the default
    #: tier; the reference had no notion of cross-job priority (its
    #: fixed point ordered purely by fulfillment, ref
    #: ``pkg/autoscaler.go:97-129``).
    priority: int = 0
    trainer: TrainerSpec = field(default_factory=TrainerSpec)
    coordinator: CoordinatorSpec = field(default_factory=CoordinatorSpec)
    volumes: List[Dict[str, Any]] = field(default_factory=list)
    #: Runtime knobs the reference kept outside the CRD (in user code).
    #: Fixed global batch under elasticity (SURVEY.md §7.4): per-replica
    #: batch = global_batch_size / world_size at every generation.
    global_batch_size: int = 0
    checkpoint_interval_steps: int = 100
    #: directory of a file-backed array store (see
    #: ``edl_tpu_torch.runtime.datasets``) mounted into trainer pods; ""
    #: trains on the model's synthetic data (the reference carried the
    #: analogous pointer opaquely in Workspace/TRAINER_PACKAGE,
    #: ref ``pkg/jobparser.go:288-291``)
    dataset_dir: str = ""
    #: durable checkpoint directory (a mounted volume shared by the
    #: trainer pods).  When set, every host-DRAM checkpoint also spills
    #: here and a cold start (whole-world loss: every pod preempted,
    #: restart-all) restores from it instead of silently re-initializing
    #: at step 0.  The reference delegated exactly this durability to
    #: its master+etcd sidecar (ref ``pkg/jobparser.go:174-191``;
    #: design doc pointer ``README.md:18-21``); "" = DRAM-only.
    checkpoint_dir: str = ""
    #: the JAX package's persistent XLA compilation-cache directory.
    #: It has no counterpart in the port: eager PyTorch compiles no step
    #: (the kernels are built once per checkout by ``ops/_build.py``),
    #: so the field is parsed for manifest compatibility and no pod env
    #: key is rendered for it.
    compile_cache_dir: str = ""
    #: shard-only host checkpoints (the JAX package's EDL_SHARD_ONLY):
    #: each member's host DRAM holds only its own shard plus K
    #: ring-buddy shards, and spills are per-rank shard files.  It needs
    #: the checkpoint fabric, which the port has not yet (ROADMAP A-7):
    #: ``validate`` refuses True and no pod env key is rendered.
    shard_only: bool = False
    #: elastic inference serving attached to this job (None = train
    #: only).  Serving replicas load the newest verified checkpoint
    #: from ``checkpoint_dir`` and hot-swap as training writes fresher
    #: ones; the autoscaler's serving lane scales them on p95/queue
    #: depth read from the serving coordinator's merged telemetry.
    serving: Optional["ServingSpec"] = None

    @staticmethod
    def from_dict(d: Optional[Mapping[str, Any]]) -> "TrainingJobSpec":
        d = d or {}
        return TrainingJobSpec(
            serving=ServingSpec.from_dict(d.get("serving")),
            dataset_dir=str(d.get("dataset_dir", d.get("datasetDir", "")) or ""),
            checkpoint_dir=str(
                d.get("checkpoint_dir", d.get("checkpointDir", "")) or ""
            ),
            compile_cache_dir=str(
                d.get("compile_cache_dir", d.get("compileCacheDir", "")) or ""
            ),
            shard_only=bool(d.get("shard_only", d.get("shardOnly", False))),
            image=d.get("image", ""),
            port=int(d.get("port", 0)),
            priority=int(d.get("priority", 0)),
            fault_tolerant=bool(d.get("fault_tolerant", d.get("faultTolerant", False))),
            passes=int(d.get("passes", 0)),
            trainer=TrainerSpec.from_dict(d.get("trainer")),
            coordinator=CoordinatorSpec.from_dict(
                d.get("coordinator", d.get("master"))
            ),
            volumes=list(d.get("volumes", []) or []),
            global_batch_size=int(d.get("global_batch_size", d.get("globalBatchSize", 0))),
            checkpoint_interval_steps=int(
                d.get("checkpoint_interval_steps", d.get("checkpointIntervalSteps", 100))
            ),
        )


@dataclass
class TrainingJobStatus:
    """ref TrainingJobStatus (pkg/resource/training_job.go:153-167).
    The reference never writes it (SURVEY.md §5.5); ours is maintained by
    the controller."""

    state: JobState = JobState.CREATED
    parallelism: int = 0
    generation: int = 0
    running: int = 0
    pending: int = 0
    message: str = ""
    #: wall-clock seconds the job spent with all pods pending (for the
    #: pending-time p50 north-star metric).
    submitted_at: float = 0.0
    started_at: float = 0.0

    def pending_seconds(self, now: Optional[float] = None) -> float:
        """Seconds from submit to first running pod.  ``now`` must come
        from the same clock that wrote the timestamps (the controller
        passes its injected clock); defaults to wall time."""
        if self.submitted_at <= 0:
            return 0.0
        if self.started_at > 0:
            end = self.started_at
        else:
            end = now if now is not None else time.time()
        return max(0.0, end - self.submitted_at)


@dataclass
class TrainingJob:
    """ref TrainingJob (pkg/resource/training_job.go:101-106)."""

    name: str = ""
    namespace: str = "default"
    #: API-server-assigned object UID; stamps ownerReferences on every
    #: rendered workload manifest so Kubernetes garbage-collects them
    #: when the CR is deleted (the ref delegated GC to k8s ownership).
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    spec: TrainingJobSpec = field(default_factory=TrainingJobSpec)
    status: TrainingJobStatus = field(default_factory=TrainingJobStatus)

    # -- helpers (ref pkg/resource/training_job.go:179-197) -----------------
    def elastic(self) -> bool:
        """min < max (ref Elastic(), ``:179-181``)."""
        return self.spec.trainer.min_instance < self.spec.trainer.max_instance

    def gpu_per_trainer(self) -> int:
        """GPUs each trainer replica consumes (ref GPU(), ``:184-190``,
        reading the nvidia limit).  Falls back to the topology's GPU
        count when resources.limits omits the key."""
        n = self.spec.trainer.resources.gpu_limit()
        if n:
            return n
        from edl_tpu_torch.cluster.gpu_topology import topology_gpus

        return topology_gpus(self.spec.trainer.slice_topology)

    def need_gpu(self) -> bool:
        """ref NeedGPU() (``:193-197``)."""
        return self.gpu_per_trainer() > 0

    def hosts_per_replica(self) -> int:
        """Host machines (pods) per trainer replica.  1 up to 8 GPUs;
        >1 for multi-host topologies (h100-16 = 2 hosts), where
        one replica renders as an Indexed Job of this many pods."""
        from edl_tpu_torch.cluster.gpu_topology import get_topology

        try:
            return max(1, get_topology(self.spec.trainer.slice_topology).hosts)
        except ValueError:
            return 1

    def gpu_per_host(self) -> int:
        """GPUs each POD requests: a multi-host replica's GPUs split
        across its host pods (the per-pod ``nvidia.com/gpu`` limit is
        GPUs-per-host)."""
        return self.gpu_per_trainer() // self.hosts_per_replica()

    def fullname(self) -> str:
        return f"{self.namespace}/{self.name}"

    def trainer_job_name(self) -> str:
        """Name of the actuated trainer workload: ``<job>-trainer``
        (ref pkg/cluster.go:92-94)."""
        return f"{self.name}-trainer"

    def coordinator_name(self) -> str:
        return f"{self.name}-coordinator"

    def serving_name(self) -> str:
        """Name of the serving-replica Deployment/Service:
        ``<job>-serve``."""
        return f"{self.name}-serve"

    def serving_coordinator_name(self) -> str:
        """The SERVING world's coordinator (separate from the training
        coordinator: serving replicas must never join the training
        plan's rank order)."""
        return f"{self.name}-serve-coordinator"

    def router_name(self) -> str:
        """The fleet front door (routerd) Deployment/Service:
        ``<job>-router`` — what clients actually point at."""
        return f"{self.name}-router"

    # -- validation + defaulting (ref DefaultJobParser.Validate,
    #    pkg/jobparser.go:47-71) --------------------------------------------
    def validate(self) -> "TrainingJob":
        """Fill defaults and reject invalid specs.  Returns self.

        Mirrors ref semantics: default port/image/passes; reject
        elastic-without-fault-tolerant (ref ``:66-68``).  Adds
        constraints the reference could not have: instance bounds sane,
        topology legal.  Last, refuses what the port cannot honour yet
        (a parallelism layout, shard-only checkpoints), naming the
        ROADMAP item that brings it."""
        s = self.spec
        if not self.name:
            raise ValidationError("job name must be set")
        if s.port <= 0:
            s.port = DEFAULT_PORT
        if not s.image:
            s.image = DEFAULT_IMAGE
        if s.passes <= 0:
            s.passes = DEFAULT_PASSES
        t = s.trainer
        if t.min_instance <= 0:
            raise ValidationError("trainer.min_instance must be >= 1")
        if t.max_instance < t.min_instance:
            raise ValidationError(
                "trainer.max_instance must be >= trainer.min_instance"
            )
        if self.elastic() and not s.fault_tolerant:
            # ref pkg/jobparser.go:66-68: elastic requires fault tolerance
            # (a shrinkable job must checkpoint + re-mesh).
            raise ValidationError(
                "max_instance > min_instance requires fault_tolerant: true"
            )
        from edl_tpu_torch.cluster.gpu_topology import topology_gpus

        try:
            topology_gpus(t.slice_topology)
        except ValueError as e:
            raise ValidationError(str(e)) from None
        for res in (t.resources, s.coordinator.resources):
            for bucket in (res.requests, res.limits):
                for key, q in bucket.items():
                    try:
                        if key == "cpu":
                            v = parse_cpu_milli(q)
                        elif key == "memory":
                            v = parse_memory_mega(q)
                        else:
                            v = parse_count(q)
                    except (ValueError, TypeError) as e:
                        raise ValidationError(
                            f"invalid quantity {key}={q!r}: {e}"
                        ) from None
                    if v < 0:
                        raise ValidationError(
                            f"resource quantity must be >= 0: {key}={q!r}"
                        )
        declared_gpu = t.resources.gpu_limit()
        topo_gpus = topology_gpus(t.slice_topology)
        if declared_gpu and declared_gpu != topo_gpus:
            raise ValidationError(
                f"limits['{GPU_RESOURCE_KEY}']={declared_gpu} contradicts "
                f"slice_topology {t.slice_topology!r} ({topo_gpus} GPUs); "
                "omit the limit or make them agree"
            )
        if s.global_batch_size < 0:
            raise ValidationError("global_batch_size must be >= 0")
        if s.priority < 0:
            raise ValidationError("priority must be >= 0")
        if s.serving is not None:
            sv = s.serving
            if sv.min_replicas < 1 or sv.max_replicas < sv.min_replicas:
                raise ValidationError(
                    "serving replica bounds must satisfy 1 <= min <= max "
                    f"(got [{sv.min_replicas}, {sv.max_replicas}])"
                )
            if sv.max_batch < 1 or sv.queue_limit < 1 or sv.deadline_ms < 1:
                raise ValidationError(
                    "serving max_batch / queue_limit / deadline_ms must "
                    "be >= 1"
                )
            if not s.checkpoint_dir:
                raise ValidationError(
                    "spec.serving requires spec.checkpoint_dir: replicas "
                    "serve the newest verified durable checkpoint (a "
                    "DRAM-only training fleet leaves them nothing to load)"
                )
        par = t.parallelism
        for a in LAYOUT_AXES:
            if int(getattr(par, a)) < 1:
                raise ValidationError(
                    f"parallelism.{a} must be >= 1, got {getattr(par, a)}"
                )
        gpus = max(1, topo_gpus)
        # The layout and (when set) the global batch must admit BOTH
        # instance endpoints, or the job could neither start at min nor
        # reach max.  At world w the mesh spans w x gpus devices, the
        # model axes claim par.product() of them per dp slot, and the
        # batch shards over the dp x fsdp extent (SURVEY.md §7.4:
        # fixed-global-batch elasticity).
        for w, which in ((t.min_instance, "min"), (t.max_instance, "max")):
            total = w * gpus
            if total % par.product() != 0:
                raise ValidationError(
                    f"parallelism layout {par.axes()} (product "
                    f"{par.product()}) must divide trainer.{which}_instance "
                    f"x replica GPUs ({w} x {gpus} = {total})"
                )
            if s.global_batch_size:
                extent = total // par.nonbatch_product()
                if s.global_batch_size % extent != 0:
                    raise ValidationError(
                        "global_batch_size must be divisible by the batch "
                        f"extent at trainer.{which}_instance "
                        f"(dp x fsdp = {extent} of {total} devices)"
                    )
        if not par.trivial():
            raise ValidationError(
                f"trainer.parallelism {par.axes()} is not supported by the "
                "PyTorch port yet: mesh layouts wait for ROADMAP A-8 "
                "(parallel layouts); omit it to train pure data parallel"
            )
        if s.shard_only:
            raise ValidationError(
                "shard_only: true is not supported by the PyTorch port yet: "
                "shard-only host checkpoints wait for ROADMAP A-7 (the "
                "checkpoint fabric)"
            )
        return self

    def legal_world_sizes(
        self, gpus_per_replica: Optional[int] = None
    ) -> List[int]:
        """World sizes the elastic runtime may resize to: every w in
        [min_instance, max_instance] whose full device mesh
        (w x GPUs-per-replica) factors into the requested parallelism
        layout AND whose batch extent (dp x fsdp) divides the global
        batch.  With no global_batch_size set, only the layout
        divisibility applies.

        ``gpus_per_replica`` defaults to the spec's slice topology;
        pass 1 when the runtime simulates one-device trainers (the CLI
        local modes), where the deployed topology's GPU count would
        wrongly disqualify sizes the actual mesh shards fine."""
        from edl_tpu_torch.cluster.gpu_topology import topology_gpus

        t = self.spec.trainer
        if gpus_per_replica is None:
            gpus_per_replica = topology_gpus(t.slice_topology)
        return quantized_world_sizes(
            t.min_instance,
            t.max_instance,
            gpus_per_replica,
            self.spec.global_batch_size,
            t.parallelism,
        )

    # -- (de)serialization --------------------------------------------------
    def to_manifest(self) -> Dict[str, Any]:
        """Render as a k8s custom-resource manifest dict."""
        spec = asdict(self.spec)
        status = asdict(self.status)
        status["state"] = self.status.state.value
        metadata = {
            "name": self.name,
            "namespace": self.namespace,
            "labels": dict(self.labels),
        }
        if self.uid:
            metadata["uid"] = self.uid
        return {
            "apiVersion": f"{GROUP}/{VERSION}",
            "kind": KIND,
            "metadata": metadata,
            "spec": spec,
            "status": status,
        }

    @staticmethod
    def from_manifest(d: Mapping[str, Any]) -> "TrainingJob":
        api_version = d.get("apiVersion", f"{GROUP}/{VERSION}")
        if api_version != f"{GROUP}/{VERSION}":
            raise ValidationError(f"unsupported apiVersion: {api_version}")
        if d.get("kind", KIND) != KIND:
            raise ValidationError(f"unsupported kind: {d.get('kind')}")
        meta = d.get("metadata", {}) or {}
        try:
            job = TrainingJob(
                name=meta.get("name", ""),
                namespace=meta.get("namespace", "default"),
                uid=meta.get("uid", ""),
                labels=dict(meta.get("labels", {}) or {}),
                spec=TrainingJobSpec.from_dict(d.get("spec")),
            )
            st = d.get("status") or {}
            if st:
                job.status = TrainingJobStatus(
                    state=JobState(st.get("state", "Created")),
                    parallelism=int(st.get("parallelism", 0)),
                    generation=int(st.get("generation", 0)),
                    running=int(st.get("running", 0)),
                    pending=int(st.get("pending", 0)),
                    message=st.get("message", ""),
                    submitted_at=float(st.get("submitted_at", 0.0)),
                    started_at=float(st.get("started_at", 0.0)),
                )
        except ValidationError:
            raise
        except (ValueError, TypeError) as e:
            raise ValidationError(f"malformed TrainingJob manifest: {e}") from None
        return job

    @staticmethod
    def from_yaml(text: str) -> "TrainingJob":
        import yaml

        return TrainingJob.from_manifest(yaml.safe_load(text))

    def deepcopy(self) -> "TrainingJob":
        """ref zz_generated.deepcopy.go DeepCopyObject — trivially
        ``copy.deepcopy`` in Python; kept as a named method so call
        sites document intent."""
        return copy.deepcopy(self)


def quantized_world_sizes(
    min_w: int,
    max_w: int,
    gpus_per_replica: int,
    global_batch_size: int,
    parallelism: Optional[ParallelismSpec] = None,
) -> List[int]:
    """World sizes in [min_w, max_w] the elastic runtime may form.

    A size ``w`` is legal when its full device mesh (w x GPUs) factors
    into the parallelism layout (dp = total / product must be whole)
    and, when a global batch is set, the batch extent (dp x fsdp =
    total / nonbatch product) divides it.  Shared by
    ``TrainingJob.legal_world_sizes`` (deployed path: the coordinator's
    ``--legal-sizes``) and the launcher/CLI local modes, so every mode
    quantizes identically."""
    par = parallelism or ParallelismSpec()
    gpus = max(1, gpus_per_replica)
    out = []
    for w in range(min_w, max_w + 1):
        total = w * gpus
        if total % par.product() != 0:
            continue
        if global_batch_size:
            extent = total // par.nonbatch_product()
            if global_batch_size % extent != 0:
                continue
        out.append(w)
    return out


def crd_manifest() -> Dict[str, Any]:
    """CustomResourceDefinition manifest registering TrainingJob
    (ref RegisterResource, pkg/resource/training_job.go:208-228 — the
    reference registers a client-side scheme; on modern k8s the CRD
    itself is an object we can emit)."""
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{PLURAL}.{GROUP}"},
        "spec": {
            "group": GROUP,
            "names": {
                "kind": KIND,
                "listKind": f"{KIND}List",
                "plural": PLURAL,
                "singular": "trainingjob",
            },
            "scope": "Namespaced",
            "versions": [
                {
                    "name": VERSION,
                    "served": True,
                    "storage": True,
                    "schema": {
                        "openAPIV3Schema": {
                            "type": "object",
                            "properties": {
                                "spec": {
                                    "type": "object",
                                    "x-kubernetes-preserve-unknown-fields": True,
                                },
                                "status": {
                                    "type": "object",
                                    "x-kubernetes-preserve-unknown-fields": True,
                                },
                            },
                        }
                    },
                    "subresources": {"status": {}},
                }
            ],
        },
    }
