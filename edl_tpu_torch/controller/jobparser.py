"""L2 job parsing: TrainingJob spec -> Kubernetes object manifests
(counterpart of ``edl_tpu/controller/jobparser.py``, for GPU nodes).

The reference's ``DefaultJobParser`` (``pkg/jobparser.go``) emitted
*three* objects per job — pserver ReplicaSet (``:74-112``), trainer
batch Job (``:115-158``), and a master ReplicaSet with an etcd v3.2.1
sidecar (``:194-232``).  Here gradient sync is an all-reduce inside the
step and the master+etcd pair is one lightweight coordinator, so a job
is exactly **two** manifests:

- trainer batch Job: ``parallelism`` = min_instance, ``RestartPolicy:
  Never`` (ref ``:153`` — scaled-down trainers must not be restarted by
  kubelet), one replica's GPUs via ``nvidia.com/gpu`` limits and the
  GKE H100 nodeSelector,
- coordinator Deployment of 1 + Service: membership/generation truth
  (replaces master+etcd).

The env contract replaces ``PADDLE_INIT_*`` (ref ``podEnv``,
``:265-313``): trainers get the coordinator address and static job
facts; rank and world size are *not* in env (they are membership facts
owned by the coordinator, because elasticity changes them mid-pod).
The trainer pod's env holds exactly the keys the port's launcher reads
(``launcher.env_config``): the JAX package's ``EDL_JAX_COORD_PORT`` is
``EDL_DIST_PORT`` here, and ``EDL_PARALLELISM``, ``EDL_SHARD_ONLY``,
``EDL_COMPILE_CACHE_DIR`` and ``EDL_NAMESPACE`` are not rendered.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from edl_tpu_torch.cluster.gpu_topology import get_topology
from edl_tpu_torch.cluster.kube import ACCELERATOR_LABEL, H100_ACCELERATOR
from edl_tpu_torch.resource.training_job import TrainingJob, GPU_RESOURCE_KEY

#: label selecting a job's *trainer* pods (ref label ``paddle-job``,
#: pkg/cluster.go:121).  The coordinator deliberately does NOT carry
#: it — pod counting (``Cluster.job_pods``) keys on this label, and a
#: coordinator counted as a trainer would mask the all-pods-pending
#: signal.  Coordinator objects use OWNER_LABEL instead.
JOB_LABEL = "edl-job"
OWNER_LABEL = "edl-owner"
ROLE_LABEL = "edl-role"
#: replica index label on a multi-host slice's per-replica Job/pods
REPLICA_LABEL = "edl-replica"


def owner_references(job: TrainingJob) -> List[Dict[str, Any]]:
    """ownerReference from the TrainingJob CR, stamped on every rendered
    workload so Kubernetes garbage-collects them when the CR is deleted
    (the reference relied on external cleanup; k8s ownership is the
    native fix).  Empty when the CR has no UID yet
    (dry-run rendering before the API server assigned one)."""
    if not job.uid:
        return []
    from edl_tpu_torch.resource.training_job import GROUP, KIND, VERSION

    return [
        {
            "apiVersion": f"{GROUP}/{VERSION}",
            "kind": KIND,
            "name": job.name,
            "uid": job.uid,
            "controller": True,
            "blockOwnerDeletion": False,
        }
    ]


#: Base port of the per-generation ``torch.distributed`` rendezvous; the
#: launcher derives EDL_POD_ADDRESS = $(EDL_POD_IP):$(EDL_DIST_PORT).
DIST_PORT = 8476


def pod_env(job: TrainingJob) -> List[Dict[str, Any]]:
    """Trainer-pod environment — the entire runtime contract
    (ref ``podEnv``, ``pkg/jobparser.go:265-313``): every key is one
    ``launcher.env_config`` reads."""
    t = job.spec.trainer
    env = [
        {"name": "EDL_JOB_NAME", "value": job.name},
        {"name": "EDL_COORDINATOR_ADDR", "value": f"{job.coordinator_name()}:{job.spec.port}"},
        {"name": "EDL_ENTRYPOINT", "value": t.entrypoint},
        {"name": "EDL_WORKSPACE", "value": t.workspace},
        {"name": "EDL_SLICE_TOPOLOGY", "value": t.slice_topology},
        {"name": "EDL_MIN_INSTANCE", "value": str(t.min_instance)},
        {"name": "EDL_MAX_INSTANCE", "value": str(t.max_instance)},
        {"name": "EDL_NUM_PASSES", "value": str(job.spec.passes)},
        {"name": "EDL_GLOBAL_BATCH_SIZE", "value": str(job.spec.global_batch_size)},
        {"name": "EDL_CHECKPOINT_INTERVAL", "value": str(job.spec.checkpoint_interval_steps)},
        {"name": "EDL_FAULT_TOLERANT", "value": "1" if job.spec.fault_tolerant else "0"},
        {"name": "EDL_DATA_DIR", "value": job.spec.dataset_dir},
        # Durable checkpoint dir (mounted volume): host-DRAM checkpoints
        # spill here; a cold start restores from it (whole-world loss
        # must not restart training at step 0 — the durability the
        # reference's etcd sidecar owned, ref pkg/jobparser.go:174-191).
        {"name": "EDL_CHECKPOINT_DIR", "value": job.spec.checkpoint_dir},
        # downward API (ref ``:302-312``)
        {
            "name": "EDL_POD_NAME",
            "valueFrom": {"fieldRef": {"fieldPath": "metadata.name"}},
        },
        {
            "name": "EDL_POD_IP",
            "valueFrom": {"fieldRef": {"fieldPath": "status.podIP"}},
        },
        {"name": "EDL_DIST_PORT", "value": str(DIST_PORT)},
    ]
    return env


def _trainer_resources(job: TrainingJob) -> Dict[str, Dict[str, Any]]:
    t = job.spec.trainer
    requests = dict(t.resources.requests)
    limits = dict(t.resources.limits)
    gpus = job.gpu_per_trainer()
    if gpus:
        limits[GPU_RESOURCE_KEY] = str(gpus)
        requests[GPU_RESOURCE_KEY] = str(gpus)
    return {"requests": requests, "limits": limits}


def _node_selector(topo) -> Dict[str, str]:
    """GKE GPU scheduling vocabulary: the accelerator type (replicas
    pack onto nodes by GPU count; no pool shape is asked for)."""
    if topo.gpus <= 0:
        return {}
    return {ACCELERATOR_LABEL: H100_ACCELERATOR}


def _trainer_metadata(
    job: TrainingJob, name: str, labels: Dict[str, str]
) -> Dict[str, Any]:
    metadata: Dict[str, Any] = {
        "name": name,
        "namespace": job.namespace,
        "labels": labels,
    }
    refs = owner_references(job)
    if refs:
        metadata["ownerReferences"] = refs
    return metadata


def _trainer_pod_template(
    job: TrainingJob,
    labels: Dict[str, str],
    extra_env: Optional[List[Dict[str, Any]]] = None,
    subdomain: str = "",
    resources: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The one trainer pod template both renderers share (single-host
    batch Job and multi-host per-replica Indexed Job) — env base, the
    rendezvous port, volumes, restartPolicy, GKE nodeSelector."""
    topo = get_topology(job.spec.trainer.slice_topology)
    spec: Dict[str, Any] = {
        "restartPolicy": "Never",  # ref :153
        "nodeSelector": _node_selector(topo),
        "containers": [
            {
                "name": "trainer",
                "image": job.spec.image,
                "command": ["python", "-m", "edl_tpu_torch.launcher"],
                "env": pod_env(job) + list(extra_env or ()),
                "resources": (
                    resources if resources is not None else _trainer_resources(job)
                ),
                "ports": [
                    # ONE port: the torch.distributed rendezvous base
                    # (the reference opened ports_num +
                    # ports_num_for_sparse pserver ports, :237-249)
                    {"name": "dist", "containerPort": DIST_PORT}
                ],
            }
        ],
        "volumes": list(job.spec.volumes),
    }
    if subdomain:
        spec["subdomain"] = subdomain
    return {"metadata": {"labels": dict(labels)}, "spec": spec}


#: Victim coordination depends on this field: the autoscaler gracefully
#: deletes the coordinator-chosen victims BEFORE lowering parallelism.
#: Under the default policy (TerminatingOrFailed) the Job controller
#: would replace still-Terminating victims while parallelism is briefly
#: unchanged, and the subsequent PUT could then kill an active-world
#: member.  "Failed" defers replacement until pods are fully terminal,
#: so active count == parallelism converges without the controller ever
#: choosing a victim (k8s >= 1.28; older servers drop the unknown field
#: and keep the reference's kube-chooses semantics).
_POD_REPLACEMENT_POLICY = "Failed"


def parse_to_trainer(job: TrainingJob) -> Dict[str, Any]:
    """Trainer batch Job manifest for single-host topologies
    (ref ``ParseToTrainer``, ``pkg/jobparser.go:115-158``).  Multi-host
    topologies render per-replica Indexed Jobs instead — use
    ``parse_to_trainer_manifests``."""
    if job.hosts_per_replica() > 1:
        raise ValueError(
            f"slice topology {job.spec.trainer.slice_topology!r} spans "
            f"{job.hosts_per_replica()} hosts; render it with "
            "parse_to_trainer_manifests (per-replica Indexed Jobs)"
        )
    t = job.spec.trainer
    labels = {JOB_LABEL: job.name, ROLE_LABEL: "trainer"}
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": _trainer_metadata(job, job.trainer_job_name(), labels),
        "spec": {
            "parallelism": t.min_instance,
            # completions unset: an elastic pool, not a run-to-N batch
            "backoffLimit": 0 if not job.spec.fault_tolerant else 1000000,
            "podReplacementPolicy": _POD_REPLACEMENT_POLICY,
            "template": _trainer_pod_template(job, labels),
        },
    }


def parse_to_trainer_slice(job: TrainingJob, replica: int) -> Dict[str, Any]:
    """One trainer REPLICA of a multi-host topology (``h100-16`` and
    up): an Indexed batch Job of ``hosts`` pods (completions ==
    parallelism == hosts), whole 8-GPU nodes of one pool.  Pod identity
    inside the replica comes from the completion index (k8s injects
    ``JOB_COMPLETION_INDEX``; the launcher registers it as the host
    index), and the headless trainer Service
    (``parse_to_trainer_manifests``) gives the replica's pods
    resolvable per-pod hostnames.  The reference's trainer Job was one
    flat pod pool (``pkg/jobparser.go:115-158``) — multi-host replicas
    need pod GROUPS, which is why scaling actuates in whole Jobs here
    (see ``Cluster.update_parallelism``).  Rendered and scheduled as
    the JAX package does; running a replica of several GPUs waits for
    NCCL worlds (ROADMAP A-8)."""
    hosts = job.hosts_per_replica()
    labels = {
        JOB_LABEL: job.name,
        ROLE_LABEL: "trainer",
        REPLICA_LABEL: str(replica),
    }
    base = _trainer_resources(job)
    # Per-POD GPUs = per-replica GPUs / hosts.
    per_host = str(job.gpu_per_host())
    resources = {
        "requests": {**base["requests"], GPU_RESOURCE_KEY: per_host},
        "limits": {**base["limits"], GPU_RESOURCE_KEY: per_host},
    }
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": _trainer_metadata(
            job, f"{job.trainer_job_name()}-{replica}", labels
        ),
        "spec": {
            "completionMode": "Indexed",
            "completions": hosts,
            "parallelism": hosts,
            "backoffLimit": 0 if not job.spec.fault_tolerant else 1000000,
            "podReplacementPolicy": _POD_REPLACEMENT_POLICY,
            "template": _trainer_pod_template(
                job,
                labels,
                extra_env=[{"name": "EDL_REPLICA", "value": str(replica)}],
                subdomain=job.trainer_job_name(),
                resources=resources,
            ),
        },
    }


def parse_to_trainer_manifests(
    job: TrainingJob,
    replicas: int = 0,
    indexes: Optional[List[int]] = None,
) -> List[Dict[str, Any]]:
    """All trainer manifests for a job at ``replicas`` replicas
    (default min_instance).  Single-host: one batch Job whose
    parallelism is the replica count.  Multi-host: one headless Service
    (stable per-pod DNS inside a replica) plus one Indexed Job per
    replica — the unit the autoscaler's actuation creates/deletes.
    ``indexes`` overrides WHICH replica indexes to render (a refresh of
    live non-contiguous replicas must re-apply the EXISTING Jobs, not
    conjure fresh low-index ones)."""
    replicas = replicas or job.spec.trainer.min_instance
    if job.hosts_per_replica() == 1:
        m = parse_to_trainer(job)
        m["spec"]["parallelism"] = replicas
        return [m]
    labels = {JOB_LABEL: job.name, ROLE_LABEL: "trainer"}
    headless = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": _trainer_metadata(job, job.trainer_job_name(), labels),
        "spec": {
            "clusterIP": "None",
            "selector": dict(labels),
            "ports": [{"name": "dist", "port": DIST_PORT}],
        },
    }
    if indexes is None:
        indexes = list(range(replicas))
    return [headless] + [parse_to_trainer_slice(job, r) for r in indexes]


def parse_to_coordinator(job: TrainingJob) -> List[Dict[str, Any]]:
    """Coordinator Deployment-of-1 + Service (replaces the reference's
    master ReplicaSet + etcd sidecar + hardcoded master resources,
    ``pkg/jobparser.go:160-232``)."""
    labels = {OWNER_LABEL: job.name, ROLE_LABEL: "coordinator"}
    res = job.spec.coordinator.resources
    resources = {
        "requests": dict(res.requests) or {"cpu": "250m", "memory": "256Mi"},
        "limits": dict(res.limits) or {"cpu": "1", "memory": "1Gi"},
    }
    refs = owner_references(job)
    coord_meta: Dict[str, Any] = {
        "name": job.coordinator_name(),
        "namespace": job.namespace,
        "labels": labels,
    }
    if refs:
        coord_meta["ownerReferences"] = refs
    deployment = {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": dict(coord_meta),
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": dict(labels)},
            "template": {
                "metadata": {"labels": dict(labels)},
                "spec": {
                    "containers": [
                        {
                            "name": "coordinator",
                            "image": job.spec.image,
                            "command": [
                                "python",
                                "-m",
                                "edl_tpu_torch.runtime.coord_service",
                                "--port",
                                str(job.spec.port),
                                "--min-world",
                                str(job.spec.trainer.min_instance),
                                "--max-world",
                                str(job.spec.trainer.max_instance),
                                # batch-divisibility quantization: without
                                # this a transient membership count (e.g. 5
                                # of 8 pods up) would form an illegal world
                                "--legal-sizes",
                                ",".join(str(w) for w in job.legal_world_sizes()),
                                # generous lease: a resize window (flush
                                # + restore) must not outlive it
                                "--heartbeat-timeout",
                                "30",
                                # multi-host replicas: pods group into
                                # replicas of this many hosts
                                "--hosts",
                                str(job.hosts_per_replica()),
                            ],
                            "env": [
                                {"name": "EDL_JOB_NAME", "value": job.name},
                            ],
                            "resources": resources,
                            "ports": [
                                {"name": "coord", "containerPort": job.spec.port}
                            ],
                        }
                    ],
                },
            },
        },
    }
    service = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": dict(coord_meta),
        "spec": {
            "selector": dict(labels),
            "ports": [{"name": "coord", "port": job.spec.port}],
        },
    }
    return [deployment, service]


#: graceful-drain budget for serving replicas (EDL_SERVE_DRAIN_MS) and
#: the pod grace period sized above it: SIGTERM -> drain (close
#: admission, finish in-flight, free KV, deregister) -> exit, with the
#: kubelet's SIGKILL arriving only after the budget + margin
SERVE_DRAIN_MS = 30000
SERVE_TERMINATION_GRACE_S = 45

#: the fleet front door's listen port and routing knobs (the
#: ``EDL_ROUTE_*`` contract ``edl_tpu_torch.serving.router.main`` reads):
#: per-request retry budget, active-probe cadence, and the
#: consecutive-failure count that ejects a replica from rotation
ROUTE_PORT = 7190
ROUTE_RETRY_BUDGET_MS = 10000
ROUTE_PROBE_MS = 500
ROUTE_EJECT_AFTER = 3


def router_pod_env(job: TrainingJob) -> List[Dict[str, Any]]:
    """Router pod environment: the ``EDL_ROUTE_*`` contract
    (``edl_tpu_torch.serving.router.main`` reads it) plus the serving
    coordinator address the router feeds from — plan membership,
    merged telemetry, and drain flight events all come from there."""
    return [
        {"name": "EDL_JOB_NAME", "value": job.name},
        {
            "name": "EDL_COORDINATOR_ADDR",
            "value": f"{job.serving_coordinator_name()}:{job.spec.port}",
        },
        {"name": "EDL_ROUTE_PORT", "value": str(ROUTE_PORT)},
        {
            "name": "EDL_ROUTE_RETRY_BUDGET_MS",
            "value": str(ROUTE_RETRY_BUDGET_MS),
        },
        {"name": "EDL_ROUTE_PROBE_MS", "value": str(ROUTE_PROBE_MS)},
        {
            "name": "EDL_ROUTE_EJECT_AFTER",
            "value": str(ROUTE_EJECT_AFTER),
        },
    ]


def serving_pod_env(job: TrainingJob) -> List[Dict[str, Any]]:
    """Serving-replica pod environment: the ``EDL_SERVE_*`` contract
    (``edl_tpu_torch.serving.server.serve_run`` reads it) plus the shared
    facts serving inherits from the job — entrypoint (the model to
    serve) and the durable checkpoint dir (the weights source training
    spills into).  The JAX package's ``EDL_COMPILE_CACHE_DIR`` has no
    counterpart here."""
    sv = job.spec.serving
    t = job.spec.trainer
    return [
        {"name": "EDL_JOB_NAME", "value": job.name},
        {
            "name": "EDL_COORDINATOR_ADDR",
            "value": f"{job.serving_coordinator_name()}:{job.spec.port}",
        },
        {"name": "EDL_ENTRYPOINT", "value": t.entrypoint},
        {"name": "EDL_WORKSPACE", "value": t.workspace},
        {"name": "EDL_CHECKPOINT_DIR", "value": job.spec.checkpoint_dir},
        {"name": "EDL_SERVE_PORT", "value": str(sv.port)},
        {"name": "EDL_SERVE_MAX_BATCH", "value": str(sv.max_batch)},
        {"name": "EDL_SERVE_QUEUE_LIMIT", "value": str(sv.queue_limit)},
        {"name": "EDL_SERVE_DEADLINE_MS", "value": str(sv.deadline_ms)},
        # graceful-drain budget: the SIGTERM handler closes admission
        # and lets in-flight generations finish for this long before
        # the replica exits (terminationGracePeriodSeconds below is
        # sized ABOVE it so the kubelet's SIGKILL never beats a drain)
        {"name": "EDL_SERVE_DRAIN_MS", "value": str(SERVE_DRAIN_MS)},
        {
            "name": "EDL_POD_NAME",
            "valueFrom": {"fieldRef": {"fieldPath": "metadata.name"}},
        },
    ]


def parse_to_serving_manifests(job: TrainingJob) -> List[Dict[str, Any]]:
    """Serving fleet manifests (empty when ``spec.serving`` is unset):

    - a SEPARATE serving coordinator Deployment-of-1 + Service — the
      serving world's membership/telemetry truth.  Separate on purpose:
      a serving replica registering with the *training* coordinator
      would join the training plan's rank order and drag inference pods
      through training resize barriers;
    - the replica Deployment (``min_replicas``; the autoscaler's
      serving lane drives the coordinator target between min and max,
      and the Deployment's replica count follows via the lane's kube
      glue) + the front Service routing ``/predict``.
    """
    if job.spec.serving is None:
        return []
    sv = job.spec.serving
    coord_labels = {OWNER_LABEL: job.name, ROLE_LABEL: "serve-coordinator"}
    refs = owner_references(job)

    def meta(name: str, labels: Dict[str, str]) -> Dict[str, Any]:
        m: Dict[str, Any] = {
            "name": name,
            "namespace": job.namespace,
            "labels": dict(labels),
        }
        if refs:
            m["ownerReferences"] = refs
        return m

    coord = {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": meta(job.serving_coordinator_name(), coord_labels),
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": dict(coord_labels)},
            "template": {
                "metadata": {"labels": dict(coord_labels)},
                "spec": {
                    "containers": [
                        {
                            "name": "coordinator",
                            "image": job.spec.image,
                            "command": [
                                "python",
                                "-m",
                                "edl_tpu_torch.runtime.coord_service",
                                "--port",
                                str(job.spec.port),
                                "--min-world",
                                str(sv.min_replicas),
                                "--max-world",
                                str(sv.max_replicas),
                                "--heartbeat-timeout",
                                "30",
                            ],
                            "env": [
                                {"name": "EDL_JOB_NAME", "value": job.name}
                            ],
                            "ports": [
                                {
                                    "name": "coord",
                                    "containerPort": job.spec.port,
                                }
                            ],
                        }
                    ],
                },
            },
        },
    }
    coord_svc = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": meta(job.serving_coordinator_name(), coord_labels),
        "spec": {
            "selector": dict(coord_labels),
            "ports": [{"name": "coord", "port": job.spec.port}],
        },
    }
    labels = {OWNER_LABEL: job.name, ROLE_LABEL: "server"}
    res = sv.resources
    resources = {
        "requests": dict(res.requests) or {"cpu": "1", "memory": "2Gi"},
        "limits": dict(res.limits) or {"cpu": "2", "memory": "4Gi"},
    }
    deployment = {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": meta(job.serving_name(), labels),
        "spec": {
            "replicas": sv.min_replicas,
            "selector": {"matchLabels": dict(labels)},
            "template": {
                "metadata": {"labels": dict(labels)},
                "spec": {
                    # pod deletion = SIGTERM -> graceful drain; SIGKILL
                    # only after the drain budget + margin has passed
                    "terminationGracePeriodSeconds": (
                        SERVE_TERMINATION_GRACE_S
                    ),
                    "containers": [
                        {
                            "name": "server",
                            "image": job.spec.image,
                            "command": [
                                "python",
                                "-m",
                                "edl_tpu_torch.serving.server",
                            ],
                            "env": serving_pod_env(job),
                            "resources": resources,
                            "ports": [
                                {
                                    "name": "predict",
                                    "containerPort": sv.port,
                                }
                            ],
                        }
                    ],
                    "volumes": list(job.spec.volumes),
                },
            },
        },
    }
    front = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": meta(job.serving_name(), labels),
        "spec": {
            "selector": dict(labels),
            "ports": [{"name": "predict", "port": sv.port}],
        },
    }
    # The fleet front door: a routerd Deployment-of-1 + the
    # Service clients actually point at.  Replicas keep their own
    # Service (the router dials them by plan address, and the lane's
    # kube glue still needs it), but the published entry point is the
    # router — it steers around drains, absorbs replica churn, and
    # re-drives cut streams so clients never see the 503s beneath it.
    router_labels = {OWNER_LABEL: job.name, ROLE_LABEL: "router"}
    router = {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": meta(job.router_name(), router_labels),
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": dict(router_labels)},
            "template": {
                "metadata": {"labels": dict(router_labels)},
                "spec": {
                    "containers": [
                        {
                            "name": "router",
                            "image": job.spec.image,
                            "command": [
                                "python",
                                "-m",
                                "edl_tpu_torch.serving.router",
                            ],
                            "env": router_pod_env(job),
                            "ports": [
                                {
                                    "name": "route",
                                    "containerPort": ROUTE_PORT,
                                }
                            ],
                        }
                    ],
                },
            },
        },
    }
    router_svc = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": meta(job.router_name(), router_labels),
        "spec": {
            "selector": dict(router_labels),
            "ports": [{"name": "route", "port": ROUTE_PORT}],
        },
    }
    return [coord, coord_svc, deployment, front, router, router_svc]


class JobParser:
    """ref ``JobParser`` interface (``pkg/jobparser.go:36-41``), minus
    ``ParseToPserver`` (no pservers here).  ``validate`` lives on the
    TrainingJob itself (``resource/training_job.py``)."""

    def validate(self, job: TrainingJob) -> TrainingJob:
        return job.validate()

    def parse_to_trainer(self, job: TrainingJob) -> Dict[str, Any]:
        return parse_to_trainer(job)

    def parse_to_coordinator(self, job: TrainingJob) -> List[Dict[str, Any]]:
        return parse_to_coordinator(job)
