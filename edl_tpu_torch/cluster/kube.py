"""The Kubernetes I/O boundary: a thin interface + an in-memory fake
(counterpart of ``edl_tpu/cluster/kube.py``, with GPU nodes).

The reference's ``Cluster`` talks straight to client-go and is therefore
untestable (SURVEY.md §4: "What is *not* tested: Cluster (all k8s
I/O)").  We keep the same *surface* but put it behind ``KubeAPI`` so the
decision and control planes are testable against ``FakeKube`` — which
also emulates the external actors the reference system leaned on:

- the **kube Job controller** turning ``parallelism`` changes into pod
  creation/deletion (ref relies on it after the PUT,
  ``pkg/autoscaler.go:339-376``),
- the **scheduler** binding pods to nodes with capacity, leaving the
  rest ``Pending``.

``KubectlAPI`` adapts the same interface onto a real cluster through
the ``kubectl`` binary (no python k8s client dependency).
"""

from __future__ import annotations

import json
import subprocess
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

#: GKE's accelerator node label and its value on H100 nodes; the
#: jobparser's nodeSelector asks for it and ``fake_kubectl`` sets it.
ACCELERATOR_LABEL = "cloud.google.com/gke-accelerator"
H100_ACCELERATOR = "nvidia-h100-80gb"


@dataclass
class NodeInfo:
    """Allocatable capacity of one node/pool (the inventory unit of
    ref ``InquiryResource``, ``pkg/cluster.go:176-242``)."""

    name: str
    cpu_milli: int = 0
    memory_mega: int = 0
    gpus: int = 0
    #: replica topology this pool schedules whole ("h100-16"), or "" to
    #: place by GPU count.  GPU nodes carry no slice label, so
    #: ``KubectlAPI`` leaves it empty (the reference counted GPUs per
    #: node, ``pkg/cluster.go:224-234``); only a FakeKube declares it.
    gpu_topology: str = ""
    #: nodepool identity (GKE ``cloud.google.com/gke-nodepool``): a
    #: hosts>1 replica must place all its pods inside a single pool
    pool: str = ""


@dataclass
class PodInfo:
    name: str
    job_name: str  # label paddle-job analog: edl-job=<name>
    phase: str = "Pending"  # Pending | Running | Succeeded | Failed
    node: str = ""
    cpu_request_milli: int = 0
    memory_request_mega: int = 0
    gpu_limit: int = 0
    deleting: bool = False  # DeletionTimestamp set (ref pkg/cluster.go:127-131)
    #: owning workload name — distinct from job_name when a job renders
    #: several per-replica slice Jobs sharing one edl-job label
    workload: str = ""
    #: creationTimestamp (RFC3339, sorts lexicographically) — victim
    #: ordering for scale-down: newest pod first.  "" = unknown.
    created: str = ""


@dataclass
class WorkloadInfo:
    """The trainer workload: name + parallelism (the one mutable knob,
    ref ``Job.Spec.Parallelism``) + per-replica resources."""

    name: str
    job_name: str
    parallelism: int
    cpu_request_milli: int = 0
    memory_request_mega: int = 0
    gpu_limit: int = 0
    resource_version: int = 0
    #: k8s kind ("Job" for trainers, "Deployment" for coordinators)
    kind: str = "Job"
    #: owning TrainingJob name (from the edl-job / edl-owner label);
    #: empty for workloads the framework does not own.  Drives the
    #: controller's level-triggered orphan GC.
    owner: str = ""


def node_from_manifest(it: dict) -> NodeInfo:
    """Project a Node object (``kubectl get nodes -o json``) onto the
    inventory view.  A GPU node's allocatable ``nvidia.com/gpu`` is all
    that is read of its accelerators: no pool shape is derived from it,
    so replicas pack onto it by GPU count."""
    from edl_tpu_torch.utils.quantity import (
        parse_count,
        parse_cpu_milli,
        parse_memory_mega,
    )

    alloc = it["status"].get("allocatable", {})
    labels = it["metadata"].get("labels", {})
    return NodeInfo(
        name=it["metadata"]["name"],
        cpu_milli=parse_cpu_milli(alloc.get("cpu", 0)),
        memory_mega=parse_memory_mega(alloc.get("memory", 0)),
        gpus=parse_count(alloc.get("nvidia.com/gpu", 0)),
        pool=labels.get("cloud.google.com/gke-nodepool", ""),
    )


class ConflictError(RuntimeError):
    """Optimistic-concurrency conflict (stale resourceVersion) — the
    reason the reference retried updates 5 times (``pkg/autoscaler.go:
    346-370``)."""


def _workload_from_manifest(m: dict) -> WorkloadInfo:
    """Project a rendered Job/Deployment manifest onto the WorkloadInfo
    view (name, parallelism knob, per-replica resources)."""
    from edl_tpu_torch.utils.quantity import (
        parse_count,
        parse_cpu_milli,
        parse_memory_mega,
    )

    kind = m["kind"]
    meta = m["metadata"]
    spec = m["spec"]
    parallelism = (
        spec.get("parallelism", 1) if kind == "Job" else spec.get("replicas", 1)
    )
    cpu = mem = gpu = 0
    for c in spec.get("template", {}).get("spec", {}).get("containers", []):
        req = c.get("resources", {}).get("requests", {})
        lim = c.get("resources", {}).get("limits", {})
        cpu += parse_cpu_milli(req.get("cpu", 0))
        mem += parse_memory_mega(req.get("memory", 0))
        gpu += parse_count(lim.get("nvidia.com/gpu", 0))
    labels = meta.get("labels", {})
    # Trainer Jobs carry the pod-counting label; coordinator Deployments
    # must NOT be counted as trainer pods (see jobparser OWNER_LABEL).
    job_name = labels.get("edl-job", meta["name"]) if kind == "Job" else meta["name"]
    return WorkloadInfo(
        name=meta["name"],
        job_name=job_name,
        parallelism=parallelism,
        cpu_request_milli=cpu,
        memory_request_mega=mem,
        gpu_limit=gpu,
        kind=kind,
        owner=labels.get("edl-job", labels.get("edl-owner", "")),
    )


class KubeAPI:
    """Everything the framework asks of Kubernetes.  One process
    boundary, kept narrow on purpose."""

    # inventory
    def list_nodes(self) -> List[NodeInfo]:
        raise NotImplementedError

    def list_pods(self) -> List[PodInfo]:
        raise NotImplementedError

    # trainer workload CRUD (ref pkg/cluster.go:91-113, 245-291)
    def get_workload(
        self, name: str, kind: str = "Job"
    ) -> Optional[WorkloadInfo]:
        """Fetch one workload by name.  ``kind`` routes the lookup on
        backends whose API is kind-scoped (kubectl); name-keyed
        backends (FakeKube) may ignore it."""
        raise NotImplementedError

    def list_workloads(self) -> List[WorkloadInfo]:
        """All framework-owned workloads (trainer Jobs + coordinator
        Deployments), for level-triggered reconciliation: the controller
        compares them against the live CR set and GCs orphans."""
        raise NotImplementedError

    def apply_manifests(self, manifests: List[dict]) -> None:
        """Create-or-update rendered k8s manifests (the jobparser's
        output).  This is the creation path — the reference's TODO
        (``pkg/controller.go:115-133``) wired for real."""
        raise NotImplementedError

    def update_workload(self, w: WorkloadInfo) -> WorkloadInfo:
        raise NotImplementedError

    def delete_workload(self, name: str) -> bool:
        raise NotImplementedError

    def delete_pod(self, name: str) -> bool:
        """Gracefully delete one named pod (scale-down victim
        coordination): the pod gets SIGTERM and enters Terminating; the
        kube Job controller then converges a lowered parallelism
        without choosing its own victim.  Returns False when the pod
        does not exist."""
        raise NotImplementedError

    def update_training_job_status(
        self, name: str, status: dict, namespace: Optional[str] = None
    ) -> bool:
        """Write the controller's status view to the CR's status
        subresource so ``kubectl get trainingjobs`` tells the truth —
        the reference declared ``TrainingJobStatus`` and never wrote it
        (SURVEY.md §5.5).  Default no-op: backends without CR storage
        (in-memory FakeKube) simply skip it."""
        return False


class FakeKube(KubeAPI):
    """In-memory cluster with a synchronous Job-controller + scheduler
    emulation: every mutation immediately reconciles pods to the
    declared parallelism and binds what fits onto nodes.

    Tests fabricate multi-node state as literals, exactly the
    reference's test philosophy (SURVEY.md §4) — but with the actuation
    half actually closed-loop.
    """

    def __init__(
        self,
        nodes: Optional[List[NodeInfo]] = None,
        scale_down_victim: str = "newest",
    ):
        self._lock = threading.RLock()
        self.nodes: Dict[str, NodeInfo] = {n.name: n for n in (nodes or [])}
        self.workloads: Dict[str, WorkloadInfo] = {}
        self.pods: Dict[str, PodInfo] = {}
        self.services: Dict[str, dict] = {}
        self._pod_seq = 0
        #: names of workloads whose pods must stay Pending (test knob to
        #: simulate unschedulable jobs beyond capacity math)
        self.hold_pending: set = set()
        #: which pod the emulated Job controller kills when parallelism
        #: drops below the live count.  "newest" (highest index) happens
        #: to match the coordinator's drop-newest rank order; "oldest"
        #: is the adversarial mode — the real controller makes no such
        #: promise, so tests use it to prove the autoscaler's named
        #: victim deletion matters.
        if scale_down_victim not in ("newest", "oldest"):
            raise ValueError(f"unknown scale_down_victim {scale_down_victim!r}")
        self.scale_down_victim = scale_down_victim

    # -- inventory ----------------------------------------------------------
    def list_nodes(self) -> List[NodeInfo]:
        with self._lock:
            return [NodeInfo(**vars(n)) for n in self.nodes.values()]

    def list_pods(self) -> List[PodInfo]:
        with self._lock:
            return [PodInfo(**vars(p)) for p in self.pods.values()]

    # -- workload CRUD ------------------------------------------------------
    def get_workload(
        self, name: str, kind: str = "Job"
    ) -> Optional[WorkloadInfo]:
        with self._lock:
            w = self.workloads.get(name)  # name-keyed; kind advisory
            return WorkloadInfo(**vars(w)) if w else None

    def list_workloads(self) -> List[WorkloadInfo]:
        with self._lock:
            return [WorkloadInfo(**vars(w)) for w in self.workloads.values()]

    def create_workload(self, w: WorkloadInfo) -> WorkloadInfo:
        with self._lock:
            if w.name in self.workloads:
                raise ConflictError(f"workload {w.name} already exists")
            stored = WorkloadInfo(**vars(w))
            stored.resource_version = 1
            self.workloads[w.name] = stored
            self._reconcile(stored)
            return WorkloadInfo(**vars(stored))

    def update_workload(self, w: WorkloadInfo) -> WorkloadInfo:
        with self._lock:
            cur = self.workloads.get(w.name)
            if cur is None:
                raise KeyError(f"no workload {w.name}")
            if w.resource_version != cur.resource_version:
                raise ConflictError(
                    f"stale resourceVersion {w.resource_version} != {cur.resource_version}"
                )
            cur.parallelism = w.parallelism
            cur.resource_version += 1
            self._reconcile(cur)
            return WorkloadInfo(**vars(cur))

    def delete_workload(self, name: str) -> bool:
        with self._lock:
            svc = self.services.pop(name, None)
            w = self.workloads.pop(name, None)
            if w is None:
                return svc is not None
            for pname in [
                p
                for p, pod in self.pods.items()
                if (
                    pod.workload == name
                    if pod.workload
                    else pod.job_name == w.job_name
                )
            ]:
                del self.pods[pname]
            return True

    def delete_pod(self, name: str) -> bool:
        with self._lock:
            p = self.pods.get(name)
            if p is None or p.deleting:
                return False
            # Graceful delete: Terminating until the controller's next
            # reconcile purges it (emulates the SIGTERM grace window —
            # the launcher's graceful-leave handshake runs inside it).
            p.deleting = True
            return True

    # -- manifest application -------------------------------------------------
    def apply_manifests(self, manifests: List[dict]) -> None:
        """Interpret the jobparser's real manifests — so FakeKube tests
        exercise the identical creation path a live cluster gets."""
        for m in manifests:
            kind = m.get("kind", "")
            if kind == "Service":
                with self._lock:
                    self.services[m["metadata"]["name"]] = m
                continue
            if kind not in ("Job", "Deployment"):
                raise ValueError(f"FakeKube cannot apply kind {kind!r}")
            w = _workload_from_manifest(m)
            with self._lock:
                cur = self.workloads.get(w.name)
                if cur is None:
                    self.create_workload(w)
                else:
                    cur.parallelism = w.parallelism
                    cur.resource_version += 1
                    self._reconcile(cur)

    # -- controller + scheduler emulation ------------------------------------
    def _workload_pods(self, w: WorkloadInfo) -> List[PodInfo]:
        """Live (non-Terminating) pods owned by one workload.  Matching
        by workload name, not job label: a multi-host job's per-replica
        slice Jobs share the edl-job label but reconcile separately."""
        return [
            p
            for p in self.pods.values()
            if not p.deleting
            and (p.workload == w.name if p.workload else p.job_name == w.job_name)
        ]

    def _free_on(self, node: NodeInfo) -> Tuple[int, int, int]:
        used_cpu = used_mem = used_gpu = 0
        for p in self.pods.values():
            if p.node == node.name and p.phase in ("Pending", "Running"):
                used_cpu += p.cpu_request_milli
                used_mem += p.memory_request_mega
                used_gpu += p.gpu_limit
        return (
            node.cpu_milli - used_cpu,
            node.memory_mega - used_mem,
            node.gpus - used_gpu,
        )

    def _reconcile(self, w: WorkloadInfo):
        """Kube Job controller: match pod count to parallelism.
        Terminating (gracefully deleted) pods are purged first — by the
        time the controller acts on a new parallelism, named victims
        deleted just before the PUT are already on their way out and
        don't count toward the live set.  Any remaining excess is
        killed per ``scale_down_victim``."""
        for pname in [
            p
            for p, pod in self.pods.items()
            if pod.job_name == w.job_name and pod.deleting
        ]:
            del self.pods[pname]
        pods = sorted(self._workload_pods(w), key=lambda p: p.name)
        while len(pods) > w.parallelism:
            victim = (
                pods.pop() if self.scale_down_victim == "newest" else pods.pop(0)
            )
            del self.pods[victim.name]
        while len(pods) < w.parallelism:
            self._pod_seq += 1
            p = PodInfo(
                # zero-padded so lexicographic name order == creation order
                name=f"{w.job_name}-pod-{self._pod_seq:06d}",
                created=f"{self._pod_seq:06d}",  # monotonic, sortable
                job_name=w.job_name,
                cpu_request_milli=w.cpu_request_milli,
                memory_request_mega=w.memory_request_mega,
                gpu_limit=w.gpu_limit,
                workload=w.name,
            )
            self.pods[p.name] = p
            pods.append(p)
        self._schedule()

    def _schedule(self):
        """Bind Pending pods to nodes with room; leave the rest Pending."""
        for p in sorted(self.pods.values(), key=lambda p: p.name):
            if p.phase != "Pending" or p.node or p.job_name in self.hold_pending:
                continue
            for node in sorted(self.nodes.values(), key=lambda n: n.name):
                free_cpu, free_mem, free_gpu = self._free_on(node)
                if (
                    p.cpu_request_milli <= free_cpu
                    and p.memory_request_mega <= free_mem
                    and p.gpu_limit <= free_gpu
                ):
                    p.node = node.name
                    p.phase = "Running"
                    break

    # -- test helpers --------------------------------------------------------
    def complete_pods(self, job_name: str):
        """Test knob: all of a job's pods run to completion (the kube
        Job controller leaves Succeeded pods in place)."""
        with self._lock:
            for p in self.pods.values():
                if p.job_name == job_name:
                    p.phase = "Succeeded"

    def kill_pod(self, name: str):
        """Simulate a pod death (node failure, preemption)."""
        with self._lock:
            self.pods.pop(name, None)
            # The Job controller would re-create it:
            for w in self.workloads.values():
                self._reconcile(w)

    def retry_scheduling(self):
        with self._lock:
            self._schedule()


class KubectlAPI(KubeAPI):  # pragma: no cover - needs a real cluster
    """Real-cluster adapter via the ``kubectl`` binary (the baked-in
    image has no python k8s client; shelling out keeps the dependency
    surface zero).  Only the subset the framework uses."""

    def __init__(self, namespace: str = "default", kubectl: str = "kubectl"):
        self.namespace = namespace
        self.kubectl = kubectl

    def _run(self, *args: str) -> dict:
        out = subprocess.run(
            [self.kubectl, "-n", self.namespace, *args, "-o", "json"],
            capture_output=True,
            text=True,
            check=True,
        )
        return json.loads(out.stdout)

    def list_nodes(self) -> List[NodeInfo]:
        return [node_from_manifest(it) for it in self._run("get", "nodes")["items"]]

    def list_pods(self) -> List[PodInfo]:
        from edl_tpu_torch.utils.quantity import (
            parse_count,
            parse_cpu_milli,
            parse_memory_mega,
        )

        items = self._run("get", "pods")["items"]
        pods = []
        for it in items:
            cpu = mem = gpu = 0
            for c in it["spec"].get("containers", []):
                req = c.get("resources", {}).get("requests", {})
                lim = c.get("resources", {}).get("limits", {})
                cpu += parse_cpu_milli(req.get("cpu", 0))
                mem += parse_memory_mega(req.get("memory", 0))
                gpu += parse_count(lim.get("nvidia.com/gpu", 0))
            pods.append(
                PodInfo(
                    name=it["metadata"]["name"],
                    job_name=it["metadata"].get("labels", {}).get("edl-job", ""),
                    phase=it["status"].get("phase", "Pending"),
                    node=it["spec"].get("nodeName", ""),
                    cpu_request_milli=cpu,
                    memory_request_mega=mem,
                    gpu_limit=gpu,
                    deleting="deletionTimestamp" in it["metadata"],
                    created=it["metadata"].get("creationTimestamp", ""),
                )
            )
        return pods

    def get_workload(
        self, name: str, kind: str = "Job"
    ) -> Optional[WorkloadInfo]:
        try:
            it = self._run("get", kind.lower(), name)
        except subprocess.CalledProcessError:
            return None
        spec = it["spec"]
        tmpl = spec["template"]["spec"]["containers"][0]
        from edl_tpu_torch.utils.quantity import (
            parse_count,
            parse_cpu_milli,
            parse_memory_mega,
        )

        req = tmpl.get("resources", {}).get("requests", {})
        lim = tmpl.get("resources", {}).get("limits", {})
        labels = it["metadata"].get("labels", {})
        return WorkloadInfo(
            name=name,
            job_name=labels.get("edl-job", name),
            parallelism=spec.get(
                "parallelism", spec.get("replicas", 0)
            ),
            cpu_request_milli=parse_cpu_milli(req.get("cpu", 0)),
            memory_request_mega=parse_memory_mega(req.get("memory", 0)),
            gpu_limit=parse_count(lim.get("nvidia.com/gpu", 0)),
            resource_version=int(it["metadata"]["resourceVersion"]),
            kind=it.get("kind", kind),
            owner=labels.get("edl-job", labels.get("edl-owner", "")),
        )

    def list_workloads(self) -> List[WorkloadInfo]:
        """Framework-owned workloads via label selectors: trainer Jobs
        carry ``edl-job``, coordinator Deployments ``edl-owner``."""
        out: List[WorkloadInfo] = []
        for kind_plural, kind, selector in (
            ("jobs", "Job", "edl-job"),
            ("deployments", "Deployment", "edl-owner"),
        ):
            try:
                items = self._run("get", kind_plural, "-l", selector)["items"]
            except subprocess.CalledProcessError:
                continue
            for it in items:
                labels = it["metadata"].get("labels", {})
                out.append(
                    WorkloadInfo(
                        name=it["metadata"]["name"],
                        job_name=labels.get("edl-job", it["metadata"]["name"]),
                        parallelism=it["spec"].get(
                            "parallelism", it["spec"].get("replicas", 1)
                        ),
                        resource_version=int(
                            it["metadata"].get("resourceVersion", 0)
                        ),
                        kind=kind,
                        owner=labels.get(
                            "edl-job", labels.get("edl-owner", "")
                        ),
                    )
                )
        return out

    def update_workload(self, w: WorkloadInfo) -> WorkloadInfo:
        # Include resourceVersion in the merge patch so the API server
        # enforces the optimistic-concurrency precondition; a 409 maps to
        # ConflictError so Cluster.update_parallelism's retry loop works
        # identically against FakeKube and a real cluster.  The knob
        # follows the kind: batch Jobs scale through spec.parallelism,
        # Deployments (the serving replica fleet) through spec.replicas.
        knob = "replicas" if w.kind == "Deployment" else "parallelism"
        patch = {
            "metadata": {"resourceVersion": str(w.resource_version)},
            "spec": {knob: w.parallelism},
        }
        r = subprocess.run(
            [
                self.kubectl,
                "-n",
                self.namespace,
                "patch",
                w.kind.lower(),
                w.name,
                "--type=merge",
                "-p",
                json.dumps(patch),
            ],
            capture_output=True,
            text=True,
        )
        if r.returncode != 0:
            msg = r.stderr or r.stdout
            if "Conflict" in msg or "the object has been modified" in msg:
                raise ConflictError(msg.strip())
            raise RuntimeError(f"kubectl patch failed: {msg.strip()}")
        return self.get_workload(w.name, kind=w.kind)

    def update_training_job_status(
        self, name: str, status: dict, namespace: Optional[str] = None
    ) -> bool:
        r = subprocess.run(
            [
                self.kubectl,
                "-n",
                namespace or self.namespace,
                "patch",
                "trainingjob",
                name,
                "--subresource=status",
                "--type=merge",
                "-p",
                json.dumps({"status": status}),
            ],
            capture_output=True,
            text=True,
        )
        return r.returncode == 0

    def list_training_jobs(self) -> List[dict]:
        """All TrainingJob CRs across namespaces (the watch source,
        ref informer ListWatch ``pkg/controller.go:80-85``)."""
        r = subprocess.run(
            [self.kubectl, "get", "trainingjobs", "-A", "-o", "json"],
            capture_output=True,
            text=True,
        )
        if r.returncode != 0:
            raise RuntimeError(
                f"kubectl get trainingjobs failed: {(r.stderr or r.stdout).strip()}"
            )
        return json.loads(r.stdout).get("items", [])

    def apply_manifests(self, manifests: List[dict]) -> None:
        payload = json.dumps({"apiVersion": "v1", "kind": "List", "items": manifests})
        r = subprocess.run(
            [self.kubectl, "-n", self.namespace, "apply", "-f", "-"],
            input=payload,
            capture_output=True,
            text=True,
        )
        if r.returncode != 0:
            raise RuntimeError(
                f"kubectl apply failed: {(r.stderr or r.stdout).strip()}"
            )

    def delete_workload(self, name: str) -> bool:
        """Delete by name across the kinds a job owns: trainer batch
        Job, or coordinator Deployment + Service (same name)."""
        deleted = False
        for kind in ("job", "deployment", "service"):
            r = subprocess.run(
                [
                    self.kubectl,
                    "-n",
                    self.namespace,
                    "delete",
                    kind,
                    name,
                    "--ignore-not-found",
                ],
                capture_output=True,
                text=True,
            )
            if r.returncode == 0 and r.stdout.strip():
                deleted = True
        return deleted

    def delete_pod(self, name: str) -> bool:
        """Graceful named-pod delete (``--wait=false``: the pod keeps
        its SIGTERM grace window; the control loop must not block on
        it)."""
        r = subprocess.run(
            [
                self.kubectl,
                "-n",
                self.namespace,
                "delete",
                "pod",
                name,
                "--wait=false",
                "--ignore-not-found",
            ],
            capture_output=True,
            text=True,
        )
        return r.returncode == 0 and bool(r.stdout.strip())
