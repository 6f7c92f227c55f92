"""A ``kubectl`` stand-in backed by FakeKube, for end-to-end control
plane tests without a cluster (counterpart of
``edl_tpu/cluster/fake_kubectl.py``).

Each invocation loads cluster state from the JSON file named by
``EDL_FAKE_KUBE_STATE``, performs one kubectl-shaped operation through
the *real* ``FakeKube`` implementation (so the Job-controller +
scheduler emulation applies), and writes the state back.  Point
``KubectlAPI(kubectl=<shim>)`` — where the shim execs
``python -m edl_tpu_torch.cluster.fake_kubectl "$@"`` — at it and the entire
KubectlAPI surface (get/apply/patch/delete, TrainingJob CRs) runs
against deterministic in-memory semantics.

Supported verb shapes (exactly what ``KubectlAPI`` and the CLI emit):

- ``get nodes|pods|trainingjobs [-A] -o json``
- ``get job <name> -o json``
- ``apply -f -``                     (JSON List on stdin)
- ``patch job <name> --type=merge -p <json>``
- ``delete job|deployment|service|trainingjob|pod <name> [--ignore-not-found]``
"""

from __future__ import annotations

import json
import os
import sys
from typing import List

from edl_tpu_torch.cluster.kube import (
    ACCELERATOR_LABEL,
    H100_ACCELERATOR,
    ConflictError,
    FakeKube,
    NodeInfo,
    PodInfo,
    WorkloadInfo,
)


def _load() -> tuple[FakeKube, dict]:
    path = os.environ["EDL_FAKE_KUBE_STATE"]
    with open(path) as f:
        raw = json.load(f)
    kube = FakeKube([NodeInfo(**n) for n in raw.get("nodes", [])])
    kube.workloads = {
        w["name"]: WorkloadInfo(**w) for w in raw.get("workloads", [])
    }
    kube.pods = {p["name"]: PodInfo(**p) for p in raw.get("pods", [])}
    kube.services = {s["metadata"]["name"]: s for s in raw.get("services", [])}
    kube._pod_seq = raw.get("pod_seq", 0)
    return kube, raw


def _save(kube: FakeKube, raw: dict) -> None:
    raw["nodes"] = [vars(n) for n in kube.nodes.values()]
    raw["workloads"] = [vars(w) for w in kube.workloads.values()]
    raw["pods"] = [vars(p) for p in kube.pods.values()]
    raw["services"] = list(kube.services.values())
    raw["pod_seq"] = kube._pod_seq
    path = os.environ["EDL_FAKE_KUBE_STATE"]
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(raw, f)
    os.replace(tmp, path)


def node_manifest(n: NodeInfo) -> dict:
    """The Node object a cluster serves for ``n`` (``kubectl get nodes``):
    allocatable CPU, memory and ``nvidia.com/gpu``, the accelerator and
    nodepool labels."""
    labels = {}
    if n.gpus:
        labels[ACCELERATOR_LABEL] = H100_ACCELERATOR
    if n.pool:
        labels["cloud.google.com/gke-nodepool"] = n.pool
    return {
        "metadata": {"name": n.name, "labels": labels},
        "status": {
            "allocatable": {
                "cpu": f"{n.cpu_milli}m",
                "memory": f"{n.memory_mega}Mi",
                "nvidia.com/gpu": str(n.gpus),
            }
        },
    }


def _pod_manifest(p: PodInfo) -> dict:
    meta = {"name": p.name, "labels": {"edl-job": p.job_name} if p.job_name else {}}
    if p.deleting:
        meta["deletionTimestamp"] = "1970-01-01T00:00:00Z"
    return {
        "metadata": meta,
        "status": {"phase": p.phase},
        "spec": {
            "nodeName": p.node,
            "containers": [
                {
                    "resources": {
                        "requests": {
                            "cpu": f"{p.cpu_request_milli}m",
                            "memory": f"{p.memory_request_mega}Mi",
                        },
                        "limits": {"nvidia.com/gpu": str(p.gpu_limit)},
                    }
                }
            ],
        },
    }


def _job_manifest(w: WorkloadInfo) -> dict:
    if w.kind == "Deployment":
        labels = {"edl-owner": w.owner} if w.owner else {}
        knob = {"replicas": w.parallelism}
    else:
        labels = {"edl-job": w.owner or w.job_name}
        knob = {"parallelism": w.parallelism}
    return {
        "kind": w.kind,
        "metadata": {
            "name": w.name,
            "labels": labels,
            "resourceVersion": str(w.resource_version),
        },
        "spec": {
            **knob,
            "template": {
                "spec": {
                    "containers": [
                        {
                            "resources": {
                                "requests": {
                                    "cpu": f"{w.cpu_request_milli}m",
                                    "memory": f"{w.memory_request_mega}Mi",
                                },
                                "limits": {"nvidia.com/gpu": str(w.gpu_limit)},
                            }
                        }
                    ]
                }
            },
        },
    }


def main(argv: List[str]) -> int:
    # Strip flags KubectlAPI interleaves; record the ones that matter.
    args: List[str] = []
    out_json = False
    selector = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-n":
            i += 2
            continue
        if a == "-o":
            out_json = argv[i + 1] == "json"
            i += 2
            continue
        if a == "-l":
            selector = argv[i + 1]
            i += 2
            continue
        if a in ("-A", "--ignore-not-found", "--wait=false"):
            i += 1
            continue
        args.append(a)
        i += 1

    kube, raw = _load()
    verb = args[0]

    if verb == "get":
        kind = args[1]
        if kind == "nodes":
            print(json.dumps({"items": [node_manifest(n) for n in kube.list_nodes()]}))
        elif kind == "pods":
            print(json.dumps({"items": [_pod_manifest(p) for p in kube.list_pods()]}))
        elif kind == "trainingjobs":
            print(json.dumps({"items": raw.get("trainingjobs", [])}))
        elif kind in ("jobs", "deployments"):
            want = "Deployment" if kind == "deployments" else "Job"
            items = []
            for w in kube.list_workloads():
                if w.kind != want:
                    continue
                m = _job_manifest(w)
                if selector and selector not in m["metadata"]["labels"]:
                    continue
                items.append(m)
            print(json.dumps({"items": items}))
        elif kind in ("job", "deployment"):
            w = kube.get_workload(args[2])
            want = "Deployment" if kind == "deployment" else "Job"
            if w is None or w.kind != want:
                print(
                    f'Error from server (NotFound): {kind}s "{args[2]}" '
                    "not found",
                    file=sys.stderr,
                )
                return 1
            print(json.dumps(_job_manifest(w)))
        else:
            print(f"fake-kubectl: unsupported get {kind}", file=sys.stderr)
            return 1
        return 0

    if verb == "apply":
        payload = json.loads(sys.stdin.read())
        items = payload.get("items", [payload])
        crs = {m["metadata"]["name"]: m for m in raw.get("trainingjobs", [])}
        rest = []
        for m in items:
            if m.get("kind") == "TrainingJob":
                # A real API server assigns the object UID on creation;
                # ownerReferences on rendered workloads depend on it.
                prior = crs.get(m["metadata"]["name"])
                m["metadata"].setdefault(
                    "uid",
                    (prior or {}).get("metadata", {}).get("uid")
                    or f"uid-{m['metadata']['name']}",
                )
                crs[m["metadata"]["name"]] = m
            else:
                rest.append(m)
        raw["trainingjobs"] = list(crs.values())
        if rest:
            kube.apply_manifests(rest)
        _save(kube, raw)
        for m in items:
            print(f"{m.get('kind', 'object').lower()}/{m['metadata']['name']} configured")
        return 0

    if verb == "patch":
        # patch job|trainingjob <name> [--subresource=status] --type=merge -p <json>
        name = args[2]
        patch = json.loads(args[args.index("-p") + 1])
        if args[1] == "trainingjob":
            for m in raw.get("trainingjobs", []):
                if m["metadata"]["name"] == name:
                    m.setdefault("status", {}).update(patch.get("status", {}))
                    _save(kube, raw)
                    print(f"trainingjob/{name} patched")
                    return 0
            print(
                f'Error from server (NotFound): trainingjobs "{name}" not found',
                file=sys.stderr,
            )
            return 1
        w = kube.get_workload(name)
        if w is None:
            print(
                f'Error from server (NotFound): {args[1]}s "{name}" not '
                "found",
                file=sys.stderr,
            )
            return 1
        rv = patch.get("metadata", {}).get("resourceVersion")
        if rv is not None:
            w.resource_version = int(rv)
        spec = patch.get("spec", {})
        # Jobs scale through spec.parallelism, Deployments (the serving
        # replica fleet) through spec.replicas — one knob either way.
        w.parallelism = spec.get(
            "replicas", spec.get("parallelism", w.parallelism)
        )
        try:
            kube.update_workload(w)
        except ConflictError as e:
            print(f"Error from server (Conflict): {e}", file=sys.stderr)
            return 1
        _save(kube, raw)
        print(f"{args[1]}/{name} patched")
        return 0

    if verb == "delete":
        kind, name = args[1], args[2]
        if kind == "pod":
            existed = kube.delete_pod(name)
            _save(kube, raw)
            if existed:
                print(f"pod/{name} deleted")
            return 0
        if kind == "trainingjob":
            before = raw.get("trainingjobs", [])
            raw["trainingjobs"] = [m for m in before if m["metadata"]["name"] != name]
            _save(kube, raw)
            if len(raw["trainingjobs"]) < len(before):
                print(f"trainingjob/{name} deleted")
            return 0
        existed = (
            kube.delete_workload(name)
            if kind in ("job", "deployment")
            else kube.services.pop(name, None) is not None
        )
        _save(kube, raw)
        if existed:
            print(f"{kind}/{name} deleted")
        return 0

    print(f"fake-kubectl: unsupported verb {verb}", file=sys.stderr)
    return 1


if __name__ == "__main__":  # pragma: no cover - subprocess entrypoint
    sys.exit(main(sys.argv[1:]))
