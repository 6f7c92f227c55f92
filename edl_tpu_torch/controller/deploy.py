"""Control-plane install manifests: everything ``kubectl apply`` needs
to run the controller in-cluster (counterpart of
``edl_tpu/controller/deploy.py``; the controller image is the port's,
``edl-tpu-torch/trainer``, whose entry point is ``python -m
edl_tpu_torch.cli``).

The reference shipped only a binary image (its ``Dockerfile``) and
registered its CRD at process start
(``cmd/edl/edl.go:39``); granting the controller permission to watch
TrainingJobs and rewrite Job parallelism was left to the operator.
Here the full set is rendered: CRD, namespace, ServiceAccount, the
least-privilege ClusterRole the control loops actually use (watch CRs;
CRUD trainer Jobs + coordinator Deployments/Services; read nodes/pods
for inventory), its binding, and the controller Deployment itself.
"""

from __future__ import annotations

from typing import Any, Dict, List

from edl_tpu_torch.resource.training_job import DEFAULT_IMAGE, crd_manifest

NAMESPACE = "edl-system"
SERVICE_ACCOUNT = "edl-controller"


def rbac_manifests() -> List[Dict[str, Any]]:
    """ServiceAccount + ClusterRole + binding for the controller.

    The rules mirror the controller's real API surface (one verb set
    per call site): the CR watch (``watch.py``), workload CRUD
    (``kube.KubectlAPI``), and the inventory's node/pod lists
    (``cluster.inquiry_resource`` — ref ``pkg/cluster.go:176-242``)."""
    return [
        {
            "apiVersion": "v1",
            "kind": "ServiceAccount",
            "metadata": {"name": SERVICE_ACCOUNT, "namespace": NAMESPACE},
        },
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "ClusterRole",
            "metadata": {"name": SERVICE_ACCOUNT},
            "rules": [
                {
                    # Read-only on the CR objects themselves (the
                    # watcher polls; specs belong to users)...
                    "apiGroups": ["edl.tpu.dev"],
                    "resources": ["trainingjobs"],
                    "verbs": ["get", "list", "watch"],
                },
                {
                    # ...but the controller owns the status subresource
                    # (state machine writeback, SURVEY.md §5.5).
                    "apiGroups": ["edl.tpu.dev"],
                    "resources": ["trainingjobs/status"],
                    "verbs": ["update", "patch"],
                },
                {
                    "apiGroups": ["batch"],
                    "resources": ["jobs"],
                    "verbs": [
                        "get", "list", "watch",
                        "create", "update", "patch", "delete",
                    ],
                },
                {
                    "apiGroups": ["apps"],
                    "resources": ["deployments"],
                    "verbs": [
                        "get", "list", "watch",
                        "create", "update", "patch", "delete",
                    ],
                },
                {
                    # patch included: re-applying a rendered Service on
                    # ensure/refresh PATCHes the existing object.
                    "apiGroups": [""],
                    "resources": ["services"],
                    "verbs": [
                        "get", "list",
                        "create", "update", "patch", "delete",
                    ],
                },
                {
                    "apiGroups": [""],
                    "resources": ["nodes", "pods"],
                    "verbs": ["get", "list", "watch"],
                },
            ],
        },
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "ClusterRoleBinding",
            "metadata": {"name": SERVICE_ACCOUNT},
            "roleRef": {
                "apiGroup": "rbac.authorization.k8s.io",
                "kind": "ClusterRole",
                "name": SERVICE_ACCOUNT,
            },
            "subjects": [
                {
                    "kind": "ServiceAccount",
                    "name": SERVICE_ACCOUNT,
                    "namespace": NAMESPACE,
                }
            ],
        },
    ]


def controller_deployment(image: str = DEFAULT_IMAGE) -> Dict[str, Any]:
    """One controller replica (the decision plane is a singleton, like
    the reference binary — leader election is out of scope as it was
    there)."""
    labels = {"app": "edl-controller"}
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": "edl-controller", "namespace": NAMESPACE},
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": labels},
            "template": {
                "metadata": {"labels": labels},
                "spec": {
                    "serviceAccountName": SERVICE_ACCOUNT,
                    "containers": [
                        {
                            "name": "controller",
                            "image": image,
                            "args": ["controller"],
                            "resources": {
                                "requests": {"cpu": "200m", "memory": "256Mi"}
                            },
                        }
                    ],
                },
            },
        },
    }


def deploy_manifests(image: str = DEFAULT_IMAGE) -> List[Dict[str, Any]]:
    """The full ``kubectl apply``-able control-plane install."""
    return [
        {
            "apiVersion": "v1",
            "kind": "Namespace",
            "metadata": {"name": NAMESPACE},
        },
        crd_manifest(),
        *rbac_manifests(),
        controller_deployment(image),
    ]
