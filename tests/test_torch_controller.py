"""The port's controller, job parser, deploy manifests and CLI
(``edl_tpu_torch.controller``, ``edl_tpu_torch.cli``) against the JAX
package's: the job life cycle on FakeKube gives the same states and
cluster objects, every rendered manifest equals the JAX one after
``tpu_to_gpu``, every pod-env key the port renders is one its launcher
reads, and ``submit`` -> ``controller`` drives a real coordinator
through the port's kubectl stand-in."""

import json
import os
import stat
import sys
from pathlib import Path

import pytest

from edl_tpu.autoscaler import scaler as jax_scaler
from edl_tpu.cluster import cluster as jax_cluster
from edl_tpu.cluster import kube as jax_kube
from edl_tpu.controller import controller as jax_controller
from edl_tpu.controller import deploy as jax_deploy
from edl_tpu.controller import jobparser as jax_parser
from edl_tpu import fleet as jax_fleet
from edl_tpu.resource import training_job as jax_tj
from edl_tpu.runtime import coord_service as jax_service
from edl_tpu.runtime import coordinator as jax_coord
from edl_tpu_torch import cli, launcher
from edl_tpu_torch import fleet as port_fleet
from edl_tpu_torch.autoscaler import scaler
from edl_tpu_torch.cluster import cluster as port_cluster
from edl_tpu_torch.cluster import kube as port_kube
from edl_tpu_torch.controller import controller as port_controller
from edl_tpu_torch.controller import deploy
from edl_tpu_torch.controller import jobparser
from edl_tpu_torch.resource import training_job as tj
from edl_tpu_torch.runtime import coord_service
from edl_tpu_torch.runtime import coordinator as port_coord
from torch_vocab import tpu_to_gpu

ROOT = Path(__file__).resolve().parents[1]


def _manifest(name, mn=1, mx=1, topo="v5e-4", gbs=0, uid="", **spec):
    meta = {"name": name, **({"uid": uid} if uid else {})}
    return {"apiVersion": "edl.tpu.dev/v1", "kind": "TrainingJob", "metadata": meta,
            "spec": {"fault_tolerant": mn < mx, "global_batch_size": gbs, **spec,
                     "trainer": {"entrypoint": "transformer_lm", "min_instance": mn,
                                 "max_instance": mx, "slice_topology": topo,
                                 "resources": {"requests": {"cpu": "1", "memory": "1Gi"}}}}}


JOBS = {
    "single_host": _manifest("lm", 1, 4, "v5e-4", gbs=32, checkpoint_dir="/ckpt",
                             dataset_dir="/data", checkpoint_interval_steps=4),
    "one_chip_uid": _manifest("one", 1, 2, "v5e-1", uid="u-1", image="img:2", port=7200,
                              volumes=[{"name": "ckpt", "emptyDir": {}}]),
    "fixed": _manifest("fixed", 2, 2, "v5e-8", passes=3),
    "cpu_only": _manifest("cpu", 1, 3, "cpu"),
    "multi_host": _manifest("mh", 1, 3, "v5e-16", gbs=96, uid="u-mh"),
    "serving": _manifest("srv", 1, 2, "v5e-4", uid="u-s", checkpoint_dir="/ckpt",
                         serving={"min_replicas": 1, "max_replicas": 3, "port": 7181,
                                  "max_batch": 32}),
    "compile_cache": _manifest("cc", 1, 1, "v5e-4", compile_cache_dir="/cache"),
}


def _render(parser, job):
    out = {
        "trainer": parser.parse_to_trainer_manifests(job),
        "trainer_at_3": parser.parse_to_trainer_manifests(job, replicas=3),
        "coordinator": parser.parse_to_coordinator(job),
        "serving": parser.parse_to_serving_manifests(job),
        "pod_env": parser.pod_env(job),
        "owner": parser.owner_references(job),
    }
    if job.hosts_per_replica() > 1:
        out["slice_2"] = parser.parse_to_trainer_slice(job, 2)
        out["indexes"] = parser.parse_to_trainer_manifests(job, indexes=[1, 4])
    else:
        out["trainer_job"] = parser.parse_to_trainer(job)
    return out


@pytest.mark.parametrize("name", sorted(JOBS))
def test_rendered_manifests_equal_the_jax_packages(name):
    jax_job = jax_tj.TrainingJob.from_manifest(JOBS[name]).validate()
    job = tj.TrainingJob.from_manifest(tpu_to_gpu(JOBS[name])).validate()
    assert _render(jobparser, job) == tpu_to_gpu(_render(jax_parser, jax_job))


def test_install_manifests_equal_the_jax_packages():
    assert deploy.deploy_manifests() == tpu_to_gpu(jax_deploy.deploy_manifests())
    assert deploy.deploy_manifests("reg/img:1") == jax_deploy.deploy_manifests("reg/img:1")


class _RecordingEnv(dict):
    """``os.environ`` stand-in that records every key read."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def get(self, key, default=None):
        self.read.add(key)
        return super().get(key, default)

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)

    def __contains__(self, key):
        self.read.add(key)
        return super().__contains__(key)


def _pod_env_values(env):
    """The rendered env with the downward-API values filled in."""
    fills = {"metadata.name": "lm-trainer-abcde", "status.podIP": "10.0.0.7",
             "metadata.namespace": "default"}
    return {e["name"]: e["value"] if "value" in e else fills[e["valueFrom"]["fieldRef"]["fieldPath"]]
            for e in env}


@pytest.mark.parametrize("name", sorted(JOBS))
def test_every_rendered_env_key_is_read_by_the_launcher(name, monkeypatch):
    m = tpu_to_gpu(JOBS[name])
    job = tj.TrainingJob.from_manifest(m).validate()
    envs = [jobparser.pod_env(job)]
    if job.hosts_per_replica() > 1:
        envs.append(jobparser.parse_to_trainer_slice(job, 1)["spec"]["template"]["spec"]
                    ["containers"][0]["env"])
    if job.spec.serving is not None:
        envs.append(jobparser.serving_pod_env(job))
    for env in envs:
        values = _pod_env_values(env)
        rec = _RecordingEnv(values)
        monkeypatch.setattr(os, "environ", rec)
        cfg = launcher.env_config()
        monkeypatch.undo()
        assert set(values) <= rec.read, set(values) - rec.read
    cfg_env = _pod_env_values(jobparser.pod_env(job))
    monkeypatch.setattr(os, "environ", _RecordingEnv(cfg_env))
    cfg = launcher.env_config()
    monkeypatch.undo()
    assert cfg["pod_address"] == "10.0.0.7:8476" and cfg["pod_name"] == "lm-trainer-abcde"
    assert cfg["slice_topology"] == job.spec.trainer.slice_topology
    assert "EDL_TELEMETRY_INTERVAL" not in cfg_env and cfg["telemetry_interval"] == 5.0
    assert (cfg["global_batch_size"], cfg["checkpoint_interval"]) == (
        job.spec.global_batch_size, job.spec.checkpoint_interval_steps)


# ---- the life cycle against the JAX Controller ----------------------------------


class _Side:
    def __init__(self, jax: bool):
        self.jax = jax
        self.kube = jax_kube if jax else port_kube
        self.cluster = jax_cluster if jax else port_cluster
        self.scaler = jax_scaler if jax else scaler
        self.controller = jax_controller if jax else port_controller
        self.tj = jax_tj if jax else tj
        self.service = jax_service if jax else coord_service
        self.coord = jax_coord if jax else port_coord

    def w(self, v):
        return v if self.jax else tpu_to_gpu(v)

    def obs(self, v):
        return tpu_to_gpu(v) if self.jax else v


def _life_cycle(S):
    """Two jobs on four 4-chip pools: ``a`` grows, ``b`` arrives and
    ``a`` sheds for it, ``a`` completes through its coordinator's
    ``/complete`` (over HTTP), ``b``'s pods run to completion, ``b`` is
    deleted and a dangling workload is collected."""
    nodes = [S.kube.NodeInfo(name=f"pool-{i}", cpu_milli=8000, memory_mega=32768,
                             **{"tpu_chips" if S.jax else "gpus": 4,
                                "tpu_topology" if S.jax else "gpu_topology": S.w("v5e-4")})
             for i in range(4)]
    kube = S.kube.FakeKube(nodes)
    cluster = S.cluster.Cluster(kube)
    servers, now = {}, [1000.0]

    def client(job):
        if job.name not in servers:
            servers[job.name] = S.service.CoordinatorServer(
                S.coord.LocalCoordinator(target_world=1, max_world=4), host="127.0.0.1",
                port=0).start(evict=False)
        return S.service.HTTPCoordinator(f"127.0.0.1:{servers[job.name].port}", timeout=5,
                                         retries=1)

    ctrl = S.controller.Controller(cluster, S.scaler.Autoscaler(cluster, coord_client_factory=client),
                                   clock=lambda: now[0])
    out = []

    def snap(what):
        now[0] += 5.0
        out.append((what, S.obs(ctrl.job_statuses()), S.obs(ctrl.cluster_metrics()),
                    S.obs(sorted((w.name, w.kind, w.parallelism, w.owner)
                                 for w in kube.list_workloads())),
                    S.obs(sorted((p.name, p.job_name, p.phase, p.node) for p in kube.list_pods())),
                    {n: (s.coordinator.target_world(), s.coordinator.prewarm_hint())
                     for n, s in sorted(servers.items())}))

    try:
        ctrl.on_add(S.tj.TrainingJob.from_manifest(S.w(_manifest("a", 1, 4, "v5e-4", gbs=16))))
        snap("added")
        for i in range(2):
            ctrl.run_once()
            snap(f"tick {i}")
        ctrl.on_add(S.tj.TrainingJob.from_manifest(S.w(_manifest("b", 2, 2, "v5e-4"))))
        for i in range(3):
            ctrl.run_once()
            snap(f"b tick {i}")
        client(ctrl.jobs["a"]).report_complete(step=40)
        ctrl.run_once()
        snap("a complete")
        kube.complete_pods("b")
        ctrl.run_once()
        snap("b pods done")
        job_b = ctrl.jobs["b"]
        ctrl.on_delete(job_b)
        snap("b deleted")
        kube.apply_manifests(S.w(jax_parser.parse_to_coordinator(
            jax_tj.TrainingJob.from_manifest(_manifest("ghost")).validate())))
        out.append(("gc", ctrl.gc_orphans(["a"])))
        snap("collected")
    finally:
        for s in servers.values():
            s.stop()
    return out


def test_controller_life_cycle_equals_the_jax_controller():
    got = _life_cycle(_Side(jax=False))
    want = _life_cycle(_Side(jax=True))
    assert got == want
    states = [[j["state"] for j in step[1]] for step in got if len(step) > 2]
    assert ["Succeed", "Succeed"] in states


# ---- the GPU market's wiring against the JAX controller's ------------------------


def _market_scenario(S, name):
    """One market-wiring case of ``tests/test_controller.py`` on eight
    4-chip (4-GPU) pools; returns what the controller shows after each
    tick: the arbiter's bidders with their spec fields, the market's
    jobs, the single-cluster lane's jobs and the live inventory."""
    kube = S.kube.FakeKube([S.kube.NodeInfo(name=f"pool-{i}", cpu_milli=8000, memory_mega=32768,
                                            **{"tpu_chips" if S.jax else "gpus": 4})
                            for i in range(8)])
    cluster = S.cluster.Cluster(kube)
    coords = {}
    ctrl = S.controller.Controller(cluster, S.scaler.Autoscaler(
        cluster, coord_client_factory=lambda j: coords.setdefault(
            j.name, S.coord.LocalCoordinator(target_world=1, max_world=4))),
        clock=lambda: 100.0)

    def job(n, pri=0):
        return S.tj.TrainingJob.from_manifest(S.w(_manifest(n, 1, 2, "v5e-4", priority=pri)))

    out = []

    def tick():
        ctrl.run_once()
        ctrl.autoscaler._drain_events()
        arbiter = getattr(ctrl.autoscaler, "fleet_arbiter", None)
        out.append({
            "bidders": None if arbiter is None else sorted(
                (b.name, b.priority, b.chips_per_unit, b.min_units, b.max_units,
                 list(b.legal_units)) for b in arbiter.trainers),
            "market": sorted(ctrl._fleet_managed),
            "lane": sorted(ctrl.autoscaler.jobs),
            "inventory": ctrl._fleet_inventory().snapshot(),
        })

    if name == "auto_attach":
        ctrl.on_add(job("hi", 10))
        tick()  # one prioritized job is not a market
        ctrl.on_add(job("lo", 1))
        ctrl.on_add(job("plain"))
        tick()
    elif name == "bidder_sync":
        ctrl.on_add(job("a", 5))
        ctrl.on_add(job("b", 3))
        tick()
        ctrl.on_add(job("c", 7))  # joins the market
        tick()
        ctrl.on_delete(ctrl.jobs["b"])  # leaves it
        tick()
        ctrl.on_update(job("a", 9))  # a spec edit reaches its bidder
        tick()
    elif name == "explicit_arbiter":
        fleet = jax_fleet if S.jax else port_fleet
        fleet.attach_fleet(ctrl.autoscaler, fleet.FleetArbiter(
            8, trainers=[fleet.TrainingBidder("external", None, min_units=1, max_units=1)]))
        ctrl.on_add(job("x", 2))
        ctrl.on_add(job("y", 4))
        tick()  # no second attach
    elif name == "watch_update":
        ctrl.on_add(job("a", 5))
        ctrl.on_add(job("b", 3))
        tick()
        ctrl.on_update(job("a", 5))  # the same spec, a new object
        ctrl.autoscaler._drain_events()
        out.append(sorted(ctrl.autoscaler.jobs))
        tick()
    elif name == "priority_removed":
        ctrl.on_add(job("a", 5))
        ctrl.on_add(job("b", 3))
        tick()
        ctrl.on_update(job("b"))  # priority -> 0: back to the single lane
        tick()
    return out


@pytest.mark.parametrize("name", ["auto_attach", "bidder_sync", "explicit_arbiter",
                                  "watch_update", "priority_removed"])
def test_market_wiring_equals_the_jax_controller(name):
    got = _market_scenario(_Side(jax=False), name)
    assert got == _market_scenario(_Side(jax=True), name)
    last = got[-1]
    if name == "auto_attach":
        assert got[0]["bidders"] is None and got[0]["lane"] == ["hi"]
        assert [b[:5] for b in last["bidders"]] == [("hi", 10, 4, 1, 2), ("lo", 1, 4, 1, 2)]
        assert last["market"] == ["hi", "lo"] and last["lane"] == ["plain"]
        assert last["inventory"]["total_chips"] == 32
    elif name == "bidder_sync":
        assert [b[0] for b in got[1]["bidders"]] == ["a", "b", "c"]
        assert last["market"] == ["a", "c"] and last["lane"] == []
        assert [b[:2] for b in last["bidders"]] == [("a", 9), ("c", 7)]
    elif name == "explicit_arbiter":
        assert [b[0] for b in last["bidders"]] == ["external", "x", "y"]
    elif name == "watch_update":
        assert got[1] == [] and last["lane"] == []
    else:
        assert [b[0] for b in last["bidders"]] == ["a"] and last["lane"] == ["b"]


class _Lane:
    """A serving lane whose requirement the test sets; its replicas
    are its coordinator's target."""

    def __init__(self):
        self.coordinator = port_coord.LocalCoordinator(target_world=1, max_world=2)
        self.min_replicas, self.max_replicas, self.required = 1, 2, 1
        self.on_scale = None

    def observe(self):
        return {"queue_depth": 0}

    def current_replicas(self):
        return self.coordinator.target_world()

    def desired_replicas(self, obs, current):
        return self.required, "scripted"

    def drain_victims(self, before, units):
        return {"acked": True}


def _market_controller():
    """``lo`` (priority 1, 1-2 GPUs) and ``hi`` (priority 10, 1 GPU) on
    four 1-GPU nodes; after the first tick ``lo`` holds 2, and the
    serving fleet ``api`` (priority 100, 1 replica) has joined: full."""
    kube = port_kube.FakeKube([port_kube.NodeInfo(name=f"gpu-{i}", cpu_milli=8000,
                                                  memory_mega=32768, gpus=1) for i in range(4)])
    cluster = port_cluster.Cluster(kube)
    coords = {}
    ctrl = port_controller.Controller(cluster, scaler.Autoscaler(
        cluster, coord_client_factory=lambda j: coords.setdefault(
            j.name, port_coord.LocalCoordinator(target_world=1, max_world=2))))
    for name, mx, pri in (("lo", 2, 1), ("hi", 1, 10)):
        ctrl.on_add(tj.TrainingJob.from_manifest(tpu_to_gpu(
            _manifest(name, 1, mx, "v5e-1", priority=pri))))
    ctrl.run_once()
    lane = _Lane()
    ctrl.autoscaler.fleet_arbiter.add_fleet(port_fleet.ServingBidder("api", lane, priority=100))
    return ctrl, kube, coords, lane


def _lo_view(ctrl, kube, coords):
    return (coords["lo"].target_world(), kube.get_workload("lo-trainer").parallelism,
            len([p for p in kube.list_pods() if p.job_name == "lo"]))


def test_controller_ticks_hold_the_market_retargets_through_a_preemption_and_a_restore():
    """The market's training retargets survive the controller's own
    tick: ``reconcile_targets`` does not POST the old parallelism back
    (the target does not flap), and the preempted job's workload and
    pods follow the market, so its GPU is free on the cluster too."""
    ctrl, kube, coords, lane = _market_controller()
    posted, real = [], coords["lo"].set_target_world

    def record(n, trace_id=""):
        posted.append(n)
        return real(n, trace_id=trace_id)

    coords["lo"].set_target_world = record
    # what the cluster showed when api's replica count moved
    scaled = []
    lane.on_scale = lambda old, new: scaled.append(
        (old, new, ctrl.cluster.inquiry_resource().free_gpus()))
    assert _lo_view(ctrl, kube, coords) == (2, 2, 2)
    ctrl.run_once()
    assert _lo_view(ctrl, kube, coords) == (2, 2, 2) and posted == []  # calm: full
    lane.required = 2  # the spike
    views = []
    for _ in range(3):
        ctrl.run_once()
        views.append((_lo_view(ctrl, kube, coords), lane.current_replicas()))
    assert views == [((1, 1, 1), 2)] * 3
    assert posted == [1]  # one preemption, not one a tick
    assert scaled == [(1, 2, 2)]  # lo's pod was gone before api grew
    # lo's second GPU is free on the cluster (api's replica B is not a pod here)
    assert ctrl.cluster.inquiry_resource().free_gpus() == 2
    lane.required = 1  # the spike clears
    views = []
    for _ in range(3):
        ctrl.run_once()
        views.append((_lo_view(ctrl, kube, coords), lane.current_replicas()))
    assert views == [((2, 2, 2), 1)] * 3 and posted == [1, 2]
    assert coords["hi"].target_world() == 1
    assert kube.get_workload("hi-trainer").parallelism == 1


def test_a_market_resize_whose_put_failed_is_repaired_by_the_next_tick():
    """The bidder's PUT gives up once: the market's target stands, and
    the next tick's ``reconcile_targets`` moves the workload onto it."""
    from edl_tpu_torch.cluster.cluster import ParallelismUpdateError

    ctrl, kube, coords, lane = _market_controller()
    real, fails = ctrl.cluster.update_parallelism, [ParallelismUpdateError("conflict storm")]

    def flaky(job, n):
        if fails:
            raise fails.pop()
        return real(job, n)

    ctrl.cluster.update_parallelism = flaky
    lane.required = 2
    ctrl.autoscaler.run_once()  # the market alone: the PUT after the drain fails
    assert _lo_view(ctrl, kube, coords) == (1, 2, 2)
    ctrl.run_once()
    assert _lo_view(ctrl, kube, coords) == (1, 1, 1)
    ctrl.run_once()
    assert _lo_view(ctrl, kube, coords) == (1, 1, 1)


def test_a_refused_cr_beside_a_running_job_does_not_stop_the_watch():
    """CRs the port refuses (a mesh layout, a shard-only checkpoint)
    sit beside a running job: the watch records each refusal on its CR
    and goes on, the running job still grows and reaches Succeed through
    its coordinator, a refused CR is not retried until its spec changes,
    and a refused spec edit leaves a live job on its old spec."""
    from edl_tpu_torch.controller.watch import TrainingJobWatcher

    kube = port_kube.FakeKube([port_kube.NodeInfo(name=f"n{i}", cpu_milli=8000,
                                                  memory_mega=32768, gpus=8) for i in range(2)])
    pushed = {}

    def push(name, status, namespace=None):
        pushed[name] = status
        return True

    kube.update_training_job_status = push
    cluster = port_cluster.Cluster(kube)
    coords = {}
    ctrl = port_controller.Controller(cluster, scaler.Autoscaler(
        cluster, coord_client_factory=lambda j: coords.setdefault(
            j.name, port_coord.LocalCoordinator(target_world=1, max_world=4))))
    crs = {"a": tpu_to_gpu(_manifest("a", 1, 4, "v5e-1", priority=1)),
           "mesh": tpu_to_gpu(_manifest("mesh", 1, 2, "v5e-4")),
           "hi": tpu_to_gpu(_manifest("hi", 1, 2, "v5e-1", priority=2, shard_only=True))}
    crs["mesh"]["spec"]["trainer"]["parallelism"] = {"fsdp": 2}
    watcher = TrainingJobWatcher(lambda: list(crs.values()), ctrl)
    assert watcher.poll_once() == 3
    assert sorted(ctrl.jobs) == ["a"]
    assert pushed["mesh"]["state"] == "Failed" and "ROADMAP A-8" in pushed["mesh"]["message"]
    assert pushed["hi"]["state"] == "Failed" and "ROADMAP A-7" in pushed["hi"]["message"]
    ctrl.run_once()
    assert kube.get_workload("a-trainer").parallelism == 4
    assert watcher.poll_once() == 0  # refused CRs wait for a new spec
    crs["a"]["spec"]["shard_only"] = True  # a refused edit of a live job
    assert watcher.poll_once() == 1
    assert "ROADMAP A-7" in ctrl.jobs["a"].status.message
    assert not ctrl.jobs["a"].spec.shard_only
    coords["a"].report_complete(step=40)
    ctrl.run_once()
    assert ctrl.jobs["a"].status.state.value == "Succeed"
    crs["hi"]["spec"]["shard_only"] = False  # the fixed CR is added
    assert watcher.poll_once() == 1
    assert sorted(ctrl.jobs) == ["a", "hi"] and kube.get_workload("hi-trainer") is not None


# ---- the CLI through the port's kubectl stand-in --------------------------------


@pytest.fixture
def fake_cluster(tmp_path, monkeypatch):
    """Four 4-GPU nodes behind a kubectl shim running the port's
    ``cluster.fake_kubectl``."""
    state = tmp_path / "kube-state.json"
    state.write_text(json.dumps({"nodes": [
        {"name": f"pool-{i}", "cpu_milli": 16000, "memory_mega": 65536, "gpus": 4}
        for i in range(4)]}))
    shim = tmp_path / "kubectl"
    shim.write_text(f'#!/bin/sh\nexec {sys.executable} -m edl_tpu_torch.cluster.fake_kubectl "$@"\n')
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("EDL_FAKE_KUBE_STATE", str(state))
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    return {"state": state, "kubectl": str(shim)}


JOB_YAML = """
apiVersion: edl.tpu.dev/v1
kind: TrainingJob
metadata: {name: e2e-lm}
spec:
  fault_tolerant: true
  global_batch_size: 64
  trainer:
    entrypoint: transformer_lm
    min_instance: 1
    max_instance: 4
    slice_topology: h100-4
    resources:
      requests: {cpu: "1", memory: 1Gi}
"""


def test_submit_then_controller_runs_the_actuation_handshake(fake_cluster, tmp_path, capsys,
                                                             monkeypatch):
    """As the JAX ``test_actuation_handshake_e2e``: ``submit`` then
    ``controller`` grows the coordinator's plan to world 4 with the
    prewarm hint announced — no test code retargets the coordinator —
    and the node inventory reads back through ``KubectlAPI``."""
    coord = port_coord.LocalCoordinator(target_world=1, max_world=4, heartbeat_timeout=60)
    server = coord_service.CoordinatorServer(coord, host="127.0.0.1", port=0).start(evict=False)
    try:
        monkeypatch.setenv("EDL_COORD_ADDR_TEMPLATE", f"127.0.0.1:{server.port}")
        for i in range(4):
            coord.register(f"t{i}")
        assert coord.plan().world_size == 1
        spec = tmp_path / "job.yaml"
        spec.write_text(JOB_YAML)
        kubectl = fake_cluster["kubectl"]
        assert cli.main(["submit", str(spec), "--kubectl", kubectl]) == 0
        assert cli.main(["controller", "--kubectl", kubectl, "--iterations", "3",
                         "--interval", "0"]) == 0
        out = capsys.readouterr().out
        summary = json.loads(out[out.index('{\n  "jobs"'):])
        assert summary["jobs"][0]["state"] == "Running"
        assert summary["cluster"]["gpu_utilization"] == 1.0
        assert coord.target_world() == 4 and coord.plan().world_size == 4
        assert coord.prewarm_hint() == 4 and coord.plan().prewarm == 4
        nodes = port_kube.KubectlAPI(kubectl=kubectl).list_nodes()
        assert [(n.gpus, n.gpu_topology) for n in nodes] == [(4, "")] * 4
        st = json.loads(fake_cluster["state"].read_text())
        cr = st["trainingjobs"][0]
        assert cr["status"]["state"] == "Running" and cr["status"]["parallelism"] == 4
        assert cli.main(["kill", "e2e-lm", "--kubectl", kubectl]) == 0
        assert cli.main(["controller", "--kubectl", kubectl, "--iterations", "1",
                         "--interval", "0"]) == 0
        st = json.loads(fake_cluster["state"].read_text())
        assert st["workloads"] == [] and st["trainingjobs"] == []
    finally:
        server.stop()


def test_local_sim_and_manifests_print_what_the_jax_cli_prints(tmp_path, capsys):
    from edl_tpu import cli as jax_cli

    spec = tmp_path / "job.yaml"
    spec.write_text(JOB_YAML.replace("h100-4", "v5e-4").replace("transformer_lm", "mnist"))
    port_spec = tmp_path / "port.yaml"
    port_spec.write_text(JOB_YAML.replace("transformer_lm", "mnist"))
    for args in (["manifests"], ["local-sim", "--iterations", "3"]):
        assert jax_cli.main(args[:1] + [str(spec)] + args[1:]) == 0
        want = capsys.readouterr().out
        assert cli.main(args[:1] + [str(port_spec)] + args[1:]) == 0
        got = capsys.readouterr().out
        if args[0] == "manifests":
            import yaml

            assert list(yaml.safe_load_all(got)) == tpu_to_gpu(list(yaml.safe_load_all(want)))
        else:
            assert json.loads(got[got.index("{"):]) == tpu_to_gpu(json.loads(want[want.index("{"):]))
