"""The port's control plane closes the loop on the CPU: a ``Controller``
and its ``Autoscaler`` over a FakeKube of two 1-GPU nodes size a job of
real trainer processes (``edl_tpu_torch.launcher``, the tiny
``transformer_lm`` on gloo), each started with the env the port's job
parser rendered for its pod (and EDL_TELEMETRY_INTERVAL, the report
cadence, shortened for a 40-step run).  The autoscaler, not the test, grows the
world 1 -> 2 and sheds it back to 1 when a second job arrives; the test
plays the kubelet (a pod created in FakeKube starts a process, a pod
deleted there gets SIGTERM).  The survivor's loss stream equals a fixed
world-1 run (float32 compute: in bfloat16 the two-member world's
gradient sum differs from one member's in rounding)."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from edl_tpu_torch import launcher
from edl_tpu_torch.autoscaler.scaler import Autoscaler
from edl_tpu_torch.cluster.cluster import Cluster
from edl_tpu_torch.cluster.kube import FakeKube, NodeInfo
from edl_tpu_torch.controller.controller import Controller
from edl_tpu_torch.controller.jobparser import pod_env
from edl_tpu_torch.resource.training_job import TrainingJob
from edl_tpu_torch.runtime.coord_service import CoordinatorServer
from edl_tpu_torch.runtime.coordinator import LocalCoordinator

ROOT = Path(__file__).resolve().parents[1]
STEPS = 40
#: a small Adam step: near-zero gradients take steps of up to lr whatever
#: their size, so the worlds' rounding differences grow with it
LR = 1e-4
#: the bar of test_torch_elastic.py::test_gloo_1_2_1_equals_fixed_world_and_jax
DP_RTOL = 1e-5
#: seconds between the trainers' telemetry reports (the pod env's
#: EDL_TELEMETRY_INTERVAL; the launcher's default is 5 s)
TELEMETRY_S = 0.2
#: a pod's container: the image is warm (torch imported) before the
#: kubelet hands it its env, then it runs the launcher on the tiny model
#: in float32 (argv: steps, lr, history file)
_POD = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
from edl_tpu_torch import launcher
env = json.loads(sys.stdin.readline())
os.environ.update(env)
steps, lr, history = sys.argv[1:]
launcher.run(steps=int(steps), lr=float(lr), history_file=history, device="cpu",
             model_kwargs={"tiny": True, "dtype": torch.float32})
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _job(name, mn, mx, port):
    return TrainingJob.from_manifest({
        "apiVersion": "edl.tpu.dev/v1", "kind": "TrainingJob", "metadata": {"name": name},
        "spec": {"fault_tolerant": mn < mx, "global_batch_size": 8, "checkpoint_interval_steps": 4,
                 "port": port,
                 "trainer": {"entrypoint": "transformer_lm", "min_instance": mn,
                             "max_instance": mx, "slice_topology": "h100-1",
                             "resources": {"requests": {"cpu": "1", "memory": "1Gi"}}}}})


def _history(path):
    if not path.exists():
        return []
    return [json.loads(x) for x in path.read_text().splitlines() if x.strip()]


def test_autoscaler_drives_a_gloo_world_1_2_1_that_equals_a_fixed_world(tmp_path, monkeypatch):
    env0 = dict(os.environ, PYTHONPATH=str(ROOT))
    # two warm pod sandboxes: the kubelet hands each its pod's env
    sandboxes = [subprocess.Popen([sys.executable, "-c", _POD, str(STEPS), str(LR), str(tmp_path / f"h{i}")],
                                  stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, cwd=str(ROOT), env=env0)
                 for i in range(2)]
    servers = {}
    try:
        for name in ("lm", "lm-b"):
            servers[name] = CoordinatorServer(
                LocalCoordinator(target_world=1, max_world=2 if name == "lm" else 1,
                                 legal_sizes=[1, 2], heartbeat_timeout=30),
                host="127.0.0.1", port=0).start()
        coord = servers["lm"].coordinator
        # no cluster DNS here: the job's Service address is 127.0.0.1
        monkeypatch.setenv("EDL_COORD_ADDR_TEMPLATE", "127.0.0.1:{port}")
        kube = FakeKube([NodeInfo(name=f"gpu-{i}", cpu_milli=8000, memory_mega=32768, gpus=1)
                         for i in range(2)])
        cluster = Cluster(kube)
        ctrl = Controller(cluster, Autoscaler(cluster))
        lm = ctrl.on_add(_job("lm", 1, 2, servers["lm"].port))
        rendered = pod_env(lm)

        # the fixed world-1 run, in-process, while the sandboxes warm up
        # (one thread, as the pods: the CPU products' order is the same)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            fixed = launcher.run("transformer_lm", steps=STEPS, global_batch_size=8,
                                 checkpoint_interval=4, lr=LR, device="cpu",
                                 model_kwargs={"tiny": True, "dtype": torch.float32})
        finally:
            torch.set_num_threads(threads)
        want = {r.step: r.loss for r in fixed.history}

        started, procs, lm_b = {}, {}, None
        parallelism = [kube.get_workload("lm-trainer").parallelism]
        deadline = time.monotonic() + 120

        def kubelet():
            """Start a process for each new pod of lm (in creation order,
            the next once the previous one stepped); SIGTERM the deleted."""
            pods = sorted((p for p in kube.list_pods() if p.job_name == "lm"), key=lambda p: p.name)
            for p in pods:
                if p.deleting and p.name in procs and p.name not in started.get("term", ()):
                    procs[p.name].send_signal(signal.SIGTERM)
                    started.setdefault("term", set()).add(p.name)
                if p.deleting or p.phase != "Running" or p.name in procs:
                    continue
                if procs and len(_history(tmp_path / "h0")) < 3:
                    return  # the lead has not stepped yet
                env = {}
                for e in rendered:
                    env[e["name"]] = e.get("value", "")
                env.update(EDL_POD_NAME=p.name, EDL_POD_IP="127.0.0.1",
                           EDL_DIST_PORT=str(_free_port()), EDL_TELEMETRY_INTERVAL=str(TELEMETRY_S),
                           EDL_COORDINATOR_ADDR=f"127.0.0.1:{servers['lm'].port}")
                proc = sandboxes[len(procs)]
                proc.stdin.write((json.dumps(env) + "\n").encode())
                proc.stdin.close()
                procs[p.name] = proc

        lead = sandboxes[0]
        while lead.poll() is None or ctrl.jobs["lm"].status.state.value != "Succeed":
            assert time.monotonic() < deadline, (parallelism, [p.poll() for p in sandboxes])
            ctrl.run_once()
            kubelet()
            w = kube.get_workload("lm-trainer")
            if not parallelism or parallelism[-1] != w.parallelism:
                parallelism.append(w.parallelism)
            at2 = [h for h in _history(tmp_path / "h0") if h.get("world_size") == 2]
            if lm_b is None and len(at2) >= 2:
                lm_b = ctrl.on_add(_job("lm-b", 1, 1, servers["lm-b"].port))
            time.sleep(0.05)
        for p in procs.values():
            p.wait(timeout=60)
        logs = [p.stdout.read().decode(errors="replace") for p in procs.values()]
    finally:
        for p in sandboxes:
            if p.poll() is None:
                p.kill()
        for s in servers.values():
            s.stop()
    assert [p.returncode for p in procs.values()] == [0, 0], logs
    assert parallelism == [1, 2, 1]
    b_pods = [p for p in kube.list_pods() if p.job_name == "lm-b"]
    assert [(p.phase, p.node) for p in b_pods] == [("Running", "gpu-1")]
    assert ctrl.jobs["lm-b"].status.state.value == "Running"
    steps = [h for h in _history(tmp_path / "h0") if "step" in h]
    assert [h["step"] for h in steps] == list(range(STEPS))
    worlds = [h["world_size"] for h in steps]
    assert worlds[0] == 1 and 2 in worlds and worlds[-1] == 1, worlds
    np.testing.assert_allclose([h["loss"] for h in steps], [want[s] for s in range(STEPS)],
                               rtol=DP_RTOL)
    # the world-2 steps were one world: the joiner logged the lead's losses
    joined = {h["step"]: h["loss"] for h in _history(tmp_path / "h1") if h.get("world_size") == 2}
    assert joined and all(steps[s]["loss"] == loss for s, loss in joined.items())
    # the autoscaler saw the trainers' step rate in their telemetry reports
    rates = [d["observed"].get("step_rate") for d in ctrl.autoscaler.decision_log]
    assert any(r for r in rates), rates
    assert coord.completed()


def test_world_builder_sets_the_current_card_for_an_index_less_cuda_device(monkeypatch):
    """``make_world_builder`` on ``"cuda"`` (no index, the entry points'
    default) selects the card by its index: ``torch.cuda.set_device``
    refuses a device without one."""
    from edl_tpu_torch.runtime.coordinator import ElasticPlan

    seen = []

    class Stop(Exception):
        pass

    def set_device(d):
        seen.append(d)
        raise Stop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    build = launcher.make_world_builder("t0", "cuda")
    plan = ElasticPlan(generation=1, world_size=1, members=("t0",), restore_step=0,
                       addresses=("127.0.0.1:9",))
    try:
        build(plan)
    except Stop:
        pass
    assert seen == [0]
