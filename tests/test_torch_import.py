"""The port stands alone: it imports with JAX and the JAX package
blocked, none of its files (nor ``chip_smoke.py``) imports them, and
its entry points ask for CUDA unless told otherwise.  Also: the elastic
loop's pipeline reads the device only at its sanctioned sync points."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "edl_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "edl_tpu"}


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_module_imports_with_jax_and_edl_tpu_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'edl_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import edl_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(edl_tpu_torch.__path__, 'edl_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'edl_tpu_torch.serving.server' in names, names\n"
        "assert 'edl_tpu_torch.serving.prefix' in names, names\n"
        "from edl_tpu_torch.serving.prefix import PrefixCache, chain_hashes\n"
        "from edl_tpu_torch.serving.server import ServingReplica, serve_run, main\n"
        "from edl_tpu_torch.serving import DrainingError\n"
        "import edl_tpu_torch.runtime.elastic, edl_tpu_torch.launcher\n"
        "import edl_tpu_torch.checkpoint.hostdram, edl_tpu_torch.checkpoint.transfer\n"
        "import edl_tpu_torch.consensus\n"
        "for n in ('edl_tpu_torch.serving.migrate', 'edl_tpu_torch.serving.router',\n"
        "          'edl_tpu_torch.serving.client', 'edl_tpu_torch.telemetry.recorder',\n"
        "          'edl_tpu_torch.telemetry.aggregate', 'edl_tpu_torch.telemetry.spans'):\n"
        "    assert n in names, n\n"
        "from edl_tpu_torch.serving.migrate import MigrationReceiver, migrate_out\n"
        "from edl_tpu_torch.serving.router import RequestRouter, RouterServer, main\n"
        "from edl_tpu_torch.serving.client import RetryingClient, RetryBudgetExhausted\n"
        "from edl_tpu_torch.telemetry import FlightRecorder, TelemetryAggregator, get_recorder\n"
        "for n in CONTROL_PLANE:\n"
        "    assert n in names, n\n"
        "from edl_tpu_torch.resource import TrainingJob, GPU_RESOURCE_KEY\n"
        "from edl_tpu_torch.cluster import Cluster, FakeKube, KubectlAPI, NodeInfo\n"
        "from edl_tpu_torch.autoscaler import Autoscaler, scale_all_jobs_dry_run\n"
        "from edl_tpu_torch.controller import Controller, JobParser, pod_env\n"
        "from edl_tpu_torch.cli import build_parser, main\n"
        "for n in FLEET_MARKET:\n"
        "    assert n in names, n\n"
        "from edl_tpu_torch.fleet import (Arbitration, Bid, ChipInventory, FleetArbiter,\n"
        "    ServingBidder, TrainingBidder, arbitrate, attach_fleet)\n"
        "from edl_tpu_torch.autoscaler import (ServingLane, attach_serving_lane,\n"
        "    kube_replica_glue, post_drain)\n"
        "from edl_tpu_torch.cli import cmd_fleet\n"
        "for n in MODEL_ZOO:\n"
        "    assert n in names, n\n"
        "from edl_tpu_torch.models import get_model, load_workspace_factory, registered_models\n"
        "zoo = {'fit_a_line', 'mnist', 'resnet50', 'transformer_base', 'moe_lm'}\n"
        "assert zoo <= set(registered_models())\n"
        "from edl_tpu_torch.models.moe import MoELM, moe_loss_fn\n"
        "from edl_tpu_torch.convert import moe_from_flax\n"
        "from edl_tpu_torch.cli import cmd_route, cmd_serve\n"
        "assert get_model('moe_lm', tiny=True).decode.chunk_fn is not None\n"
        "from edl_tpu_torch.runtime.datasets import ingest_mnist_idx, ingest_tokens, read_idx\n"
        "from edl_tpu_torch.cli import cmd_ingest\n"
        "for n in CHAOS:\n"
        "    assert n in names, n\n"
        "from edl_tpu_torch.chaos import (KNOWN_POINTS, ChaosCoordinator, ChaosHTTPCoordinator,\n"
        "    ChaosKube, ChaosMonkey, FaultEvent, FaultSchedule, corrupt_checkpoint, corrupt_newest)\n"
        "assert len(KNOWN_POINTS) == 41\n"
        "print(len(names))\n"
    )
    code = (f"CONTROL_PLANE = {CONTROL_PLANE!r}\nFLEET_MARKET = {FLEET_MARKET!r}\n"
            f"MODEL_ZOO = {MODEL_ZOO!r}\nCHAOS = {CHAOS!r}\n" + code)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip().splitlines()[-1]) >= (
        21 + len(CONTROL_PLANE) + len(FLEET_MARKET) + len(MODEL_ZOO) + len(CHAOS))


#: the control plane's modules (resource, cluster, autoscaler,
#: controller, the CLI)
CONTROL_PLANE = (
    "edl_tpu_torch.utils.quantity", "edl_tpu_torch.resource.training_job",
    "edl_tpu_torch.cluster.gpu_topology", "edl_tpu_torch.cluster.resources",
    "edl_tpu_torch.cluster.kube", "edl_tpu_torch.cluster.cluster",
    "edl_tpu_torch.cluster.fake_kubectl", "edl_tpu_torch.autoscaler.algorithm",
    "edl_tpu_torch.autoscaler.scaler", "edl_tpu_torch.controller.coordclient",
    "edl_tpu_torch.controller.jobparser", "edl_tpu_torch.controller.lifecycle",
    "edl_tpu_torch.controller.watch", "edl_tpu_torch.controller.controller",
    "edl_tpu_torch.controller.deploy", "edl_tpu_torch.cli",
)

#: the model zoo's families (BASELINE configs 1-4, the MoE LM) and
#: their layers
MODEL_ZOO = (
    "edl_tpu_torch.models.fit_a_line", "edl_tpu_torch.models.mnist",
    "edl_tpu_torch.models.resnet", "edl_tpu_torch.models.transformer",
    "edl_tpu_torch.models.layers", "edl_tpu_torch.models.moe",
)

#: the chaos harness
CHAOS = (
    "edl_tpu_torch.chaos", "edl_tpu_torch.chaos.schedule", "edl_tpu_torch.chaos.storage",
    "edl_tpu_torch.chaos.membership", "edl_tpu_torch.chaos.transport",
    "edl_tpu_torch.chaos.kubeapi", "edl_tpu_torch.chaos.monkey",
)

#: the GPU market and the serving lane
FLEET_MARKET = (
    "edl_tpu_torch.fleet", "edl_tpu_torch.fleet.inventory", "edl_tpu_torch.fleet.bidders",
    "edl_tpu_torch.fleet.arbiter", "edl_tpu_torch.autoscaler.serving",
)


def test_kubectl_stand_in_and_job_model_import_without_torch():
    """The kubectl stand-in runs once per kubectl call: it and the job
    model import neither torch nor JAX."""
    code = (
        "import sys\n"
        "for name in ('torch', 'jax', 'jaxlib', 'flax', 'optax', 'edl_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import edl_tpu_torch.cluster.fake_kubectl, edl_tpu_torch.controller.jobparser\n"
        "import edl_tpu_torch.autoscaler.algorithm\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                       env=dict(os.environ, PYTHONPATH=str(ROOT)),
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_coordinator_metrics_is_prometheus_text_and_json_on_request():
    """``GET /metrics`` on the port's ``CoordinatorServer`` serves
    Prometheus text (the coordinator snapshot as gauges, merged with the
    members' telemetry), ``?format=json`` the snapshot dict, and
    ``HTTPCoordinator.metrics()`` reads the dict."""
    import urllib.request

    from edl_tpu_torch import telemetry
    from edl_tpu_torch.runtime import LocalCoordinator
    from edl_tpu_torch.runtime.coord_service import CoordinatorServer, HTTPCoordinator

    coord = LocalCoordinator(target_world=1, max_world=2)
    server = CoordinatorServer(coord, host="127.0.0.1", port=0).start(evict=False)
    base = f"http://127.0.0.1:{server.port}"
    try:
        client = HTTPCoordinator(f"127.0.0.1:{server.port}")
        client.register("m0", address="127.0.0.1:1")
        reg = telemetry.MetricsRegistry()
        reg.counter("edl_serve_tokens_total").inc(5)
        client.report_telemetry("m0", snapshot=reg.snapshot(), seq=1, boot="b",
                                events=[{"kind": "serve.drain", "data": {"phase": "start"}}])
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            ctype = r.headers.get("Content-Type")
            text = r.read().decode()
        assert ctype.startswith("text/plain")
        assert "# TYPE edl_generation gauge\nedl_generation 1\n" in text
        assert "edl_world_size 1" in text and "edl_serve_tokens_total 5" in text
        with urllib.request.urlopen(f"{base}/metrics?format=json", timeout=10) as r:
            snap = json.loads(r.read())
        assert snap == coord.metrics() == client.metrics()
        assert snap["generation"] == 1 and snap["world_size"] == 1
        assert client.metrics_text() == text
        tel = client.telemetry()
        assert tel["sources"] == {"m0": 1}
        assert [e["kind"] for e in tel["events"]][-1] == "serve.drain"
    finally:
        server.stop()


def test_no_port_file_imports_jax_flax_optax_or_edl_tpu():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in FORBIDDEN:
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {n}")
    assert not bad, bad


def test_entry_points_default_to_cuda(monkeypatch):
    """Given no device, entry points ask for CUDA; where it is absent
    they raise rather than run on the CPU."""
    from edl_tpu_torch import launcher, resolve_device
    from edl_tpu_torch.checkpoint import HostCheckpoint, HostDRAMStore
    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.runtime import (
        BatchStager,
        ElasticTrainer,
        LocalCoordinator,
        ShardedDataIterator,
        Trainer,
    )
    from edl_tpu_torch.serving import DecodeEngine, InferenceEngine, KVBlockPool
    from edl_tpu_torch.serving.server import ServingReplica, build_replica, serve_run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = get_model("transformer_lm", tiny=True)
    it = ShardedDataIterator({"x": np.zeros((8, 1), np.float32)}, 8)
    ckpt = HostCheckpoint(step=0, generation=0, leaves=[np.zeros(1, np.float32)])
    for make in (
        resolve_device,
        lambda: DecodeEngine(model),
        lambda: InferenceEngine(model),
        lambda: KVBlockPool(1, 1, 16, 2, 16, torch.bfloat16),
        lambda: build_replica("transformer_lm", tiny=True),
        lambda: DecodeEngine(model, store=HostDRAMStore()),
        lambda: ServingReplica(DecodeEngine(model, store=HostDRAMStore())),
        lambda: serve_run("transformer_lm", tiny=True),
        lambda: Trainer(model),
        lambda: ElasticTrainer(model, it, LocalCoordinator()),
        lambda: HostDRAMStore().restore(ckpt),
        lambda: BatchStager(it),
        lambda: launcher.run("transformer_lm", steps=1, model_kwargs={"tiny": True}),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA the script exits non-zero and prints no result —
    and alone in a directory (without the package) it fails too."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=str(ROOT),
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env.pop("PYTHONPATH")
    r = subprocess.run(
        [sys.executable, str(alone)], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_elastic_run_fetches_only_at_sanctioned_sync_points(monkeypatch):
    """Every host read of a tensor that the port's own code makes inside
    ``ElasticTrainer.run`` (pipeline depth 2, 10 steps, interval saves
    at 4 and 8) is the lagged harvest of one step's loss: no other
    ``.item()``, ``float()``, ``int()``, ``bool()`` or ``tolist()``.  On
    a CUDA tensor each of those would block the host on the device and
    silently make the pipeline synchronous.  (Adam's reads of its own
    host-side step counts are torch's, not the port's.)"""
    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.runtime import (
        ElasticTrainer,
        LocalCoordinator,
        ShardedDataIterator,
        synthetic_dataset,
    )

    model = get_model("transformer_lm", tiny=True, dtype=torch.float32)
    coord = LocalCoordinator()
    coord.register("tr0")
    it = ShardedDataIterator(synthetic_dataset(model.synth_batch, 64), 8)
    et = ElasticTrainer(model, it, coord, device="cpu", checkpoint_interval=4)
    et.run(1)  # the first resize (init) stays outside the counted window
    calls = []

    def counting(name):
        real = getattr(torch.Tensor, name)

        def wrapper(self, *a, **k):
            caller = sys._getframe(1)
            if caller.f_code.co_filename.startswith(str(PKG)):
                frames, f = [], caller
                while f is not None:
                    frames.append(f.f_code.co_name)
                    f = f.f_back
                calls.append((name, frames))
            return real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrapper)

    for name in ("item", "__float__", "__int__", "__bool__", "tolist"):
        counting(name)
    et.run(10)
    monkeypatch.undo()
    assert [r.step for r in et.history] == list(range(10))
    assert len(calls) == 9, calls  # steps 1..9, each harvested once
    assert all(n == "item" and "_harvest_one" in frames for n, frames in calls), calls
    assert et.pipeline_stats["max_in_flight"] == 2
