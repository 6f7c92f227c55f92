"""User code, real corpora and ``/predict`` for the model zoo, on the CPU.

- The workspace contract: an unregistered entrypoint loads from the
  job's ``trainer.workspace`` (``model.py`` exposing ``build(**kwargs)
  -> ModelDef``, this package's, in PyTorch), through ``local-run``, and
  through the launcher from the pod env the job parser renders; missing
  code fails loudly (as ``tests/test_models.py`` holds the JAX package).
- Ingest: IDX files written from numpy become the same array store as
  the JAX package's ingester makes, and ``local-run --data-dir`` trains
  ``mnist`` (the spec's default model) on those bytes; a token file
  round-trips into rows.
- ``/predict`` for each family at its tiny size behind
  ``InferenceEngine``, ``ContinuousBatcher`` and ``ServingServer``: the
  replies equal ``predict_fn`` run directly on the same inputs (labels
  and tokens where the top-2 margin exceeds 2e-2 of the row's largest
  |logit|, ``pred`` to bf16 tolerance).
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from edl_tpu.runtime import datasets as jax_datasets
from edl_tpu_torch import launcher
from edl_tpu_torch.cli import main
from edl_tpu_torch.controller import jobparser
from edl_tpu_torch.models import get_model
from edl_tpu_torch.resource.training_job import TrainingJob
from edl_tpu_torch.runtime import ShardedDataIterator, Trainer
from edl_tpu_torch.runtime.datasets import load_array_store, read_idx

USER_MODEL = '''
import numpy as np
import torch
from torch import nn

import helper  # a sibling module: the workspace dir is on sys.path

from edl_tpu_torch.models.base import ModelDef


class Linear(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.empty(4))

    def forward(self, x):
        return x @ self.w


def build(**kwargs):
    def module(sd, device):
        m = Linear().to(device)
        m.load_state_dict(sd)
        return m

    def loss_fn(params, batch, generator=None):
        loss = torch.mean((params(batch["x"]) - batch["y"]) ** 2)
        return loss, {"loss": loss}

    def synth_batch(rng, n):
        x = rng.randn(n, 4).astype(np.float32)
        return {"x": x, "y": x @ np.arange(4.0, dtype=np.float32)}

    return ModelDef(
        name="user_linear",
        init_params=lambda g: {"w": torch.randn(4, generator=g) * helper.SCALE},
        bind_params=lambda sd, device: module(sd, device).eval(),
        synth_batch=synth_batch,
        train_params=module,
        loss_fn=loss_fn,
    )
'''


def _job_yaml(path, entrypoint="", workspace="", gbs=16):
    path.write_text(f"""
apiVersion: edl.tpu.dev/v1
kind: TrainingJob
metadata:
  name: user-job
spec:
  fault_tolerant: true
  global_batch_size: {gbs}
  trainer:
    entrypoint: "{entrypoint}"
    workspace: "{workspace}"
    min_instance: 1
    max_instance: 1
""")
    return str(path)


@pytest.fixture
def workspace(tmp_path):
    ws = tmp_path / "userspace"
    ws.mkdir()
    (ws / "helper.py").write_text("SCALE = 0.5\n")
    (ws / "model.py").write_text(USER_MODEL)
    return ws


def _summary(capsys):
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


def test_local_run_trains_a_workspace_model(workspace, tmp_path, capsys):
    spec = _job_yaml(tmp_path / "job.yaml", "user_linear", str(workspace))
    assert main(["local-run", spec, "--steps", "12", "--device", "cpu"]) == 0
    summary = _summary(capsys)
    assert summary["model"] == "user_linear" and summary["steps"] == 12
    assert np.isfinite([summary["first_loss"], summary["final_loss"]]).all()


def test_the_pod_env_carries_the_workspace_to_the_launchers_model(workspace, monkeypatch):
    """The trainer pod's env, as the job parser renders it (less the
    coordinator address: the launcher then runs alone), is all the
    launcher needs to build and train the user's model."""
    job = TrainingJob.from_manifest({
        "apiVersion": "edl.tpu.dev/v1", "kind": "TrainingJob", "metadata": {"name": "u"},
        "spec": {"global_batch_size": 8, "trainer": {
            "entrypoint": "user_linear", "workspace": str(workspace)}}}).validate()
    env = {e["name"]: e["value"] for e in jobparser.pod_env(job) if "value" in e}
    assert env["EDL_WORKSPACE"] == str(workspace) and env["EDL_ENTRYPOINT"] == "user_linear"
    for key, value in env.items():
        if key != "EDL_COORDINATOR_ADDR":
            monkeypatch.setenv(key, value)
    monkeypatch.delenv("EDL_COORDINATOR_ADDR", raising=False)
    et = launcher.run(steps=3, device="cpu")
    assert et.model.name == "user_linear" and len(et.history) == 3


def test_workspace_errors_are_loud(tmp_path):
    with pytest.raises(ValueError, match="trainer.workspace"):
        get_model("no_such_model")
    ws = tmp_path / "empty_ws"
    ws.mkdir()
    with pytest.raises(ValueError, match="no model.py"):
        get_model("no_such_model", workspace=str(ws))
    (ws / "model.py").write_text("x = 1\n")
    with pytest.raises(ValueError, match="build"):
        get_model("no_such_model", workspace=str(ws))
    ws2 = tmp_path / "ws2"
    ws2.mkdir()
    (ws2 / "model.py").write_text("def build(**kw):\n    return 42\n")
    with pytest.raises(ValueError, match="not a ModelDef"):
        get_model("no_such_model", workspace=str(ws2))
    # a registered name never loads from the workspace
    assert get_model("fit_a_line", workspace=str(ws2)).name == "fit_a_line"


# -- ingest -------------------------------------------------------------------


def _write_idx(path, arr):
    with open(path, "wb") as f:
        f.write(bytes([0, 0, 0x08, arr.ndim]))
        f.write(np.asarray(arr.shape, ">u4").tobytes())
        f.write(np.ascontiguousarray(arr, np.uint8).tobytes())


def test_ingested_mnist_idx_trains_through_local_run(tmp_path, capsys):
    """IDX bytes (digit-like stripes, 0-255) -> the same store as the JAX
    ingester's -> ``local-run --data-dir`` on a spec with no entrypoint
    (``mnist``), whose first loss is the loss of the store's first
    global batch."""
    synth = get_model("mnist").synth_batch(np.random.RandomState(0), 256)
    images = (np.clip(synth["image"][..., 0], 0, 1) * 255).astype(np.uint8)
    _write_idx(tmp_path / "images.idx", images)
    _write_idx(tmp_path / "labels.idx", synth["label"].astype(np.uint8))
    store = tmp_path / "store"
    assert main(["ingest", "mnist", "--images", str(tmp_path / "images.idx"),
                 "--labels", str(tmp_path / "labels.idx"), "--out", str(store)]) == 0
    manifest = json.loads(capsys.readouterr().out)
    assert manifest["n"] == 256 and manifest["provenance"]["format"] == "mnist-idx"
    jax_datasets.ingest_mnist_idx(str(tmp_path / "jax_store"), str(tmp_path / "images.idx"),
                                  str(tmp_path / "labels.idx"))
    got, want = load_array_store(str(store)), jax_datasets.load_array_store(
        str(tmp_path / "jax_store"))
    for k in ("image", "label"):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    np.testing.assert_array_equal(read_idx(str(tmp_path / "images.idx")), images)

    spec = _job_yaml(tmp_path / "job.yaml")
    assert main(["local-run", spec, "--steps", "4", "--device", "cpu",
                 "--data-dir", str(store)]) == 0
    summary = _summary(capsys)
    assert summary["model"] == "mnist" and summary["steps"] == 4
    trainer = Trainer(get_model("mnist"), device="cpu", seed=0)
    first = trainer.eval_loss(trainer.init_state(),
                              ShardedDataIterator(got, 16, seed=0).device_batch(0, "cpu"))
    assert abs(summary["first_loss"] - first.item()) <= 1e-4


@pytest.mark.parametrize("suffix", [".npy", ".u16"])
def test_ingest_tokens_round_trips(tmp_path, capsys, suffix):
    flat = np.random.RandomState(0).randint(0, 32000, size=1000)
    path = tmp_path / f"corpus{suffix}"
    if suffix == ".npy":
        np.save(path, flat.astype(np.int64))
    else:
        flat.astype("<u2").tofile(path)
    assert main(["ingest", "tokens", "--tokens", str(path), "--seq-len", "15",
                 "--out", str(tmp_path / "tok")]) == 0
    manifest = json.loads(capsys.readouterr().out)
    rows = load_array_store(str(tmp_path / "tok"))["tokens"]
    assert rows.dtype == np.int32 and rows.shape == (62, 16)
    np.testing.assert_array_equal(rows.reshape(-1), flat[: 62 * 16])
    assert manifest["provenance"]["dropped_tokens"] == str(1000 - 62 * 16)
    jax_datasets.ingest_tokens(str(tmp_path / "jtok"), str(path), seq_len=15)
    np.testing.assert_array_equal(rows, jax_datasets.load_array_store(str(tmp_path / "jtok"))
                                  ["tokens"])


def test_ingest_refuses_missing_files(tmp_path, capsys):
    assert main(["ingest", "mnist", "--out", str(tmp_path / "s")]) == 2
    assert main(["ingest", "tokens", "--out", str(tmp_path / "s")]) == 2


# -- /predict -----------------------------------------------------------------


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("name", ["fit_a_line", "mnist", "resnet50", "transformer_base"])
def test_predict_replies_equal_predict_fn(name):
    """Eight concurrent ``POST /predict`` of one example each, batched by
    the server into padded buckets, against ``predict_fn`` on all eight
    at once."""
    from edl_tpu_torch.serving.server import build_replica

    engine, batcher, _, server = build_replica(name, device="cpu", tiny=True)
    model = engine.model
    rows = model.synth_batch(np.random.RandomState(7), 8)
    inputs = {k: rows[k] for k in model.predict_inputs}
    replies = [None] * 8

    def ask(i):
        replies[i] = _post(f"http://127.0.0.1:{server.port}/predict",
                           {"inputs": {k: v[i].tolist() for k, v in inputs.items()}})

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.stop()
        batcher.stop()
    params = engine.current_weights().params
    with torch.no_grad():
        want = model.predict_fn(params, {k: torch.from_numpy(v) for k, v in inputs.items()})
    got = {k: np.concatenate([np.asarray(r["outputs"][k]) for r in replies]) for k in want}
    assert all(r["weights_step"] == 0 for r in replies)
    if name == "fit_a_line":
        np.testing.assert_allclose(got["pred"], want["pred"].numpy(), rtol=1e-5, atol=1e-5)
        return
    if name == "transformer_base":
        with torch.no_grad():
            logits = params(*(torch.from_numpy(inputs[k]) for k in ("src", "tgt"))).numpy()
        key = "tokens"
    else:
        logits = want["logits"].numpy()
        np.testing.assert_allclose(got["logits"], logits, rtol=2e-2,
                                   atol=2e-2 * np.abs(logits).max())
        key = "label"
    top2 = np.sort(logits, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2e-2 * np.abs(logits).max(axis=-1)
    np.testing.assert_array_equal(got[key][sure], want[key].numpy()[sure])

