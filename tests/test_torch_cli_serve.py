"""The port's ``edl serve`` and ``edl route``, on the CPU.

- ``python -m edl_tpu_torch.cli serve --entrypoint moe_lm --tiny
  --device cpu --checkpoint-dir D`` loads the tiny ``moe_lm`` a
  ``Trainer`` spilled to ``D``, prints its JSON line (replica, model,
  port, weights step) and answers ``/generate`` with the tokens of a
  ``build_replica`` holding the same weights;
- ``edl route`` reads a ``RouterServer`` in front of that replica, as a
  table and as ``--json`` (the port's counterpart of
  ``tests/test_router.py``'s ``edl route`` test).
"""

import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from edl_tpu_torch import telemetry
from edl_tpu_torch.checkpoint import HostDRAMStore
from edl_tpu_torch.cli import main
from edl_tpu_torch.models import get_model
from edl_tpu_torch.runtime import ShardedDataIterator, Trainer, synthetic_dataset
from edl_tpu_torch.serving import RequestRouter, RouterServer
from edl_tpu_torch.serving.server import build_replica

ROOT = Path(__file__).resolve().parents[1]
STEPS = 2
NEW_TOKENS = 6


def _generate(port, prompt):
    body = json.dumps({"inputs": {"tokens": prompt}, "max_new_tokens": NEW_TOKENS}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())["tokens"]


class _Plan:
    def __init__(self, members, addresses):
        self.generation = 1
        self.members = tuple(members)
        self.addresses = tuple(addresses)


class _Coord:
    """The serving coordinator's plan and telemetry, for one replica."""

    def __init__(self, rid=None, address=None):
        self.rid, self.address = rid, address

    def plan(self):
        if self.rid is None:  # an empty fleet
            return _Plan([], [])
        return _Plan([self.rid], [self.address])

    def telemetry(self):
        return {"merged": {"counters": {}, "gauges": {}, "histograms": {}}, "events": []}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny ``moe_lm`` trained ``STEPS`` steps and spilled; ``edl
    serve`` on it in a subprocess.  Yields (its JSON line, the trained
    parameters, the prompt)."""
    spill = tmp_path_factory.mktemp("spill")
    model = get_model("moe_lm", tiny=True)
    trainer = Trainer(model, device="cpu", seed=0)
    it = ShardedDataIterator(synthetic_dataset(model.synth_batch, 16, seed=0), 4, seed=0)
    state = trainer.init_state()
    for step in range(STEPS):
        state, _ = trainer.step(state, it.device_batch(step, "cpu"))
    store = HostDRAMStore(spill_dir=str(spill))
    store.save_async(state)
    store.wait()
    params = {n: p.detach().clone() for n, p in state.params.named_parameters()}
    env = dict(os.environ, PYTHONPATH=str(ROOT), EDL_SERVE_PORT="0", EDL_POD_NAME="moe-0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "edl_tpu_torch.cli", "serve", "--entrypoint", "moe_lm", "--tiny",
         "--device", "cpu", "--checkpoint-dir", str(spill), "--port", "0", "--duration", "120"],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        line = proc.stdout.readline()
        if not line:
            raise AssertionError(f"edl serve printed nothing: {proc.stderr.read()}")
        prompt = model.synth_batch(np.random.RandomState(3), 1)["tokens"][0, :21].tolist()
        yield json.loads(line), params, prompt
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_serve_loads_the_spill_and_answers_as_build_replica(served):
    info, params, prompt = served
    assert info["model"] == "moe_lm" and info["weights_step"] == STEPS
    assert info["replica"] == "moe-0" and info["port"] > 0
    got = _generate(info["port"], prompt)
    with telemetry.scoped():
        engine, batcher, gen, server = build_replica("moe_lm", device="cpu", tiny=True)
        try:
            engine.install(params, step=STEPS)
            want = _generate(server.port, prompt)
        finally:
            server.stop()
            gen.stop()
            batcher.stop()
    assert len(got) == NEW_TOKENS and got == want


def test_route_prints_the_routing_table_and_json(served, capsys):
    info, _, _ = served
    address = f"127.0.0.1:{info['port']}"
    with telemetry.scoped():
        router = RequestRouter(_Coord(info["replica"], address))
        router.sync()
        router.probe_all()
        rs = RouterServer(router, host="127.0.0.1", port=0, sync_interval_s=1e9).start()
        try:
            assert main(["route", f"127.0.0.1:{rs.port}"]) == 0
            out = capsys.readouterr().out
            assert "plan_generation" in out and "fleet_ttft_p95" in out
            row = next(x for x in out.splitlines() if info["replica"] in x)
            assert address in row and "healthy" in row and row.rstrip().endswith("yes")
            assert main(["route", f"127.0.0.1:{rs.port}", "--json"]) == 0
            table = json.loads(capsys.readouterr().out)
            assert [(r["replica"], r["address"], r["health"]) for r in table["replicas"]] == [
                (info["replica"], address, "healthy")]
            assert table["plan_generation"] == 1
        finally:
            rs.stop()


def test_route_with_no_backends_and_serve_flags():
    """An empty fleet prints ``(no backends)``; ``serve`` takes the
    port's ``--device`` and ``--tiny`` in place of ``--platform``."""
    from edl_tpu_torch.cli import build_parser

    args = build_parser().parse_args(
        ["serve", "--entrypoint", "moe_lm", "--device", "cpu", "--tiny", "--duration", "1"])
    assert (args.entrypoint, args.device, args.tiny, args.duration, args.port) == (
        "moe_lm", "cpu", True, 1.0, 0)
    with pytest.raises(SystemExit):
        build_parser().parse_args(["serve", "--platform", "cpu"])
    with telemetry.scoped():
        rs = RouterServer(RequestRouter(_Coord()), host="127.0.0.1",
                          port=0, sync_interval_s=1e9).start()
        try:
            out = subprocess.run(
                [sys.executable, "-m", "edl_tpu_torch.cli", "route", f"127.0.0.1:{rs.port}"],
                cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT)),
                capture_output=True, text=True, timeout=60)
        finally:
            rs.stop()
    assert out.returncode == 0, out.stderr
    assert "(no backends)" in out.stdout
