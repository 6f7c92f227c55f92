"""A member of a live two-member world dies mid-step, on the CPU.

Two worker processes, each an ``ElasticTrainer`` with an
``HTTPCoordinator`` and ``launcher.make_world_builder`` (gloo), step the
tiny LM at world 2 behind a ``CoordinatorServer`` hosted here, with a
short heartbeat lease.  While the victim harvests step 8, two steps
past the step-8 checkpoint in flight, the test SIGKILLs it.  Then:

- the survivor's next collective fails on the dead peer and the world
  is buried: it journals ``world.broken`` for the step it was running;
- the coordinator's lease reaper evicts the victim (``coord.evict``) and
  bumps the generation to a world of one;
- the survivor re-forms alone, restores its last checkpoint (not a
  flush: the state died with the world) and replays, and its loss
  stream equals a fixed world-1 run's (data parallelism on gloo is
  held to world 1 at 1e-5, as in ``tests/test_torch_elastic.py``).

On the CPU the step's gloo all-reduce is synchronous, so the dead peer
surfaces as an error in the step itself, at once; the collective
watchdog, which guards the lagged harvest of a step's outputs, does not
see it.  ``test_a_wedged_harvest_trips_the_watchdog_into_a_broken_world``
drives the watchdog's path: a harvest that never returns on a live
world of two, with the deadline the launcher sets for such worlds
shortened, buries the world the same way.

Every wait has its own deadline and the workers are killed in a
``finally``.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from edl_tpu_torch import telemetry
from edl_tpu_torch.checkpoint import HostDRAMStore
from edl_tpu_torch.models import get_model
from edl_tpu_torch.runtime import ElasticTrainer, LocalCoordinator, ShardedDataIterator
from edl_tpu_torch.runtime import synthetic_dataset
from edl_tpu_torch.runtime.coord_service import CoordinatorServer

ROOT = Path(__file__).resolve().parents[1]
STEPS = 12
INTERVAL = 4
#: killed in the harvest of step 8, with steps 9 and 10 dispatched (the
#: pipeline's depth of 2): the step-8 checkpoint exists and three steps
#: past it are lost with the world
KILL_AFTER = 8
PACE_S = 0.3
#: the coordinator's heartbeat lease: long enough that a member beating
#: every 0.25 s keeps it on a machine loaded by the rest of the suite
LEASE_S = 5.0
DP_RTOL = 1e-5
WAIT_S = 60

_WORKER = r"""
import json, os, sys, time
import torch
from edl_tpu_torch import telemetry
from edl_tpu_torch.checkpoint import HostDRAMStore
from edl_tpu_torch.launcher import make_world_builder
from edl_tpu_torch.models import get_model
from edl_tpu_torch.runtime import ElasticTrainer, ShardedDataIterator, synthetic_dataset
from edl_tpu_torch.runtime.coord_service import HTTPCoordinator

name, addr, port, out, progress, pace, timeout = sys.argv[1:8]
torch.set_num_threads(1)
model = get_model("transformer_lm", tiny=True, dtype=torch.float32)
ds = synthetic_dataset(model.synth_batch, 64, seed=0)
coord = HTTPCoordinator(addr)
et = ElasticTrainer(model, ShardedDataIterator(ds, 8, seed=0), coord, store=HostDRAMStore(),
                    device="cpu", checkpoint_interval=%d,
                    world_builder=make_world_builder(name, "cpu"))
et.HEARTBEAT_INTERVAL = 0.25
et.collective_timeout = float(timeout)
et.heartbeat_ids = [name]
et.register_address = f"127.0.0.1:{port}"
coord.register(name, address=et.register_address)

def on_step(rec):
    with open(progress, "a") as f:
        f.write(f"{rec.step} {rec.world_size}\n")
    time.sleep(float(pace))

et.run(%d, on_step=on_step)
et.stop_heartbeat()
et.world_builder.teardown()
with open(out, "w") as f:
    json.dump({"history": [[r.step, r.loss, r.world_size] for r in et.history],
               "resizes": [[e.world_size, e.graceful, e.restored_step, e.replayed_steps]
                           for e in et.resize_events],
               "journal": [e.to_dict() for e in telemetry.get_recorder().events()]}, f)
""" % (INTERVAL, STEPS)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(what, pred, procs=()):
    deadline = time.monotonic() + WAIT_S
    while not pred():
        for p in procs:
            assert p.poll() is None, f"{what}: a worker exited with {p.returncode}"
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def _progress(path):
    if not path.exists():
        return []
    return [tuple(int(x) for x in ln.split()) for ln in path.read_text().splitlines() if ln]


def _tiny_et(coord):
    model = get_model("transformer_lm", tiny=True, dtype=torch.float32)
    ds = synthetic_dataset(model.synth_batch, 64, seed=0)
    return ElasticTrainer(model, ShardedDataIterator(ds, 8, seed=0), coord, store=HostDRAMStore(),
                          device="cpu", checkpoint_interval=INTERVAL)


@pytest.fixture(scope="module")
def fixed_world():
    coord = LocalCoordinator(target_world=1, max_world=1)
    coord.register("solo")
    return {r.step: r.loss for r in _tiny_et(coord).run(STEPS)}


def test_sigkilled_member_is_evicted_and_the_survivor_replays(fixed_world, tmp_path):
    with telemetry.scoped():
        coord = LocalCoordinator(target_world=2, max_world=2, heartbeat_timeout=LEASE_S,
                                 legal_sizes=[1, 2])
        server = CoordinatorServer(coord, host="127.0.0.1", port=0).start()
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        procs = {}
        try:
            for name in ("lead", "victim"):
                args = [name, f"127.0.0.1:{server.port}", str(_free_port()),
                        str(tmp_path / f"{name}.json"), str(tmp_path / f"{name}.steps"),
                        str(PACE_S), "60"]
                procs[name] = subprocess.Popen(
                    [sys.executable, "-c", _WORKER, *args], cwd=str(ROOT), env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                # the lead registers first: it is rank 0 of every world
                _wait(f"{name} registered", lambda n=name: n in coord.members(), procs.values())
            victim_steps = tmp_path / "victim.steps"
            _wait("the victim harvesting step 8 at world 2",
                  lambda: (KILL_AFTER, 2) in _progress(victim_steps), procs.values())
            procs["victim"].send_signal(signal.SIGKILL)
            procs["victim"].wait(timeout=WAIT_S)
            out, _ = procs["lead"].communicate(timeout=WAIT_S)
            assert procs["lead"].returncode == 0, out.decode(errors="replace")
            coord_events = coord.recorder().events()
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                p.wait(timeout=WAIT_S)
            server.stop()
    lead = json.loads((tmp_path / "lead.json").read_text())
    journal = lead["journal"]
    (broken,) = [e for e in journal if e["kind"] == "world.broken"]
    assert broken["generation"] == 2 and broken["data"]["failed_step"] == broken["step"]
    evicted = [e.data for e in coord_events if e.kind == "coord.evict"]
    assert evicted == [{"members": ["victim"]}]
    # the survivor's resize after the break: alone, not graceful, from a
    # checkpoint at or before the break, replaying what it had done past it
    after = [e for e in journal if e["kind"] == "resize" and e["seq"] > broken["seq"]]
    assert len(after) == 1
    resize = after[0]["data"]
    assert (resize["world_size"], resize["graceful"]) == (1, False)
    assert resize["restored_step"] == INTERVAL * (broken["step"] // INTERVAL) == KILL_AFTER
    assert resize["replayed_steps"] == broken["step"] - resize["restored_step"] > 0
    first = [e for e in journal if e["kind"] == "step.first" and e["seq"] > after[0]["seq"]]
    assert first and first[0]["step"] == resize["restored_step"]
    # the stream: every step once at its last world, equal to world 1's
    last = {s: loss for s, loss, _ in lead["history"]}
    assert sorted(last) == list(range(STEPS))
    np.testing.assert_allclose([last[s] for s in range(STEPS)],
                               [fixed_world[s] for s in range(STEPS)], rtol=DP_RTOL)
    at2 = [i for i, (_, _, w) in enumerate(lead["history"]) if w == 2]
    alone = [s for s, _, _ in lead["history"][at2[-1] + 1:]]
    assert alone == list(range(resize["restored_step"], STEPS))


def test_a_wedged_harvest_trips_the_watchdog_into_a_broken_world():
    """The watchdog's own path, in process: a member of a live world of
    two (the world stubbed: no peer is needed for a harvest that never
    returns) whose loss fetch hangs past the deadline trips the
    watchdog, journals ``consensus.watchdog`` and ``world.broken``, and
    holds for a fresh generation."""
    from edl_tpu_torch.runtime import elastic

    with telemetry.scoped() as (_, rec):
        coord = LocalCoordinator(target_world=1, max_world=1)
        coord.register("solo")
        et = _tiny_et(coord)
        et.run(2)
        et.collective_timeout = 0.2
        et._watchdog = None  # the next fetch builds it with this deadline
        et.world_builder = lambda plan: None  # counted as a multi-process member
        et.trainer.world = 2

        class _Hung:
            def value(self):
                time.sleep(5)

        et._pending.append(elastic._InFlightStep(step=2, generation=et.generation, world_size=2,
                                                 t_dispatch=time.perf_counter(), loss=_Hung()))
        t0 = time.monotonic()
        assert not et._drain_guarded()
        assert time.monotonic() - t0 < 2.0
        kinds = [e.kind for e in rec.events()]
    assert kinds[-2:] == ["consensus.watchdog", "world.broken"]
    assert et._await_new_generation and et.state is None
