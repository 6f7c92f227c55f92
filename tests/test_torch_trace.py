"""The port's flight-recorder spill, merged timeline, profiler windows
and ``edl trace`` / ``edl metrics``, against the JAX package's, on the
CPU.

- ``member_streams``, ``merge_events``, ``chrome_trace`` and
  ``trace_chains`` of both packages give equal JSON for the same
  journals (phases the port's resizes journal: flush, world formation,
  restore, and the overlapped background flush);
- the JSONL spill rotates at ``spill_max_mb`` and backs off after a
  write failure, counting its drops, byte for byte like the JAX
  recorder's;
- ``StepProfiler`` on ``torch.profiler``: a deferred window, a window
  re-armed by a resize, and the ``profile.window`` events, whose
  identities equal the JAX profiler's; ``ElasticTrainer`` with the
  profiler on gives the same loss stream bit for bit, windows that
  cover exactly their steps, and one trace id from the retarget to the
  first step after it;
- ``edl trace --journal ... --summary`` and ``edl trace <coordinator>
  --summary`` print what the JAX command prints for the same inputs;
  ``edl metrics --prom`` shows a member's spill counter;
- every literal ``.record("<kind>"`` in ``edl_tpu_torch/`` and
  ``chip_smoke.py`` names a key of the port's ``KNOWN_EVENT_KINDS``,
  whose keys are the JAX package's, less those of slices not ported.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from edl_tpu import telemetry as jax_telemetry
from edl_tpu.telemetry import KNOWN_EVENT_KINDS as JAX_KINDS
from edl_tpu.telemetry import trace as jax_trace
from edl_tpu.telemetry.recorder import FlightRecorder as JaxRecorder
from edl_tpu_torch import telemetry
from edl_tpu_torch.telemetry import KNOWN_EVENT_KINDS
from edl_tpu_torch.telemetry import trace
from edl_tpu_torch.telemetry.recorder import FlightRecorder
from edl_tpu_torch.utils.profiling import StepProfiler

ROOT = Path(__file__).resolve().parents[1]


def _ev(kind, wall, trace_id="", timing=None, seq=1, step=0, generation=1, **data):
    d = {"seq": seq, "step": step, "generation": generation, "kind": kind,
         "data": data, "wall": wall}
    if trace_id:
        d["trace"] = trace_id
    if timing:
        d["timing"] = timing
    return d


def _coordinator_journal():
    """A coordinator journal: its own plan and ack events, and two
    members' ingested tails (``data.origin``), w2's clock 100 s ahead."""
    phases = {"flush": 0.03, "world_formation": 0.2, "restore": 0.09,
              "flush_bg": 1.4, "flush_bg_join": 1.1}
    return [
        _ev("coord.plan", 1000.0, "t1", seq=1, reason="retarget", world_size=2),
        {**_ev("consensus.vote", 1100.9, "t1", seq=2, step=5, proposed_stop=8),
         "data": {"proposed_stop": 8, "origin": "w2"}},
        {**_ev("resize", 1002.0, "t1", {"seconds": 1.5, "phases": phases}, seq=3, step=8),
         "data": {"world_size": 2, "graceful": True, "origin": "w1"}},
        {**_ev("checkpoint.save", 1000.6, "t1", seq=4, step=8),
         "data": {"kind": "flush", "step": 8, "origin": "w1"}},
        _ev("coord.world_acked", 1002.1, "t1", seq=5, world_size=2),
        {**_ev("step.first", 1102.3, "t1", seq=6, step=8),
         "data": {"world_size": 2, "origin": "w2"}},
        {**_ev("serve.prefix", 1003.0, seq=7), "data": {"outcome": "invalidated",
                                                         "origin": "w1"}},
        _ev("coord.plan", 1010.0, "t2", seq=8, reason="evict", world_size=1),
    ]


@pytest.mark.parametrize("trace_id", ["", "t1"], ids=["all", "one-chain"])
def test_merged_timeline_equals_jax(trace_id):
    journal = _coordinator_journal()
    offsets = {"w2": -100.0}
    streams = trace.member_streams(journal)
    assert streams == jax_trace.member_streams(journal)
    merged = trace.merge_events(streams, offsets)
    assert merged == jax_trace.merge_events(streams, offsets)
    assert [e["kind"] for e in merged][:3] == ["coord.plan", "checkpoint.save", "consensus.vote"]
    doc = trace.chrome_trace(merged, trace_id=trace_id)
    assert json.dumps(doc, sort_keys=True) == json.dumps(
        jax_trace.chrome_trace(merged, trace_id=trace_id), sort_keys=True)
    names = [e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert {"resize/flush", "resize/world_formation", "resize/restore",
            "resize/flush_bg"} <= set(names)
    assert trace.trace_chains(merged) == jax_trace.trace_chains(merged)
    assert set(trace.trace_chains(merged)) == {"t1", "t2"}


def test_the_timeline_lays_out_the_ports_resize_phases():
    """The serial phases a resize slice nests are the port's ledger's,
    back to back from the window's start."""
    from edl_tpu_torch.telemetry.ledger import RESIZE_PHASES

    phases = {"flush": 0.25, "world_formation": 0.5, "restore": 0.75}
    merged = trace.merge_events({"w1": [_ev("resize", 10.0, "t", {"seconds": 2.0,
                                                                  "phases": phases})]})
    slices = {e["name"]: e for e in trace.chrome_trace(merged)["traceEvents"]
              if e.get("ph") == "X"}
    start = slices["resize"]["ts"]
    for name in RESIZE_PHASES:
        assert slices[f"resize/{name}"]["ts"] == pytest.approx(start)
        start += phases[name] * 1e6


def test_new_trace_id_has_one_home():
    from edl_tpu_torch.runtime import coordinator

    assert not hasattr(coordinator, "new_trace_id") or (
        coordinator.new_trace_id is trace.new_trace_id)
    a, b = trace.new_trace_id(), trace.new_trace_id()
    assert a != b and len(a) == len(jax_trace.new_trace_id()) == 16


# ---- the JSONL spill -------------------------------------------------------------


def test_spill_rotation_bounds_file_size_like_jax(tmp_path):
    files = {}
    for name, cls in (("jax", JaxRecorder), ("port", FlightRecorder)):
        path = tmp_path / name / "events.jsonl"
        path.parent.mkdir()
        rec = cls(spill_path=str(path), spill_max_mb=0.001, clock=lambda: 7.0)
        for i in range(200):
            rec.record("resize", {"world_size": i}, step=i, generation=0)
        assert len(rec) == 200
        assert path.stat().st_size <= 1200 and Path(f"{path}.1").stat().st_size <= 1200
        files[name] = (path.read_bytes(), Path(f"{path}.1").read_bytes())
    assert files["port"] == files["jax"]


def test_spill_failure_counts_drops_and_recovers_like_jax(tmp_path):
    seen = {}
    for name, cls, tel in (("jax", JaxRecorder, jax_telemetry),
                           ("port", FlightRecorder, telemetry)):
        clock = [100.0]
        base = tmp_path / name
        with tel.scoped() as (reg, _):
            rec = cls(spill_path=str(base / "x.jsonl"), clock=lambda: clock[0])
            rec.record("resize", {}, step=1, generation=0)  # the open fails
            rec.record("resize", {}, step=2, generation=0)  # backing off
            drops = reg.counter("edl_flight_spill_dropped_total").value()
            base.mkdir()
            clock[0] += 10.0
            rec.record("resize", {}, step=3, generation=0)
            spilled = trace.load_journal(str(base / "x.jsonl"))
        seen[name] = (drops, rec.spill_dropped, [e["step"] for e in spilled])
    assert seen["port"] == seen["jax"] == (2, 2, [3])


def test_spill_to_publishes_the_drop_counter_at_zero(tmp_path):
    with telemetry.scoped() as (reg, rec):
        assert "edl_flight_spill_dropped_total" not in reg.snapshot()["counters"]
        rec.spill_to(str(tmp_path / "events.jsonl"))
        assert reg.snapshot()["counters"]["edl_flight_spill_dropped_total"] == {"": 0.0}


def test_load_journal_skips_a_torn_tail(tmp_path):
    path = tmp_path / "events.jsonl"
    path.write_text(json.dumps(_ev("resize", 1.0)) + "\n" + '{"seq": 2, "ki')
    assert trace.load_journal(str(path)) == jax_trace.load_journal(str(path))
    assert len(trace.load_journal(str(path))) == 1


# ---- the profiler ----------------------------------------------------------------


def _annotations(path):
    doc = json.loads(Path(path).read_text())
    return sorted(e["name"] for e in doc["traceEvents"]
                  if str(e.get("name", "")).startswith("train#"))


def test_profiler_at_step_defers_the_window(tmp_path):
    p = StepProfiler(profile_dir=str(tmp_path), max_steps=2, at_step=10, device="cpu")
    p.maybe_start(0)
    assert not p.tracing and not p.files
    p.maybe_start(10)
    assert p.tracing
    for step in (10, 11):
        with p.step(step):
            torch.ones(4).sum()
    assert p.closing
    p.maybe_stop()
    assert not p.tracing and len(p.files) == 1
    assert _annotations(p.files[0]) == ["train#10", "train#11"]
    p.maybe_start(12)  # closed: no new window without a rearm
    assert not p.tracing


def test_profiler_rearm_on_resize_opens_a_second_window(tmp_path):
    p = StepProfiler(profile_dir=str(tmp_path), max_steps=1, rearm_on_resize=True, device="cpu")
    p.maybe_start(0)
    with p.step(0):
        pass
    p.maybe_stop()
    p.note_resize()
    p.maybe_start(5)
    assert p.tracing
    with p.step(5):
        pass
    p.maybe_stop()
    assert [_annotations(f) for f in p.files] == [["train#0"], ["train#5"]]


def test_profiler_windows_journal_the_jax_events(tmp_path, monkeypatch):
    import jax

    from edl_tpu.utils.profiling import StepProfiler as JaxProfiler

    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
    idents = {}
    for name, cls, tel, kw in (("jax", JaxProfiler, jax_telemetry, {}),
                               ("port", StepProfiler, telemetry, {"device": "cpu"})):
        with tel.scoped() as (_, rec):
            p = cls(profile_dir=str(tmp_path), max_steps=1, at_step=3, rearm_on_resize=True, **kw)
            for step in (2, 3, 4):
                p.maybe_start(step)
                with p.step(step):
                    pass
                p.maybe_stop()
            p.note_resize()
            p.maybe_start(7)
            p.stop()
            idents[name] = [e.identity() for e in rec.events()]
    assert idents["port"] == idents["jax"]
    assert len(idents["port"]) == 4


def test_profiler_is_off_without_a_directory(monkeypatch):
    monkeypatch.delenv("EDL_PROFILE_DIR", raising=False)
    p = StepProfiler(device="cpu")
    p.maybe_start(0)
    assert not p.enabled and not p.tracing
    with p.step(0):
        pass
    p.maybe_stop()
    p.stop()
    assert p.files == []


# ---- the elastic loop: profiler windows and one trace id --------------------------


def _tiny_elastic(coord, profiler=None):
    from edl_tpu_torch.checkpoint import HostDRAMStore
    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.runtime import ElasticTrainer, ShardedDataIterator, synthetic_dataset

    model = get_model("transformer_lm", tiny=True, dtype=torch.float32)
    ds = synthetic_dataset(model.synth_batch, 64, seed=0)
    et = ElasticTrainer(model, ShardedDataIterator(ds, 8, seed=0), coord, store=HostDRAMStore(),
                        device="cpu", checkpoint_interval=4)
    if profiler is not None:
        et.profiler = profiler
    return et


def test_elastic_profile_windows_and_the_retargets_trace(tmp_path):
    """A window at steps 2-3 and one re-armed by a traced prewarm hint
    and retarget at step 5; the loss stream equals the same run's
    without a profiler bit for bit, each window's file annotates
    exactly its steps, every event of the member from the hint to
    ``step.first`` carries the decision's trace id, and the hint is
    journaled once (not again once the world is the hinted size)."""
    from edl_tpu_torch.runtime import LocalCoordinator

    streams = {}
    for on in (False, True):
        with telemetry.scoped() as (_, rec):
            coord = LocalCoordinator(target_world=1, max_world=2)
            coord.register("tr0")
            coord.register("tr1")
            prof = StepProfiler(profile_dir=str(tmp_path / "prof"), max_steps=2, at_step=2,
                                rearm_on_resize=True, device="cpu") if on else None
            et = _tiny_elastic(coord, prof)
            et.heartbeat_ids = ["tr0", "tr1"]
            et.run(5)
            coord.set_prewarm(2, trace_id="feedfacefeedface")
            et.run(5)  # one poll sees the hint
            coord.set_target_world(2, trace_id="feedfacefeedface")
            et.run(9)
            et.store.wait()
            streams[on] = [(r.step, r.loss) for r in et.history]
            events = rec.events()
    assert streams[True] == streams[False]
    assert [_annotations(f) for f in prof.files] == [["train#2", "train#3"], ["train#5", "train#6"]]
    windows = [(e.data["phase"], e.data["window"], e.step) for e in events
               if e.kind == "profile.window"]
    assert windows == [("open", 1, 2), ("close", 1, 3), ("open", 2, 5), ("close", 2, 6)]
    traced = [i for i, e in enumerate(events) if e.trace == "feedfacefeedface"]
    chain = events[traced[0]:traced[-1] + 1]
    assert {e.trace for e in chain} == {"feedfacefeedface"}
    assert [e.kind for e in chain if e.kind != "profile.window"] == [
        "prewarm.hint", "checkpoint.save", "resize", "step.first"]
    assert chain[0].data == {"world_size": 2}
    assert [e.kind for e in events].count("prewarm.hint") == 1
    assert chain[1].data == {"step": 5, "kind": "flush"}
    resize = next(e for e in chain if e.kind == "resize")
    assert resize.data["graceful"] and resize.data["world_size"] == 2
    assert set(resize.timing["phases"]) >= {"flush", "restore"}
    assert all(e.trace == "" for e in events[traced[-1] + 1:])


# ---- edl trace / edl metrics -------------------------------------------------------


def _journals(tmp_path):
    j1, j2 = tmp_path / "w1.jsonl", tmp_path / "w2.jsonl"
    j1.write_text(
        json.dumps(_ev("resize", 10.0, "cafe", {"seconds": 1.0}, seq=1, world_size=2)) + "\n"
        + json.dumps(_ev("step.first", 10.2, "cafe", seq=2)) + "\n")
    j2.write_text(json.dumps(_ev("consensus.quiesce", 9.8, "cafe", seq=1)) + "\n")
    return [f"w1={j1}", f"w2={j2}"]


def _run_cli(main, args, out, capsys):
    rc = main(["trace", *args, "--out", str(out), "--summary"])
    printed = capsys.readouterr().out.replace(str(out), "OUT")
    return rc, printed, json.loads(out.read_text())


def test_trace_journal_summary_prints_what_jax_prints(tmp_path, capsys):
    from edl_tpu.cli import main as jax_main
    from edl_tpu_torch.cli import main

    args = [a for j in _journals(tmp_path) for a in ("--journal", j)]
    got = _run_cli(main, args, tmp_path / "port.json", capsys)
    want = _run_cli(jax_main, args, tmp_path / "jax.json", capsys)
    assert got == want
    assert got[0] == 0 and "causal chains (1)" in got[1] and "cafe" in got[1]


def test_trace_live_coordinator_summary_prints_what_jax_prints(tmp_path, capsys):
    from edl_tpu.cli import main as jax_main
    from edl_tpu.runtime.coord_service import CoordinatorServer as JaxServer
    from edl_tpu.runtime.coordinator import LocalCoordinator as JaxCoordinator
    from edl_tpu_torch.cli import main
    from edl_tpu_torch.runtime import LocalCoordinator
    from edl_tpu_torch.runtime.coord_service import CoordinatorServer

    outs = {}
    for name, coord_cls, server_cls, tel, run in (
            ("jax", JaxCoordinator, JaxServer, jax_telemetry, jax_main),
            ("port", LocalCoordinator, CoordinatorServer, telemetry, main)):
        coord = coord_cls(target_world=1, max_world=2)
        coord.register("a")
        reg = tel.MetricsRegistry()
        m = reg.counter("edl_goodput_seconds_total")
        m.inc(9.0, state="stepping")
        m.inc(1.0, state="resizing")
        coord.report_telemetry("a", snapshot=reg.snapshot(), seq=1, boot="b",
                               clock={"offset": 0.001, "rtt": 0.002},
                               events=[_ev("resize", 5.0, "beef", {"seconds": 0.5})])
        server = server_cls(coord, host="127.0.0.1", port=0).start(evict=False)
        try:
            outs[name] = _run_cli(run, [f"127.0.0.1:{server.port}", "--trace-id", "beef"],
                                  tmp_path / f"{name}.json", capsys)
        finally:
            server.stop()
    # the coordinators' own plan events carry fresh random trace ids
    # and wall stamps: hold the lines and documents that do not
    got, want = outs["port"], outs["jax"]
    assert got[0] == want[0] == 0
    keep = ("events merged", "clock offset", "frac", "total_s", "stepping", "resizing")
    assert [ln for ln in got[1].splitlines() if ln.strip().startswith(keep)] == [
        ln for ln in want[1].splitlines() if ln.strip().startswith(keep)]
    assert "0.9000" in got[1] and "clock offset a" in got[1]
    assert got[2] == want[2]
    assert any(e["name"] == "resize" and e["ph"] == "X" for e in got[2]["traceEvents"])


def test_metrics_prom_and_json_show_a_members_spill_counter(tmp_path, capsys):
    from edl_tpu_torch.cli import main
    from edl_tpu_torch.runtime import LocalCoordinator
    from edl_tpu_torch.runtime.coord_service import CoordinatorServer

    coord = LocalCoordinator(target_world=1, max_world=1)
    coord.register("a")
    with telemetry.scoped() as (reg, rec):
        rec.spill_to(str(tmp_path / "a.jsonl"))
        rec.record("resize", {"world_size": 1}, step=0, generation=1)
        coord.report_telemetry("a", snapshot=reg.snapshot(), seq=1, boot="b",
                               events=[e.to_dict() for e in rec.events()])
    server = CoordinatorServer(coord, host="127.0.0.1", port=0).start(evict=False)
    try:
        addr = f"127.0.0.1:{server.port}"
        assert main(["metrics", addr, "--prom"]) == 0
        prom = capsys.readouterr().out
        assert main(["metrics", addr, "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert main(["metrics", addr]) == 0
        pretty = capsys.readouterr().out
    finally:
        server.stop()
    assert "edl_flight_spill_dropped_total 0" in prom
    assert doc["telemetry"]["merged"]["counters"]["edl_flight_spill_dropped_total"] == {"": 0.0}
    assert "flight recorder" in pretty and "resize" in pretty


# ---- the event-kind registry -------------------------------------------------------


def _literal_record_kinds():
    """(path:line, kind) of every ``.record("<kind>", ...)`` call in the
    port and chip_smoke.py; CUDA event records and the recorder's own
    ingest pass no string literal and are not collected."""
    files = sorted((ROOT / "edl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    found = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "record" and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                found.append((f"{path.relative_to(ROOT)}:{node.lineno}", node.args[0].value))
    return found


def test_every_literal_record_kind_is_registered():
    found = _literal_record_kinds()
    assert len(found) > 40
    unknown = [(where, kind) for where, kind in found if kind not in KNOWN_EVENT_KINDS]
    assert not unknown
    # the catalog holds nothing the port never journals (the ingest
    # default "event" is not a literal record)
    assert set(KNOWN_EVENT_KINDS) - {k for _, k in found} == {"event"}


def test_the_ports_kinds_are_the_jax_kinds_of_the_ported_slices():
    assert set(KNOWN_EVENT_KINDS) <= set(JAX_KINDS)
    missing = set(JAX_KINDS) - set(KNOWN_EVENT_KINDS)
    assert missing == {k for k in JAX_KINDS if k.startswith("fabric.")}


def _literal_payloads(root, kind):
    """(data keys, "outcome" value or None) of every ``.record("<kind>",
    {literal dict}, ...)`` call under ``root``."""
    out = set()
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "record" and len(node.args) >= 2
                    and isinstance(node.args[0], ast.Constant) and node.args[0].value == kind
                    and isinstance(node.args[1], ast.Dict)):
                keys = tuple(sorted(k.value for k in node.args[1].keys))
                outcome = None
                for k, v in zip(node.args[1].keys, node.args[1].values):
                    if k.value == "outcome" and isinstance(v, ast.Constant):
                        outcome = v.value
                out.add((keys, outcome))
    return out


@pytest.mark.parametrize("kind", ["chaos", "serve.prefix"])
def test_the_chaos_and_prefix_payloads_are_the_jax_packages(kind):
    """Every literal payload the port journals under ``kind`` (its keys
    and its outcome) is one the JAX package journals, and the other way
    round: the chaos event and the prefix cache's ``invalidated``,
    ``hash_skew_rejected`` and ``chaos_evicted`` outcomes."""
    got = _literal_payloads(ROOT / "edl_tpu_torch", kind)
    want = _literal_payloads(ROOT / "edl_tpu", kind)
    assert got and got == want
    if kind == "serve.prefix":
        assert {o for _, o in got} == {"invalidated", "hash_skew_rejected", "chaos_evicted"}


def test_the_catalog_is_a_pure_literal():
    src = (ROOT / "edl_tpu_torch" / "telemetry" / "catalog.py").read_text()
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "KNOWN_EVENT_KINDS":
            assert ast.literal_eval(node.value) == KNOWN_EVENT_KINDS
            break
    else:
        raise AssertionError("KNOWN_EVENT_KINDS not assigned at module level")


def test_the_launcher_spills_the_journal_its_env_names(tmp_path, monkeypatch):
    from edl_tpu_torch import launcher

    path = tmp_path / "events.jsonl"
    monkeypatch.setenv("EDL_FLIGHT_RECORDER_FILE", str(path))
    assert launcher.env_config()["flight_recorder_file"] == str(path)
    with telemetry.scoped() as (_, rec):
        launcher.run("transformer_lm", steps=2, device="cpu", dataset_examples=16,
                     model_kwargs={"tiny": True, "dtype": torch.float32})
        kinds = [e["kind"] for e in trace.load_journal(str(path))]
        assert kinds == [e.kind for e in rec.events()]
    assert "resize" in kinds and "step.first" in kinds


# ---- the serving plane's journal ---------------------------------------------------


def test_warm_journals_each_model_call_it_runs():
    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.serving import DecodeEngine

    with telemetry.scoped() as (_, rec):
        engine = DecodeEngine(get_model("transformer_lm", tiny=True), device="cpu", max_seqs=2)
        engine.install_seeded(0)
        ran = engine.warm()
        warm = [e for e in rec.events() if e.kind == "serve.warm"]
    assert [e.data["call"] for e in warm] == ["prefill", "chunk", "decode"][:ran]
    assert [e.data["bucket"] for e in warm] == [
        engine.prompt_bucket_for(1), engine.chunk_bucket_for(1), engine.decode_bucket_for(1)][:ran]
    assert all(e.timing["seconds"] >= 0 for e in warm)


def test_the_prefix_cache_journals_invalidation_and_collisions_like_jax():
    import jax.numpy as jnp

    from edl_tpu.serving import KVBlockPool as JaxPool
    from edl_tpu.serving.prefix import PrefixCache as JaxCache
    from edl_tpu_torch.serving import KVBlockPool, PrefixCache

    prompt = np.arange(3, 3 + 40, dtype=np.int32)
    pools = {"jax": lambda: JaxPool(2, 4, 16, num_blocks=9, block_tokens=8, dtype=jnp.bfloat16,
                                    sharding=None),
             "port": lambda: KVBlockPool(2, 4, 16, num_blocks=9, block_tokens=8,
                                         dtype=torch.bfloat16, device="cpu")}
    idents = {}
    for name, cache_cls, tel in (("jax", JaxCache, jax_telemetry),
                                 ("port", PrefixCache, telemetry)):
        with tel.scoped() as (_, rec):
            pool = pools[name]()
            cache = cache_cls(pool, 8)
            cache.rekey((1, 0))
            blocks = pool.alloc(5)
            cache.publish(prompt, blocks)
            pool.free(blocks)
            # a collision: the entry's stored tokens differ from the probe's
            entry = next(iter(cache._index.values()))
            entry.tokens = b"\x00" * len(entry.tokens)
            assert cache.claim(prompt) == ([], 0)
            cache.rekey((2, 0))
            idents[name] = [(e.kind, e.data, e.timing) for e in rec.events()]
            assert cache.stats["skew_rejected"] == 1
    assert idents["port"] == idents["jax"]
    assert [d["outcome"] for _, d, _ in idents["port"]] == ["hash_skew_rejected", "invalidated"]
