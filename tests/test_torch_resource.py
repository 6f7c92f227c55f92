"""The port's resource model (``edl_tpu_torch.resource``,
``utils/quantity.py``, ``cluster/gpu_topology.py``) against the JAX
package's: the TrainingJob specs of ``tests/test_resource.py``, mapped
by ``tpu_to_gpu``, parse, validate and quantize the same; the two
settings the port cannot honour yet are refused."""

import copy

import numpy as np
import pytest
import yaml

from edl_tpu.cluster import tpu_topology as jax_topo
from edl_tpu.resource import training_job as jax_tj
from edl_tpu.utils import quantity as jax_q
from edl_tpu_torch.cluster import gpu_topology as topo
from edl_tpu_torch.resource import training_job as tj
from edl_tpu_torch.utils import quantity as q
from torch_vocab import tpu_to_gpu

RESNET_YAML = """
apiVersion: edl.tpu.dev/v1
kind: TrainingJob
metadata:
  name: resnet50
  namespace: ml
spec:
  fault_tolerant: true
  global_batch_size: 4096
  trainer:
    entrypoint: "python -m edl_tpu.models.resnet"
    min_instance: 1
    max_instance: 16
    slice_topology: v5e-4
    resources:
      requests: {cpu: "4", memory: 8Gi}
      limits: {"google.com/tpu": "4"}
"""


def _job(name="j1", mn=1, mx=1, ft=False, topo_name=None, gbs=0, res=None, status=None,
         layout=None, **spec):
    trainer = {"min_instance": mn, "max_instance": mx}
    if topo_name is not None:
        trainer["slice_topology"] = topo_name
    if res is not None:
        trainer["resources"] = res
    if layout is not None:
        trainer["parallelism"] = layout
    m = {"apiVersion": "edl.tpu.dev/v1", "kind": "TrainingJob", "metadata": {"name": name},
         "spec": {"fault_tolerant": ft, "global_batch_size": gbs, "trainer": trainer, **spec}}
    if status is not None:
        m["status"] = status
    return m


#: the specs of tests/test_resource.py (and the validation paths it
#: names), as JAX-vocabulary manifests
CASES = {
    "defaults": _job(),
    "elastic_without_ft": _job(mn=1, mx=4, ft=False),
    "elastic_with_ft": _job(mn=1, mx=4, ft=True),
    "min_zero": _job(mn=0),
    "max_below_min": _job(mn=3, mx=1),
    "no_name": _job(name=""),
    "unknown_topology": _job(topo_name="v9-banana"),
    "unlisted_topology": _job(topo_name="v5e-12"),
    "cpu_topology": _job(topo_name="cpu"),
    "cpu_topology_with_limit": _job(topo_name="cpu", res={"limits": {"google.com/tpu": "4"}}),
    "topology_fallback": _job(topo_name="v5e-8"),
    "gbs_6_on_1_chip": _job(mn=1, mx=4, ft=True, topo_name="v5e-1", gbs=6),
    "gbs_8_on_1_chip": _job(mn=1, mx=4, ft=True, topo_name="v5e-1", gbs=8),
    "gbs_0_on_1_chip": _job(mn=1, mx=4, ft=True, topo_name="v5e-1", gbs=0),
    "gbs_8_on_4_chips": _job(mn=1, mx=4, ft=True, topo_name="v5e-4", gbs=8),
    "gbs_32_on_4_chips": _job(mn=1, mx=4, ft=True, topo_name="v5e-4", gbs=32),
    "negative_limit": _job(res={"limits": {"google.com/tpu": "-4"}}),
    "negative_cpu": _job(res={"requests": {"cpu": "-500m"}}),
    "non_scalar_quantity": _job(res={"requests": {"cpu": {"oops": 1}}}),
    "limit_contradicts_topology": _job(topo_name="v5e-4", res={"limits": {"google.com/tpu": "8"}}),
    "limit_agrees_with_topology": _job(topo_name="v5e-4", res={"limits": {"google.com/tpu": "4"}}),
    "roundtrip": _job(name="mnist", mn=1, mx=4, ft=True, topo_name="v5e-4", gbs=128,
                      status={"state": "Running", "parallelism": 2}),
    "null_port": {"metadata": {"name": "x"}, "spec": {"port": None}},
    "bogus_state": {"metadata": {"name": "x"}, "status": {"state": "Bogus"}},
    "bad_api_version": {"apiVersion": "edl.tpu.dev/v2", "metadata": {"name": "x"}},
    "resnet_yaml": yaml.safe_load(RESNET_YAML),
    "multi_host": _job(mn=1, mx=3, ft=True, topo_name="v5e-16", gbs=96,
                       res={"requests": {"cpu": "8", "memory": "32Gi"}}),
    "negative_priority": _job(priority=-1),
    "priority": _job(priority=3),
    "serving_without_checkpoint_dir": _job(serving={"min_replicas": 1, "max_replicas": 2}),
    "serving": _job(serving={"min_replicas": 1, "max_replicas": 2, "port": 7181},
                    checkpoint_dir="/ckpt"),
    "serving_bad_bounds": _job(serving={"min_replicas": 3, "max_replicas": 2},
                               checkpoint_dir="/ckpt"),
    "dataset_and_cache": _job(dataset_dir="/data", compile_cache_dir="/cache",
                              checkpoint_interval_steps=7, passes=3, image="img:1",
                              port=9000, volumes=[{"name": "v"}]),
    "unknown_layout_axis": _job(mn=1, mx=2, ft=True, topo_name="v5e-1",
                                layout={"zz": 2}),
    "layout_axis_zero": _job(mn=1, mx=2, ft=True, topo_name="v5e-1",
                             layout={"fsdp": 0}),
    "layout_not_dividing": _job(mn=1, mx=2, ft=True, topo_name="v5e-1",
                                layout={"tp": 4}),
    "trivial_layout": _job(mn=1, mx=2, ft=True, topo_name="v5e-1",
                           layout={"fsdp": 1}),
}
#: valid for the JAX package, refused by the port (ROADMAP item named)
REFUSED = {
    "layout": (_job(mn=1, mx=2, ft=True, topo_name="v5e-4", gbs=16, layout={"fsdp": 2}),
               "ROADMAP A-8"),
    "shard_only": (_job(shard_only=True), "ROADMAP A-7"),
}


def _port_manifest(m):
    """The JAX manifest in the port's words.  A trainer without a
    topology gets the JAX default's counterpart (h100-4): the port's own
    default, h100-1, is pinned apart."""
    m = copy.deepcopy(m)
    trainer = (m.get("spec") or {}).get("trainer")
    if isinstance(trainer, dict) and "slice_topology" not in trainer:
        trainer["slice_topology"] = "v5e-4"
    return tpu_to_gpu(m)


def _outcome(mod, manifest):
    """(stage, message) of a failure, or the job's facts."""
    try:
        job = mod.TrainingJob.from_manifest(manifest)
    except mod.ValidationError as e:
        return ("parse", str(e))
    try:
        job.validate()
    except mod.ValidationError as e:
        return ("validate", str(e))
    gpus = job.tpu_per_trainer() if mod is jax_tj else job.gpu_per_trainer()
    per_host = job.tpu_per_host() if mod is jax_tj else job.gpu_per_host()
    need = job.need_tpu() if mod is jax_tj else job.need_gpu()
    manifest = job.to_manifest()
    return {
        "manifest": manifest,
        "legal": job.legal_world_sizes(),
        "legal_one_device": job.legal_world_sizes(1),
        "gpus": gpus,
        "per_host": per_host,
        "hosts": job.hosts_per_replica(),
        "need": need,
        "elastic": job.elastic(),
        "names": [job.fullname(), job.trainer_job_name(), job.coordinator_name(),
                  job.serving_name(), job.router_name()],
        "normalized": job.spec.trainer.resources.normalized(),
    }


@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_parses_validates_and_quantizes_like_the_jax_package(case):
    want = tpu_to_gpu(_outcome(jax_tj, CASES[case]))
    got = _outcome(tj, _port_manifest(CASES[case]))
    assert got == want


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_port_refuses_what_it_cannot_honour_yet(case):
    manifest, item = REFUSED[case]
    jax_job = jax_tj.TrainingJob.from_manifest(manifest).validate()  # valid there
    assert jax_job.name == "j1"
    job = tj.TrainingJob.from_manifest(_port_manifest(manifest))
    with pytest.raises(tj.ValidationError, match=item):
        job.validate()


def test_port_defaults_to_one_gpu_replicas_and_its_own_image():
    job = tj.TrainingJob.from_manifest(_job()).validate()
    assert job.spec.trainer.slice_topology == "h100-1"
    assert (job.gpu_per_trainer(), job.hosts_per_replica()) == (1, 1)
    assert tj.DEFAULT_IMAGE == tpu_to_gpu(jax_tj.DEFAULT_IMAGE) == "edl-tpu-torch/trainer:latest"
    assert tj.GPU_RESOURCE_KEY == tpu_to_gpu(jax_tj.TPU_RESOURCE_KEY) == "nvidia.com/gpu"


def test_crd_is_the_jax_packages():
    assert tj.crd_manifest() == jax_tj.crd_manifest()


def test_quantized_world_sizes_agree_on_seeded_draws():
    rng = np.random.default_rng(0)
    axes = tj.LAYOUT_AXES
    for _ in range(300):
        mn = int(rng.integers(1, 9))
        mx = int(rng.integers(mn, 17))
        per = int(rng.choice([0, 1, 2, 4, 8, 16]))
        gbs = int(rng.choice([0, 8, 12, 16, 24, 48, 64, 96, 128, 4096]))
        layout = {a: int(rng.choice([1, 1, 2, 4])) for a in axes if rng.random() < 0.3}
        jpar = jax_tj.ParallelismSpec.from_dict(layout)
        par = tj.ParallelismSpec.from_dict(layout)
        assert (par.axes(), par.product(), par.nonbatch_product(), par.env_value()) == (
            jpar.axes(), jpar.product(), jpar.nonbatch_product(), jpar.env_value())
        assert tj.ParallelismSpec.from_env(par.env_value()) == par
        assert tj.quantized_world_sizes(mn, mx, per, gbs, par) == jax_tj.quantized_world_sizes(
            mn, mx, per, gbs, jpar), (mn, mx, per, gbs, layout)


QUANTITIES = ["250m", "2", "1.5", 1, "", None, 0, "1Gi", "64Mi", "500M", "2G", "4", 8,
              "4.5", "1Gi", "-3", "1e3", "7Ki", "3m", "0.5Gi", "abc"]


@pytest.mark.parametrize("fn", ["parse_cpu_milli", "parse_memory_mega", "parse_count",
                                "parse_quantity_bytes"])
def test_quantity_parsing_is_the_jax_packages(fn):
    def run(mod, v):
        try:
            return getattr(mod, fn)(v)
        except (ValueError, TypeError) as e:
            return type(e).__name__, str(e)

    assert [run(q, v) for v in QUANTITIES] == [run(jax_q, v) for v in QUANTITIES]
    a, b = {"cpu_milli": 1000}, {"cpu_milli": 500, "gpu": 4}
    assert q.add_resource_list(a, b) == {"cpu_milli": 1500, "gpu": 4}


def test_gpu_topologies_mirror_the_v5e_table():
    assert topo.legal_topologies() == tpu_to_gpu(jax_topo.legal_topologies())
    for name in jax_topo.legal_topologies():
        t, jt = topo.get_topology(tpu_to_gpu(name)), jax_topo.get_topology(name)
        assert (t.gpus, t.hosts) == (jt.chips, jt.hosts)
        assert topo.topology_gpus(t.name) == jax_topo.topology_chips(name)
        if jt.chips:
            label = "x".join(map(str, jt.ici_mesh))
            # a node's shape: the JAX package reads the ICI label, the
            # port the node's GPU count
            assert topo.normalize_topology(jt.chips).name == tpu_to_gpu(
                jax_topo.normalize_topology(label).name)
    for n in range(70):
        assert topo.largest_topology_fitting(n).gpus == jax_topo.largest_topology_fitting(n).chips
    assert topo.normalize_topology("3") is None and topo.normalize_topology("h100-2") is None
    with pytest.raises(ValueError, match="unknown GPU replica topology"):
        topo.get_topology("v5e-4")
