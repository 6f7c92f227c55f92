"""The port's autoscaler (``edl_tpu_torch.autoscaler``) against the JAX
package's: every scenario runs once through each package, written in
the JAX package's words and mapped by ``tpu_to_gpu``; the dry run's
diffs, the simulated inventory it leaves and the views it mutates must
be equal.  The scenarios are the fabricated literals of
``tests/test_autoscaler.py`` and ``tests/test_multihost.py``, 300
seeded random clusters, and ``Autoscaler.run_once`` over FakeKube."""

import dataclasses
import threading
import time

import numpy as np
import pytest

from edl_tpu.autoscaler import algorithm as jax_alg
from edl_tpu.autoscaler import scaler as jax_scaler
from edl_tpu.cluster import cluster as jax_cluster
from edl_tpu.cluster import kube as jax_kube
from edl_tpu.cluster import resources as jax_res
from edl_tpu.resource import training_job as jax_tj
from edl_tpu.runtime import coordinator as jax_coord
from edl_tpu_torch.autoscaler import algorithm as alg
from edl_tpu_torch.autoscaler import scaler
from edl_tpu_torch.cluster import cluster as port_cluster
from edl_tpu_torch.cluster import kube as port_kube
from edl_tpu_torch.cluster import resources as res
from edl_tpu_torch.resource import training_job as tj
from edl_tpu_torch.runtime import coordinator as port_coord
from torch_vocab import tpu_to_gpu

#: JAX field names of the device axis -> the port's
_FIELDS = {"tpu_limit": "gpu_limit", "tpu_total": "gpu_total", "tpu_request": "gpu_request",
           "tpu_per_trainer": "gpu_per_trainer", "tpu_chips": "gpus",
           "tpu_topology": "gpu_topology"}


class Side:
    """One package behind the JAX package's vocabulary: a scenario calls
    it the same way for both, and ``obs`` returns what it observed in
    the port's words."""

    def __init__(self, jax: bool):
        self.jax = jax
        self.alg, self.res = (jax_alg, jax_res) if jax else (alg, res)
        self.kube = jax_kube if jax else port_kube
        self.cluster_mod = jax_cluster if jax else port_cluster
        self.scaler = jax_scaler if jax else scaler
        self.tj = jax_tj if jax else tj
        self.coord = jax_coord if jax else port_coord

    def f(self, name):
        return name if self.jax else _FIELDS.get(name, name)

    def w(self, value):
        """A JAX-vocabulary value in this side's words."""
        return value if self.jax else tpu_to_gpu(value)

    def obs(self, value):
        if dataclasses.is_dataclass(value) and not isinstance(value, type):
            value = dataclasses.asdict(value)
        return tpu_to_gpu(value) if self.jax else value

    def view(self, name="j", cpu=1000, mem=1024, tpu=4, mn=1, mx=4, parallelism=1, legal=None,
             topo="", hosts=1, pod_nodes=None):
        return self.alg.JobView(
            name=name, min_instance=mn, max_instance=mx, parallelism=parallelism,
            cpu_request_milli=cpu, mem_request_mega=mem, legal_sizes=list(legal or []),
            elastic=mn < mx, slice_topology=self.w(topo), hosts=hosts,
            pod_nodes=list(pod_nodes or []), **{self.f("tpu_per_trainer"): tpu})

    def roomy(self, n_nodes=4, cpu=8000, mem=32768, tpu=16):
        names = [f"node-{i}" for i in range(n_nodes)]
        return self.res.ClusterResource(
            node_count=n_nodes, cpu_total_milli=cpu * n_nodes, memory_total_mega=mem * n_nodes,
            nodes=self.res.Nodes(cpu_idle_milli={n: cpu for n in names},
                                 memory_free_mega={n: mem for n in names},
                                 **{self.f("tpu_free") if self.jax else "gpu_free":
                                    {n: tpu for n in names}}),
            **{self.f("tpu_total"): tpu * n_nodes})

    def set(self, obj, field, value):
        setattr(obj, self.f(field), value)

    def free(self, r):
        return r.nodes.tpu_free if self.jax else r.nodes.gpu_free

    def pools(self, r, labels, node_pool=None):
        r.nodes.pool_topology = {k: self.w(v) for k, v in labels.items()}
        if node_pool is not None:
            r.nodes.node_pool = dict(node_pool)

    def pending(self, tpu_chips=0, cpu_milli=0, mem_mega=0):
        return self.alg.PendingDemand(cpu_milli=cpu_milli, mem_mega=mem_mega,
                                      **{"tpu_chips" if self.jax else "gpus": tpu_chips})

    def node(self, name, cpu, mem, chips, label="", pool=""):
        return self.kube.NodeInfo(name=name, cpu_milli=cpu, memory_mega=mem, pool=pool,
                                  **{self.f("tpu_chips"): chips,
                                     self.f("tpu_topology"): self.w(label)})

    def job(self, manifest):
        return self.tj.TrainingJob.from_manifest(self.w(manifest)).validate()


# ---- the fabricated literals ---------------------------------------------------


def _plan(S, views, r, **kw):
    diff = S.alg.scale_all_jobs_dry_run(views, r, **kw)
    return [S.obs(diff), S.obs(r), [S.obs(v) for v in views]]


def _step(S, r, j, cur=0, **kw):
    d = S.alg.scale_dry_run(r, j, cur, **kw)
    return [d, S.obs(r), S.obs(j)]


def sc_fulfillment_and_sort(S):
    views = [S.view("a", parallelism=3, mn=1, mx=3), S.view("b", parallelism=1, mn=1, mx=3),
             S.view("c", parallelism=2, mn=1, mx=3), S.view("d", parallelism=1, mn=1, mx=3, tpu=8),
             S.view("e", parallelism=1, mn=1, mx=3, tpu=4),
             S.view("f", parallelism=1, mn=1, mx=3, tpu=4, cpu=500),
             S.view("g", tpu=0, mn=1, mx=4), S.view("h", mn=2, mx=2)]
    needs = S.alg.needs_tpu if S.jax else S.alg.needs_gpu
    return [[S.alg.fulfillment(v) for v in views],
            [v.name for v in S.alg.sorted_jobs(views)],
            [v.name for v in S.alg.sorted_jobs(views, S.alg.elastic)],
            [v.name for v in S.alg.sorted_jobs(views, needs)]]


def sc_search_checks_all_axes(S):
    r = S.roomy(n_nodes=2, cpu=2000, mem=2048, tpu=4)
    j = S.view(cpu=1500, mem=1024, tpu=4)
    out = [S.alg.search_assignable_node(r, j)]
    S.free(r)["node-0"] = 0
    out.append(S.alg.search_assignable_node(r, j))
    r.nodes.cpu_idle_milli["node-1"] = 100
    return out + [S.alg.search_assignable_node(r, j)]


def sc_scale_up_satisfied(S):
    return _step(S, S.roomy(), S.view(parallelism=1, mn=1, mx=4))


def sc_scale_up_insufficient_cpu(S):
    r = S.roomy(n_nodes=1, cpu=1000)
    r.cpu_request_milli = 500
    return _step(S, r, S.view(parallelism=1, mn=1, mx=4, cpu=1000), max_load_desired=1.0)


def sc_scale_up_insufficient_tpu(S):
    r = S.roomy(n_nodes=1, tpu=4)
    S.set(r, "tpu_limit", 4)
    return _step(S, r, S.view(parallelism=1, mn=1, mx=4, tpu=4))


def sc_scale_up_insufficient_memory(S):
    r = S.roomy(n_nodes=1, mem=1024)
    r.memory_request_mega = 512
    return _step(S, r, S.view(parallelism=1, mn=1, mx=4, mem=1024))


def sc_scale_up_no_assignable_node(S):
    r = S.roomy(n_nodes=4, cpu=800)
    r.cpu_total_milli = 100_000
    return _step(S, r, S.view(parallelism=1, mn=1, mx=4, cpu=1000))


def sc_scale_up_respects_max_load(S):
    out = []
    for load in (0.8, 1.0):
        r = S.roomy(n_nodes=1, cpu=10_000)
        r.cpu_request_milli = 7500
        out += _step(S, r, S.view(parallelism=1, mn=1, mx=4, cpu=1000, tpu=0),
                     max_load_desired=load)
    return out


def sc_scale_up_clamps_at_max(S):
    return (_step(S, S.roomy(), S.view(parallelism=4, mn=1, mx=4))
            + _step(S, S.roomy(), S.view(parallelism=6, mn=1, mx=4)))


def sc_scale_down_beyond_max(S):
    return _step(S, S.roomy(), S.view(parallelism=6, mn=1, mx=4), scale_down=True)


def sc_scale_down_cpu_pressure(S):
    r = S.roomy(n_nodes=1, cpu=4000)
    r.cpu_request_milli = 4000
    return _step(S, r, S.view(parallelism=3, mn=1, mx=4, cpu=1000), scale_down=True)


def sc_scale_down_stops_at_min(S):
    r = S.roomy(n_nodes=1, cpu=1000)
    r.cpu_request_milli = 1000
    return _step(S, r, S.view(parallelism=1, mn=1, mx=4), scale_down=True)


def sc_scale_down_idle_noop(S):
    return _step(S, S.roomy(), S.view(parallelism=3, mn=1, mx=4), scale_down=True)


def sc_quantized_step_up(S):
    j = S.view(parallelism=2, mn=1, mx=8, legal=[1, 2, 4, 8])
    r = S.roomy(n_nodes=4, tpu=4)
    S.set(r, "tpu_limit", 8)
    S.free(r)["node-0"] = S.free(r)["node-1"] = 0
    out = _step(S, r, j)
    r2 = S.roomy(n_nodes=4, tpu=4)
    S.set(r2, "tpu_limit", 12)
    for n in ("node-0", "node-1", "node-2"):
        S.free(r2)[n] = 0
    return out + _step(S, r2, S.view(parallelism=2, mn=1, mx=8, legal=[1, 2, 4, 8]))


def sc_quantized_step_down(S):
    r = S.roomy(n_nodes=1, cpu=4000)
    r.cpu_request_milli = 4000
    return _step(S, r, S.view(parallelism=4, mn=1, mx=8, cpu=500, legal=[1, 2, 4, 8]),
                 scale_down=True)


def sc_jobview_from_trainingjob(S):
    out = []
    for topo_name, gbs, mn, mx in (("v5e-4", 96, 1, 8), ("v5e-8", 0, 2, 6), ("v5e-16", 64, 1, 4)):
        job = S.job({"apiVersion": "edl.tpu.dev/v1", "kind": "TrainingJob",
                     "metadata": {"name": "x"},
                     "spec": {"fault_tolerant": True, "global_batch_size": gbs,
                              "trainer": {"min_instance": mn, "max_instance": mx,
                                          "slice_topology": topo_name,
                                          "resources": {"requests": {"cpu": "4",
                                                                     "memory": "8Gi"}}}}})
        for par in (None, 2):
            v = S.alg.JobView.from_job(job, parallelism=par, pod_nodes=["n1", "n0"])
            out.append([S.obs(v), v.next_size_up(4), v.next_size_down(4), v.clamp_size(5)])
    return out


def sc_plan_grows_all_to_max(S):
    return _plan(S, [S.view("a", parallelism=1, mn=1, mx=3, tpu=8),
                     S.view("b", parallelism=1, mn=1, mx=3, tpu=8)], S.roomy(n_nodes=8, tpu=8))


def sc_plan_splits_scarce_chips(S):
    r = S.roomy(n_nodes=8, tpu=4)
    S.set(r, "tpu_limit", 8)
    S.free(r)["node-0"] = S.free(r)["node-1"] = 0
    return _plan(S, [S.view("a", parallelism=1, mn=1, mx=8),
                     S.view("b", parallelism=1, mn=1, mx=8)], r)


def sc_plan_max_load_partial(S):
    r = S.roomy(n_nodes=1, cpu=10_000, tpu=0)
    r.cpu_request_milli = 1000
    r.nodes.cpu_idle_milli["node-0"] -= 1000
    return _plan(S, [S.view("a", parallelism=1, mn=1, mx=10, cpu=1000, tpu=0)], r,
                 max_load_desired=0.8)


def sc_plan_noop_for_non_elastic(S):
    return _plan(S, [S.view("a", parallelism=2, mn=2, mx=2)], S.roomy())


def sc_shed_until_under_max_load(S):
    r = S.roomy(n_nodes=2, cpu=4000, tpu=0)
    r.cpu_request_milli = 9000
    return _plan(S, [S.view("a", parallelism=4, mn=1, mx=4, cpu=1000, tpu=0),
                     S.view("b", parallelism=3, mn=1, mx=4, cpu=1000, tpu=0)], r)


def sc_full_cluster_shed_reaches_min(S):
    r = S.roomy(n_nodes=2, cpu=4000, tpu=0)
    r.cpu_request_milli = 50_000
    return _plan(S, [S.view("a", parallelism=4, mn=1, mx=4, cpu=1000, tpu=0),
                     S.view("b", parallelism=3, mn=1, mx=4, cpu=1000, tpu=0)], r)


def sc_fixed_point_at_full_utilization(S):
    r = S.roomy(n_nodes=2, tpu=4)
    S.set(r, "tpu_limit", 8)
    for n in list(S.free(r)):
        S.free(r)[n] = 0
    return _plan(S, [S.view("a", parallelism=2, mn=1, mx=4)], r)


def _full16(S):
    r = S.roomy(n_nodes=4, tpu=4)
    S.set(r, "tpu_limit", 16)
    for n in list(S.free(r)):
        S.free(r)[n] = 0
    return r


def sc_pending_sheds_running_jobs(S):
    return _plan(S, [S.view("a", parallelism=4, mn=1, mx=4)], _full16(S),
                 pending=S.pending(tpu_chips=4))


def sc_pending_suppresses_growth_while_starved(S):
    out = []
    for demand in (16, 4):
        r = S.roomy(n_nodes=4, tpu=4)
        S.set(r, "tpu_limit", 4)
        out += _plan(S, [S.view("a", parallelism=1, mn=1, mx=4)], r,
                     pending=S.pending(tpu_chips=demand))
    return out


def sc_pending_stops_shedding_once_satisfied(S):
    return _plan(S, [S.view("a", parallelism=4, mn=1, mx=4),
                     S.view("b", parallelism=4, mn=1, mx=4)], _full16(S),
                 pending=S.pending(tpu_chips=4))


def sc_cpu_pending_sheds_cpu_jobs(S):
    r = S.roomy(n_nodes=2, cpu=4000, tpu=0)
    r.cpu_request_milli = 7000
    return _plan(S, [S.view("a", parallelism=3, mn=1, mx=4, cpu=1000, tpu=0)], r,
                 pending=S.pending(cpu_milli=2000))


def sc_memory_oversubscription_sheds(S):
    r = S.roomy(n_nodes=1, mem=8192, tpu=0)
    r.memory_request_mega = 10000
    return _step(S, r, S.view("a", parallelism=3, mn=1, mx=4, mem=1024, tpu=0), scale_down=True)


def sc_slice_shape_refuses_split_across_pools(S):
    r = S.roomy(n_nodes=2, tpu=8)
    S.pools(r, {"node-0": "v5e-8", "node-1": "v5e-8"})
    j = S.view(tpu=16, mn=1, mx=2, topo="v5e-16")
    r2 = S.roomy(n_nodes=1, tpu=16)
    S.pools(r2, {"node-0": "v5e-16"})
    r3 = S.roomy(n_nodes=2, tpu=8)
    S.pools(r3, {"node-0": "v5e-8", "node-1": "v5e-8"})
    return ([S.alg.search_assignable_node(r, j), S.alg.search_assignable_node(r2, j)]
            + _step(S, r3, S.view(tpu=16, mn=1, mx=2, parallelism=1, topo="v5e-16")))


def sc_untyped_jobs_match_by_chip_count(S):
    r = S.roomy(n_nodes=1, tpu=16)
    S.pools(r, {"node-0": "v5e-8"})
    return [S.alg.search_assignable_node(r, S.view(tpu=8, mn=1, mx=2)),
            S.alg.search_assignable_node(r, S.view(tpu=4, mn=1, mx=2))]


def sc_over_max_clamp_lands_on_legal_size(S):
    return _step(S, S.roomy(), S.view(mn=1, mx=6, parallelism=8, legal=[1, 2, 4]))


def sc_shed_returns_capacity_to_victim_nodes(S):
    r = S.roomy(n_nodes=2, cpu=4000, tpu=4)
    r.cpu_request_milli = 8000
    S.set(r, "tpu_limit", 8)
    S.free(r).update({"node-0": 0, "node-1": 0})
    r.nodes.cpu_idle_milli = {"node-0": 0, "node-1": 0}
    a = S.view("a", parallelism=2, mn=1, mx=2, cpu=4000, tpu=4, pod_nodes=["node-1", "node-0"])
    return _step(S, r, a, scale_down=True)


def sc_freed_victim_node_is_replaceable(S):
    r = S.res.ClusterResource(
        node_count=2, cpu_total_milli=2400, cpu_request_milli=2400, memory_total_mega=65536,
        nodes=S.res.Nodes(cpu_idle_milli={"node-0": 50, "node-1": -50},
                          memory_free_mega={"node-0": 32768, "node-1": 32768},
                          **{"tpu_free" if S.jax else "gpu_free": {"node-0": 0, "node-1": 4}}),
        **{S.f("tpu_total"): 8, S.f("tpu_limit"): 4})
    a = S.view("a", parallelism=2, mn=1, mx=2, cpu=1150, mem=0, tpu=0,
               pod_nodes=["node-1", "node-0"])
    c = S.view("c", parallelism=1, mn=1, mx=2, cpu=100, mem=0, tpu=4, pod_nodes=["node-1"])
    return _plan(S, [a, c], r)


def sc_sim_placed_shed_frees_simulated_nodes(S):
    r = S.roomy(n_nodes=2, cpu=8000, tpu=4)
    j = S.view("j", parallelism=1, mn=1, mx=2, cpu=1000, mem=0, tpu=4, pod_nodes=["node-0"])
    out = _step(S, r, j)
    j.max_instance = 1
    j.legal_sizes = []
    return out + _step(S, r, j, cur=out[0], scale_down=True)


def sc_shed_skips_nodes_gone_from_inventory(S):
    r = S.roomy(n_nodes=1, cpu=4000, tpu=4)
    r.cpu_request_milli = 8000
    a = S.view("a", parallelism=2, mn=1, mx=2, cpu=4000, tpu=4, pod_nodes=["node-gone", "node-0"])
    return _step(S, r, a, scale_down=True)


def _slice_cluster(S, n, labeled_pool=True):
    nodes = [S.node(f"host-{i}", 16000, 65536, 8, "4x4",
                    pool=f"slice-{i // 2}" if labeled_pool else "") for i in range(n)]
    return S.cluster_mod.Cluster(S.kube.FakeKube(nodes)).inquiry_resource()


def sc_multihost_placement_takes_one_pool(S):
    j = S.view("mh", mn=1, mx=2, parallelism=1, cpu=1000, mem=1024, tpu=16, topo="v5e-16",
               hosts=2)
    r = _slice_cluster(S, 4)
    out = [S.alg.search_assignable_nodes(r, j), S.obs(r)]
    S.free(r)["host-0"] = S.free(r)["host-2"] = 0
    out.append(S.alg.search_assignable_nodes(r, j))
    out.append(S.alg.search_assignable_nodes(_slice_cluster(S, 2, labeled_pool=False), j))
    return out + _plan(S, [j], _slice_cluster(S, 6))


SCENARIOS = {name[3:]: fn for name, fn in sorted(globals().items()) if name.startswith("sc_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fixture_scenario_equals_the_jax_package(name):
    assert SCENARIOS[name](Side(jax=False)) == SCENARIOS[name](Side(jax=True))


def _a3_nodes(n, pool="a3"):
    """``n`` 8-GPU H100 nodes of one nodepool as ``KubectlAPI`` reads
    them: the Node objects ``fake_kubectl`` serves, through the same
    projection ``list_nodes`` applies."""
    from edl_tpu_torch.cluster import fake_kubectl

    return [port_kube.node_from_manifest(fake_kubectl.node_manifest(port_kube.NodeInfo(
        name=f"n{i}", cpu_milli=16000, memory_mega=65536, gpus=8, pool=pool)))
        for i in range(n)]


def test_multihost_replica_fits_one_host_shaped_nodes():
    """GPU nodes carry no slice label, so a node read from the cluster
    declares no pool shape and replicas pack by GPU count, as the
    reference counted GPUs per node: ``h100-1`` and ``h100-4`` replicas
    take part of an 8-GPU node, ``h100-8`` a whole one, and an
    ``h100-16`` replica two whole nodes of one nodepool."""
    S = Side(jax=False)
    nodes = _a3_nodes(3)
    assert [(n.gpus, n.gpu_topology, n.pool) for n in nodes] == [(8, "", "a3")] * 3
    r = port_cluster.Cluster(port_kube.FakeKube(nodes)).inquiry_resource()
    assert r.nodes.pool_topology == {}
    mh = S.view("mh", tpu=16, topo="h100-16", hosts=2)
    assert alg.search_assignable_nodes(r, mh) == ["n0", "n1"]
    for gpus in (1, 4, 8):
        assert alg.search_assignable_nodes(r, S.view("s", tpu=gpus, topo=f"h100-{gpus}")) == ["n0"]
    r.nodes.gpu_free["n0"] = 4  # half of n0 taken: not a host of an h100-16
    assert alg.search_assignable_nodes(r, mh) == ["n1", "n2"]
    assert alg.search_assignable_nodes(r, S.view("q", tpu=4, topo="h100-4")) == ["n0"]
    assert alg.search_assignable_nodes(r, S.view("e", tpu=8, topo="h100-8")) == ["n1"]


def test_autoscaler_grows_one_gpu_replicas_onto_8_gpu_nodes_read_through_kubectl(
        tmp_path, monkeypatch):
    """The autoscaler over ``KubectlAPI`` (the port's kubectl stand-in
    serving two 8-GPU nodes) grows an ``h100-1`` job and an ``h100-4``
    job from one replica each until the nodes' 16 GPUs are in use,
    packing both by GPU count."""
    import json
    import os
    import stat
    import sys

    state = tmp_path / "kube-state.json"
    state.write_text(json.dumps({"nodes": [
        {"name": f"a3-{i}", "cpu_milli": 16000, "memory_mega": 65536, "gpus": 8, "pool": "a3"}
        for i in range(2)]}))
    shim = tmp_path / "kubectl"
    shim.write_text(f'#!/bin/sh\nexec {sys.executable} -m edl_tpu_torch.cluster.fake_kubectl "$@"\n')
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("EDL_FAKE_KUBE_STATE", str(state))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(sys.path))
    kube = port_kube.KubectlAPI(kubectl=str(shim))
    assert [(n.gpus, n.gpu_topology) for n in kube.list_nodes()] == [(8, "")] * 2
    cluster = port_cluster.Cluster(kube)
    coords = {}
    a = scaler.Autoscaler(cluster, coord_client_factory=lambda job: coords.setdefault(
        job.name, port_coord.LocalCoordinator(target_world=1, max_world=12)))
    for name, topo, mx in (("one", "h100-1", 12), ("four", "h100-4", 2)):
        job = tj.TrainingJob.from_manifest(_manifest(name, 1, mx, topo))
        cluster.create_trainer_workload(job)
        a.on_add(job)
    a.run_once()
    par = {w.job_name: w.parallelism for w in kube.list_workloads()}
    assert par == {"one": 8, "four": 2}, par
    pods = [p for p in kube.list_pods() if p.phase == "Running"]
    assert sum(p.gpu_limit for p in pods) == 16
    assert {p.node for p in pods if p.job_name == "one"} == {"a3-0", "a3-1"}


# ---- 300 seeded random clusters ----------------------------------------------


def _random_case(seed):
    """A random cluster, job set and pending demand in the JAX package's
    words: 1-16 nodes of 0-8 chips, some in labeled pools, pairs of
    8-chip nodes in multi-host (v5e-16) pools; 1-8 jobs of v5e-1/4/8/16
    with CPU and memory requests, live pods on known or vanished nodes."""
    rng = np.random.default_rng(seed)
    nodes = []
    n_nodes = int(rng.integers(1, 17))
    i = 0
    while i < n_nodes:
        if i + 1 < n_nodes and rng.random() < 0.2:  # a two-host v5e-16 pool
            for k in range(2):
                nodes.append(dict(name=f"node-{i + k}", chips=8, label="v5e-16",
                                  pool=f"slice-{i}"))
            i += 2
            continue
        chips = int(rng.integers(0, 9))
        label = f"v5e-{chips}" if chips in (1, 4, 8) and rng.random() < 0.5 else ""
        nodes.append(dict(name=f"node-{i}", chips=chips, label=label, pool=""))
        i += 1
    for n in nodes:
        n["cpu"] = int(rng.choice([2000, 4000, 8000, 16000]))
        n["mem"] = int(rng.choice([4096, 16384, 65536]))
        n["used_chips"] = int(rng.integers(0, n["chips"] + 1)) if rng.random() < 0.4 else 0
        n["used_cpu"] = int(rng.integers(0, n["cpu"] + 1)) if rng.random() < 0.4 else 0
        n["used_mem"] = int(rng.integers(0, n["mem"] + 1)) if rng.random() < 0.3 else 0
    jobs = []
    names = [n["name"] for n in nodes] + ["node-gone"]
    for k in range(int(rng.integers(1, 9))):
        chips = int(rng.choice([0, 1, 4, 8, 16]))
        hosts = 2 if chips == 16 else 1
        mn = int(rng.integers(1, 4))
        mx = int(rng.integers(mn, mn + 5))
        gbs = int(rng.choice([0, 0, 16, 24, 48, 96]))
        legal = jax_tj.quantized_world_sizes(mn, mx, chips, gbs) if rng.random() < 0.5 else []
        if legal == []:
            legal = []
        par = int(rng.integers(max(1, mn - 1), mx + 2))
        pods = [str(rng.choice(names)) for _ in range(par * hosts)] if rng.random() < 0.7 else []
        jobs.append(dict(name=f"job-{k}", tpu=chips, hosts=hosts, mn=mn, mx=mx, parallelism=par,
                         legal=legal, topo=(f"v5e-{chips}" if chips and rng.random() < 0.8 else ""),
                         cpu=int(rng.choice([0, 250, 500, 1000, 2000])),
                         mem=int(rng.choice([0, 512, 1024, 4096])), pod_nodes=pods))
    pending = None
    if rng.random() < 0.4:
        pending = dict(tpu_chips=int(rng.choice([0, 1, 4, 8, 16])),
                       cpu_milli=int(rng.choice([0, 500, 2000])),
                       mem_mega=int(rng.choice([0, 1024, 8192])))
    return nodes, jobs, pending, float(rng.choice([0.8, 0.97, 1.0]))


def _run_random(S, case):
    nodes, jobs, pending, load = case
    free = {n["name"]: n["chips"] - n["used_chips"] for n in nodes}
    r = S.res.ClusterResource(
        node_count=len(nodes),
        cpu_total_milli=sum(n["cpu"] for n in nodes),
        cpu_request_milli=sum(n["used_cpu"] for n in nodes),
        memory_total_mega=sum(n["mem"] for n in nodes),
        memory_request_mega=sum(n["used_mem"] for n in nodes),
        nodes=S.res.Nodes(
            cpu_idle_milli={n["name"]: n["cpu"] - n["used_cpu"] for n in nodes},
            memory_free_mega={n["name"]: n["mem"] - n["used_mem"] for n in nodes},
            pool_topology={n["name"]: S.w(n["label"]) for n in nodes if n["label"]},
            node_pool={n["name"]: n["pool"] for n in nodes if n["pool"]},
            **{"tpu_free" if S.jax else "gpu_free": free}),
        **{S.f("tpu_total"): sum(n["chips"] for n in nodes),
           S.f("tpu_limit"): sum(n["used_chips"] for n in nodes),
           S.f("tpu_request"): sum(n["used_chips"] for n in nodes)})
    views = [S.view(j["name"], cpu=j["cpu"], mem=j["mem"], tpu=j["tpu"], mn=j["mn"], mx=j["mx"],
                    parallelism=j["parallelism"], legal=j["legal"], topo=j["topo"],
                    hosts=j["hosts"], pod_nodes=j["pod_nodes"]) for j in jobs]
    pend = S.pending(**pending) if pending else None
    return _plan(S, views, r, max_load_desired=load, pending=pend)


@pytest.mark.parametrize("chunk", range(10))
def test_random_clusters_plan_like_the_jax_package(chunk):
    changed = 0
    for seed in range(chunk * 30, chunk * 30 + 30):
        case = _random_case(seed)
        got = _run_random(Side(jax=False), case)
        assert got == _run_random(Side(jax=True), case), seed
        changed += bool(got[0])
    assert changed  # the draws do move jobs, not just hold them


# ---- Autoscaler.run_once over FakeKube ---------------------------------------


def _manifest(name, mn, mx, topo_name, cpu="1", mem="1Gi", gbs=0):
    return {"apiVersion": "edl.tpu.dev/v1", "kind": "TrainingJob", "metadata": {"name": name},
            "spec": {"fault_tolerant": mn < mx, "global_batch_size": gbs,
                     "trainer": {"min_instance": mn, "max_instance": mx,
                                 "slice_topology": topo_name,
                                 "resources": {"requests": {"cpu": cpu, "memory": mem}}}}}


def _autoscaler_sequence(S, nodes, arrivals, ticks, victim="newest"):
    """Jobs arrive at their tick (``arrivals``: tick -> manifests); each
    tick runs ``Autoscaler.run_once`` and observes the plan, every
    job's parallelism and its coordinator's target and prewarm hint."""
    kube = S.kube.FakeKube([S.node(**n) for n in nodes], scale_down_victim=victim)
    cluster = S.cluster_mod.Cluster(kube)
    coords = {}

    def client(job):
        return coords.setdefault(job.name, S.coord.LocalCoordinator(
            target_world=job.spec.trainer.min_instance, max_world=job.spec.trainer.max_instance))

    a = S.scaler.Autoscaler(cluster, coord_client_factory=client)
    jobs = {}
    out = []
    for tick in range(ticks):
        for m in arrivals.get(tick, ()):
            job = S.job(m)
            jobs[job.name] = job
            cluster.create_trainer_workload(job)
            a.on_add(job)
        plan = a.run_once()
        workloads = cluster.trainer_workloads_map()
        out.append({
            "plan": None if plan is None else S.obs(
                {"targets": plan.targets, "diff": plan.diff, "have_pending": plan.have_pending,
                 "pending": dataclasses.asdict(plan.pending),
                 "decisions": [(d["job"], d["dry_run"], d["actuated"], d["reason"])
                               for d in plan.decisions or []]}),
            "parallelism": {n: workloads[n].parallelism for n in sorted(workloads)},
            "pods": S.obs(sorted((p.name, p.phase, p.node) for p in kube.list_pods())),
            "coord": {n: (c.target_world(), c.prewarm_hint()) for n, c in sorted(coords.items())},
        })
    return out


SEQUENCES = {
    # grow on an idle cluster, a second job arrives pending, the first
    # sheds for it (the phase-10 story at TPU scale)
    "grow_then_shed_for_pending": (
        [dict(name=f"pool-{i}", cpu=8000, mem=32768, chips=4, label="2x2") for i in range(2)],
        {0: [_manifest("lm", 1, 2, "v5e-4")], 2: [_manifest("lm-b", 1, 1, "v5e-4")]}, 5),
    "three_jobs_split_chips": (
        [dict(name=f"pool-{i}", cpu=16000, mem=65536, chips=8) for i in range(4)],
        {0: [_manifest("a", 1, 8, "v5e-4", gbs=32), _manifest("b", 1, 4, "v5e-8")],
         1: [_manifest("c", 2, 2, "v5e-4")]}, 4),
    "multi_host_replicas": (
        [dict(name=f"host-{i}", cpu=16000, mem=65536, chips=8, label="4x4", pool=f"slice-{i // 2}")
         for i in range(6)],
        {0: [_manifest("mh", 1, 3, "v5e-16", cpu="2")], 1: [_manifest("mh2", 1, 2, "v5e-16")]}, 4),
    "cpu_bound": (
        [dict(name="cpu-0", cpu=4000, mem=8192, chips=0)],
        {0: [_manifest("c1", 1, 4, "cpu", cpu="1")], 1: [_manifest("c2", 2, 2, "cpu", cpu="1")]},
        4),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
@pytest.mark.parametrize("victim", ["newest", "oldest"])
def test_run_once_on_fake_kube_plans_like_the_jax_package(name, victim):
    nodes, arrivals, ticks = SEQUENCES[name]
    got = _autoscaler_sequence(Side(jax=False), nodes, arrivals, ticks, victim)
    assert got == _autoscaler_sequence(Side(jax=True), nodes, arrivals, ticks, victim)
    assert any(t["plan"] and t["plan"]["targets"] for t in got)


def test_random_fake_kube_sequences_plan_like_the_jax_package():
    rng = np.random.default_rng(7)
    topos = ["v5e-1", "v5e-4", "v5e-8"]
    for _ in range(12):
        nodes = [dict(name=f"n{i}", cpu=int(rng.choice([4000, 16000])), mem=32768,
                      chips=int(rng.choice([1, 4, 8])))
                 for i in range(int(rng.integers(1, 6)))]
        arrivals = {}
        for k in range(int(rng.integers(1, 5))):
            mn = int(rng.integers(1, 3))
            arrivals.setdefault(int(rng.integers(0, 3)), []).append(
                _manifest(f"j{k}", mn, mn + int(rng.integers(0, 4)), str(rng.choice(topos)),
                          cpu=str(rng.choice(["500m", "1", "2"]))))
        got = _autoscaler_sequence(Side(jax=False), nodes, arrivals, 4)
        assert got == _autoscaler_sequence(Side(jax=True), nodes, arrivals, 4)


# ---- the actuation half ---------------------------------------------------------


def test_victim_deletion_waits_for_the_world_ack():
    """As the JAX ``test_autoscaler_victim_deletion_waits_for_world_ack``:
    deletion waits (bounded) until every member of the retargeted plan
    acked the new generation; coordinators with no live trainers, and
    those without the signal, are not waited on."""
    asc = scaler.Autoscaler.__new__(scaler.Autoscaler)
    asc.victim_drain_timeout = 5.0
    coord = port_coord.LocalCoordinator(target_world=2, max_world=2)
    coord.register("a")
    coord.register("b")
    gen = coord.plan().generation
    coord.ack_generation("a", gen)
    coord.ack_generation("b", gen)
    coord.set_target_world(1)
    new_gen = coord.plan().generation
    t = threading.Timer(0.4, lambda: coord.ack_generation("a", new_gen))
    t.start()
    t0 = time.monotonic()
    try:
        asc._wait_for_quiesce(coord)
    finally:
        t.cancel()
    assert 0.3 <= time.monotonic() - t0 < 5.0

    cold = port_coord.LocalCoordinator(target_world=2, max_world=2)
    cold.register("x")
    cold.set_target_world(1)
    t0 = time.monotonic()
    asc._wait_for_quiesce(cold)

    class Legacy:
        def metrics(self):
            return {"generation": 1}

    asc._wait_for_quiesce(Legacy())
    assert time.monotonic() - t0 < 0.3
    assert scaler.wait_for_world_ack(coord, 0.1) is True


def test_actuation_order_prewarm_retarget_victims_put():
    """Prewarm before anything; scale-down retargets, waits, deletes the
    dropped members' pods, then PUTs; scale-up PUTs, then retargets."""
    log = []

    class RecCluster:
        def update_parallelism(self, job, n):
            log.append(("put", n))

        def delete_pod(self, name):
            log.append(("delete", name))
            return True

    coord = port_coord.LocalCoordinator(target_world=4, max_world=8)
    for m in ("p0", "p1", "p2", "p3"):
        coord.register(m)

    class Client:
        def set_prewarm(self, w, trace_id=""):
            log.append(("prewarm", w))
            coord.set_prewarm(w, trace_id=trace_id)

        def set_target_world(self, w, trace_id=""):
            log.append(("target", w))
            coord.set_target_world(w, trace_id=trace_id)

        def plan(self):
            return coord.plan()

        def members(self):
            return coord.members()

        def metrics(self):
            return coord.metrics()

    job = tj.TrainingJob.from_manifest(tpu_to_gpu(_manifest("j", 2, 8, "v5e-1"))).validate()
    sc = scaler.Autoscaler(RecCluster(), coord_client_factory=lambda j: Client())
    sc.jobs = {job.name: job}
    sc._actuate({job.name: 6}, {job.name: 2})
    assert log == [("prewarm", 6), ("put", 6), ("target", 6)]
    log.clear()
    sc._actuate({job.name: 2}, {job.name: -4})
    assert log == [("prewarm", 2), ("target", 2), ("delete", "p2"), ("delete", "p3"),
                   ("put", 2)]
