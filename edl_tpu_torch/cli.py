"""L5 CLI (counterpart of ``edl_tpu/cli.py``): submit / list / kill /
manifests / crd / deploy / local-run / local-sim / controller / fleet /
ingest / metrics / trace.

The reference had no CLI of its own — users went through the external
``paddlecloud`` client/server, which also created the k8s objects
(``pkg/resource/training_job.go:39-58``, ``pkg/controller.go:115-118``).
This CLI subsumes that role:

- ``submit``      validate a TrainingJob YAML and apply the CR (kubectl)
- ``manifests``   print the rendered trainer/coordinator manifests
- ``crd``         print the TrainingJob CustomResourceDefinition
- ``deploy``      print/apply the control-plane install
- ``list``        list TrainingJobs (kubectl)
- ``kill``        delete a TrainingJob (kubectl)
- ``local-run``   train the job's model in this process on one device
                  (the card unless ``--device cpu``) -> loss summary
- ``local-sim``   controller + autoscaler closed loop against an
                  in-memory fake cluster of GPU nodes (no k8s needed)
- ``controller``  the control-plane daemon against a cluster
- ``fleet``       one table over every GPU-market bidder's coordinator
- ``serve``       a checkpoint-backed serving replica (the card unless
                  ``--device cpu``), registered with a serving
                  coordinator when given one
- ``route``       a request router's live routing table

- ``ingest``      stage a real corpus (MNIST IDX files, a token file)
                  into a file-backed array store for ``--data-dir``
- ``metrics``     a running job's merged metrics and recent flight
                  events from its coordinator (``--prom``, ``--json``)
- ``trace``       merge the coordinator's and the members' flight
                  journals into one clock-aligned Chrome trace

Run it as ``python -m edl_tpu_torch.cli``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import List, Optional

from edl_tpu_torch.resource.training_job import TrainingJob, crd_manifest


def _load_job(path: str) -> TrainingJob:
    with open(path) as f:
        text = f.read()
    return TrainingJob.from_yaml(text).validate()


def _dump_yaml(objs) -> str:
    import yaml

    if isinstance(objs, dict):
        objs = [objs]
    return "---\n".join(yaml.safe_dump(o, sort_keys=False) for o in objs)


def _kubectl(
    argv: List[str], input: Optional[str] = None, kubectl: str = "kubectl"
) -> int:
    p = subprocess.run(
        [kubectl, *argv], input=input, text=True, capture_output=True
    )
    sys.stdout.write(p.stdout)
    sys.stderr.write(p.stderr)
    return p.returncode


def cmd_submit(args) -> int:
    job = _load_job(args.spec)
    manifest = job.to_manifest()
    if args.dry_run:
        print(_dump_yaml(manifest))
        return 0
    return _kubectl(
        ["apply", "-f", "-"],
        input=json.dumps(manifest),
        kubectl=args.kubectl,
    )


def cmd_manifests(args) -> int:
    from edl_tpu_torch.controller.jobparser import (
        parse_to_coordinator,
        parse_to_serving_manifests,
        parse_to_trainer_manifests,
    )

    job = _load_job(args.spec)
    objs = (
        parse_to_trainer_manifests(job)
        + parse_to_coordinator(job)
        + parse_to_serving_manifests(job)
    )
    print(_dump_yaml(objs))
    return 0


def cmd_crd(args) -> int:
    print(_dump_yaml(crd_manifest()))
    return 0


def cmd_deploy(args) -> int:
    """Print (or apply) the full control-plane install: namespace, CRD,
    RBAC, controller Deployment — `kubectl apply -f <(edl deploy)`."""
    from edl_tpu_torch.controller.deploy import deploy_manifests
    from edl_tpu_torch.resource.training_job import DEFAULT_IMAGE

    objs = deploy_manifests(image=args.image or DEFAULT_IMAGE)
    if args.apply:
        return _kubectl(
            ["apply", "-f", "-"],
            input=json.dumps(
                {"apiVersion": "v1", "kind": "List", "items": objs}
            ),
            kubectl=args.kubectl,
        )
    print(_dump_yaml(objs))
    return 0


def cmd_list(args) -> int:
    return _kubectl(["get", "trainingjobs", "-A"], kubectl=args.kubectl)


def cmd_kill(args) -> int:
    return _kubectl(["delete", "trainingjob", args.name], kubectl=args.kubectl)


def cmd_local_run(args) -> int:
    """One process, one device: train the job's model through the
    launcher's elastic loop (``launcher.run`` with an in-process
    coordinator, world 1) with the spec's global batch, checkpoint
    interval and checkpoint directory, and print the loss summary.
    The JAX CLI's ``--resize-at`` resizes across virtual devices in one
    process; the port's worlds of several members are processes
    (``python -m edl_tpu_torch.launcher`` behind a coordinator).

    The model is the spec's entrypoint (``mnist`` when it names none,
    as in the JAX CLI): a registered family, or user code from
    ``trainer.workspace``."""
    from edl_tpu_torch import launcher

    job = _load_job(args.spec)
    et = launcher.run(
        entrypoint=job.spec.trainer.entrypoint or "mnist",
        workspace=job.spec.trainer.workspace,
        steps=args.steps,
        global_batch_size=job.spec.global_batch_size,
        checkpoint_interval=job.spec.checkpoint_interval_steps,
        seed=args.seed,
        data_dir=args.data_dir or job.spec.dataset_dir,
        checkpoint_dir=args.checkpoint_dir or job.spec.checkpoint_dir,
        device=args.device,
        model_kwargs={"tiny": True} if args.tiny else None,
    )
    first = et.history[0] if et.history else None
    last = et.history[-1] if et.history else None
    summary = {
        "job": job.name,
        "model": et.model.name,
        "steps": len(et.history),
        "first_loss": round(first.loss, 4) if first else None,
        "final_loss": round(last.loss, 4) if last else None,
        "resizes": [
            {
                "generation": e.generation,
                "world_size": e.world_size,
                "seconds": round(e.seconds, 4),
                "graceful": e.graceful,
            }
            for e in et.resize_events
        ],
        "world_sizes_seen": sorted({r.world_size for r in et.history}),
    }
    print(json.dumps(summary, indent=2))
    return 0


def cmd_ingest(args) -> int:
    """Stage a real corpus into a file-backed array store
    (``edl_tpu_torch.runtime.datasets``): ``ingest mnist`` for IDX
    image/label pairs, ``ingest tokens`` for tokenized text.  The
    directory plugs into ``spec.dataset_dir`` / ``local-run
    --data-dir``; prints its manifest."""
    import os

    from edl_tpu_torch.runtime.datasets import MANIFEST, ingest_mnist_idx, ingest_tokens

    if args.format == "mnist":
        if not (args.images and args.labels):
            print("error: ingest mnist needs --images and --labels", file=sys.stderr)
            return 2
        path = ingest_mnist_idx(args.out, args.images, args.labels)
    else:
        if not args.tokens:
            print("error: ingest tokens needs --tokens", file=sys.stderr)
            return 2
        path = ingest_tokens(args.out, args.tokens, seq_len=args.seq_len)
    with open(os.path.join(path, MANIFEST)) as f:
        print(f.read())
    return 0


def cmd_controller(args) -> int:
    """Run the control plane against a real cluster: watch TrainingJob
    CRs and reconcile/autoscale forever — the reference's whole
    deliverable (``cmd/edl/edl.go:47-50``: two goroutines, watch +
    autoscaler loop), plus the creation wiring its TODO promised."""
    import time

    from edl_tpu_torch.autoscaler.scaler import Autoscaler
    from edl_tpu_torch.cluster.cluster import Cluster
    from edl_tpu_torch.cluster.kube import KubectlAPI
    from edl_tpu_torch.controller.controller import Controller
    from edl_tpu_torch.controller.watch import TrainingJobWatcher

    kube = KubectlAPI(namespace=args.namespace, kubectl=args.kubectl)
    cluster = Cluster(kube)
    ctrl = Controller(cluster, Autoscaler(cluster, max_load_desired=args.max_load))
    watcher = TrainingJobWatcher(kube.list_training_jobs, ctrl)

    n = 0
    while True:
        # apart: a failing watch must not stop the reconcile of the
        # jobs already known, nor the reverse
        for step in (watcher.poll_once, ctrl.run_once):
            try:
                step()
            except Exception:
                import traceback

                traceback.print_exc()
        n += 1
        if args.iterations and n >= args.iterations:
            break
        time.sleep(args.interval)
    if args.iterations:
        print(
            json.dumps(
                {"jobs": ctrl.job_statuses(), "cluster": ctrl.cluster_metrics()},
                indent=2,
            )
        )
    return 0


def cmd_local_sim(args) -> int:
    """Controller + autoscaler closed loop against FakeKube: shows the
    scheduling/scaling story without k8s or devices."""
    from edl_tpu_torch.autoscaler.scaler import Autoscaler
    from edl_tpu_torch.cluster.cluster import Cluster
    from edl_tpu_torch.cluster.kube import FakeKube, NodeInfo
    from edl_tpu_torch.controller.controller import Controller

    jobs = [_load_job(p) for p in args.spec]
    kube = FakeKube(
        [
            NodeInfo(
                name=f"pool-{i}",
                cpu_milli=args.node_cpu_milli,
                memory_mega=args.node_memory_mega,
                gpus=args.node_gpus,
            )
            for i in range(args.nodes)
        ]
    )
    cluster = Cluster(kube)
    ctrl = Controller(cluster, Autoscaler(cluster, max_load_desired=args.max_load))
    for job in jobs:
        ctrl.on_add(job)
    for i in range(args.iterations):
        ctrl.run_once()
        kube.retry_scheduling()
    ctrl.reconcile_status()
    print(
        json.dumps(
            {"jobs": ctrl.job_statuses(), "cluster": ctrl.cluster_metrics()},
            indent=2,
        )
    )
    return 0


def _parse_fleet_member(spec: str):
    """``name=url[,chips=N][,priority=P]`` -> (name, url, chips, prio)."""
    name, sep, rest = spec.partition("=")
    if not sep:
        raise ValueError(f"--job/--serve wants name=url[,k=v], got {spec!r}")
    parts = rest.split(",")
    url = parts[0]
    chips, priority = 1, 0
    for kv in parts[1:]:
        k, _, v = kv.partition("=")
        if k == "chips":
            chips = int(v)
        elif k == "priority":
            priority = int(v)
        else:
            raise ValueError(f"unknown fleet member option {k!r}")
    return name, url, chips, priority


def cmd_metrics(args) -> int:
    """Pretty-print a running job's merged metrics and recent
    flight-recorder events from its coordinator (`edl metrics
    <host:port>`).  ``--prom`` dumps the raw Prometheus exposition
    (what a scraper sees); ``--json`` dumps the merged telemetry
    document."""
    from edl_tpu_torch.runtime.coord_service import HTTPCoordinator

    client = HTTPCoordinator(args.url, timeout=args.timeout)
    if args.prom:
        print(client.metrics_text(), end="")
        return 0
    snap = client.metrics()
    tel = {}
    try:
        tel = client.telemetry()
    except Exception:
        pass  # pre-telemetry coordinator: snapshot alone still prints
    if args.json:
        print(json.dumps({"coordinator": snap, "telemetry": tel}, indent=2))
        return 0

    print("coordinator")
    for k in sorted(snap):
        print(f"  {k:<24} {snap[k]}")
    merged = tel.get("merged") or {}
    rate = tel.get("step_rate")
    cost = tel.get("resize_cost_seconds")
    print("goodput")
    print(f"  {'observed_step_rate':<24} "
          f"{f'{rate:.3f} steps/s' if rate is not None else 'n/a'}")
    print(f"  {'resize_cost_seconds':<24} "
          f"{f'{cost:.3f}' if cost is not None else 'n/a'}")
    hists_all = merged.get("histograms") or {}
    gauges_all = merged.get("gauges") or {}
    counters_all = merged.get("counters") or {}
    if any(
        name.startswith("edl_serve_")
        for section in (hists_all, gauges_all, counters_all)
        for name in section
    ):
        # Serving fleet summary: the request-side signals the serving
        # lane scales on, pre-digested (p50/p95 from the merged
        # latency histogram, occupancy mean, requests by status).
        from edl_tpu_torch.telemetry.aggregate import histogram_quantile

        print("serving")
        lat = hists_all.get("edl_serve_latency_seconds")
        for q, tag in ((0.5, "latency_p50"), (0.95, "latency_p95")):
            v = histogram_quantile(lat, q) if lat else None
            print(
                f"  {tag:<24} "
                f"{f'{v * 1000:.1f} ms' if v is not None else 'n/a'}"
            )
        occ = hists_all.get("edl_serve_batch_occupancy") or {}
        tot = sum(h["count"] for h in occ.values())
        if tot:
            mean = sum(h["sum"] for h in occ.values()) / tot
            print(f"  {'batch_occupancy_mean':<24} {mean:.3f}")
        depth = gauges_all.get("edl_serve_queue_depth") or {}
        if depth:
            print(f"  {'queue_depth_max':<24} {max(depth.values()):g}")
        wstep = gauges_all.get("edl_serve_weights_step") or {}
        if wstep:
            print(f"  {'weights_step':<24} {max(wstep.values()):g}")
        # the bytes one card holds for the KV pool, and of it in use
        for gname, tag in (
            ("edl_serve_kv_pool_bytes_per_device", "kv_pool_bytes/dev"),
            ("edl_serve_kv_used_bytes_per_device", "kv_used_bytes/dev"),
        ):
            g = gauges_all.get(gname) or {}
            if g:
                print(f"  {tag:<24} {max(g.values()):g}")
        # Per-replica drain posture: which replicas are
        # serving / draining / drained, plus the drain counters — the
        # operator view of a rolling scale-down.
        drg = gauges_all.get("edl_serve_draining") or {}
        _DRAIN_STATES = {0: "serving", 1: "draining", 2: "drained"}
        for key in sorted(drg):
            state = _DRAIN_STATES.get(int(drg[key]), "?")
            print(f"  drain{{{key}}}{'':<8} {state}")
        drains = counters_all.get("edl_serve_drains_total") or {}
        if drains:
            print(
                f"  {'drains_total':<24} {sum(drains.values()):g}"
            )
        dsec = hists_all.get("edl_serve_drain_seconds") or {}
        dcount = sum(h["count"] for h in dsec.values())
        if dcount:
            dsum = sum(h["sum"] for h in dsec.values())
            print(
                f"  {'drain_seconds_mean':<24} "
                f"{dsum / dcount:.3f}"
            )
        # Live KV migration counters: sequences drains
        # handed to survivors instead of waiting out, the KV bytes
        # that moved, and the re-prefill fallbacks the ladder took.
        mig = counters_all.get("edl_serve_migrations_total") or {}
        if mig:
            print(f"  {'migrations_total':<24} {sum(mig.values()):g}")
            fb = sum(
                v for k, v in mig.items() if "outcome=fallback" in k
            )
            print(f"  {'migrate_fallbacks':<24} {fb:g}")
            mb = counters_all.get(
                "edl_serve_migrations_bytes_total"
            ) or {}
            if mb:
                print(
                    f"  {'migrated_kv_bytes':<24} {sum(mb.values()):g}"
                )
            msec = hists_all.get("edl_serve_migrate_seconds")
            m95 = histogram_quantile(msec, 0.95) if msec else None
            print(
                f"  {'migrate_p95':<24} "
                f"{f'{m95 * 1000:.1f} ms' if m95 is not None else 'n/a'}"
            )
        tok = counters_all.get("edl_serve_tokens_total") or {}
        if tok:
            # Decode stats (the token-iteration path): tokens/s is the
            # decode-iteration cadence the fleet sustained — emitted
            # tokens over the seconds the inter-token histogram
            # accumulated (its count/sum), aggregated across replicas.
            it_h = hists_all.get("edl_serve_intertoken_seconds") or {}
            it_count = sum(h["count"] for h in it_h.values())
            it_sum = sum(h["sum"] for h in it_h.values())
            print(f"  {'tokens_total':<24} {sum(tok.values()):g}")
            if it_sum > 0:
                print(
                    f"  {'decode_tokens_per_s':<24} "
                    f"{it_count / it_sum:.1f}"
                )
            ttft = hists_all.get("edl_serve_ttft_seconds")
            for q, tag in ((0.5, "ttft_p50"), (0.95, "ttft_p95")):
                v = histogram_quantile(ttft, q) if ttft else None
                print(
                    f"  {tag:<24} "
                    f"{f'{v * 1000:.1f} ms' if v is not None else 'n/a'}"
                )
            it95 = (
                histogram_quantile(
                    hists_all.get("edl_serve_intertoken_seconds"), 0.95
                )
                if it_h
                else None
            )
            print(
                f"  {'intertoken_p95':<24} "
                f"{f'{it95 * 1000:.2f} ms' if it95 is not None else 'n/a'}"
            )
            kv = gauges_all.get("edl_serve_kv_occupancy") or {}
            if kv:
                print(
                    f"  {'kv_slot_occupancy':<24} {max(kv.values()):.3f}"
                )
            # Chunked-prefill stats: admission pressure and
            # the stall it imposed on the running decode batch.
            chunks = counters_all.get(
                "edl_serve_prefill_chunks_total"
            ) or {}
            if chunks:
                print(
                    f"  {'prefill_chunks_total':<24} "
                    f"{sum(chunks.values()):g}"
                )
                ptok = counters_all.get(
                    "edl_serve_prefill_tokens_total"
                ) or {}
                if ptok:
                    print(
                        f"  {'prefill_tokens_total':<24} "
                        f"{sum(ptok.values()):g}"
                    )
            pq = gauges_all.get("edl_serve_prefill_queued_tokens") or {}
            if pq:
                print(
                    f"  {'queued_prefill_tokens':<24} "
                    f"{max(pq.values()):g}"
                )
            stall = hists_all.get("edl_serve_prefill_stall_seconds")
            if stall:
                s95 = histogram_quantile(stall, 0.95)
                print(
                    f"  {'prefill_stall_p95':<24} "
                    f"{f'{s95 * 1000:.2f} ms' if s95 is not None else 'n/a'}"
                )
        # Prefix-cache stats: shared-prefix admission reuse
        # — how often warm admissions skipped to the first cold block,
        # and what the retention cost under pressure.
        phits = counters_all.get("edl_serve_prefix_hits_total") or {}
        if phits:
            pmiss = (
                counters_all.get("edl_serve_prefix_misses_total") or {}
            )
            print(f"  {'prefix_hits':<24} {sum(phits.values()):g}")
            print(f"  {'prefix_misses':<24} {sum(pmiss.values()):g}")
            ratio = gauges_all.get("edl_serve_prefix_hit_ratio") or {}
            if ratio:
                print(
                    f"  {'prefix_hit_ratio':<24} "
                    f"{max(ratio.values()):.3f}"
                )
            reused = (
                counters_all.get("edl_serve_prefix_blocks_reused_total")
                or {}
            )
            print(
                f"  {'prefix_blocks_reused':<24} "
                f"{sum(reused.values()):g}"
            )
            pev = (
                counters_all.get("edl_serve_prefix_evictions_total")
                or {}
            )
            print(f"  {'prefix_evictions':<24} {sum(pev.values()):g}")
        req = counters_all.get("edl_serve_requests_total") or {}
        for key in sorted(req):
            print(f"  requests{{{key}}}{'':<10} {req[key]:g}")
    if any(
        name.startswith("edl_route_")
        for section in (gauges_all, counters_all)
        for name in section
    ):
        # Front-door summary: the fault-masking the router
        # did on the fleet's behalf — backends by health state, request
        # outcomes, steers off draining replicas, per-attempt failures
        # absorbed, the eject/readmit ledger, and stream re-drives.
        print("router")
        backends = gauges_all.get("edl_route_backends") or {}
        for key in sorted(backends):
            print(f"  backends{{{key}}}{'':<8} {backends[key]:g}")
        rreq = counters_all.get("edl_route_requests_total") or {}
        for key in sorted(rreq):
            print(f"  requests{{{key}}}{'':<8} {rreq[key]:g}")
        rsteer = counters_all.get("edl_route_steers_total") or {}
        if rsteer:
            print(f"  {'steers_total':<24} {sum(rsteer.values()):g}")
        rretry = counters_all.get("edl_route_retries_total") or {}
        if rretry:
            print(
                f"  {'retries_absorbed':<24} {sum(rretry.values()):g}"
            )
            for key in sorted(rretry):
                print(f"  retries{{{key}}}{'':<9} {rretry[key]:g}")
        for cname, tag in (
            ("edl_route_ejections_total", "ejections_total"),
            ("edl_route_readmits_total", "readmits_total"),
        ):
            c = counters_all.get(cname) or {}
            if c:
                print(f"  {tag:<24} {sum(c.values()):g}")
        rdrv = counters_all.get("edl_route_redrives_total") or {}
        for key in sorted(rdrv):
            print(f"  redrives{{{key}}}{'':<8} {rdrv[key]:g}")
        raff = counters_all.get("edl_route_affinity_total") or {}
        for key in sorted(raff):
            print(f"  affinity{{{key}}}{'':<8} {raff[key]:g}")
    counters = counters_all
    if counters:
        print("counters (merged across trainers)")
        for name in sorted(counters):
            for key in sorted(counters[name]):
                label = f"{{{key}}}" if key else ""
                print(f"  {name}{label:<32} {counters[name][key]:g}")
    hists = merged.get("histograms") or {}
    if hists:
        print("histograms (merged: count / mean)")
        for name in sorted(hists):
            for key in sorted(hists[name]):
                h = hists[name][key]
                mean = h["sum"] / h["count"] if h["count"] else 0.0
                label = f"{{{key}}}" if key else ""
                print(
                    f"  {name}{label:<32} {h['count']} / {mean:.6f}"
                )
    events = (tel.get("events") or [])[-args.events:]
    if events:
        print(f"flight recorder (last {len(events)} events)")
        for ev in events:
            data = json.dumps(ev.get("data") or {}, sort_keys=True)
            print(
                f"  step={ev.get('step'):<7} gen={ev.get('generation'):<4} "
                f"{ev.get('kind'):<20} {data}"
            )
    return 0


def cmd_route(args) -> int:
    """Print a router's live routing table (``edl route <host:port>``):
    every backend it knows, its health (healthy / draining / ejected),
    the load score admissions are spread by and the vitals behind it;
    ``--json`` prints the raw ``/routes`` table."""
    import urllib.request

    addr = args.url if "//" in args.url else f"http://{args.url}"
    with urllib.request.urlopen(f"{addr}/routes", timeout=args.timeout) as resp:
        table = json.loads(resp.read())
    if args.json:
        print(json.dumps(table, indent=2))
        return 0
    print("router")
    print(f"  {'plan_generation':<24} {table.get('plan_generation')}")
    p95 = table.get("ttft_p95_s")
    print(f"  {'fleet_ttft_p95':<24} {f'{p95 * 1000:.1f} ms' if p95 is not None else 'n/a'}")
    print(f"  {'affinity_entries':<24} {table.get('affinity_entries', 0)}")
    replicas = table.get("replicas") or []
    if not replicas:
        print("  (no backends)")
        return 0
    print(f"  {'replica':<12} {'address':<22} {'health':<9} "
          f"{'score':>7} {'queue':>6} {'kv':>6} {'fails':>6} gen")
    for r in sorted(replicas, key=lambda x: x.get("score") or 0.0):
        kv = r.get("kv_occupancy") or 0.0
        print(
            f"  {r.get('replica', '?'):<12} "
            f"{r.get('address', '?'):<22} "
            f"{r.get('health', '?'):<9} "
            f"{r.get('score', 0.0):>7.2f} "
            f"{r.get('queue_depth', 0):>6g} "
            f"{kv:>6.2f} "
            f"{r.get('consecutive_failures', 0):>6g} "
            f"{'yes' if r.get('can_generate') else 'no'}"
        )
    return 0


def cmd_serve(args) -> int:
    """Run a serving replica (``edl serve --spec job.yaml`` or ``edl
    serve --entrypoint moe_lm --checkpoint-dir d/``): load the newest
    verified checkpoint, open the HTTP front (/predict, /generate,
    /healthz, /metrics) and, given a serving coordinator, register into
    the serving world the autoscaler's serving lane scales
    (``serving.server.serve_run``).  Prints one JSON line (replica,
    model, port, weights step), then serves until killed or for
    ``--duration`` seconds.  The spec's ``serving`` section gives the
    port, batch, queue and deadline the flags leave at 0; ``--port 0``
    and no spec is ``EDL_SERVE_PORT`` (7180)."""
    entrypoint = args.entrypoint
    checkpoint_dir = args.checkpoint_dir
    port, max_batch, queue_limit, deadline_ms = args.port, args.max_batch, 0, args.deadline_ms
    if args.spec:
        job = _load_job(args.spec)
        entrypoint = entrypoint or job.spec.trainer.entrypoint
        checkpoint_dir = checkpoint_dir or job.spec.checkpoint_dir
        sv = job.spec.serving
        if sv is not None:
            port = port or sv.port
            max_batch = max_batch or sv.max_batch
            queue_limit = sv.queue_limit
            deadline_ms = deadline_ms or sv.deadline_ms
    from edl_tpu_torch.serving import serve_run

    replica = serve_run(
        entrypoint=entrypoint,
        coordinator_addr=args.coordinator,
        checkpoint_dir=checkpoint_dir,
        port=port,
        max_batch=max_batch,
        queue_limit=queue_limit,
        deadline_ms=deadline_ms,
        device=args.device,
        **({"tiny": True} if args.tiny else {}),
    )
    engine = replica.engine
    print(json.dumps({
        "replica": replica.replica_id,
        "model": engine.model.name,
        "port": replica.server.port if replica.server else None,
        "weights_step": engine.weights_step,
    }), flush=True)
    try:
        if args.duration > 0:
            import time

            time.sleep(args.duration)
        else:
            import threading

            threading.Event().wait()  # serve until killed
    except KeyboardInterrupt:
        pass
    finally:
        replica.stop()
    return 0


def cmd_trace(args) -> int:
    """Merge the cluster's flight-recorder journals into ONE causally
    ordered Chrome-trace/Perfetto timeline (`edl trace <host:port>`):
    the coordinator's journal (which already holds every member's
    reported event tail, origin-tagged) is fetched over `/telemetry`,
    member lanes are clock-aligned with the NTP-style offsets the
    members estimated from their heartbeats, and the result is written
    as JSON for ui.perfetto.dev / chrome://tracing — pid = member,
    tid = subsystem, duration slices for resizes (with per-phase child
    slices), instants for votes/quiesce/saves/decisions.

    ``--journal name=path`` merges on-disk JSONL spills
    (EDL_FLIGHT_RECORDER_FILE) instead of / in addition to the live
    coordinator — the post-mortem path.  ``--trace-id`` filters to one
    causal chain; ``--summary`` prints the goodput decomposition and
    the trace chains instead of only writing the file."""
    from edl_tpu_torch.telemetry import trace as tracing

    streams = {}
    offsets = {}
    goodput = None
    if args.url:
        from edl_tpu_torch.runtime.coord_service import HTTPCoordinator

        client = HTTPCoordinator(args.url, timeout=args.timeout)
        tel = client.telemetry()
        streams.update(tracing.member_streams(tel.get("events") or []))
        offsets = {
            m: o
            for m, o in (tel.get("clock_offsets") or {}).items()
            if o is not None
        }
        goodput = tel.get("goodput")
    for spec in args.journal or []:
        name, sep, path = spec.partition("=")
        if not sep:
            import os

            name, path = os.path.basename(spec), spec
        streams[name] = tracing.load_journal(path)
    if not streams:
        print(
            "error: nothing to merge (give a coordinator URL and/or "
            "--journal name=events.jsonl)",
            file=sys.stderr,
        )
        return 2
    merged = tracing.merge_events(streams, offsets)
    if args.summary:
        print(f"events merged: {len(merged)} from {len(streams)} lane(s)")
        if offsets:
            for m in sorted(offsets):
                print(f"  clock offset {m:<20} {offsets[m]:+.6f}s")
        print("goodput")
        if goodput:
            print(f"  {'frac':<24} {goodput['frac']:.4f}")
            print(f"  {'total_s':<24} {goodput['total_s']:.3f}")
            for state in sorted(goodput.get("seconds") or {}):
                print(
                    f"  {state:<24} {goodput['seconds'][state]:.3f}s"
                )
        else:
            print("  n/a (no goodput ledger reported)")
        chains = tracing.trace_chains(merged)
        if chains:
            print(f"causal chains ({len(chains)})")
            for tid_, evs in sorted(
                chains.items(), key=lambda kv: kv[1][0]["wall_aligned"]
            ):
                kinds = [e.get("kind") for e in evs]
                members = sorted({e["member"] for e in evs})
                print(
                    f"  {tid_}  {len(evs)} events over "
                    f"{','.join(members)}: {' -> '.join(kinds[:10])}"
                    + (" ..." if len(kinds) > 10 else "")
                )
    doc = tracing.chrome_trace(merged, trace_id=args.trace_id)
    out = args.out
    with open(out, "w") as f:
        json.dump(doc, f)
    print(
        f"merged trace: {out} "
        f"({len(doc['traceEvents'])} trace events; open at "
        "ui.perfetto.dev or chrome://tracing)"
    )
    return 0


def cmd_fleet(args) -> int:
    """Cluster-wide fleet status (`fleet --job lo=host:port,chips=4
    --serve api=host:port`): one table over every bidder's coordinator
    — world/target, chips (GPUs: the market keeps the JAX package's
    word), the training goodput signals the market's objective reads
    (goodput frac, step rate), and the serving SLO signals its hard
    constraints read (p95, queue depth) — plus the GPU totals.  The same
    reads the arbiter's bidders make each tick, so what this prints IS
    the market's next input."""
    from edl_tpu_torch.runtime.coord_service import HTTPCoordinator
    from edl_tpu_torch.telemetry.aggregate import histogram_quantile

    rows = []
    for kind, specs in (("training", args.job), ("serving", args.serve)):
        for spec in specs or []:
            name, url, chips, priority = _parse_fleet_member(spec)
            row = {
                "job": name,
                "kind": kind,
                "priority": priority,
                "chips_per_unit": chips,
                "url": url,
            }
            client = HTTPCoordinator(url, timeout=args.timeout)
            try:
                snap = client.metrics() or {}
            except Exception as e:
                row["error"] = f"unreachable: {e}"
                rows.append(row)
                continue
            row["world"] = snap.get("world_size")
            row["target"] = snap.get("target_world")
            # Same fallback the market's bidders read (TrainingBidder.
            # collect / ServingLane.current_replicas): target first,
            # live world while a retarget hasn't landed — the table
            # must show the market's actual next input.
            units = int(
                snap.get("target_world") or snap.get("world_size") or 0
            )
            row["chips"] = units * chips
            try:
                tel = client.telemetry() or {}
            except Exception:
                tel = {}
            goodput = tel.get("goodput") or {}
            row["goodput_frac"] = goodput.get("frac")
            row["step_rate"] = tel.get("step_rate")
            hists = (tel.get("merged") or {}).get("histograms") or {}
            gauges = (tel.get("merged") or {}).get("gauges") or {}
            lat = hists.get("edl_serve_latency_seconds")
            if lat:
                # histogram_quantile merges label-keyed series itself
                # (with the bucket-schema-skew guard)
                p95 = histogram_quantile(lat, 0.95)
                row["p95_ms"] = round(p95 * 1000, 2) if p95 else None
            depth = gauges.get("edl_serve_queue_depth") or {}
            if depth:
                row["queue_depth"] = max(depth.values())
            rows.append(row)
    if not rows:
        print(
            "error: no bidders (give --job name=url and/or "
            "--serve name=url)",
            file=sys.stderr,
        )
        return 2
    allocated = sum(r.get("chips") or 0 for r in rows)
    if args.json:
        print(
            json.dumps(
                {
                    "bidders": rows,
                    "chips_allocated": allocated,
                    "chips_total": args.chips or None,
                },
                indent=2,
            )
        )
        return 0

    def fmt(v, nd=3):
        if v is None:
            return "-"
        if isinstance(v, float):
            return f"{v:.{nd}f}"
        return str(v)

    print(
        f"{'JOB':<14} {'KIND':<9} {'PRI':>3} {'WORLD':>5} {'TARGET':>6} "
        f"{'CHIPS':>5} {'GOODPUT':>7} {'STEP/S':>7} {'P95_MS':>7} "
        f"{'QUEUE':>5}"
    )
    for r in rows:
        if "error" in r:
            print(f"{r['job']:<14} {r['kind']:<9} {r['error']}")
            continue
        print(
            f"{r['job']:<14} {r['kind']:<9} {r['priority']:>3} "
            f"{fmt(r.get('world')):>5} {fmt(r.get('target')):>6} "
            f"{fmt(r.get('chips')):>5} {fmt(r.get('goodput_frac')):>7} "
            f"{fmt(r.get('step_rate'), 2):>7} "
            f"{fmt(r.get('p95_ms'), 2):>7} {fmt(r.get('queue_depth')):>5}"
        )
    total = f" / {args.chips} total" if args.chips else ""
    print(f"chips allocated: {allocated}{total}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="edl", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("submit", help="validate + apply a TrainingJob")
    s.add_argument("spec")
    s.add_argument("--dry-run", action="store_true")
    s.add_argument("--kubectl", default="kubectl", help="kubectl binary")
    s.set_defaults(fn=cmd_submit)

    s = sub.add_parser("manifests", help="print rendered k8s manifests")
    s.add_argument("spec")
    s.set_defaults(fn=cmd_manifests)

    s = sub.add_parser("crd", help="print the TrainingJob CRD")
    s.set_defaults(fn=cmd_crd)

    s = sub.add_parser(
        "deploy", help="print/apply the control-plane install (CRD+RBAC+controller)"
    )
    s.add_argument("--image", default=None, help="controller image override")
    s.add_argument("--apply", action="store_true", help="kubectl apply it")
    s.add_argument("--kubectl", default="kubectl")
    s.set_defaults(fn=cmd_deploy)

    s = sub.add_parser("list", help="list TrainingJobs")
    s.add_argument("--kubectl", default="kubectl", help="kubectl binary")
    s.set_defaults(fn=cmd_list)

    s = sub.add_parser("kill", help="delete a TrainingJob")
    s.add_argument("name")
    s.add_argument("--kubectl", default="kubectl", help="kubectl binary")
    s.set_defaults(fn=cmd_kill)

    s = sub.add_parser("local-run", help="train the job's model on one device")
    s.add_argument("spec")
    s.add_argument("--steps", type=int, default=50)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--device", default=None, help="torch device (default: cuda)")
    s.add_argument("--tiny", action="store_true", help="the model's tiny configuration")
    s.add_argument(
        "--data-dir",
        default="",
        help=(
            "train from a file-backed array store (memory-mapped .npy "
            "directory, see edl_tpu_torch.runtime.datasets) instead of "
            "synthetic data; overrides spec.dataset_dir"
        ),
    )
    s.add_argument(
        "--checkpoint-dir",
        default="",
        help=(
            "durable checkpoint directory (spill + cold-start restore); "
            "overrides spec.checkpoint_dir"
        ),
    )
    s.set_defaults(fn=cmd_local_run)

    s = sub.add_parser(
        "ingest", help="stage a real corpus into a file-backed array store"
    )
    s.add_argument("format", choices=["mnist", "tokens"])
    s.add_argument("--out", required=True, help="array-store directory")
    s.add_argument("--images", default="", help="IDX image file (mnist)")
    s.add_argument("--labels", default="", help="IDX label file (mnist)")
    s.add_argument("--tokens", default="", help="token corpus (.npy/.u16/.u32)")
    s.add_argument(
        "--seq-len", type=int, default=2048, help="row length (tokens) - 1"
    )
    s.set_defaults(fn=cmd_ingest)

    s = sub.add_parser(
        "controller", help="run the control-plane daemon against a cluster"
    )
    s.add_argument("--namespace", default="default")
    s.add_argument("--kubectl", default="kubectl", help="kubectl binary")
    s.add_argument(
        "--interval", type=float, default=5.0, help="reconcile period (ref 5s tick)"
    )
    s.add_argument(
        "--iterations",
        type=int,
        default=0,
        help="stop after N reconcile loops and print statuses (0 = forever)",
    )
    s.add_argument("--max-load", type=float, default=0.97)
    s.set_defaults(fn=cmd_controller)

    s = sub.add_parser("local-sim", help="controller+autoscaler vs fake cluster")
    s.add_argument("spec", nargs="+")
    s.add_argument("--nodes", type=int, default=4)
    s.add_argument("--node-gpus", type=int, default=4)
    s.add_argument("--node-cpu-milli", type=int, default=8000)
    s.add_argument("--node-memory-mega", type=int, default=32768)
    s.add_argument("--max-load", type=float, default=0.97)
    s.add_argument("--iterations", type=int, default=6)
    s.set_defaults(fn=cmd_local_sim)

    s = sub.add_parser(
        "fleet",
        help="cluster-wide fleet status: every bidder's world/GPUs + "
        "the market's goodput/SLO input signals",
    )
    s.add_argument(
        "--job",
        action="append",
        metavar="NAME=URL[,chips=N][,priority=P]",
        help="a training job's coordinator (repeatable; chips = GPUs "
        "per trainer)",
    )
    s.add_argument(
        "--serve",
        action="append",
        metavar="NAME=URL[,chips=N]",
        help="a serving fleet's coordinator (repeatable)",
    )
    s.add_argument(
        "--chips", type=int, default=0,
        help="inventory total in GPUs (for the footer)",
    )
    s.add_argument("--json", action="store_true", help="dump raw JSON")
    s.add_argument("--timeout", type=float, default=5.0)
    s.set_defaults(fn=cmd_fleet)

    s = sub.add_parser(
        "route",
        help="print a router's live routing table (backends, health, load scores)",
    )
    s.add_argument("url", help="router address (host:port)")
    s.add_argument("--json", action="store_true", help="dump raw JSON")
    s.add_argument("--timeout", type=float, default=5.0)
    s.set_defaults(fn=cmd_route)

    s = sub.add_parser(
        "serve",
        help="run a serving replica (checkpoint-backed, continuous-batched, "
        "hot-swapping)",
    )
    s.add_argument("--spec", default="", help="TrainingJob YAML (serving "
                   "defaults come from its spec.serving section)")
    s.add_argument("--entrypoint", default="", help="registered model name")
    s.add_argument("--coordinator", default="", help="serving-world coordinator address")
    s.add_argument(
        "--checkpoint-dir", default="",
        help="durable checkpoint dir to serve from (training spills here)",
    )
    s.add_argument("--port", type=int, default=0)
    s.add_argument("--max-batch", type=int, default=0)
    s.add_argument("--deadline-ms", type=int, default=0)
    s.add_argument(
        "--duration", type=float, default=0.0,
        help="serve for N seconds then exit (0 = forever)",
    )
    s.add_argument("--device", default=None, help="torch device (default: cuda)")
    s.add_argument("--tiny", action="store_true", help="the model's tiny configuration")
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser(
        "metrics",
        help="pretty-print a running job's merged metrics + flight "
        "recorder (from its coordinator URL)",
    )
    s.add_argument("url", help="coordinator address (host:port)")
    s.add_argument(
        "--events", type=int, default=20, help="flight-recorder tail length"
    )
    s.add_argument(
        "--prom",
        action="store_true",
        help="dump the raw Prometheus text exposition instead",
    )
    s.add_argument(
        "--json", action="store_true", help="dump raw JSON instead"
    )
    s.add_argument("--timeout", type=float, default=5.0)
    s.set_defaults(fn=cmd_metrics)

    s = sub.add_parser(
        "trace",
        help="merge coordinator + member flight journals into one "
        "clock-aligned Perfetto timeline (+ goodput summary)",
    )
    s.add_argument(
        "url",
        nargs="?",
        default="",
        help="coordinator address (host:port); omit for --journal-only",
    )
    s.add_argument(
        "--journal",
        action="append",
        metavar="NAME=PATH",
        help="merge an on-disk flight-recorder JSONL spill "
        "(EDL_FLIGHT_RECORDER_FILE) as lane NAME (repeatable)",
    )
    s.add_argument(
        "--out", default="edl-trace.json", help="output Chrome-trace JSON"
    )
    s.add_argument(
        "--trace-id", default="", help="filter to one causal chain"
    )
    s.add_argument(
        "--summary",
        action="store_true",
        help="print the goodput decomposition + causal chains",
    )
    s.add_argument("--timeout", type=float, default=5.0)
    s.set_defaults(fn=cmd_trace)

    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # Downstream pager/head closed the pipe: normal CLI etiquette.
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    sys.exit(main())
