"""Where the serving step's time goes, on the card.

    python -m edl_tpu_torch.tools.profile_serving [--prompt 2048] [--batch 4]

Builds the full-width ``transformer_lm`` ``DecodeEngine`` with seeded
weights, then measures, after warm-up:

- one monolithic prefill at ``--prompt`` tokens (B=1), and
- one decode step for ``--batch`` sequences whose caches hold
  ``--prompt`` tokens each,

each as host wall time per call (ending in the step's device-to-host
read of the ids, as the engine does) and under ``torch.profiler``:
device time per kernel class, the top kernels, and the device's busy
share of the wall time.  Prints one JSON line per phase and a summary
line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "flash_fwd (B1)"
    if any(w in n for w in ("gemm", "gemv", "xmma", "cutlass", "nvjet", "sm90")):
        return "matmul (cuBLAS)"
    if "index" in n or "gather" in n or "scatter" in n:
        return "gather/scatter"
    if "softmax" in n or "layer_norm" in n or "reduce" in n or "argmax" in n:
        return "softmax/norm/reduce"
    if "memcpy" in n or "memset" in n:
        return "copies"
    return "elementwise/other"


def _device_us(evt) -> float:
    """Self device microseconds of a profiler event; 0 for a user
    annotation (``Optimizer.step#Adam.step``): its span on the device
    timeline covers kernels that are counted on their own."""
    if getattr(evt, "is_user_annotation", False):
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v:
            return float(v)
    return 0.0


def _wall_ms(fn, reps: int) -> float:
    """Host wall milliseconds per call over ``reps`` calls, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _profile(fn, reps: int) -> dict:
    """One profiled window of ``reps`` calls: device time by kernel
    class, the top kernels, and the device's busy share of the window's
    wall time (the profiler slows the host, so the unprofiled wall time
    is taken separately, before any profiling)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    by_class = defaultdict(float)
    kernels = []
    launches = 0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_class[_kernel_class(evt.key)] += us
        kernels.append((us, evt.count, evt.key))
        launches += evt.count
    device_ms = sum(by_class.values()) / 1e3
    kernels.sort(reverse=True)
    return {
        "device_ms_per_call": device_ms / reps,
        "device_busy_share": device_ms / window_ms if window_ms else None,
        "kernel_launches_per_call": launches / reps,
        "device_ms_by_class_per_call": {
            k: v / 1e3 / reps for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])
        },
        "top_kernels": [
            {"name": name[:120], "ms_per_call": us / 1e3 / reps, "calls_per_call": n / reps}
            for us, n, name in kernels[:8]
        ],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--prompt", type=int, default=2048)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving measures the card; no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.serving import DecodeEngine

    model = get_model("transformer_lm")
    eng = DecodeEngine(model, device="cuda", max_seqs=8, block_tokens=16)
    w = eng.install_seeded(args.seed)
    rng = np.random.RandomState(args.seed)
    plen = min(args.prompt, eng.max_prompt)
    prompts = [rng.randint(3, model.decode.vocab_size, size=plen).astype(np.int32)
               for _ in range(args.batch)]
    tables = np.zeros((args.batch, eng.blocks_per_seq), np.int32)
    for i, pr in enumerate(prompts):
        blocks = eng.pool.alloc(eng.prompt_bucket_for(plen) // eng.block_tokens)
        tables[i, : len(blocks)] = blocks
        eng.prefill(w, pr, tables[i])
    last = np.zeros(eng.decode_bucket_for(args.batch), np.int32)
    lengths = np.full_like(last, plen - 1)  # rewrite the last position
    dec_tables = np.zeros((len(last), eng.blocks_per_seq), np.int32)
    dec_tables[: args.batch] = tables

    run_prefill = lambda: eng.prefill(w, prompts[0], tables[0])  # noqa: E731
    run_decode = lambda: eng.decode_step(w, last, lengths, dec_tables)  # noqa: E731
    walls = {"prefill": _wall_ms(run_prefill, args.reps),
             "decode": _wall_ms(run_decode, args.reps)}
    prefill = {"host_wall_ms_per_call": walls["prefill"], **_profile(run_prefill, args.reps)}
    decode = {"host_wall_ms_per_call": walls["decode"], **_profile(run_decode, args.reps)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({"prefill": {"prompt_tokens": plen, "bucket": eng.prompt_bucket_for(plen), **prefill}}))
    print(json.dumps({"decode": {"batch": args.batch, "bucket": len(last), "context": plen, **decode}}))
    print(json.dumps({"card": smi, "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
