"""Where the training step's time goes, on the card.

    python -m edl_tpu_torch.tools.profile_training [--batch 8] [--reps 5]
    python -m edl_tpu_torch.tools.profile_training --model longcontext_lm \
        --seq-len 32768 --batch 1 --reps 2
    python -m edl_tpu_torch.tools.profile_training --model moe_lm

Builds the ``Trainer`` of a full-width model (``transformer_lm`` by
default, or another family of ``MODELS``; seeded weights, float32
parameters, bf16 compute, Adam) over
``ShardedDataIterator`` and, after one warm-up step, measures the train
step as host wall time per step (ending in a synchronize) and under
``torch.profiler``: device time per kernel class (the port's kernels
B1-B6 by name, cuBLAS products, the optimizer, the rest), the top
kernels, launches per step and the device's busy share of the wall
time.  A model whose loss reports ``moe_drop_rate`` (``moe_lm``) has
the mean drop rate of the measured steps in the step line.  Prints one
JSON line for the step and a summary line with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from edl_tpu_torch.tools.profile_serving import _device_us

#: the families it profiles (``--model``)
MODELS = ("transformer_lm", "longcontext_lm", "moe_lm", "transformer_base", "resnet50",
          "mnist", "fit_a_line")

#: H100 SXM dense bf16 peak (NVIDIA data sheet, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "flash_fwd (B1)"
    if "flash_bwd_streamk" in n:
        return "flash_bwd_streamk (B3)"
    if "flash_bwd" in n:
        return "flash_bwd (B2)"
    for kernel, label in (("xent_fwd", "B4"), ("xent_dy", "B5"), ("xent_de", "B6")):
        if f"{kernel}_kernel" in n:
            return f"{kernel} ({label})"
    if "conv" in n or "cudnn" in n or "wgrad" in n or "dgrad" in n:
        return "convolution (cuDNN)"
    if any(w in n for w in ("gemm", "gemv", "xmma", "cutlass", "nvjet", "sm90")):
        return "matmul (cuBLAS)"
    if "multi_tensor" in n or "adam" in n:
        return "optimizer (Adam)"
    if any(w in n for w in ("layer_norm", "groupnorm", "group_norm", "moments", "softmax",
                            "reduce", "pool")):
        return "norm/reduce"
    if "index" in n or "gather" in n or "scatter" in n or "embedding" in n:
        return "gather/scatter"
    if "memcpy" in n or "memset" in n:
        return "copies"
    return "elementwise/other"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="transformer_lm", choices=MODELS)
    p.add_argument("--seq-len", type=int, default=None,
                   help="tokens per example of a token model (its default when omitted)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_training measures the card; no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.runtime import ShardedDataIterator, Trainer, synthetic_dataset

    model = get_model(args.model, **({"seq_len": args.seq_len} if args.seq_len else {}))
    trainer = Trainer(model, device="cuda", seed=args.seed)
    state = trainer.init_state()
    it = ShardedDataIterator(
        synthetic_dataset(model.synth_batch, 4 * args.batch, seed=args.seed), args.batch,
        seed=args.seed,
    )
    batches = [it.device_batch(s, "cuda") for s in range(2 * args.reps + 1)]

    drops = []

    def run(i):
        nonlocal state
        state, metrics = trainer.step(state, batches[i])
        if "moe_drop_rate" in metrics:
            drops.append(metrics["moe_drop_rate"])

    run(0)  # warm-up: library handles, allocator, kernel builds
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, args.reps + 1):
        run(i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.reps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.reps + 1, 2 * args.reps + 1):
            run(i)
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
    device_ms = sum(by_class.values()) / 1e3 / args.reps
    kernels.sort(reverse=True)
    flops = args.batch * model.flops_per_example
    tokens = args.batch * model.tokens_per_example
    step = {
        "model": args.model, "batch": args.batch, "seq_len": model.tokens_per_example,
        "host_wall_ms_per_step": wall_ms,
        "tokens_per_s": tokens / (wall_ms * 1e-3),
        "examples_per_s": args.batch / (wall_ms * 1e-3),
        "mfu": flops / (wall_ms * 1e-3) / PEAK_BF16_FLOPS,
        "device_ms_per_step": device_ms,
        "device_busy_share_of_unprofiled_wall": device_ms / wall_ms,
        "device_busy_share_of_profiled_window": device_ms * args.reps / window_ms,
        "kernel_launches_per_step": launches / args.reps,
        "device_ms_by_class_per_step": {
            k: v / 1e3 / args.reps for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])
        },
        "top_kernels": [
            {"name": name[:120], "ms_per_step": us / 1e3 / args.reps,
             "calls_per_step": n / args.reps}
            for us, n, name in kernels[:10]
        ],
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    if drops:  # the measured steps', the warm-up's left out
        step["moe_drop_rate_mean"] = float(torch.stack(drops[1:]).mean())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({"train_step": step}))
    print(json.dumps({"card": smi, "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
