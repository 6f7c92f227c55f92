#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``edl_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's serving path on the card and exits non-zero on
the first failure.  Phases, in order:

1. **Device** — prints the card's name and power limit (nvidia-smi);
   turns TF32 off for float32 matmuls and convolutions.
2. **Build** — compiles every hand-written kernel from the sources in
   the checkout (``edl_tpu_torch/ops/csrc``), all ``nvcc`` started
   together, and prints the build seconds.
3. **Kernels against their plain versions** — each kernel's wrapper on
   card tensors at the shapes the serving path gives it, held against
   the plain PyTorch version on the same inputs; then timed at the
   main path's largest shape beside its plain version, one PyTorch
   library call computing the same function, and its bound.
4. **Serving** — full-width ``transformer_lm`` (seeded random weights)
   behind ``DecodeEngine`` + ``TokenContinuousBatcher`` (monolithic
   prefill) + ``ServingServer`` on loopback; four concurrent
   ``/generate`` requests (one streaming).  Launch counts are zeroed
   just before and read just after, and the served tokens are checked
   against a full-recompute greedy run through the port's own forward.
5. **Kernels line** — one JSON object listing every ported kernel with
   its launches on the serving path, error, times and bound.
6. **Last line** — ``{"ok": true, "device": {...}}``.

Every phase prints its details as one JSON line.  Without CUDA, or
without the package beside it, it exits non-zero and prints no result.
"""

import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

#: H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

#: bf16 tolerance of the repo's flash tests (tests/test_flash_attention.py)
BF16_TOL = 3e-2
#: lse is float32 on both sides; only summation order and exp differ
LSE_TOL = 1e-3
#: served vs full-recompute logits agree within this fraction of the
#: row's largest |logit| (the bf16 scale tolerance of the model parity
#: tests): a top-2 margin above it cannot be flipped by bf16 rounding
MARGIN_FRAC = 2e-2

SERVE_PROMPTS = (300, 700, 1200, 1900)
SERVE_NEW_TOKENS = 32
SEED = 0


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back
    calls (CUDA events, after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 1 --------------------------------------------------------------


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi exit {smi.returncode}: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": card,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    log({"device": info})


# -- phase 2 --------------------------------------------------------------


def phase_build():
    from edl_tpu_torch.ops import _build

    t0 = time.perf_counter()
    per = _build.build(_build.KERNELS)
    secs = time.perf_counter() - t0
    ptxas = {
        name: [
            line.strip() for line in _build.build_log(name).splitlines()
            if "registers" in line or "spill" in line
        ]
        for name in _build.KERNELS
    }
    log({"build": {"seconds": round(secs, 3), "per_kernel": per, "ptxas": ptxas}})


# -- phase 3 --------------------------------------------------------------


def _qkv(g, b, t, h, d):
    import torch

    return [
        torch.randn((b, t, h, d), generator=g, device="cuda").to(torch.bfloat16)
        for _ in range(3)
    ]


def _flash_case(g, b, t, h, d, causal, mask_kind=None):
    """One kernel-vs-plain comparison; returns the O and lse errors."""
    import torch

    from edl_tpu_torch.ops.flash_attention import flash_attention_plain, flash_fwd_cuda

    q, k, v = _qkv(g, b, t, h, d)
    mask = None
    if mask_kind == "row_masked":
        mask = torch.rand((b, t), generator=g, device="cuda") > 0.25
        mask[-1] = False  # one batch row with every key masked
    scale = d ** -0.5
    o, lse = flash_fwd_cuda(q, k, v, causal, scale, mask)
    torch.cuda.synchronize()
    po, plse = flash_attention_plain(q, k, v, causal, scale, mask)
    torch.cuda.synchronize()
    if not (torch.isfinite(o.float()).all() and torch.isfinite(lse).all()):
        fail(f"flash_fwd non-finite output at {b=} {t=} {causal=} {mask_kind=}")
    o_err = (o.float() - po.float()).abs().max().item()
    lse_err = (lse - plse).abs().max().item()
    o_ok = torch.allclose(o.float(), po.float(), atol=BF16_TOL, rtol=BF16_TOL)
    if not o_ok or lse_err > LSE_TOL:
        fail(f"flash_fwd disagrees with its plain version at {b=} {t=} "
             f"{causal=} {mask_kind=}: O err {o_err}, lse err {lse_err}")
    if mask_kind == "row_masked":
        if o[-1].float().abs().max().item() != 0.0:
            fail("fully masked row: O is not 0")
        want = float(np.log(np.float32(1e-30)))
        if (lse[-1] - want).abs().max().item() > 1e-4:
            fail("fully masked row: lse is not log(1e-30)")
    return {"B": b, "T": t, "H": h, "D": d, "causal": causal,
            "mask": mask_kind, "o_max_abs_err": o_err, "lse_max_abs_err": lse_err}


def flash_bound_ms(b, t, h, d, causal) -> tuple:
    """Least time the card needs for the same attention forward: the
    larger of its tensor-core FLOPs (QK^T and PV over the key pairs the
    mask keeps) at the bf16 peak, and its bytes (Q, K, V read once, O
    and lse written once) at the memory rate."""
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 4 * b * h * d * pairs
    nbytes = 4 * b * t * h * d * 2 + b * h * t * 4
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes"), flops, nbytes


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.ops.flash_attention import flash_attention_plain, flash_fwd_cuda

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    cases = []
    # the serving path's prefill shapes (B=1, H=12, D=64, causal), ragged
    # lengths included, then the masked non-causal case and /predict's
    for t in (16, 48, 512, 2047, 2048):
        cases.append(_flash_case(g, 1, t, 12, 64, True))
    cases.append(_flash_case(g, 2, 300, 12, 64, False, "row_masked"))
    cases.append(_flash_case(g, 4, 2048, 12, 64, True))
    for c in cases:
        log({"flash_fwd_check": c})

    b, t, h, d = 1, 2048, 12, 64
    q, k, v = _qkv(g, b, t, h, d)
    scale = d ** -0.5
    kernel_ms = cuda_ms(lambda: flash_fwd_cuda(q, k, v, True, scale), iters=50)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, True, scale), iters=10)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale),
        iters=50,
    )
    bound_ms, bound_by, flops, nbytes = flash_bound_ms(b, t, h, d, True)
    timing = {
        "name": "flash_fwd", "shape": [b, t, h, d], "causal": True,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
        "tflops": flops / (kernel_ms * 1e-3) / 1e12,
    }
    log({"kernel_timing": timing})
    max_err = max(c["o_max_abs_err"] for c in cases)
    return {"cases": cases, "timing": timing, "max_abs_err": max_err}


# -- phase 4 --------------------------------------------------------------


def _post(url, body, timeout=600):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    return urllib.request.urlopen(req, timeout=timeout)


def _generate(base, prompt, stream, out, key):
    body = {"inputs": {"tokens": prompt.tolist()},
            "max_new_tokens": SERVE_NEW_TOKENS, "stream": stream}
    t0 = time.perf_counter()
    try:
        with _post(base + "/generate", body) as r:
            status = r.status
            if stream:
                lines = [json.loads(x) for x in r.read().decode().splitlines() if x]
                done = lines[-1]
                tokens = [ev["token"] for ev in lines if "token" in ev]
                if not done.get("done") or done.get("tokens") != tokens:
                    out[key] = {"status": status, "error": f"bad stream end {done}"}
                    return
                ttft_ms = done["ttft_s"] * 1e3
            else:
                reply = json.loads(r.read())
                tokens, ttft_ms = reply["tokens"], reply["ttft_ms"]
        out[key] = {"status": status, "tokens": tokens, "ttft_ms": ttft_ms,
                    "latency_s": time.perf_counter() - t0, "stream": stream}
    except Exception as e:  # recorded, then failed on by the caller
        out[key] = {"status": getattr(e, "code", None), "error": repr(e)}


def _recompute_check(engine, prompts, served):
    """Teacher-forced full recompute: at every served step, run the
    port's forward over prompt + the tokens served so far (flash kernel
    at the exact length, no KV cache) and compare its greedy token."""
    import torch

    params = engine.current_weights().params
    w = params.logit_weight(torch.bfloat16)
    checked = agreed = near_ties = 0
    with torch.no_grad():
        for prompt, toks in zip(prompts, served):
            seq = torch.tensor(np.concatenate([prompt, toks]), device=engine.device)[None]
            for i in range(len(toks)):
                n = len(prompt) + i
                feats = params(seq[:, :n], return_features=True)[:, -1]
                logits = (feats.to(torch.bfloat16).float() @ w.t())[0]
                top = torch.topk(logits, 2)
                margin = (top.values[0] - top.values[1]).item()
                tol = MARGIN_FRAC * logits.abs().max().item()
                same = int(top.indices[0]) == int(toks[i])
                agreed += same
                checked += 1
                if margin > tol:
                    if not same:
                        fail(f"served token {toks[i]} != full-recompute "
                             f"{int(top.indices[0])} at step {i} of a "
                             f"{len(prompt)}-token prompt (margin {margin}, tol {tol})")
                else:
                    near_ties += 1
    return {"steps": checked, "agreement": agreed / checked, "near_ties": near_ties}


def phase_serving():
    import torch

    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.ops.flash_attention import LAUNCHES, reset_launch_counts
    from edl_tpu_torch.serving import (
        ContinuousBatcher,
        DecodeEngine,
        ServingServer,
        TokenContinuousBatcher,
    )

    model = get_model("transformer_lm")  # full width, bf16
    t0 = time.perf_counter()
    engine = DecodeEngine(model, device="cuda", max_seqs=8, block_tokens=16)
    engine.install_seeded(SEED)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    batcher = ContinuousBatcher(engine).start()
    gen = TokenContinuousBatcher(engine, chunked_prefill=False).start()
    server = ServingServer(batcher, port=0, gen_batcher=gen).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        # warm-up request (library handles, allocator) before the counts
        with _post(base + "/generate", {"inputs": {"tokens": [5, 6, 7]},
                                        "max_new_tokens": 2}) as r:
            if r.status != 200:
                fail(f"warm-up /generate answered {r.status}")
        rng = np.random.RandomState(SEED)
        vocab = model.decode.vocab_size
        prompts = [rng.randint(3, vocab, size=n).astype(np.int32) for n in SERVE_PROMPTS]
        prefills0 = gen.stats["prefills"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = {}
        threads = [
            threading.Thread(target=_generate, args=(base, p, i == 3, out, i))
            for i, p in enumerate(prompts)
        ]
        reset_launch_counts()
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        prefills = gen.stats["prefills"] - prefills0
        peak = torch.cuda.max_memory_allocated()
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
    finally:
        server.stop()
        gen.stop()
        batcher.stop()
    for i in range(len(prompts)):
        res = out.get(i)
        if res is None or res.get("status") != 200 or "error" in res:
            fail(f"/generate request {i} failed: {res}")
        if len(res["tokens"]) != SERVE_NEW_TOKENS:
            fail(f"/generate request {i} returned {len(res['tokens'])} tokens")
    layers = model.decode.layers  # 12 at full width
    if prefills < len(prompts) or launches["flash_fwd"] != layers * prefills:
        fail(f"flash_fwd launched {launches['flash_fwd']} times for {prefills} "
             f"prefills on the serving path (want {layers} per prefill)")
    if engine.pool.used_blocks != 0:
        fail(f"{engine.pool.used_blocks} KV blocks still owned after serving")
    served = [out[i]["tokens"] for i in range(len(prompts))]
    check = _recompute_check(engine, prompts, served)
    ttfts = sorted(out[i]["ttft_ms"] for i in range(len(prompts)))
    total_tokens = sum(len(s) for s in served)
    result = {
        "model": "transformer_lm", "prompts": list(SERVE_PROMPTS),
        "new_tokens": SERVE_NEW_TOKENS, "setup_s": setup_s, "wall_s": wall,
        "ttft_ms": ttfts, "ttft_p50_ms": float(np.median(ttfts)),
        "tokens_per_s": total_tokens / wall,
        "latency_s": [out[i]["latency_s"] for i in range(len(prompts))],
        "peak_allocated_bytes": peak, "kv_pool_bytes": engine.pool.nbytes(),
        "prefills": prefills, "launches": launches,
        "recompute": check, "healthz": health,
    }
    log({"serving": result})
    return result


# -- main -----------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import edl_tpu_torch  # noqa: F401  (fails here when run without the repo)

    phase_device()
    phase_build()
    kernels = phase_kernels()
    serving = phase_serving()
    timing = kernels["timing"]
    line = {"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "edl_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "edl_tpu/ops/flash_attention.py:203",
        "launches": serving["launches"]["flash_fwd"],
        "max_abs_err": kernels["max_abs_err"],
        "ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
