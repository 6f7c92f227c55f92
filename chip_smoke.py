#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``edl_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's serving and training paths on the card and exits
non-zero on the first failure.  Phases, in order:

1. **Device** — prints the card's name and power limit (nvidia-smi);
   turns TF32 off for float32 matmuls and convolutions.
2. **Build** — compiles every hand-written kernel from the sources in
   the checkout (``edl_tpu_torch/ops/csrc``), all ``nvcc`` started
   together, and prints the build seconds.
3. **Kernels against their plain versions** — each kernel's wrapper on
   card tensors at the shapes the main paths give it (and ragged,
   masked edge cases), held against the plain PyTorch version on the
   same inputs with a stated tolerance; then timed at the main path's
   largest shape beside its plain version, its bound and, where one
   exists, one PyTorch library call computing the same function.
   B1 flash forward, B2 flash backward, B4-B6 fused tied-vocab cross
   entropy.
4. **Serving** — full-width ``transformer_lm`` (seeded random weights)
   behind ``DecodeEngine`` + ``TokenContinuousBatcher`` (monolithic
   prefill) + ``ServingServer`` on loopback; four concurrent
   ``/generate`` requests (one streaming).  Launch counts are zeroed
   just before and read just after, and the served tokens are checked
   against a full-recompute greedy run through the port's own forward.
5. **Training** — full-width ``transformer_lm`` (seeded, float32
   parameters, bf16 compute) in the port's ``Trainer`` (Adam, lr 1e-3)
   at global batch 8 x 2048 tokens from ``ShardedDataIterator`` over
   ``synthetic_dataset``: two runs of step 0 from one state must give
   bit-identical loss and gradients; one warm-up step and five timed
   steps, each with its launch counts zeroed before and read after
   (12 ``flash_fwd``, 12 ``flash_bwd``, one each of ``xent_fwd``,
   ``xent_dy``, ``xent_de``); the loss must be finite and fall; and at
   batch 2 the kernel path's step-0 loss and gradients are held
   against the plain path's (plain attention autograd +
   ``tied_vocab_xent``).
6. **Kernels line** — one JSON object listing every ported kernel with
   its launches on the main path, error, times and bound.
7. **Last line** — ``{"ok": true, "device": {...}}``.

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

#: gradients in bf16: kernel and plain versions round dS, P and dL to
#: bf16 at the same points from float32 sums taken in another order, so
#: a rounding can land one ulp apart; held at this fraction of the
#: gradient's largest magnitude (tests/test_torch_cuda_kernels.py)
GRAD_TOL = 2e-2
#: float32 loss statistics (lse, label logit, row max) of the fused
#: cross entropy: sums of exact bf16 products in another order, held at
#: this fraction of the largest |value|
STAT_TOL = 1e-5
#: training at batch 2, kernel path vs plain path (plain attention
#: autograd + tied_vocab_xent): the paths round bf16 at different
#: points through 12 layers; the loss is held at this relative
#: tolerance and each gradient at GRAD_TOL of its largest magnitude
TRAIN_LOSS_TOL = 1e-3

SERVE_PROMPTS = (300, 700, 1200, 1900)
SERVE_NEW_TOKENS = 32
SEED = 0

#: the training phase: global batch 8 at the model's T=2048 (the batch
#: of bench_lib/lm.py's bench_longcontext_lm at T=2048), the launcher's
#: default lr, one warm-up step and five timed steps
TRAIN_BATCH = 8
TRAIN_LR = 1e-3
TRAIN_STEPS = 5
PARITY_BATCH = 2


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


def _bound(flops, nbytes) -> tuple:
    """``(bound_ms, bound_by, flops, bytes)``: the larger of the FLOPs
    at the bf16 peak and the bytes at the memory rate."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes"), flops, nbytes


def flash_bound_ms(b, t, h, d, causal) -> tuple:
    """Least time the card needs for the same attention forward: the
    larger of its tensor-core FLOPs (QK^T and PV over the key pairs the
    mask keeps) at the bf16 peak, and its bytes (Q, K, V read once, O
    and lse written once) at the memory rate."""
    pairs = t * (t + 1) // 2 if causal else t * t
    return _bound(4 * b * h * d * pairs, 4 * b * t * h * d * 2 + b * h * t * 4)


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.ops.flash_attention import flash_attention_plain, flash_fwd_cuda

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    cases = []
    # the serving path's prefill shapes (B=1, H=12, D=64, causal), ragged
    # lengths included, then the masked non-causal case and the training
    # path's shape
    for t in (16, 48, 512, 2047, 2048):
        cases.append(_flash_case(g, 1, t, 12, 64, True))
    cases.append(_flash_case(g, 2, 300, 12, 64, False, "row_masked"))
    cases.append(_flash_case(g, TRAIN_BATCH, 2048, 12, 64, True))
    for c in cases:
        log({"flash_fwd_check": c})

    # timed at the serving path's largest prefill (the kernels line) and
    # at the training path's shape
    timings = []
    for b in (1, TRAIN_BATCH):
        t, h, d = 2048, 12, 64
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
        timings.append({
            "name": "flash_fwd", "shape": [b, t, h, d], "causal": True,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            "tflops": flops / (kernel_ms * 1e-3) / 1e12,
        })
        log({"kernel_timing": timings[-1]})
    max_err = max(c["o_max_abs_err"] for c in cases)
    return {"cases": cases, "timing": timings[0], "max_abs_err": max_err}


def _rel_err(got, want) -> float:
    """max |got - want| over max |want| (both as float32)."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _max_abs(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def _bwd_case(g, b, t, h, d, causal, mask_kind=None, with_glse=False):
    """One B2 kernel-vs-plain comparison from the B1 kernel's O and lse."""
    import torch

    from edl_tpu_torch.ops.flash_attention import flash_bwd_cuda, flash_bwd_plain, flash_fwd_cuda

    q, k, v = _qkv(g, b, t, h, d)
    do = torch.randn((b, t, h, d), generator=g, device="cuda").to(torch.bfloat16)
    mask = None
    if mask_kind == "row_masked":
        mask = torch.rand((b, t), generator=g, device="cuda") > 0.25
        mask[-1] = False  # one batch row with every key masked
    g_lse = torch.randn((b, h, t), generator=g, device="cuda") if with_glse else None
    scale = d ** -0.5
    o, lse = flash_fwd_cuda(q, k, v, causal, scale, mask)
    got = flash_bwd_cuda(q, k, v, o, lse, do, g_lse, mask, causal, scale)
    torch.cuda.synchronize()
    want = flash_bwd_plain(q, k, v, o, lse, do, g_lse, mask, causal, scale)
    torch.cuda.synchronize()
    errs = {}
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        if not torch.isfinite(x.float()).all():
            fail(f"flash_bwd non-finite {name} at {b=} {t=} {causal=} {mask_kind=}")
        errs[name] = (_max_abs(x, w), _rel_err(x, w))
        if errs[name][1] > GRAD_TOL:
            fail(f"flash_bwd {name} disagrees with its plain version at {b=} {t=} "
                 f"{causal=} {mask_kind=} {with_glse=}: error {errs[name][1]} of "
                 f"its scale (tolerance {GRAD_TOL})")
        if mask_kind == "row_masked" and x[-1].float().abs().max().item() != 0.0:
            fail(f"fully masked row: {name} is not 0")
    return {"B": b, "T": t, "H": h, "D": d, "causal": causal, "mask": mask_kind,
            "g_lse": with_glse, "tolerance_of_scale": GRAD_TOL,
            "max_abs_err": max(e[0] for e in errs.values()),
            "err_of_scale": {k: e[1] for k, e in errs.items()}}


def flash_bwd_bound_ms(b, t, h, d, causal) -> tuple:
    """Least time for the same attention backward: its five products
    (S, dP, dV, dK, dQ) over the key pairs the mask keeps at the bf16
    peak, or its bytes (q, k, v, O, dO and lse read once, dQ, dK, dV
    written once) at the memory rate."""
    pairs = t * (t + 1) // 2 if causal else t * t
    return _bound(10 * b * h * d * pairs, 8 * b * t * h * d * 2 + b * h * t * 4)


def phase_flash_bwd():
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.ops.flash_attention import flash_bwd_cuda, flash_bwd_plain, flash_fwd_cuda

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 1)
    cases = [
        # the training path's shape, then ragged T, a key mask with a
        # fully masked row, and the lse cotangent (the ring's merge)
        _bwd_case(g, 8, 2048, 12, 64, True),
        _bwd_case(g, 1, 2047, 12, 64, True, with_glse=True),
        _bwd_case(g, 2, 48, 12, 64, True),
        _bwd_case(g, 2, 300, 12, 64, False, "row_masked", with_glse=True),
        _bwd_case(g, 2, 300, 12, 64, False, "row_masked"),
    ]
    for c in cases:
        log({"flash_bwd_check": c})

    b, t, h, d = TRAIN_BATCH, 2048, 12, 64
    q, k, v = _qkv(g, b, t, h, d)
    do = torch.randn((b, t, h, d), generator=g, device="cuda").to(torch.bfloat16)
    scale = d ** -0.5
    o, lse = flash_fwd_cuda(q, k, v, True, scale)
    kernel_ms = cuda_ms(
        lambda: flash_bwd_cuda(q, k, v, o, lse, do, None, None, True, scale), iters=20)
    plain_ms = cuda_ms(
        lambda: flash_bwd_plain(q, k, v, o, lse, do, None, None, True, scale),
        iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)

    with torch.no_grad():
        fwd_ms = cuda_ms(sdpa_fwd, iters=20)
    library_ms = cuda_ms(sdpa_fwd_bwd, iters=20) - fwd_ms
    bound_ms, bound_by, flops, nbytes = flash_bwd_bound_ms(b, t, h, d, True)
    timing = {
        "name": "flash_bwd", "shape": [b, t, h, d], "causal": True,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library": "scaled_dot_product_attention backward (fwd+bwd minus fwd)",
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
        "tflops": flops / (kernel_ms * 1e-3) / 1e12,
    }
    log({"kernel_timing": timing})
    return {"cases": cases, "timing": timing,
            "max_abs_err": max(c["max_abs_err"] for c in cases)}


def _xent_inputs(g, n, v, d, pad_rows=0):
    """Features and embedding at the training path's scale (LayerNorm
    output and the embedding's N(0, 1) init), labels, and row scales
    with every 7th row at valid 0; the last ``pad_rows`` rows are the
    padding ``fused_vocab_xent`` adds (zero features, label 0, scale 0)."""
    import torch

    y = torch.randn((n, d), generator=g, device="cuda").to(torch.bfloat16)
    e = torch.randn((v, d), generator=g, device="cuda").to(torch.bfloat16)
    labels = torch.randint(0, v, (n,), generator=g, device="cuda", dtype=torch.int32)
    valid = torch.ones(n, device="cuda")
    valid[::7] = 0.0
    if pad_rows:
        y[n - pad_rows:] = 0
        labels[n - pad_rows:] = 0
        valid[n - pad_rows:] = 0.0
    row_scale = valid / valid.sum().clamp_min(1.0)
    return y, e, labels, row_scale


def xent_bound_ms(n, v, d, mode) -> tuple:
    """Least time for one fused cross-entropy kernel: its products (the
    logits, 2*N*V*D, and for dY / dE the product with dL, as much
    again) at the bf16 peak, or its bytes (Y, E, labels and the
    per-row inputs read once, its outputs written once) at the memory
    rate."""
    flops = (2 if mode == "xent_fwd" else 4) * n * v * d
    nbytes = n * d * 2 + v * d * 2 + n * 4
    nbytes += {"xent_fwd": 3 * n * 4, "xent_dy": 2 * n * 4 + n * d * 2,
               "xent_de": 2 * n * 4 + v * d * 4}[mode]
    return _bound(flops, nbytes)


def _xent_case(g, n, v, d, pad_rows=0):
    """B4, B5 and B6 against their plain versions on one input."""
    import torch

    from edl_tpu_torch.ops import fused_xent as fx

    y, e, labels, row_scale = _xent_inputs(g, n, v, d, pad_rows)
    got = fx.xent_fwd_cuda(y, e, labels)
    torch.cuda.synchronize()
    want = fx.xent_fwd_plain(y, e, labels)
    out = {"N": n, "V": v, "D": d, "pad_rows": pad_rows}
    errs = {}
    for name, x, w in zip(("lse", "label_logit", "row_max"), got, want):
        errs[name] = (_max_abs(x, w), _rel_err(x, w))
        if not torch.isfinite(x).all() or errs[name][1] > STAT_TOL:
            fail(f"xent_fwd {name} disagrees with its plain version at {n=} {v=}: "
                 f"error {errs[name][1]} of its scale (tolerance {STAT_TOL})")
    out["xent_fwd"] = {"max_abs_err": max(x[0] for x in errs.values()),
                       "err_of_scale": {k: x[1] for k, x in errs.items()},
                       "tolerance_of_scale": STAT_TOL}
    lse = want[0]
    for mode, kern, plain in (("xent_dy", fx.xent_dy_cuda, fx.xent_dy_plain),
                              ("xent_de", fx.xent_de_cuda, fx.xent_de_plain)):
        x = kern(y, e, labels, lse, row_scale)
        torch.cuda.synchronize()
        w = plain(y, e, labels, lse, row_scale)
        rel = _rel_err(x, w)
        if not torch.isfinite(x.float()).all() or rel > GRAD_TOL:
            fail(f"{mode} disagrees with its plain version at {n=} {v=}: error "
                 f"{rel} of its scale (tolerance {GRAD_TOL})")
        if mode == "xent_dy" and x[::7].float().abs().max().item() != 0.0:
            fail("xent_dy: rows with valid 0 have a gradient")
        out[mode] = {"max_abs_err": _max_abs(x, w), "err_of_scale": rel,
                     "tolerance_of_scale": GRAD_TOL}
        del x, w
    return out


def phase_xent():
    import torch

    from edl_tpu_torch.ops import fused_xent as fx

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 2)
    n, v, d = TRAIN_BATCH * 2048, 32000, 768
    # the training path's shape, then an odd N and V with padding rows
    cases = [_xent_case(g, n, v, d), _xent_case(g, 300, 32001, d, pad_rows=20)]
    for c in cases:
        log({"xent_check": c})
    torch.cuda.empty_cache()
    y, e, labels, row_scale = _xent_inputs(g, n, v, d)
    lse = fx.xent_fwd_cuda(y, e, labels)[0]
    gemm_ms = cuda_ms(lambda: torch.matmul(y, e.t()), iters=10)
    runs = {
        "xent_fwd": (lambda: fx.xent_fwd_cuda(y, e, labels),
                     lambda: fx.xent_fwd_plain(y, e, labels)),
        "xent_dy": (lambda: fx.xent_dy_cuda(y, e, labels, lse, row_scale),
                    lambda: fx.xent_dy_plain(y, e, labels, lse, row_scale)),
        "xent_de": (lambda: fx.xent_de_cuda(y, e, labels, lse, row_scale),
                    lambda: fx.xent_de_plain(y, e, labels, lse, row_scale)),
    }
    timings = {}
    for mode, (kern, plain) in runs.items():
        kernel_ms = cuda_ms(kern, iters=5, warmup=1)
        plain_ms = cuda_ms(plain, iters=2, warmup=1)
        torch.cuda.empty_cache()
        bound_ms, bound_by, flops, nbytes = xent_bound_ms(n, v, d, mode)
        timings[mode] = {
            "name": mode, "shape": {"N": n, "V": v, "D": d},
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": None,
            "library": "none: no single PyTorch call computes it",
            "gemm_ms": gemm_ms, "gemm": "torch.matmul(Y, E.T) bf16, the product it contains",
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            "tflops": flops / (kernel_ms * 1e-3) / 1e12,
        }
        log({"kernel_timing": timings[mode]})
    errs = {mode: max(c[mode]["max_abs_err"] for c in cases) for mode in runs}
    return {"cases": cases, "timing": timings, "max_abs_err": errs}


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


# -- phase 5 --------------------------------------------------------------


def _all_launches() -> dict:
    from edl_tpu_torch.ops import fused_xent
    from edl_tpu_torch.ops.flash_attention import LAUNCHES

    return {**LAUNCHES, **fused_xent.LAUNCHES}


def _reset_launches() -> None:
    from edl_tpu_torch.ops import fused_xent
    from edl_tpu_torch.ops.flash_attention import reset_launch_counts

    reset_launch_counts()
    fused_xent.reset_launch_counts()


def _grads(params) -> dict:
    return {n: p.grad.detach().clone() for n, p in params.named_parameters()}


def _parity_plain_vs_kernels(model, trainer, it):
    """Step-0 loss and gradients at batch ``PARITY_BATCH``: the kernel
    path against the plain path (flash_attention_plain through torch
    autograd, tied_vocab_xent), which launches no kernel."""
    from unittest import mock

    import torch

    import edl_tpu_torch.models.transformer_lm as tlm
    from edl_tpu_torch.ops import tied_vocab_xent
    from edl_tpu_torch.ops.flash_attention import flash_attention_plain

    def plain_attention(q, k, v, causal=False, scale=None, kv_mask=None):
        return flash_attention_plain(q, k, v, causal, scale, kv_mask)[0]

    batch = it.device_batch(0, "cuda", world=TRAIN_BATCH // PARITY_BATCH, rank=0)
    state = trainer.init_state()
    loss_k, _ = trainer.loss_and_grads(state, batch)
    grads_k = _grads(state.params)
    _reset_launches()
    with mock.patch.object(tlm, "fused_attention", plain_attention), \
            mock.patch.object(tlm, "best_vocab_xent", tied_vocab_xent):
        loss_p, _ = trainer.loss_and_grads(state, batch)
    torch.cuda.synchronize()
    if any(_all_launches().values()):
        fail(f"the plain training path launched kernels: {_all_launches()}")
    grads_p = _grads(state.params)
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    grad_errs = {n: _rel_err(grads_k[n], grads_p[n]) for n in grads_p}
    worst = max(grad_errs, key=grad_errs.get)
    if loss_err > TRAIN_LOSS_TOL or grad_errs[worst] > GRAD_TOL:
        fail(f"batch-{PARITY_BATCH} step 0, kernels vs plain: loss error {loss_err} "
             f"(tolerance {TRAIN_LOSS_TOL}), worst gradient {worst} error "
             f"{grad_errs[worst]} of its scale (tolerance {GRAD_TOL})")
    return {"batch": PARITY_BATCH, "loss_kernels": loss_k.item(), "loss_plain": loss_p.item(),
            "loss_rel_err": loss_err, "loss_tolerance": TRAIN_LOSS_TOL,
            "worst_grad": worst, "worst_grad_err_of_scale": grad_errs[worst],
            "grad_tolerance_of_scale": GRAD_TOL,
            "median_grad_err_of_scale": float(np.median(list(grad_errs.values())))}


def phase_training():
    import torch

    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.runtime import ShardedDataIterator, Trainer, synthetic_dataset

    model = get_model("transformer_lm")  # full width: bf16 compute, f32 params
    layers = model.decode.layers
    want = {"flash_fwd": layers, "flash_bwd": layers, "xent_fwd": 1, "xent_dy": 1,
            "xent_de": 1}
    t0 = time.perf_counter()
    trainer = Trainer(model, lr=TRAIN_LR, device="cuda", seed=SEED)
    state = trainer.init_state()
    it = ShardedDataIterator(
        synthetic_dataset(model.synth_batch, 8 * TRAIN_BATCH, seed=SEED), TRAIN_BATCH,
        seed=SEED)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # two runs of step 0 from one state: bit-identical loss and gradients
    batch0 = it.device_batch(0, "cuda")
    loss_a, _ = trainer.loss_and_grads(state, batch0)
    grads_a = _grads(state.params)
    loss_b, _ = trainer.loss_and_grads(state, batch0)
    identical = torch.equal(loss_a, loss_b) and all(
        torch.equal(grads_a[n], p.grad) for n, p in state.params.named_parameters())
    if not identical:
        fail("two runs of training step 0 from one state differ")
    del grads_a

    steps = []
    timed_launches = dict.fromkeys(want, 0)
    torch.cuda.reset_peak_memory_stats()
    for step in range(TRAIN_STEPS + 1):  # one warm-up step, then the timed ones
        batch = it.device_batch(step, "cuda")
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = _all_launches()
        if launches != want:
            fail(f"training step {step} launched {launches}, want {want} per step")
        if step:
            for k in timed_launches:
                timed_launches[k] += launches[k]
        loss = metrics["loss"].item()
        if not np.isfinite(loss):
            fail(f"training step {step}: loss {loss} is not finite")
        steps.append({"step": step, "loss": loss, "ms": wall_ms})
    peak = torch.cuda.max_memory_allocated()
    loss0 = loss_a.item()
    eval0 = trainer.eval_loss(state, batch0).item()
    if not (steps[-1]["loss"] < steps[0]["loss"] and eval0 < loss0):
        fail(f"the loss did not fall over {TRAIN_STEPS} steps: step losses "
             f"{[x['loss'] for x in steps]}, batch-0 loss {loss0} -> {eval0}")
    step_ms = float(np.median([x["ms"] for x in steps[1:]]))
    tokens = TRAIN_BATCH * model.tokens_per_example
    flops = TRAIN_BATCH * model.flops_per_example
    del state, batch0
    torch.cuda.empty_cache()
    parity = _parity_plain_vs_kernels(model, trainer, it)
    result = {
        "model": "transformer_lm", "batch": TRAIN_BATCH, "seq_len": model.tokens_per_example,
        "lr": TRAIN_LR, "setup_s": setup_s, "steps": steps,
        "step_ms_median": step_ms, "tokens_per_s": tokens / (step_ms * 1e-3),
        "mfu": flops / (step_ms * 1e-3) / PEAK_BF16_FLOPS,
        "flops_per_step": flops, "peak_allocated_bytes": peak,
        "launches_per_step": want,
        "launches_timed_steps": timed_launches,
        "bit_identical_step0": identical, "batch0_loss": [loss0, eval0],
        "parity": parity,
    }
    log({"training": result})
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
    kernels = {"flash_fwd": phase_kernels(), "flash_bwd": phase_flash_bwd()}
    xent = phase_xent()
    serving = phase_serving()
    training = phase_training()
    timings = {"flash_fwd": kernels["flash_fwd"]["timing"],
               "flash_bwd": kernels["flash_bwd"]["timing"], **xent["timing"]}
    errors = {"flash_fwd": kernels["flash_fwd"]["max_abs_err"],
              "flash_bwd": kernels["flash_bwd"]["max_abs_err"], **xent["max_abs_err"]}
    launches = {"flash_fwd": serving["launches"]["flash_fwd"],
                **{k: v for k, v in training["launches_timed_steps"].items()
                   if k != "flash_fwd"}}
    sources = {
        "flash_fwd": ("edl_tpu_torch/ops/csrc/flash_fwd.cu", "edl_tpu/ops/flash_attention.py:203"),
        "flash_bwd": ("edl_tpu_torch/ops/csrc/flash_bwd.cu", "edl_tpu/ops/flash_attention.py:341"),
        "xent_fwd": ("edl_tpu_torch/ops/csrc/fused_xent.cu", "edl_tpu/ops/fused_xent.py:54"),
        "xent_dy": ("edl_tpu_torch/ops/csrc/fused_xent.cu", "edl_tpu/ops/fused_xent.py:151"),
        "xent_de": ("edl_tpu_torch/ops/csrc/fused_xent.cu", "edl_tpu/ops/fused_xent.py:188"),
    }
    line = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": errors[name],
        "ms": timings[name]["kernel_ms"],
        "plain_ms": timings[name]["plain_ms"],
        "bound_ms": timings[name]["bound_ms"],
        "bound_by": timings[name]["bound_by"],
        "library_ms": timings[name]["library_ms"],
    } for name, (source, replaces) in sources.items()]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
