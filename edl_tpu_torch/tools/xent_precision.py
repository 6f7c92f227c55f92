"""The cross-entropy gradient kernels against a float64 evaluation, row
by row, on the card.

    python -m edl_tpu_torch.tools.xent_precision [--seeds 5] [--n 300] [--v 1001]

For each gradient kernel (B5 ``xent_dy``, B6 ``xent_de``), each width
in ``--dims`` and each feature scale in ``--scales`` (1.0 is unit bf16
features; the card tests also use 0.1), it runs the kernel and its
plain version on the same seeded inputs and holds both against the
float64 evaluation of the same function (``float64_grads``): logits in
float64 from the bf16 operands, ``dL = (exp(logit - lse) - onehot) *
row_scale`` in float64, not rounded to bf16, the product in float64.
Each result is the row error of ``row_errors``: per output row,
``|got - ref|`` over ``|ref|`` floored at 1e-3 of the largest row (the
row check of ``chip_smoke.py`` and the card tests).  Prints one JSON
line per case (the worst row of each seed, with its share of the
largest row and whether its dL is dominated by a label that is also
its row's argmax) and a last line with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from edl_tpu_torch.ops import fused_xent as fx

#: rows under this share of the largest row are held against it
ROW_FLOOR = 1e-3


def xent_inputs(g: torch.Generator, n: int, v: int, d: int, scale: float):
    """Seeded inputs on ``g``'s device: features ``y`` (N(0, scale^2),
    bf16), embedding ``e`` (N(0, 1), bf16), labels (row 1 out of range),
    row scales (every 7th row 0), and the plain version's lse."""
    dev = g.device
    y = (torch.randn((n, d), generator=g, device=dev) * scale).to(torch.bfloat16)
    e = torch.randn((v, d), generator=g, device=dev).to(torch.bfloat16)
    labels = torch.randint(0, v, (n,), generator=g, device=dev, dtype=torch.int32)
    if n > 1:
        labels[1] = v
    row_scale = torch.rand((n,), generator=g, device=dev) / n
    row_scale[::7] = 0.0
    lse = fx.xent_fwd_plain(y, e, labels)[0]
    return y, e, labels, lse, row_scale


def float64_grads(y, e, labels, lse, row_scale):
    """``(dY, dE)`` of the fused cross entropy in float64, with dL not
    rounded to bf16."""
    logits = y.double() @ e.double().t()
    p = torch.exp(logits - lse.double()[:, None])
    lab = labels.long()
    ok = (lab >= 0) & (lab < e.shape[0])
    rows = torch.arange(lab.shape[0], device=lab.device)[ok]
    p[rows, lab[ok]] -= 1.0
    dl = p * row_scale.double()[:, None]
    return dl @ e.double(), dl.t() @ y.double()


def row_errors(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per row: ``|got - ref| / max(|ref|, ROW_FLOOR * max |ref|)``."""
    ref = ref.double()
    norm = ref.norm(dim=-1)
    floor = ROW_FLOOR * norm.max().clamp_min(1e-300)
    return (got.double() - ref).norm(dim=-1) / torch.maximum(norm, floor)


#: log2(e) as the kernels hold it (float32)
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32).item()


def emulated_dl(y, e, labels, lse, row_scale, subtract_first: bool) -> torch.Tensor:
    """dL from the plain version's float32 logits by one of two float32
    formulas of the exponent, each rounding as the card does (rounded to
    bf16): ``fma(s, LOG2E, -(lse * LOG2E))`` with ``lse * LOG2E``
    rounded to float32, or ``(s - lse) * LOG2E`` (subtract first)."""
    s = fx._logits(y, e).double()
    lse = lse.double()[:, None]
    if subtract_first:
        x = ((s - lse).float().double() * LOG2E).float()
    else:
        x = (s * LOG2E - (lse * LOG2E).float().double()).float()
    p = torch.exp2(x.double())
    lab = labels.long()
    ok = (lab >= 0) & (lab < e.shape[0])
    rows = torch.arange(lab.shape[0], device=lab.device)[ok]
    p[rows, lab[ok]] -= 1.0
    return (p * row_scale.double()[:, None]).to(torch.bfloat16).double()


def _argmax_label_rows(y, e, labels) -> torch.Tensor:
    """Rows whose label is their argmax (by float64 logits)."""
    logits = y.double() @ e.double().t()
    return logits.argmax(dim=1) == labels.long()


def measure(kernel: str, n: int, v: int, d: int, scale: float, seed: int) -> dict:
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    y, e, labels, lse, rs = xent_inputs(g, n, v, d, scale)
    run, plain = {"xent_dy": (fx.xent_dy_cuda, fx.xent_dy_plain),
                  "xent_de": (fx.xent_de_cuda, fx.xent_de_plain)}[kernel]
    got = run(y, e, labels, lse, rs)
    torch.cuda.synchronize()
    want = plain(y, e, labels, lse, rs)
    ref = float64_grads(y, e, labels, lse, rs)[0 if kernel == "xent_dy" else 1]
    k_err, p_err = row_errors(got, ref), row_errors(want, ref)
    kp_err = row_errors(got, want.double())
    worst = int(k_err.argmax())
    hits = _argmax_label_rows(y, e, labels) & (rs > 0)
    if kernel == "xent_dy":
        ill = bool(hits[worst])
    else:  # vocab row `worst` is the label and argmax of some scaled row
        ill = bool((labels.long()[hits] == worst).any())
    norm = ref.norm(dim=-1)
    emulated = {}
    for name, first in (("exp2_fma", False), ("exp2_subtract_first", True)):
        dl = emulated_dl(y, e, labels, lse, rs, first)
        x = dl @ e.double() if kernel == "xent_dy" else dl.t() @ y.double()
        emulated[name] = row_errors(x, ref).max().item()
    return {
        "kernel": kernel, "N": n, "V": v, "D": d, "feature_scale": scale, "seed": seed,
        "kernel_vs_f64": k_err.max().item(), "plain_vs_f64": p_err.max().item(),
        "kernel_vs_plain": kp_err.max().item(),
        "worst_row": worst, "worst_row_share_of_largest": (norm[worst] / norm.max()).item(),
        "worst_row_plain_vs_f64": p_err[worst].item(),
        "worst_row_is_label_argmax": ill,
        "label_argmax_rows": int(hits.sum()),
        "emulated_formula_vs_f64": emulated,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kernels", default="xent_de,xent_dy")
    p.add_argument("--dims", default="768,1024")
    p.add_argument("--scales", default="1.0,0.1")
    p.add_argument("--n", type=int, default=300)
    p.add_argument("--v", type=int, default=1001)
    p.add_argument("--seeds", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("xent_precision measures the card's kernels; no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    for kernel in args.kernels.split(","):
        for d in (int(x) for x in args.dims.split(",")):
            for scale in (float(x) for x in args.scales.split(",")):
                rows = [measure(kernel, args.n, args.v, d, scale, s) for s in range(args.seeds)]
                for r in rows:
                    print(json.dumps(r), flush=True)
                print(json.dumps({"summary": {
                    "kernel": kernel, "D": d, "feature_scale": scale,
                    "kernel_vs_f64_max": max(r["kernel_vs_f64"] for r in rows),
                    "plain_vs_f64_max": max(r["plain_vs_f64"] for r in rows),
                    "kernel_vs_plain_max": max(r["kernel_vs_plain"] for r in rows),
                }}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.stdout.strip()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
