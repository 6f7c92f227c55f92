"""The port stands alone: it imports with JAX and the JAX package
blocked, none of its files (nor ``chip_smoke.py``) imports them, and
its entry points ask for CUDA unless told otherwise."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "edl_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "edl_tpu"}


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_module_imports_with_jax_and_edl_tpu_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'edl_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import edl_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(edl_tpu_torch.__path__, 'edl_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'edl_tpu_torch.serving.server' in names, names\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip().splitlines()[-1]) >= 15


def test_no_port_file_imports_jax_flax_optax_or_edl_tpu():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in FORBIDDEN:
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {n}")
    assert not bad, bad


def test_entry_points_default_to_cuda(monkeypatch):
    """Given no device, entry points ask for CUDA; where it is absent
    they raise rather than run on the CPU."""
    from edl_tpu_torch import resolve_device
    from edl_tpu_torch.models import get_model
    from edl_tpu_torch.runtime import Trainer
    from edl_tpu_torch.serving import DecodeEngine, InferenceEngine, KVBlockPool
    from edl_tpu_torch.serving.server import build_replica

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = get_model("transformer_lm", tiny=True)
    for make in (
        resolve_device,
        lambda: DecodeEngine(model),
        lambda: InferenceEngine(model),
        lambda: KVBlockPool(1, 1, 16, 2, 16, torch.bfloat16),
        lambda: build_replica("transformer_lm", tiny=True),
        lambda: Trainer(model),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA the script exits non-zero and prints no result —
    and alone in a directory (without the package) it fails too."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=str(ROOT),
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env.pop("PYTHONPATH")
    r = subprocess.run(
        [sys.executable, str(alone)], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
