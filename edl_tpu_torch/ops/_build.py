"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface (the
kernels share the helpers of ``csrc/*.cuh``).  At first
use ``nvcc`` compiles it for Hopper (``sm_90a``) into a shared library
under ``build/kernels/`` at the repository root (git-ignored), and
``ctypes`` loads it.  The library's file name carries a hash of the
source, the local headers it includes and the flags, so an edited
source or header never loads a stale build, and a header edit rebuilds
only the kernels that include it.
Only the sources in the repository are compiled; nothing is fetched.

``build()`` starts one ``nvcc`` per source, all at once, and waits for
them together, so the build time is that of the slowest kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

#: every kernel source of the port, by name (``csrc/<name>.cu``)
KERNELS = ("flash_fwd", "flash_bwd", "flash_bwd_streamk", "xent_fwd", "xent_dy", "xent_de")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, Callable[..., int]] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``,
    ``/usr/local/cuda/bin/nvcc`` or ``nvcc`` on PATH."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the port's kernels are built "
        "from source at first use"
    )


#: a local ``#include "x.cuh"`` line of a kernel source
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _source_bytes(path: Path, seen: set) -> bytes:
    """``path`` followed by every local header it includes, recursively,
    each once."""
    text = path.read_bytes()
    out = [text]
    for inc in _LOCAL_INCLUDE.findall(text):
        header = path.parent / inc.decode()
        if header not in seen:
            seen.add(header)
            out.append(_source_bytes(header, seen))
    return b"".join(out)


def library_path(name: str) -> Path:
    src = _source_bytes(CSRC / f"{name}.cu", set())
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel that has no current build, all
    ``nvcc`` processes started together.  Returns the wall seconds of
    the whole build per name (0.0 for one already built).  Raises with
    the compiler's output when any fails; the ``-Xptxas -v`` report of
    each build lands beside its library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {}
    for name in names:
        out = library_path(name)
        if not out.exists():
            todo[name] = out
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
            ),
            tmp,
            out,
        )
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_name(out.name + ".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    dt = time.perf_counter() - t0
    return {name: (dt if name in todo else 0.0) for name in names}


def build_log(name: str) -> str:
    """The compiler's report (registers, shared memory, spills) of the
    current build of ``name``; empty when it has not been built here."""
    p = library_path(name)
    p = p.with_name(p.name + ".log")
    return p.read_text(errors="replace") if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if
    needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def entry(name: str, symbol: str, argtypes: Sequence) -> Callable[..., int]:
    """C function ``symbol`` of kernel ``name``'s library, declared with
    ``argtypes`` and returning its ``cudaError_t`` as an int."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn
