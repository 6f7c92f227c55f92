"""File-backed datasets: memory-mapped array stores on disk (a copy of
``edl_tpu/runtime/datasets.py``).

An **array store** is a directory of ``.npy`` files (one per feature)
plus a JSON manifest, and loading it memory-maps every array so
trainers stream real bytes from disk without materializing the dataset
in RAM.  A memmapped store plugs straight into ``ShardedDataIterator``
— batch assembly fancy-indexes the maps, so only the touched rows are
ever paged in — which preserves the (seed, step) -> indices
determinism the elastic protocol depends on: a resize re-slices the
same global batch stream whether the bytes live in RAM or on disk.

Everything here reads and writes local files only.  The JAX package's
corpus ingesters (``read_idx``, ``ingest_mnist_idx``, ``ingest_tokens``,
behind its ``edl ingest`` command) are not ported yet; a corpus staged
by them loads here unchanged.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

MANIFEST = "manifest.json"


def save_array_store(
    path: str,
    arrays: Dict[str, np.ndarray],
    seed: Optional[int] = None,
    provenance: Optional[Dict[str, str]] = None,
) -> str:
    """Write ``arrays`` (shared leading dim) as ``<key>.npy`` files plus
    a manifest.  Atomic enough for the single-writer staging pattern:
    the manifest is written last, so a crashed half-written store fails
    ``load_array_store`` loudly instead of loading short arrays.

    ``provenance``: optional source metadata recorded in the manifest
    (e.g. the ingester's per-source-file sha256 checksums) so a staged
    corpus is auditable back to its bytes."""
    if not arrays:
        raise ValueError("array store needs at least one array")
    sizes = {k: len(v) for k, v in arrays.items()}
    if len(set(sizes.values())) != 1:
        raise ValueError(f"arrays disagree on leading dim: {sizes}")
    os.makedirs(path, exist_ok=True)
    # Invalidate any existing store FIRST: a crash mid-restage must
    # leave a store that fails load loudly, never an old manifest
    # validating a mix of old and new .npy files.
    try:
        os.remove(os.path.join(path, MANIFEST))
    except FileNotFoundError:
        pass
    meta = {"n": next(iter(sizes.values())), "arrays": {}, "seed": seed}
    if provenance:
        meta["provenance"] = dict(provenance)
    for key, v in arrays.items():
        if "/" in key or key.startswith("."):
            raise ValueError(f"bad array key {key!r}")
        np.save(os.path.join(path, f"{key}.npy"), np.asarray(v))
        meta["arrays"][key] = {
            "shape": list(v.shape),
            "dtype": str(np.asarray(v).dtype),
        }
    tmp = os.path.join(path, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    os.replace(tmp, os.path.join(path, MANIFEST))
    return path


def load_array_store(path: str, mmap: bool = True) -> Dict[str, np.ndarray]:
    """Load a store as a dict of (by default) memory-mapped arrays,
    validated against the manifest — shape/dtype drift between staging
    and training fails here, not as a silent garbage batch."""
    mpath = os.path.join(path, MANIFEST)
    if not os.path.exists(mpath):
        raise FileNotFoundError(
            f"{path!r} is not an array store (no {MANIFEST}); stage one "
            "with save_array_store"
        )
    with open(mpath) as f:
        meta = json.load(f)
    out: Dict[str, np.ndarray] = {}
    for key, info in meta["arrays"].items():
        v = np.load(
            os.path.join(path, f"{key}.npy"),
            mmap_mode="r" if mmap else None,
        )
        if list(v.shape) != info["shape"] or str(v.dtype) != info["dtype"]:
            raise ValueError(
                f"array {key!r} drifted from manifest: "
                f"{v.shape}/{v.dtype} != {info['shape']}/{info['dtype']}"
            )
        out[key] = v
    return out


def validate_for_model(dataset: Dict[str, np.ndarray], model) -> None:
    """Fail fast — before any compile — when a store doesn't match the
    batches the model's loss reads (a mismatch otherwise surfaces as a
    bare ``KeyError`` or an opaque shape error deep inside the step).  The model's own ``synth_batch`` is the shape/dtype
    contract: per-feature trailing dims and dtype must agree."""
    ref = model.synth_batch(np.random.RandomState(0), 1)
    missing = set(ref) - set(dataset)
    if missing:
        raise ValueError(
            f"array store lacks features {sorted(missing)} required by "
            f"model {model.name!r} (store has {sorted(dataset)})"
        )
    for key, want in ref.items():
        got = dataset[key]
        if got.shape[1:] != want.shape[1:]:
            raise ValueError(
                f"array store feature {key!r} has per-example shape "
                f"{tuple(got.shape[1:])}; model {model.name!r} expects "
                f"{tuple(want.shape[1:])}"
            )
        if np.asarray(got).dtype != np.asarray(want).dtype:
            raise ValueError(
                f"array store feature {key!r} has dtype {got.dtype}; "
                f"model {model.name!r} expects {np.asarray(want).dtype}"
            )


def stage_synthetic(
    path: str, model_synth_batch, n_examples: int, seed: int = 0
) -> str:
    """Stage a model's deterministic synthetic dataset to disk — the
    zero-download stand-in for a real corpus that still exercises the
    full file-backed path (mmap -> fancy-index -> device)."""
    rng = np.random.RandomState(seed)
    return save_array_store(path, model_synth_batch(rng, n_examples), seed=seed)


def resolve_dataset(
    model, data_dir: str, n_examples: int
) -> Dict[str, np.ndarray]:
    """The one dataset-resolution path every entrypoint shares:
    ``data_dir`` set -> memory-mapped store validated against the
    model; empty -> the model's synthetic data (``n_examples`` rows,
    seed 0 — the staging default, so a staged copy of the synthetic
    set trains bit-identically to the in-memory one)."""
    if data_dir:
        dataset = load_array_store(data_dir)
        validate_for_model(dataset, model)
        return dataset
    from edl_tpu_torch.runtime.data import synthetic_dataset

    return synthetic_dataset(model.synth_batch, n_examples)
