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

Everything here reads and writes local files only.  The corpus
ingesters (``read_idx``, ``ingest_mnist_idx``, ``ingest_tokens``,
behind the CLI's ``ingest``) write the same stores as the JAX
package's: a corpus staged by either loads in both.
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


# -- real-corpus ingestion ---------------------------------------------------

#: IDX dtype codes (the MNIST distribution format,
#: http://yann.lecun.com/exdb/mnist/ — a magic of 0x00 0x00 <dtype>
#: <ndim>, big-endian uint32 dims, then row-major data).
_IDX_DTYPES = {
    0x08: np.uint8,
    0x09: np.int8,
    0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"),
    0x0D: np.dtype(">f4"),
    0x0E: np.dtype(">f8"),
}


def read_idx(path: str) -> np.ndarray:
    """Parse one IDX file (optionally .gz) into a numpy array."""
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    if len(raw) < 4 or raw[0] != 0 or raw[1] != 0:
        raise ValueError(f"{path!r} is not an IDX file (bad magic)")
    code, ndim = raw[2], raw[3]
    if code not in _IDX_DTYPES:
        raise ValueError(f"{path!r}: unknown IDX dtype code 0x{code:02x}")
    dims = np.frombuffer(raw, ">u4", count=ndim, offset=4)
    dtype = _IDX_DTYPES[code]
    start = 4 + 4 * ndim
    want = int(np.prod(dims)) if ndim else 0
    avail = (len(raw) - start) // np.dtype(dtype).itemsize
    if avail < want:
        # Checked up front: frombuffer's own error names no file.
        raise ValueError(
            f"{path!r}: truncated IDX payload ({avail} of {want} items)"
        )
    data = np.frombuffer(raw, dtype, count=want, offset=start)
    return data.reshape(tuple(int(d) for d in dims))


def _sha256(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def ingest_mnist_idx(
    out_path: str, images_path: str, labels_path: str
) -> str:
    """Ingest a real MNIST-format corpus (IDX image + label files, the
    BASELINE config-2 dataset) into an array store matching the
    ``mnist`` model's batch contract: ``image`` [N, 28, 28, 1] float32
    in [0, 1], ``label`` [N] int32.  The source files' sha256 checksums
    land in the manifest's provenance block, so a staged store is
    auditable back to the exact bytes it came from."""
    imgs = read_idx(images_path)
    labs = read_idx(labels_path)
    if imgs.ndim != 3:
        raise ValueError(
            f"images IDX must be [N, rows, cols]; got shape {imgs.shape}"
        )
    if labs.ndim != 1 or len(labs) != len(imgs):
        raise ValueError(
            f"labels IDX must be [N={len(imgs)}]; got shape {labs.shape}"
        )
    image = (imgs.astype(np.float32) / 255.0)[..., None]
    label = labs.astype(np.int32)
    return save_array_store(
        out_path,
        {"image": image, "label": label},
        provenance={
            "format": "mnist-idx",
            "images": os.path.basename(images_path),
            "images_sha256": _sha256(images_path),
            "labels": os.path.basename(labels_path),
            "labels_sha256": _sha256(labels_path),
        },
    )


def ingest_tokens(
    out_path: str, tokens_path: str, seq_len: int, key: str = "tokens"
) -> str:
    """Ingest a tokenized text corpus — a flat binary/.npy array of
    token ids — into fixed-length rows of ``seq_len + 1`` (input +
    shifted-label convention of the LM families).  Leftover tokens past
    the last full row are dropped.  Accepts ``.npy`` or raw little-
    endian uint16/uint32 binary (``.bin`` with dtype inferred from
    size alignment is ambiguous, so raw files must be ``.u16``/
    ``.u32``)."""
    if tokens_path.endswith(".npy"):
        flat = np.load(tokens_path, mmap_mode="r")
    elif tokens_path.endswith(".u16"):
        flat = np.fromfile(tokens_path, "<u2")
    elif tokens_path.endswith(".u32"):
        flat = np.fromfile(tokens_path, "<u4")
    else:
        raise ValueError(
            f"unknown token file type {tokens_path!r} (.npy/.u16/.u32)"
        )
    if flat.ndim != 1:
        raise ValueError(f"token corpus must be flat; got {flat.shape}")
    if not np.issubdtype(flat.dtype, np.integer):
        raise ValueError(
            f"token corpus must hold integer ids; got dtype {flat.dtype} "
            "(a float corpus would silently truncate under astype)"
        )
    if flat.size and int(flat.max()) >= 2**31:
        raise ValueError(
            "token ids exceed int32 range; they would wrap negative and "
            "gather garbage embeddings"
        )
    if flat.size and int(flat.min()) < 0:
        raise ValueError(
            "token corpus contains negative ids (ignore-index sentinels "
            "like -100?); strip them before staging — a negative gather "
            "index trains on garbage embedding rows"
        )
    row = seq_len + 1
    n = len(flat) // row
    if n == 0:
        raise ValueError(
            f"corpus has {len(flat)} tokens, fewer than one {row}-token row"
        )
    rows = np.asarray(flat[: n * row]).reshape(n, row).astype(np.int32)
    return save_array_store(
        out_path,
        {key: rows},
        provenance={
            "format": "tokens",
            "source": os.path.basename(tokens_path),
            "source_sha256": _sha256(tokens_path),
            "seq_len": str(seq_len),
            "dropped_tokens": str(len(flat) - n * row),
        },
    )


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
