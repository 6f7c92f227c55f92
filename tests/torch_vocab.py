"""The JAX control plane's vocabulary mapped onto the port's, for the
parity tests of ``edl_tpu_torch``'s resource, cluster, autoscaler and
controller modules (``test_torch_resource.py``,
``test_torch_autoscaler.py``, ``test_torch_controller.py``).

``tpu_to_gpu`` maps any JSON-shaped value (a manifest, a dataclass as a
dict, an error message) from the JAX package's words to the port's:

- ``v5e-N`` -> ``h100-N``, and a node's ICI-mesh label (``2x4``) -> the
  topology of that many GPUs (``h100-8``);
- ``google.com/tpu`` -> ``nvidia.com/gpu``;
- ``tpu_*`` fields -> ``gpu_*`` (``tpu_chips`` -> ``gpus``, the
  normalized limit ``tpu`` -> ``gpu``);
- the TPU nodeSelector -> the GPU one;
- ``EDL_JAX_COORD_PORT`` -> ``EDL_DIST_PORT`` (the ``jaxcoord`` port is
  ``dist``), and the pod-env keys the port's launcher does not read
  (``EDL_PARALLELISM``, ``EDL_COMPILE_CACHE_DIR``, ``EDL_SHARD_ONLY``,
  ``EDL_NAMESPACE``) dropped;
- the image name and the module paths in pod commands;
- the few words of the error messages (``chips`` -> ``GPUs``).
"""

import dataclasses
import enum
import re

#: pod-env keys the JAX package renders and the port does not
DROPPED_ENV = {"EDL_PARALLELISM", "EDL_COMPILE_CACHE_DIR", "EDL_SHARD_ONLY", "EDL_NAMESPACE"}
#: a v5e slice's 2D ICI mesh -> its chip count
ICI_MESH = {"1x1": 1, "2x2": 4, "2x4": 8, "4x4": 16, "4x8": 32, "8x8": 64}
_KEYS = {"tpu_chips": "gpus", "tpu": "gpu", "google.com/tpu": "nvidia.com/gpu"}
_TEXT = [
    (re.compile(r"google\.com/tpu"), "nvidia.com/gpu"),
    (re.compile(r"\bv5e-(\d+)"), r"h100-\1"),
    (re.compile(r"edl-tpu/trainer"), "edl-tpu-torch/trainer"),
    (re.compile(r"EDL_JAX_COORD_PORT"), "EDL_DIST_PORT"),
    (re.compile(r"^jaxcoord$"), "dist"),
    (re.compile(r"\bedl_tpu\."), "edl_tpu_torch."),
    (re.compile(r"unknown TPU slice topology"), "unknown GPU replica topology"),
    (re.compile(r"slice chips"), "replica GPUs"),
    (re.compile(r" chips\)"), " GPUs)"),
]
_TPU_SELECTOR = "cloud.google.com/gke-tpu-accelerator"


def _key(k):
    if not isinstance(k, str):
        return k
    if k in _KEYS:
        return _KEYS[k]
    if k.startswith("tpu_"):
        return "gpu_" + k[4:]
    return k


def _text(s: str) -> str:
    if s in ICI_MESH:
        return f"h100-{ICI_MESH[s]}"
    for pat, rep in _TEXT:
        s = pat.sub(rep, s)
    return s


def tpu_to_gpu(obj):
    """The JAX-vocabulary value ``obj`` in the port's vocabulary (see the
    module docstring).  Dataclasses map as their ``asdict``."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = dataclasses.asdict(obj)
    if isinstance(obj, dict):
        if _TPU_SELECTOR in obj:
            return {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
        return {_key(k): tpu_to_gpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        out = [
            tpu_to_gpu(v)
            for v in obj
            if not (isinstance(v, dict) and v.get("name") in DROPPED_ENV)
        ]
        return type(obj)(out) if isinstance(obj, tuple) else out
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, str):
        return _text(obj)
    return obj
