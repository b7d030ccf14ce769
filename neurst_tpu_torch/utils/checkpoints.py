"""Reading the JAX package's name-keyed checkpoints (the subset of
``neurst_tpu/utils/checkpoints.py`` that serving needs).

A checkpoint is a flat ``{path/to/param: ndarray}`` mapping stored as
``.npz``.  Legacy files may hold bfloat16 arrays saved as raw void
``|V2`` bytes; they are read back exactly as float32.
"""

from typing import Dict

import numpy as np

__all__ = ["flatten_params", "unflatten_params",
           "restore_checkpoint_params", "bf16_bytes_to_float32"]


def flatten_params(params, sep="/", prefix="") -> Dict[str, np.ndarray]:
    """Nested dict -> {path: leaf}."""
    out = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(flatten_params(v, sep, f"{prefix}{k}{sep}"))
    else:
        out[prefix[:-len(sep)]] = params
    return out


def unflatten_params(flat: Dict[str, np.ndarray], sep="/") -> dict:
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split(sep)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def bf16_bytes_to_float32(a: np.ndarray) -> np.ndarray:
    """bfloat16 (an extension dtype, or its raw ``|V2`` bytes) -> exact
    float32: a bf16 value is the high half of the float32 with the same
    value.  Other arrays are returned as they are."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        bits = np.ascontiguousarray(a).view(np.uint16).astype(np.uint32)
        return (bits << 16).view(np.float32)
    return a


def restore_checkpoint_params(path: str) -> Dict[str, np.ndarray]:
    """The flat name -> array mapping of a ``.npz`` checkpoint."""
    with np.load(path) as data:
        return {k: bf16_bytes_to_float32(data[k]) for k in data.files}
