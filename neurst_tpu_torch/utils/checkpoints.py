"""The JAX package's name-keyed checkpoints (the subset of
``neurst_tpu/utils/checkpoints.py`` that serving needs).

A checkpoint is a flat ``{path/to/param: ndarray}`` mapping stored as
``<model_dir>/ckpt-<step>.npz``, listed in ``checkpoint.json`` beside it.
Legacy files may hold bfloat16 arrays saved as raw void ``|V2`` bytes;
they are read back exactly as float32, and saves write float32.
"""

import json
import logging
import os
import re
from typing import Dict, List, Optional

import numpy as np

__all__ = ["flatten_params", "unflatten_params",
           "restore_checkpoint_params", "bf16_bytes_to_float32",
           "save_checkpoint", "list_checkpoints", "latest_checkpoint"]

_META_FILE = "checkpoint.json"


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


def _ckpt_path(model_dir, step):
    return os.path.join(model_dir, f"ckpt-{step}.npz")


def _read_meta(model_dir) -> dict:
    path = os.path.join(model_dir, _META_FILE)
    if not os.path.exists(path):
        return {"latest": None, "all": []}
    with open(path) as f:
        return json.load(f)


def _write_meta(model_dir, meta: dict):
    path = os.path.join(model_dir, _META_FILE)
    with open(path + ".tmp", "w") as f:
        json.dump(meta, f)
    os.replace(path + ".tmp", path)


def save_checkpoint(model_dir: str, step: int, params,
                    max_to_keep: Optional[int] = 8) -> str:
    """Saves params (a nested or flat name -> array mapping) as
    ``ckpt-<step>.npz`` in float32 (bfloat16 widened exactly), records
    the step in ``checkpoint.json`` and prunes all but the newest
    ``max_to_keep``.  Returns the path."""
    os.makedirs(model_dir, exist_ok=True)
    flat = {k: bf16_bytes_to_float32(np.asarray(v))
            for k, v in flatten_params(params).items()}
    path = _ckpt_path(model_dir, step)
    with open(path + ".tmp", "wb") as f:
        np.savez(f, **flat)
    os.replace(path + ".tmp", path)
    meta = _read_meta(model_dir)
    if step not in meta["all"]:
        meta["all"].append(step)
    meta["latest"] = step
    if max_to_keep and len(meta["all"]) > max_to_keep:
        for old in sorted(meta["all"])[:-max_to_keep]:
            meta["all"].remove(old)
            if os.path.exists(_ckpt_path(model_dir, old)):
                os.remove(_ckpt_path(model_dir, old))
    _write_meta(model_dir, meta)
    logging.info("Saved checkpoint %s", path)
    return path


def list_checkpoints(model_dir: str) -> List[int]:
    """The steps recorded in ``checkpoint.json`` and of any
    ``ckpt-<step>.npz`` in the directory, ascending."""
    steps = set(_read_meta(model_dir)["all"])
    if os.path.isdir(model_dir):
        for f in os.listdir(model_dir):
            m = re.match(r"^ckpt-(\d+)\.npz$", f)
            if m:
                steps.add(int(m.group(1)))
    return sorted(steps)


def latest_checkpoint(model_dir: Optional[str]) -> Optional[str]:
    """The path of the newest ``.npz`` checkpoint in ``model_dir``, or
    None."""
    if model_dir is None or not os.path.isdir(model_dir):
        return None
    step = _read_meta(model_dir).get("latest")
    if step is None:
        steps = list_checkpoints(model_dir)
        step = steps[-1] if steps else None
    if step is None or not os.path.exists(_ckpt_path(model_dir, step)):
        return None
    return _ckpt_path(model_dir, step)
