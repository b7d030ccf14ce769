"""The JAX package's name-keyed checkpoints (the port's copy of
``neurst_tpu/utils/checkpoints.py``, npz format; ``ckpt-<step>.orbax``
directories, the sharded format, are read transparently through
``utils/orbax_checkpoints``, as in the JAX package).

A checkpoint is a flat ``{path/to/param: ndarray}`` mapping in the JAX
package's names and layouts (``utils/param_bridge``) stored as
``<model_dir>/ckpt-<step>.npz``, listed in ``checkpoint.json`` beside it.
Legacy files may hold bfloat16 arrays saved as raw void ``|V2`` bytes;
they are read back exactly as float32, and saves write float32.

The optimizer sidecar differs from the JAX package's on purpose: the port
writes ``ckpt-<step>.torch_optstate.npz``, the optimizer state flattened
by name (``opt_state_to_flat``: moments, accumulators and counts under
the port's parameter names, the bf16 params' float32 master, and the
train state's step).  It never writes the JAX package's ``.optstate``
(flax msgpack of an optax state), which it cannot read: a JAX trainer
given a directory the port wrote restores the parameters and starts a
fresh optimizer, its own behaviour without a sidecar.
"""

import json
import logging
import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["flatten_params", "unflatten_params",
           "restore_checkpoint_params", "bf16_bytes_to_float32",
           "save_checkpoint", "list_checkpoints", "latest_checkpoint",
           "restore_into", "average_checkpoints", "opt_state_to_flat",
           "load_opt_state", "sidecar_path", "JAX_SIDECAR_SUFFIX",
           "checkpoint_path", "save_opt_sidecar",
           "NameBasedCheckpointManager", "KeepBestCheckpointSaver",
           "AverageCheckpointSaver"]

SIDECAR_SUFFIX = ".torch_optstate.npz"
JAX_SIDECAR_SUFFIX = ".optstate"

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
    """The flat name -> array mapping of a ``.npz`` checkpoint, of a
    ``.orbax`` directory (read host-side and flattened, so every npz tool
    works on both) or of a model dir's newest checkpoint."""
    from neurst_tpu_torch.utils import orbax_checkpoints as orbax_lib
    if orbax_lib.is_orbax_checkpoint(path):
        return flatten_params(orbax_lib.restore_checkpoint_orbax(path))
    if os.path.isdir(path):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"No checkpoint found in {path}")
        return restore_checkpoint_params(found)
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


def sidecar_path(path: str) -> str:
    """The port's optimizer sidecar beside checkpoint ``path`` (``.npz``
    or ``.orbax``)."""
    return os.path.splitext(path)[0] + SIDECAR_SUFFIX


def save_opt_sidecar(path: str, opt_state: Dict[str, np.ndarray]):
    """The port's optimizer sidecar of checkpoint ``path``."""
    _savez(sidecar_path(path), opt_state)


def _savez(path: str, flat: Dict[str, np.ndarray]):
    with open(path + ".tmp", "wb") as f:
        np.savez(f, **flat)
    os.replace(path + ".tmp", path)


def save_checkpoint(model_dir: str, step: int, params,
                    max_to_keep: Optional[int] = 8,
                    opt_state: Optional[Dict[str, np.ndarray]] = None
                    ) -> str:
    """Saves params (a nested or flat name -> array mapping) as
    ``ckpt-<step>.npz`` in float32 (bfloat16 widened exactly), and
    ``opt_state`` (``opt_state_to_flat``'s mapping) as its sidecar;
    records the step in ``checkpoint.json`` and prunes all but the newest
    ``max_to_keep`` with their sidecars.  Returns the path."""
    os.makedirs(model_dir, exist_ok=True)
    path = _ckpt_path(model_dir, step)
    _savez(path, {k: bf16_bytes_to_float32(np.asarray(v))
                  for k, v in flatten_params(params).items()})
    if opt_state is not None:
        _savez(sidecar_path(path), opt_state)
    meta = _read_meta(model_dir)
    if step not in meta["all"]:
        meta["all"].append(step)
    meta["latest"] = step
    if max_to_keep and len(meta["all"]) > max_to_keep:
        for old in sorted(meta["all"])[:-max_to_keep]:
            meta["all"].remove(old)
            old_path = _ckpt_path(model_dir, old)
            for p in (old_path, sidecar_path(old_path)):
                if os.path.exists(p):
                    os.remove(p)
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


def checkpoint_path(model_dir: str, step: int) -> str:
    """The checkpoint of ``step``: ``ckpt-<step>.npz``, else its
    ``.orbax`` directory where only that exists."""
    path = _ckpt_path(model_dir, step)
    orbax = path[:-len(".npz")] + ".orbax"
    return orbax if not os.path.exists(path) and os.path.isdir(orbax) \
        else path


def latest_checkpoint(model_dir: Optional[str]) -> Optional[str]:
    """The path of the newest checkpoint in ``model_dir`` (``.npz``, or a
    ``.orbax`` directory in a sharded-format dir), or None."""
    if model_dir is None or not os.path.isdir(model_dir):
        return None
    step = _read_meta(model_dir).get("latest")
    if step is None:
        steps = list_checkpoints(model_dir)
        step = steps[-1] if steps else None
    if step is not None:
        path = checkpoint_path(model_dir, step)
        if os.path.exists(path):
            return path
    from neurst_tpu_torch.utils.orbax_checkpoints import \
        latest_orbax_checkpoint
    return latest_orbax_checkpoint(model_dir)


def restore_into(model: torch.nn.Module, flat: Dict[str, np.ndarray],
                 name_pattern: Optional[str] = None):
    """Name-based partial restore into ``model``'s parameters, in place:
    every parameter whose JAX flat name matches ``name_pattern`` (all
    without one) and is in ``flat`` with its shape is filled (in the
    parameter's dtype).  Scan-stacked checkpoints (the MoE block scan's
    too) are read per layer.  Returns (restored, missing): JAX flat names filled, and those matched
    but left as they were."""
    from neurst_tpu_torch.utils.param_bridge import (flat_to_state_dict,
                                                     state_dict_to_flat,
                                                     unstack_scan_layers)
    pattern = re.compile(name_pattern) if name_pattern else None
    source = unstack_scan_layers(flat)
    target = state_dict_to_flat(model)
    restored, missing = [], []
    for name, current in target.items():
        if pattern and not pattern.search(name):
            continue
        value = source.get(name)
        if value is None:
            missing.append(name)
            continue
        value = bf16_bytes_to_float32(np.asarray(value)).astype(np.float32)
        if value.shape != current.shape:
            logging.warning("Shape mismatch for %s: ckpt %s vs model %s",
                            name, value.shape, current.shape)
            missing.append(name)
            continue
        target[name] = value
        restored.append(name)
    model.load_state_dict(flat_to_state_dict(target, model))
    if missing:
        logging.info("Unrestored parameters (%d): %s", len(missing),
                     missing[:10])
    logging.info("Restored %d/%d parameters", len(restored), len(target))
    return restored, missing


def average_checkpoints(paths: List[str]) -> Dict[str, np.ndarray]:
    """The element-wise mean of flat checkpoints (float64 sums, float32
    result)."""
    acc: Dict[str, np.ndarray] = {}
    for p in paths:
        flat = restore_checkpoint_params(p)
        if not acc:
            acc = {k: v.astype(np.float64) for k, v in flat.items()}
        else:
            for k in acc:
                acc[k] += flat[k]
    return {k: (v / len(paths)).astype(np.float32) for k, v in acc.items()}


def _state_leaves(state, prefix=""):
    """(key, leaf) pairs of a nested optimizer state (dicts by key,
    tuples and lists by index; tensors and numbers are leaves)."""
    if isinstance(state, dict):
        for k, v in state.items():
            yield from _state_leaves(v, f"{prefix}{k}/")
    elif isinstance(state, (tuple, list)):
        for i, v in enumerate(state):
            yield from _state_leaves(v, f"{prefix}{i}/")
    elif state is not None:
        yield prefix[:-1], state


def opt_state_to_flat(opt_state, step: int) -> Dict[str, np.ndarray]:
    """An optimizer state as a flat name -> numpy mapping (tensors as
    float32 or their integer dtype, counts as int64 scalars), with the
    train state's ``step`` under "step"."""
    flat = {"step": np.asarray(step, np.int64)}
    for key, leaf in _state_leaves(opt_state, "opt_state/"):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            flat[key] = (leaf.float() if leaf.is_floating_point()
                         else leaf).cpu().numpy()
        else:
            flat[key] = np.asarray(leaf)
    return flat


def load_opt_state(opt_state, flat: Dict[str, np.ndarray]):
    """Fills ``opt_state`` (a fresh state of the same transformation) from
    ``opt_state_to_flat``'s mapping: tensors in place, counts replaced.
    Returns (state, step).  Raises on a missing or unknown key and on a
    shape mismatch: the sidecar belongs to another optimizer."""
    used = {"step"}

    def fill(node, prefix):
        if isinstance(node, dict):
            return {k: fill(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(fill(v, f"{prefix}{i}/")
                              for i, v in enumerate(node))
        if node is None:
            return None
        key = prefix[:-1]
        if key not in flat:
            raise KeyError(f"optimizer sidecar lacks {key}")
        used.add(key)
        value = np.asarray(flat[key])
        if isinstance(node, torch.Tensor):
            if tuple(value.shape) != tuple(node.shape):
                raise ValueError(f"optimizer sidecar {key}: shape "
                                 f"{value.shape}, state {tuple(node.shape)}")
            with torch.no_grad():
                node.copy_(torch.from_numpy(value))
            return node
        return type(node)(value.item())

    state = fill(opt_state, "opt_state/")
    unknown = sorted(set(flat) - used)
    if unknown:
        raise KeyError(f"optimizer sidecar holds keys this optimizer does "
                       f"not have: {unknown[:10]}")
    return state, int(flat["step"])


class NameBasedCheckpointManager(object):
    """Saves and restores a model's checkpoints in ``model_dir``."""

    def __init__(self, model_dir: str, max_to_keep: int = 8):
        self._model_dir = model_dir
        self._max_to_keep = max_to_keep

    @property
    def model_dir(self):
        return self._model_dir

    def save(self, step: int, params, opt_state=None):
        return save_checkpoint(self._model_dir, step, params,
                               self._max_to_keep, opt_state)

    def restore(self, model: torch.nn.Module):
        """Restores the newest checkpoint into ``model``: None without
        one, else {"step", "path", "restored", "missing"}."""
        from neurst_tpu_torch.utils.compat import hack_global_step
        path = latest_checkpoint(self._model_dir)
        if path is None:
            return None
        restored, missing = restore_into(model,
                                         restore_checkpoint_params(path))
        return {"step": hack_global_step(os.path.splitext(path)[0]),
                "path": path, "restored": restored, "missing": missing}


def _flat_float32(params) -> Dict[str, np.ndarray]:
    return {k: bf16_bytes_to_float32(np.asarray(v)).astype(np.float32)
            for k, v in flatten_params(params).items()}


class KeepBestCheckpointSaver(object):
    """Keeps the ``max_to_keep`` best checkpoints by ``metric`` in
    ``model_dir/subdir``, their values in ``metrics.json``."""

    def __init__(self, model_dir: str, metric, max_to_keep: int = 8,
                 subdir: str = "best"):
        self._dir = os.path.join(model_dir, subdir)
        os.makedirs(self._dir, exist_ok=True)
        self._metric = metric
        self._max_to_keep = max_to_keep
        self._records_file = os.path.join(self._dir, "metrics.json")
        self._records = {}
        if os.path.exists(self._records_file):
            with open(self._records_file) as f:
                self._records = {int(k): v for k, v in json.load(f).items()}

    def save(self, step: int, params, metric_value: float) -> bool:
        worst = None
        if len(self._records) >= self._max_to_keep:
            greater = self._metric.greater_or_eq(1.0, 0.0)
            worst = min(self._records.items(),
                        key=lambda kv: kv[1] if greater else -kv[1])
            if not self._metric.greater_or_eq(metric_value, worst[1]):
                return False
        save_checkpoint(self._dir, step, params, max_to_keep=None)
        self._records[step] = float(metric_value)
        if worst is not None:
            self._records.pop(worst[0], None)
            p = _ckpt_path(self._dir, worst[0])
            if os.path.exists(p):
                os.remove(p)
        with open(self._records_file, "w") as f:
            json.dump(self._records, f)
        return True


class AverageCheckpointSaver(object):
    """Keeps a window of the last ``max_to_keep`` evaluated weights and
    writes their mean to ``model_dir/subdir`` whenever the metric is at
    least as good as the best so far."""

    def __init__(self, model_dir: str, metric, max_to_keep: int = 8,
                 subdir: str = "best_avg"):
        self._dir = os.path.join(model_dir, subdir)
        os.makedirs(self._dir, exist_ok=True)
        self._metric = metric
        self._max_to_keep = max_to_keep
        self._window: Dict[int, Dict[str, np.ndarray]] = {}
        self._best: Optional[float] = None

    def save(self, step: int, params, metric_value: float) -> bool:
        flat = _flat_float32(params)
        self._window[step] = flat
        if len(self._window) > self._max_to_keep:
            del self._window[min(self._window)]
        if self._best is not None and not self._metric.greater_or_eq(
                metric_value, self._best):
            return False
        self._best = metric_value
        avg = {k: np.mean([w[k].astype(np.float64)
                           for w in self._window.values()],
                          axis=0).astype(np.float32) for k in flat}
        save_checkpoint(self._dir, step, avg, max_to_keep=2)
        return True
