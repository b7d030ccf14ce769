"""The orbax checkpoint format (the port's counterpart of
``neurst_tpu/utils/orbax_checkpoints.py``), read and written through the
port's own OCDBT store (``utils/ocdbt``), zarr v2 arrays
(``utils/zarr``) and zstd decoder (``utils/zstd``): it imports neither
orbax, tensorstore nor JAX.

A checkpoint is a directory ``ckpt-<step>.orbax`` as orbax 0.11's
``StandardCheckpointer`` writes it: ``_METADATA`` (the tree's key paths
with each leaf's type, ``use_ocdbt`` true, ``use_zarr3`` false),
``_CHECKPOINT_METADATA``, and an OCDBT store whose root manifest refers
to the stores of the processes that wrote (``ocdbt.process_<rank>``), in
which each array ``a.b.c`` (its key path joined by ".") is a zarr array.
A tree is nested dicts of arrays; the port's flat ``a/b/c`` names are its
key paths.  Every array is written as the JAX package's array
(``value_type`` "jax.Array", uncompressed chunks) and read back as numpy
(bfloat16 as float32, exactly).

Several ranks write one checkpoint with ``save_tree``: each rank writes
the chunks it owns (``Leaf.blocks``) into its own process store, and
after a barrier rank 0 writes the root manifest over them, the metadata,
the step in ``checkpoint.json`` and the pruning of old
``ckpt-<step>.orbax`` / ``.optstate.orbax`` dirs, as the JAX function
does on process 0.
"""

import json
import logging
import os
import re
import shutil
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from neurst_tpu_torch.utils import ocdbt
from neurst_tpu_torch.utils import zarr as zarr_lib

__all__ = ["save_checkpoint_orbax", "save_checkpoint_orbax_raw",
           "restore_checkpoint_orbax", "latest_orbax_checkpoint",
           "is_orbax_checkpoint", "Leaf", "save_tree", "read_tree",
           "whole_leaves"]


class Leaf(NamedTuple):
    """An array of a checkpoint: its key path, shape, zarr dtype and chunk
    shape, and the chunks this rank writes ({chunk index: block})."""
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    dtype: str
    chunks: Tuple[int, ...]
    blocks: Dict[Tuple[int, ...], np.ndarray]


def _as_numpy(value) -> Tuple[np.ndarray, str]:
    """(numpy array, zarr dtype) of an array or tensor (a bfloat16 tensor
    as its bits)."""
    if hasattr(value, "detach"):  # a torch tensor
        import torch
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            return value.view(torch.int16).numpy().view(np.uint16), \
                "bfloat16"
        value = value.numpy()
    value = np.asarray(value)
    return value, zarr_lib.zarr_dtype(value)


def _leaf_paths(tree, prefix=()):
    """(key path, leaf) of a nested dict; a flat dict's "/" names are key
    paths."""
    for key, value in tree.items():
        path = prefix + tuple(str(key).split("/"))
        if isinstance(value, dict):
            yield from _leaf_paths(value, path)
        else:
            yield path, value


def whole_leaves(tree) -> List[Leaf]:
    """The leaves of a tree held whole by one rank (one chunk each)."""
    out = []
    for path, value in _leaf_paths(tree):
        array, dtype = _as_numpy(value)
        index = (0,) * array.ndim
        out.append(Leaf(path, tuple(array.shape), dtype, tuple(array.shape),
                        {index: array}))
    return out


def _metadata(leaves: List[Leaf]) -> dict:
    tree = {}
    for leaf in sorted(leaves, key=lambda x: x.path):
        tree[str(tuple(leaf.path))] = {
            "key_metadata": [{"key": k, "key_type": 2} for k in leaf.path],
            "value_metadata": {"value_type": "jax.Array",
                               "skip_deserialize": False,
                               "write_shape": list(leaf.chunks)}}
    return {"tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}


def _write_json(path: str, obj):
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def save_tree(path: str, leaves: List[Leaf], rank: int = 0,
              world: int = 1, barrier=None) -> str:
    """Writes checkpoint directory ``path``: every rank calls it with
    every leaf (the same paths, shapes and chunks) and the chunks it owns;
    ``barrier()`` waits for every rank (None with one).  The ``.zarray``
    of a leaf is written by the rank that writes its first chunk."""
    path = os.path.abspath(path)
    if rank == 0 and os.path.isdir(path):
        shutil.rmtree(path)
    if barrier is not None:
        barrier()
    items = {}
    for leaf in leaves:
        name = ".".join(leaf.path)
        for index, block in leaf.blocks.items():
            if not any(index):
                items[f"{name}/.zarray"] = zarr_lib.zarray(
                    leaf.shape, leaf.chunks, leaf.dtype)
            items[f"{name}/{zarr_lib.chunk_key(index)}"] = \
                zarr_lib.chunk_bytes(block, leaf.chunks)
    init = time.time_ns()
    if items:  # a rank that owns no chunk writes no store
        ocdbt.write_store(os.path.join(path, f"ocdbt.process_{rank}"),
                          items)
    if barrier is not None:
        barrier()
    if rank == 0:
        ocdbt.write_root(path, [f"ocdbt.process_{r}" for r in range(world)])
        _write_json(os.path.join(path, "_METADATA"), _metadata(leaves))
        _write_json(os.path.join(path, "_CHECKPOINT_METADATA"), {
            "item_handlers": "orbax.checkpoint._src.handlers."
                             "standard_checkpoint_handler."
                             "StandardCheckpointHandler",
            "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": init,
            "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}})
    if barrier is not None:
        barrier()
    return path


def read_tree(path: str) -> Dict[Tuple[str, ...], np.ndarray]:
    """{key path: numpy array} of every array of checkpoint ``path``."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{path}: only OCDBT + zarr v2 checkpoints are "
                         f"supported")
    store = ocdbt.OcdbtReader(path)
    out = {}
    for entry in meta["tree_metadata"].values():
        keys = tuple(str(k["key"]) for k in entry["key_metadata"])
        if entry["value_metadata"].get("skip_deserialize"):
            continue
        out[keys] = zarr_lib.read_array(store, ".".join(keys))
    return out


def save_checkpoint_orbax_raw(path: str, tree) -> str:
    """Saves a tree (nested dicts, or a flat "/"-named dict) at the exact
    path (no step meta); used for the optimizer-state sidecar."""
    return save_tree(path, whole_leaves(tree))


def _ckpt_dir(model_dir: str, step: int) -> str:
    return os.path.join(model_dir, f"ckpt-{step}.orbax")


def is_orbax_checkpoint(path: str) -> bool:
    return path is not None and path.endswith(".orbax") \
        and os.path.isdir(path)


def save_checkpoint_orbax(model_dir: str, step: int, params,
                          max_to_keep: Optional[int] = 8, leaves=None,
                          rank: int = 0, world: int = 1,
                          barrier=None) -> str:
    """Saves ``params`` (or, over several ranks, ``leaves``: each rank's
    ``Leaf`` list) as ``ckpt-<step>.orbax``; rank 0 then records the step
    in ``checkpoint.json`` and prunes all but the newest ``max_to_keep``
    checkpoints with their optimizer sidecars.  Returns the path."""
    from neurst_tpu_torch.utils.checkpoints import _read_meta, _write_meta
    os.makedirs(model_dir, exist_ok=True)
    path = _ckpt_dir(model_dir, step)
    save_tree(path, whole_leaves(params) if leaves is None else leaves,
              rank, world, barrier)
    if rank != 0:
        return path
    meta = _read_meta(model_dir)
    if step not in meta["all"]:
        meta["all"].append(step)
    meta["latest"] = step
    if max_to_keep and len(meta["all"]) > max_to_keep:
        for old in sorted(meta["all"])[:-max_to_keep]:
            meta["all"].remove(old)
            old_path = _ckpt_dir(model_dir, old)
            for p in (old_path,
                      old_path.replace(".orbax", ".optstate.orbax")):
                if os.path.isdir(p):
                    shutil.rmtree(p)
            # the port's optimizer sidecar
            sidecar = old_path.replace(".orbax", ".torch_optstate.npz")
            if os.path.exists(sidecar):
                os.remove(sidecar)
    _write_meta(model_dir, meta)
    logging.info("Saved sharded checkpoint %s", path)
    return path


def latest_orbax_checkpoint(model_dir: str) -> Optional[str]:
    if model_dir is None or not os.path.isdir(model_dir):
        return None
    steps: List[int] = []
    for f in os.listdir(model_dir):
        m = re.match(r"^ckpt-(\d+)\.orbax$", f)
        if m:
            steps.append(int(m.group(1)))
    if not steps:
        return None
    return _ckpt_dir(model_dir, max(steps))


def restore_checkpoint_orbax(path: str, template=None):
    """The saved tree as nested dicts of numpy arrays; with a
    ``template`` (nested dicts, or a flat "/"-named dict) only its leaves,
    in its structure, each checked against the template's shape."""
    found = read_tree(path)
    if template is None:
        tree = {}
        for keys, value in found.items():
            node = tree
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = value
        return tree

    def fill(node, prefix):
        out = {}
        for key, value in node.items():
            keys = prefix + tuple(str(key).split("/"))
            if isinstance(value, dict):
                out[key] = fill(value, keys)
                continue
            if keys not in found:
                raise KeyError(f"{path} holds no {'/'.join(keys)}")
            if tuple(found[keys].shape) != tuple(np.shape(value)):
                raise ValueError(
                    f"{'/'.join(keys)}: saved {found[keys].shape}, "
                    f"template {tuple(np.shape(value))}")
            out[key] = found[keys]
        return out

    return fill(template, ())
