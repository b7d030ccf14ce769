"""Batch placement helpers (counterpart of ``neurst_tpu/parallel/utils.py``).

In the port a rank is a JAX process with one device: ``process_index`` /
``process_count`` are the rank and the world size and
``local_device_count`` is 1.  ``put_batch(mesh, batch, batch_axis)``
gives the rank its slice of a batch along ``batch_axis`` over the "data"
axis (the same slice on every "stage" and "model" rank), moved to the
device; object fields are dropped and arrays of ndim <= ``batch_axis``
are replicated.
"""

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["put_batch", "local_device_count", "process_index",
           "process_count", "data_slice"]


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device_count() -> int:
    return 1


def data_slice(n: int, mesh) -> slice:
    """This rank's rows of ``n`` along the "data" axis."""
    dp = mesh.shape["data"]
    if n % dp:
        raise ValueError(f"batch dim {n} does not divide the data axis "
                         f"({dp})")
    per = n // dp
    d = mesh.coords["data"]
    return slice(d * per, (d + 1) * per)


def put_batch(mesh, batch: dict, batch_axis: int = 0, device=None) -> dict:
    """The rank's part of a host batch as tensors on ``device``: axis
    ``batch_axis`` sliced over "data", replicated over "stage" and
    "model"."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray) or v.dtype == object:
            continue
        if v.ndim > batch_axis:
            index = [slice(None)] * v.ndim
            index[batch_axis] = data_slice(v.shape[batch_axis], mesh)
            v = v[tuple(index)]
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(
            device or "cpu", non_blocking=True)
    return out
