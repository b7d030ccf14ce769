"""The cluster bootstrap (counterpart of ``neurst_tpu/parallel/cluster.py``).

The JAX package resolves ``--worker_hosts`` / ``--task_index`` (or the
``WORKER_HOSTS`` / ``TASK_ID`` environment variables) to
``jax.distributed.initialize`` arguments, with the first worker as the
coordinator; the same inputs, and the same validation errors, resolve
here to ``torch.distributed.init_process_group`` arguments.  The port runs
one process per GPU: a host runs ``LOCAL_WORLD_SIZE`` processes (1 by
default), so the world is hosts x local processes and a process's rank is
``task_index x local + LOCAL_RANK``.  With no spec at all, torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
``MASTER_PORT``) is read, the counterpart of JAX's auto-discovery; with
neither, the run is one process and no group is formed.

Each process binds ``cuda:LOCAL_RANK`` unless the caller asks for the
CPU; the group's backend follows ``collectives.choose_backend``.
"""

import logging
import os
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from neurst_tpu_torch.parallel.collectives import choose_backend

__all__ = ["resolve_cluster", "distributed_initialize", "local_rank",
           "DEFAULT_PORT"]

# the JAX package's conventional coordinator port
DEFAULT_PORT = 8476


def local_rank(env: Optional[Mapping[str, str]] = None) -> int:
    env = os.environ if env is None else env
    return int(env.get("LOCAL_RANK") or 0)


def resolve_cluster(worker_hosts: Optional[str] = None,
                    task_index: Optional[int] = None,
                    env: Optional[Mapping[str, str]] = None) -> dict:
    """A cluster spec -> ``init_process_group`` keyword arguments
    (``init_method``, ``world_size``, ``rank``); {} for one process.

    Raises on an ambiguous spec (several workers but no task index) and
    on a task index out of range, as the JAX package does."""
    env = os.environ if env is None else env
    if worker_hosts is None:
        worker_hosts = env.get("WORKER_HOSTS") or None
        if task_index is None and env.get("TASK_ID") is not None:
            task_index = int(env["TASK_ID"])
    if not worker_hosts:
        world = int(env.get("WORLD_SIZE") or 1)
        if world <= 1:
            return {}
        return {"init_method": "tcp://{}:{}".format(
                    env.get("MASTER_ADDR") or "localhost",
                    env.get("MASTER_PORT") or DEFAULT_PORT),
                "world_size": world, "rank": int(env.get("RANK") or 0)}
    workers = [w.strip() for w in str(worker_hosts).split(",") if w.strip()]
    if len(workers) > 1 and (task_index is None or task_index < 0):
        raise ValueError(
            "Must specify task_index (or TASK_ID) when number of "
            "workers > 1")
    task_index = 0 if len(workers) == 1 else int(task_index)
    if not 0 <= task_index < len(workers):
        raise ValueError(
            f"task_index {task_index} out of range for {len(workers)} "
            f"workers")
    coordinator = workers[0]
    if ":" not in coordinator:
        coordinator += f":{DEFAULT_PORT}"
    local = int(env.get("LOCAL_WORLD_SIZE") or 1)
    return {"init_method": f"tcp://{coordinator}",
            "world_size": len(workers) * local,
            "rank": task_index * local + local_rank(env)}


def distributed_initialize(worker_hosts: Optional[str] = None,
                           task_index: Optional[int] = None,
                           device=None) -> torch.device:
    """Forms the process group from flags or the environment and returns
    this process's device: ``cuda:LOCAL_RANK`` unless ``device`` says
    otherwise (``"cpu"``).  One process forms no group."""
    kwargs = resolve_cluster(worker_hosts, task_index)
    if device is None:
        device = torch.device("cuda", local_rank())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not kwargs or dist.is_initialized():
        return device
    local = int(os.environ.get("LOCAL_WORLD_SIZE") or 1)
    cuda_devices = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = choose_backend(device, local, cuda_devices)
    logging.info("init_process_group(%s, backend=%s)", kwargs, backend)
    dist.init_process_group(backend=backend, **kwargs)
    logging.info("process group formed: rank %d of %d on %s",
                 dist.get_rank(), dist.get_world_size(), device)
    return device
