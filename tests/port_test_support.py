"""Shared support for the port's CPU tests that train.

Importing it sets one torch thread for each pytest-xdist worker.  The
parallel suite runs several workers on the host's cores; without this,
each worker's torch runs an OpenMP pool over all of them, which slowed
the port's CPU training ~15x under the suite.

``start_jax_side`` runs a test file's JAX-side script in a subprocess on
one CPU device, so that the JAX package's trainer and CLIs run beside
the port's side."""

import json
import os
import subprocess
import sys

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start_jax_side(script, root, name, ops):
    """``script`` (Python source) with the path of ``ops`` (written as
    ``<root>/<name>.json``) as its argument, in a subprocess on one CPU
    device, its output in ``<root>/<name>.log``.  Returns (process, log
    path)."""
    ops_path = os.path.join(root, f"{name}.json")
    with open(ops_path, "w") as f:
        json.dump(ops, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    log = os.path.join(root, f"{name}.log")
    with open(log, "w") as out:
        return subprocess.Popen([sys.executable, "-c", script, ops_path],
                                cwd=REPO, env=env, stdout=out,
                                stderr=out), log
