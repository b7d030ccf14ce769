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


# A JAX-side script for ``start_jax_side``: its ops are ["exec", code,
# None] (run code, e.g. a test's patches, in the script's namespace),
# ["wait", path, None] (until the file exists) and [kind, argv, out]
# (``run_exp.cli_main(argv)``, its result, or with kind "train" the
# losses the trainer logged, as JSON in ``out``).
JAX_CLI_SIDE = r"""
import json, logging, os, sys, time
import jax
jax.config.update("jax_default_matmul_precision", "float32")
import neurst_tpu.exps.trainer as trainer_mod
from neurst_tpu.cli.run_exp import cli_main
logging.basicConfig(level=logging.INFO)
LOSSES = []


class Log(object):
    def __getattr__(self, name):
        return getattr(logging, name)

    def info(self, msg, *args, **kwargs):
        if msg.startswith("step %d | loss"):
            LOSSES.append(args[1])
        logging.info(msg, *args, **kwargs)


trainer_mod.logging = Log()
for kind, argv, out in json.load(open(sys.argv[1])):
    if kind == "exec":
        exec(argv)
        continue
    if kind == "wait":
        while not os.path.exists(argv):
            time.sleep(0.05)
        continue
    del LOSSES[:]
    result = cli_main(argv)
    with open(out, "w") as f:
        json.dump(list(LOSSES) if kind == "train" else result, f,
                  default=lambda o: o.tolist() if hasattr(o, "tolist")
                  else str(o))
"""


class TrainerLossLog(object):
    """Stands in for the port trainer module's ``logging``: keeps the
    exact losses of its "step %d | loss" lines (the line rounds them)."""

    def __init__(self):
        import logging
        self._logging = logging
        self.losses = []

    def __getattr__(self, name):
        return getattr(self._logging, name)

    def info(self, msg, *args, **kwargs):
        if msg.startswith("step %d | loss"):
            self.losses.append(args[1])
        self._logging.info(msg, *args, **kwargs)
