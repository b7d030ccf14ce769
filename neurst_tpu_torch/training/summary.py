"""TensorBoard scalars (the port's copy of
``neurst_tpu/training/summary.py``): the trainer's windowed metrics under
``training/``.  Without ``tensorboard`` the writer is a no-op with a
warning, as in the JAX package.

``enable_profiler``: where the JAX trainer starts ``jax.profiler``'s
server, the port traces a window of training steps with
``torch.profiler`` (host and, on the card, device activity): the first
step is skipped, one warms up and the next three are recorded, written
as a Chrome trace (``*.pt.trace.json``) under ``<model_dir>/profile/``,
which ``chrome://tracing``, Perfetto and TensorBoard's profiler plugin
read."""

import logging
import os
from typing import Optional

__all__ = ["SummaryWriterWrapper", "TrainingProfiler"]


class SummaryWriterWrapper(object):
    """A thin wrapper over ``torch.utils.tensorboard.SummaryWriter``."""

    def __init__(self, logdir: Optional[str], enabled: bool = True):
        self._writer = None
        if not enabled or not logdir:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            logging.warning("TensorBoard writer unavailable: %s", e)
            return
        os.makedirs(logdir, exist_ok=True)
        self._writer = SummaryWriter(logdir)
        logging.info("TensorBoard summaries -> %s", logdir)

    def scalars(self, prefix: str, values: dict, step: int):
        if self._writer is None:
            return
        for k, v in values.items():
            self._writer.add_scalar(f"{prefix}/{k}", float(v), step)

    def close(self):
        if self._writer is not None:
            self._writer.close()


class TrainingProfiler(object):
    """A ``torch.profiler`` window over training steps; ``step()`` after
    each train step, ``close()`` at the end.  Off (no-op) unless
    ``enabled`` with a model dir."""

    WAIT, WARMUP, ACTIVE = 1, 1, 3

    def __init__(self, model_dir: Optional[str], enabled: bool,
                 device="cpu"):
        self._prof = None
        if not enabled or not model_dir:
            return
        import torch
        trace_dir = os.path.join(model_dir, "profile")
        os.makedirs(trace_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(
            activities=activities,
            schedule=torch.profiler.schedule(
                wait=self.WAIT, warmup=self.WARMUP, active=self.ACTIVE,
                repeat=1),
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                trace_dir))
        self._prof.start()
        logging.info("torch.profiler traces steps %d-%d -> %s",
                     self.WAIT + self.WARMUP + 1,
                     self.WAIT + self.WARMUP + self.ACTIVE, trace_dir)

    def step(self):
        if self._prof is not None:
            self._prof.step()

    def close(self):
        if self._prof is not None:
            self._prof.stop()
            self._prof = None
