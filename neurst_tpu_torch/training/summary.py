"""TensorBoard scalars (the port's copy of
``neurst_tpu/training/summary.py``): the trainer's windowed metrics under
``training/``.  Without ``tensorboard`` the writer is a no-op with a
warning, as in the JAX package.  The profiler hook is not ported."""

import logging
import os
from typing import Optional

__all__ = ["SummaryWriterWrapper", "maybe_start_profiler"]


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


def maybe_start_profiler(model_dir: Optional[str], enabled: bool):
    """The JAX package starts its profiler server here; the port has no
    counterpart, so ``enable_profiler`` raises."""
    if enabled:
        raise NotImplementedError("enable_profiler is not ported (profile "
                                  "the card with tools/profile_torch_"
                                  "train.py)")
