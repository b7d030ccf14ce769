"""PruneTune partial trainer, a plug-in reached through ``--include``
(the port's counterpart of ``examples/prune_tune/src/partial_trainer.py``).

``partial_tune`` fine-tunes only the slots that a pruned general-domain
model holds at zero (``--mask_dir``, its newest checkpoint), keeping the
dense subnetwork frozen: its ``_wrap_tx`` appends a transformation that
zeroes the updates of the dense slots, inside the bf16 master, so a
frozen slot's master does not move either.

Usage:
    python -m neurst_tpu_torch.cli.run_exp --entry partial_tune \\
        --include neurst_tpu_torch/contrib/prune_tune/partial_trainer.py \\
        --mask_dir general_model_dir ... (the trainer's flags)
"""

import logging

import numpy as np
import torch

from neurst_tpu_torch.exps.base_experiment import register_exp
from neurst_tpu_torch.exps.trainer import Trainer
from neurst_tpu_torch.optimizers.optimizers import (GradientTransformation,
                                                     chain)
from neurst_tpu_torch.parallel.sharding import shard_tensors
from neurst_tpu_torch.utils import checkpoints as ckpt_lib
from neurst_tpu_torch.utils.flags_core import Flag
from neurst_tpu_torch.utils.param_bridge import to_torch_layout

__all__ = ["PartialTrainer", "partial_mask_transform", "tunable_masks"]


def tunable_masks(model_dir: str):
    """{port name: float32 numpy mask}, 1 where the newest checkpoint of
    ``model_dir`` holds a zero (a tunable slot), 0 elsewhere."""
    path = ckpt_lib.latest_checkpoint(model_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoint in mask_dir {model_dir}")
    flat = ckpt_lib.restore_checkpoint_params(path)
    return {name: (np.asarray(w) == 0.0).astype(np.float32)
            for name, w in to_torch_layout(flat).items()}


def partial_mask_transform(masks) -> GradientTransformation:
    """Multiplies each named update by its mask (0 on the dense slots);
    updates without a mask pass."""
    cache = {}

    def update(updates, state, params=None):
        out = {}
        for name, u in updates.items():
            m = masks.get(name)
            if m is None:
                out[name] = u
                continue
            if name not in cache:
                cache[name] = torch.from_numpy(m).to(u.device)
            out[name] = u * cache[name].to(u.dtype)
        return out, state

    return GradientTransformation(lambda params: (), update)


@register_exp("partial_tune")
class PartialTrainer(Trainer):
    """Fine-tunes only the pruned (zero) parameter slots."""

    @staticmethod
    def class_or_method_args():
        return Trainer.class_or_method_args() + [
            Flag("mask_dir", dtype=Flag.TYPE.STRING, default=None,
                 help="Checkpoint dir of the pruned general-domain model "
                      "(zeros mark the tunable slots)."),
        ]

    def run(self):
        mask_dir = self._args.get("mask_dir")
        if not mask_dir:
            raise ValueError("--mask_dir is required for partial_tune")
        self._partial_masks = tunable_masks(mask_dir)
        tunable = sum(float(m.sum()) for m in self._partial_masks.values())
        total = sum(m.size for m in self._partial_masks.values())
        logging.info("partial_tune: %.1f%% of parameters are tunable",
                     100.0 * tunable / total)
        return super().run()

    def _wrap_tx(self, tx):
        # this rank's parts of the masks (its shards, its stage's layers)
        parts = shard_tensors(
            {name: torch.from_numpy(m)
             for name, m in self._partial_masks.items()},
            self._specs, self._mesh)
        return chain(tx, partial_mask_transform(
            {name: t.numpy() for name, t in parts.items()}))
