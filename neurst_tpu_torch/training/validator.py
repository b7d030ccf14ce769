"""Validators (the port's copy of ``neurst_tpu/training/validator.py``).

A validator evaluates the live parameters every ``eval_steps`` from
``eval_start_at``, records the best metric (with the keep-best and
averaged checkpoint savers) and asks the trainer to stop after
``eval_estop_patience`` evaluations without improvement.
"""

import logging
import os
from typing import Optional

from neurst_tpu_torch.utils.checkpoints import (AverageCheckpointSaver,
                                                KeepBestCheckpointSaver)
from neurst_tpu_torch.utils.flags_core import Flag
from neurst_tpu_torch.utils.registry import setup_registry

__all__ = ["Validator", "build_validator", "register_validator",
           "TrainingStatusRecorder"]


def _saver_dir(path, model_dir, default_subdir):
    return ((os.path.dirname(path) or ".", os.path.basename(path))
            if path else (model_dir, default_subdir))


class TrainingStatusRecorder(object):
    """Tracks the best metric; drives the keep-best and averaged savers
    and the early stop."""

    def __init__(self, metric, model_dir: Optional[str] = None,
                 keep_best: int = 0, keep_best_avg: int = 0,
                 estop_patience: Optional[int] = None,
                 best_dir: Optional[str] = None,
                 best_avg_dir: Optional[str] = None):
        self._metric = metric
        self._best = None
        self._best_step = None
        self._bad_count = 0
        self._estop_patience = estop_patience
        self._keep_best_saver = None
        self._avg_saver = None
        if (model_dir or best_dir) and keep_best:
            base, sub = _saver_dir(best_dir, model_dir, "best")
            self._keep_best_saver = KeepBestCheckpointSaver(
                base, metric, max_to_keep=keep_best, subdir=sub)
        if (model_dir or best_avg_dir) and keep_best_avg:
            base, sub = _saver_dir(best_avg_dir, model_dir, "best_avg")
            self._avg_saver = AverageCheckpointSaver(
                base, metric, max_to_keep=keep_best_avg, subdir=sub)

    @property
    def best(self):
        return self._best

    @property
    def best_step(self):
        return self._best_step

    def record(self, step: int, metric_value: float, params=None) -> bool:
        """Records an evaluation (``params``: flat JAX-named arrays for
        the savers).  Returns True when training should stop."""
        if self._best is None or self._metric.greater_or_eq(metric_value,
                                                            self._best):
            self._best, self._best_step, self._bad_count = \
                metric_value, step, 0
        else:
            self._bad_count += 1
        logging.info("validation @%d: %s=%.4f (best %.4f @%d, bad=%d)",
                     step, self._metric.flag or "metric", metric_value,
                     self._best, self._best_step, self._bad_count)
        if params is not None:
            for saver in (self._keep_best_saver, self._avg_saver):
                if saver is not None:
                    saver.save(step, params, metric_value)
        if self._estop_patience and self._bad_count >= self._estop_patience:
            logging.info("Early stop triggered after %d bad evals.",
                         self._bad_count)
            return True
        return False


class Validator(object):
    """Evaluates every ``eval_steps`` from ``eval_start_at``."""

    # built from the trainer's full args
    ALLOW_UNDECLARED_PARAMS = True

    def __init__(self, args=None):
        self._args = dict(args or {})
        self._eval_steps = int(self._args.get("eval_steps") or 1000)
        self._eval_start_at = int(self._args.get("eval_start_at") or 0)

    @staticmethod
    def class_or_method_args():
        return [
            Flag("eval_steps", dtype=Flag.TYPE.INTEGER, default=1000,
                 help="Evaluate every this many steps."),
            Flag("eval_start_at", dtype=Flag.TYPE.INTEGER, default=0,
                 help="Start evaluating at this step."),
            Flag("eval_estop_patience", dtype=Flag.TYPE.INTEGER,
                 default=None,
                 help="Early-stop after this many non-improving evals."),
            Flag("eval_best_checkpoint_path", dtype=Flag.TYPE.STRING,
                 default=None, help="Where to keep best checkpoints "
                                    "(defaults to model_dir/best)."),
            Flag("eval_auto_average_checkpoints", dtype=Flag.TYPE.BOOLEAN,
                 default=True, help="Maintain an averaged-best checkpoint."),
            Flag("eval_best_avg_checkpoint_path", dtype=Flag.TYPE.STRING,
                 default=None, help="Where to keep the averaged checkpoint."),
        ]

    def should_eval(self, step: int) -> bool:
        return (step >= self._eval_start_at
                and step % self._eval_steps == 0)

    def build(self, task, model, model_dir: Optional[str]):
        raise NotImplementedError

    def validate(self, step: int, params) -> bool:
        """Validates the model's live weights; ``params`` are their flat
        JAX-named float32 arrays for the savers.  Returns True to stop
        early."""
        raise NotImplementedError


build_validator, register_validator = setup_registry(
    "validator", base_class=Validator,
    create_fn=lambda cls, args: cls(args))
