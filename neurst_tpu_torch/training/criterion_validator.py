"""Criterion (loss / perplexity) validator (the port's copy of
``neurst_tpu/training/criterion_validator.py``): the dev set's EVAL
batches through the model's inference forward and the criterion's
statistics; checkpoints are selected by NLL, early stop only."""

import logging

import numpy as np

from neurst_tpu_torch.criterions.criterion import build_criterion
from neurst_tpu_torch.data.datasets.dataset import build_dataset
from neurst_tpu_torch.parallel import make_eval_step
from neurst_tpu_torch.training.validator import (TrainingStatusRecorder,
                                                 Validator,
                                                 register_validator)
from neurst_tpu_torch.utils.compat import ModeKeys
from neurst_tpu_torch.utils.flags_core import Flag, ModuleFlag

__all__ = ["CriterionValidator"]


def model_inputs(batch):
    """The array fields of a batch (object fields, like raw frame counts,
    stay on the host)."""
    return {k: v for k, v in batch.items()
            if isinstance(v, np.ndarray) and v.dtype != object}


@register_validator("criterion_validator")
class CriterionValidator(Validator):

    @staticmethod
    def class_or_method_args():
        return Validator.class_or_method_args() + [
            ModuleFlag("eval_criterion", "criterion",
                       default="label_smoothed_cross_entropy",
                       help="The criterion for validation."),
            ModuleFlag("eval_dataset", "dataset",
                       help="The development dataset."),
            Flag("eval_batch_size", dtype=Flag.TYPE.INTEGER, default=32,
                 help="The batch size for validation."),
        ]

    def build(self, task, model, model_dir=None):
        a = self._args
        self._criterion = build_criterion({
            "criterion.class": a.get("eval_criterion.class")
            or "label_smoothed_cross_entropy",
            "criterion.params": a.get("eval_criterion.params") or {}})
        self._task = task
        self._dataset = build_dataset(
            {"dataset.class": a.get("eval_dataset.class"),
             "dataset.params": a.get("eval_dataset.params") or {}})
        self._eval_step = make_eval_step(model, self._criterion)
        self._batch_args = {"batch_size": a.get("eval_batch_size") or 32}
        self._recorder = TrainingStatusRecorder(
            self._criterion.as_metric(), model_dir=model_dir,
            estop_patience=a.get("eval_estop_patience"))
        return self

    def validate(self, step, params):
        it = self._task.create_batch_iterator(self._dataset, ModeKeys.EVAL,
                                              self._batch_args)
        stats = [self._eval_step(model_inputs(batch)) for batch in it()]
        metrics = self._criterion.reduce_metrics(stats)
        logging.info("criterion validation @%d: %s", step, metrics)
        flag = self._criterion.as_metric().flag
        return self._recorder.record(step, float(metrics[flag]), params)
