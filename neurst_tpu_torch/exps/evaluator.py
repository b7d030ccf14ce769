"""The loss / perplexity evaluation entry ``eval`` (the port's copy of
``neurst_tpu/exps/evaluator.py``): the criterion's statistics of the
model's inference forward over the dataset's EVAL batches
(``make_eval_step``), reduced by ``criterion.reduce_metrics``.  A
``MultipleDataset`` is evaluated one named dataset at a time; the result
holds each under ``datasets`` and their ``sample_weights`` mixture under
``weighted``."""

import logging

from neurst_tpu_torch.criterions.criterion import build_criterion
from neurst_tpu_torch.data.datasets.mixed_train_dataset import \
    MultipleDataset
from neurst_tpu_torch.exps.base_experiment import BaseExperiment, register_exp
from neurst_tpu_torch.exps.sequence_generator import weighted_mixture
from neurst_tpu_torch.parallel import make_eval_step
from neurst_tpu_torch.training.criterion_validator import model_inputs
from neurst_tpu_torch.utils.compat import ModeKeys
from neurst_tpu_torch.utils.flags_core import Flag, ModuleFlag

__all__ = ["Evaluator", "eval_batches"]

_CRITERION_FLAG = ModuleFlag("criterion", "criterion",
                             default="label_smoothed_cross_entropy",
                             help="The evaluation criterion.")
_CHECKPOINT_FLAG = Flag("checkpoint_path", dtype=Flag.TYPE.STRING,
                        default=None, help="Explicit checkpoint path.")


def eval_batches(exp):
    """(criterion, [(batch, statistics)]) of an entry's restored model
    over its dataset's EVAL batches."""
    criterion = build_criterion(exp.args)
    exp.restore_params()
    eval_step = make_eval_step(exp.model, criterion)
    batches = exp.task.create_batch_iterator(exp.custom_dataset,
                                             ModeKeys.EVAL, exp.args)
    return criterion, [(batch, eval_step(model_inputs(batch)))
                       for batch in batches()]


@register_exp("eval", "evaluation")
class Evaluator(BaseExperiment):

    @staticmethod
    def class_or_method_args():
        return [_CRITERION_FLAG, _CHECKPOINT_FLAG]

    def run(self):
        if isinstance(self._custom_dataset, MultipleDataset):
            per_ds = {name: Evaluator(self._args, task=self._task,
                                      model=self._model, custom_dataset=sub,
                                      model_dir=self._model_dir).run()
                      for name, sub in sorted(
                          self._custom_dataset.datasets.items())}
            weighted = weighted_mixture(per_ds,
                                        self._custom_dataset.sample_weights)
            logging.info("Weighted mixture evaluation: %s", weighted)
            return {"datasets": per_ds, "weighted": weighted}
        criterion, results = eval_batches(self)
        metrics = criterion.reduce_metrics([stats for _, stats in results])
        logging.info("Evaluation results: %s", metrics)
        return metrics
