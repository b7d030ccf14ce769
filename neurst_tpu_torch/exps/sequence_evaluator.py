"""Per-sample criterion scores over a dataset, the ``sequence_evaluator``
entry (the port's copy of ``neurst_tpu/exps/sequence_evaluator.py``):
each kept row's NLL, per-token NLL and perplexity, written one JSON
object a line to ``output_file``."""

import json
import logging

from neurst_tpu_torch.exps.base_experiment import BaseExperiment, register_exp
from neurst_tpu_torch.exps.evaluator import (_CHECKPOINT_FLAG,
                                             _CRITERION_FLAG, eval_batches)
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["SequenceEvaluator"]


@register_exp("sequence_evaluator")
class SequenceEvaluator(BaseExperiment):

    @staticmethod
    def class_or_method_args():
        return [_CRITERION_FLAG,
                Flag("output_file", dtype=Flag.TYPE.STRING, default=None,
                     help="Where to write per-sample scores."),
                _CHECKPOINT_FLAG]

    def run(self):
        criterion, results = eval_batches(self)
        sample_metrics = []
        for batch, stats in results:
            mask = batch.get("sample_mask")
            for i, m in enumerate(criterion.reduce_sample_metrics(stats)):
                if mask is None or i >= len(mask) or mask[i] != 0:
                    sample_metrics.append(m)
        logging.info("Scored %d samples", len(sample_metrics))
        if self._args.get("output_file"):
            with open(self._args["output_file"], "w") as f:
                for m in sample_metrics:
                    f.write(json.dumps(m) + "\n")
        return sample_metrics
