"""Sequence-generation validator (the port's copy of
``neurst_tpu/training/seq_generation_validator.py``): beam-decodes the
dev set with the live weights, scores BLEU / WER, logs sample hypotheses
and keeps the best and the averaged checkpoints."""

import logging

from neurst_tpu_torch.data.datasets.dataset import build_dataset
from neurst_tpu_torch.exps.sequence_generator import recover_targets
from neurst_tpu_torch.layers.search.sequence_search import build_search_layer
from neurst_tpu_torch.training.criterion_validator import model_inputs
from neurst_tpu_torch.training.validator import (TrainingStatusRecorder,
                                                 Validator,
                                                 register_validator)
from neurst_tpu_torch.utils.compat import DataStatus, ModeKeys
from neurst_tpu_torch.utils.flags_core import Flag, ModuleFlag

__all__ = ["SeqGenerationValidator"]


@register_validator("seq_generation_validator")
class SeqGenerationValidator(Validator):

    @staticmethod
    def class_or_method_args():
        return Validator.class_or_method_args() + [
            ModuleFlag("eval_search_method", "search_method",
                       default="beam_search",
                       help="The search layer for validation decode."),
            ModuleFlag("eval_metric", "metric",
                       help="The metric for validation."),
            ModuleFlag("eval_dataset", "dataset",
                       help="The development dataset."),
            Flag("eval_batch_size", dtype=Flag.TYPE.INTEGER, default=32,
                 help="The batch size for validation decode."),
            Flag("eval_top_hypothesis_display", dtype=Flag.TYPE.INTEGER,
                 default=3, help="Log this many sample hypotheses."),
            Flag("eval_keep_best_checkpoints", dtype=Flag.TYPE.INTEGER,
                 default=8, help="Keep top-k checkpoints by metric "
                                 "(alias eval_top_checkpoints_to_keep)."),
        ]

    def build(self, task, model, model_dir=None):
        a = self._args
        self._task = task
        self._dataset = build_dataset(
            {"dataset.class": a.get("eval_dataset.class"),
             "dataset.params": a.get("eval_dataset.params") or {}})
        self._search = build_search_layer({
            "search_method.class": a.get("eval_search_method.class")
            or "beam_search",
            "search_method.params": a.get("eval_search_method.params")
            or {}})
        self._search.set_model(model)
        metric_args = {"metric.class": a.get("eval_metric.class"),
                       "metric.params": a.get("eval_metric.params") or {}}
        self._metric = task.get_eval_metric(
            metric_args if metric_args["metric.class"] else {},
            ds=self._dataset)
        self._batch_args = {"batch_size": a.get("eval_batch_size") or 32}
        self._display = int(a.get("eval_top_hypothesis_display") or 3)
        keep_best = a.get("eval_keep_best_checkpoints")
        if keep_best is None:
            keep_best = a.get("eval_top_checkpoints_to_keep")
        if keep_best is None:
            keep_best = 8
        self._recorder = TrainingStatusRecorder(
            self._metric, model_dir=model_dir, keep_best=keep_best,
            keep_best_avg=(keep_best
                           if a.get("eval_auto_average_checkpoints", True)
                           else 0),
            estop_patience=a.get("eval_estop_patience"),
            best_dir=a.get("eval_best_checkpoint_path"),
            best_avg_dir=a.get("eval_best_avg_checkpoint_path"))
        return self

    def validate(self, step, params):
        # targets first: no decode of a dev set without references
        targets = self._task.eval_targets(self._dataset)
        if not targets:
            logging.warning("Validation dataset has no targets; skipping "
                            "generation validation.")
            return False
        hypo_decode = self._task.get_data_postprocess_fn(
            DataStatus.PROJECTED)
        hypotheses = []
        it = self._task.create_batch_iterator(
            self._dataset, ModeKeys.INFER, self._batch_args)
        for batch in it():
            hyp, _ = self._search(model_inputs(batch))
            hyp = hyp.cpu().numpy()
            mask = batch.get("sample_mask")
            bsz = mask.shape[0] if mask is not None else hyp.shape[0]
            top_k = hyp.shape[0] // bsz
            for i in range(bsz):
                if mask is not None and mask[i] == 0:
                    continue
                hypotheses.append(hypo_decode(hyp[i * top_k].tolist()))
        targets = recover_targets(self._task, self._dataset,
                                  list(targets)[:len(hypotheses)])
        for i in range(min(self._display, len(hypotheses))):
            logging.info("  sample %d | hyp: %s | ref: %s", i,
                         hypotheses[i][:120], targets[i][:120])
        result = self._metric(hypotheses, targets)
        logging.info("generation validation @%d: %s", step, result)
        return self._recorder.record(step, self._metric.get_value(result),
                                     params)
