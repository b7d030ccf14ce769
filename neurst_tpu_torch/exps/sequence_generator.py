"""The generation ("predict") entry (the port's counterpart of
``neurst_tpu/exps/sequence_generator.py``).

Restores the latest checkpoint of the model dir (or ``checkpoint_path``)
into the model, decodes the dataset's INFER batches with the search layer
(beam search), turns the top hypothesis of each row that ``sample_mask``
keeps into text, writes them to ``output_file`` and scores them against
the dataset's references with the metric.  The returned dict also holds
``timing``: seconds spent reading and batching, decoding (the search,
synchronized by the copy of its result to the host), and turning ids
into text and scoring; and the seconds to the first batch's hypotheses.

A ``MultipleDataset`` is decoded one named dataset at a time, in name
order, each with ``output_file.<name>`` and ``save_metric.<name>``; the
result holds each dataset's result under ``datasets`` and the
``sample_weights`` mixture of their numbers under ``weighted``, which
``save_metric`` also receives.

Several model dirs (``--model_dir a,b,c``) decode as one ensemble
(``models/ensemble_model.py``): each member is built from its own dir's
``model_configs.yml`` and restored from its newest checkpoint, and the
members' probabilities mix with ``ensemble_weights`` (of the entry or of
the search's params; equal by default).

Not ported: tensor-parallel decode raises ``NotImplementedError``.
"""

import json
import logging
import time

import numpy as np

from neurst_tpu_torch.data.datasets.mixed_train_dataset import \
    MultipleDataset
from neurst_tpu_torch.exps.base_experiment import BaseExperiment, register_exp
from neurst_tpu_torch.layers.search.sequence_search import build_search_layer
from neurst_tpu_torch.models.ensemble_model import \
    EncoderDecoderEnsembleModel
from neurst_tpu_torch.tasks.task import build_task
from neurst_tpu_torch.utils.compat import DataStatus, ModeKeys
from neurst_tpu_torch.utils.configurable import (
    ModelConfigs, flatten_string_list, strip_training_only_model_flags)
from neurst_tpu_torch.utils.flags_core import Flag, ModuleFlag

__all__ = ["SequenceGenerator", "recover_targets", "weighted_mixture"]


def recover_targets(task, dataset, targets):
    """Raw reference texts from a dataset's targets whatever their
    DataStatus (the copy of ``neurst_tpu/training/validator.py:38``):
    PROCESSED strings are detokenized, PROJECTED ids decoded, raw strings
    pass through."""
    status = dataset.status
    if isinstance(status, dict):
        status = status.get("transcript", DataStatus.RAW)
    post = task.get_data_postprocess_fn(status)
    if status == DataStatus.PROCESSED:
        return [post(t) for t in targets]
    return [post(t) if not isinstance(t, str) else t for t in targets]


def weighted_mixture(results, weights, skip=()):
    """{number key: sum over datasets of weight x value} of each
    dataset's int and float results (keys in ``skip`` left out)."""
    mixed = {}
    for name, res in results.items():
        w = weights.get(name, 0.0)
        for k, v in res.items():
            if isinstance(v, (int, float)) and k not in skip:
                mixed[k] = mixed.get(k, 0.0) + w * v
    return mixed


@register_exp("predict", "generation")
class SequenceGenerator(BaseExperiment):

    @staticmethod
    def class_or_method_args():
        return [
            ModuleFlag("search_method", "search_method",
                       default="beam_search", help="The search layer."),
            ModuleFlag("metric", "metric", help="The evaluation metric."),
            Flag("output_file", dtype=Flag.TYPE.STRING, default=None,
                 help="The file to write hypotheses to."),
            Flag("save_metric", dtype=Flag.TYPE.STRING, default=None,
                 help="Path to dump the metric result JSON."),
            Flag("checkpoint_path", dtype=Flag.TYPE.STRING, default=None,
                 help="Explicit checkpoint path (defaults to latest in "
                      "model_dir)."),
            Flag("decode_data_parallel", dtype=Flag.TYPE.BOOLEAN,
                 default=None,
                 help="Shard decode batches over all devices (one device "
                      "here)."),
            Flag("decode_tensor_parallel", dtype=Flag.TYPE.INTEGER,
                 default=None,
                 help="Shard the model's parameters over this many devices "
                      "during decode (not ported)."),
        ]

    def _maybe_build_ensemble(self):
        """Several model dirs -> the ensemble of their models, each built
        from its dir's configs on the entry's device and restored from its
        newest checkpoint; else None."""
        model_dirs = flatten_string_list(self._model_dir)
        if len(model_dirs) <= 1:
            return None
        members = []
        for model_dir in model_dirs:
            cfg = ModelConfigs.load(model_dir)
            cfg["model.params"] = strip_training_only_model_flags(
                cfg.get("model.params"))
            member = build_task(cfg).build_model(cfg,
                                                 device=self._model.device)
            BaseExperiment(model=member, model_dir=model_dir
                           ).restore_params()
            members.append(member)
        weights = (self._args.get("ensemble_weights")
                   or (self._args.get("search_method.params")
                       or {}).get("ensemble_weights"))
        if isinstance(weights, str):
            weights = [float(x) for x in weights.split(",")]
        return EncoderDecoderEnsembleModel(members, weights)

    def _run_multiple(self):
        results = {}
        base_output = self._args.get("output_file")
        base_metric = self._args.get("save_metric")
        for name, sub in sorted(self._custom_dataset.datasets.items()):
            logging.info("===== decoding dataset '%s' =====", name)
            results[name] = SequenceGenerator(
                dict(self._args,
                     output_file=(f"{base_output}.{name}"
                                  if base_output else None),
                     save_metric=(f"{base_metric}.{name}"
                                  if base_metric else None)),
                task=self._task, model=self._model, custom_dataset=sub,
                model_dir=self._model_dir).run()
        weighted = weighted_mixture(
            results, self._custom_dataset.sample_weights, skip=("samples",))
        logging.info("Weighted mixture metrics: %s", weighted)
        if base_metric:
            with open(base_metric, "w") as f:
                json.dump({"datasets": {
                    k: {m: v for m, v in r.items()
                        if isinstance(v, (int, float))}
                    for k, r in results.items()},
                    "weighted": weighted}, f, indent=2)
        return {"datasets": results, "weighted": weighted}

    def run(self):
        if (self._args.get("decode_tensor_parallel") or 1) > 1:
            raise NotImplementedError("tensor-parallel decode is not ported")
        if isinstance(self._custom_dataset, MultipleDataset):
            return self._run_multiple()
        task, args = self._task, self._args
        model = self._maybe_build_ensemble()
        if model is None:
            model = self.restore_params()
        search = build_search_layer(args)
        search.set_model(model)
        search.prepare()
        batch_iter = task.create_batch_iterator(
            self._custom_dataset, ModeKeys.INFER, args)
        hypo_decode = task.get_data_postprocess_fn(DataStatus.PROJECTED)

        hypotheses, scores = [], []
        timing = {"read_batch_s": 0.0, "decode_s": 0.0,
                  "detok_metric_s": 0.0, "first_batch_s": None}
        start = time.perf_counter()
        batches = batch_iter()
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            t1 = time.perf_counter()
            timing["read_batch_s"] += t1 - t0
            if batch is None:
                break
            model_inp = {k: v for k, v in batch.items()
                         if isinstance(v, np.ndarray) and v.dtype != object}
            hyp, score = search(model_inp)
            hyp, score = hyp.cpu().numpy(), score.cpu().numpy()
            t2 = time.perf_counter()
            timing["decode_s"] += t2 - t1
            if timing["first_batch_s"] is None:
                timing["first_batch_s"] = t2 - start
            mask = batch.get("sample_mask")
            bsz = mask.shape[0] if mask is not None else hyp.shape[0]
            top_k = hyp.shape[0] // bsz
            for i in range(bsz):
                if mask is not None and mask[i] == 0:
                    continue
                hypotheses.append(hypo_decode(hyp[i * top_k].tolist()))
                scores.append(float(score[i * top_k]))
            timing["detok_metric_s"] += time.perf_counter() - t2
        elapsed = time.perf_counter() - start
        n_samples = len(hypotheses)
        logging.info("Generation of %d samples took %.2fs (%.2f samples/s)",
                     n_samples, elapsed, n_samples / max(elapsed, 1e-6))

        t0 = time.perf_counter()
        if args.get("output_file"):
            with open(args["output_file"], "w", encoding="utf-8") as f:
                for h in hypotheses:
                    f.write(h + "\n")
            logging.info("Hypotheses written to %s", args["output_file"])
        results = {"samples": n_samples,
                   "samples_per_sec": n_samples / max(elapsed, 1e-6)}
        targets = task.eval_targets(self._custom_dataset)
        if targets:
            targets = recover_targets(task, self._custom_dataset,
                                      list(targets)[:len(hypotheses)])
            metric_result = task.get_eval_metric(args)(hypotheses, targets)
            logging.info("Evaluation result: %s", metric_result)
            results.update(metric_result)
            if args.get("save_metric"):
                with open(args["save_metric"], "w") as f:
                    json.dump(results, f, indent=2)
        timing["detok_metric_s"] += time.perf_counter() - t0
        return {"hypotheses": hypotheses, "scores": scores, **results,
                "timing": timing}
