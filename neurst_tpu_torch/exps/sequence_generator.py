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

Under ``--int8_static_activations`` the generator first calibrates the
static activation scales on the first ``--int8_calibration_batches``
batches: it decodes each (dynamic int8 activations), teacher-forces the
model's own top hypotheses while every dense records its input absmax,
and writes ``act_scale = absmax / 127`` (as the JAX generator does).

Over several ranks (one process per GPU, every rank reading the same
batches): ``decode_data_parallel`` (on by default) shards each batch's
rows over the "data" axis where they divide it and replicates the batch
where they do not (the JAX package's ``_dp_put`` rule);
``decode_tensor_parallel N`` shards the model's heads, mlp and vocabulary
over N "model" ranks (the beam cache holds the local heads; int8 and
QAT layers included); an ensemble keeps every member whole on every rank
and splits the batches over the "data" axis of the same mesh (two ranks
at tp 2 both decode every batch whole, as in the JAX package); MoE experts
are split over the "data" ranks when their count divides it, each decode
step dispatching to them (a rank whose search ends first serves its
experts until every rank's has, ``layers.moe.drain_experts``); and with
``--decode_data_parallel false`` the mesh is tensor-parallel only.  The
hypotheses are gathered in order, and rank 0 alone writes the output
file and the metric.
"""

import json
import logging
import time

import numpy as np
import torch

from neurst_tpu_torch.data.datasets.mixed_train_dataset import \
    MultipleDataset
from neurst_tpu_torch.exps.base_experiment import BaseExperiment, register_exp
from neurst_tpu_torch.layers.quantization.quant_layers import (
    int8_static_act_enabled, recording_act_absmax, set_int8_calibration,
    write_calibrated_act_scales)
from neurst_tpu_torch.layers.moe import drain_experts
from neurst_tpu_torch.layers.search.sequence_search import build_search_layer
from neurst_tpu_torch.models.ensemble_model import \
    EncoderDecoderEnsembleModel
from neurst_tpu_torch.parallel import collectives
from neurst_tpu_torch.parallel.mesh import make_mesh
from neurst_tpu_torch.parallel.sharding import apply_mesh
from neurst_tpu_torch.parallel.utils import (data_slice, process_count,
                                             process_index)
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
                 help="Shard decode batches over all ranks (on by "
                      "default with more than one; false keeps every "
                      "batch whole)."),
            Flag("decode_tensor_parallel", dtype=Flag.TYPE.INTEGER,
                 default=None,
                 help="Shard the model's parameters (heads, mlp and "
                      "vocabulary) over this many ranks during decode; "
                      "composes with data parallelism (mesh = dp x tp "
                      "over all ranks)."),
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

    def _calibrate_int8_static(self, model, search, batch_iter):
        """Self-calibration of the static int8 activation scales: decode
        each of the first ``int8_calibration_batches`` batches, then
        teacher-force BOS + its top hypotheses (but the last position)
        while recording every dense's input absmax; the maxima over the
        batches give ``act_scale = absmax / 127``."""
        n = int(self._args.get("int8_calibration_batches") or 4)
        agg, count = {}, 0
        set_int8_calibration(True)
        try:
            for batch in batch_iter():
                model_inp = {k: v for k, v in batch.items()
                             if isinstance(v, np.ndarray)
                             and v.dtype != object}
                hyp = search(model_inp)[0].cpu().numpy()
                bos = np.asarray(model_inp["trg_input"]).reshape(-1)
                top = hyp[::max(hyp.shape[0] // bos.shape[0], 1)]
                trg_input = np.concatenate(
                    [bos[:, None], top[:, :-1]], axis=1).astype(np.int32)
                with torch.no_grad(), recording_act_absmax(model) as found:
                    model(dict(model_inp, trg_input=trg_input))
                for path, amax in found.items():
                    agg[path] = max(agg.get(path, amax), amax)
                count += 1
                if count >= n:
                    break
        finally:
            set_int8_calibration(False)
        if not count:
            logging.warning("int8 static calibration saw no batches; act "
                            "scales keep their init values")
            return
        logging.info("Calibrated static int8 activation scales on %d "
                     "batches", count)
        write_calibrated_act_scales(model, agg)

    def _decode_mesh(self, model):
        """The decode mesh over every rank (None on one rank), with the
        model put on it once."""
        if process_count() == 1:
            return None
        mesh = getattr(model, "decode_mesh", None)
        if mesh is not None:
            return mesh
        tp = int(self._args.get("decode_tensor_parallel") or 1)
        if self._args.get("decode_data_parallel") is False:
            if tp == 1:
                return None  # every rank decodes every batch whole
            # tensor-parallel only: the world is the model group
            mesh = make_mesh(data_parallel=1, model_parallel=tp)
        else:
            mesh = make_mesh(model_parallel=tp)
        if isinstance(model, EncoderDecoderEnsembleModel):
            # the members stay whole on every rank: only the batches are
            # split, over "data"
            logging.info("Ensemble decode over %d-way data parallelism "
                         "(members replicated)", mesh.shape["data"])
        else:
            apply_mesh(model, mesh)
            logging.info("Decode over %d-way data x %d-way tensor "
                         "parallelism", mesh.shape["data"],
                         mesh.shape["model"])
        model.decode_mesh = mesh
        return mesh

    @staticmethod
    def _shard_rows(mesh, model_inp):
        """(this rank's rows of the batch, whether they are a shard): the
        rows where they divide the "data" axis, else the whole batch."""
        if mesh is None or mesh.shape["data"] == 1:
            return model_inp, False
        rows = next(v.shape[0] for v in model_inp.values() if v.ndim)
        if rows % mesh.shape["data"]:
            return model_inp, False
        sl = data_slice(rows, mesh)
        return {k: v[sl] if v.ndim and v.shape[0] == rows else v
                for k, v in model_inp.items()}, True

    def run(self):
        if isinstance(self._custom_dataset, MultipleDataset):
            return self._run_multiple()
        task, args = self._task, self._args
        model = self._maybe_build_ensemble()
        if model is None:
            model = self.restore_params()
        mesh = self._decode_mesh(model)
        search = build_search_layer(args)
        search.set_model(model)
        search.prepare()
        batch_iter = task.create_batch_iterator(
            self._custom_dataset, ModeKeys.INFER, args)
        if int8_static_act_enabled() and model is self._model:
            self._calibrate_int8_static(model, search, batch_iter)
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
            rows = next(v.shape[0] for v in model_inp.values() if v.ndim)
            model_inp, sharded = self._shard_rows(mesh, model_inp)
            hyp, score = search(model_inp)
            if mesh is not None and model is self._model:
                # experts sharded over "data" serve the other ranks'
                # decode steps until every rank's search has ended
                drain_experts(model)
            hyp, score = hyp.cpu().numpy(), score.cpu().numpy()
            t2 = time.perf_counter()
            timing["decode_s"] += t2 - t1
            if timing["first_batch_s"] is None:
                timing["first_batch_s"] = t2 - start
            local = next(v.shape[0] for v in model_inp.values() if v.ndim)
            top_k = hyp.shape[0] // local
            tops = [(hyp[i * top_k].tolist(), float(score[i * top_k]))
                    for i in range(local)]
            if sharded:
                # every data rank's rows, in order
                tops = [t for part in collectives.all_gather_object(
                    tops, mesh.group("data")) for t in part]
            mask = batch.get("sample_mask")
            for i in range(rows):
                if mask is not None and mask[i] == 0:
                    continue
                hypotheses.append(hypo_decode(tops[i][0]))
                scores.append(tops[i][1])
            timing["detok_metric_s"] += time.perf_counter() - t2
        elapsed = time.perf_counter() - start
        n_samples = len(hypotheses)
        logging.info("Generation of %d samples took %.2fs (%.2f samples/s)",
                     n_samples, elapsed, n_samples / max(elapsed, 1e-6))

        t0 = time.perf_counter()
        rank0 = process_index() == 0
        if args.get("output_file") and rank0:
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
            if args.get("save_metric") and rank0:
                with open(args["save_metric"], "w") as f:
                    json.dump(results, f, indent=2)
        timing["detok_metric_s"] += time.perf_counter() - t0
        return {"hypotheses": hypotheses, "scores": scores, **results,
                "timing": timing}
