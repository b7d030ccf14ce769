"""The language-model task (the port's copy of
``neurst_tpu/tasks/language_model.py``): GPT-2 style language modelling
over mono text.

Model inputs:
    trg         int [B, T]  the text (TRAIN, EVAL)
    trg_input   int [B, T]  the text shifted right behind the
                            begin-of-sentence id (``begin_of_sentence``:
                            eos, GPT-2's convention, or bos); at INFER
                            the prompt itself
    trg_length, trg_padding, sample_mask

TRAIN batches are token-bucketed with ``batch_by_tokens`` (boundaries up
to ``max_trg_len``, 512 by default) after a reservoir shuffle; EVAL and
INFER batches are fixed-size.  The ``eval`` entry reads the criterion's
PPL; ``get_eval_metric`` builds the generation metric (BLEU unless
``metric.class`` says otherwise).
"""

from typing import Optional

import numpy as np

from neurst_tpu_torch.data import dataset_utils
from neurst_tpu_torch.data.data_pipelines.data_pipeline import \
    build_data_pipeline
from neurst_tpu_torch.metrics.metric import build_metric
from neurst_tpu_torch.models.model import build_model
from neurst_tpu_torch.tasks.task import Task, register_task
from neurst_tpu_torch.utils.compat import DataStatus, ModeKeys
from neurst_tpu_torch.utils.configurable import deep_merge_dict
from neurst_tpu_torch.utils.flags_core import Flag, ModuleFlag

__all__ = ["LanguageModel"]


@register_task("lm", "language_model")
class LanguageModel(Task):

    def __init__(self, args=None):
        super().__init__(args)
        cls = self._args.get("data_pipeline.class") or "TextDataPipeline"
        params = self._args.get("data_pipeline.params") or {}
        self._data_pipeline = build_data_pipeline(
            {"data_pipeline.class": cls, "data_pipeline.params": params})
        self._begin_of_sentence = self._args.get("begin_of_sentence") \
            or "eos"

    @property
    def pipeline(self):
        return self._data_pipeline

    def get_config(self):
        return {
            "data_pipeline.class": type(self._data_pipeline).__name__,
            "data_pipeline.params": self._data_pipeline.config,
            "begin_of_sentence": self._begin_of_sentence,
        }

    @staticmethod
    def class_or_method_args():
        args = Task.class_or_method_args()
        args.extend([
            ModuleFlag("data_pipeline", "data_pipeline",
                       help="The text data pipeline."),
            Flag("begin_of_sentence", dtype=Flag.TYPE.STRING, default="eos",
                 choices=["bos", "eos"],
                 help="The begin-of-sentence symbol (GPT-2 uses eos)."),
        ])
        return args

    def build_model(self, args, name=None, **kwargs):
        return build_model(args, trg_meta=self._data_pipeline.meta,
                           **kwargs)

    def get_data_preprocess_fn(self, mode, data_status=DataStatus.RAW,
                               args=None):
        if args is None:
            args = self._args
        else:
            args = deep_merge_dict(self._args, args, local_overwrite=False)
        max_len = args.get("max_trg_len") or args.get("max_len")
        truncate = args.get("truncate_trg")

        def _process(data):
            text = data.get("feature", data.get("tokens"))
            if data_status != DataStatus.PROJECTED:
                text = self._data_pipeline.encode(
                    text,
                    is_processed=(data_status == DataStatus.PROCESSED))
            ids = [int(x) for x in text]
            if mode == ModeKeys.TRAIN and truncate and max_len \
                    and len(ids) > max_len:
                ids = ids[:max_len - 1] + ids[-1:]
            return {"feature": ids}
        return _process

    def get_data_postprocess_fn(self, data_status, **kwargs):
        if data_status == DataStatus.PROJECTED:
            return self._data_pipeline.decode
        if data_status == DataStatus.PROCESSED:
            return self._data_pipeline.postprocess
        return lambda x: x

    def example_to_input(self, batch_of_data, mode):
        meta = self._data_pipeline.meta
        bos = (meta["eos_id"] if self._begin_of_sentence == "eos"
               else meta.get("bos_id", meta["eos_id"]))
        tokens = batch_of_data["feature"]
        lens = batch_of_data.get("feature_length")
        batch = tokens.shape[0]
        input_dict = {}
        if "sample_mask" in batch_of_data:
            input_dict["sample_mask"] = batch_of_data["sample_mask"]
        if mode == ModeKeys.INFER:
            input_dict["trg_input"] = tokens  # prompt
            input_dict["trg_length"] = lens
        else:
            tpos = np.arange(tokens.shape[1])[None, :]
            input_dict["trg"] = tokens
            input_dict["trg_length"] = lens
            input_dict["trg_padding"] = (
                tpos >= lens[:, None]).astype(np.float32)
            input_dict["trg_input"] = np.concatenate(
                [np.full([batch, 1], bos, np.int32), tokens[:, :-1]],
                axis=1)
        return input_dict

    def create_batch_iterator(self, ds, mode, args=None,
                              num_replicas_in_sync=1,
                              shard_id=0, total_shards=1):
        if args is None:
            args = self._args
        else:
            args = deep_merge_dict(self._args, args, local_overwrite=False)
        preprocess = self.get_data_preprocess_fn(mode, ds.status, args)
        pad = self._data_pipeline.meta["pad_id"]
        default_bs = None if mode == ModeKeys.TRAIN else 32
        batch_size = dataset_utils.adjust_batch_size(
            args.get("batch_size") or default_bs,
            args.get("batch_size_per_gpu"),
            num_replicas_in_sync, verbose=(shard_id == 0))
        multiple = int(args.get("pad_length_multiple") or 8)

        def make_iter():
            it = ds.build_iterator(map_func=preprocess, shard_id=shard_id,
                                   total_shards=total_shards)()
            if mode == ModeKeys.TRAIN:
                shuffle_buffer = args.get("shuffle_buffer")
                if shuffle_buffer is None or shuffle_buffer > 0:
                    it = dataset_utils.shuffle_iterator(
                        it, shuffle_buffer or 10000)
                if args.get("batch_by_tokens"):
                    max_len = args.get("max_trg_len") or 512
                    bounds = dataset_utils.create_batch_bucket_boundaries(
                        max_len, length_multiple=multiple)
                    batches = dataset_utils.batch_by_tokens_bucketed(
                        it, batch_size, {"feature": bounds},
                        {"feature": pad},
                        lambda ex: {"feature": len(ex["feature"])},
                        batch_size_multiple=(
                            args.get("batch_size_multiple")
                            or max(8, num_replicas_in_sync)))
                else:
                    batches = dataset_utils.batch_fixed_size(
                        it, batch_size, {"feature": pad},
                        fields=["feature"], pad_length_multiple=multiple)
            else:
                batches = dataset_utils.batch_fixed_size(
                    it, batch_size, {"feature": pad},
                    fields=["feature"], pad_length_multiple=multiple)
            yield from dataset_utils.prefetch_iterator(
                (self.example_to_input(b, mode) for b in batches))
        return make_iter

    def get_eval_metric(self, args, name="metric", ds=None):
        metric_cls = args.get(f"{name}.class") or "BLEU"
        params = dict(args.get(f"{name}.params") or {})
        params.setdefault(
            "language", self._data_pipeline.meta.get("language", "en"))
        return build_metric({"metric.class": metric_cls,
                             "metric.params": params})
