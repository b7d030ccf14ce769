"""The sequence-to-sequence task (the port's copy of
``neurst_tpu/tasks/seq2seq.py``), and the data-pipeline builder the
speech task shares.

Model inputs:
    src, src_length, src_padding   int [B, S], [B], float [B, S]
    trg_input  int [B] (INFER: the BOS id) or [B, T] (TRAIN, EVAL)
    trg, trg_length, trg_padding   (TRAIN, EVAL)
    sample_mask                    float [B], 0 on filler rows

``target_begin_of_sentence: eos`` starts the target with EOS (fairseq's
convention).  TRAIN truncation (``truncate_src`` / ``truncate_trg`` with
``max_src_len`` / ``max_trg_len``) keeps the last id, EOS.  TRAIN batches
are token-bucketed (``batch_by_tokens``: a ``batch_size`` budget of
tokens, geometric src/trg boundaries padded to ``pad_length_multiple``,
bucket batch sizes a multiple of ``batch_size_multiple``) after a
reservoir shuffle; otherwise, and for EVAL / INFER, fixed-size batches of
``batch_size`` rows (32 by default) padded to ``pad_length_multiple``.
"""

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

__all__ = ["build_pipeline", "Seq2Seq"]


def build_pipeline(args, key):
    """The data pipeline configured under ``{key}.class`` /
    ``{key}.params`` (``TextDataPipeline`` by default)."""
    return build_data_pipeline({
        "data_pipeline.class": args.get(f"{key}.class") or "TextDataPipeline",
        "data_pipeline.params": args.get(f"{key}.params") or {}})


def _padding(lengths, width):
    return (np.arange(width)[None, :] >= lengths[:, None]).astype(np.float32)


@register_task("seq_to_seq")
class Seq2Seq(Task):

    def __init__(self, args=None):
        super().__init__(args)
        self._src_data_pipeline = build_pipeline(self._args,
                                                 "src_data_pipeline")
        self._trg_data_pipeline = build_pipeline(self._args,
                                                 "trg_data_pipeline")
        self._target_begin_of_sentence = self._args.get(
            "target_begin_of_sentence") or "bos"

    @property
    def src_pipeline(self):
        return self._src_data_pipeline

    @property
    def trg_pipeline(self):
        return self._trg_data_pipeline

    def get_config(self):
        return {
            "src_data_pipeline.class":
                type(self._src_data_pipeline).__name__,
            "src_data_pipeline.params": self._src_data_pipeline.config,
            "trg_data_pipeline.class":
                type(self._trg_data_pipeline).__name__,
            "trg_data_pipeline.params": self._trg_data_pipeline.config,
            "target_begin_of_sentence": self._target_begin_of_sentence,
        }

    @staticmethod
    def class_or_method_args():
        return Task.class_or_method_args() + [
            ModuleFlag("src_data_pipeline", "data_pipeline",
                       help="The source side data pipeline."),
            ModuleFlag("trg_data_pipeline", "data_pipeline",
                       help="The target side data pipeline."),
            Flag("target_begin_of_sentence", dtype=Flag.TYPE.STRING,
                 default="bos", choices=["bos", "eos"],
                 help="The BOS symbol for the target side ('eos' for "
                      "fairseq compatibility)."),
        ]

    def build_model(self, args, name=None, **kwargs):
        return build_model(args, src_meta=self._src_data_pipeline.meta,
                           trg_meta=self._trg_data_pipeline.meta, **kwargs)

    def get_data_preprocess_fn(self, mode, data_status=DataStatus.RAW,
                               args=None):
        args = self._args if args is None else deep_merge_dict(
            self._args, args, local_overwrite=False)

        def one(text, pipeline, truncate, max_len):
            if data_status != DataStatus.PROJECTED:
                text = pipeline.encode(
                    text, is_processed=(data_status == DataStatus.PROCESSED))
            text = [int(x) for x in text]
            if mode == ModeKeys.TRAIN and truncate and max_len \
                    and len(text) > max_len:
                text = text[:max_len - 1] + text[-1:]  # keep EOS
            return text

        src = (self._src_data_pipeline, args.get("truncate_src"),
               args.get("max_src_len"))
        trg = (self._trg_data_pipeline, args.get("truncate_trg"),
               args.get("max_trg_len"))

        def process(data):
            out = {"feature": one(data["feature"], *src)}
            if "label" in data and mode != ModeKeys.INFER:
                out["label"] = one(data["label"], *trg)
            return out
        return process

    def get_data_postprocess_fn(self, data_status, is_src=False, **kwargs):
        pipeline = self._src_data_pipeline if is_src \
            else self._trg_data_pipeline
        if data_status == DataStatus.PROJECTED:
            return pipeline.decode
        if data_status == DataStatus.PROCESSED:
            return pipeline.postprocess
        return lambda x: x

    def example_to_input(self, batch_of_data: dict, mode) -> dict:
        """Model inputs of a batch; lengths missing from the batch count
        the non-pad ids plus one (the EOS, which pad equals), at most the
        width."""
        def lengths(ids, key, pipeline):
            got = batch_of_data.get(key)
            if got is not None:
                return got
            pad = pipeline.meta["pad_id"]
            return np.minimum((ids != pad).astype(np.int32).sum(axis=1) + 1,
                              ids.shape[1])

        src = batch_of_data["feature"]
        src_len = lengths(src, "feature_length", self._src_data_pipeline)
        input_dict = {"src": src, "src_length": src_len,
                      "src_padding": _padding(src_len, src.shape[1])}
        if "sample_mask" in batch_of_data:
            input_dict["sample_mask"] = batch_of_data["sample_mask"]
        meta = self._trg_data_pipeline.meta
        bos = meta["eos_id"] if self._target_begin_of_sentence == "eos" \
            else meta["bos_id"]
        batch = src.shape[0]
        if mode == ModeKeys.INFER:
            input_dict["trg_input"] = np.full([batch], bos, np.int32)
            return input_dict
        trg = batch_of_data["label"]
        trg_len = lengths(trg, "label_length", self._trg_data_pipeline)
        input_dict.update({
            "trg": trg, "trg_length": trg_len,
            "trg_padding": _padding(trg_len, trg.shape[1]),
            "trg_input": np.concatenate(
                [np.full([batch, 1], bos, np.int32), trg[:, :-1]], axis=1)})
        return input_dict

    def create_batch_iterator(self, ds, mode, args=None,
                              num_replicas_in_sync=1,
                              shard_id=0, total_shards=1):
        args = self._args if args is None else deep_merge_dict(
            self._args, args, local_overwrite=False)
        preprocess = self.get_data_preprocess_fn(mode, ds.status, args)
        pads = {"feature": self._src_data_pipeline.meta["pad_id"],
                "label": self._trg_data_pipeline.meta["pad_id"]}
        batch_size = dataset_utils.adjust_batch_size(
            args.get("batch_size") or (None if mode == ModeKeys.TRAIN
                                       else 32),
            args.get("batch_size_per_gpu") or args.get(
                "batch_size_per_replica"),
            num_replicas_in_sync, verbose=(shard_id == 0))
        multiple = int(args.get("pad_length_multiple") or 8)

        def train_batches(it):
            shuffle_buffer = args.get("shuffle_buffer")
            if shuffle_buffer is None or shuffle_buffer > 0:
                it = dataset_utils.shuffle_iterator(it,
                                                    shuffle_buffer or 10000)
            if not args.get("batch_by_tokens"):
                return dataset_utils.batch_fixed_size(
                    it, batch_size, pads, fields=["feature", "label"],
                    pad_length_multiple=multiple)
            bounds = [dataset_utils.create_batch_bucket_boundaries(
                args.get(key) or 128, length_multiple=multiple)
                for key in ("max_src_len", "max_trg_len")]
            b_src, b_trg = dataset_utils.associated_bucket_boundaries(
                *bounds)
            return dataset_utils.batch_by_tokens_bucketed(
                it, batch_size, {"feature": b_src, "label": b_trg}, pads,
                lambda ex: {"feature": len(ex["feature"]),
                            "label": len(ex["label"])},
                batch_size_multiple=(args.get("batch_size_multiple")
                                     or max(8, num_replicas_in_sync)))

        def make_iter():
            it = ds.build_iterator(map_func=preprocess, shard_id=shard_id,
                                   total_shards=total_shards)()
            if mode == ModeKeys.TRAIN:
                batches = train_batches(it)
            else:
                batches = dataset_utils.batch_fixed_size(
                    it, batch_size, pads,
                    fields=["feature"] + ([] if mode == ModeKeys.INFER
                                          else ["label"]),
                    pad_length_multiple=multiple)
            yield from dataset_utils.prefetch_iterator(
                self.example_to_input(b, mode) for b in batches)
        return make_iter

    def get_eval_metric(self, args, name="metric", ds=None):
        params = dict(args.get(f"{name}.params") or {})
        params.setdefault(
            "language", self._trg_data_pipeline.meta.get("language", "en"))
        return build_metric({"metric.class": args.get(f"{name}.class")
                             or "BLEU", "metric.params": params})
