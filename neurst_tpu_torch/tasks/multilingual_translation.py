"""Many-to-many multilingual translation (the port's copy of
``neurst_tpu/tasks/multilingual_translation.py``).

One ``MultilingualTextDataPipeline`` serves both sides; examples carry
``src_lang`` / ``trg_lang`` (``MultilingualTranslationDataset``, mixed by
``mixed_train``).  The target-language tag is the target's BOS
(``trg_lang_tag_position: trg``) or is prepended to the source (``src``);
``with_src_lang_tag`` also prepends the source-language tag, after the
target's.  TRAIN batches are token-bucketed (``batch_by_tokens``) or of a
fixed size, EVAL and INFER batches of ``batch_size`` rows (32 by
default); the tags ride along as int32 [B] fields.

As in the JAX package, an INFER batch carries the target tag as
``trg_input``, but the models' ``prepare_generation`` starts every row
from ``bos_id`` (ROADMAP R13): with ``trg_lang_tag_position: trg`` a
decode does not see which language to produce.
"""

import numpy as np

from neurst_tpu_torch.data import dataset_utils
from neurst_tpu_torch.data.data_pipelines.multilingual_text_data_pipeline \
    import MultilingualTextDataPipeline
from neurst_tpu_torch.metrics.metric import build_metric
from neurst_tpu_torch.models.model import build_model
from neurst_tpu_torch.tasks.seq2seq import _padding
from neurst_tpu_torch.tasks.task import Task, register_task
from neurst_tpu_torch.utils.compat import DataStatus, ModeKeys
from neurst_tpu_torch.utils.configurable import deep_merge_dict
from neurst_tpu_torch.utils.flags_core import Flag, ModuleFlag

__all__ = ["MultilingualTranslation"]

_TRG_LANG_TAG_POSITIONS = ("trg", "target", "src", "source")
_LANG_FIELDS = ("src_lang", "trg_lang")


@register_task("multilingual_translation")
class MultilingualTranslation(Task):

    def __init__(self, args=None):
        super().__init__(args)
        params = dict(self._args.get("multilingual_dp.params")
                      or self._args.get("data_pipeline.params") or {})
        self._dp = MultilingualTextDataPipeline(**params)
        self._with_src_lang_tag = bool(self._args.get("with_src_lang_tag"))
        self._trg_lang_tag_position = self._args.get(
            "trg_lang_tag_position") or "trg"
        if self._trg_lang_tag_position not in _TRG_LANG_TAG_POSITIONS:
            raise ValueError(f"trg_lang_tag_position must be one of "
                             f"{_TRG_LANG_TAG_POSITIONS}, got "
                             f"{self._trg_lang_tag_position}")

    @property
    def pipeline(self):
        return self._dp

    def get_config(self):
        return {
            "multilingual_dp.params": self._dp.config,
            "with_src_lang_tag": self._with_src_lang_tag,
            "trg_lang_tag_position": self._trg_lang_tag_position,
        }

    @staticmethod
    def class_or_method_args():
        return Task.class_or_method_args() + [
            ModuleFlag("multilingual_dp", "data_pipeline",
                       help="The shared multilingual data pipeline."),
            Flag("with_src_lang_tag", dtype=Flag.TYPE.BOOLEAN,
                 default=False,
                 help="Prepend the source-language tag to the source."),
            Flag("trg_lang_tag_position", dtype=Flag.TYPE.STRING,
                 default="trg", choices=list(_TRG_LANG_TAG_POSITIONS),
                 help="Where the target-language tag goes (trg = BOS)."),
        ]

    def build_model(self, args, name=None, **kwargs):
        return build_model(args, src_meta=self._dp.meta,
                           trg_meta=self._dp.meta, **kwargs)

    def get_data_preprocess_fn(self, mode, data_status=DataStatus.RAW,
                               args=None):
        args = self._args if args is None else deep_merge_dict(
            self._args, args, local_overwrite=False)
        trunc_src, trunc_trg = args.get("truncate_src"), \
            args.get("truncate_trg")
        max_src, max_trg = args.get("max_src_len"), args.get("max_trg_len")

        def one(text, truncate, max_len):
            if data_status != DataStatus.PROJECTED:
                text = self._dp.encode(
                    text, is_processed=(data_status == DataStatus.PROCESSED))
            text = [int(x) for x in text]
            if mode == ModeKeys.TRAIN and truncate and max_len \
                    and len(text) > max_len:
                text = text[:max_len - 1] + text[-1:]  # keep EOS
            return text

        def lang(value):
            if isinstance(value, str):
                if value.startswith("<"):
                    value = value[1:-1]
                return self._dp.meta["lang2id"][value]
            return int(value)

        def process(data):
            out = {"feature": one(data["feature"], trunc_src, max_src),
                   "src_lang": lang(data["src_lang"]),
                   "trg_lang": lang(data["trg_lang"])}
            if "label" in data and mode != ModeKeys.INFER:
                out["label"] = one(data["label"], trunc_trg, max_trg)
            return out
        return process

    def get_data_postprocess_fn(self, data_status, **kwargs):
        if data_status == DataStatus.PROJECTED:
            return self._dp.decode
        if data_status == DataStatus.PROCESSED:
            return self._dp.postprocess
        return lambda x: x

    def example_to_input(self, batch_of_data: dict, mode) -> dict:
        src = batch_of_data["feature"]
        batch = src.shape[0]
        src_len = batch_of_data["feature_length"].copy()
        prepend = []
        if self._trg_lang_tag_position in ("src", "source"):
            prepend.append(batch_of_data["trg_lang"])
        if self._with_src_lang_tag:
            prepend.append(batch_of_data["src_lang"])
        for tag in prepend:
            src = np.concatenate([tag[:, None].astype(np.int32), src],
                                 axis=1)
            src_len = src_len + 1
        input_dict = {"src": src, "src_length": src_len,
                      "src_padding": _padding(src_len, src.shape[1])}
        if "sample_mask" in batch_of_data:
            input_dict["sample_mask"] = batch_of_data["sample_mask"]
        if self._trg_lang_tag_position in ("trg", "target"):
            target_bos = batch_of_data["trg_lang"].astype(np.int32)
        else:
            target_bos = np.full([batch], self._dp.meta["bos_id"], np.int32)
        if mode == ModeKeys.INFER:
            input_dict["trg_input"] = target_bos
            return input_dict
        trg, trg_len = batch_of_data["label"], batch_of_data["label_length"]
        input_dict.update({
            "trg": trg, "trg_length": trg_len,
            "trg_padding": _padding(trg_len, trg.shape[1]),
            "trg_input": np.concatenate([target_bos[:, None], trg[:, :-1]],
                                        axis=1)})
        return input_dict

    def create_batch_iterator(self, ds, mode, args=None,
                              num_replicas_in_sync=1,
                              shard_id=0, total_shards=1):
        args = self._args if args is None else deep_merge_dict(
            self._args, args, local_overwrite=False)
        preprocess = self.get_data_preprocess_fn(mode, ds.status, args)
        pad = self._dp.meta["pad_id"]
        pads = {"feature": pad, "label": pad}
        batch_size = dataset_utils.adjust_batch_size(
            args.get("batch_size")
            or (None if mode == ModeKeys.TRAIN else 32),
            args.get("batch_size_per_gpu"), num_replicas_in_sync,
            verbose=(shard_id == 0))
        multiple = int(args.get("pad_length_multiple") or 8)
        fields = ["feature"] if mode == ModeKeys.INFER \
            else ["feature", "label"]

        def train_batches(it):
            shuffle_buffer = args.get("shuffle_buffer")
            if shuffle_buffer is None or shuffle_buffer > 0:
                it = dataset_utils.shuffle_iterator(it,
                                                    shuffle_buffer or 10000)
            if not args.get("batch_by_tokens"):
                return dataset_utils.batch_fixed_size(
                    it, batch_size, pads, fields=fields,
                    pad_length_multiple=multiple, extra_fields=_LANG_FIELDS)
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
                                     or max(8, num_replicas_in_sync)),
                extra_fields=_LANG_FIELDS)

        def finalize(batch):
            for f in _LANG_FIELDS:
                batch[f] = np.asarray([0 if v is None else int(v)
                                       for v in batch[f]], np.int32)
            return self.example_to_input(batch, mode)

        def make_iter():
            it = ds.build_iterator(map_func=preprocess, shard_id=shard_id,
                                   total_shards=total_shards)()
            if mode == ModeKeys.TRAIN:
                batches = train_batches(it)
            else:
                batches = dataset_utils.batch_fixed_size(
                    it, batch_size, pads, fields=fields,
                    pad_length_multiple=multiple, extra_fields=_LANG_FIELDS)
            yield from dataset_utils.prefetch_iterator(
                finalize(b) for b in batches)
        return make_iter

    def get_eval_metric(self, args, name="metric", ds=None):
        return build_metric({"metric.class": args.get(f"{name}.class")
                             or "BLEU",
                             "metric.params": dict(
                                 args.get(f"{name}.params") or {})})
