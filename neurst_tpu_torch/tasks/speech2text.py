"""Speech-to-text tasks, ASR and end-to-end ST (the port's counterparts of
``SpeechToText`` and ``MultiTaskSpeechTranslation`` in
``neurst_tpu/tasks/speech2text.py``).

Model inputs:
    src        float [B, frames, feat_dim, channels]
    src_length int    [B]
    trg_input  int    [B] (INFER: the BOS id) or [B, U] (TRAIN, EVAL)
    trg, trg_length, trg_padding (TRAIN, EVAL)

INFER / EVAL: audio is flattened to one sequence field and padded to a
multiple of 64 frames by ``batch_fixed_size``; the last batch is filled up
with rows of length 0 that ``sample_mask`` marks 0.

TRAIN: SpecAugment masks each utterance on the host, and batches are
bucketed in two dimensions, frames and transcript length: geometric frame
boundaries (``create_audio_bucket_boundaries``), a batch size per bucket
from the frame budget, a transcript cap per bucket from
``experimental_frame_transcript_ratio`` with the next bucket's cap as the
one fallback shape, and a bucket's batch filled up with zero rows of
length 0 that ``sample_mask`` marks 0.  Every non-empty bucket is flushed
at the end of an epoch.  The text fields a batch carries are the task's
``_batch_text_fields`` (the transcript; the multi-task task adds the
translation), and the text length of an example is its longest field's.
"""

import logging

import numpy as np

from neurst_tpu_torch.data import dataset_utils
from neurst_tpu_torch.data.dataset_utils import round_up
from neurst_tpu_torch.metrics.metric import build_metric
from neurst_tpu_torch.models.model import build_model
from neurst_tpu_torch.tasks.seq2seq import build_pipeline
from neurst_tpu_torch.tasks.task import Task, register_task
from neurst_tpu_torch.utils.audio_lib import SpecAugment
from neurst_tpu_torch.utils.compat import DataStatus, ModeKeys
from neurst_tpu_torch.utils.configurable import deep_merge_dict
from neurst_tpu_torch.utils.flags_core import Flag, ModuleFlag

__all__ = ["SpeechToText", "MultiTaskSpeechTranslation",
           "create_audio_bucket_boundaries", "train_bucket_shapes"]


def create_audio_bucket_boundaries(maxlen: int, minlen: int = 128):
    """Geometric frame-count boundaries from ``minlen`` (x1.2 each) up to
    ``maxlen``, which is the last."""
    if minlen is None:
        minlen = 128
    bounds = []
    x = minlen
    while x < maxlen:
        bounds.append(x)
        x = max(x + 1, int(x * 1.2))
    bounds.append(maxlen)
    return bounds


def train_bucket_shapes(args, num_replicas=1):
    """The TRAIN buckets of ``args``: (frame bounds, [(batch size, frame
    bound, sorted transcript caps)] one a bucket).  The frame budget
    ``batch_size`` per replica must exceed ``max_src_len``; a bucket's
    batch size is the budget over its bound, rounded up to a multiple of
    8 (floored at 8) unless ``disable_batch_efficiency``, then to
    ``batch_size_multiple``; its transcript caps are its own and the next
    bucket's."""
    batch_size = dataset_utils.adjust_batch_size(
        args.get("batch_size"),
        args.get("batch_size_per_gpu") or args.get("batch_size_per_replica"),
        num_replicas, verbose=False)
    max_src_len = int(args.get("max_src_len") or 3000)
    max_trg_len = int(args.get("max_trg_len") or 120)
    bounds = create_audio_bucket_boundaries(
        max_src_len, args.get("min_src_bucket_boundary"))
    bounds[-1] = round_up(bounds[-1], 8)
    replicas = max(num_replicas, 1)
    bs_per_replica = batch_size // replicas
    if bs_per_replica <= max_src_len:
        raise ValueError(f"the frame budget per replica ({bs_per_replica}) "
                         f"must exceed max_src_len={max_src_len}")
    multiple = int(args.get("batch_size_multiple") or max(8, num_replicas))
    if args.get("disable_batch_efficiency"):
        sizes = [max(int(bs_per_replica // b), 1) * replicas for b in bounds]
    else:
        sizes = [max(round_up(int(bs_per_replica // b), 8), 8) * replicas
                 for b in bounds]
    sizes = [round_up(b, multiple) for b in sizes]
    ratio = args.get("experimental_frame_transcript_ratio")
    if ratio is None:
        logging.warning("experimental_frame_transcript_ratio not set; "
                        "max_trg_len caps every audio bucket")
        caps = [max_trg_len] * len(bounds)
    else:
        caps = [int(b / (ratio + i * (max_src_len / max_trg_len - ratio)
                         / len(bounds))) for i, b in enumerate(bounds)]
        caps = [round_up(min(t, max_trg_len), 8) for t in caps]
    shapes = [(sizes[i], bounds[i],
               sorted({caps[i], caps[min(i + 1, len(bounds) - 1)]}))
              for i in range(len(bounds))]
    return bounds, shapes


@register_task("speech2text", "audio2text", "AudioToText")
class SpeechToText(Task):

    def __init__(self, args=None):
        super().__init__(args)
        self._trg_data_pipeline = build_pipeline(self._args,
                                                 "transcript_data_pipeline")
        self._audio_feature_dim = int(
            self._args.get("audio_feature_dim") or 80)
        self._audio_feature_channels = int(
            self._args.get("audio_feature_channels") or 1)
        self._specaug = SpecAugment.build(self._args.get("specaug"))

    @property
    def trg_pipeline(self):
        return self._trg_data_pipeline

    def get_config(self):
        return {
            "transcript_data_pipeline.class":
                type(self._trg_data_pipeline).__name__,
            "transcript_data_pipeline.params":
                self._trg_data_pipeline.config,
            "audio_feature_dim": self._audio_feature_dim,
            "audio_feature_channels": self._audio_feature_channels,
        }

    @staticmethod
    def class_or_method_args():
        return Task.class_or_method_args() + [
            ModuleFlag("transcript_data_pipeline", "data_pipeline",
                       help="The data pipeline for the target text."),
            Flag("audio_feature_dim", dtype=Flag.TYPE.INTEGER, default=80,
                 help="The dimension of audio features."),
            Flag("audio_feature_channels", dtype=Flag.TYPE.INTEGER,
                 default=1, help="The number of audio feature channels."),
            Flag("specaug", dtype=Flag.TYPE.STRING, default=None,
                 help="SpecAugment setting (TRAIN only): LB/LD/SM/SS or a "
                      "YAML dict."),
            Flag("min_src_bucket_boundary", dtype=Flag.TYPE.INTEGER,
                 default=128, help="The minimum audio bucket boundary."),
            Flag("experimental_frame_transcript_ratio",
                 dtype=Flag.TYPE.FLOAT, default=None,
                 help="The frames/transcript-length ratio for 2-D "
                      "bucketing (TRAIN only)."),
            Flag("disable_batch_efficiency", dtype=Flag.TYPE.BOOLEAN,
                 default=None, help="Disable rounding bucket batch sizes "
                                    "to multiples of 8 (TRAIN only)."),
            Flag("batch_by_frames", dtype=Flag.TYPE.BOOLEAN, default=True,
                 help="Interpret batch_size as an audio-frames budget in "
                      "TRAIN mode."),
        ]

    def _src_meta(self):
        return {"audio_feature_dim": self._audio_feature_dim,
                "audio_feature_channels": self._audio_feature_channels}

    def build_model(self, args, name=None, **kwargs):
        return build_model(args, src_meta=self._src_meta(),
                           trg_meta=self._trg_data_pipeline.meta, **kwargs)

    def _feature_elems(self):
        return self._audio_feature_dim * self._audio_feature_channels

    def get_data_preprocess_fn(self, mode, data_status=DataStatus.RAW,
                               args=None):
        args = self._args if args is None else deep_merge_dict(
            self._args, args, local_overwrite=False)
        if isinstance(data_status, dict):
            audio_status = data_status.get("audio", DataStatus.PROJECTED)
            trans_status = data_status.get("transcript", DataStatus.RAW)
        else:
            audio_status = trans_status = data_status
        if audio_status != DataStatus.PROJECTED:
            raise RuntimeError("Audio must be feature-extracted in advance "
                               "(records of fbank features).")
        trunc = args.get("truncate_src")
        max_src_len = args.get("max_src_len")
        max_trg_len = args.get("max_trg_len")
        truncate_trg = mode == ModeKeys.TRAIN and args.get("truncate_trg") \
            and max_trg_len
        feat_elems = self._feature_elems()
        specaug = self._specaug if mode == ModeKeys.TRAIN else None

        def _process(data):
            audio = np.asarray(data["audio"], np.float32).reshape(-1)
            if trunc and max_src_len:
                audio = audio[:max_src_len * feat_elems]
            frames = len(audio) // feat_elems
            audio = audio.reshape(frames, feat_elems)
            if specaug is not None:
                audio = specaug.apply_numpy(audio)
            out = {"audio": audio, "audio_length": frames}
            transcript = data.get("transcript")
            if transcript is not None and mode != ModeKeys.INFER:
                if trans_status != DataStatus.PROJECTED:
                    transcript = self._trg_data_pipeline.encode(
                        transcript,
                        is_processed=(trans_status == DataStatus.PROCESSED))
                transcript = [int(x) for x in transcript]
                if truncate_trg and len(transcript) > max_trg_len:
                    # keep the last id (EOS)
                    transcript = transcript[:max_trg_len - 1] \
                        + transcript[-1:]
                out["transcript"] = transcript
            if "translation" in data:
                out["translation"] = data["translation"]
            return out
        return _process

    def get_data_postprocess_fn(self, data_status, **kwargs):
        if isinstance(data_status, dict):
            data_status = data_status.get("transcript", DataStatus.RAW)
        if data_status == DataStatus.PROJECTED:
            return self._trg_data_pipeline.decode
        if data_status == DataStatus.PROCESSED:
            return self._trg_data_pipeline.postprocess
        return lambda x: x

    def example_to_input(self, batch_of_data: dict, mode) -> dict:
        audio = batch_of_data["audio"]
        batch, frames = audio.shape[0], audio.shape[1]
        input_dict = {
            "src": audio.reshape(batch, frames, self._audio_feature_dim,
                                 self._audio_feature_channels),
            "src_length": batch_of_data["audio_length"],
        }
        if "sample_mask" in batch_of_data:
            input_dict["sample_mask"] = batch_of_data["sample_mask"]
        bos = self._trg_data_pipeline.meta["bos_id"]
        if mode == ModeKeys.INFER:
            input_dict["trg_input"] = np.full([batch], bos, np.int32)
            return input_dict
        trg = batch_of_data["transcript"]
        trg_len = batch_of_data["transcript_length"]
        input_dict["trg"] = trg
        input_dict["trg_length"] = trg_len
        input_dict["trg_padding"] = (np.arange(trg.shape[1])[None, :]
                                     >= trg_len[:, None]).astype(np.float32)
        input_dict["trg_input"] = np.concatenate(
            [np.full([batch, 1], bos, np.int32), trg[:, :-1]], axis=1)
        return input_dict

    def create_batch_iterator(self, ds, mode, args=None,
                              num_replicas_in_sync=1,
                              shard_id=0, total_shards=1):
        """TRAIN: 2-D bucketed batches (``_train_iterator``).  INFER /
        EVAL: batches of ``batch_size`` (16 by default) utterances, audio
        padded to a multiple of 64 frames."""
        args = self._args if args is None else deep_merge_dict(
            self._args, args, local_overwrite=False)
        preprocess = self.get_data_preprocess_fn(mode, ds.status, args)
        if mode == ModeKeys.TRAIN:
            return self._train_iterator(ds, preprocess, args,
                                        num_replicas_in_sync, shard_id,
                                        total_shards)
        feat_elems = self._feature_elems()
        text_fields = self._batch_text_fields()
        batch_size = dataset_utils.adjust_batch_size(
            args.get("batch_size") or 16,
            args.get("batch_size_per_gpu") or args.get(
                "batch_size_per_replica"),
            num_replicas_in_sync, verbose=(shard_id == 0))
        fields = ["audio"] + ([] if mode == ModeKeys.INFER
                              else [f for f, _ in text_fields])

        def make_iter():
            it = ds.build_iterator(map_func=preprocess, shard_id=shard_id,
                                   total_shards=total_shards)()
            # audio is padded on the flattened feature axis, so the
            # batcher treats it as one sequence field
            flat = ({"audio": ex["audio"].reshape(-1),
                     "audio_frames": ex["audio_length"],
                     **{f: ex[f] for f, _ in text_fields if f in ex}}
                    for ex in it)
            for b in dataset_utils.batch_fixed_size(
                    flat, batch_size, {"audio": 0, **dict(text_fields)},
                    fields=fields, pad_length_multiple=64 * feat_elems,
                    extra_fields=("audio_frames",)):
                frames = b["audio"].shape[1] // feat_elems
                batch = {
                    "audio": b["audio"].reshape(batch_size, frames,
                                                feat_elems),
                    "audio_length": np.asarray(
                        [0 if x is None else int(x)
                         for x in b["audio_frames"]], np.int32),
                    "sample_mask": b["sample_mask"]}
                for f, _ in text_fields:
                    if f in b:
                        batch[f] = b[f]
                        batch[f + "_length"] = b[f + "_length"]
                yield self.example_to_input(batch, mode)
        return make_iter

    def _batch_text_fields(self):
        """[(field, pad id)] of the text fields batches carry (the
        multi-task subclass adds the translation)."""
        return [("transcript", self._trg_data_pipeline.meta["pad_id"])]

    def _train_iterator(self, ds, preprocess, args, num_replicas, shard_id,
                        total_shards):
        """Batches of (frames x text) buckets, the text length an
        example's longest text field: an example goes to the first bucket
        whose frame bound and larger text cap hold it (examples no bucket
        holds are dropped and counted); a full bucket is emitted at the
        smaller cap that holds its longest text, and every non-empty
        bucket at the end of the epoch."""
        bounds, shapes = train_bucket_shapes(args, num_replicas)
        if shard_id == 0:
            logging.info("speech2text: %d input shapes",
                         sum(len(caps) for _, _, caps in shapes))
            for bs, bound, caps in shapes:
                logging.info("  - batch=%d frames<=%d transcript<=%s", bs,
                             bound, caps)
        feat_elems = self._feature_elems()
        text_fields = self._batch_text_fields()

        def text_len(ex):
            return max(len(ex[f]) for f, _ in text_fields)

        def emit(exs, i):
            bs, bound, caps = shapes[i]
            tmax = max(text_len(ex) for ex in exs)
            tcap = next((t for t in caps if tmax <= t), caps[-1])
            audio = np.zeros([bs, bound, feat_elems], np.float32)
            lens = np.zeros([bs], np.int32)
            batch = {"audio": audio, "audio_length": lens}
            for f, pad in text_fields:
                batch[f] = np.full([bs, tcap], pad, np.int32)
                batch[f + "_length"] = np.zeros([bs], np.int32)
            for j, ex in enumerate(exs):
                audio[j, :ex["audio_length"]] = ex["audio"]
                lens[j] = ex["audio_length"]
                for f, _ in text_fields:
                    ids = ex[f][:tcap]
                    batch[f][j, :len(ids)] = ids
                    batch[f + "_length"][j] = len(ids)
            batch["sample_mask"] = np.zeros([bs], np.float32)
            batch["sample_mask"][:len(exs)] = 1.0
            return self.example_to_input(batch, ModeKeys.TRAIN)

        def make_iter():
            it = ds.build_iterator(map_func=preprocess, shard_id=shard_id,
                                   total_shards=total_shards)()
            shuffle_buffer = args.get("shuffle_buffer")
            if shuffle_buffer is None or shuffle_buffer > 0:
                it = dataset_utils.shuffle_iterator(it, shuffle_buffer or 512)
            buckets = [[] for _ in bounds]
            dropped = 0
            for ex in dataset_utils.prefetch_iterator(it):
                if any(f not in ex for f, _ in text_fields):
                    continue
                frames, tlen = ex["audio_length"], text_len(ex)
                i = next((i for i, (_, bound, caps) in enumerate(shapes)
                          if frames <= bound and tlen <= caps[-1]), None)
                if i is None:
                    dropped += 1
                    if dropped % 1000 == 1:
                        logging.warning(
                            "speech2text: dropped %d unbucketable examples "
                            "so far (frames=%d transcript=%d)", dropped,
                            frames, tlen)
                    continue
                buckets[i].append(ex)
                if len(buckets[i]) >= shapes[i][0]:
                    exs, buckets[i] = buckets[i], []
                    yield emit(exs, i)
            for i, exs in enumerate(buckets):
                if exs:
                    yield emit(exs, i)
        return make_iter

    def get_eval_metric(self, args, name="metric", ds=None):
        params = dict(args.get(f"{name}.params") or {})
        params.setdefault(
            "language", self._trg_data_pipeline.meta.get("language", "en"))
        return build_metric({"metric.class": args.get(f"{name}.class")
                             or "WER", "metric.params": params})


@register_task("multi_task_speech_translation", "MultiTaskSpeechTranslation")
class MultiTaskSpeechTranslation(SpeechToText):
    """Joint ASR + ST from audio triples (audio, transcript, translation).

    ``get_data_preprocess_fn`` projects both text sides (the transcript by
    the inherited pipeline, the translation by
    ``translation_data_pipeline``): stage 03 of the speech recipes writes
    its triple records through it with ``create_records``.  Batches carry
    both sides through the parent's 2-D frames x text bucketing (the text
    cap the longer side's); ``example_to_input`` gives the translation as
    the primary ``trg*`` targets and the transcript as ``asr_trg*``.
    Generation decodes the ST side, or with ``--generation_output asr``
    the transcript (postprocessing, metric and references follow the
    side).  ``build_model`` builds ``MultiTaskSpeechTransformer``, which
    trains through ``joint_criterion``.
    """

    def __init__(self, args=None):
        super().__init__(args)
        self._translation_pipeline = build_pipeline(
            self._args, "translation_data_pipeline") \
            if self._args.get("translation_data_pipeline.class") else None

    @staticmethod
    def class_or_method_args():
        return SpeechToText.class_or_method_args() + [
            ModuleFlag("translation_data_pipeline", "data_pipeline",
                       help="The data pipeline for the translation text."),
            Flag("generation_output", dtype=Flag.TYPE.STRING, default="st",
                 choices=["st", "asr"],
                 help="Which head generation decodes: the translation "
                      "(st) or the transcript (asr)."),
        ]

    def get_config(self):
        cfg = super().get_config()
        if self._translation_pipeline is not None:
            cfg["translation_data_pipeline.class"] = \
                type(self._translation_pipeline).__name__
            cfg["translation_data_pipeline.params"] = \
                self._translation_pipeline.config
        cfg["generation_output"] = self._gen_side
        return cfg

    @property
    def _gen_side(self):
        return self._args.get("generation_output") or "st"

    def _gen_pipeline(self):
        if self._gen_side == "asr" or self._translation_pipeline is None:
            return self._trg_data_pipeline
        return self._translation_pipeline

    def get_data_preprocess_fn(self, mode, data_status=DataStatus.RAW,
                               args=None):
        base = super().get_data_preprocess_fn(mode, data_status, args)
        if isinstance(data_status, dict):
            trans_status = data_status.get("translation", DataStatus.RAW)
        else:
            trans_status = data_status

        def _process(data):
            out = base(data)
            translation = out.get("translation")
            if translation is not None \
                    and self._translation_pipeline is not None \
                    and trans_status != DataStatus.PROJECTED:
                out["translation"] = [int(x) for x in
                                      self._translation_pipeline.encode(
                    translation,
                    is_processed=(trans_status == DataStatus.PROCESSED))]
            return out
        return _process

    def _batch_text_fields(self):
        fields = super()._batch_text_fields()
        if self._translation_pipeline is not None:
            fields.append(
                ("translation", self._translation_pipeline.meta["pad_id"]))
        return fields

    def example_to_input(self, batch_of_data, mode):
        audio = batch_of_data["audio"]
        batch, frames = audio.shape[0], audio.shape[1]
        input_dict = {
            "src": audio.reshape(batch, frames, self._audio_feature_dim,
                                 self._audio_feature_channels),
            "src_length": batch_of_data["audio_length"],
        }
        if "sample_mask" in batch_of_data:
            input_dict["sample_mask"] = batch_of_data["sample_mask"]
        if mode == ModeKeys.INFER:
            input_dict["trg_input"] = np.full(
                [batch], self._gen_pipeline().meta["bos_id"], np.int32)
            return input_dict

        def put(prefix, field, meta):
            trg = batch_of_data[field]
            trg_len = batch_of_data[field + "_length"]
            input_dict[prefix + "trg"] = trg
            input_dict[prefix + "trg_length"] = trg_len
            input_dict[prefix + "trg_padding"] = (
                np.arange(trg.shape[1])[None, :]
                >= trg_len[:, None]).astype(np.float32)
            input_dict[prefix + "trg_input"] = np.concatenate(
                [np.full([batch, 1], meta["bos_id"], np.int32),
                 trg[:, :-1]], axis=1)

        # the translation is the primary head (trg*), the transcript the
        # ASR head
        put("", "translation", self._translation_pipeline.meta)
        put("asr_", "transcript", self._trg_data_pipeline.meta)
        return input_dict

    def build_model(self, args, name=None, **kwargs):
        """The multi-task model over the translation (``trg_meta``) and
        transcript (``asr_meta``) vocabularies; ``generation_output: asr``
        of the task reaches the model's params."""
        if self._translation_pipeline is None:
            raise ValueError(
                "multi_task_speech_translation requires "
                "translation_data_pipeline.class for the model build "
                "(preprocess-only use works without it)")
        if self._gen_side == "asr":
            args = dict(args, **{"model.params": dict(
                args.get("model.params") or {}, generation_output="asr")})
        return build_model(args, src_meta=self._src_meta(),
                           trg_meta=self._translation_pipeline.meta,
                           asr_meta=self._trg_data_pipeline.meta, **kwargs)

    def get_data_postprocess_fn(self, data_status, **kwargs):
        if isinstance(data_status, dict):
            key = "transcript" if self._gen_side == "asr" else "translation"
            data_status = data_status.get(key, DataStatus.RAW)
        pipeline = self._gen_pipeline()
        if data_status == DataStatus.PROJECTED:
            return pipeline.decode
        if data_status == DataStatus.PROCESSED:
            return pipeline.postprocess
        return lambda x: x

    def get_eval_metric(self, args, name="metric", ds=None):
        default_cls = "WER" if self._gen_side == "asr" else "bleu"
        params = dict(args.get(f"{name}.params") or {})
        params.setdefault(
            "language", self._gen_pipeline().meta.get("language", "en"))
        return build_metric({"metric.class": args.get(f"{name}.class")
                             or default_cls, "metric.params": params})

    def eval_targets(self, dataset):
        """The translations (the dataset's targets), or the transcripts
        where generation decodes the ASR side."""
        if self._gen_side == "asr":
            try:
                return [ex["transcript"]
                        for ex in dataset.build_iterator()()
                        if "transcript" in ex]
            except (AttributeError, OSError):
                return None
        return super().eval_targets(dataset)
