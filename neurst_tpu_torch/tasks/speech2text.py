"""Speech-to-text task, ASR and end-to-end ST (the port's counterpart of
``SpeechToText`` in ``neurst_tpu/tasks/speech2text.py``; the inference and
evaluation side).

Model inputs:
    src        float [B, frames, feat_dim, channels]
    src_length int    [B]
    trg_input  int    [B] (INFER: the BOS id) or [B, U] (EVAL)

Audio is flattened to one sequence field and padded to a multiple of 64
frames by ``batch_fixed_size``; the last batch is filled up with rows of
length 0 that ``sample_mask`` marks 0.  The bucketed TRAIN iterator and
SpecAugment are not ported yet: TRAIN mode raises.
"""

import numpy as np

from neurst_tpu_torch.data import dataset_utils
from neurst_tpu_torch.metrics.metric import build_metric
from neurst_tpu_torch.models.model import build_model
from neurst_tpu_torch.tasks.seq2seq import build_pipeline
from neurst_tpu_torch.tasks.task import Task, register_task
from neurst_tpu_torch.utils.compat import DataStatus, ModeKeys
from neurst_tpu_torch.utils.configurable import deep_merge_dict
from neurst_tpu_torch.utils.flags_core import Flag, ModuleFlag

__all__ = ["SpeechToText"]


def _training_is_not_ported():
    return NotImplementedError(
        "speech2text TRAIN batching (2-D bucketing, SpecAugment) is not "
        "ported yet; the port's task serves INFER and EVAL")


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

    @property
    def trg_pipeline(self):
        return self._trg_data_pipeline

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
                 help="SpecAugment setting (TRAIN only)."),
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

    def build_model(self, args, name=None, **kwargs):
        src_meta = {"audio_feature_dim": self._audio_feature_dim,
                    "audio_feature_channels": self._audio_feature_channels}
        return build_model(args, src_meta=src_meta,
                           trg_meta=self._trg_data_pipeline.meta, **kwargs)

    def _feature_elems(self):
        return self._audio_feature_dim * self._audio_feature_channels

    def get_data_preprocess_fn(self, mode, data_status=DataStatus.RAW,
                               args=None):
        if mode == ModeKeys.TRAIN:
            raise _training_is_not_ported()
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
        feat_elems = self._feature_elems()

        def _process(data):
            audio = np.asarray(data["audio"], np.float32).reshape(-1)
            if trunc and max_src_len:
                audio = audio[:max_src_len * feat_elems]
            frames = len(audio) // feat_elems
            out = {"audio": audio.reshape(frames, feat_elems),
                   "audio_length": frames}
            transcript = data.get("transcript")
            if transcript is not None and mode != ModeKeys.INFER:
                if trans_status != DataStatus.PROJECTED:
                    transcript = self._trg_data_pipeline.encode(
                        transcript,
                        is_processed=(trans_status == DataStatus.PROCESSED))
                out["transcript"] = [int(x) for x in transcript]
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
        """INFER / EVAL batches of ``batch_size`` (16 by default)
        utterances, audio padded to a multiple of 64 frames."""
        if mode == ModeKeys.TRAIN:
            raise _training_is_not_ported()
        args = self._args if args is None else deep_merge_dict(
            self._args, args, local_overwrite=False)
        preprocess = self.get_data_preprocess_fn(mode, ds.status, args)
        feat_elems = self._feature_elems()
        trg_pad = self._trg_data_pipeline.meta["pad_id"]
        batch_size = dataset_utils.adjust_batch_size(
            args.get("batch_size") or 16,
            args.get("batch_size_per_gpu") or args.get(
                "batch_size_per_replica"),
            num_replicas_in_sync, verbose=(shard_id == 0))
        fields = ["audio"] + ([] if mode == ModeKeys.INFER
                              else ["transcript"])

        def make_iter():
            it = ds.build_iterator(map_func=preprocess, shard_id=shard_id,
                                   total_shards=total_shards)()
            # audio is padded on the flattened feature axis, so the
            # batcher treats it as one sequence field
            flat = ({"audio": ex["audio"].reshape(-1),
                     "audio_frames": ex["audio_length"],
                     **({"transcript": ex["transcript"]}
                        if "transcript" in ex else {})} for ex in it)
            for b in dataset_utils.batch_fixed_size(
                    flat, batch_size, {"audio": 0, "transcript": trg_pad},
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
                if "transcript" in b:
                    batch["transcript"] = b["transcript"]
                    batch["transcript_length"] = b["transcript_length"]
                yield self.example_to_input(batch, mode)
        return make_iter

    def get_eval_metric(self, args, name="metric", ds=None):
        params = dict(args.get(f"{name}.params") or {})
        params.setdefault(
            "language", self._trg_data_pipeline.meta.get("language", "en"))
        return build_metric({"metric.class": args.get(f"{name}.class")
                             or "WER", "metric.params": params})
