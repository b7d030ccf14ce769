"""Record-backed audio datasets (the port's copy of
``neurst_tpu/data/datasets/audio/audio_record_dataset.py``).

Records hold float "audio" features (flattened [frames * feat_dim]) and a
"transcript" (and "translation" for ST triples) as token ids or raw
text.  ``feature_key`` / ``transcript_key`` / ``translation_key`` rename
the record fields (``transcript_key: translation`` reads an ST record's
translation as the target).
"""

from neurst_tpu_torch.data.datasets.dataset import (RecordDataset,
                                                    register_dataset)
from neurst_tpu_torch.data.datasets.parallel_text_dataset import \
    AbstractParallelDataset
from neurst_tpu_torch.utils.compat import DataStatus
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["AudioRecordDataset", "AudioTripleRecordDataset"]


def _text(values):
    """A record's text field: raw text (one bytes value) or token ids."""
    if len(values) and isinstance(values[0], bytes):
        return values[0].decode("utf-8")
    return [int(x) for x in values]


@register_dataset("audio_tfrecord", "AudioTFRecordDataset")
class AudioRecordDataset(RecordDataset, AbstractParallelDataset):
    """ASR: (audio features, transcript)."""

    def __init__(self, args=None):
        super().__init__(args)
        self._feature_key = self._args.get("feature_key") or "audio"
        self._transcript_key = self._args.get("transcript_key") \
            or "transcript"
        self._targets = None
        self._sniffed_status = None

    @staticmethod
    def class_or_method_args():
        return RecordDataset.class_or_method_args() + [
            Flag("feature_key", dtype=Flag.TYPE.STRING, default="audio",
                 help="The audio feature field name in the record."),
            Flag("transcript_key", dtype=Flag.TYPE.STRING,
                 default="transcript",
                 help="The transcript field name in the record."),
        ]

    @property
    def status(self):
        """Audio is PROJECTED; the text sides are sniffed from the first
        record: raw strings are RAW, token ids PROJECTED."""
        if self._sniffed_status is None:
            text_status = DataStatus.PROJECTED
            ex = next(iter(self.build_iterator()()), None)
            if ex is not None and any(isinstance(ex.get(k), str)
                                      for k in ("transcript", "translation")):
                text_status = DataStatus.RAW
            self._sniffed_status = {"audio": DataStatus.PROJECTED,
                                    "transcript": text_status,
                                    "translation": text_status}
        return self._sniffed_status

    def parse_record(self, parsed):
        out = {"audio": parsed[self._feature_key]}
        transcript = parsed.get(self._transcript_key)
        if transcript is not None:
            out["transcript"] = _text(transcript)
        return out

    @property
    def targets(self):
        if self._targets is None:
            self._targets = [ex["transcript"]
                             for ex in self.build_iterator()()]
        return self._targets


@register_dataset("audio_triple_tfrecord", "AudioTripleTFRecordDataset")
class AudioTripleRecordDataset(AudioRecordDataset):
    """ST: (audio features, transcript, translation)."""

    def __init__(self, args=None):
        super().__init__(args)
        self._translation_key = self._args.get("translation_key") \
            or "translation"

    @staticmethod
    def class_or_method_args():
        return AudioRecordDataset.class_or_method_args() + [
            Flag("translation_key", dtype=Flag.TYPE.STRING,
                 default="translation",
                 help="The translation field name in the record."),
        ]

    def parse_record(self, parsed):
        out = super().parse_record(parsed)
        translation = parsed.get(self._translation_key)
        if translation is not None:
            out["translation"] = _text(translation)
        return out

    @property
    def targets(self):
        if self._targets is None:
            self._targets = [ex["translation"]
                             for ex in self.build_iterator()()]
        return self._targets
