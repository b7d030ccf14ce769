"""Raw audio corpora streamed from their archives, with feature
extraction on the fly (the port's copy of
``neurst_tpu/data/datasets/audio/raw_audio_dataset.py``).

Archives (tarballs, and zips where the base reader is used) are STREAMED
without extraction; each adapter knows its corpus layout (transcript
files inside the archive) and yields
    {"audio": waveform-or-features, "audio_length", "transcript"
     [, "translation"]}
The ``feature_extractor`` (e.g. fbank) runs as examples are read, so
``create_records`` writes PROJECTED features offline.  Sharding is
round-robin over the utterances (or segments) in archive order.
"""

import json
import logging
import os
import tarfile
import zipfile
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import yaml

from neurst_tpu_torch.data.audio.feature_extractor import \
    build_feature_extractor
from neurst_tpu_torch.data.audio.wav_io import decode_audio
from neurst_tpu_torch.data.datasets.dataset import Dataset, register_dataset
from neurst_tpu_torch.utils.compat import DataStatus
from neurst_tpu_torch.utils.flags_core import Flag, ModuleFlag

__all__ = ["RawAudioDataset", "AugmentedLibriSpeech", "LibriSpeech", "MuSTC",
           "CommonVoice", "TedLium", "GigaSpeech", "IWSLTAudio"]

_TEXT_FIELDS = ("transcript", "translation")


class RawAudioDataset(Dataset):
    """Base: stream audio files and transcripts from an archive."""

    def __init__(self, args: Optional[dict] = None):
        super().__init__(args)
        self._input_tarball = self._args.get("input_tarball") \
            or self._args.get("data_path")
        fe_cls = self._args.get("feature_extractor.class")
        self._feature_extractor = None
        if fe_cls:
            self._feature_extractor = build_feature_extractor(
                {"feature_extractor.class": fe_cls,
                 "feature_extractor.params":
                     self._args.get("feature_extractor.params") or {}})
        self._transcripts_dict: Optional[Dict[str, dict]] = None

    @staticmethod
    def class_or_method_args():
        return [
            Flag("input_tarball", dtype=Flag.TYPE.STRING, default=None,
                 help="The corpus archive (streamed, not extracted)."),
            ModuleFlag("feature_extractor", "feature_extractor",
                       help="On-the-fly feature extractor (e.g. fbank)."),
        ]

    @property
    def status(self):
        return {
            "audio": (DataStatus.PROJECTED if self._feature_extractor
                      else DataStatus.RAW),
            "transcript": DataStatus.RAW,
            "translation": DataStatus.RAW,
        }

    def load_transcripts(self) -> Dict[str, dict]:
        """Scans the archive's transcript files: {audio member key:
        {"transcript": ..., ["translation": ...]}} (segmented corpora map
        a key to its segments' indices).  Subclasses implement the
        corpus layout."""
        raise NotImplementedError

    def _transcripts(self):
        if self._transcripts_dict is None:
            logging.info("Scanning transcripts from %s", self._input_tarball)
            self._transcripts_dict = self.load_transcripts()
            logging.info("Found %d transcribed utterances",
                         len(self._transcripts_dict))
        return self._transcripts_dict

    def _features(self, waveform: np.ndarray, rate: int) -> dict:
        """The example's audio: features where an extractor is set (flat
        [frames * dim]), else the waveform."""
        if self._feature_extractor is not None:
            feats = self._feature_extractor(waveform, rate)
            return {"audio": feats.reshape(-1).astype(np.float32),
                    "audio_length": feats.shape[0]}
        return {"audio": waveform.astype(np.float32),
                "audio_length": len(waveform)}

    def _iter_archive(self, tar_only: bool = False
                      ) -> Iterator[Tuple[str, Callable[[], bytes]]]:
        """Streams (member name, read-bytes function) from the archive: a
        tarball (any compression), or a zip unless ``tar_only``."""
        path = self._input_tarball
        if not tar_only and zipfile.is_zipfile(path):
            with zipfile.ZipFile(path) as z:
                for info in z.infolist():
                    if info.is_dir():
                        continue
                    yield info.filename, (lambda i=info: z.read(i))
        else:
            with tarfile.open(path, "r|*") as tar:
                for member in tar:
                    if not member.isfile():
                        continue
                    yield member.name, \
                        (lambda m=member: tar.extractfile(m).read())

    def build_iterator(self, map_func=None, shard_id=0, total_shards=1):
        transcripts = self._transcripts()

        def gen():
            idx = 0
            for name, read in self._iter_archive():
                key = os.path.basename(name)
                stem = os.path.splitext(key)[0]
                meta = (transcripts.get(name)
                        or transcripts.get(key)
                        or transcripts.get(stem))
                if meta is None:
                    continue
                if total_shards > 1 and idx % total_shards != shard_id:
                    idx += 1
                    continue
                idx += 1
                waveform, rate = decode_audio(read(),
                                              os.path.splitext(name)[1])
                example = self._features(waveform, rate)
                example.update(meta)
                if map_func is not None:
                    example = map_func(example)
                if example is not None:
                    yield example
        return gen

    def _read_members(self, *suffixes: str) -> Dict[str, bytes]:
        """The archive's members that end in one of ``suffixes``, read in
        one streaming pass."""
        out = {}
        for name, read in self._iter_archive():
            if any(name.endswith(s) for s in suffixes):
                out[name] = read()
        return out

    def _segment_iterator(self, members, segment_ids, bounds, map_func,
                          shard_id, total_shards):
        """Examples of segmented corpora: for each audio member of
        ``members`` ((name, read) pairs) whose ``segment_ids(name)`` are
        not empty, the clips ``bounds(segment, rate)`` = (start, stop)
        samples of each of its segments, with the segment's text fields;
        sharded round-robin over segments."""
        def gen():
            idx = 0
            for name, read in members():
                seg_ids = segment_ids(name)
                if not seg_ids:
                    continue
                waveform, rate = decode_audio(read(),
                                              os.path.splitext(name)[1])
                for si in seg_ids:
                    seg = self._segments[si]
                    if total_shards > 1 and idx % total_shards != shard_id:
                        idx += 1
                        continue
                    idx += 1
                    start, stop = bounds(seg, rate)
                    example = self._features(waveform[start:stop], rate)
                    for k in _TEXT_FIELDS:
                        if k in seg:
                            example[k] = seg[k]
                    if map_func is not None:
                        example = map_func(example)
                    if example is not None:
                        yield example
        return gen


def _clip_by_offset(seg, rate):
    start = int(seg["offset"] * rate)
    return start, start + int(seg["duration"] * rate)


def _clip_by_time(seg, rate):
    return int(seg["start"] * rate), int(seg["end"] * rate)


@register_dataset("aug_librispeech", "AugmentedLibriSpeech")
class AugmentedLibriSpeech(RawAudioDataset):
    """libri-trans (Augmented LibriSpeech, En->Fr): TSV members with
    (wav, transcript[, translation]) or (id, wav, transcript[,
    translation]) rows beside the audio files."""

    _AUDIO_EXTS = (".wav", ".flac", ".mp3", ".sph")

    def load_transcripts(self):
        out = {}
        for name, data in self._read_members(".tsv").items():
            for line in data.decode("utf-8").splitlines():
                parts = [p.strip() for p in line.split("\t")]
                if len(parts) < 2:
                    continue
                if len(parts) >= 3 and parts[1].lower().endswith(
                        self._AUDIO_EXTS):
                    wav, rest = parts[1], parts[2:]   # id-first layout
                else:
                    wav, rest = parts[0], parts[1:]
                entry = {"transcript": rest[0]}
                if len(rest) >= 2 and rest[1]:
                    entry["translation"] = rest[1]
                out[os.path.splitext(os.path.basename(wav))[0]] = entry
        return out


@register_dataset("librispeech", "LibriSpeech")
class LibriSpeech(RawAudioDataset):
    """LibriSpeech: ``<spk>-<chap>-<utt>.flac`` utterances with
    per-chapter ``<spk>-<chap>.trans.txt`` files of "UTTID TEXT" lines."""

    def load_transcripts(self):
        out = {}
        for name, data in self._read_members(".trans.txt").items():
            for line in data.decode("utf-8").splitlines():
                if not line.strip():
                    continue
                utt_id, _, text = line.partition(" ")
                for ext in (".flac", ".wav"):
                    out[utt_id + ext] = {"transcript": text.strip()}
        return out


@register_dataset("mustc", "MuSTC")
class MuSTC(RawAudioDataset):
    """MuST-C: a segments yaml (wav, offset, duration) with parallel
    ``.en`` / ``.<trg_lang>`` text members per split; segments are cut
    from the talks' wavs.  ``extraction`` keeps one split."""

    def __init__(self, args=None):
        super().__init__(args)
        self._trg_lang = self._args.get("trg_lang") or "de"
        self._extraction = self._args.get("extraction")

    @staticmethod
    def class_or_method_args():
        return RawAudioDataset.class_or_method_args() + [
            Flag("trg_lang", dtype=Flag.TYPE.STRING, default="de",
                 help="The target translation language suffix."),
            Flag("extraction", dtype=Flag.TYPE.STRING, default=None,
                 help="The split to extract from the archive "
                      "(train / dev / tst-COMMON / tst-HE)."),
        ]

    def _in_split(self, member_name: str) -> bool:
        if not self._extraction:
            return True
        parts = member_name.replace("\\", "/").split("/")
        return self._extraction in parts

    def load_transcripts(self):
        members = {name: data for name, data in self._read_members(
            ".yaml", ".en", "." + self._trg_lang).items()
            if self._in_split(name)}
        seg_yaml = None
        en_texts, trg_texts = None, None
        for name, data in members.items():
            if name.endswith(".yaml"):
                seg_yaml = yaml.safe_load(data.decode("utf-8"))
            elif name.endswith(".en"):
                en_texts = data.decode("utf-8").splitlines()
            elif name.endswith("." + self._trg_lang):
                trg_texts = data.decode("utf-8").splitlines()
        if not (seg_yaml and en_texts and trg_texts):
            raise FileNotFoundError(
                "MuST-C archive must contain segments yaml + .en + "
                f".{self._trg_lang} members")
        self._segments = [
            {"wav": seg["wav"], "offset": float(seg["offset"]),
             "duration": float(seg["duration"]),
             "transcript": en_texts[i].strip(),
             "translation": trg_texts[i].strip()}
            for i, seg in enumerate(seg_yaml)]
        out = {}
        for i, seg in enumerate(self._segments):
            out.setdefault(seg["wav"], []).append(i)
        return out

    def build_iterator(self, map_func=None, shard_id=0, total_shards=1):
        wav_to_segments = self._transcripts()

        def members():
            return ((name, read) for name, read in self._iter_archive()
                    if self._in_split(name))

        def segment_ids(name):
            key = os.path.basename(name)
            return (wav_to_segments.get(key) or wav_to_segments.get(name)
                    or wav_to_segments.get(os.path.splitext(key)[0]))
        return self._segment_iterator(members, segment_ids, _clip_by_offset,
                                      map_func, shard_id, total_shards)


@register_dataset("common_voice", "CommonVoice")
class CommonVoice(RawAudioDataset):
    """Mozilla CommonVoice: a TSV index (path, sentence) and mp3 clips
    (or wav conversions, matched by the stem)."""

    def load_transcripts(self):
        out = {}
        for name, data in self._read_members(".tsv").items():
            lines = data.decode("utf-8").splitlines()
            if not lines:
                continue
            header = lines[0].split("\t")
            try:
                path_col = header.index("path")
                sent_col = header.index("sentence")
            except ValueError:
                continue
            for line in lines[1:]:
                parts = line.split("\t")
                if len(parts) > max(path_col, sent_col):
                    stem = os.path.splitext(
                        os.path.basename(parts[path_col]))[0]
                    out[stem] = {"transcript": parts[sent_col].strip()}
        return out


@register_dataset("tedlium", "TedLium")
class TedLium(RawAudioDataset):
    """TED-LIUM: STM transcript members reference (start, end) segments of
    the talks' sph (or wav / flac) audio."""

    def load_transcripts(self):
        out = {}
        self._segments = []
        for name, data in self._read_members(".stm").items():
            for line in data.decode("utf-8", errors="ignore").splitlines():
                parts = line.split(None, 6)
                # <wav> <channel> <speaker> <start> <end> <label> <text>
                if len(parts) < 7 or parts[6].strip() \
                        == "ignore_time_segment_in_scoring":
                    continue
                self._segments.append({
                    "wav": parts[0], "start": float(parts[3]),
                    "end": float(parts[4]),
                    "transcript": parts[6].strip()})
        for i, seg in enumerate(self._segments):
            for ext in (".sph", ".wav"):
                out.setdefault(seg["wav"] + ext, []).append(i)
        return out

    def build_iterator(self, map_func=None, shard_id=0, total_shards=1):
        wav_to_segments = self._transcripts()

        def segment_ids(name):
            key = os.path.basename(name)
            if os.path.splitext(key)[1].lower() not in (".wav", ".sph",
                                                        ".flac"):
                return None  # transcript and metadata members
            stem = os.path.splitext(key)[0]
            return (wav_to_segments.get(key)
                    or wav_to_segments.get(stem + ".wav")
                    or wav_to_segments.get(stem))
        return self._segment_iterator(
            lambda: self._iter_archive(tar_only=True), segment_ids,
            _clip_by_time, map_func, shard_id, total_shards)


@register_dataset("gigaspeech", "GigaSpeech")
class GigaSpeech(RawAudioDataset):
    """GigaSpeech: a JSON index of (begin_time, end_time, text_tn)
    segments of long recordings.  Keeps the ``subset`` tag at the audio
    and the segment level, maps punctuation tags to symbols, drops
    garbage-only segments, lowercases, and merges GigaST translations by
    segment id (``extra_translation_json``)."""

    SUBSET_CHOICES = ("XS", "S", "M", "L", "XL", "DEV", "TEST")
    _TAG_MAP = (("<QUESTIONMARK>", "?"), ("<EXCLAMATIONPOINT>", "!"),
                ("<PERIOD>", "."), ("<COMMA>", ","),
                # collapse the space the tags leave behind
                (" ?", "?"), (" !", "!"), (" .", "."), (" ,", ","))
    _GARBAGE = ("<SIL>", "<NOISE>", "<MUSIC>", "<OTHER>")

    def __init__(self, args=None):
        super().__init__(args)
        subset = self._args.get("subset") or "XL"
        if subset not in self.SUBSET_CHOICES:
            raise ValueError(
                f"GigaSpeech subset must be one of "
                f"{list(self.SUBSET_CHOICES)}, got '{subset}' (subsets "
                f"are case-sensitive tags in the corpus index)")

    @staticmethod
    def class_or_method_args():
        return RawAudioDataset.class_or_method_args() + [
            Flag("subset", dtype=Flag.TYPE.STRING, default="XL",
                 choices=list(GigaSpeech.SUBSET_CHOICES),
                 help="The GigaSpeech subset tag to keep."),
            Flag("extra_translation_json", dtype=Flag.TYPE.STRING,
                 default=None,
                 help="GigaST json whose per-sid translations are "
                      "merged into the segments."),
        ]

    def _load_translations(self):
        path = self._args.get("extra_translation_json")
        if not path:
            return {}
        with open(path, encoding="utf-8") as f:
            meta = json.load(f)
        sid_to_text = {}
        for audio in meta.get("audios", []):
            for seg in audio.get("segments", []):
                if "sid" in seg:
                    sid_to_text[seg["sid"]] = (
                        seg.get("text_raw") or seg.get("text_tn")
                        or "").strip()
        return sid_to_text

    def load_transcripts(self):
        subset = "{" + (self._args.get("subset") or "XL") + "}"
        translations = self._load_translations()
        self._segments = []
        n_dropped = 0
        for name, data in self._read_members(".json").items():
            meta = json.loads(data.decode("utf-8"))
            for audio in meta.get("audios", []):
                if subset not in (audio.get("subsets") or [subset]):
                    continue
                path = os.path.splitext(
                    os.path.basename(audio.get("path", "")))[0]
                for seg in audio.get("segments", []):
                    if subset not in (seg.get("subsets") or [subset]):
                        continue
                    text = seg.get("text_tn", "").strip()
                    if any(g in text for g in self._GARBAGE):
                        n_dropped += 1
                        continue
                    for tag, sym in self._TAG_MAP:
                        text = text.replace(tag, sym)
                    entry = {"wav": path,
                             "start": float(seg.get("begin_time", 0)),
                             "end": float(seg.get("end_time", 0)),
                             "transcript": text.lower()}
                    sid = seg.get("sid")
                    if sid is not None and sid in translations:
                        entry["translation"] = translations[sid]
                    self._segments.append(entry)
        if translations:
            n_st = sum(1 for s in self._segments if "translation" in s)
            logging.info("GigaST merge: %d/%d segments matched a "
                         "translation.", n_st, len(self._segments))
        if n_dropped:
            logging.info("GigaSpeech: dropped %d garbage-only segments.",
                         n_dropped)
        out = {}
        for i, seg in enumerate(self._segments):
            out.setdefault(seg["wav"], []).append(i)
        return out

    build_iterator = TedLium.build_iterator


@register_dataset("iwslt_audio", "IWSLTAudio")
class IWSLTAudio(RawAudioDataset):
    """IWSLT evaluation sets: a segments yaml (wav, offset, duration) and
    parallel text members, MuST-C-style."""

    def load_transcripts(self):
        members = self._read_members(".yaml", ".en", ".de", ".fr")
        seg_yaml, texts = None, {}
        for name, data in members.items():
            if name.endswith(".yaml"):
                seg_yaml = yaml.safe_load(data.decode("utf-8"))
            else:
                texts[name.rsplit(".", 1)[1]] = \
                    data.decode("utf-8").splitlines()
        if seg_yaml is None:
            raise FileNotFoundError("IWSLT archive needs a segments yaml")
        self._segments = []
        src = texts.get("en", [None] * len(seg_yaml))
        trg = texts.get("de") or texts.get("fr") \
            or [None] * len(seg_yaml)
        for i, seg in enumerate(seg_yaml):
            entry = {"wav": seg["wav"], "start": float(seg["offset"]),
                     "end": float(seg["offset"]) + float(seg["duration"])}
            if i < len(src) and src[i] is not None:
                entry["transcript"] = src[i].strip()
            if i < len(trg) and trg[i] is not None:
                entry["translation"] = trg[i].strip()
            self._segments.append(entry)
        out = {}
        for i, seg in enumerate(self._segments):
            out.setdefault(seg["wav"], []).append(i)
        return out

    def build_iterator(self, map_func=None, shard_id=0, total_shards=1):
        wav_to_segments = self._transcripts()

        def segment_ids(name):
            key = os.path.basename(name)
            return (wav_to_segments.get(key) or wav_to_segments.get(name)
                    or wav_to_segments.get(os.path.splitext(key)[0]))
        return self._segment_iterator(
            lambda: self._iter_archive(tar_only=True), segment_ids,
            _clip_by_time, map_func, shard_id, total_shards)
