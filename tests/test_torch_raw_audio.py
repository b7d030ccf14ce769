"""The port's raw-audio datasets against the JAX package's, on the CPU: each
of the seven adapters reads a synthetic archive in its corpus's layout,
and both packages yield the same examples (keys, transcript, translation,
audio and its length bitwise), with and without the fbank extractor,
whole and as shard 1 of 2; MuST-C also under ``--extraction``.
"""

import io
import json
import os
import tarfile
import wave
import zipfile

import numpy as np
import pytest
import yaml

jax = pytest.importorskip("jax")

import chip_smoke  # noqa: E402
import neurst_tpu  # noqa: E402,F401
import neurst_tpu_torch  # noqa: E402,F401
from neurst_tpu.data.datasets.dataset import \
    build_dataset as jax_build_dataset  # noqa: E402
from neurst_tpu_torch.data.datasets.dataset import build_dataset  # noqa: E402
from neurst_tpu_torch.utils.compat import DataStatus  # noqa: E402

RATE = 16000


def _pcm(rng, seconds):
    return chip_smoke._talk_pcm(rng, int(seconds * RATE), RATE)


def _wav(pcm):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(RATE)
        w.writeframes(pcm.astype("<i2").tobytes())
    return buf.getvalue()


def _sph(pcm):
    header = "\n".join(["NIST_1A", "   1024", "sample_rate -i 16000",
                        "channel_count -i 1", "sample_n_bytes -i 2",
                        "sample_byte_format -s2 01",
                        f"sample_count -i {len(pcm)}",
                        "sample_coding -s3 pcm", "end_head"]).encode()
    return header + b"\0" * (1024 - len(header)) + pcm.astype(
        "<i2").tobytes()


def _tar(path, members):
    with tarfile.open(path, "w:gz") as tar:
        for name, data in members:
            chip_smoke._tar_add(tar, name, data)
    return str(path)


def _aug_librispeech(tmp, rng):
    rows = [("utt1.wav", "hello world", "bonjour le monde"),
            ("utt2.wav", "the quick brown fox", "le renard brun rapide"),
            ("utt3.wav", "speech translation", ""),
            ("utt4.wav", "another line here", "une autre ligne")]
    path = tmp / "train_100h.zip"
    with zipfile.ZipFile(path, "w") as z:
        # the wav-first layout, and the id-first one
        z.writestr("train/alignments.tsv", "\n".join(
            "\t".join(r) for r in rows[:3]))
        z.writestr("train/other.tsv", "\t".join(("u4",) + rows[3]))
        for wav, _, _ in rows:
            z.writestr(f"train/audio/{wav}", _wav(_pcm(rng, 0.4)))
    return {"input_tarball": str(path)}


def _librispeech(tmp, rng):
    members, lines = [], []
    for u in range(5):
        utt = f"19-198-{u:04d}"
        pcm = _pcm(rng, rng.uniform(0.2, 0.6))
        if u % 2:
            members.append((f"LibriSpeech/dev/19/198/{utt}.wav", _wav(pcm)))
        else:
            members.append((f"LibriSpeech/dev/19/198/{utt}.flac",
                            chip_smoke.flac_encode(pcm, RATE, 4096)))
        lines.append(f"{utt} SOME WORDS NUMBER {u}")
    members.append(("LibriSpeech/dev/19/198/19-198.trans.txt",
                    ("\n".join(lines) + "\n\n").encode()))
    return {"input_tarball": _tar(tmp / "dev-clean.tar.gz", members)}


def _mustc_members(rng, splits=("train", "dev")):
    members = []
    for split in splits:
        segs, en, de = [], [], []
        for t in range(2):
            name = f"ted_{split}_{t}.wav"
            members.append((f"en-de/data/{split}/wav/{name}",
                            _wav(_pcm(rng, 2.0))))
            for k, (offset, duration) in enumerate(((0.0, 0.5), (0.61, 0.7),
                                                    (1.4, 0.55))):
                segs.append({"wav": name, "offset": offset,
                             "duration": duration, "speaker_id": "s"})
                en.append(f"{split} talk {t} segment {k} en")
                de.append(f"{split} talk {t} segment {k} de")
        txt = f"en-de/data/{split}/txt/{split}"
        members += [(txt + ".yaml", yaml.safe_dump(segs).encode()),
                    (txt + ".en", ("\n".join(en) + "\n").encode()),
                    (txt + ".de", ("\n".join(de) + "\n").encode())]
    return members


def _mustc(tmp, rng):
    return {"input_tarball": _tar(tmp / "MUSTC_v1.0_en-de.tar.gz",
                                  _mustc_members(rng, ("dev",))),
            "trg_lang": "de"}


def _mustc_train_split(tmp, rng):
    return {"input_tarball": _tar(tmp / "MUSTC_v1.0_en-de.tar.gz",
                                  _mustc_members(rng)),
            "trg_lang": "de", "extraction": "train"}


def _common_voice(tmp, rng):
    members = [("cv/en/validated.tsv", (
        "client_id\tpath\tsentence\tup_votes\n"
        "a\tcommon_voice_en_1.mp3\tFirst clip.\t2\n"
        "b\tcommon_voice_en_2.mp3\tSecond clip here.\t1\n"
        "c\tcommon_voice_en_3.mp3\tNot in the archive.\t0\n").encode()),
        ("cv/en/other.tsv", b"no\theader\there\n")]
    for i in (1, 2):
        members.append((f"cv/en/clips/common_voice_en_{i}.wav",
                        _wav(_pcm(rng, 0.3 * i))))
    return {"input_tarball": _tar(tmp / "cv.tar.gz", members)}


def _tedlium(tmp, rng):
    stm = ("talk_a 1 spk 0.00 0.50 <o,f0,male> first segment\n"
           "talk_a 1 spk 0.50 0.80 <o,f0,male> ignore_time_segment_in_scoring\n"
           "talk_a 1 spk 0.80 1.60 <o,f0,male> second segment\n"
           "talk_b 1 spk 0.10 0.90 <o,f0,female> third one\n"
           "short line\n")
    members = [("TEDLIUM/test/stm/talks.stm", stm.encode()),
               ("TEDLIUM/test/sph/talk_a.sph", _sph(_pcm(rng, 2.0))),
               ("TEDLIUM/test/sph/talk_b.wav", _wav(_pcm(rng, 1.0))),
               ("TEDLIUM/test/readme.txt", b"notes")]
    return {"input_tarball": _tar(tmp / "tedlium.tar.gz", members)}


def _gigaspeech(tmp, rng):
    index = {"audios": [
        {"path": "audio/podcast/P0001.wav", "subsets": ["{XL}", "{S}"],
         "segments": [
             {"sid": "P0001_S1", "begin_time": 0.0, "end_time": 0.6,
              "text_tn": "HELLO <COMMA> WORLD <PERIOD>",
              "subsets": ["{XL}", "{S}"]},
             {"sid": "P0001_S2", "begin_time": 0.6, "end_time": 1.1,
              "text_tn": "<NOISE>", "subsets": ["{XL}", "{S}"]},
             {"sid": "P0001_S3", "begin_time": 1.1, "end_time": 1.9,
              "text_tn": "IS IT <QUESTIONMARK>", "subsets": ["{XL}"]}]},
        {"path": "audio/youtube/Y0002.wav", "subsets": ["{XL}"],
         "segments": [
             {"sid": "Y0002_S1", "begin_time": 0.2, "end_time": 0.9,
              "text_tn": "WOW <EXCLAMATIONPOINT>"}]}]}
    members = [("GigaSpeech/GigaSpeech.json", json.dumps(index).encode()),
               ("GigaSpeech/audio/podcast/P0001.wav", _wav(_pcm(rng, 2.0))),
               ("GigaSpeech/audio/youtube/Y0002.wav", _wav(_pcm(rng, 1.0)))]
    gigast = tmp / "gigast.json"
    gigast.write_text(json.dumps({"audios": [{"segments": [
        {"sid": "P0001_S1", "text_raw": "Hallo, Welt."},
        {"sid": "Y0002_S1", "text_tn": "Wow!"}]}]}))
    return {"input_tarball": _tar(tmp / "gigaspeech.tar.gz", members),
            "subset": "XL", "extra_translation_json": str(gigast)}


def _iwslt(tmp, rng):
    segs = [{"wav": "talk.wav", "offset": 0.1, "duration": 0.5},
            {"wav": "talk.wav", "offset": 0.7, "duration": 0.6},
            {"wav": "talk.wav", "offset": 1.4, "duration": 0.4}]
    members = [("IWSLT/tst2020/wav/talk.wav", _wav(_pcm(rng, 2.0))),
               ("IWSLT/tst2020/IWSLT.tst2020.yaml",
                yaml.safe_dump(segs).encode()),
               ("IWSLT/tst2020/IWSLT.tst2020.en",
                b"one source\ntwo source\nthree source\n"),
               ("IWSLT/tst2020/IWSLT.tst2020.de", b"eins\nzwei\n")]
    return {"input_tarball": _tar(tmp / "iwslt.tar.gz", members)}


ADAPTERS = {"AugmentedLibriSpeech": _aug_librispeech,
            "LibriSpeech": _librispeech, "MuSTC": _mustc,
            "CommonVoice": _common_voice, "TedLium": _tedlium,
            "GigaSpeech": _gigaspeech, "IWSLTAudio": _iwslt}
EXPECTED = {"AugmentedLibriSpeech": 4, "LibriSpeech": 5, "MuSTC": 6,
            "CommonVoice": 2, "TedLium": 3, "GigaSpeech": 3, "IWSLTAudio": 3}


def _examples(build, cls, params, shard):
    ds = build({"dataset.class": cls, "dataset.params": params})
    shard_id, total = shard
    return ds, list(ds.build_iterator(shard_id=shard_id,
                                      total_shards=total)())


def _assert_same(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert sorted(a) == sorted(b)
        for k in b:
            if k == "audio":
                assert a[k].dtype == b[k].dtype == np.float32
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)], ids=["whole", "shard1of2"])
@pytest.mark.parametrize("features", [None, "fbank"])
@pytest.mark.parametrize("cls", sorted(ADAPTERS))
def test_adapter_yields_the_jax_examples(cls, features, shard, tmp_path):
    params = ADAPTERS[cls](tmp_path, np.random.RandomState(len(cls)))
    if features:
        params["feature_extractor.class"] = features
        params["feature_extractor.params"] = {"nfilt": 20}
    port_ds, port = _examples(build_dataset, cls, params, shard)
    ref_ds, ref = _examples(jax_build_dataset, cls, params, shard)
    _assert_same(port, ref)
    whole = EXPECTED[cls]
    assert len(port) == (whole if shard[1] == 1 else whole // 2)
    status = port_ds.status
    assert status == ref_ds.status
    assert status["audio"] == (DataStatus.PROJECTED if features
                               else DataStatus.RAW)
    for ex in port:
        if features:
            assert len(ex["audio"]) == ex["audio_length"] * 20
        else:
            assert len(ex["audio"]) == ex["audio_length"]


@pytest.mark.parametrize("split", ["train", "dev"])
def test_mustc_extraction_matches(split, tmp_path):
    params = _mustc_train_split(tmp_path, np.random.RandomState(5))
    params["extraction"] = split
    _, port = _examples(build_dataset, "MuSTC", params, (0, 1))
    _, ref = _examples(jax_build_dataset, "MuSTC", params, (0, 1))
    _assert_same(port, ref)
    assert len(port) == 6
    assert all(ex["transcript"].startswith(split) for ex in port)
    assert port[1]["audio_length"] == int(0.7 * RATE)


def test_adapters_registered_alike():
    from neurst_tpu.utils.registry import REGISTRIES as JAX_REGISTRIES
    from neurst_tpu_torch.utils.registry import REGISTRIES
    for name in ("aug_librispeech", "librispeech", "mustc", "common_voice",
                 "tedlium", "gigaspeech", "iwslt_audio"):
        assert REGISTRIES["dataset"][name].__name__ \
            == JAX_REGISTRIES["dataset"][name].__name__


def test_gigaspeech_subset_is_checked_alike():
    for build in (build_dataset, jax_build_dataset):
        with pytest.raises(ValueError, match="subset"):
            build({"dataset.class": "GigaSpeech",
                   "dataset.params": {"input_tarball": "x", "subset": "xl"}})


def test_mustc_without_text_members_raises_alike(tmp_path):
    path = _tar(tmp_path / "broken.tar.gz",
                [("en-de/data/dev/wav/a.wav", _wav(np.zeros(10, np.int16)))])
    for build in (build_dataset, jax_build_dataset):
        ds = build({"dataset.class": "MuSTC",
                    "dataset.params": {"input_tarball": path}})
        with pytest.raises(FileNotFoundError):
            list(ds.build_iterator()())
