"""The speech recipes' data preparation through the port's CLIs against the
JAX CLIs, on the CPU, and what it feeds.

Both recipe tests of ``tests/test_recipe_pipeline.py`` run through each
package's CLIs (in-process) on the same corpus, and every output must be
byte-identical: transcripts, ``codes.bpe``, vocabularies, BPE text and
every record shard.  The augmented-LibriSpeech zip of that file goes
through stages 02-03 (fbank records in 2 shards, joint BPE, the projected
ASR/ST triples); a MuST-C tarball from ``chip_smoke.write_mustc_corpus``
(three splits) through stages 02-03 of ``must-c/0[23]-*.sh`` (2
processors over 4 shards, ``--extraction``, Moses with punctuation
normalization before the joint BPE, and in the triple records'
pipelines).  The port's
stage-03 records then feed ``run_exp --entry train --device cpu`` (2
steps, ``speech_transformer_toy``) and ``--entry predict --device cpu``,
through ``chip_smoke``'s ``prep_train_phase`` / ``prep_predict_phase``.
Also: ``test_cli_tools.py``'s ``generate_vocab``, ``process_text``,
``view_records`` and ``audio_analysis`` cases on both packages, and
``MultiTaskSpeechTranslation`` (config, preprocess, batches, metric,
postprocess) against the JAX task, and the joint model it builds.
"""

import contextlib
import importlib
import io
import json
import os
import sys
import zipfile

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import port_test_support  # noqa: E402,F401

import chip_smoke  # noqa: E402
import neurst_tpu  # noqa: E402,F401
import neurst_tpu_torch  # noqa: E402,F401
from neurst_tpu.data.datasets.dataset import \
    build_dataset as jax_build_dataset  # noqa: E402
from neurst_tpu.tasks.task import build_task as jax_build_task  # noqa: E402
from neurst_tpu_torch.data.datasets.dataset import build_dataset  # noqa: E402
from neurst_tpu_torch.data.recordio import (glob_record_files,  # noqa: E402
                                            parse_example, record_iterator)
from neurst_tpu_torch.ops.device_fbank import num_frames  # noqa: E402
from neurst_tpu_torch.tasks.task import build_task  # noqa: E402
from neurst_tpu_torch.utils.compat import DataStatus, ModeKeys  # noqa: E402

PACKAGES = ("neurst_tpu", "neurst_tpu_torch")
RECIPE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "test_recipe_pipeline.py")


def _cli(pkg, name):
    return importlib.import_module(f"{pkg}.cli.{name}")


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _assert_same_tree(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for name in ta:
        assert ta[name] == tb[name], name
    return ta


def _records(path):
    return [parse_example(r) for f in glob_record_files(path)
            for r in record_iterator(f, check_crc=True)]


# ------------------------------------------- augmented LibriSpeech


def _load_recipe_pipeline():
    """``tests/test_recipe_pipeline.py``, for its wav writer."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("recipe_pipeline", RECIPE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


RECIPE_PIPELINE = _load_recipe_pipeline()


@pytest.fixture()
def corpus_zip(tmp_path):
    """``tests/test_recipe_pipeline.py``'s corpus."""
    rows = [("utt1.wav", "hello world", "bonjour le monde"),
            ("utt2.wav", "the quick brown fox", "le renard brun rapide"),
            ("utt3.wav", "speech translation works",
             "la traduction vocale marche")]
    path = tmp_path / "train_100h.zip"
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("train/alignments.tsv",
                   "\n".join("\t".join(r) for r in rows))
        for i, (wav, _, _) in enumerate(rows):
            z.writestr(f"train/audio/{wav}",
                       RECIPE_PIPELINE._make_wav_bytes(seed=i))
    return str(path)


def _librispeech_stages(pkg, corpus, data):
    ts = os.path.join(data, "transcripts")
    os.makedirs(ts)
    _cli(pkg, "extract_audio_transcripts").main([
        "--dataset", "AugmentedLibriSpeech", "--input_tarball", corpus,
        "--output_transcript_file", f"{ts}/train.en.txt",
        "--output_translation_file", f"{ts}/train.fr.txt"])
    _cli(pkg, "create_records").main([
        "--processor_id", "0", "--num_processors", "1",
        "--num_output_shards", "2", "--output_range_begin", "0",
        "--output_range_end", "2", "--dataset", "AugmentedLibriSpeech",
        "--feature_extractor.class", "fbank",
        "--feature_extractor.params", '{"nfilt": 8}',
        "--input_tarball", corpus, "--output_template",
        os.path.join(data, "train", "train.tfrecords-%5.5d-of-%5.5d")])
    _cli(pkg, "learn_bpe").main([
        "--input", f"{ts}/train.en.txt", f"{ts}/train.fr.txt",
        "--symbols", "40", "--output", f"{ts}/codes.bpe",
        "--write_vocabulary", f"{ts}/vocab.en", f"{ts}/vocab.fr"])
    for side in ("en", "fr"):
        _cli(pkg, "process_text").main([
            "--tokenizer", "bpe", "--subtokenizer_codes", f"{ts}/codes.bpe",
            "--input", f"{ts}/train.{side}.txt",
            "--output", f"{ts}/train.{side}.bpe.txt"])
    task_params = f"""
audio_feature_dim: 8
transcript_data_pipeline.class: TranscriptDataPipeline
transcript_data_pipeline.params:
    lowercase: True
    language: en
    subtokenizer: bpe
    subtokenizer_codes: {ts}/codes.bpe
    vocab_path: {ts}/vocab.en
translation_data_pipeline.class: TranscriptDataPipeline
translation_data_pipeline.params:
    language: fr
    subtokenizer: bpe
    subtokenizer_codes: {ts}/codes.bpe
    vocab_path: {ts}/vocab.fr
"""
    _cli(pkg, "create_records").main([
        "--processor_id", "0", "--num_processors", "1",
        "--num_output_shards", "1", "--dataset",
        "AudioTripleTFRecordDataset", "--feature_key", "audio",
        "--transcript_key", "transcript", "--translation_key", "translation",
        "--data_path", os.path.join(data, "train"),
        "--task", "MultiTaskSpeechTranslation", "--task.params", task_params,
        "--output_template",
        os.path.join(data, "asr_st", "train",
                     "train.tfrecords-%5.5d-of-%5.5d")])


def test_librispeech_recipe_stages_byte_identical(corpus_zip, tmp_path):
    outs = {}
    for pkg in PACKAGES:
        outs[pkg] = str(tmp_path / pkg)
        _librispeech_stages(pkg, corpus_zip, outs[pkg])
    tree = _assert_same_tree(*outs.values())
    assert sum(name.startswith("train/") for name in tree) == 2
    assert tree["transcripts/train.en.txt"].decode().splitlines() == [
        "hello world", "the quick brown fox", "speech translation works"]
    raw = _records(os.path.join(outs["neurst_tpu_torch"], "train"))
    assert len(raw) == 3 and all(np.asarray(ex["audio"]).dtype.kind == "f"
                                 for ex in raw)
    projected = _records(os.path.join(outs["neurst_tpu_torch"], "asr_st",
                                      "train"))
    assert len(projected) == 3
    for ex in projected:
        for k in ("transcript", "translation"):
            assert np.asarray(ex[k]).dtype.kind == "i" and len(ex[k]) > 0


# ------------------------------------------------------------ MuST-C

MUSTC = dict(chip_smoke.AUDIO_PREP, train_talks=2, talk_s=6.0, max_seg_s=2.0,
             dev_segments=3, test_segments=4, lexicon=150, nfilt=80,
             bpe_symbols=300, train_steps=2, summary_steps=1,
             hparams_set="speech_transformer_toy")


@pytest.fixture(scope="module")
def mustc(tmp_path_factory):
    """The MuST-C corpus, and stages 02-03 through each package's CLIs."""
    root = tmp_path_factory.mktemp("mustc")
    tarball, splits = chip_smoke.write_mustc_corpus(
        str(root), np.random.RandomState(7), MUSTC)
    outs = {pkg: str(root / pkg) for pkg in PACKAGES}
    for pkg, data in outs.items():
        _mustc_stages(pkg, tarball, data, splits)
    return tarball, splits, outs


def _mustc_stages(pkg, tarball, data, splits):
    ts = os.path.join(data, "transcripts")
    os.makedirs(ts)
    common = ["--trg_lang", "de", "--input_tarball", tarball]
    fbank = ["--feature_extractor.class", "fbank",
             "--feature_extractor.params", '{"nfilt": 80}']
    for split in splits:
        _cli(pkg, "extract_audio_transcripts").main([
            "--dataset", "MuSTC", "--extraction", split, *common,
            "--output_transcript_file", f"{ts}/{split}.en.txt",
            "--output_translation_file", f"{ts}/{split}.de.txt"])
    for module, args in chip_smoke._shard_calls(
            ["--dataset", "MuSTC", "--extraction", "train", *common, *fbank],
            os.path.join(data, "train", "train.tfrecords-%5.5d-of-%5.5d"),
            2, 4):
        _cli(pkg, module).main(args)
    for split in ("dev", "tst-COMMON"):
        _cli(pkg, "create_records").main([
            "--processor_id", "0", "--num_processors", "1",
            "--num_output_shards", "1", "--output_range_begin", "0",
            "--output_range_end", "1", "--dataset", "MuSTC", "--extraction",
            split, *common, *fbank, "--output_template", os.path.join(
                data, "devtest", f"{split}.en-de.tfrecords-%5.5d-of-%5.5d")])
    for side in ("en", "de"):
        _cli(pkg, "process_text").main([
            "--tokenizer", "moses", "--language", side,
            "--normalize_punctuation", "--input", f"{ts}/train.{side}.txt",
            "--output", f"{ts}/train.{side}.tok.txt"])
    _cli(pkg, "learn_bpe").main([
        "--input", f"{ts}/train.en.tok.txt", f"{ts}/train.de.tok.txt",
        "--symbols", str(MUSTC["bpe_symbols"]), "--output",
        f"{ts}/codes.bpe", "--write_vocabulary", f"{ts}/vocab.en",
        f"{ts}/vocab.de"])
    for side in ("en", "de"):
        _cli(pkg, "process_text").main([
            "--tokenizer", "bpe", "--subtokenizer_codes", f"{ts}/codes.bpe",
            "--input", f"{ts}/train.{side}.tok.txt",
            "--output", f"{ts}/train.{side}.tok.bpe.txt"])
    for module, args in chip_smoke._shard_calls(
            ["--dataset", "AudioTripleTFRecordDataset", "--feature_key",
             "audio", "--transcript_key", "transcript", "--translation_key",
             "translation", "--data_path", os.path.join(data, "train"),
             "--task", "MultiTaskSpeechTranslation", "--task.params",
             json.dumps(_triple_task(ts))],
            os.path.join(data, "asr_st", "train",
                         "train.tfrecords-%5.5d-of-%5.5d"), 2, 4):
        _cli(pkg, module).main(args)


def _pipeline(ts, side, clean):
    return {"remove_punctuation": clean, "lowercase": clean,
            "language": side, "tokenizer": "moses", "subtokenizer": "bpe",
            "subtokenizer_codes": f"{ts}/codes.bpe",
            "vocab_path": f"{ts}/vocab.{side}"}


def _triple_task(ts):
    return {"audio_feature_dim": 80,
            "transcript_data_pipeline.class": "TranscriptDataPipeline",
            "transcript_data_pipeline.params": _pipeline(ts, "en", True),
            "translation_data_pipeline.class": "TranscriptDataPipeline",
            "translation_data_pipeline.params": _pipeline(ts, "de", False)}


def test_mustc_recipe_stages_byte_identical(mustc):
    _, splits, outs = mustc
    tree = _assert_same_tree(*outs.values())
    assert sum(name.startswith("train/") for name in tree) == 4
    assert sum(name.startswith("asr_st/") for name in tree) == 4
    port = outs["neurst_tpu_torch"]
    for split, segs in splits.items():
        with open(os.path.join(port, "transcripts", f"{split}.de.txt")) as f:
            assert f.read().splitlines() == [s["translation"] for s in segs]
    records = _records(os.path.join(port, "train"))
    assert len(records) == len(splits["train"])
    by_text = {s["transcript"]: s for s in splits["train"]}
    for ex in records:
        seg = by_text[ex["transcript"][0].decode()]
        frames = num_frames(seg["samples"])
        assert int(ex["audio_length"][0]) == frames
        assert len(ex["audio"]) == 80 * frames
    triples = _records(os.path.join(port, "asr_st", "train"))
    assert len(triples) == len(splits["train"])
    with open(os.path.join(port, "transcripts", "codes.bpe")) as f:
        assert f.readline().startswith("#version")


def test_port_records_feed_train_and_predict(mustc, tmp_path):
    """The port's stage-03 records through ``run_exp --entry train
    --device cpu`` (2 steps) and its tst-COMMON records through
    ``--entry predict --device cpu`` on the trained dir."""
    import shutil
    _, splits, outs = mustc
    root = str(tmp_path)
    shutil.copytree(os.path.join(outs["neurst_tpu_torch"], "devtest"),
                    os.path.join(root, "devtest"))
    ts = os.path.join(outs["neurst_tpu_torch"], "transcripts")
    model_dir, launches = chip_smoke.prep_train_phase(
        root, f"{ts}/codes.bpe", f"{ts}/vocab.de",
        os.path.join(outs["neurst_tpu_torch"], "asr_st", "train"), "cpu",
        MUSTC)
    assert os.path.exists(os.path.join(model_dir, "ckpt-2.npz"))
    assert not any(launches.values())   # the CPU runs the plain versions
    counts = chip_smoke.prep_predict_phase(root, model_dir, "cpu", MUSTC)
    assert not any(counts.values())
    with open(os.path.join(root, "hypo.txt")) as f:
        assert len(f.read().splitlines()) == len(splits["tst-COMMON"])


# ---------------------------------------------------- MultiTask task


def _task_args(ts, **extra):
    return {"task.class": "MultiTaskSpeechTranslation",
            "task.params": dict(_triple_task(ts), batch_size=2000,
                                max_src_len=600, shuffle_buffer=0,
                                **extra)}


def _batches(task, ds, mode):
    return list(task.create_batch_iterator(ds, mode)())


def test_multi_task_speech_translation_matches_jax(mustc):
    _, _, outs = mustc
    ts = os.path.join(outs["neurst_tpu_torch"], "transcripts")
    args = _task_args(ts)
    port, ref = build_task(args), jax_build_task(args)
    assert port.get_config() == ref.get_config()
    assert port._batch_text_fields() == ref._batch_text_fields()
    ds_args = {"dataset.class": "AudioTripleTFRecordDataset",
               "dataset.params": {"data_path": os.path.join(
                   outs["neurst_tpu_torch"], "train")}}
    ds, jds = build_dataset(ds_args), jax_build_dataset(ds_args)
    assert ds.status == jds.status
    for raw, jraw in zip(ds.build_iterator()(), jds.build_iterator()()):
        got = port.get_data_preprocess_fn(ModeKeys.TRAIN, ds.status)(raw)
        want = ref.get_data_preprocess_fn(ModeKeys.TRAIN, jds.status)(jraw)
        assert got["transcript"] == want["transcript"]
        assert got["translation"] == want["translation"]
        np.testing.assert_array_equal(got["audio"], want["audio"])
    # TRAIN: 2-D buckets over both text sides, compared whole
    train, jtrain = _batches(port, ds, ModeKeys.TRAIN), _batches(
        ref, jds, ModeKeys.TRAIN)
    assert len(train) == len(jtrain) > 0
    for got, want in zip(train, jtrain):
        assert sorted(got) == sorted(want)
        assert "asr_trg" in got and "trg" in got
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
    # EVAL / INFER: the JAX batcher truncates audio features to int32
    # (R5), so the audio is compared by shape and length
    for mode in (ModeKeys.EVAL, ModeKeys.INFER):
        got_b, want_b = _batches(port, ds, mode), _batches(ref, jds, mode)
        assert len(got_b) == len(want_b) > 0
        for got, want in zip(got_b, want_b):
            assert sorted(got) == sorted(want)
            for k in want:
                if k == "src":
                    assert got[k].shape == np.asarray(want[k]).shape
                else:
                    np.testing.assert_array_equal(got[k], np.asarray(
                        want[k]), k)
    for side in ("st", "asr"):
        p = build_task(_task_args(ts, generation_output=side))
        r = jax_build_task(_task_args(ts, generation_output=side))
        ids = [4, 5, 6, 1]
        for status in (DataStatus.PROJECTED, {"translation":
                                              DataStatus.PROJECTED,
                                              "transcript":
                                              DataStatus.PROJECTED}):
            assert p.get_data_postprocess_fn(status)(ids) \
                == r.get_data_postprocess_fn(status)(ids)
        assert type(p.get_eval_metric({})).__name__ \
            == type(r.get_eval_metric({})).__name__
        assert p.eval_targets(ds) == r.eval_targets(jds)


def test_multi_task_build_model_builds(mustc):
    """The task builds the joint model over its two vocabularies (the
    JAX task's parameter names), trains it on the stage-03 records'
    first TRAIN batch through the joint criterion, and hands the
    generation side to the model."""
    from neurst_tpu.utils.checkpoints import flatten_params
    from neurst_tpu_torch.utils.param_bridge import state_dict_to_flat
    _, _, outs = mustc
    ts = os.path.join(outs["neurst_tpu_torch"], "transcripts")
    from neurst_tpu_torch.models.speech_transformer import SpeechTransformer
    cfg = {"model.class": "MultiTaskSpeechTransformer",
           "model.params": dict(SpeechTransformer.build_model_args_by_name(
               "speech_transformer_toy")["model.params"], dtype="float32")}
    task = build_task(_task_args(ts))
    model = task.build_model(cfg, device="cpu")
    meta = {"st": task._translation_pipeline.meta,
            "asr": task.trg_pipeline.meta}
    assert model.trg_meta["vocab_size"] == meta["st"]["vocab_size"]
    assert model.asr_meta["vocab_size"] == meta["asr"]["vocab_size"]
    jmodel = jax_build_task(_task_args(ts)).build_model(cfg)
    model.init_params()
    assert sorted(state_dict_to_flat(model)) == sorted(flatten_params(
        jmodel.init_params(jax.random.PRNGKey(0))))
    ds = build_dataset({"dataset.class": "AudioTripleTFRecordDataset",
                        "dataset.params": {"data_path": os.path.join(
                            outs["neurst_tpu_torch"], "asr_st", "train")}})
    batch = _batches(task, ds, ModeKeys.TRAIN)[0]
    criterion = neurst_tpu_torch.build_criterion({
        "criterion.class": "joint_criterion", "criterion.params": {
            "criterions": [
                {"class": "label_smoothed_cross_entropy",
                 "params": {"label_smoothing": 0.1}, "output_key": "st"},
                {"class": "label_smoothed_cross_entropy",
                 "params": {"label_smoothing": 0.1}, "output_key": "asr",
                 "input_prefix": "asr", "weight": 0.3}]}})
    from neurst_tpu_torch.utils.rng import make_key
    out, _ = model.call_train(batch, dropout_key=make_key(0))
    for head in ("st", "asr"):
        prefix = "asr_" if head == "asr" else ""
        assert out[head].shape == batch[prefix + "trg"].shape + (
            meta[head]["vocab_size"],)
    assert np.isfinite(float(criterion.reduce_loss(batch, out).detach()))
    asr = build_task(_task_args(ts, generation_output="asr")).build_model(
        cfg, device="cpu")
    assert asr.generation_meta == meta["asr"] \
        and model.generation_meta == meta["st"]
    assert asr.args["generation_output"] == "asr"


# ------------------------------------------------------ small CLIs


def _run_both(name, argv_of):
    """Runs the CLI of both packages; returns {package: stdout}."""
    out = {}
    for pkg in PACKAGES:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _cli(pkg, name).main(argv_of(pkg))
        out[pkg] = buf.getvalue()
    return out


def test_generate_vocab_matches(tmp_path):
    corpus = tmp_path / "c.txt"
    corpus.write_text("a b b c c c\n" "c b a a\nD d d\n")
    for flags in ([], ["--min_frequency", "2"], ["--lowercase",
                                                 "--max_vocab_size", "2",
                                                 "--extra_slots", "2"]):
        _run_both("generate_vocab", lambda pkg: [
            "--input", str(corpus), "--output",
            str(tmp_path / f"vocab.{pkg}"), *flags])
        port = (tmp_path / "vocab.neurst_tpu_torch").read_text()
        assert port == (tmp_path / "vocab.neurst_tpu").read_text()
    assert [line.split()[0] for line in port.splitlines()] == [
        "c", "a", "<unused0>", "<unused1>"]


# a line a MuST-C language with its quotes, apostrophes, numbers and
# spaces (non-breaking ones too), for the recipe's ``process_text``
PROCESS_TEXT_LINES = {
    "en": "Hello, world! It's 2026. \"Quoted\" -- a well-known (test)...",
    "de": "„Hallo“, sagte er – es ist 3,5\u00a0% größer, z.B. Nr. 5!",
    "es": "¿Qué tal? ¡Hola! Son 1.000 \u00abpesos\u00bb, Sr. García.",
    "fr": "L'homme a dit\u00a0: \u00ab\u00a0Non\u00a0!\u00a0\u00bb "
          "C'est 3,5\u00a0%.",
    "it": "Dell'anno scorso, l'uomo disse: \"Sì\"... è così.",
    "nl": "'t Is z'n boek, dhr. De Vries — 1.000 euro.",
    "pt": "A ação \u201cnão\u201d custa 3,5\u00a0%, Sr. Silva.",
    "ro": "Dl. Popescu n-a spus: \u201eștiință\u201d într-un an.",
    "ru": "Он сказал: \u00abПривет\u00bb, т.е. 3,5\u00a0% — много.",
}


def test_process_text_matches(tmp_path, monkeypatch):
    """``process_text --tokenizer moses --normalize_punctuation``, then
    ``--detokenize``, in every MuST-C language: the port's CLI, where
    sacremoses cannot be imported, writes the JAX CLI's bytes."""
    sacremoses = pytest.importorskip("sacremoses")
    english = None
    for lang, line in PROCESS_TEXT_LINES.items():
        src = tmp_path / f"in.{lang}"
        src.write_text("Hello, world! It's 2026.\nA second line.\n" + line
                       + "\n" + line.upper() + "\n")
        outs = {}
        for pkg in PACKAGES:
            if pkg == "neurst_tpu_torch":
                monkeypatch.setitem(sys.modules, "sacremoses", None)
            tok = tmp_path / f"tok.{lang}.{pkg}"
            detok = tmp_path / f"detok.{lang}.{pkg}"
            _cli(pkg, "process_text").main([
                "--tokenizer", "moses", "--language", lang,
                "--normalize_punctuation", "--input", str(src),
                "--output", str(tok)])
            _cli(pkg, "process_text").main([
                "--tokenizer", "moses", "--language", lang, "--detokenize",
                "--input", str(tok), "--output", str(detok)])
            outs[pkg] = (tok.read_text(), detok.read_text())
        monkeypatch.setitem(sys.modules, "sacremoses", sacremoses)
        assert outs["neurst_tpu"] == outs["neurst_tpu_torch"], lang
        assert outs["neurst_tpu_torch"][0] != src.read_text()
        assert " ," in outs["neurst_tpu_torch"][0]
        english = english or outs["neurst_tpu_torch"]
    # English's apostrophe rules give its contraction back
    assert english[1].splitlines()[0] == "Hello, world! It's 2026."


def test_view_records_and_audio_analysis_match(tmp_path):
    from neurst_tpu_torch.data.recordio import RecordWriter, build_example
    rng = np.random.RandomState(0)
    rec = str(tmp_path / "x.tfrecords")
    with RecordWriter(rec) as w:
        for i in range(5):
            w.write(build_example({
                "audio": rng.randn(40 * (i + 2)).astype(np.float32),
                "transcript": rng.randint(0, 9, size=i + 2).astype(
                    np.int64)}))
    for argv in ([rec, "--count", "2"], [rec, "--stats"]):
        out = _run_both("view_records", lambda pkg: argv)
        assert out["neurst_tpu"] == out["neurst_tpu_torch"]
        assert "audio" in out["neurst_tpu_torch"]
    out = _run_both("audio_analysis", lambda pkg: [
        rec, "--audio_feature_dim", "8", "--audio_feature_channels", "1"])
    assert out["neurst_tpu"] == out["neurst_tpu_torch"]
    assert "ratio" in out["neurst_tpu_torch"]
