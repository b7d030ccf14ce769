"""The port's checkpoint ensembles, ASR -> MT cascade and small CLIs
against the JAX package's, on the CPU.

Model dirs the port's trainer wrote on the CPU (float32; the JAX package
reads them): two ``speech_transformer_toy`` ASR dirs (A: 60 steps, B: 30
steps from another seed) on 16 ``audio_tfrecord`` utterances of
whole-number 16-dim features (the JAX INFER batcher truncates features
to int32, ROADMAP R5) and their transcripts, and a ``transformer_toy`` MT
dir trained on the transcripts and their word-for-word translations.
Prediction: batch 4, beam 2.

- ``--model_dir A,A`` gives A's hypotheses and scores exactly;
- ``--model_dir A,B`` gives the JAX ensemble's hypothesis file, without
  and with ``ensemble_weights``, and BLEU within 1e-6;
- ``cascade_st`` (A -> MT) writes the JAX ``cascade_st``'s output file
  and prints the same metric line;
- ``text_metric`` and ``inspect_checkpoint`` print what the JAX CLIs
  print; every name ``view_registry`` lists is registered under the same
  registry in the JAX package.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import port_test_support  # noqa: E402,F401

from neurst_tpu.cli import cascade_st as jax_cascade  # noqa: E402
from neurst_tpu.cli import inspect_checkpoint as jax_inspect  # noqa: E402
from neurst_tpu.cli import run_exp as jax_run_exp  # noqa: E402
from neurst_tpu.cli import text_metric as jax_text_metric  # noqa: E402
from neurst_tpu.data.recordio import RecordWriter, build_example  # noqa: E402
from neurst_tpu.utils.registry import REGISTRIES as JAX_REGISTRIES  # noqa
from neurst_tpu_torch.cli import cascade_st as port_cascade  # noqa: E402
from neurst_tpu_torch.cli import \
    inspect_checkpoint as port_inspect  # noqa: E402
from neurst_tpu_torch.cli import run_exp as port_run_exp  # noqa: E402
from neurst_tpu_torch.cli import text_metric as port_text_metric  # noqa
from neurst_tpu_torch.cli import view_registry as port_view  # noqa: E402

FEATURE_DIM = 16
SOURCE_WORDS = ["the", "cat", "sat", "on", "mat", "dog", "ran", "a", "big",
                "red", "house", "."]
TARGET_WORDS = ["die", "katze", "sass", "auf", "der", "matte", "hund",
                "lief", "ein", "grosses", "rotes", "haus", "."]
SEARCH = {"beam_size": 2, "length_penalty": -1, "maximum_decode_length": 8}


def _train(root, name, task, dataset, hparams, steps, seed):
    """A model dir from ``steps`` steps of the port's trainer on the CPU
    (float32, constant lr 0.01), from the seed's random init."""
    cfg = {"task.class": task[0], "task.params": task[1],
           "dataset.class": dataset[0], "dataset.params": dataset[1],
           "hparams_set": hparams, "dtype": "float32", "seed": seed,
           "entry.class": "trainer",
           "entry.params": {
               "criterion.class": "label_smoothed_cross_entropy",
               "lr_schedule.class": "constant",
               "lr_schedule.params": {"learning_rate": 0.01},
               "train_steps": steps, "save_checkpoint_steps": steps,
               "summary_steps": steps, "enable_tensorboard": False}}
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    model_dir = os.path.join(root, name)
    port_run_exp.cli_main(["--config_paths", path, "--model_dir", model_dir,
                           "--device", "cpu"])
    return model_dir


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Two speech dirs trained 60 and 30 steps from different seeds on 16
    utterances with transcripts, an MT dir trained 60 steps on their
    transcripts and translations (a word a word), the utterances as
    ``audio_tfrecord`` records and a prediction config."""
    root = str(tmp_path_factory.mktemp("ensemble"))
    rng = np.random.RandomState(9)
    vocabs = []
    for name, words in (("src", SOURCE_WORDS), ("trg", TARGET_WORDS)):
        vocabs.append(os.path.join(root, f"vocab.{name}"))
        with open(vocabs[-1], "w") as f:
            f.write("\n".join(words) + "\n")
    records = os.path.join(root, "test.tfrecords")
    pairs = []
    with RecordWriter(records) as w:
        for _ in range(16):
            audio = np.round(3.0 * rng.randn(int(rng.randint(20, 65)),
                                             FEATURE_DIM))
            ids = rng.randint(len(SOURCE_WORDS), size=int(rng.randint(2, 6)))
            pairs.append((" ".join(SOURCE_WORDS[i] for i in ids),
                          " ".join(TARGET_WORDS[i] for i in ids)))
            w.write(build_example({
                "audio": audio.reshape(-1).astype(np.float32),
                "translation": pairs[-1][0]}))
    texts = []
    for side in (0, 1):
        texts.append(os.path.join(root, f"train.{side}"))
        with open(texts[-1], "w") as f:
            f.write("\n".join(p[side] for p in pairs) + "\n")
    audio_data = ("audio_tfrecord", {"data_path": records,
                                     "feature_key": "audio",
                                     "transcript_key": "translation"})
    speech_task = ("speech2text", {
        "audio_feature_dim": FEATURE_DIM, "batch_size": 1024,
        "max_src_len": 64, "max_trg_len": 8, "min_src_bucket_boundary": 64,
        "shuffle_buffer": 0, "experimental_frame_transcript_ratio": 8.0,
        "transcript_data_pipeline.class": "TextDataPipeline",
        "transcript_data_pipeline.params": {"vocab_path": vocabs[0]}})
    dirs = {name: _train(root, name, speech_task, audio_data,
                         "speech_transformer_toy", steps, seed)
            for name, steps, seed in (("A", 60, 1), ("B", 30, 2))}
    dirs["mt"] = _train(
        root, "mt", ("translation", {
            "src_data_pipeline.class": "TextDataPipeline",
            "src_data_pipeline.params": {"vocab_path": vocabs[0]},
            "trg_data_pipeline.class": "TextDataPipeline",
            "trg_data_pipeline.params": {"vocab_path": vocabs[1]},
            "batch_size": 256, "shuffle_buffer": 0}),
        ("parallel_text", {"src_file": texts[0], "trg_file": texts[1]}),
        "transformer_toy", 60, 3)
    config = {"entry.class": "predict",
              "entry.params": {"search_method.class": "beam_search",
                               "search_method.params": SEARCH,
                               "metric.class": "bleu"},
              "dataset.class": "audio_tfrecord",
              "dataset.params": {"data_path": records,
                                 "feature_key": "audio",
                                 "transcript_key": "translation"},
              "batch_size": 4}
    cfg_path = os.path.join(root, "predict.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    return root, dirs, cfg_path, records


def _predict(main, workdir, model_dirs, out, extra=()):
    root, _, cfg_path, _ = workdir
    argv = ["--config_paths", cfg_path, "--model_dir", model_dirs,
            "--output_file", os.path.join(root, out), *extra]
    if main is port_run_exp.cli_main:
        argv += ["--device", "cpu"]
    result = main(argv)
    with open(os.path.join(root, out)) as f:
        return result, f.read()


def test_ensemble_of_one_dir_twice_is_the_single_model(workdir):
    _, dirs, _, _ = workdir
    single, single_file = _predict(port_run_exp.cli_main, workdir,
                                   dirs["A"], "hyp.single")
    twice, twice_file = _predict(port_run_exp.cli_main, workdir,
                                 f"{dirs['A']},{dirs['A']}", "hyp.twice")
    assert twice["samples"] == single["samples"] == 16
    assert twice_file == single_file
    assert twice["hypotheses"] == single["hypotheses"]
    assert twice["scores"] == single["scores"]
    assert len(set(single["hypotheses"])) > 1


@pytest.mark.parametrize("weights", [None, "0.3,0.7"])
def test_ensemble_of_two_dirs_matches_jax(workdir, weights):
    _, dirs, _, _ = workdir
    extra = [] if weights is None else [
        "--search_method.params",
        json.dumps(dict(SEARCH, ensemble_weights=weights))]
    out = {}
    for name, main in (("jax", jax_run_exp.cli_main),
                       ("port", port_run_exp.cli_main)):
        out[name] = _predict(main, workdir, f"{dirs['A']},{dirs['B']}",
                             f"hyp.ens.{weights}.{name}", extra)
    (ours, our_file), (ref, ref_file) = out["port"], out["jax"]
    assert our_file == ref_file
    assert ours["hypotheses"] == ref["hypotheses"]
    assert abs(ours["BLEU"] - ref["BLEU"]) <= 1e-6
    single = _predict(port_run_exp.cli_main, workdir, dirs["B"],
                      "hyp.single_b")[0]["hypotheses"]
    assert ours["hypotheses"] != single


def test_cascade_matches_jax(workdir, capsys):
    root, dirs, _, records = workdir
    base = ["--asr_model_dir", dirs["A"], "--mt_model_dir", dirs["mt"],
            "--dataset", "audio_tfrecord", "--data_path", records,
            "--batch_size", "4", "--asr_beam_size", "2",
            "--mt_beam_size", "2", "--maximum_decode_length", "10"]
    first = os.path.join(root, "cascade.first")
    port_cascade.main(base + ["--output_file", first, "--device", "cpu"])
    with open(first) as f:
        translations = f.read().splitlines()
    assert len(translations) == 16 and len(set(translations)) > 1
    # references that share n-grams with half the translations
    rng = np.random.RandomState(4)
    refs = [t if i % 2 else " ".join(rng.choice(TARGET_WORDS, 4))
            for i, t in enumerate(translations)]
    ref_file = os.path.join(root, "cascade.refs")
    with open(ref_file, "w") as f:
        f.write("\n".join(refs) + "\n")
    files, printed = {}, {}
    for name, main, extra in (("jax", jax_cascade.main, []),
                              ("port", port_cascade.main,
                               ["--device", "cpu"])):
        files[name] = os.path.join(root, f"cascade.{name}")
        capsys.readouterr()
        main(base + ["--output_file", files[name], "--ref_file", ref_file]
             + extra)
        printed[name] = capsys.readouterr().out
    with open(files["port"]) as f, open(files["jax"]) as g:
        assert f.read() == g.read()
    assert printed["port"] == printed["jax"]
    assert "BLEU" in printed["port"]
    bleu = eval(printed["port"].strip().splitlines()[-1])["BLEU"]
    assert 0 < bleu < 100


def _printed(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("metric", ["bleu", "wer", "two_refs"])
def test_text_metric_prints_as_jax(tmp_path, metric):
    rng = np.random.RandomState(1)
    hyp, refs = tmp_path / "hyp.txt", [tmp_path / "ref0.txt",
                                       tmp_path / "ref1.txt"]
    lines = [" ".join(rng.choice(SOURCE_WORDS, 5)) for _ in range(6)]
    hyp.write_text("\n".join(lines) + "\n")
    for i, ref in enumerate(refs):
        ref.write_text("\n".join(
            line if (j + i) % 3 else " ".join(rng.choice(SOURCE_WORDS, 4))
            for j, line in enumerate(lines)) + "\n")
    argv = ["--metric", "bleu" if metric == "two_refs" else metric,
            "--hypo_file", str(hyp), "--ref_file", str(refs[0])]
    if metric == "two_refs":
        argv.append(str(refs[1]))
    ours = _printed(port_text_metric.main, argv)
    assert ours == _printed(jax_text_metric.main, argv)
    assert ours.strip()


@pytest.mark.parametrize("extra", [[], ["--pattern", "bias",
                                        "--values"], ["--dir"]])
def test_inspect_checkpoint_prints_as_jax(workdir, extra):
    _, dirs, _, _ = workdir
    path = dirs["A"] if extra == ["--dir"] else os.path.join(
        dirs["A"], "ckpt-60.npz")
    argv = [path] + [a for a in extra if a != "--dir"]
    ours = _printed(port_inspect.main, argv)
    assert ours == _printed(jax_inspect.main, argv)
    assert "Total parameters:" in ours


def test_view_registry_names_are_the_jax_registries():
    listed = _printed(port_view.main, [])
    registries = [line.split()[0] for line in listed.splitlines()[1:]]
    assert {"model", "criterion", "dataset", "entry"} <= set(registries)
    checked = 0
    for name in registries:
        assert name in JAX_REGISTRIES, name
        out = _printed(port_view.main, [name])
        for line in out.splitlines()[1:]:
            aliases = json.loads(line.split("aliases=")[1].replace("'", '"'))
            for alias in aliases:
                assert alias in JAX_REGISTRIES[name], (name, alias)
                checked += 1
    assert checked > 50
    for cls in ("multi_task_speech_transformer", "joint_criterion",
                "mixed_speech_text"):
        assert cls in _printed(port_view.main, [
            {"joint_criterion": "criterion",
             "mixed_speech_text": "dataset"}.get(cls, "model")])
    flags = _printed(port_view.main, ["model",
                                      "multi_task_speech_transformer"])
    assert "--generation_output" in flags
