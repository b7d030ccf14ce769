"""Multilingual translation of the port against the JAX package's
(``neurst_tpu/tasks/multilingual_translation.py``,
``data/data_pipelines/multilingual_text_data_pipeline.py`` and
``MultilingualTranslationDataset``), and the trainer's
``enable_profiler``.

Held identical: the pipeline's meta, ids and texts (tags, unknown words,
``reverse_sequence``); the direction dataset's examples, alone and drawn
by ``mixed_train`` at its ratios; the task's TRAIN batches (token buckets
and fixed size) and INFER batches for every ``trg_lang_tag_position``
with and without the source tag.  Both CLIs run the configuration of the
JAX package's ``tests/test_lm_and_multilingual_e2e.py::
test_multilingual_train_and_predict`` (two directions of the reversal
corpus, 1 + 1 layers at d 16, 10 steps; the JAX side in a subprocess on
one CPU device) from one ``ckpt-0``: losses within 1e-5 relative,
parameters within 2 lr (attention key biases, whose gradient is rounding
noise, within 2 x the summed lr), predict hypotheses identical, BLEU
within 1e-6, and no language tag in a hypothesis.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

import port_test_support  # noqa: F401  (one torch thread per worker)

jax = pytest.importorskip("jax")

from neurst_tpu.data.data_pipelines.multilingual_text_data_pipeline import \
    MultilingualTextDataPipeline as JaxPipeline  # noqa: E402
from neurst_tpu.data.datasets.dataset import \
    build_dataset as jax_build_dataset  # noqa: E402
from neurst_tpu.tasks.task import build_task as jax_build_task  # noqa: E402
from neurst_tpu.utils import checkpoints as jax_ckpt  # noqa: E402
from neurst_tpu.utils.compat import ModeKeys as JaxModeKeys  # noqa: E402

import neurst_tpu_torch  # noqa: E402,F401
from neurst_tpu_torch.cli import run_exp as port_run_exp  # noqa: E402
from neurst_tpu_torch.data.data_pipelines.multilingual_text_data_pipeline \
    import MultilingualTextDataPipeline  # noqa: E402
from neurst_tpu_torch.data.datasets.dataset import build_dataset  # noqa
from neurst_tpu_torch.exps import trainer as port_trainer  # noqa: E402
from neurst_tpu_torch.tasks.task import build_task  # noqa: E402
from neurst_tpu_torch.utils import checkpoints as port_ckpt  # noqa: E402
from neurst_tpu_torch.utils.compat import ModeKeys  # noqa: E402

from port_test_support import (JAX_CLI_SIDE, REPO,  # noqa: E402
                               TrainerLossLog, start_jax_side)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EXAMPLES = os.path.join(REPO, "tests", "examples")
VOCAB = os.path.join(EXAMPLES, "vocab.txt")
STEPS = 10
LR = 1e-3
TOL = 1e-5
POSITIONS = ("trg", "target", "src", "source")


def _direction(src, trg, src_lang, trg_lang, split="train"):
    return {"dataset.class": "multilingual_translation_dataset",
            "dataset.params": {
                "src_file": os.path.join(EXAMPLES, f"{split}.{src}"),
                "trg_file": os.path.join(EXAMPLES, f"{split}.{trg}"),
                "src_lang": src_lang, "trg_lang": trg_lang}}


def _mixed(en2fr, fr2en):
    return {"dataset.class": "mixed_train", "dataset.params": {
        "data_files": {"en2fr": _direction("src", "trg", "en", "fr"),
                       "fr2en": _direction("trg", "src", "fr", "en")},
        "data_sampler.class": "data_sampler",
        "data_sampler.params": {"sample_ratios": {"en2fr": en2fr,
                                                  "fr2en": fr2en}}}}


MIXED = _mixed(0.7, 0.3)


def _task_cfg(position="trg", src_tag=True, **extra):
    return {"task.class": "multilingual_translation", "task.params": dict({
        "multilingual_dp.params": {"vocab_path": VOCAB,
                                   "languages": ["en", "fr"],
                                   "tokenizer": None},
        "with_src_lang_tag": src_tag, "trg_lang_tag_position": position,
        "batch_size": 64, "batch_by_tokens": True, "max_src_len": 18,
        "max_trg_len": 18, "shuffle_buffer": 0}, **extra)}


def _same_batches(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for key in b:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# ----------------------------- the pipeline --------------------------- #

@pytest.mark.parametrize("reverse", [False, True])
def test_pipeline_meta_encode_decode_match_jax(reverse):
    args = dict(vocab_path=VOCAB, languages=["en", "fr", "de"],
                tokenizer=None, reverse_sequence=reverse)
    ours, ref = MultilingualTextDataPipeline(**args), JaxPipeline(**args)
    assert ours.meta == ref.meta
    assert ours.meta["lang2id"] == {"en": 43, "fr": 44, "de": 45}
    assert ours.config == ref.config
    for text in ("tok1 tok2 tok3", "tok5 unknown tok39", ""):
        assert ours.encode(text) == ref.encode(text)
    ids = [ours.meta["lang2id"]["fr"], 7, 8, 40, ours.meta["eos_id"], 9]
    for seq in (ids, [ours.meta["bos_id"]] + ids[1:], ids[1:], []):
        assert ours.decode(seq) == ref.decode(seq)
    assert "<fr>" not in ours.decode(ids)


def test_spm_tokenizer_is_not_available():
    """The default tokenizer (spm) needs the ``sentencepiece`` package in
    the JAX package, which this host lacks: building the JAX pipeline
    raises.  The port's spm is its own: the pipeline builds, and asks for
    a model before it tokenizes (``tests/test_torch_spm.py`` encodes with
    one)."""
    with pytest.raises(ImportError, match="sentencepiece"):
        JaxPipeline(vocab_path=VOCAB, languages=["en"])
    pipe = MultilingualTextDataPipeline(vocab_path=VOCAB, languages=["en"])
    with pytest.raises(ValueError, match="spm model not initialized"):
        pipe.encode("tok1 tok2")


# ------------------------------ the dataset --------------------------- #

def test_direction_dataset_examples_match_jax():
    cfg = _direction("src", "trg", "en", "fr", split="dev")
    ours = list(build_dataset(cfg).build_iterator()())
    ref = list(jax_build_dataset(cfg).build_iterator()())
    assert ours == ref and len(ours) == 24
    assert ours[0]["src_lang"] == "en" and ours[0]["trg_lang"] == "fr"
    shard = list(build_dataset(cfg).build_iterator(None, 1, 3)())
    assert shard == list(jax_build_dataset(cfg).build_iterator(
        None, 1, 3)())


def test_mixed_train_draws_match_jax_at_its_ratios():
    def first(ds, n=2000):
        it = ds.build_iterator()()
        return [next(it) for _ in range(n)]
    ours, ref = first(build_dataset(MIXED)), first(jax_build_dataset(MIXED))
    assert ours == ref
    share = np.mean([ex["dataset_key"] == "en2fr" for ex in ours])
    assert abs(share - 0.7) < 0.05
    assert all((ex["src_lang"], ex["trg_lang"]) == (
        ("en", "fr") if ex["dataset_key"] == "en2fr" else ("fr", "en"))
        for ex in ours)


# -------------------------------- the task ---------------------------- #

def _batches(build, task_cfg, ds_cfg, mode, n):
    task = build(task_cfg)
    ds = (build_dataset if build is build_task else jax_build_dataset)(
        ds_cfg)
    it = task.create_batch_iterator(ds, mode)()
    return [next(it) for _ in range(n)] if n else list(it)


@pytest.mark.parametrize("src_tag", [True, False])
@pytest.mark.parametrize("position", POSITIONS)
@pytest.mark.parametrize("mode", ["train_tokens", "train_fixed", "infer"])
def test_task_batches_match_jax(position, src_tag, mode):
    extra = {"batch_by_tokens": False, "batch_size": 16} \
        if mode == "train_fixed" else {}
    cfg = _task_cfg(position, src_tag, **extra)
    if mode == "infer":
        ds_cfg, n = _direction("src", "trg", "en", "fr", split="dev"), 0
        ours = _batches(build_task, cfg, ds_cfg, ModeKeys.INFER, n)
        ref = _batches(jax_build_task, cfg, ds_cfg, JaxModeKeys.INFER, n)
    else:
        ours = _batches(build_task, cfg, MIXED, ModeKeys.TRAIN, 6)
        ref = _batches(jax_build_task, cfg, MIXED, JaxModeKeys.TRAIN, 6)
    _same_batches(ours, ref)
    lang2id = build_task(cfg).pipeline.meta["lang2id"]
    real = ours[0]["sample_mask"] > 0
    tags = int(position in ("src", "source")) + int(src_tag)
    assert np.all(ours[0]["src_length"][real] >= tags + 1)
    if tags:
        assert set(ours[0]["src"][real, 0].tolist()) <= set(
            lang2id.values())


def test_r13_multilingual_decode_starts_from_seq_beg():
    """R13: an INFER batch carries the target-language tag as
    ``trg_input``, but both packages' ``prepare_generation`` start every
    row from ``bos_id`` (<SEQ_BEG>), which training never fed the
    decoder with ``trg_lang_tag_position: trg``."""
    from neurst_tpu.models.model import build_model as jax_build
    cfg = _task_cfg("trg", True)
    task = build_task(cfg)
    batch = _batches(build_task, cfg, _direction(
        "src", "trg", "en", "fr", split="dev"), ModeKeys.INFER, 1)[0]
    meta = task.pipeline.meta
    rows = len(batch["trg_input"])
    assert np.all(batch["trg_input"][batch["sample_mask"] > 0]
                  == meta["lang2id"]["fr"])
    model_cfg = {"model.class": "transformer", "model.params": {
        "modality.dim": 8, "encoder.num_layers": 1, "decoder.num_layers": 1,
        "encoder.hidden_size": 8, "decoder.hidden_size": 8,
        "encoder.num_attention_heads": 2, "decoder.num_attention_heads": 2,
        "encoder.filter_size": 16, "decoder.filter_size": 16,
        "dtype": "float32"}}
    model = task.build_model(model_cfg, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    inputs = {k: v for k, v in batch.items() if k != "sample_mask"}
    with torch.no_grad():
        _, init = model.prepare_generation(inputs, 4)
    assert init["decoder_input"].tolist() == [meta["bos_id"]] * rows
    jm = jax_build(model_cfg, src_meta=meta, trg_meta=meta)
    _, jinit = jm.prepare_generation(
        jm.init_params(jax.random.PRNGKey(0)), inputs, 4)
    assert np.asarray(jinit["decoder_input"]).tolist() == \
        [meta["bos_id"]] * rows


# ------------------------------- both CLIs ---------------------------- #

def _train_config(root):
    cfg = dict(_task_cfg("trg", True), **_mixed(0.5, 0.5), **{
        "model.class": "transformer",
        "model.params": {
            "modality.share_source_target_embedding": True,
            "modality.share_embedding_and_softmax_weights": True,
            "modality.dim": 16, "modality.timing": "sinusoids",
            "encoder.num_layers": 1, "encoder.hidden_size": 16,
            "encoder.num_attention_heads": 2, "encoder.filter_size": 32,
            "decoder.num_layers": 1, "decoder.hidden_size": 16,
            "decoder.num_attention_heads": 2, "decoder.filter_size": 32},
        "dtype": "float32", "entry.class": "trainer",
        "entry.params": {
            "criterion.class": "label_smoothed_cross_entropy",
            "lr_schedule.class": "constant",
            "lr_schedule.params": {"learning_rate": LR},
            "train_steps": STEPS, "summary_steps": 1,
            "save_checkpoint_steps": STEPS, "enable_tensorboard": False}})
    path = os.path.join(root, "ml.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ml_cli"))
    train = ["--entry", "train", "--config_paths", _train_config(root)]
    dirs = {side: os.path.join(root, side) for side in ("jax", "port")}
    predict = ["--entry", "predict", "--model_dir", dirs["port"],
               "--dataset.class", "multilingual_translation_dataset",
               "--dataset.params", json.dumps(_direction(
                   "src", "trg", "en", "fr", split="dev")["dataset.params"]),
               "--search_method.params",
               json.dumps({"beam_size": 2, "maximum_decode_length": 20}),
               "--metric", "bleu"]
    seeded = os.path.join(root, "seeded")
    ready = os.path.join(root, "port_trained")
    procs = [
        start_jax_side(JAX_CLI_SIDE, root, "jax_train", [
            ["wait", seeded, None],
            ["train", train + ["--model_dir", dirs["jax"]],
             os.path.join(root, "jax_train.json")]]),
        start_jax_side(JAX_CLI_SIDE, root, "jax_predict", [
            ["wait", ready, None],
            ["predict", predict + ["--output_file",
                                   os.path.join(root, "hyp.jax")],
             os.path.join(root, "jax_predict.json")]])]
    out = {"root": root, "dirs": dirs}
    try:
        parsed = port_run_exp.parse_and_merge(train)
        jtask = jax_build_task(parsed)
        jmodel = jtask.build_model({"model.class": parsed["model.class"],
                                    "model.params": parsed["model.params"]})
        seed_dir = os.path.join(root, "seed")
        jax_ckpt.save_checkpoint(seed_dir, 0, jax.tree_util.tree_map(
            np.asarray, jmodel.init_params(jax.random.PRNGKey(1))))
        for d in dirs.values():
            shutil.copytree(seed_dir, d)
        open(seeded, "w").close()
        log = TrainerLossLog()
        trainer_logging, port_trainer.logging = port_trainer.logging, log
        try:
            port_run_exp.cli_main(train + ["--model_dir", dirs["port"],
                                           "--device", "cpu"])
        finally:
            port_trainer.logging = trainer_logging
        open(ready, "w").close()
        out["port_train"] = log.losses
        out["port_predict"] = port_run_exp.cli_main(
            predict + ["--output_file", os.path.join(root, "hyp.port"),
                       "--device", "cpu"])
        for proc, _ in procs:
            proc.wait(timeout=600)
    finally:
        for proc, _ in procs:
            proc.kill()
    for proc, path in procs:
        with open(path) as f:
            assert proc.returncode == 0, f.read()[-4000:]
    for name in ("jax_train", "jax_predict"):
        with open(os.path.join(root, f"{name}.json")) as f:
            out[name] = json.load(f)
    return out


def _key_bias(name, value):
    """The key part of an attention projection's bias, else None."""
    if name.endswith("/qkv_transform/bias"):
        return value[1]
    if name.endswith("/kv_transform/bias"):
        return value[0]
    return None


def test_multilingual_cli_training_matches_jax(runs):
    port, ref = runs["port_train"], runs["jax_train"]
    assert len(port) == len(ref) == STEPS
    np.testing.assert_allclose(port, ref, rtol=TOL)
    ours = port_ckpt.restore_checkpoint_params(os.path.join(
        runs["dirs"]["port"], f"ckpt-{STEPS}.npz"))
    want = jax_ckpt.restore_checkpoint_params(os.path.join(
        runs["dirs"]["jax"], f"ckpt-{STEPS}.npz"))
    assert sorted(ours) == sorted(want)
    for name in want:
        diff = np.abs(ours[name] - want[name])
        key = _key_bias(name, diff)
        if key is not None:
            assert float(key.max()) <= 2 * STEPS * LR + 1e-6, name
            diff = np.delete(diff, 1 if "qkv" in name else 0, axis=0)
        assert float(diff.max()) <= 2 * LR + 1e-6, name


def test_multilingual_cli_predict_matches_jax(runs):
    ours, ref = runs["port_predict"], runs["jax_predict"]
    assert ours["samples"] == ref["samples"] == 24
    with open(os.path.join(runs["root"], "hyp.port")) as f, \
            open(os.path.join(runs["root"], "hyp.jax")) as g:
        assert f.read() == g.read()
    assert ours["hypotheses"] == ref["hypotheses"]
    assert abs(ours["BLEU"] - ref["BLEU"]) <= 1e-6
    for hyp in ours["hypotheses"]:
        assert "<fr>" not in hyp and "<en>" not in hyp, hyp


# ------------------------------- profiler ----------------------------- #

def test_enable_profiler_writes_a_trace_and_keeps_the_losses(runs):
    """``enable_profiler`` traces steps 3-5 with torch.profiler into
    ``<model_dir>/profile/``; the losses equal an unprofiled run's."""
    config = os.path.join(runs["root"], "ml.json")
    losses = {}
    for profile in (False, True):
        model_dir = os.path.join(runs["root"], f"profile_{profile}")
        log = TrainerLossLog()
        trainer_logging, port_trainer.logging = port_trainer.logging, log
        try:
            port_run_exp.cli_main([
                "--entry", "train", "--config_paths", config, "--model_dir",
                model_dir, "--device", "cpu", "--train_steps", "6",
                "--enable_profiler", str(profile).lower()])
        finally:
            port_trainer.logging = trainer_logging
        losses[profile] = log.losses
        traces = glob.glob(os.path.join(model_dir, "profile",
                                        "*.pt.trace.json"))
        assert len(traces) == int(profile)
    assert len(losses[True]) == 6 and losses[True] == losses[False]
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == "ProfilerStep#3" for e in events) == 1
