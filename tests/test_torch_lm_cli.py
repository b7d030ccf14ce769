"""Language modelling (GPT-2, the ``lm`` task) through both packages'
CLIs.

The configuration of the JAX package's
``tests/test_lm_and_multilingual_e2e.py::test_lm_train_and_eval_ppl``
(a 1-layer d 16 GPT-2 over ``tests/examples``' mono text, token-bucketed
batches of 64 tokens, max length 16) trains 10 steps without shuffling in
both packages' ``run_exp`` from one ``ckpt-0.npz`` of the JAX
initializers; then both packages' eval (PPL on the dev text) and predict
entries (the dev lines as prompts, continued by beam 2 and by greedy
``top_sampling``) read the port's dir.  GPT-2's dropout rate is 0.1 in
both packages whatever the flags (``dropout_rate or 0.1``), and the two
draw different masks, so both sides build the decoder stack at rate 0
(a patch of each package's builder).  The JAX side runs in two
subprocesses on one CPU device each, beside the port's side.

Tolerances: losses 1e-5 relative (the log line's 4 decimals are coarser);
hypothesis files identical; PPL and NLL 1e-6 relative.
"""

import json
import os
import shutil

import numpy as np
import pytest

import port_test_support  # noqa: F401  (one torch thread per worker)

jax = pytest.importorskip("jax")

from neurst_tpu.cli.run_exp import \
    parse_and_merge as jax_parse_and_merge  # noqa: E402
from neurst_tpu.tasks.task import build_task as jax_build_task  # noqa: E402
from neurst_tpu.utils import checkpoints as jax_ckpt  # noqa: E402
from neurst_tpu_torch.cli import run_exp as port_run_exp  # noqa: E402
from neurst_tpu_torch.exps import trainer as port_trainer  # noqa: E402
from neurst_tpu_torch.models import gpt2 as port_gpt2  # noqa: E402

from port_test_support import (JAX_CLI_SIDE, REPO,  # noqa: E402
                               TrainerLossLog, start_jax_side)

EXAMPLES = os.path.join(REPO, "tests", "examples")
STEPS = 10
TOL = 1e-5
JAX_PATCH = r"""
import neurst_tpu.models.gpt2 as gpt2_mod
_module = gpt2_mod.GPT2Module
def _no_dropout(**kw):
    kw["dropout_rate"] = 0.0
    return _module(**kw)
gpt2_mod.GPT2Module = _no_dropout
"""
SEARCHES = {
    "beam": ["--search_method.params",
             json.dumps({"beam_size": 2, "maximum_decode_length": 8})],
    "greedy": ["--search_method", "top_sampling", "--search_method.params",
               json.dumps({"top_k": 1, "maximum_decode_length": 8})]}


def _config(root):
    cfg = {
        "task.class": "lm",
        "task.params": {
            "data_pipeline.class": "TextDataPipeline",
            "data_pipeline.params": {
                "vocab_path": os.path.join(EXAMPLES, "vocab.txt")},
            "batch_size": 64, "batch_by_tokens": True, "max_len": 16,
            "shuffle_buffer": 0},
        "dataset.class": "mono_text",
        "dataset.params": {"data_file": os.path.join(EXAMPLES,
                                                     "train.src")},
        "model.class": "gpt2",
        "model.params": {
            "num_layers": 1, "hidden_size": 16, "num_attention_heads": 2,
            "filter_size": 32, "max_position_embeddings": 32,
            "dtype": "float32"},
        "entry.class": "trainer",
        "entry.params": {
            "criterion.class": "label_smoothed_cross_entropy",
            "lr_schedule.class": "constant",
            "lr_schedule.params": {"learning_rate": 1e-3},
            "train_steps": STEPS, "summary_steps": 1,
            "save_checkpoint_steps": STEPS, "enable_tensorboard": False},
    }
    path = os.path.join(root, "lm.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lm_cli"))
    train = ["--entry", "train", "--config_paths", _config(root)]
    dirs = {side: os.path.join(root, side) for side in ("jax", "port")}
    dev = json.dumps({"data_file": os.path.join(EXAMPLES, "dev.src")})
    predict = {name: ["--entry", "predict", "--model_dir", dirs["port"],
                      "--dataset.class", "mono_text", "--dataset.params",
                      dev, *extra] for name, extra in SEARCHES.items()}
    evaluate = ["--entry", "eval", "--model_dir", dirs["port"],
                "--dataset.class", "mono_text", "--dataset.params", dev,
                "--batch_size", "64"]
    seeded = os.path.join(root, "seeded")
    ready = os.path.join(root, "port_trained")
    decodes = [["predict", argv + ["--output_file",
                                   os.path.join(root, f"{name}.jax")],
                os.path.join(root, f"jax_{name}.json")]
               for name, argv in predict.items()]
    procs = [
        start_jax_side(JAX_CLI_SIDE, root, "jax_train", [
            ["exec", JAX_PATCH, None], ["wait", seeded, None],
            ["train", train + ["--model_dir", dirs["jax"]],
             os.path.join(root, "jax_train.json")]]),
        start_jax_side(JAX_CLI_SIDE, root, "jax_decode", [
            ["exec", JAX_PATCH, None], ["wait", ready, None]] + decodes
            + [["eval", evaluate, os.path.join(root, "jax_eval.json")]])]
    out = {"root": root}
    try:
        parsed = jax_parse_and_merge(train)
        jmodel = jax_build_task(parsed).build_model(
            {"model.class": parsed["model.class"],
             "model.params": parsed["model.params"]})
        seed_dir = os.path.join(root, "seed")
        jax_ckpt.save_checkpoint(seed_dir, 0, jax.tree_util.tree_map(
            np.asarray, jmodel.init_params(jax.random.PRNGKey(1))))
        for d in dirs.values():
            shutil.copytree(seed_dir, d)
        open(seeded, "w").close()
        log = TrainerLossLog()
        decoder = port_gpt2.TransformerDecoder

        def no_dropout(*args, **kw):
            kw.update(attention_dropout_rate=0.0, ffn_dropout_rate=0.0,
                      layer_postprocess_dropout_rate=0.0)
            return decoder(*args, **kw)

        trainer_logging, port_trainer.logging = port_trainer.logging, log
        port_gpt2.TransformerDecoder = no_dropout
        try:
            port_run_exp.cli_main(train + ["--model_dir", dirs["port"],
                                           "--device", "cpu"])
            open(ready, "w").close()
            for name, argv in predict.items():
                out[f"port_{name}"] = port_run_exp.cli_main(
                    argv + ["--output_file",
                            os.path.join(root, f"{name}.port"),
                            "--device", "cpu"])
            out["port_eval"] = port_run_exp.cli_main(evaluate + ["--device",
                                                                 "cpu"])
        finally:
            port_trainer.logging = trainer_logging
            port_gpt2.TransformerDecoder = decoder
        out["port_train"] = log.losses
        for proc, _ in procs:
            proc.wait(timeout=600)
    finally:
        for proc, _ in procs:
            proc.kill()
    for proc, path in procs:
        with open(path) as f:
            assert proc.returncode == 0, f.read()[-4000:]
    for name in ["jax_train", "jax_eval"] + [f"jax_{n}" for n in SEARCHES]:
        with open(os.path.join(root, f"{name}.json")) as f:
            out[name] = json.load(f)
    return out


def test_lm_cli_training_losses_match_jax(runs):
    port, ref = runs["port_train"], runs["jax_train"]
    assert len(port) == len(ref) == STEPS
    np.testing.assert_allclose(port, ref, rtol=TOL)


def test_lm_cli_eval_ppl_matches_jax(runs):
    ours, ref = runs["port_eval"], runs["jax_eval"]
    assert 1.0 < ref["PPL"] < 1e9
    for key in ("PPL", "NLL"):
        assert abs(ours[key] - ref[key]) <= 1e-6 * abs(ref[key]), key


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_lm_cli_predict_matches_jax(runs, name):
    ours, ref = runs[f"port_{name}"], runs[f"jax_{name}"]
    assert ours["samples"] == ref["samples"] == 24
    with open(os.path.join(runs["root"], f"{name}.port")) as f, \
            open(os.path.join(runs["root"], f"{name}.jax")) as g:
        assert f.read() == g.read()
    assert ours["hypotheses"] == ref["hypotheses"]


def test_r12_bound_control_ids_do_not_survive_the_model_configs(tmp_path):
    """R12: ``TextDataPipeline(vocab_path, eos_id=...)`` binds its control
    tokens to entries of the vocabulary (GPT-2's <|endoftext|>), but its
    ``config`` (what a trainer writes to model_configs.yml) drops the
    bound ids, so the eval and predict entries rebuild a pipeline that
    appends <UNK>, <SEQ_BEG> and <SEQ_END> again: a vocabulary 3 larger
    than the trained model's, and another eos.  Both packages do so."""
    from neurst_tpu.data.data_pipelines.data_pipeline import \
        build_data_pipeline as jax_pipeline
    from neurst_tpu_torch.data.data_pipelines import build_data_pipeline
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("a\nb\nc\n<unk>\n<s>\n<|endoftext|>\n")
    params = {"vocab_path": str(vocab), "unk_id": 3, "bos_id": 4,
              "eos_id": 5}
    for build in (build_data_pipeline, jax_pipeline):
        bound = build({"data_pipeline.class": "TextDataPipeline",
                       "data_pipeline.params": params})
        assert bound.meta["vocab_size"] == 6 and bound.meta["eos_id"] == 5
        assert "eos_id" not in bound.config
        rebuilt = build({"data_pipeline.class": "TextDataPipeline",
                         "data_pipeline.params": bound.config})
        assert rebuilt.meta["vocab_size"] == 9
        assert rebuilt.meta["eos_id"] == 8
