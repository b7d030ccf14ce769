"""CTNMT through both packages' CLIs, and R11.

The CTNMT configuration of the JAX package's
``test_ctnmt_dynamic_switch_train_and_predict``
(``tests/test_lm_and_multilingual_e2e.py``; dynamic switch, 1 + 1 layers and a 1-layer BERT at d 16, ``freeze_variables:
bert``) trains 10 steps without shuffling in both packages' ``run_exp``
from one ``ckpt-0.npz`` of the JAX initializers; then both packages'
predict (beam 2, max 16, BLEU) and eval entries read the port's dir.  The
BERT trunk's dropout is 0.1 in both packages whatever the flags, and the
two draw different masks, so both sides pass it 0 (a patch of each
package's builder); the MT stacks' rates are 0 by the configuration.
The JAX side runs in two subprocesses on one CPU device each, beside the
port's side.

R11: the recipe's literal workflow (``convert_checkpoint --converter
google_bert``, then ``pretrain_model`` with ``pretrain_variable_pattern:
bert``) restores no BERT parameter in either package, since the
converter writes the trunk's names without CTNMT's ``bert/`` prefix;
``load_pretrained_into(..., to_prefix="bert/")`` restores all of them in
both.

Tolerances: losses 1e-5 relative (the log line's 4 decimals are coarser);
hypothesis files identical; BLEU and PPL 1e-6 relative.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import port_test_support  # noqa: F401  (one torch thread per worker)

jax = pytest.importorskip("jax")

import chip_smoke  # noqa: E402
import neurst_tpu_torch  # noqa: E402
from neurst_tpu.cli.run_exp import \
    parse_and_merge as jax_parse_and_merge  # noqa: E402
from neurst_tpu.models.model import build_model as jax_build  # noqa: E402
from neurst_tpu.tasks.task import build_task as jax_build_task  # noqa: E402
from neurst_tpu.utils import checkpoints as jax_ckpt  # noqa: E402
from neurst_tpu.utils.converters.converter import \
    build_converter as jax_converter  # noqa: E402
from neurst_tpu_torch.cli import run_exp as port_run_exp  # noqa: E402
from neurst_tpu_torch.cli.convert_checkpoint import \
    main as port_convert  # noqa: E402
from neurst_tpu_torch.exps import trainer as port_trainer  # noqa: E402
from neurst_tpu_torch.layers.auto_pretrained_layer import \
    load_pretrained_into  # noqa: E402
from neurst_tpu_torch.models.ctnmt_transformer import \
    CtnmtTransformer  # noqa: E402
from neurst_tpu_torch.utils import checkpoints as port_ckpt  # noqa: E402
from neurst_tpu_torch.utils.param_bridge import \
    state_dict_to_flat  # noqa: E402

from port_test_support import (JAX_CLI_SIDE, REPO,  # noqa: E402
                               TrainerLossLog, start_jax_side)

EXAMPLES = os.path.join(REPO, "tests", "examples")
STEPS = 10
TOL = 1e-5
BERT = dict(layers=1, dim=16, heads=2, filter=3072, vocab=None,
            positions=512, token_types=2)
JAX_PATCH = r"""
from neurst_tpu.models.ctnmt_transformer import CtnmtTransformer
_kwargs = CtnmtTransformer.module_kwargs
def _no_bert_dropout(self):
    kw = _kwargs(self)
    kw["bert_cfg"] = dict(kw["bert_cfg"], dropout_rate=0.0)
    return kw
CtnmtTransformer.module_kwargs = _no_bert_dropout
"""


def _config(root):
    vocab = {"vocab_path": os.path.join(EXAMPLES, "vocab.txt")}
    cfg = {
        "task.class": "translation",
        "task.params": {
            "src_data_pipeline.class": "TextDataPipeline",
            "src_data_pipeline.params": vocab,
            "trg_data_pipeline.class": "TextDataPipeline",
            "trg_data_pipeline.params": vocab,
            "batch_size": 64, "batch_by_tokens": True,
            "max_src_len": 16, "max_trg_len": 16, "shuffle_buffer": 0},
        "dataset.class": "parallel_text",
        "dataset.params": {"src_file": os.path.join(EXAMPLES, "train.src"),
                           "trg_file": os.path.join(EXAMPLES, "train.trg")},
        "model.class": "ctnmt",
        "model.params": {
            "bert_mode": "dynamic_switch",
            "modality.share_embedding_and_softmax_weights": True,
            "modality.dim": 16, "modality.timing": "sinusoids",
            "encoder.num_layers": 1, "encoder.hidden_size": 16,
            "encoder.num_attention_heads": 2, "encoder.filter_size": 32,
            "decoder.num_layers": 1, "decoder.hidden_size": 16,
            "decoder.num_attention_heads": 2, "decoder.filter_size": 32,
            "bert.num_layers": 1, "bert.hidden_size": 16,
            "bert.num_attention_heads": 2, "dtype": "float32"},
        "entry.class": "trainer",
        "entry.params": {
            "criterion.class": "label_smoothed_cross_entropy",
            "lr_schedule.class": "constant",
            "lr_schedule.params": {"learning_rate": 1e-3},
            "freeze_variables": "bert", "train_steps": STEPS,
            "summary_steps": 1, "save_checkpoint_steps": STEPS,
            "enable_tensorboard": False},
    }
    path = os.path.join(root, "ctnmt.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _dev():
    return json.dumps({"src_file": os.path.join(EXAMPLES, "dev.src"),
                       "trg_file": os.path.join(EXAMPLES, "dev.trg")})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ctnmt_cli"))
    train = ["--entry", "train", "--config_paths", _config(root)]
    dirs = {side: os.path.join(root, side) for side in ("jax", "port")}
    predict = ["--entry", "predict", "--model_dir", dirs["port"],
               "--dataset.class", "parallel_text", "--dataset.params",
               _dev(), "--search_method.params",
               json.dumps({"beam_size": 2, "maximum_decode_length": 16}),
               "--metric", "bleu"]
    evaluate = ["--entry", "eval", "--model_dir", dirs["port"],
                "--dataset.class", "parallel_text", "--dataset.params",
                _dev(), "--batch_size", "64"]
    seeded = os.path.join(root, "seeded")
    ready = os.path.join(root, "port_trained")
    procs = [
        start_jax_side(JAX_CLI_SIDE, root, "jax_train", [
            ["exec", JAX_PATCH, None], ["wait", seeded, None],
            ["train", train + ["--model_dir", dirs["jax"]],
             os.path.join(root, "jax_train.json")]]),
        start_jax_side(JAX_CLI_SIDE, root, "jax_decode", [
            ["exec", JAX_PATCH, None], ["wait", ready, None],
            ["predict", predict + ["--output_file",
                                   os.path.join(root, "hypo.jax")],
             os.path.join(root, "jax_predict.json")],
            ["eval", evaluate, os.path.join(root, "jax_eval.json")]])]
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
        config = CtnmtTransformer.bert_config
        trainer_logging, port_trainer.logging = port_trainer.logging, log
        CtnmtTransformer.bert_config = lambda self: dict(
            config(self), dropout_rate=0.0)
        try:
            port_run_exp.cli_main(train + ["--model_dir", dirs["port"],
                                           "--device", "cpu"])
            open(ready, "w").close()
            out["port_predict"] = port_run_exp.cli_main(
                predict + ["--output_file", os.path.join(root, "hypo.port"),
                           "--device", "cpu"])
            out["port_eval"] = port_run_exp.cli_main(evaluate + ["--device",
                                                                 "cpu"])
        finally:
            port_trainer.logging = trainer_logging
            CtnmtTransformer.bert_config = config
        out["port_train"] = log.losses
        for proc, _ in procs:
            proc.wait(timeout=600)
    finally:
        for proc, _ in procs:
            proc.kill()
    for proc, path in procs:
        with open(path) as f:
            assert proc.returncode == 0, f.read()[-4000:]
    for name in ("jax_train", "jax_predict", "jax_eval"):
        with open(os.path.join(root, f"{name}.json")) as f:
            out[name] = json.load(f)
    return out


def test_ctnmt_cli_training_losses_match_jax(runs):
    port, ref = runs["port_train"], runs["jax_train"]
    assert len(port) == len(ref) == STEPS
    np.testing.assert_allclose(port, ref, rtol=TOL)
    # the frozen trunk is the seed's after the steps, in both dirs
    root = runs["root"]
    seed = port_ckpt.restore_checkpoint_params(
        os.path.join(root, "seed", "ckpt-0.npz"))
    for side in ("port", "jax"):
        trained = port_ckpt.restore_checkpoint_params(
            os.path.join(root, side, f"ckpt-{STEPS}.npz"))
        bert = [k for k in seed if k.startswith("bert/")]
        assert len(bert) == 19
        for k in bert:
            np.testing.assert_array_equal(trained[k], seed[k], err_msg=k)
        assert not np.array_equal(trained["ds_gate_w/kernel"],
                                  seed["ds_gate_w/kernel"])


def test_ctnmt_cli_predict_and_eval_match_jax(runs):
    ours, ref = runs["port_predict"], runs["jax_predict"]
    assert ours["samples"] == ref["samples"] == 24
    with open(os.path.join(runs["root"], "hypo.port")) as f, \
            open(os.path.join(runs["root"], "hypo.jax")) as g:
        assert f.read() == g.read()
    assert ours["hypotheses"] == ref["hypotheses"]
    assert abs(ours["BLEU"] - ref["BLEU"]) <= 1e-6 * max(1.0, ref["BLEU"])
    for key in ("PPL", "NLL"):
        assert abs(runs["port_eval"][key] - runs["jax_eval"][key]) \
            <= 1e-6 * abs(runs["jax_eval"][key]), key


def test_r11_ctnmt_recipe_restores_no_bert(tmp_path):
    """examples/ctnmt/README.md step 1 converts BERT with
    ``convert_checkpoint --converter google_bert --to_path bert_ckpt``;
    the recipes then restore ``pretrain_model: [bert_ckpt]`` under
    ``pretrain_variable_pattern: [bert]``.  The converter writes
    ``word_embedding``, ``encoder/layer_0/...``; CTNMT's trunk is
    ``bert/word_embedding``, ``bert/encoder/layer_0/...``: the trainers'
    name-exact restore (JAX ``exps/trainer.py:197-204``, the port's
    ``Trainer._restore``) finds none of them.  The ``bert/`` prefix
    (``load_pretrained_into(..., to_prefix="bert/")``) restores all 19
    of the 1-layer trunk in both packages."""
    cfg = json.load(open(_config(str(tmp_path))))
    vocab = 43  # tests/examples/vocab.txt's 40 words + 3 control tokens
    state = chip_smoke.bert_state_dict(7, dict(BERT, vocab=vocab))
    pt = chip_smoke.save_torch_checkpoint(str(tmp_path / "bert.bin"),
                                          state)
    port_convert(["--converter", "google_bert", "--from_path", pt,
                  "--to_path", str(tmp_path / "bert_ckpt"), "--num_heads",
                  "2"])
    flat = port_ckpt.restore_checkpoint_params(
        port_ckpt.latest_checkpoint(str(tmp_path / "bert_ckpt")))
    assert "word_embedding" in flat and "bert/word_embedding" not in flat

    meta = {"vocab_size": vocab, "eos_id": 42, "bos_id": 41, "unk_id": 40}
    model_cfg = {"model.class": "ctnmt",
                 "model.params": cfg["model.params"]}
    tm = neurst_tpu_torch.build_model(model_cfg, src_meta=meta,
                                      trg_meta=meta, device="cpu")
    tm.init_params(torch.Generator().manual_seed(0))
    jm = jax_build(model_cfg, src_meta=meta, trg_meta=meta)
    params = jm.init_params(jax.random.PRNGKey(0))

    # the recipe: pattern "bert" over the converted names
    restored, missing = port_ckpt.restore_into(tm, flat, name_pattern="bert")
    _, jax_restored, jax_missing = jax_ckpt.restore_into(
        params, flat, name_pattern="bert")
    assert restored == [] and jax_restored == []
    assert len(missing) == len(jax_missing) == 19

    # the prefix: every trunk parameter, the converted values
    got = load_pretrained_into(tm, pt, "bert", num_heads=2,
                               to_prefix="bert/")
    converted = jax_converter({"converter.class": "google_bert",
                               "converter.params": {"num_heads": 2}}
                              ).convert_to_flat(pt)
    _, jax_got, _ = jax_ckpt.restore_into(
        params, {"bert/" + k: v for k, v in converted.items()})
    assert len(got) == len(jax_got) == 19
    ours = state_dict_to_flat(tm)
    for name, value in converted.items():
        np.testing.assert_array_equal(ours["bert/" + name], value)
