"""PruneTune through the port's ``run_exp --include`` (the plug-ins under
``neurst_tpu_torch/contrib/prune_tune/``; the form of
``tests/test_operational_paths.py``'s PruneTune test, at the tiny
Transformer of ``tests/examples/example_train_seq2seq.yml``).

A general model trained with pruning is fine-tuned by ``partial_tune``
(the plug-in named by its file): its dense slots stay bitwise unchanged
and more than half of its pruned slots move.  ``mask_predict`` (the
plug-in named by its module) on the tuned dir, masked by the general
dir, gives exactly the general dir's ``predict`` hypotheses, which the
tuned dir's own ``predict`` does not.  A plug-in named both ways
registers once, and a missing one raises.  With bf16 params the frozen
slots come out as bf16(general), as in the JAX trainer (R15).
"""

import os

import numpy as np
import pytest
import yaml

import port_test_support  # noqa: F401  (one torch thread per worker)

from neurst_tpu_torch.cli import run_exp  # noqa: E402
from neurst_tpu_torch.utils import checkpoints as ckpt_lib  # noqa: E402
from neurst_tpu_torch.utils.registry import \
    get_registered_class  # noqa: E402

from port_test_support import REPO  # noqa: E402

TRAIN_YML = "tests/examples/example_train_seq2seq.yml"
PLUGINS = os.path.join("neurst_tpu_torch", "contrib", "prune_tune")
LR = ["--lr_schedule.class", "constant",
      "--lr_schedule.params", "{learning_rate: 0.01}"]


def _cli(argv):
    os.chdir(REPO)
    return run_exp.cli_main(argv + ["--device", "cpu",
                                    "--enable_tensorboard", "false"])


def _predict(model_dir, entry):
    return _cli(["--entry"] + entry + [
        "--model_dir", model_dir, "--dataset.class", "parallel_text",
        "--dataset.params", "{src_file: tests/examples/dev.src, "
                            "trg_file: tests/examples/dev.trg}",
        "--search_method.params",
        "{beam_size: 2, maximum_decode_length: 12}"])["hypotheses"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("prune_tune"))
    general, tuned = os.path.join(root, "general"), os.path.join(root, "tuned")
    with open(os.path.join(REPO, TRAIN_YML)) as f:
        cfg = yaml.safe_load(f)
    cfg["task.params"]["shuffle_buffer"] = 0  # the same batches every run
    config = os.path.join(root, "train.yml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    _cli(["--entry", "train", "--config_paths", config, "--model_dir",
          general, "--train_steps", "40", "--save_checkpoint_steps", "40",
          "--summary_steps", "40",
          "--pruning_schedule.class", "constant_sparsity",
          "--pruning_schedule.params",
          "{target_sparsity: 0.5, begin_pruning_step: 5, "
          "pruning_frequency: 5}",
          "--pruning_variable_pattern", r"ffn/dense\d/kernel"] + LR)
    _cli(["--entry", "partial_tune",
          "--include", os.path.join(PLUGINS, "partial_trainer.py"),
          "--config_paths", TRAIN_YML, "--model_dir", tuned,
          "--pretrain_model", general, "--mask_dir", general,
          "--train_steps", "15", "--save_checkpoint_steps", "15",
          "--summary_steps", "15"] + LR)
    return general, tuned


def test_partial_tune_moves_only_the_pruned_slots(dirs):
    general = ckpt_lib.restore_checkpoint_params(
        ckpt_lib.latest_checkpoint(dirs[0]))
    tuned = ckpt_lib.restore_checkpoint_params(
        ckpt_lib.latest_checkpoint(dirs[1]))
    assert sorted(general) == sorted(tuned)
    frozen = tunable = 0
    for name, g in general.items():
        dense = g != 0
        np.testing.assert_array_equal(tuned[name][dense], g[dense],
                                      err_msg=name)
        frozen += int(dense.sum())
        if "ffn/dense" in name and name.endswith("kernel"):
            moved = float((tuned[name][~dense] != 0).mean())
            assert moved > 0.5, (name, moved)
            tunable += int((~dense).sum())
    assert frozen > 0 and tunable > 0


def test_mask_predict_on_the_tuned_dir_equals_the_general_predict(dirs):
    general, tuned = dirs
    want = _predict(general, ["predict"])
    assert len(set(want)) > 1, "the general model decodes one string"
    masked = _predict(tuned, [
        "mask_predict", "--include",
        "neurst_tpu_torch.contrib.prune_tune.mask_sequence_generator",
        "--mask_from_ckpt", general])
    assert masked == want
    assert _predict(tuned, ["predict"]) != want


def test_a_plugin_named_by_file_and_by_module_registers_once():
    run_exp._load_includes([
        os.path.join(REPO, PLUGINS, "mask_sequence_generator.py"),
        "neurst_tpu_torch.contrib.prune_tune.mask_sequence_generator",
        os.path.join(PLUGINS, "partial_trainer.py")])
    from neurst_tpu_torch.contrib.prune_tune import (mask_sequence_generator,
                                                     partial_trainer)
    assert get_registered_class("mask_generation", "entry") is \
        mask_sequence_generator.MaskSequenceGenerator
    assert get_registered_class("partial_trainer", "entry") is \
        partial_trainer.PartialTrainer
    with pytest.raises(ModuleNotFoundError):
        run_exp._load_includes(["no_such_plugin_module"])


def test_partial_tune_needs_a_mask_dir(dirs, tmp_path):
    with pytest.raises(ValueError, match="mask_dir"):
        _cli(["--entry", "partial_tune", "--include",
              os.path.join(PLUGINS, "partial_trainer.py"), "--config_paths",
              TRAIN_YML, "--model_dir", str(tmp_path / "m"),
              "--train_steps", "1"])


def test_r15_a_bf16_master_starts_from_the_rounded_general_weights(dirs,
                                                                    tmp_path):
    """R15, kept as in the JAX trainer: with bf16 params the restored
    float32 weights are cast to bf16 before the f32 master is taken from
    them, so partial_tune's frozen dense slots come out as bf16(general),
    not as the general model's own float32 values."""
    import torch
    general = ckpt_lib.restore_checkpoint_params(
        ckpt_lib.latest_checkpoint(dirs[0]))
    tuned = str(tmp_path / "bf16")
    _cli(["--entry", "partial_tune", "--include",
          os.path.join(PLUGINS, "partial_trainer.py"), "--config_paths",
          TRAIN_YML, "--model_dir", tuned, "--pretrain_model", dirs[0],
          "--mask_dir", dirs[0], "--dtype", "bfloat16", "--train_steps", "1",
          "--save_checkpoint_steps", "1"] + LR)
    after = ckpt_lib.restore_checkpoint_params(
        ckpt_lib.latest_checkpoint(tuned))
    rounded = 0
    for name, g in general.items():
        dense = g != 0
        want = torch.from_numpy(g).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(after[name][dense], want[dense],
                                      err_msg=name)
        rounded += int((want[dense] != g[dense]).sum())
    assert rounded > 0
