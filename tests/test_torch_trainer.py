"""The port's ``train`` entry against the JAX package's, end to end on
the CPU.

One toy ``speech_transformer_toy`` setup: 13 ``audio_tfrecord``
utterances (16-dim whole-number features, 20-64 frames, 2-6 words), a
word vocabulary, the MuST-C recipe's task flags cut to one bucket of 8
(so every JAX step compiles once and each epoch ends with a batch padded
by length-0 rows), SpecAugment ``LB`` with ``np.random`` seeded before
each run, no shuffling, float32, dropout 0, label smoothing 0.1, clip
norm 1 and a noam schedule with warmup 1 (lr 1e-3 at step 1, falling as
1/sqrt(step)).  Both trainers start from the same JAX-initialised
``ckpt-0.npz`` and train 4 steps, saving every 2, with ``update_cycle``
1 and 2.  The JAX side runs in a subprocess on one CPU device (the test
session's 8 virtual devices would make the JAX trainer batch for 8
replicas) with a compilation cache, so its resumed runs reuse the step.

Checked: ckpt-2 and ckpt-4 within 2 lr + 1e-6 of JAX's; equal
``checkpoint.json``; each package loads the other's
``model_configs.yml``; the JAX package restores every parameter of a
port checkpoint, its ``predict`` CLI on the port-trained dir gives the
port's hypotheses and its trainer resumes from that dir; ``pretrain_model``
patterns restore the same names as JAX; R6 (after a resume with an
optimizer sidecar JAX reads its schedule at 2k + 1, the port at k + 1;
without one both at k + 1); a JAX ``.optstate`` without a port sidecar
and the mesh flags one process cannot hold raise; the CLI writes the documented files.
"""

import json
import logging
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import yaml

jax = pytest.importorskip("jax")

import neurst_tpu_torch  # noqa: E402
from neurst_tpu.data.recordio import RecordWriter, build_example  # noqa: E402
from neurst_tpu.tasks.task import build_task as jax_build_task  # noqa: E402
from neurst_tpu.utils import checkpoints as jax_ckpt  # noqa: E402
from neurst_tpu.utils.configurable import \
    ModelConfigs as JaxModelConfigs  # noqa: E402
from neurst_tpu_torch.cli import run_exp as port_run_exp  # noqa: E402
from neurst_tpu_torch.tasks.task import build_task as port_build_task  # noqa: E402
from neurst_tpu_torch.utils import checkpoints as port_ckpt  # noqa: E402
from neurst_tpu_torch.utils.configurable import \
    ModelConfigs as PortModelConfigs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATURE_DIM = 16
WORDS = ["the", "cat", "sat", "on", "mat", "dog", "ran", "a", "big", "red",
         "house", "we", "saw", "it"]
DMODEL, FACTOR = 16, 0.004
DROPOUTS = {f"{side}.{rate}": 0.0 for side in ("encoder", "decoder")
            for rate in ("attention_dropout_rate", "ffn_dropout_rate",
                         "layer_postprocess_dropout_rate")}
PREDICT_PARAMS = {"search_method.class": "beam_search",
                  "search_method.params": {"beam_size": 2,
                                           "length_penalty": -1,
                                           "maximum_decode_length": 8},
                  "metric.class": "bleu"}

# runs the JAX side's operations in one process: train / predict through
# neurst_tpu.cli.run_exp, copies and removals; each run's log to a file
JAX_DRIVER = r"""
import json, logging, os, shutil, sys
import numpy as np
import jax
jax.config.update("jax_default_matmul_precision", "float32")
from neurst_tpu.cli.run_exp import cli_main
logging.basicConfig(level=logging.INFO)
for op in json.load(open(sys.argv[1])):
    if op[0] == "copytree":
        shutil.copytree(op[1], op[2])
    elif op[0] == "remove":
        os.remove(op[1])
    else:
        handler = logging.FileHandler(op[2])
        logging.getLogger().addHandler(handler)
        np.random.seed(0)
        result = cli_main(op[1])
        logging.getLogger().removeHandler(handler)
        handler.close()
        if op[0] == "predict":
            with open(op[3], "w") as f:
                json.dump(result["hypotheses"], f)
"""


def noam(step):
    return FACTOR * DMODEL ** -0.5 / np.sqrt(step)


def _config(root, records, vocab, **entry):
    cfg = {
        "task.class": "speech2text",
        "task.params": {
            "audio_feature_dim": FEATURE_DIM, "batch_size": 512,
            "max_src_len": 64, "max_trg_len": 16, "truncate_src": True,
            "min_src_bucket_boundary": 64, "specaug": "LB",
            "shuffle_buffer": 0,
            "transcript_data_pipeline.class": "TextDataPipeline",
            "transcript_data_pipeline.params": {"vocab_path": vocab,
                                                "language": "en"}},
        "dataset.class": "audio_tfrecord",
        "dataset.params": {"data_path": records, "feature_key": "audio",
                           "transcript_key": "translation"},
        "hparams_set": "speech_transformer_toy",
        "model.params": dict(DROPOUTS, dtype="float32"),
        "entry.class": "trainer",
        "entry.params": dict({
            "train_steps": 4, "save_checkpoint_steps": 2,
            "summary_steps": 1, "enable_tensorboard": False,
            "clip_norm": 1.0,
            "criterion.class": "label_smoothed_cross_entropy",
            "criterion.params": {"label_smoothing": 0.1},
            "lr_schedule.params": {"warmup_steps": 1,
                                   "initial_factor": FACTOR}}, **entry)}
    path = os.path.join(root, f"train{len(os.listdir(root))}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


class _Messages(logging.Handler):

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _port_train(argv):
    handler = _Messages()
    root = logging.getLogger()
    root.addHandler(handler)
    level = root.level
    root.setLevel(logging.INFO)
    np.random.seed(0)
    try:
        state = port_run_exp.cli_main(argv + ["--device", "cpu"])
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    return state, handler.messages


def _first_lr(messages, step):
    for m in messages:
        found = re.match(rf"step {step} \| loss \S+ \| lr (\S+) ", m)
        if found:
            return float(found.group(1))
    raise AssertionError(f"no log of step {step}: {messages[-5:]}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trainer"))
    rng = np.random.RandomState(3)
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(WORDS) + "\n")
    records = os.path.join(root, "train.tfrecords")
    with RecordWriter(records) as w:
        for _ in range(13):
            audio = np.round(3.0 * rng.randn(int(rng.randint(20, 65)),
                                             FEATURE_DIM)).astype(np.float32)
            text = " ".join(rng.choice(WORDS, int(rng.randint(2, 7))))
            w.write(build_example({"audio": audio.reshape(-1),
                                   "translation": text}))
    cfgs = {uc: _config(root, records, vocab, update_cycle=uc)
            for uc in (1, 2)}
    predict_cfg = os.path.join(root, "predict.yml")
    with open(predict_cfg, "w") as f:
        yaml.safe_dump({"entry.class": "predict",
                        "entry.params": PREDICT_PARAMS,
                        "dataset.class": "audio_tfrecord",
                        "dataset.params": {"data_path": records,
                                           "feature_key": "audio",
                                           "transcript_key": "translation"},
                        "batch_size": 4}, f)

    # the JAX initializers' weights as ckpt-0 of every run's dir
    jtask = jax_build_task(yaml.safe_load(open(cfgs[1])))
    from neurst_tpu.models.speech_transformer import SpeechTransformer
    hp = SpeechTransformer.build_model_args_by_name("speech_transformer_toy")
    jmodel = jtask.build_model({"model.class": "SpeechTransformer",
                                "model.params": dict(hp["model.params"],
                                                     **DROPOUTS,
                                                     dtype="float32")})
    seed_dir = os.path.join(root, "seed")
    jax_ckpt.save_checkpoint(seed_dir, 0, jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(1))))
    dirs = {}
    for side in ("jax", "port"):
        for uc in (1, 2):
            dirs[side, uc] = os.path.join(root, f"{side}_uc{uc}")
            shutil.copytree(seed_dir, dirs[side, uc])

    def argv(uc, model_dir, *extra):
        return ["--config_paths", cfgs[uc], "--model_dir", model_dir,
                *extra]

    # the port: both runs, then R6's resumes on copies of the uc 1 dir
    out = {"port_msgs": {}}
    for uc in (1, 2):
        out["port_state", uc], out["port_msgs"][uc] = _port_train(
            argv(uc, dirs["port", uc]))
    for tag in ("sidecar", "fresh"):
        dirs["port", tag] = os.path.join(root, f"port_{tag}")
        shutil.copytree(dirs["port", 1], dirs["port", tag])
    _, out["port_msgs"]["sidecar"] = _port_train(
        argv(1, dirs["port", "sidecar"], "--train_steps", "5"))
    os.remove(os.path.join(dirs["port", "fresh"],
                           "ckpt-4.torch_optstate.npz"))
    _, out["port_msgs"]["fresh"] = _port_train(
        argv(1, dirs["port", "fresh"], "--train_steps", "5"))
    out["port_hyps"] = port_run_exp.cli_main(
        ["--config_paths", predict_cfg, "--model_dir", dirs["port", 1],
         "--device", "cpu"])["hypotheses"]
    out["port_uc1_snapshot"] = os.path.join(root, "port_uc1_snapshot")
    shutil.copytree(dirs["port", 1], out["port_uc1_snapshot"])

    # the JAX side, in one subprocess on one CPU device
    cache = os.path.join(root, "xla_cache")
    logs = {k: os.path.join(root, f"jax_{k}.log")
            for k in (1, 2, "sidecar", "fresh", "on_port", "predict")}
    for tag in ("sidecar", "fresh", "on_port"):
        dirs["jax", tag] = os.path.join(root, f"jax_{tag}")
    ops = [["train", argv(1, dirs["jax", 1], "--compilation_cache_dir",
                          cache), logs[1]],
           ["copytree", dirs["jax", 1], dirs["jax", "sidecar"]],
           ["copytree", dirs["jax", 1], dirs["jax", "fresh"]],
           ["remove", os.path.join(dirs["jax", "fresh"], "ckpt-4.optstate")],
           ["copytree", dirs["port", 1], dirs["jax", "on_port"]]]
    for tag in ("sidecar", "fresh", "on_port"):
        ops.append(["train", argv(1, dirs["jax", tag], "--train_steps", "5",
                                  "--compilation_cache_dir", cache),
                    logs[tag]])
    ops.append(["train", argv(2, dirs["jax", 2], "--compilation_cache_dir",
                              cache), logs[2]])
    hyps_path = os.path.join(root, "jax_hyps.json")
    ops.append(["predict", ["--config_paths", predict_cfg, "--model_dir",
                            out["port_uc1_snapshot"]], logs["predict"],
                hyps_path])
    ops_path = os.path.join(root, "ops.json")
    with open(ops_path, "w") as f:
        json.dump(ops, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    proc = subprocess.run([sys.executable, "-c", JAX_DRIVER, ops_path],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out["jax_msgs"] = {k: open(v).read().splitlines()
                       for k, v in logs.items()}
    with open(hyps_path) as f:
        out["jax_hyps"] = json.load(f)
    out["dirs"], out["root"], out["cfgs"] = dirs, root, cfgs
    out["records"], out["vocab"] = records, vocab
    return out


def _key_bias(name, value):
    """The key part of an attention projection's bias (else None): a
    key bias adds one constant per query to its logits, which the softmax
    drops, so its gradient is 0 up to rounding noise, and Adam moves it
    by up to lr a step in the direction of that noise."""
    if name.endswith("/qkv_transform/bias"):
        return value[1]
    if name.endswith("/kv_transform/bias"):
        return value[0]
    return None


@pytest.mark.parametrize("uc", [1, 2])
@pytest.mark.parametrize("step", [2, 4])
def test_checkpoints_match_jax(runs, uc, step):
    """Every parameter within 2 lr + 1e-6 of JAX's (lr of step 1, the
    largest); the key biases, whose updates follow rounding noise, within
    2 x the summed lr of the steps + 1e-6."""
    port = port_ckpt.restore_checkpoint_params(
        os.path.join(runs["dirs"]["port", uc], f"ckpt-{step}.npz"))
    ref = jax_ckpt.restore_checkpoint_params(
        os.path.join(runs["dirs"]["jax", uc], f"ckpt-{step}.npz"))
    seed = jax_ckpt.restore_checkpoint_params(
        os.path.join(runs["dirs"]["jax", uc], "ckpt-0.npz"))
    assert sorted(port) == sorted(ref)
    tol = 2 * noam(1) + 1e-6
    noise_tol = 2 * sum(noam(s) for s in range(1, step + 1)) + 1e-6
    moved = 0
    for name in ref:
        assert port[name].dtype == np.float32
        diff = np.abs(port[name] - ref[name])
        key = _key_bias(name, diff)
        if key is not None:
            assert float(key.max()) <= noise_tol, (name, key.max())
            diff = np.delete(diff, 1 if "qkv" in name else 0, axis=0)
        assert float(diff.max()) <= tol, (name, float(diff.max()), tol)
        moved += int(np.any(ref[name] != seed[name]))
    assert moved == len(ref)


@pytest.mark.parametrize("uc", [1, 2])
def test_losses_and_checkpoint_index_match_jax(runs, uc):
    def losses(messages):
        return [float(m) for m in re.findall(
            r"step \d+ \| loss (\S+) \|", "\n".join(messages))]
    port = losses(runs["port_msgs"][uc])
    ref = losses(runs["jax_msgs"][uc])
    assert len(port) == len(ref) == 4
    np.testing.assert_allclose(port, ref, rtol=1e-4)
    with open(os.path.join(runs["dirs"]["port", uc], "checkpoint.json")) as f:
        port_meta = json.load(f)
    with open(os.path.join(runs["dirs"]["jax", uc], "checkpoint.json")) as f:
        assert port_meta == json.load(f) == {"latest": 4, "all": [0, 2, 4]}
    names = sorted(os.listdir(runs["dirs"]["port", uc]))
    assert names == ["checkpoint.json", "ckpt-0.npz", "ckpt-2.npz",
                     "ckpt-2.torch_optstate.npz", "ckpt-4.npz",
                     "ckpt-4.torch_optstate.npz", "model_configs.yml"]


def test_each_package_loads_the_others_model_configs(runs):
    port_dir, jax_dir = runs["dirs"]["port", 1], runs["dirs"]["jax", 1]
    assert PortModelConfigs.load(port_dir) == JaxModelConfigs.load(jax_dir)
    cfg = JaxModelConfigs.load(port_dir)
    task = jax_build_task(cfg)
    model = task.build_model(cfg)
    assert model.args["encoder.num_layers"] == 2
    cfg = PortModelConfigs.load(jax_dir)
    task = port_build_task(cfg)
    model = task.build_model(cfg, device="cpu")
    assert model.args["dtype"] == "float32"


def test_jax_restores_and_predicts_and_resumes_from_a_port_dir(runs):
    cfg = JaxModelConfigs.load(runs["port_uc1_snapshot"])
    model = jax_build_task(cfg).build_model(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    flat = jax_ckpt.restore_checkpoint_params(
        os.path.join(runs["port_uc1_snapshot"], "ckpt-4.npz"))
    _, restored, missing = jax_ckpt.restore_into(params, flat)
    assert missing == [] and len(restored) == len(flat)
    assert runs["jax_hyps"] == runs["port_hyps"]
    assert len(runs["port_hyps"]) == 13
    on_port = "\n".join(runs["jax_msgs"]["on_port"])
    assert "Restored checkpoint at step 4" in on_port
    assert "Training finished at step 5" in on_port


def test_r6_resumed_learning_rates(runs):
    """After a resume at k = 4: with the optimizer sidecar JAX reads its
    schedule at 2k + 1, the port at k + 1; without one both at k + 1."""
    k = 4
    jax_sidecar = _first_lr(runs["jax_msgs"]["sidecar"], k + 1)
    port_sidecar = _first_lr(runs["port_msgs"]["sidecar"], k + 1)
    np.testing.assert_allclose(jax_sidecar, noam(2 * k + 1), rtol=2e-3)
    np.testing.assert_allclose(port_sidecar, noam(k + 1), rtol=2e-3)
    for side in ("jax", "port"):
        lr = _first_lr(runs[f"{side}_msgs"]["fresh"], k + 1)
        np.testing.assert_allclose(lr, noam(k + 1), rtol=2e-3)


def test_resume_restores_the_optimizer_state_exactly(runs):
    """The sidecar's Adam moments, counts and step come back bitwise: a
    resumed run with train_steps at the saved step trains nothing and
    returns the saved state."""
    from neurst_tpu_torch.utils.param_bridge import state_dict_to_flat
    d = os.path.join(runs["root"], "port_again")
    shutil.copytree(runs["port_uc1_snapshot"], d)
    state, _ = _port_train(["--config_paths", runs["cfgs"][1], "--model_dir",
                            d])
    assert state.step == 4
    adam = state.opt_state[1][0]
    assert adam["count"] == 4
    saved = np.load(os.path.join(runs["port_uc1_snapshot"],
                                 "ckpt-4.torch_optstate.npz"))
    for name, mu in adam["mu"].items():
        np.testing.assert_array_equal(
            mu.numpy(), saved[f"opt_state/1/0/mu/{name}"])
    flat = port_ckpt.restore_checkpoint_params(
        os.path.join(runs["port_uc1_snapshot"], "ckpt-4.npz"))
    cfg = PortModelConfigs.load(d)
    model = port_build_task(cfg).build_model(cfg, device="cpu")
    ours = state_dict_to_flat(model, state.params)
    assert sorted(ours) == sorted(flat)
    for name, value in flat.items():
        np.testing.assert_array_equal(ours[name], value)


def test_pretrain_pattern_restores_the_same_names_as_jax(runs):
    pattern = "(input_audio_modality|encoder)"
    flat = jax_ckpt.restore_checkpoint_params(
        os.path.join(runs["dirs"]["jax", 1], "ckpt-4.npz"))
    cfg = JaxModelConfigs.load(runs["dirs"]["jax", 1])
    jmodel = jax_build_task(cfg).build_model(cfg)
    _, jax_restored, _ = jax_ckpt.restore_into(
        jmodel.init_params(jax.random.PRNGKey(0)), flat,
        name_pattern=pattern)
    model = port_build_task(cfg).build_model(cfg, device="cpu")
    import torch
    model.init_params(torch.Generator().manual_seed(0))
    restored, missing = port_ckpt.restore_into(model, flat, pattern)
    assert sorted(restored) == sorted(jax_restored) and missing == []
    assert any(n.startswith("encoder/") for n in restored)
    assert not any(n.startswith("decoder/") for n in restored)
    # through the trainer, every variable frozen: one step keeps the
    # pretrained names as restored and the rest as initialised
    d = os.path.join(runs["root"], "pretrained")
    _port_train(["--config_paths", runs["cfgs"][1], "--model_dir", d,
                 "--pretrain_model",
                 os.path.join(runs["dirs"]["jax", 1], "ckpt-4.npz"),
                 "--pretrain_variable_pattern", pattern, "--train_steps",
                 "1", "--freeze_variables", "."])
    saved = port_ckpt.restore_checkpoint_params(os.path.join(d, "ckpt-1.npz"))
    for name, value in saved.items():
        assert np.array_equal(value, flat[name]) == (name in restored), name


def test_jax_optstate_without_port_sidecar_raises(runs):
    d = os.path.join(runs["root"], "jax_only")
    shutil.copytree(runs["dirs"]["jax", 2], d)
    with pytest.raises(ValueError, match="pretrain_model"):
        _port_train(["--config_paths", runs["cfgs"][1], "--model_dir", d])


@pytest.mark.parametrize("flag", [
    ["--num_model_partitions", "2"], ["--pipeline_parallel", "2"],
    ["--distribution_strategy", "horovod"],
    ["--distribution_strategy", "mirrored"]])
def test_refused_trainer_flags(runs, flag):
    """The parallel flags are the mesh's since slice 14: one process
    cannot hold tp 2 or pp 2 (the JAX package's assertion of
    ``make_mesh``), and a ``distribution_strategy`` is accepted and
    ignored (the process group replaces it)."""
    d = os.path.join(runs["root"], "refused", "_".join(flag))
    argv = ["--config_paths", runs["cfgs"][1], "--model_dir", d, *flag]
    if flag[0] == "--distribution_strategy":
        _port_train(argv + ["--train_steps", "1"])
        assert os.path.exists(os.path.join(d, "ckpt-1.npz"))
    else:
        with pytest.raises(AssertionError, match="not divisible by"):
            _port_train(argv)


def test_cli_subprocess_writes_the_model_dir(runs):
    d = os.path.join(runs["root"], "cli")
    proc = subprocess.run(
        [sys.executable, "-m", "neurst_tpu_torch.cli.run_exp", "--entry",
         "train", "--device", "cpu", "--config_paths", runs["cfgs"][1],
         "--model_dir", d, "--train_steps", "2"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(os.listdir(d)) == [
        "checkpoint.json", "ckpt-2.npz", "ckpt-2.torch_optstate.npz",
        "model_configs.yml"]
    proc = subprocess.run(
        [sys.executable, "-m", "neurst_tpu_torch.cli.run_exp", "--entry",
         "train", "--config_paths", runs["cfgs"][1], "--model_dir",
         os.path.join(runs["root"], "cli_no_device")], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
