"""The port's text translation path against the JAX package's, end to end
through both ``run_exp`` CLIs on the CPU.

The ``tests/examples`` corpus and its configs: ``example_train_seq2seq.yml``
(``translation`` task, token-bucketed batches, a 2+2-layer d 32
``transformer``, float32, label smoothing 0.1, Adam + noam) cut to 2
steps with no shuffling, from one ``ckpt-0.npz`` of the JAX initializers,
with ``update_cycle`` 1 and 2; ``example_predict_seq2seq.yml`` (beam 2,
max 24, BLEU) over a model dir the port trained 100 steps; a
``MultipleDataset`` of ``dev`` and ``echo`` (whose references are half
the port's own hypotheses, so that BLEU is not 0) through ``predict`` and
``eval``; ``sequence_evaluator``; and the ``validation`` sidecar
(``criterion_validator`` over checkpoints that appear while it polls,
``seq_generation_validator`` over the trained dir).  The JAX side runs
in one subprocess on one CPU device with a compilation cache, as in
``tests/test_torch_trainer.py``.

Tolerances: losses within 1e-5 relative; every parameter after two steps
within 2 lr + 1e-6 (the attention key biases, whose gradient is 0 up to
rounding, within 2 x the summed lr + 1e-6); hypotheses identical up to
the first EOS (the decoded strings stop there) and output files
identical; BLEU, NLL and PPL within 1e-6; weighted mixtures within 1e-5.
"""

import json
import logging
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import yaml

jax = pytest.importorskip("jax")

import port_test_support  # noqa: E402,F401

import neurst_tpu_torch  # noqa: E402,F401
from neurst_tpu.cli import run_exp as jax_run_exp  # noqa: E402
from neurst_tpu.tasks.task import build_task as jax_build_task  # noqa: E402
from neurst_tpu.utils import checkpoints as jax_ckpt  # noqa: E402
from neurst_tpu_torch.cli import run_exp as port_run_exp  # noqa: E402
from neurst_tpu_torch.exps import trainer as port_trainer  # noqa: E402
from neurst_tpu_torch.exps.base_experiment import build_exp  # noqa: E402
from neurst_tpu_torch.tasks.task import build_task  # noqa: E402
from neurst_tpu_torch.training.validator import \
    TrainingStatusRecorder  # noqa: E402
from neurst_tpu_torch.utils import checkpoints as port_ckpt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "tests", "examples")
DMODEL, WARMUP = 32, 100
TRAIN_STEPS, PREDICT_STEPS = 2, 100

# runs the JAX side's CLI calls in one process: a train run's result is
# the exact losses it logged, another run's the entry's result, as JSON
JAX_SIDE = r"""
import json, logging, sys
import jax
jax.config.update("jax_default_matmul_precision", "float32")
import neurst_tpu.exps.trainer as trainer_mod
from neurst_tpu.cli.run_exp import cli_main
logging.basicConfig(level=logging.INFO)
LOSSES = []


class Log(object):
    def __getattr__(self, name):
        return getattr(logging, name)

    def info(self, msg, *args, **kwargs):
        if msg.startswith("step %d | loss"):
            LOSSES.append(args[1])
        logging.info(msg, *args, **kwargs)


trainer_mod.logging = Log()
for kind, argv, out in json.load(open(sys.argv[1])):
    del LOSSES[:]
    result = cli_main(argv)
    with open(out, "w") as f:
        json.dump(LOSSES if kind == "train" else result, f,
                  default=lambda o: o.tolist())
"""


def noam(step):
    return DMODEL ** -0.5 * min(step ** -0.5, step * WARMUP ** -1.5)


def _absolute(cfg):
    """The config with its ``tests/examples/...`` paths made absolute."""
    text = json.dumps(cfg).replace('"tests/examples/', f'"{EXAMPLES}/')
    return json.loads(text)


def _write(root, name, cfg):
    path = os.path.join(root, name)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


class _Log(object):
    """The trainer's ``logging``, keeping the exact loss of each log line
    (the line itself rounds it to 4 decimals)."""

    def __init__(self):
        self.losses = []

    def __getattr__(self, name):
        return getattr(logging, name)

    def info(self, msg, *args, **kwargs):
        if msg.startswith("step %d | loss"):
            self.losses.append(args[1])
        logging.info(msg, *args, **kwargs)


def _port(argv):
    """The port's CLI on the CPU: (result, the exact logged losses)."""
    log = _Log()
    trainer_logging, port_trainer.logging = port_trainer.logging, log
    try:
        result = port_run_exp.cli_main(argv + ["--device", "cpu"])
    finally:
        port_trainer.logging = trainer_logging
    return result, log.losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("translation"))
    with open(os.path.join(EXAMPLES, "example_train_seq2seq.yml")) as f:
        train = _absolute(yaml.safe_load(f))
    train["task.params"]["shuffle_buffer"] = 0
    train["entry.class"] = "trainer"
    train["entry.params"].update(
        train_steps=TRAIN_STEPS, save_checkpoint_steps=TRAIN_STEPS,
        summary_steps=1, enable_tensorboard=False)
    cfgs = {uc: _write(root, f"train{uc}.yml", dict(
        train, **{"entry.params": dict(train["entry.params"],
                                       update_cycle=uc)}))
        for uc in (1, 2)}
    with open(os.path.join(EXAMPLES, "example_predict_seq2seq.yml")) as f:
        cfgs["predict"] = _write(root, "predict.yml",
                                 _absolute(yaml.safe_load(f)))

    # the JAX initializers' weights as ckpt-0 of every run's dir
    jtask = jax_build_task(train)
    jmodel = jtask.build_model({"model.class": train["model.class"],
                                "model.params": dict(train["model.params"],
                                                     dtype="float32")})
    seed_dir = os.path.join(root, "seed")
    jax_ckpt.save_checkpoint(seed_dir, 0, jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(1))))
    dirs = {}
    for side in ("jax", "port"):
        for uc in (1, 2):
            dirs[side, uc] = os.path.join(root, f"{side}_uc{uc}")
            shutil.copytree(seed_dir, dirs[side, uc])

    out = {"port": {}, "root": root, "dirs": dirs, "cfgs": cfgs}
    for uc in (1, 2):
        _, out["port"]["train", uc] = _port(
            ["--config_paths", cfgs[uc], "--model_dir", dirs["port", uc]])

    # the dir both packages predict from: 100 port steps from the seed
    dirs["trained"] = os.path.join(root, "trained")
    shutil.copytree(seed_dir, dirs["trained"])
    _port(["--config_paths", cfgs[1], "--model_dir", dirs["trained"],
           "--train_steps", str(PREDICT_STEPS), "--save_checkpoint_steps",
           str(PREDICT_STEPS), "--summary_steps", "50"])
    predict = ["--config_paths", cfgs["predict"], "--model_dir",
               dirs["trained"]]
    out["port"]["predict"], _ = _port(
        predict + ["--output_file", os.path.join(root, "hyp.port")])
    # references that share n-grams with the hypotheses
    with open(os.path.join(EXAMPLES, "dev.trg")) as f:
        refs = [line.strip() for line in f]
    echo = [h if i % 2 else refs[i]
            for i, h in enumerate(out["port"]["predict"]["hypotheses"])]
    echo_trg = os.path.join(root, "echo.trg")
    with open(echo_trg, "w") as f:
        f.write("\n".join(echo) + "\n")
    sets = {"multiple_datasets": {
        "dev": {"dataset.class": "parallel_text", "dataset.params": {
            "src_file": f"{EXAMPLES}/dev.src",
            "trg_file": f"{EXAMPLES}/dev.trg"}},
        "echo": {"dataset.class": "ParallelTextDataset", "dataset.params": {
            "src_file": f"{EXAMPLES}/dev.src", "trg_file": echo_trg}}},
        "sample_weights": {"dev": 1.0, "echo": 3.0}}
    dev = ["--dataset.class", "parallel_text", "--dataset.params",
           json.dumps({"src_file": f"{EXAMPLES}/dev.src",
                       "trg_file": f"{EXAMPLES}/dev.trg"})]
    multi = ["--dataset.class", "MultipleDataset", "--dataset.params",
             json.dumps(sets)]
    trained = ["--model_dir", dirs["trained"]]
    evals = {
        "multi_predict": predict + multi + [
            "--output_file", os.path.join(root, "multi.{side}"),
            "--save_metric", os.path.join(root, "multi.{side}.json")],
        "eval": ["--entry", "eval", *trained, *dev, "--batch_size", "8"],
        "multi_eval": ["--entry", "eval", *trained, *multi,
                       "--batch_size", "8"],
        "sequence_evaluator": [
            "--entry", "sequence_evaluator", *trained, *dev,
            "--batch_size", "8", "--output_file",
            os.path.join(root, "scores.{side}")]}
    for name, argv in evals.items():
        out["port"][name], _ = _port([a.replace("{side}", "port")
                                      for a in argv])

    # the validation sidecar's checkpoints: the trained weights, blown up
    # more and more so that the dev loss gets worse
    flat = port_ckpt.restore_checkpoint_params(
        port_ckpt.latest_checkpoint(dirs["trained"]))
    dirs["validation"] = os.path.join(root, "validation")
    for step, scale in ((10, 1.0), (20, 7.0), (30, 15.0)):
        port_ckpt.save_checkpoint(
            os.path.join(root, "scaled"), step,
            {k: v * np.float32(scale) for k, v in flat.items()})
    for step in (10, 20, 30):
        evals[f"eval_{step}"] = [
            "--entry", "eval", *trained, *dev, "--batch_size", "8",
            "--checkpoint_path",
            os.path.join(root, "scaled", f"ckpt-{step}.npz")]

    # the JAX side, in one subprocess on one CPU device
    cache = os.path.join(root, "xla_cache")
    ops = [["train", ["--config_paths", cfgs[uc], "--model_dir",
                      dirs["jax", uc], "--compilation_cache_dir", cache],
            os.path.join(root, f"jax_train{uc}.json")] for uc in (1, 2)]
    ops.append(["run", predict + ["--output_file",
                                  os.path.join(root, "hyp.jax"),
                                  "--compilation_cache_dir", cache],
                os.path.join(root, "jax_predict.json")])
    for name, argv in evals.items():
        ops.append(["run", [a.replace("{side}", "jax") for a in argv]
                    + ["--compilation_cache_dir", cache],
                    os.path.join(root, f"jax_{name}.json")])
    ops_path = os.path.join(root, "ops.json")
    with open(ops_path, "w") as f:
        json.dump(ops, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    proc = subprocess.run([sys.executable, "-c", JAX_SIDE, ops_path],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out["jax"] = {}
    for uc in (1, 2):
        with open(os.path.join(root, f"jax_train{uc}.json")) as f:
            out["jax"]["train", uc] = json.load(f)
    for name in ["predict", *evals]:
        with open(os.path.join(root, f"jax_{name}.json")) as f:
            out["jax"][name] = json.load(f)
    out["sets"], out["dev"] = sets, dev
    return out


def _key_bias(name, value):
    """The key part of an attention projection's bias, else None."""
    if name.endswith("/qkv_transform/bias"):
        return value[1]
    if name.endswith("/kv_transform/bias"):
        return value[0]
    return None


@pytest.mark.parametrize("uc", [1, 2])
def test_train_checkpoints_match_jax(runs, uc):
    port = port_ckpt.restore_checkpoint_params(os.path.join(
        runs["dirs"]["port", uc], f"ckpt-{TRAIN_STEPS}.npz"))
    ref = jax_ckpt.restore_checkpoint_params(os.path.join(
        runs["dirs"]["jax", uc], f"ckpt-{TRAIN_STEPS}.npz"))
    seed = jax_ckpt.restore_checkpoint_params(os.path.join(
        runs["dirs"]["jax", uc], "ckpt-0.npz"))
    assert sorted(port) == sorted(ref)
    tol = 2 * noam(1) + 1e-6
    noise_tol = 2 * sum(noam(s) for s in range(1, TRAIN_STEPS + 1)) + 1e-6
    moved = 0
    for name in ref:
        diff = np.abs(port[name] - ref[name])
        key = _key_bias(name, diff)
        if key is not None:
            assert float(key.max()) <= noise_tol, (name, key.max())
            diff = np.delete(diff, 1 if "qkv" in name else 0, axis=0)
        assert float(diff.max()) <= tol, (name, float(diff.max()), tol)
        moved += int(np.any(ref[name] != seed[name]))
    assert moved == len(ref)


@pytest.mark.parametrize("uc", [1, 2])
def test_train_losses_match_jax(runs, uc):
    port, ref = runs["port"]["train", uc], runs["jax"]["train", uc]
    assert len(port) == len(ref) == TRAIN_STEPS
    np.testing.assert_allclose(port, ref, rtol=1e-5)
    with open(os.path.join(runs["dirs"]["port", uc], "checkpoint.json")) as f:
        assert json.load(f) == {"latest": TRAIN_STEPS,
                                "all": [0, TRAIN_STEPS]}


def test_predict_matches_jax(runs):
    ours, theirs = runs["port"]["predict"], runs["jax"]["predict"]
    assert ours["samples"] == theirs["samples"] == 24
    assert ours["hypotheses"] == theirs["hypotheses"]
    assert len(set(ours["hypotheses"])) > 1
    root = runs["root"]
    with open(os.path.join(root, "hyp.port")) as a, \
            open(os.path.join(root, "hyp.jax")) as b:
        assert a.read() == b.read()
    for key in ("BLEU", "UncasedBLEU"):
        assert abs(ours[key] - theirs[key]) <= 1e-6
    np.testing.assert_allclose(ours["scores"], theirs["scores"], atol=1e-4)


def test_multi_set_predict_matches_jax(runs):
    ours, theirs = runs["port"]["multi_predict"], runs["jax"]["multi_predict"]
    assert sorted(ours["datasets"]) == sorted(theirs["datasets"]) == [
        "dev", "echo"]
    root = runs["root"]
    for name in ("dev", "echo"):
        p, j = ours["datasets"][name], theirs["datasets"][name]
        assert p["hypotheses"] == j["hypotheses"]
        for key in ("BLEU", "UncasedBLEU"):
            assert abs(p[key] - j[key]) <= 1e-6
        with open(os.path.join(root, f"multi.port.{name}")) as a, \
                open(os.path.join(root, f"multi.jax.{name}")) as b:
            assert a.read() == b.read()
        assert os.path.exists(os.path.join(root, f"multi.port.json.{name}"))
    assert ours["datasets"]["echo"]["BLEU"] > 0.0
    for key in ("BLEU", "UncasedBLEU"):
        assert abs(ours["weighted"][key] - theirs["weighted"][key]) <= 1e-5
    with open(os.path.join(root, "multi.port.json")) as a, \
            open(os.path.join(root, "multi.jax.json")) as b:
        saved, jsaved = json.load(a), json.load(b)
    assert sorted(saved) == sorted(jsaved) == ["datasets", "weighted"]
    assert abs(saved["weighted"]["BLEU"] - jsaved["weighted"]["BLEU"]) <= 1e-5


def test_eval_matches_jax(runs):
    ours, theirs = runs["port"]["eval"], runs["jax"]["eval"]
    assert sorted(ours) == sorted(theirs) == ["NLL", "PPL"]
    for key in theirs:
        assert abs(ours[key] - theirs[key]) <= 1e-6 * max(1.0, theirs[key])
    assert ours["PPL"] > 1.0


def test_multi_set_eval_matches_jax(runs):
    ours, theirs = runs["port"]["multi_eval"], runs["jax"]["multi_eval"]
    assert sorted(ours["datasets"]) == sorted(theirs["datasets"])
    for name, res in theirs["datasets"].items():
        for key, value in res.items():
            assert abs(ours["datasets"][name][key] - value) <= 1e-6 * max(
                1.0, value)
    for key, value in theirs["weighted"].items():
        assert abs(ours["weighted"][key] - value) <= 1e-5 * max(1.0, value)
    # the same dev source with other references: the weights mix them
    nll = {n: r["NLL"] for n, r in ours["datasets"].items()}
    assert abs(ours["weighted"]["NLL"]
               - (0.25 * nll["dev"] + 0.75 * nll["echo"])) <= 1e-9


def test_sequence_evaluator_matches_jax(runs):
    ours = runs["port"]["sequence_evaluator"]
    theirs = runs["jax"]["sequence_evaluator"]
    assert len(ours) == len(theirs) == 24
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for key in b:
            assert abs(a[key] - b[key]) <= 1e-5 * max(1.0, abs(b[key]))
    with open(os.path.join(runs["root"], "scores.port")) as f:
        lines = f.read().splitlines()
    assert [json.loads(line) for line in lines] == ours


def _validation(task, model, model_dir, validator, **extra):
    return build_exp({"entry.class": "validation", "entry.params": dict(
        {"validator.class": validator[0], "validator.params": validator[1],
         "waiting_interval": 1, "maximum_waiting_time": 4}, **extra)},
        task=task, model=model, model_dir=model_dir)


def _task_and_model(runs):
    args = port_run_exp.parse_and_merge(
        ["--model_dir", runs["dirs"]["trained"], "--entry", "predict"])
    task = build_task(args)
    return task, task.build_model({"model.class": args["model.class"],
                                   "model.params": args["model.params"]},
                                  device="cpu")


class _Spy(object):
    """Records ``TrainingStatusRecorder.record``'s (step, value)."""

    def __init__(self, monkeypatch):
        self.seen = []
        real = TrainingStatusRecorder.record

        def record(recorder, step, value, params=None):
            self.seen.append((step, value))
            return real(recorder, step, value, params)
        monkeypatch.setattr(TrainingStatusRecorder, "record", record)


def test_validation_sidecar_polls_records_and_early_stops(runs, tmp_path,
                                                          monkeypatch):
    """Checkpoints appear in the model dir, one while the sidecar polls;
    it validates them in step order with the port's eval step, records
    the JAX ``eval`` entry's NLL of each checkpoint (within 1e-5
    relative: the weights scaled 7 and 15 times give logits in the
    hundreds, and NLLs of ~500 that float32 holds to a few 1e-7), and
    stops early after two evaluations without improvement."""
    task, model = _task_and_model(runs)
    model_dir = str(tmp_path / "model")
    scaled = os.path.join(runs["root"], "scaled")
    os.makedirs(model_dir)
    for step in (10, 20):
        shutil.copy(os.path.join(scaled, f"ckpt-{step}.npz"), model_dir)

    def late_writer():
        time.sleep(2.0)
        shutil.copy(os.path.join(scaled, "ckpt-30.npz"),
                    os.path.join(model_dir, "ckpt-30.npz.tmp"))
        os.replace(os.path.join(model_dir, "ckpt-30.npz.tmp"),
                   os.path.join(model_dir, "ckpt-30.npz"))

    spy = _Spy(monkeypatch)
    dev = json.loads(runs["dev"][3])
    entry = _validation(task, model, model_dir, (
        "criterion_validator",
        {"eval_dataset.class": "parallel_text", "eval_dataset.params": dev,
         "eval_batch_size": 8, "eval_estop_patience": 2}),
        maximum_waiting_time=8)
    writer = threading.Thread(target=late_writer, daemon=True)
    writer.start()
    start = time.time()
    entry.run()
    elapsed = time.time() - start
    writer.join()
    assert [s for s, _ in spy.seen] == [10, 20, 30]
    values = [v for _, v in spy.seen]
    assert values[0] < values[1] < values[2]
    for (step, value) in spy.seen:
        want = runs["jax"][f"eval_{step}"]["NLL"]
        assert abs(value - want) <= 1e-5 * max(1.0, want), step
    assert elapsed < 8 + 6


def test_validation_sidecar_gives_up_when_no_checkpoint(runs, tmp_path):
    task, model = _task_and_model(runs)
    model_dir = str(tmp_path / "empty")
    os.makedirs(model_dir)
    dev = json.loads(runs["dev"][3])
    entry = _validation(task, model, model_dir, (
        "criterion_validator",
        {"eval_dataset.class": "parallel_text", "eval_dataset.params": dev}),
        maximum_waiting_time=2)
    start = time.time()
    entry.run()
    assert time.time() - start < 30


def test_seq_generation_validation_matches_jax_predict(runs, monkeypatch):
    """The recipes' validator through the sidecar, on the trained dir:
    its BLEU is the JAX ``predict`` entry's on the same set and search."""
    task, model = _task_and_model(runs)
    with open(runs["cfgs"]["predict"]) as f:
        predict = yaml.safe_load(f)
    spy = _Spy(monkeypatch)
    entry = _validation(task, model, runs["dirs"]["trained"], (
        "seq_generation_validator",
        {"eval_dataset.class": "parallel_text",
         "eval_dataset.params": json.loads(runs["dev"][3]),
         "eval_batch_size": predict["batch_size"],
         "eval_search_method.class": "beam_search",
         "eval_search_method.params": predict["search_method.params"],
         "eval_metric.class": "bleu", "eval_keep_best_checkpoints": 0,
         "eval_auto_average_checkpoints": False}),
        maximum_waiting_time=1)
    entry.run()
    assert [s for s, _ in spy.seen] == [0, PREDICT_STEPS]
    assert abs(spy.seen[-1][1] - runs["jax"]["predict"]["BLEU"]) <= 1e-6


@pytest.mark.parametrize("configs", [
    ["examples/speech_transformer/must-c/mt_training_args.yml",
     "examples/speech_transformer/must-c/mt_validation_args.yml"],
    ["examples/translation/task_args_bpe.yml",
     "examples/translation/training_args.yml",
     "examples/translation/validation_args.yml"],
    ["examples/speech_transformer/must-c/mt_prediction_args.yml"],
    ["examples/translation/prediction_args.yml"],
    ["examples/quality/mt_synth_base.yml"]])
def test_recipe_configs_resolve_as_in_jax(configs):
    """The recipes' text configs resolve to the same flags in both
    packages, but for the port's ``device`` flag and the trainer's flag
    the port names apart: it declares ``experimental_frozen_variables``
    as a flag of its own (an alias of ``freeze_variables`` in JAX).  The
    pruning patterns are flags of both trainers."""
    argv = ["--config_paths", ",".join(os.path.join(REPO, c)
                                       for c in configs)]
    ours = port_run_exp.parse_and_merge(argv)
    theirs = jax_run_exp.parse_and_merge(argv)
    assert ours.pop("device") is None
    if ours.get("entry.class") == "trainer":
        assert ours["entry.params"].pop(
            "experimental_frozen_variables") is None
    assert ours == theirs


def test_text_entry_without_device_raises_on_a_cuda_less_host(runs):
    proc = subprocess.run(
        [sys.executable, "-m", "neurst_tpu_torch.cli.run_exp",
         "--config_paths", runs["cfgs"]["predict"], "--model_dir",
         runs["dirs"]["trained"]], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
