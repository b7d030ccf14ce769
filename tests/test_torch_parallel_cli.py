"""The port's parallel stack through its CLI entries, against the JAX
package's CLI.

* ``--entry train`` of the toy recipe (``tests/examples``, shuffling off,
  2 steps from one ckpt-0) over 2 ranks formed by ``--distributed_init
  --worker_hosts/--task_index`` (gloo on the CPU), against the JAX CLI
  run as 2 processes with ``--distributed_init`` (the
  ``tests/parallel/test_multiprocess.py`` pattern, each process one CPU
  device): the logged losses and the rank-0 checkpoint within the step
  tolerances (4 decimals for the log lines; 2 lr a step for the weights);
* ``--entry predict`` of the port's model dir over 2 ranks under
  torchrun's environment, data-parallel and with
  ``--decode_tensor_parallel 2``: hypotheses equal to the port's one-rank
  predict, written by rank 0 alone;
* the port's ``--num_model_partitions 2`` train with magnitude pruning
  and ``--pipeline_parallel 2`` train, each with an inline
  ``seq_generation_validator`` and then a resume to step 4 from the
  gathered checkpoint and optimizer sidecar (each rank cutting its
  shards, or its stage's layers), against the port's one-rank runs of
  the same steps;
* repair 1 at the entry: a model dir the JAX CLI trained with
  ``--pipeline_parallel 2`` (its checkpoint in the ``[S, P, ...]``
  pipeline layout, ``model_configs.yml`` with the pipeline flags)
  predicts through the port with the JAX predict's hypotheses.

The JAX side runs in subprocesses while the port's side runs.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import yaml

jax = pytest.importorskip("jax")

import port_test_support  # noqa: E402,F401  (one torch thread per worker)
from port_test_support import JAX_CLI_SIDE, REPO  # noqa: E402
from torch_parallel_worker import _free_port, wait_all  # noqa: E402

STEPS = 2
PREDICT = ["--entry", "predict", "--config_paths",
           "tests/examples/example_predict_seq2seq.yml"]
# an inline validator at step 4 (in the resumed runs), keeping the best
# checkpoint
VALIDATE = ["--validator.class", "seq_generation_validator",
            "--validator.params", json.dumps({
                "eval_steps": 4, "eval_dataset.class": "parallel_text",
                "eval_dataset.params": {
                    "src_file": "tests/examples/dev.src",
                    "trg_file": "tests/examples/dev.trg"},
                "eval_batch_size": 8,
                "eval_search_method.class": "beam_search",
                "eval_search_method.params": {"beam_size": 2,
                                              "maximum_decode_length": 20},
                "eval_metric.class": "bleu",
                "eval_keep_best_checkpoints": 1,
                "eval_auto_average_checkpoints": False})]
# magnitude pruning at the first three updates of each run
PRUNE = ["--pruning_schedule.class", "constant_sparsity",
         "--pruning_schedule.params", json.dumps({
             "target_sparsity": 0.3, "begin_pruning_step": 1,
             "end_pruning_step": 3, "pruning_frequency": 1}),
         "--nopruning_variable_pattern", "(ln|bias|modality)"]


def _recipe(root):
    with open(os.path.join(REPO, "tests", "examples",
                           "example_train_seq2seq.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["task.params"]["shuffle_buffer"] = 0
    cfg["entry.params"].update(train_steps=STEPS, summary_steps=1,
                               save_checkpoint_steps=STEPS,
                               enable_tensorboard=False)
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path, cfg


def _ckpt0(model_dirs, cfg):
    """One set of initial weights (the port's init) as ckpt-0 of each
    dir."""
    import torch

    from neurst_tpu_torch.tasks.task import build_task
    from neurst_tpu_torch.utils import checkpoints as ckpt_lib
    from neurst_tpu_torch.utils.param_bridge import state_dict_to_flat
    task = build_task(cfg)
    model = task.build_model(cfg, device="cpu")
    model.init_params(torch.Generator().manual_seed(3))
    flat = state_dict_to_flat(model)
    for d in model_dirs:
        ckpt_lib.save_checkpoint(d, 0, flat)


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    env.pop("PYTHONPATH", None)
    return env


def _start(argv, log, env):
    with open(log, "w") as out:
        return subprocess.Popen(argv, cwd=REPO, env=env, stdout=out,
                                stderr=subprocess.STDOUT)


def _wait(procs, timeout=180):
    """Every process of a group; the first to fail (or the limit) fails
    the group at once."""
    wait_all([p for p, _ in procs], [log for _, log in procs], timeout)


def _jax_side(root, name, ops, devices):
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(ops, f)
    env = _env(JAX_PLATFORMS="cpu", XLA_FLAGS=(
        f"--xla_force_host_platform_device_count={devices}"))
    log = os.path.join(root, f"{name}.log")
    return _start([sys.executable, "-c", JAX_CLI_SIDE, path], log, env), log


def _port_ranks(root, name, argv, torchrun):
    """Two port ranks of ``run_exp`` (torchrun's environment, or
    ``--distributed_init --worker_hosts --task_index``)."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = _env()
        rank_argv = list(argv) + ["--device", "cpu"]
        if torchrun:
            env.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                       LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
        else:
            rank_argv += ["--distributed_init", "--worker_hosts",
                          f"127.0.0.1:{port},127.0.0.1:{port + 1}",
                          "--task_index", str(rank)]
        log = os.path.join(root, f"{name}.rank{rank}.log")
        procs.append((_start([sys.executable, "-m",
                              "neurst_tpu_torch.cli.run_exp"] + rank_argv,
                             log, env), log))
    return procs


def _losses(log):
    out = []
    with open(log) as f:
        for line in f:
            if "| loss " in line and "step " in line:
                out.append(float(line.split("| loss ")[1].split()[0]))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parallel_cli"))
    recipe, cfg = _recipe(root)
    dirs = {k: os.path.join(root, k) for k in ("jax", "port", "jax_pipe")}
    _ckpt0([dirs["jax"], dirs["port"]], cfg)
    # the JAX side: 2 processes of data parallelism; one process of 2
    # devices training and predicting with the pipeline
    port = _free_port()
    hosts = f"localhost:{port},localhost:{port + 1}"
    jax_procs = [_jax_side(root, f"jax_dp{i}", [[
        "train", ["--entry", "train", "--config_paths", recipe,
                  "--model_dir", dirs["jax"], "--distributed_init",
                  "--worker_hosts", hosts, "--task_index", str(i)],
        os.path.join(root, f"jax_dp{i}.losses")]], 1) for i in range(2)]
    pipe_hyps = os.path.join(root, "jax_pipe.hyp")
    jax_pipe = _jax_side(root, "jax_pipe", [
        ["train", ["--entry", "train", "--config_paths", recipe,
                   "--model_dir", dirs["jax_pipe"], "--pipeline_parallel",
                   "2", "--encoder.pipeline_stages", "2",
                   "--decoder.pipeline_stages", "2"],
         os.path.join(root, "jax_pipe.losses")],
        ["predict", PREDICT + ["--model_dir", dirs["jax_pipe"],
                               "--output_file", pipe_hyps],
         os.path.join(root, "jax_pipe.result")]], 2)
    # the port: 2 ranks train, then predict over 2 ranks two ways
    _wait(_port_ranks(root, "train", ["--entry", "train", "--config_paths",
                                      recipe, "--model_dir", dirs["port"]],
                      torchrun=False))
    out = {"dirs": dirs, "root": root, "jax_pipe_hyps": pipe_hyps,
           "port_losses": _losses(os.path.join(root, "train.rank0.log"))}
    for name, extra in (("dp", []),
                        ("tp", ["--decode_tensor_parallel", "2"])):
        hyp = os.path.join(root, f"{name}.hyp")
        _wait(_port_ranks(root, f"predict_{name}", PREDICT + [
            "--model_dir", dirs["port"], "--output_file", hyp] + extra,
            torchrun=True))
        out[f"{name}_hyps"] = hyp
    from neurst_tpu_torch.cli import run_exp
    single = os.path.join(root, "single.hyp")
    run_exp.cli_main(PREDICT + ["--model_dir", dirs["port"],
                                "--output_file", single, "--device", "cpu"])
    out["single_hyps"] = single
    # tensor parallelism with pruning, and the pipeline, each with a
    # validator and a resume, against one rank's run of the same steps
    pipe = ["--pipeline_parallel", "2", "--model.params",
            "{encoder.pipeline_stages: 2, decoder.pipeline_stages: 2}"]
    for name, extra in (("tp", ["--num_model_partitions", "2"] + PRUNE),
                        ("pp", pipe)):
        for ranks in (2, 1):
            model_dir = os.path.join(root, f"{name}{ranks}")
            _ckpt0([model_dir], cfg)
            for more in ([], ["--train_steps", "4"]):
                argv = ["--entry", "train", "--config_paths", recipe,
                        "--model_dir", model_dir] + extra + VALIDATE + more
                if ranks == 2:
                    _wait(_port_ranks(root, f"{name}{len(more)}", argv,
                                      torchrun=True))
                else:  # the same model on one rank (stages in turn)
                    run_exp.cli_main(argv[:6] + argv[8:]
                                     + ["--device", "cpu"])
            out[f"{name}{ranks}"] = model_dir
    _wait(jax_procs + [jax_pipe], timeout=300)
    with open(os.path.join(root, "jax_dp0.losses")) as f:
        out["jax_losses"] = json.load(f)
    port_pipe = os.path.join(root, "port_pipe.hyp")
    run_exp.cli_main(PREDICT + ["--model_dir", dirs["jax_pipe"],
                                "--output_file", port_pipe,
                                "--device", "cpu"])
    out["port_pipe_hyps"] = port_pipe
    return out


def _read(path):
    with open(path) as f:
        return f.read().splitlines()


def test_two_rank_train_matches_the_jax_cli(runs):
    """Both CLIs log the same 2 losses (the log rounds to 4 decimals) and
    write ckpt-2 with the same weights within 2 lr a step."""
    import neurst_tpu_torch
    from neurst_tpu_torch.utils import checkpoints as ckpt_lib
    assert len(runs["port_losses"]) == STEPS
    np.testing.assert_allclose(runs["port_losses"], runs["jax_losses"],
                               rtol=0, atol=1e-4)
    got = ckpt_lib.restore_checkpoint_params(
        os.path.join(runs["dirs"]["port"], f"ckpt-{STEPS}.npz"))
    ref = ckpt_lib.restore_checkpoint_params(
        os.path.join(runs["dirs"]["jax"], f"ckpt-{STEPS}.npz"))
    assert sorted(got) == sorted(ref)
    lr = neurst_tpu_torch.build_lr_schedule(
        {"lr_schedule.class": "noam",
         "lr_schedule.params": {"dmodel": 32, "warmup_steps": 100}})
    atol = 2 * sum(float(lr(s)) for s in range(STEPS))
    for name, want in ref.items():
        assert float(np.abs(got[name] - want).max()) <= atol, name


def test_only_rank_zero_writes(runs):
    """One checkpoint series and one output file: rank 0's."""
    files = os.listdir(runs["dirs"]["port"])
    assert f"ckpt-{STEPS}.npz" in files
    for rank in (0, 1):
        log = os.path.join(runs["root"], f"train.rank{rank}.log")
        assert "backend gloo" in open(log).read()


@pytest.mark.parametrize("mode", ["dp", "tp"])
def test_parallel_predict_equals_one_rank(runs, mode):
    got = _read(runs[f"{mode}_hyps"])
    assert got == _read(runs["single_hyps"])
    assert len(got) == len(_read(os.path.join(REPO, "tests", "examples",
                                              "dev.src")))


@pytest.mark.parametrize("name,step", [("tp", STEPS), ("tp", 4),
                                       ("pp", STEPS), ("pp", 4)])
def test_tensor_and_pipeline_train_equal_one_rank(runs, name, step):
    """The 2-rank run's checkpoint (gathered whole by rank 0) equals one
    rank's within 2 lr a step (the attention key biases' gradients are
    rounding noise, so Adam moves them by up to lr either way); the run
    resumed from it (its shards or its stage's layers, and their Adam
    moments and pruning masks, cut from the sidecar) still does at step
    4, and its sidecar's moments and masks equal one rank's within 1e-3
    of their largest value (the q/k/v biases' aside: the key part is
    noise)."""
    import neurst_tpu_torch
    from neurst_tpu_torch.utils import checkpoints as ckpt_lib
    got = ckpt_lib.restore_checkpoint_params(
        os.path.join(runs[f"{name}2"], f"ckpt-{step}.npz"))
    ref = ckpt_lib.restore_checkpoint_params(
        os.path.join(runs[f"{name}1"], f"ckpt-{step}.npz"))
    assert sorted(got) == sorted(ref)
    lr = neurst_tpu_torch.build_lr_schedule(
        {"lr_schedule.class": "noam",
         "lr_schedule.params": {"dmodel": 32, "warmup_steps": 100}})
    atol = 2 * sum(float(lr(s)) for s in range(step))
    for key, want in ref.items():
        assert float(np.abs(got[key] - want).max()) <= atol, key
    if name == "tp":  # every pruned variable is 30 % zeros
        pruned = [k for k in got if not re.search(PRUNE[-1], k)]
        assert pruned
        for key in pruned:
            assert float(np.mean(got[key] == 0.0)) >= 0.29, key
    if step != 4:
        return
    side, ref_side = (ckpt_lib.sidecar_path(os.path.join(
        runs[f"{name}{r}"], "ckpt-4.npz")) for r in (2, 1))
    with np.load(side) as a, np.load(ref_side) as b:
        assert sorted(a.files) == sorted(b.files)
        assert int(a["step"]) == int(b["step"]) == 4
        for key in b.files:
            assert a[key].shape == b[key].shape, key
            if "transform.bias" in key:
                continue
            scale = max(float(np.abs(b[key]).max()), 1e-30)
            assert float(np.abs(a[key] - b[key]).max()) <= 1e-3 * scale, key


@pytest.mark.parametrize("name", ["tp", "pp"])
def test_validator_over_ranks_equals_one_rank(runs, name):
    """The inline validator of the tensor-parallel and the pipelined run
    scores its evaluation at step 4 as one rank's does, and rank 0 keeps
    the whole weights of that step."""
    from neurst_tpu_torch.utils import checkpoints as ckpt_lib
    records = []
    for ranks in (2, 1):
        best = os.path.join(runs[f"{name}{ranks}"], "best")
        with open(os.path.join(best, "metrics.json")) as f:
            records.append(json.load(f))
    assert sorted(records[0]) == sorted(records[1]) == ["4"]
    for step, value in records[1].items():
        assert abs(records[0][step] - value) <= 1e-6, step
    best = os.path.join(runs[f"{name}2"], "best")
    step = max(records[0], key=lambda k: (records[0][k], -int(k)))
    got = ckpt_lib.restore_checkpoint_params(
        ckpt_lib.latest_checkpoint(best))
    want = ckpt_lib.restore_checkpoint_params(
        os.path.join(runs[f"{name}2"], f"ckpt-{step}.npz"))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_jax_pipeline_model_dir_predicts_through_the_port(runs):
    """The JAX pipeline-trained dir (its [S, P, ...] checkpoint and the
    pipeline flags in model_configs.yml): the port's hypotheses are the
    JAX predict's."""
    flat = np.load(os.path.join(runs["dirs"]["jax_pipe"],
                                f"ckpt-{STEPS}.npz"))
    assert any("/layers/pipeline/stages/layers/layer/" in k
               for k in flat.files)
    assert _read(runs["port_pipe_hyps"]) == _read(runs["jax_pipe_hyps"])


def teardown_module(module):
    shutil.rmtree(os.path.join(REPO, "build", "parallel_cli"),
                  ignore_errors=True)
