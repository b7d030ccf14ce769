"""The port's simultaneous translation (the wait-k agent and
``simuleval_cli``) against the JAX package's.

Both packages' ``run_exp`` train a ``waitk_transformer`` (d 32, 1 + 1
layers, monotonic encoder, ``wait_k: [3]``, float32, constant lr 1e-3)
for 10 steps on the ``tests/examples`` corpus without shuffling, from
one ``ckpt-0.npz`` of the JAX initializers; the JAX side (its trainer
and its offline CLI) runs in two subprocesses on one CPU device each,
beside the port's side.  Then:

- the training losses agree (a one-element ``wait_k`` list draws no
  random lagging);
- the offline CLI of each package on each dir (``dev.src`` / ``dev.trg``,
  ``--wait_k 3``, ``--max_decode_len 12``) gives the same hypothesis file,
  AL, CW and BLEU;
- a dir of initial weights (an untied softmax) whose configs say
  ``wait_k: [2, 4]``, decoded with ``--wait_k 4`` (the agent reads 4
  ahead, the decoder masks at the smallest k, 2, in both packages), gives
  the same hypotheses in both;
- online mode on that dir against ``MockSimulEvalServer`` (``tests/
  test_simuleval_protocol.py``) receives the same requests and the same
  PUT units from both packages;
- an empty source and ``max_decode_len`` stop both agents at the same
  place; ``average_lagging`` and the READ/WRITE policy are the JAX
  package's.

Tolerances: losses 1e-5 relative; hypotheses, AL, CW, BLEU and the wire
traffic exact.
"""

import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

jax = pytest.importorskip("jax")

import neurst_tpu_torch  # noqa: E402,F401
from neurst_tpu.cli import simuleval_cli as jax_simuleval  # noqa: E402
from neurst_tpu.tasks.task import build_task as jax_build_task  # noqa: E402
from neurst_tpu.utils import checkpoints as jax_ckpt  # noqa: E402
from neurst_tpu.utils.configurable import \
    ModelConfigs as JaxModelConfigs  # noqa: E402
from neurst_tpu.utils.simuleval_agents import \
    simul_trans_text_agent as jax_agent  # noqa: E402
from neurst_tpu_torch.cli import run_exp as port_run_exp  # noqa: E402
from neurst_tpu_torch.cli import simuleval_cli as port_simuleval  # noqa
from neurst_tpu_torch.exps import trainer as port_trainer  # noqa: E402
from neurst_tpu_torch.utils.simuleval_agents import \
    simul_trans_text_agent as port_agent  # noqa: E402
from test_simuleval_protocol import MockSimulEvalServer  # noqa: E402

from port_test_support import start_jax_side  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "tests", "examples")
STEPS = 10
DECODE = ["--wait_k", "3", "--max_decode_len", "12"]

JAX_SIDE = r"""
import json, logging, os, sys, time
import jax
jax.config.update("jax_default_matmul_precision", "float32")
import neurst_tpu.exps.trainer as trainer_mod
from neurst_tpu.cli import simuleval_cli
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
    if kind == "wait":
        while not os.path.exists(argv):
            time.sleep(0.05)
        continue
    if kind == "train":
        cli_main(argv)
        result = LOSSES
    else:
        result = simuleval_cli.main(argv)
    with open(out, "w") as f:
        json.dump(result, f)
"""


def _config():
    pipeline = {"vocab_path": f"{EXAMPLES}/vocab.txt"}
    params = {"modality.dim": 32, "modality.timing": "sinusoids",
              "modality.share_source_target_embedding": True,
              "modality.share_embedding_and_softmax_weights": True,
              "encoder.attention_monotonic": True}
    for side in ("encoder", "decoder"):
        params.update({f"{side}.num_layers": 1, f"{side}.hidden_size": 32,
                       f"{side}.num_attention_heads": 4,
                       f"{side}.filter_size": 64})
    return {
        "task.class": "waitk_translation",
        "task.params": {
            "wait_k": [3], "batch_size": 64, "batch_by_tokens": True,
            "max_src_len": 16, "max_trg_len": 16, "shuffle_buffer": 0,
            "src_data_pipeline.class": "TextDataPipeline",
            "src_data_pipeline.params": pipeline,
            "trg_data_pipeline.class": "TextDataPipeline",
            "trg_data_pipeline.params": pipeline},
        "dataset.class": "parallel_text",
        "dataset.params": {"src_file": f"{EXAMPLES}/train.src",
                           "trg_file": f"{EXAMPLES}/train.trg"},
        "model.class": "waitk_transformer", "model.params": params,
        "dtype": "float32",
        "entry.class": "trainer",
        "entry.params": {
            "criterion.class": "label_smoothed_cross_entropy",
            "lr_schedule.class": "constant",
            "lr_schedule.params": {"learning_rate": 1e-3},
            "train_steps": STEPS, "summary_steps": 1,
            "save_checkpoint_steps": STEPS, "enable_tensorboard": False}}


class _Log(object):
    """The trainer's ``logging``, keeping each logged step's exact
    loss."""

    def __init__(self):
        self.losses = []

    def __getattr__(self, name):
        return getattr(logging, name)

    def info(self, msg, *args, **kwargs):
        if msg.startswith("step %d | loss"):
            self.losses.append(args[1])
        logging.info(msg, *args, **kwargs)


def _offline_argv(model_dir, out):
    return ["--model_dir", model_dir, "--src_file", f"{EXAMPLES}/dev.src",
            "--ref_file", f"{EXAMPLES}/dev.trg", "--output_file", out]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("simuleval"))
    cfg = _config()
    cfg_path = os.path.join(root, "train.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    dirs = {side: os.path.join(root, side)
            for side in ("jax", "port", "pinned")}
    decodes = {name: _offline_argv(dirs[d], os.path.join(
        root, f"hyp.{name}.{{side}}")) + extra
        for name, d, extra in (("jax_dir", "jax", DECODE),
                               ("port_dir", "port", DECODE),
                               ("pinned", "pinned", ["--wait_k", "4",
                                                     "--max_decode_len",
                                                     "12"]))}
    ops = {name: ["simuleval", [a.replace("{side}", "jax") for a in argv],
                  os.path.join(root, f"jax_{name}.json")]
           for name, argv in decodes.items()}
    # two JAX processes start first and wait while they import: one
    # trains and decodes the JAX dir once ckpt-0 is written, the other
    # decodes the port's two dirs once they are written
    seeded = os.path.join(root, "seeded")
    ready = os.path.join(root, "port_dirs_written")
    procs = [start_jax_side(JAX_SIDE, root, "jax_train", [
        ["wait", seeded, None],
        ["train", ["--config_paths", cfg_path, "--model_dir", dirs["jax"]],
         os.path.join(root, "jax_train.json")], ops["jax_dir"]])]
    procs.append(start_jax_side(JAX_SIDE, root, "jax_decode", [
        ["wait", ready, None], ops["port_dir"], ops["pinned"]]))
    out = {"root": root, "dirs": dirs, "port": {}, "jax": {}}
    try:
        jtask = jax_build_task(cfg)
        jmodel = jtask.build_model({"model.class": cfg["model.class"],
                                    "model.params": dict(cfg["model.params"],
                                                         dtype="float32")})
        seed_dir = os.path.join(root, "seed")
        jax_ckpt.save_checkpoint(seed_dir, 0, jax.tree_util.tree_map(
            np.asarray, jmodel.init_params(jax.random.PRNGKey(3))))
        for side in ("jax", "port"):
            shutil.copytree(seed_dir, dirs[side])
        open(seeded, "w").close()
        log = _Log()
        trainer_logging, port_trainer.logging = port_trainer.logging, log
        try:
            port_run_exp.cli_main(["--config_paths", cfg_path,
                                   "--model_dir", dirs["port"], "--device",
                                   "cpu"])
        finally:
            port_trainer.logging = trainer_logging
        out["port"]["train"] = log.losses
        # the pinned case: configs that list two laggings, so the decoder
        # masks at 2 while the agent reads 4 ahead, with an untied softmax
        # and the JAX initializers' weights (a tied softmax at its initial
        # weights, or after 10 steps, mostly repeats its input token)
        configs = JaxModelConfigs.load(dirs["port"])
        configs["model.params"].update(
            {"wait_k": [2, 4],
             "modality.share_embedding_and_softmax_weights": False})
        configs["task.params"]["wait_k"] = [2, 4]
        jax_ckpt.save_checkpoint(dirs["pinned"], 0, jax.tree_util.tree_map(
            np.asarray, jax_build_task(configs).build_model(
                configs).init_params(jax.random.PRNGKey(5))))
        JaxModelConfigs.dump(configs, dirs["pinned"])
        open(ready, "w").close()
        for name, argv in decodes.items():
            if name == "jax_dir":
                continue
            out["port"][name] = port_simuleval.main(
                [a.replace("{side}", "port") for a in argv]
                + ["--device", "cpu"])
        for proc, _ in procs:
            proc.wait(timeout=600)
    finally:
        for proc, _ in procs:
            proc.kill()
    for proc, path in procs:
        with open(path) as f:
            assert proc.returncode == 0, f.read()[-4000:]
    out["port"]["jax_dir"] = port_simuleval.main(
        [a.replace("{side}", "port") for a in decodes["jax_dir"]]
        + ["--device", "cpu"])
    with open(os.path.join(root, "jax_train.json")) as f:
        out["jax"]["train"] = json.load(f)
    for name in decodes:
        with open(os.path.join(root, f"jax_{name}.json")) as f:
            out["jax"][name] = json.load(f)
    return out


def test_training_losses_match_jax(runs):
    port, ref = runs["port"]["train"], runs["jax"]["train"]
    assert len(port) == len(ref) == STEPS
    np.testing.assert_allclose(port, ref, rtol=1e-5)


@pytest.mark.parametrize("name", ["port_dir", "jax_dir", "pinned"])
def test_offline_cli_matches_jax(runs, name):
    ours, ref = runs["port"][name], runs["jax"][name]
    assert ours["samples"] == ref["samples"] == 24
    for key in ("AL", "CW", "BLEU"):
        assert ours[key] == ref[key], (key, ours[key], ref[key])
    root = runs["root"]
    with open(os.path.join(root, f"hyp.{name}.port")) as f, \
            open(os.path.join(root, f"hyp.{name}.jax")) as g:
        ours_lines, ref_lines = f.read(), g.read()
    assert ours_lines == ref_lines
    assert len(ours_lines.splitlines()) == 24
    assert len(set(ours_lines.splitlines())) > 1


def test_pinned_agent_reads_ahead_of_the_decoder_mask(runs):
    """In the pinned dir the agent's k is 4 and the model's lagging 2, in
    both packages; writes wait for 4 reads (or the source's end)."""
    agent, task = port_simuleval.build_agent(runs["dirs"]["pinned"], 4,
                                             12, "cpu")
    assert agent._k == 4 and agent._model.wait_k == 2
    cfg = JaxModelConfigs.load(runs["dirs"]["pinned"])
    jmodel = jax_build_task(cfg).build_model(cfg)
    assert jmodel.wait_k == 2
    written, meta = 0, task.trg_pipeline.meta
    with open(f"{EXAMPLES}/dev.src") as f:
        for line in f:
            src = task.src_pipeline.encode(line.strip())
            _, delays = agent.translate(src, meta["eos_id"], meta["bos_id"])
            for i, d in enumerate(delays):
                assert d == min(4 + i, len(src)), (src, delays)
            written += len(delays)
    assert written


def _agents(runs):
    """The port's and the JAX package's agents (k 3) on the pinned
    dir."""
    model_dir = runs["dirs"]["pinned"]
    ours, task = port_simuleval.build_agent(model_dir, 3, 12, "cpu")
    cfg = JaxModelConfigs.load(model_dir)
    jtask = jax_build_task(cfg)
    jmodel = jtask.build_model(cfg)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    flat = jax_ckpt.restore_checkpoint_params(
        jax_ckpt.latest_checkpoint(model_dir))
    params, _, _ = jax_ckpt.restore_into(params, flat)
    theirs = jax_agent.SimulTransTextAgent(jmodel, params, k=3,
                                           max_decode_len=12)
    return (ours, task), (theirs, jtask)


def test_online_mode_sends_what_the_jax_client_sends(runs):
    """Each package's agent against its own mock SimulEval server on
    127.0.0.1: the same GET/PUT sequence and the same units (words whose
    subword units were merged), each instance ended by the protocol's
    EOS."""
    with open(f"{EXAMPLES}/dev.src") as f:
        sources = [line.strip() for line in f][:6]
    (ours, task), (theirs, jtask) = _agents(runs)
    servers = {}
    for name, agent, t, run_online in (
            ("port", ours, task, port_simuleval.run_online),
            ("jax", theirs, jtask, jax_simuleval.run_online)):
        with MockSimulEvalServer(sources) as server:
            scores = run_online(agent, t, "127.0.0.1", server.port)
        assert scores["instances"] == len(sources)
        servers[name] = server
    assert servers["port"].log == servers["jax"].log
    assert servers["port"].hypos == servers["jax"].hypos
    for hyp in servers["port"].hypos:
        assert hyp[-1] == "</s>"
    assert any(len(h) > 1 for h in servers["port"].hypos)


def test_empty_source_and_length_limit_stop_both_agents_alike(runs):
    (ours, task), (theirs, _) = _agents(runs)
    eos, bos = task.trg_pipeline.meta["eos_id"], task.trg_pipeline.meta[
        "bos_id"]
    assert ours.translate([], eos, bos) == theirs.translate([], eos, bos) \
        == ([], [])
    with open(f"{EXAMPLES}/dev.src") as f:
        src = task.src_pipeline.encode(f.readlines()[1].strip())
    full = ours.translate(src, eos, bos)
    assert full == theirs.translate(src, eos, bos)
    assert len(full[0]) == 12   # no EOS before the length limit
    for limit in (1, 5):
        ours._max_decode_len = theirs._max_decode_len = limit
        cut = ours.translate(src, eos, bos)
        assert cut == theirs.translate(src, eos, bos)
        assert cut == (full[0][:limit], full[1][:limit])


@pytest.mark.parametrize("delays, src_len, trg_len", [
    ([], 5, 0), ([3, 4, 5, 5], 5, 4), ([1, 2, 3], 9, 3),
    ([5, 5, 5, 5, 5, 5], 5, 6), ([2, 2, 7, 8], 8, 10)])
def test_average_lagging_matches_jax(delays, src_len, trg_len):
    assert port_agent.average_lagging(delays, src_len, trg_len) == \
        jax_agent.average_lagging(delays, src_len, trg_len)


def test_policy_matches_jax():
    class Model(object):
        wait_k = 3
        device = torch.device("cpu")
    ours = port_agent.SimulTransTextAgent(Model(), k=2)
    theirs = jax_agent.SimulTransTextAgent.__new__(
        jax_agent.SimulTransTextAgent)
    theirs._k = 2
    for n_read in range(5):
        for n_written in range(5):
            for exhausted in (False, True):
                for finished in (False, True):
                    args = (n_read, n_written, exhausted, finished)
                    assert ours.policy(*args) == theirs.policy(*args)
    assert port_agent.SimulTransTextAgent(Model())._k == 3
