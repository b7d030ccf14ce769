"""Both packages' ``run_exp`` CLIs on the joint ASR + ST model, on the
CPU.

The same audio triple records (whole-number 16-dim features: the JAX
INFER batcher truncates features to int32, ROADMAP R5), a word
vocabulary a side, ``multi_task_speech_translation`` with
``multi_task_speech_transformer`` at ``speech_transformer_toy`` width
(float32, dropout 0) and ``joint_criterion`` as in
``examples/multi_task_st/example_configs/multitask_st.yml`` (ST 1.0, ASR
0.3, label smoothing 0.1): 4 training steps from the same ``ckpt-0``,
then ``--entry predict`` on the translation head (BLEU) and on the
transcript head (``--task.params "{generation_output: asr}" --metric.class
wer``), each package predicting from both packages' model dirs; and
``--entry eval`` with the joint criterion (``st_`` and ``asr_`` NLL and
PPL within 1e-5 relative).

Tolerances: the first two losses within 1e-5 relative, the last two
within 1e-4 (weights already apart by Adam's sign noise); ``ckpt-4``
within 2 x the summed lr + 1e-6 (Adam's first updates are ~lr sign(g));
hypothesis files identical; BLEU and WER within 1e-6.  The JAX side
runs in one subprocess on one CPU device with a compilation cache, as
in ``tests/test_torch_translation.py``.
"""

import json
import logging
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import yaml

jax = pytest.importorskip("jax")

from neurst_tpu.data.recordio import RecordWriter, build_example  # noqa: E402
from neurst_tpu.models.speech_transformer import \
    SpeechTransformer as JaxSpeechTransformer  # noqa: E402
from neurst_tpu.optimizers.schedules.lr_schedules import \
    NoamSchedule as JaxNoam  # noqa: E402
from neurst_tpu.tasks.task import build_task as jax_build_task  # noqa: E402
from neurst_tpu.utils import checkpoints as jax_ckpt  # noqa: E402
from neurst_tpu_torch.cli import run_exp as port_run_exp  # noqa: E402
from neurst_tpu_torch.exps import trainer as port_trainer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRITERIONS = (
    "[{class: label_smoothed_cross_entropy, params: {label_smoothing: 0.1},"
    " output_key: st, weight: 1.0},"
    " {class: label_smoothed_cross_entropy, params: {label_smoothing: 0.1},"
    " output_key: asr, input_prefix: asr, weight: 0.3}]")
JOINT = {"criterion.class": "joint_criterion",
         "criterion.params": {"criterions": CRITERIONS}}
LR = {"dmodel": 16, "warmup_steps": 10, "initial_factor": 0.1}
RATES = ("attention_dropout_rate", "ffn_dropout_rate",
         "layer_postprocess_dropout_rate")
TOL = 1e-5
# after two Adam steps the weights differ by up to 2 lr where a gradient
# near zero took another sign in the other package, which moves the
# later losses by ~1e-5 relative
LATE_TOL = 1e-4


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


TRANSLATION_WORDS = ["das", "haus", "ist", "rot", "ein", "hund", "lief",
                     "weg", "wir", "sahen", "es", "."]
TRANSCRIPT_WORDS = ["the", "house", "is", "red", "a", "dog", "ran", "away",
                    "we", "saw", "it", "."]
FEATURE_DIM = 16

# runs the JAX side's CLI calls in one process: a train run's result is
# its exact logged losses, a predict run's the entry's result, as JSON
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


class _Log(object):
    """The port trainer's ``logging``, keeping each logged loss exactly."""

    def __init__(self):
        self.losses = []

    def __getattr__(self, name):
        return getattr(logging, name)

    def info(self, msg, *args, **kwargs):
        if msg.startswith("step %d | loss"):
            self.losses.append(args[1])
        logging.info(msg, *args, **kwargs)


def _port(argv):
    log = _Log()
    trainer_logging, port_trainer.logging = port_trainer.logging, log
    try:
        result = port_run_exp.cli_main(argv + ["--device", "cpu"])
    finally:
        port_trainer.logging = trainer_logging
    return result, log.losses


def _write_triples(path, rng, n):
    with RecordWriter(path) as w:
        for _ in range(n):
            frames = int(rng.randint(20, 49))
            audio = np.round(3.0 * rng.randn(frames, FEATURE_DIM))
            w.write(build_example({
                "audio": audio.reshape(-1).astype(np.float32),
                "transcript": " ".join(rng.choice(
                    TRANSCRIPT_WORDS, int(rng.randint(2, 7)))),
                "translation": " ".join(rng.choice(
                    TRANSLATION_WORDS, int(rng.randint(2, 6))))}))


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("multitask"))
    rng = np.random.RandomState(5)
    vocabs = {}
    for side, words in (("en", TRANSCRIPT_WORDS), ("de", TRANSLATION_WORDS)):
        vocabs[side] = os.path.join(root, f"vocab.{side}")
        with open(vocabs[side], "w") as f:
            f.write("\n".join(words) + "\n")
    records = {name: os.path.join(root, f"{name}.tfrecords")
               for name in ("train", "test")}
    _write_triples(records["train"], rng, 12)
    _write_triples(records["test"], rng, 6)
    model_params = {"encoder.enable_flash_attention": False,
                    **{f"{side}.{rate}": 0.0 for side in ("encoder",
                                                          "decoder")
                       for rate in RATES}}
    train = {
        "task.class": "multi_task_speech_translation",
        "task.params": {
            "transcript_data_pipeline.class": "TextDataPipeline",
            "transcript_data_pipeline.params": {"vocab_path": vocabs["en"]},
            "translation_data_pipeline.class": "TextDataPipeline",
            "translation_data_pipeline.params": {"vocab_path":
                                                 vocabs["de"]},
            "audio_feature_dim": FEATURE_DIM, "batch_size": 768,
            "max_src_len": 48, "max_trg_len": 8,
            "min_src_bucket_boundary": 48, "shuffle_buffer": 0,
            "experimental_frame_transcript_ratio": 6.0},
        "dataset.class": "audio_triple_tfrecord",
        "dataset.params": {"data_path": records["train"],
                           "feature_key": "audio",
                           "transcript_key": "transcript",
                           "translation_key": "translation"},
        "model.class": "multi_task_speech_transformer",
        "hparams_set": "speech_transformer_toy",
        "model.params": model_params,
        "dtype": "float32",
        "entry.class": "trainer",
        "entry.params": dict(JOINT, **{
            "lr_schedule.class": "noam", "lr_schedule.params": LR,
            "train_steps": 4, "save_checkpoint_steps": 4,
            "summary_steps": 1, "enable_tensorboard": False})}
    train_cfg = os.path.join(root, "train.yml")
    with open(train_cfg, "w") as f:
        yaml.safe_dump(train, f)
    predict = {"entry.class": "predict",
               "entry.params": {
                   "search_method.class": "beam_search",
                   "search_method.params": {"beam_size": 2,
                                            "maximum_decode_length": 8}},
               "dataset.class": "audio_triple_tfrecord",
               "dataset.params": {"data_path": records["test"],
                                  "feature_key": "audio",
                                  "transcript_key": "transcript",
                                  "translation_key": "translation"},
               "batch_size": 4}
    predict_cfg = os.path.join(root, "predict.yml")
    with open(predict_cfg, "w") as f:
        yaml.safe_dump(predict, f)

    # the JAX initializers' weights, tripled so that the hypotheses
    # depend on the audio, as ckpt-0 of both dirs
    jtask = jax_build_task(train)
    jmodel = jtask.build_model({
        "model.class": train["model.class"],
        "model.params": dict(JaxSpeechTransformer.build_model_args_by_name(
            "speech_transformer_toy")["model.params"], **model_params,
            dtype="float32")})
    seed_dir = os.path.join(root, "seed")
    jax_ckpt.save_checkpoint(seed_dir, 0, jax.tree_util.tree_map(
        lambda x: 3.0 * np.asarray(x),
        jmodel.init_params(jax.random.PRNGKey(1))))
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = os.path.join(root, side)
        shutil.copytree(seed_dir, dirs[side])

    heads = {"st": ["--metric.class", "bleu"],
             "asr": ["--task.params", "{generation_output: asr}",
                     "--metric.class", "wer"]}

    def predict_argv(model_dir, head, out):
        return ["--config_paths", predict_cfg, "--model_dir", model_dir,
                "--output_file", out] + heads[head]

    out = {"port": {}, "jax": {}, "root": root, "dirs": dirs}
    _, out["port"]["train"] = _port(["--config_paths", train_cfg,
                                     "--model_dir", dirs["port"]])
    ops = [["train", ["--config_paths", train_cfg, "--model_dir",
                      dirs["jax"], "--compilation_cache_dir",
                      os.path.join(root, "xla_cache")],
            os.path.join(root, "jax_train.json")]]
    port_predicts = {}
    for head in heads:
        for model_side in ("jax", "port"):
            for runner in ("jax", "port"):
                name = f"{runner}_on_{model_side}_{head}"
                argv = predict_argv(dirs[model_side], head,
                                    os.path.join(root, f"hyp.{name}"))
                if runner == "port":
                    port_predicts[name] = argv
                else:
                    ops.append(["run", argv + [
                        "--compilation_cache_dir",
                        os.path.join(root, "xla_cache")],
                        os.path.join(root, f"{name}.json")])
    # the eval entry on the joint criterion's statistics
    port_predicts["eval"] = [
        "--config_paths", predict_cfg, "--model_dir", dirs["port"],
        "--entry", "eval", "--criterion.class", "joint_criterion",
        "--criterion.params", json.dumps(JOINT["criterion.params"])]
    ops.append(["run", port_predicts["eval"] + [
        "--compilation_cache_dir", os.path.join(root, "xla_cache")],
        os.path.join(root, "eval.json")])
    ops_path = os.path.join(root, "ops.json")
    with open(ops_path, "w") as f:
        json.dump(ops, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    proc = subprocess.run([sys.executable, "-c", JAX_SIDE, ops_path],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(os.path.join(root, "jax_train.json")) as f:
        out["jax"]["train"] = json.load(f)
    for name, argv in port_predicts.items():
        out["port"][name], _ = _port(argv)
    for _, _, path in ops[1:]:
        with open(path) as f:
            out["jax"][os.path.basename(path)[:-len(".json")]] = \
                json.load(f)
    return out


def test_cli_train_losses_and_checkpoints_match(cli_runs):
    port, jax_losses = cli_runs["port"]["train"], cli_runs["jax"]["train"]
    assert len(port) == len(jax_losses) == 4
    for step, (a, b) in enumerate(zip(port, jax_losses)):
        assert _rel(a, b) <= (TOL if step < 2 else LATE_TOL), step
    dirs = cli_runs["dirs"]
    ours = jax_ckpt.restore_checkpoint_params(
        os.path.join(dirs["port"], "ckpt-4.npz"))
    ref = jax_ckpt.restore_checkpoint_params(
        os.path.join(dirs["jax"], "ckpt-4.npz"))
    assert sorted(ours) == sorted(ref)
    assert any(k.startswith("asr_decoder/") for k in ours)
    seed = jax_ckpt.restore_checkpoint_params(
        os.path.join(dirs["port"], "ckpt-0.npz"))
    for prefix in ("decoder/", "asr_decoder/", "asr_symbol_modality/"):
        assert any(not np.array_equal(ours[k], seed[k])
                   for k in ours if k.startswith(prefix)), prefix
    lrs = JaxNoam(LR)
    atol = 2 * sum(float(lrs(s)) for s in range(4)) + 1e-6
    for k in ref:
        assert float(np.abs(ours[k] - ref[k]).max()) <= atol, k


@pytest.mark.parametrize("head, metric", [("st", "BLEU"), ("asr", "WER")])
def test_cli_predict_on_each_head_matches(cli_runs, head, metric):
    """Identical hypothesis files and metrics; each package predicts from
    the other's model dir as from its own."""
    root = cli_runs["root"]
    for model_side in ("jax", "port"):
        files = {}
        for runner in ("jax", "port"):
            name = f"{runner}_on_{model_side}_{head}"
            with open(os.path.join(root, f"hyp.{name}")) as f:
                files[runner] = f.read()
            result = cli_runs[runner][name]
            assert result["samples"] == 6
            assert metric in result
        assert files["port"] == files["jax"]
        assert len(set(files["port"].splitlines())) > 1
        ours = cli_runs["port"][f"port_on_{model_side}_{head}"]
        ref = cli_runs["jax"][f"jax_on_{model_side}_{head}"]
        assert abs(ours[metric] - ref[metric]) <= 1e-6
        assert ours["hypotheses"] == ref["hypotheses"]
    # each head speaks its own vocabulary
    own, other = (TRANSCRIPT_WORDS, TRANSLATION_WORDS) if head == "asr" \
        else (TRANSLATION_WORDS, TRANSCRIPT_WORDS)
    hyps = set(" ".join(
        cli_runs["port"][f"port_on_port_{head}"]["hypotheses"]).split())
    assert hyps & set(own) and not hyps & (set(other) - set(own))


def test_cli_eval_of_the_joint_criterion_matches(cli_runs):
    ours, ref = cli_runs["port"]["eval"], cli_runs["jax"]["eval"]
    assert sorted(ours) == sorted(ref) == ["asr_NLL", "asr_PPL", "st_NLL",
                                           "st_PPL"]
    for k in ref:
        assert _rel(ours[k], ref[k]) <= TOL, k
