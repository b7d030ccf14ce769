"""The port stands alone: importing ``neurst_tpu_torch`` (every module of
it, and each subpackage of the predict path on its own) loads no JAX and
nothing of ``neurst_tpu``; its sources and ``chip_smoke.py`` import
neither; the converters and the pretrained trunks' modules import no
TensorFlow either; an entry point without ``device=`` on a host without
CUDA raises, the predict, cascade and simuleval CLIs included (the
host-only converter CLI runs without one); ``setup.py``
ships every kernel source and header; and ``chip_smoke.py`` fails without
a card.
Each check runs in a fresh interpreter so this process's own JAX
imports cannot hide a leak.
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "neurst_tpu_torch")
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|neurst_tpu)\b",
                       re.MULTILINE)


def _run(code, env_extra=None, cwd=REPO, timeout=120):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_importing_every_module_loads_no_jax_or_neurst_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import neurst_tpu_torch\n"
        "for m in pkgutil.walk_packages(neurst_tpu_torch.__path__,\n"
        "                               'neurst_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'neurst_tpu'))\n"
        "print('LEAKED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("subpackage", ["cli", "data", "tasks", "metrics",
                                        "exps", "training"])
def test_predict_subpackages_load_no_jax_or_neurst_tpu(subpackage):
    code = (
        "import importlib, pkgutil, sys\n"
        f"pkg = importlib.import_module('neurst_tpu_torch.{subpackage}')\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'neurst_tpu'))\n"
        "print('MODULES', len(names), 'LEAKED', bad)\n"
        "sys.exit(1 if bad or not names else 0)\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_predict_cli_without_device_raises_on_a_cuda_less_host():
    proc = subprocess.run(
        [sys.executable, "-m", "neurst_tpu_torch.cli.run_exp", "--entry",
         "predict"], cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr, proc.stderr[-2000:]


@pytest.mark.parametrize("module", [
    "neurst_tpu_torch.models.multi_task_speech_transformer",
    "neurst_tpu_torch.models.ensemble_model",
    "neurst_tpu_torch.criterions.joint_criterion",
    "neurst_tpu_torch.data.datasets.mixed_speech_text_dataset",
    "neurst_tpu_torch.cli.cascade_st", "neurst_tpu_torch.cli.text_metric",
    "neurst_tpu_torch.cli.inspect_checkpoint",
    "neurst_tpu_torch.cli.view_registry"])
def test_multi_task_ensemble_and_cascade_modules_load_no_jax(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'neurst_tpu'))\n"
        "print('LEAKED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", [
    "neurst_tpu_torch.models.waitk_transformer",
    "neurst_tpu_torch.tasks.waitk_translation",
    "neurst_tpu_torch.models.light_convolution_model",
    "neurst_tpu_torch.layers.attentions.light_convolution_layer",
    "neurst_tpu_torch.layers.encoders.light_convolution_encoder",
    "neurst_tpu_torch.layers.decoders.light_convolution_decoder",
    "neurst_tpu_torch.layers.search.sampling",
    "neurst_tpu_torch.utils.simuleval_agents.simul_trans_text_agent",
    "neurst_tpu_torch.utils.simuleval_agents.online_client",
    "neurst_tpu_torch.cli.simuleval_cli"])
def test_wait_k_lightconv_and_sampling_modules_load_no_jax(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'neurst_tpu'))\n"
        "print('LEAKED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


PRETRAINED_MODULES = [
    "neurst_tpu_torch.cli.convert_checkpoint",
    "neurst_tpu_torch.utils.converters",
    "neurst_tpu_torch.utils.converters.converter",
    "neurst_tpu_torch.utils.converters.tf_bundle",
    "neurst_tpu_torch.utils.converters.neurst_transformer",
    "neurst_tpu_torch.utils.converters.fairseq_transformer",
    "neurst_tpu_torch.utils.converters.google_bert",
    "neurst_tpu_torch.utils.converters.openai_gpt2",
    "neurst_tpu_torch.utils.converters.fairseq_wav2vec2",
    "neurst_tpu_torch.layers.auto_pretrained_layer",
    "neurst_tpu_torch.models.bert", "neurst_tpu_torch.models.gpt2",
    "neurst_tpu_torch.models.wav2vec2",
    "neurst_tpu_torch.models.ctnmt_transformer",
    "neurst_tpu_torch.criterions.label_smoothed_cross_entropy_with_kd",
    "neurst_tpu_torch.tasks.language_model",
    "neurst_tpu_torch.data.text.huggingface_tokenizer",
    "neurst_tpu_torch.data.data_pipelines.bert_data_pipeline",
    "neurst_tpu_torch.data.data_pipelines.gpt2_data_pipeline"]


@pytest.mark.parametrize("module", PRETRAINED_MODULES)
def test_pretrained_trunk_modules_load_no_jax_or_tensorflow(module):
    """The converters, the pretrained models and their task and data
    modules import neither JAX nor ``neurst_tpu`` nor TensorFlow."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'neurst_tpu', 'tensorflow'))\n"
        "print('LEAKED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(
    os.path.join(PACKAGE, "utils", "converters", f)
    for f in os.listdir(os.path.join(PACKAGE, "utils", "converters"))
    if f.endswith(".py")), ids=os.path.basename)
def test_converters_never_mention_tensorflow_imports(path):
    """The TF-free bundle reader replaces the JAX converter's ``import
    tensorflow``: no converter source imports it, even lazily."""
    with open(path) as f:
        text = f.read()
    assert not re.search(r"^\s*(import|from)\s+tensorflow\b", text,
                         re.MULTILINE), path
    assert "tensorflow as tf" not in text, path


def test_convert_checkpoint_cli_runs_without_a_card(tmp_path):
    """The converter CLI is host-only: it converts on a CUDA-less host
    without ``--device``."""
    fixture = os.path.join(REPO, "tests", "fixtures", "reference_goldens",
                           "tf_ckpt")
    proc = subprocess.run(
        [sys.executable, "-m", "neurst_tpu_torch.cli.convert_checkpoint",
         "--converter", "neurst_transformer", "--from_path", fixture,
         "--to_path", str(tmp_path / "out"), "--num_heads", "2"], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert (tmp_path / "out" / "ckpt-0.npz").exists()


def test_simuleval_cli_without_device_raises_on_a_cuda_less_host(tmp_path):
    """The model dir is read first (its configs), then the device is
    resolved: without CUDA and without ``--device cpu`` it raises."""
    import json
    with open(tmp_path / "model_configs.yml", "w") as f:
        vocab = {"vocab_path": os.path.join(REPO, "tests", "examples",
                                            "vocab.txt")}
        json.dump({"task.class": "waitk_translation", "task.params": {
            "src_data_pipeline.class": "TextDataPipeline",
            "src_data_pipeline.params": vocab,
            "trg_data_pipeline.class": "TextDataPipeline",
            "trg_data_pipeline.params": vocab},
            "model.class": "waitk_transformer", "model.params": {}}, f)
    src = tmp_path / "src.txt"
    src.write_text("tok1 tok2\n")
    proc = subprocess.run(
        [sys.executable, "-m", "neurst_tpu_torch.cli.simuleval_cli",
         "--model_dir", str(tmp_path), "--src_file", str(src)], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr, proc.stderr[-2000:]


def test_cascade_st_without_device_raises_on_a_cuda_less_host(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "neurst_tpu_torch.cli.cascade_st",
         "--asr_model_dir", str(tmp_path), "--mt_model_dir", str(tmp_path),
         "--dataset", "audio_tfrecord", "--data_path",
         str(tmp_path / "none.tfrecords")], cwd=REPO, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr, proc.stderr[-2000:]


def test_setup_ships_every_kernel_source_and_header():
    import ast
    import fnmatch
    with open(os.path.join(REPO, "setup.py")) as f:
        tree = ast.parse(f.read())
    globs = next(ast.literal_eval(kw.value) for node in ast.walk(tree)
                 if isinstance(node, ast.Call)
                 for kw in node.keywords if kw.arg == "package_data")
    csrc = os.listdir(os.path.join(PACKAGE, "csrc"))
    assert any(f.endswith(".cuh") for f in csrc)
    for name in csrc:
        assert any(fnmatch.fnmatch(f"csrc/{name}", g)
                   for g in globs["neurst_tpu_torch"]), name


@pytest.mark.parametrize("path", sorted(
    [os.path.join(root, f) for root, _, files in os.walk(PACKAGE)
     for f in files if f.endswith(".py")]
    + [os.path.join(REPO, "chip_smoke.py"),
       os.path.join(REPO, "tools", "profile_torch_decode.py"),
       os.path.join(REPO, "tools", "profile_torch_train.py"),
       os.path.join(REPO, "tools", "quality_torch_mt.py")]),
    ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_no_jax_or_neurst_tpu(path):
    with open(path) as f:
        found = FORBIDDEN.findall(f.read())
    assert not found, f"{path} imports {found}"


def test_build_model_without_device_raises_on_a_cuda_less_host():
    code = (
        "import neurst_tpu_torch, torch\n"
        "from neurst_tpu_torch.models.speech_transformer import "
        "SpeechTransformer\n"
        "assert not torch.cuda.is_available()\n"
        "cfg = SpeechTransformer.build_model_args_by_name("
        "'speech_transformer_toy')\n"
        "try:\n"
        "    neurst_tpu_torch.build_model(cfg, trg_meta={'vocab_size': 8,"
        " 'eos_id': 1})\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', e)\n"
        "else:\n"
        "    raise SystemExit('built a model on the CPU unasked')\n")
    proc = _run(code)
    assert proc.returncode == 0 and "RAISED" in proc.stdout, \
        proc.stdout + proc.stderr


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot pass: here
    it stops at the device check, on a card at the package import."""
    import shutil
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run("import runpy; runpy.run_path('chip_smoke.py', "
                "run_name='__main__')", cwd=str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
