"""The port stands alone: importing ``neurst_tpu_torch`` (every module of
it, and each subpackage of the predict path on its own) loads no JAX and
nothing of ``neurst_tpu``; its sources and ``chip_smoke.py`` import
neither; the converters and the pretrained trunks' modules import no
TensorFlow either; an entry point without ``device=`` on a host without
CUDA raises, the predict, cascade and simuleval CLIs and the QAT, int8,
MoE, pruning and export entries included (the host-only converter CLI
runs without one); the orbax format's modules (zstd, OCDBT, zarr) and
the port's sources import neither orbax, tensorstore, zstandard nor
ml_dtypes, and a checkpoint round trip loads none of them; no module
of the port, and not ``chip_smoke.py``, imports sacremoses, sacrebleu,
sentencepiece, regex or protobuf at module level, nor jieba,
transformers or tokenizers anywhere, and where those cannot be imported
the port's Moses, punctuation normalizer, SacreBLEU, SentencePiece,
jieba, WordPiece and byte-level BPE give what they give beside them (the
committed goldens those packages wrote, and this process's outputs);
``setup.py`` ships every kernel source and header (the zstd decoder's
too), the Moses and jieba data and the quantization, sparsity and
plug-in (``contrib``) subpackages; and ``chip_smoke.py`` fails without a
card.

Each check runs in an interpreter of its own, so that this process's own
JAX imports cannot hide a leak; to keep that cheap, one parent
interpreter that has imported torch (and neither JAX nor ``neurst_tpu``)
forks a child per check (``CHILD_RUNNER``), and a module-scoped fixture
collects every child's result once.  A child reports its exit code, its
output and the JAX, ``neurst_tpu`` and TensorFlow modules it loaded.
"""

import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "neurst_tpu_torch")
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|neurst_tpu)\b",
                       re.MULTILINE)
JAX_ROOTS = ("jax", "jaxlib", "flax", "neurst_tpu")
# the orbax format's own libraries, which the port's reader replaces
ORBAX_ROOTS = ("orbax", "tensorstore", "zstandard", "ml_dtypes")
ORBAX_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(orbax|tensorstore|zstandard|ml_dtypes|optax)\b",
    re.MULTILINE)

# The parent: imports torch, then runs each check (a JSON list on stdin)
# in a forked child, a few at a time.  A check is {"id", "kind", ...}:
# "import" imports ``modules`` (and every module under ``walk``); "module"
# runs ``module`` as __main__ with ``argv``; "path" runs the script at
# ``path`` as __main__; "code" executes ``code``; each in ``cwd`` if
# given.  A child writes {"rc", "leaked", "count"} and its stdout and
# stderr into the work dir; the parent prints the results as JSON.
CHILD_RUNNER = r"""
import json, os, sys
import torch  # noqa: F401 - loaded once, before the forks
work = sys.argv[1]
checks = json.load(sys.stdin)
ROOTS = ("jax", "jaxlib", "flax", "neurst_tpu", "tensorflow", "orbax",
         "tensorstore", "zstandard", "ml_dtypes", "sacremoses", "sacrebleu",
         "sentencepiece", "regex", "google", "jieba", "transformers",
         "tokenizers")


def child(check):
    out = os.open(os.path.join(work, check["id"] + ".out"),
                  os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    err = os.open(os.path.join(work, check["id"] + ".err"),
                  os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(out, 1)
    os.dup2(err, 2)
    sys.stdout = os.fdopen(1, "w", buffering=1)
    sys.stderr = os.fdopen(2, "w", buffering=1)
    rc, count = 0, 0
    try:
        if check.get("cwd"):
            os.chdir(check["cwd"])
        kind = check["kind"]
        if kind == "import":
            import importlib, pkgutil
            names = list(check.get("modules") or [])
            if check.get("walk"):
                pkg = importlib.import_module(check["walk"])
                names += [m.name for m in pkgutil.walk_packages(
                    pkg.__path__, pkg.__name__ + ".")]
            for name in names:
                importlib.import_module(name)
            count = len(names)
        else:
            import runpy
            if kind == "module":
                sys.argv = [check["module"]] + check["argv"]
                runpy.run_module(check["module"], run_name="__main__",
                                 alter_sys=True)
            elif kind == "path":
                sys.argv = [check["path"]]
                runpy.run_path(check["path"], run_name="__main__")
            else:
                exec(compile(check["code"], "<check>", "exec"),
                     {"__name__": "__main__"})
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                     else 1)
    except BaseException:
        import traceback
        traceback.print_exc()
        rc = 1
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ROOTS)
    sys.stdout.flush()
    sys.stderr.flush()
    with open(os.path.join(work, check["id"] + ".json"), "w") as f:
        json.dump({"rc": rc, "leaked": leaked, "count": count}, f)
    os._exit(0)


running, pending = {}, list(checks)
while pending or running:
    while pending and len(running) < 4:
        check = pending.pop(0)
        pid = os.fork()
        if pid == 0:
            child(check)
        running[pid] = check
    pid, _ = os.wait()
    running.pop(pid, None)
results = {}
for check in checks:
    path = os.path.join(work, check["id"])
    try:
        with open(path + ".json") as f:
            res = json.load(f)
    except OSError:
        res = {"rc": -1, "leaked": [], "count": 0}
    for stream in ("out", "err"):
        with open(path + "." + stream) as f:
            res[stream] = f.read()
    results[check["id"]] = res
print(json.dumps(results))
"""

SUBPACKAGES = ["cli", "data", "tasks", "metrics", "exps", "training"]
MULTI_TASK_MODULES = [
    "neurst_tpu_torch.models.multi_task_speech_transformer",
    "neurst_tpu_torch.models.ensemble_model",
    "neurst_tpu_torch.criterions.joint_criterion",
    "neurst_tpu_torch.data.datasets.mixed_speech_text_dataset",
    "neurst_tpu_torch.cli.cascade_st", "neurst_tpu_torch.cli.text_metric",
    "neurst_tpu_torch.cli.inspect_checkpoint",
    "neurst_tpu_torch.cli.view_registry"]
WAITK_MODULES = [
    "neurst_tpu_torch.models.waitk_transformer",
    "neurst_tpu_torch.tasks.waitk_translation",
    "neurst_tpu_torch.models.light_convolution_model",
    "neurst_tpu_torch.layers.attentions.light_convolution_layer",
    "neurst_tpu_torch.layers.encoders.light_convolution_encoder",
    "neurst_tpu_torch.layers.decoders.light_convolution_decoder",
    "neurst_tpu_torch.layers.search.sampling",
    "neurst_tpu_torch.utils.simuleval_agents.simul_trans_text_agent",
    "neurst_tpu_torch.utils.simuleval_agents.online_client",
    "neurst_tpu_torch.cli.simuleval_cli"]
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
# the packages the port's own jieba, WordPiece and byte-level BPE replace
HF_ROOTS = ("jieba", "transformers", "tokenizers")
TOKENIZER_MODULES = [
    "neurst_tpu_torch.data.text.jieba_segment",
    "neurst_tpu_torch.data.text.jieba_tokenizer",
    "neurst_tpu_torch.data.text.hf_unicode_tables",
    "neurst_tpu_torch.data.text.wordpiece",
    "neurst_tpu_torch.data.text.byte_level_bpe",
    "neurst_tpu_torch.data.text.hf_tokenizer_files",
    "neurst_tpu_torch.data.text.huggingface_tokenizer",
    "neurst_tpu_torch.data.data_pipelines.bert_data_pipeline",
    "neurst_tpu_torch.data.data_pipelines.gpt2_data_pipeline"]
QUANT_MOE_MODULES = [
    "neurst_tpu_torch.layers.quantization",
    "neurst_tpu_torch.layers.quantization.quant_layers",
    "neurst_tpu_torch.layers.moe",
    "neurst_tpu_torch.layers.transformer_layers",
    "neurst_tpu_torch.utils.param_policy",
    "neurst_tpu_torch.parallel.train_step"]
SLICE13_MODULES = [
    "neurst_tpu_torch.sparsity",
    "neurst_tpu_torch.sparsity.pruning_schedule",
    "neurst_tpu_torch.sparsity.pruning_optimizer",
    "neurst_tpu_torch.exps.export",
    "neurst_tpu_torch.contrib",
    "neurst_tpu_torch.contrib.prune_tune",
    "neurst_tpu_torch.contrib.prune_tune.partial_trainer",
    "neurst_tpu_torch.contrib.prune_tune.mask_sequence_generator"]
PARALLEL_MODULES = [
    "neurst_tpu_torch.parallel",
    "neurst_tpu_torch.parallel.cluster",
    "neurst_tpu_torch.parallel.mesh",
    "neurst_tpu_torch.parallel.utils",
    "neurst_tpu_torch.parallel.collectives",
    "neurst_tpu_torch.parallel.sharding",
    "neurst_tpu_torch.layers.pipeline",
    "neurst_tpu_torch.ops.ring_attention"]
ORBAX_MODULES = [
    "neurst_tpu_torch.utils.zstd",
    "neurst_tpu_torch.utils.ocdbt",
    "neurst_tpu_torch.utils.zarr",
    "neurst_tpu_torch.utils.orbax_checkpoints",
    "neurst_tpu_torch.utils.checkpoints",
    "neurst_tpu_torch.layers.search.speculative"]
# the text packages the port's own Moses, SacreBLEU, SentencePiece,
# jieba, WordPiece and byte-level BPE replace (protobuf is
# ``google.protobuf``; other ``google`` namespace packages may load)
TEXT_PACKAGES = ("sacremoses", "sacrebleu", "sentencepiece", "regex",
                 "google.protobuf", "jieba", "transformers", "tokenizers")
TEXT_FORBIDDEN = re.compile(
    r"^(import|from)\s+(sacremoses|sacrebleu|sentencepiece|regex|"
    r"google\.protobuf|google|jieba|transformers|tokenizers)\b",
    re.MULTILINE)
# jieba, transformers and tokenizers are imported nowhere, not even
# inside a function
HF_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jieba|transformers|"
                          r"tokenizers)\b", re.MULTILINE)
# the text tools where their packages cannot be imported: the
# text_tools phase against the goldens, then outputs printed as JSON
TEXT_BLOCKED_CODE = (
    "import json, sys\n"
    "for name in ('sacremoses', 'sacrebleu', 'sentencepiece', 'regex',\n"
    "             'google.protobuf', 'jieba', 'transformers',\n"
    "             'tokenizers'):\n"
    "    sys.modules[name] = None\n"
    "import chip_smoke\n"
    "chip_smoke.text_tools_phase()\n"
    "from test_torch_isolation import text_outputs\n"
    "print('TEXT', json.dumps(text_outputs()))\n")
EXAMPLES = os.path.join(REPO, "tests", "examples")
QUANT_PARAMS = "{quant_bits: 8, quant_weight_clip_max: 1.0}"
# the QAT, int8 and MoE entries, each without --device
NO_DEVICE_ENTRIES = {
    "qat_train": ["--entry", "train", "--config_paths",
                  os.path.join(EXAMPLES, "example_train_seq2seq.yml"),
                  "--enable_quant", "--quant_params", QUANT_PARAMS],
    "moe_train": ["--entry", "train", "--config_paths",
                  os.path.join(EXAMPLES, "example_train_moe.yml")],
    "int8_predict": ["--entry", "predict", "--config_paths",
                     os.path.join(EXAMPLES, "example_predict_seq2seq.yml"),
                     "--int8_serving", "--int8_activations",
                     "--int8_static_activations"],
    "prune_train": ["--entry", "train", "--config_paths",
                    os.path.join(EXAMPLES, "example_train_seq2seq.yml"),
                    "--pruning_schedule.class", "polynomial_decay",
                    "--gradient_remat", "true"],
    "partial_tune": ["--entry", "partial_tune", "--include",
                     "neurst_tpu_torch.contrib.prune_tune.partial_trainer",
                     "--config_paths",
                     os.path.join(EXAMPLES, "example_train_seq2seq.yml")],
    "export": ["--entry", "export", "--config_paths",
               os.path.join(EXAMPLES, "example_predict_seq2seq.yml")],
    "parallel_train": ["--entry", "train", "--config_paths",
                       os.path.join(EXAMPLES, "example_train_seq2seq.yml"),
                       "--num_model_partitions", "2",
                       "--distribution_strategy", "mirrored"]}

BUILD_MODEL_CODE = (
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


def _checks(tmp):
    """Every child check, by id."""
    checks = [{"id": "every_module", "kind": "import",
               "walk": "neurst_tpu_torch", "modules": ["chip_smoke"]}]
    checks += [{"id": f"subpackage_{name}", "kind": "import",
                "walk": f"neurst_tpu_torch.{name}"} for name in SUBPACKAGES]
    for module in dict.fromkeys(
            MULTI_TASK_MODULES + WAITK_MODULES + PRETRAINED_MODULES
            + QUANT_MOE_MODULES + SLICE13_MODULES + PARALLEL_MODULES
            + ORBAX_MODULES + TOKENIZER_MODULES):
        checks.append({"id": f"module_{module}", "kind": "import",
                       "modules": [module]})
    # the orbax reader on a checkpoint it wrote: no orbax, tensorstore,
    # zstandard or ml_dtypes loaded on the way
    checks.append({"id": "orbax_round_trip", "kind": "code", "code": (
        "import numpy as np\n"
        "from neurst_tpu_torch.utils import orbax_checkpoints as o\n"
        f"path = o.save_checkpoint_orbax({os.path.join(tmp, 'orbax')!r}, "
        "1, {'a': {'w': np.arange(6, dtype=np.float32).reshape(2, 3)}})\n"
        "tree = o.restore_checkpoint_orbax(path)\n"
        "assert np.array_equal(tree['a']['w'], np.arange(6).reshape(2, 3))\n"
        "print('READ', path)\n")})
    run_exp = "neurst_tpu_torch.cli.run_exp"
    checks.append({"id": "predict_cli", "kind": "module", "module": run_exp,
                   "argv": ["--entry", "predict"]})
    for name, argv in NO_DEVICE_ENTRIES.items():
        checks.append({"id": f"entry_{name}", "kind": "module",
                       "module": run_exp, "argv": argv})
    fixture = os.path.join(REPO, "tests", "fixtures", "reference_goldens",
                           "tf_ckpt")
    checks.append({"id": "convert_checkpoint", "kind": "module",
                   "module": "neurst_tpu_torch.cli.convert_checkpoint",
                   "argv": ["--converter", "neurst_transformer",
                            "--from_path", fixture, "--to_path",
                            os.path.join(tmp, "converted"),
                            "--num_heads", "2"]})
    simul_dir = os.path.join(tmp, "simul")
    os.makedirs(simul_dir)
    with open(os.path.join(simul_dir, "model_configs.yml"), "w") as f:
        vocab = {"vocab_path": os.path.join(EXAMPLES, "vocab.txt")}
        json.dump({"task.class": "waitk_translation", "task.params": {
            "src_data_pipeline.class": "TextDataPipeline",
            "src_data_pipeline.params": vocab,
            "trg_data_pipeline.class": "TextDataPipeline",
            "trg_data_pipeline.params": vocab},
            "model.class": "waitk_transformer", "model.params": {}}, f)
    src = os.path.join(tmp, "src.txt")
    with open(src, "w") as f:
        f.write("tok1 tok2\n")
    checks.append({"id": "simuleval_cli", "kind": "module",
                   "module": "neurst_tpu_torch.cli.simuleval_cli",
                   "argv": ["--model_dir", simul_dir, "--src_file", src]})
    checks.append({"id": "cascade_st", "kind": "module",
                   "module": "neurst_tpu_torch.cli.cascade_st",
                   "argv": ["--asr_model_dir", tmp, "--mt_model_dir", tmp,
                            "--dataset", "audio_tfrecord", "--data_path",
                            os.path.join(tmp, "none.tfrecords")]})
    checks.append({"id": "build_model", "kind": "code",
                   "code": BUILD_MODEL_CODE})
    checks.append({"id": "text_blocked", "kind": "code",
                   "code": "import sys\nsys.path.insert(0, %r)\n" % (
                       os.path.join(REPO, "tests")) + TEXT_BLOCKED_CODE})
    checks.append({"id": "chip_smoke", "kind": "path",
                   "path": os.path.join(REPO, "chip_smoke.py")})
    alone = os.path.join(tmp, "alone")
    os.makedirs(alone)
    with open(os.path.join(REPO, "chip_smoke.py")) as f, \
            open(os.path.join(alone, "chip_smoke.py"), "w") as g:
        g.write(f.read())
    checks.append({"id": "chip_smoke_alone", "kind": "path",
                   "path": os.path.join(alone, "chip_smoke.py"),
                   "cwd": alone})
    return checks


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Runs every check once; {id: {"rc", "leaked", "count", "out",
    "err"}}, and the checks' temporary dir under "tmp"."""
    tmp = str(tmp_path_factory.mktemp("isolation"))
    work = os.path.join(tmp, "work")
    os.makedirs(work)
    checks = _checks(tmp)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", CHILD_RUNNER, work],
                          input=json.dumps(checks), cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    results = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(results) == sorted(c["id"] for c in checks)
    results["tmp"] = tmp
    return results


def _no_jax(res, roots=JAX_ROOTS):
    bad = [m for m in res["leaked"] if m.split(".")[0] in roots]
    assert res["rc"] == 0 and not bad, (res["leaked"], res["err"][-4000:])


def test_the_parent_has_torch_and_no_jax():
    """The forking parent imports torch and nothing of JAX or
    ``neurst_tpu``, so no child inherits either."""
    assert "import torch" in CHILD_RUNNER
    assert not FORBIDDEN.search(CHILD_RUNNER)


def test_importing_every_module_loads_no_jax_or_neurst_tpu(children):
    res = children["every_module"]
    _no_jax(res)
    assert res["count"] > 100


@pytest.mark.parametrize("subpackage", SUBPACKAGES)
def test_predict_subpackages_load_no_jax_or_neurst_tpu(children,
                                                       subpackage):
    res = children[f"subpackage_{subpackage}"]
    _no_jax(res)
    assert res["count"] > 0


def test_predict_cli_without_device_raises_on_a_cuda_less_host(children):
    res = children["predict_cli"]
    assert res["rc"] != 0
    assert "no CUDA device" in res["err"], res["err"][-2000:]


@pytest.mark.parametrize("entry", list(NO_DEVICE_ENTRIES))
def test_qat_int8_and_moe_entries_without_device_raise(children, entry):
    """``--enable_quant --quant_params``, the MoE config, the three int8
    flags, the pruning and remat flags, a plug-in entry and the export
    entry parse, and the entry asks for the card."""
    res = children[f"entry_{entry}"]
    assert res["rc"] != 0
    assert "no CUDA device" in res["err"], res["err"][-2000:]
    assert "not ported" not in res["err"]


@pytest.mark.parametrize("module", MULTI_TASK_MODULES)
def test_multi_task_ensemble_and_cascade_modules_load_no_jax(children,
                                                             module):
    _no_jax(children[f"module_{module}"])


@pytest.mark.parametrize("module", WAITK_MODULES)
def test_wait_k_lightconv_and_sampling_modules_load_no_jax(children, module):
    _no_jax(children[f"module_{module}"])


@pytest.mark.parametrize("module", PRETRAINED_MODULES)
def test_pretrained_trunk_modules_load_no_jax_or_tensorflow(children,
                                                           module):
    """The converters, the pretrained models and their task and data
    modules import neither JAX nor ``neurst_tpu`` nor TensorFlow, nor
    (the HuggingFace tokenizer and the BERT and GPT-2 pipelines among
    them) ``transformers``, ``tokenizers`` or jieba."""
    _no_jax(children[f"module_{module}"],
            JAX_ROOTS + ("tensorflow",) + HF_ROOTS)


@pytest.mark.parametrize("module", QUANT_MOE_MODULES)
def test_quantization_and_moe_modules_load_no_jax(children, module):
    _no_jax(children[f"module_{module}"])


@pytest.mark.parametrize("module", SLICE13_MODULES)
def test_pruning_export_and_plugin_modules_load_no_jax(children, module):
    _no_jax(children[f"module_{module}"])


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


def test_convert_checkpoint_cli_runs_without_a_card(children):
    """The converter CLI is host-only: it converts on a CUDA-less host
    without ``--device``."""
    res = children["convert_checkpoint"]
    assert res["rc"] == 0, res["err"][-2000:]
    assert os.path.exists(os.path.join(children["tmp"], "converted",
                                       "ckpt-0.npz"))


def test_simuleval_cli_without_device_raises_on_a_cuda_less_host(children):
    """The model dir is read first (its configs), then the device is
    resolved: without CUDA and without ``--device cpu`` it raises."""
    res = children["simuleval_cli"]
    assert res["rc"] != 0
    assert "no CUDA device" in res["err"], res["err"][-2000:]


def test_cascade_st_without_device_raises_on_a_cuda_less_host(children):
    res = children["cascade_st"]
    assert res["rc"] != 0
    assert "no CUDA device" in res["err"], res["err"][-2000:]


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


def test_setup_ships_the_quantization_subpackage():
    from setuptools import find_packages
    with open(os.path.join(REPO, "setup.py")) as f:
        text = f.read()
    include = re.search(r"find_packages\(include=(\[[^\]]*\])", text)
    packages = find_packages(where=REPO,
                             include=eval(include.group(1)))  # noqa: S307
    assert "neurst_tpu_torch.layers.quantization" in packages
    assert "neurst_tpu_torch.layers" in packages


@pytest.mark.parametrize("module", PARALLEL_MODULES)
def test_parallel_modules_load_no_jax(children, module):
    _no_jax(children[f"module_{module}"])


@pytest.mark.parametrize("module", ORBAX_MODULES)
def test_orbax_modules_load_no_orbax_tensorstore_or_zstandard(children,
                                                               module):
    """The orbax format's modules (zstd, OCDBT, zarr, the checkpoint
    functions) and the speculative search load neither JAX nor orbax,
    tensorstore, zstandard or ml_dtypes."""
    _no_jax(children[f"module_{module}"], JAX_ROOTS + ORBAX_ROOTS)


def test_orbax_round_trip_loads_no_orbax_libraries(children):
    res = children["orbax_round_trip"]
    _no_jax(res, JAX_ROOTS + ORBAX_ROOTS)
    assert "READ" in res["out"]


def test_every_module_loads_no_orbax_libraries(children):
    _no_jax(children["every_module"], JAX_ROOTS + ORBAX_ROOTS)


def test_setup_ships_the_parallel_modules():
    from setuptools import find_packages
    with open(os.path.join(REPO, "setup.py")) as f:
        text = f.read()
    include = re.search(r"find_packages\(include=(\[[^\]]*\])", text)
    packages = find_packages(where=REPO,
                             include=eval(include.group(1)))  # noqa: S307
    assert "neurst_tpu_torch.parallel" in packages
    for module in PARALLEL_MODULES[1:]:
        package, name = module.rsplit(".", 1)
        assert package in packages, module
        assert os.path.exists(os.path.join(
            REPO, *package.split("."), name + ".py")), module


def test_setup_ships_the_sparsity_and_plugin_subpackages():
    from setuptools import find_packages
    with open(os.path.join(REPO, "setup.py")) as f:
        text = f.read()
    include = re.search(r"find_packages\(include=(\[[^\]]*\])", text)
    packages = find_packages(where=REPO,
                             include=eval(include.group(1)))  # noqa: S307
    for name in ("neurst_tpu_torch.sparsity", "neurst_tpu_torch.contrib",
                 "neurst_tpu_torch.contrib.prune_tune"):
        assert name in packages, name


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
        text = f.read()
    found = FORBIDDEN.findall(text) + ORBAX_FORBIDDEN.findall(text)
    assert not found, f"{path} imports {found}"


def test_build_model_without_device_raises_on_a_cuda_less_host(children):
    res = children["build_model"]
    assert res["rc"] == 0 and "RAISED" in res["out"], \
        res["out"] + res["err"]


def test_chip_smoke_fails_without_a_card(children):
    res = children["chip_smoke"]
    assert res["rc"] != 0
    assert '"ok": true' not in res["out"]


def test_chip_smoke_alone_fails(children):
    """Without the rest of the repository the script cannot pass: here
    it stops at the device check, on a card at the package import."""
    res = children["chip_smoke_alone"]
    assert res["rc"] != 0
    assert '"ok": true' not in res["out"]


def text_outputs():
    """The port's text tools on a few lines of each MuST-C language and
    the spm fixtures: the registered Moses tokenizer with every option,
    the transcript normalizer, SacreBLEU / chrF, spm pieces and decodes.
    (Imports only the port: it runs in the children too.)"""
    import json as _json

    from neurst_tpu_torch.data.data_pipelines.data_pipeline import \
        lowercase_and_remove_punctuations
    from neurst_tpu_torch.data.text.tokenizer import build_tokenizer
    from neurst_tpu_torch.metrics.metric import build_metric
    with open(os.path.join(REPO, "tests", "fixtures", "text_goldens",
                           "goldens.json"), encoding="utf-8") as f:
        goldens = _json.load(f)
    out = {}
    for lang, g in goldens["moses"].items():
        lines = g["lines"][:6]
        for agg in (False, True):
            for esc in (False, True):
                tok = build_tokenizer({"tokenizer.class": "moses",
                                       "tokenizer.params": {
                                           "language": lang,
                                           "aggressive_dash_splits": agg,
                                           "escape": esc,
                                           "glossaries": ["e-mail"]}})
                out[f"moses_{lang}_{agg}_{esc}"] = [
                    (tok.tokenize(s, return_str=True),
                     tok.detokenize(tok.tokenize(s))) for s in lines]
        out[f"transcript_{lang}"] = [
            lowercase_and_remove_punctuations(lang, s) for s in lines]
    for name, g in goldens["sacrebleu"].items():
        refs = [list(r) for r in zip(*g["references"])]
        for cls in ("sacre_bleu", "uncased_bleu"):
            metric = build_metric({"metric.class": cls, "metric.params": {
                "language": g["language"]}})
            out[f"{cls}_{name}"] = metric(g["hypotheses"], refs)
    for name, g in goldens["spm"].items():
        tok = build_tokenizer({"tokenizer.class": "spm"})
        tok.init_subtokenizer(os.path.join(REPO, "tests", "fixtures", "spm",
                                           f"{name}.model"))
        out[f"spm_{name}"] = [(tok.tokenize(s, return_str=True),
                               tok.detokenize(tok.tokenize(s)))
                              for s in g["lines"][:20]]
    out.update(tokenizer_outputs())
    return out


def tokenizer_outputs():
    """The registered ``jieba`` (with and without glossaries) and
    ``huggingface`` tokenizers on golden lines, each fixture from its
    ``tokenizer.json`` directory and from its slow files, and the
    ``bert`` and ``gpt2`` pipelines' ids and decodes.  (Imports only the
    port: it runs in the children too.)"""
    import json as _json

    from neurst_tpu_torch.data.data_pipelines import build_data_pipeline
    from neurst_tpu_torch.data.text.tokenizer import build_tokenizer
    with open(os.path.join(REPO, "tests", "fixtures", "text_goldens",
                           "tokenizer_goldens.json"), encoding="utf-8") as f:
        goldens = _json.load(f)
    out = {}
    g = goldens["jieba"]
    for glossaries, lines in ((None, g["lines"][:60]),
                              (g["glossaries"], g["glossary_lines"])):
        tok = build_tokenizer({"tokenizer.class": "jieba",
                               "tokenizer.params": {
                                   "glossaries": glossaries}})
        out[f"jieba_{bool(glossaries)}"] = [
            (tok.tokenize(s), tok.detokenize(tok.tokenize(s)))
            for s in lines]
    fixtures = os.path.join(REPO, "tests", "fixtures", "hf")
    for part, g in goldens["hf"].items():
        for kind in ("fast", "slow"):
            tok = build_tokenizer("huggingface")
            tok.init_subtokenizer(os.path.join(
                fixtures, f"{g['fixture']}_{kind}"))
            out[f"hf_{part}_{kind}"] = [
                (tok.tokenize(s), tok.detokenize(tok.tokenize(
                    s, return_str=True))) for s in g["lines"][:60]]
    for cls, fixture, vocab, part in (
            ("bert", "bert_uncased_fast", "vocab.txt", "wordpiece_uncased"),
            ("gpt2", "gpt2_fast", "vocab.json", "gpt2_bpe")):
        path = os.path.join(fixtures, fixture)
        pipeline = build_data_pipeline({
            "data_pipeline.class": cls, "data_pipeline.params": {
                "vocab_path": os.path.join(path, vocab),
                "tokenizer_name": path}})
        ids = [pipeline.encode(s) for s in goldens["hf"][part]["lines"][:30]]
        out[f"pipeline_{cls}"] = [(i, pipeline.decode(i)) for i in ids]
    return out


def test_setup_ships_the_moses_data():
    import ast
    import fnmatch
    with open(os.path.join(REPO, "setup.py")) as f:
        tree = ast.parse(f.read())
    globs = next(ast.literal_eval(kw.value) for node in ast.walk(tree)
                 if isinstance(node, ast.Call)
                 for kw in node.keywords if kw.arg == "package_data")
    data = os.path.join(PACKAGE, "data", "text", "moses_data")
    files = [os.path.relpath(os.path.join(root, f), PACKAGE)
             for root, _, names in os.walk(data) for f in names]
    assert len(files) > 38
    for name in files:
        assert any(fnmatch.fnmatch(name, g)
                   for g in globs["neurst_tpu_torch"]), name


def test_every_module_imports_no_text_package(children):
    res = children["every_module"]
    bad = [m for m in res["leaked"] for p in TEXT_PACKAGES
           if m == p or m.startswith(p + ".")]
    assert res["rc"] == 0 and not bad, bad


@pytest.mark.parametrize("path", sorted(
    [os.path.join(root, f) for root, _, files in os.walk(PACKAGE)
     for f in files if f.endswith(".py")]
    + [os.path.join(REPO, "chip_smoke.py")]),
    ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_no_text_package_at_module_level(path):
    with open(path) as f:
        found = TEXT_FORBIDDEN.findall(f.read())
    assert not found, f"{path} imports {found}"


def test_text_tools_without_their_packages(children):
    """Where sacremoses, sacrebleu, sentencepiece, regex and protobuf
    cannot be imported, the text_tools phase passes on the goldens and
    the outputs equal this process's, where they can."""
    import json as _json
    res = children["text_blocked"]
    assert res["rc"] == 0, res["err"][-3000:]
    rows = [line for line in res["out"].splitlines()
            if line.startswith('{"phase": "text_tools"')]
    row = _json.loads(rows[-1])
    assert row["lines_equal"] == row["lines_compared"] > 2000
    for name in ("jieba_cut", "wordpiece_cased", "wordpiece_uncased",
                 "gpt2_bpe", "roberta_bpe"):
        part = row["parts"][name]
        assert part["equal"] == part["compared"] >= 500, name
    printed = _json.loads(next(line for line in res["out"].splitlines()
                               if line.startswith("TEXT "))[5:])
    assert printed == _json.loads(_json.dumps(text_outputs()))
    with open(os.path.join(REPO, "tests", "fixtures", "text_goldens",
                           "tokenizer_goldens.json"), encoding="utf-8") as f:
        goldens = _json.load(f)
    g = goldens["jieba"]
    assert [t for t, _ in printed["jieba_False"]] == [
        [w for w in cut if w.strip()] for cut in g["cut"][:60]]
    assert [t for t, _ in printed["jieba_True"]] == [
        [w for w in cut if w.strip()] for cut in g["glossary_cut"]]
    for part, g in goldens["hf"].items():
        for kind in ("fast", "slow"):
            assert [t for t, _ in printed[f"hf_{part}_{kind}"]] == \
                g["tokens"][:60], (part, kind)


def test_tokenizer_modules_load_none_of_their_packages(children):
    """The port's jieba, WordPiece, byte-level BPE, their tables and
    readers, the ``huggingface`` tokenizer and the BERT and GPT-2
    pipelines load neither JAX nor jieba, ``transformers`` or
    ``tokenizers``."""
    for module in TOKENIZER_MODULES:
        _no_jax(children[f"module_{module}"], JAX_ROOTS + HF_ROOTS)


@pytest.mark.parametrize("path", sorted(
    [os.path.join(root, f) for root, _, files in os.walk(PACKAGE)
     for f in files if f.endswith(".py")]
    + [os.path.join(REPO, "chip_smoke.py")]),
    ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_no_jieba_or_huggingface_package_anywhere(path):
    with open(path) as f:
        found = HF_FORBIDDEN.findall(f.read())
    assert not found, f"{path} imports {found}"


def test_setup_ships_the_jieba_data():
    import ast
    import fnmatch
    with open(os.path.join(REPO, "setup.py")) as f:
        tree = ast.parse(f.read())
    globs = next(ast.literal_eval(kw.value) for node in ast.walk(tree)
                 if isinstance(node, ast.Call)
                 for kw in node.keywords if kw.arg == "package_data")
    data = os.path.join(PACKAGE, "data", "text", "jieba_data")
    files = sorted(os.listdir(data))
    assert files == ["NOTICE", "dict.txt.gz", "hmm.json.gz"]
    for name in files:
        assert any(fnmatch.fnmatch(f"data/text/jieba_data/{name}", g)
                   for g in globs["neurst_tpu_torch"]), name
