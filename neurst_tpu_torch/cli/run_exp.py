"""The main CLI of the port:
``python -m neurst_tpu_torch.cli.run_exp --entry
predict|train|eval|sequence_evaluator|validation|export ...``
(counterpart of ``neurst_tpu/cli/run_exp.py``).

Config precedence as in the JAX package: command line > ``config_paths``
files > ``hparams_set`` > the model dir's ``model_configs.yml``; the
top-level config seeds ``entry.params``.  ``--device`` picks the card
(the current CUDA device by default; without CUDA it raises unless
``--device cpu`` is given, which runs every kernel's plain version).

Quantization: ``--enable_quant --quant_params`` (QAT; also read from a
model dir's ``model_configs.yml``) sets the global config before any
module is built; ``--int8_serving [--int8_activations
[--int8_static_activations]]`` serves int8 (inference entries only; a QAT
model dir's clips drive the int8 grid), as the JAX CLI does.

``--include`` takes plug-in files or module names (a file inside this
package is imported by its module name, so a plug-in is registered once
however it is named); they are imported before the flags are parsed, so
their entries and flags are known (the PruneTune plug-ins,
``neurst_tpu_torch/contrib/prune_tune/``, come in this way).

Processes: one per GPU.  Under torchrun (``WORLD_SIZE`` > 1) the process
group is formed from its environment; ``--distributed_init`` forms it
from ``--worker_hosts`` / ``--task_index`` (or ``WORKER_HOSTS`` /
``TASK_ID``), with ``LOCAL_WORLD_SIZE`` processes a host
(``parallel/cluster.py``).  Each process runs on ``cuda:LOCAL_RANK``
unless ``--device`` says otherwise.  ``distribution_strategy`` is
accepted as the JAX CLI accepts it: the process group replaces it.  The
pipeline flags (``*.pipeline_stages`` / ``*.pipeline_microbatches``) shape
the training step only: other entries build the model without them.

Flags of features the port lacks raise ``NotImplementedError`` when set:
the XLA compilation cache, ``enable_xla: true`` and NaN checks.  The
``predict``, ``train``, ``eval``, ``sequence_evaluator``, ``validation``
and ``export`` entries are ported (the recipes' ``trainer`` is ``train``
by its class name); the trainer refuses the features it lacks itself
(``exps/trainer.py``).
"""

import importlib
import importlib.util
import logging
import os
import sys

import yaml

import neurst_tpu_torch  # noqa: F401 - fills the registries
from neurst_tpu_torch.data.datasets.dataset import build_dataset
from neurst_tpu_torch.exps.base_experiment import build_exp
from neurst_tpu_torch.exps.trainer import Trainer
from neurst_tpu_torch.layers.quantization.quant_layers import (
    get_global_config, global_init, quant_enabled, set_int8_serving)
from neurst_tpu_torch.models.model import resolve_device
from neurst_tpu_torch.parallel.cluster import distributed_initialize
from neurst_tpu_torch.tasks.task import build_task
from neurst_tpu_torch.utils import flags_core
from neurst_tpu_torch.utils.configurable import (
    ModelConfigs, deep_merge_dict, flatten_string_list, load_from_config_path,
    strip_training_only_model_flags)
from neurst_tpu_torch.utils.flags_core import Flag, ModuleFlag
from neurst_tpu_torch.utils.hparams_sets import get_hyper_parameters
from neurst_tpu_torch.utils.registry import get_registered_class

__all__ = ["FLAG_LIST", "parse_and_merge", "run_experiment", "cli_main"]

FLAG_LIST = [
    Flag("config_paths", dtype=Flag.TYPE.STRING, default=None, multiple=True,
         help="Path(s) to YAML/JSON configuration files."),
    Flag("hparams_set", dtype=Flag.TYPE.STRING, default=None,
         help="A set of predefined hyper-parameters (e.g. "
              "speech_transformer_s)."),
    Flag("model_dir", dtype=Flag.TYPE.STRING, default=None,
         help="The path for saving/loading checkpoints."),
    Flag("distribution_strategy", dtype=Flag.TYPE.STRING, default=None,
         help="Kept for recipe compatibility (the process group replaces "
              "it: one process per GPU)."),
    Flag("dtype", dtype=Flag.TYPE.STRING, default=None,
         help="The computation dtype (bfloat16/float32)."),
    Flag("enable_check_numerics", dtype=Flag.TYPE.BOOLEAN, default=None,
         help="NaN checking (not ported)."),
    Flag("enable_xla", dtype=Flag.TYPE.BOOLEAN, default=None,
         help="Kept for recipe compatibility: XLA compilation is not "
              "ported (true raises)."),
    Flag("enable_quant", dtype=Flag.TYPE.BOOLEAN, default=False,
         help="Whether to enable quantization-aware training."),
    Flag("quant_params", dtype=Flag.TYPE.STRING, default=None,
         help="A dict of parameters for quantization."),
    Flag("int8_serving", dtype=Flag.TYPE.BOOLEAN, default=False,
         help="Serve with int8-stored dense kernels (absmax per output "
              "channel of the float32 checkpoint, or a QAT checkpoint's "
              "learned clips); inference entries only."),
    Flag("int8_activations", dtype=Flag.TYPE.BOOLEAN, default=False,
         help="With --int8_serving: also quantize dense inputs per token "
              "and run int8 x int8 -> int32 products."),
    Flag("int8_static_activations", dtype=Flag.TYPE.BOOLEAN, default=False,
         help="With --int8_activations: per-tensor activation scales, "
              "calibrated at predict start on the model's own "
              "hypotheses (a QAT checkpoint's FFN clip where it has one)."),
    Flag("int8_calibration_batches", dtype=Flag.TYPE.INTEGER, default=4,
         help="Number of leading batches used to calibrate the static "
              "int8 activation scales."),
    Flag("include", dtype=Flag.TYPE.STRING, default=None, multiple=True,
         help="Plug-in files or module names with custom @register "
              "components, imported before the flags are parsed."),
    Flag("seed", dtype=Flag.TYPE.INTEGER, default=0,
         help="The global random seed."),
    Flag("distributed_init", dtype=Flag.TYPE.BOOLEAN, default=None,
         help="Form the process group from --worker_hosts/--task_index "
              "(or WORKER_HOSTS/TASK_ID) before anything is built."),
    Flag("compilation_cache_dir", dtype=Flag.TYPE.STRING, default=None,
         help="The JAX package's XLA compilation cache (not ported)."),
    Flag("worker_hosts", dtype=Flag.TYPE.STRING, default=None,
         help="Comma-separated worker addresses; the first is the "
              "coordinator (port 8476 by default)."),
    Flag("task_index", dtype=Flag.TYPE.INTEGER, default=None,
         help="This host's index into worker_hosts."),
    Flag("device", dtype=Flag.TYPE.STRING, default=None,
         help="The torch device to run on ('cpu' runs the plain versions "
              "of the kernels); the current CUDA device by default."),
    ModuleFlag("entry", "entry", help="The program entry."),
    ModuleFlag("task", "task", help="The binding task."),
    ModuleFlag("model", "model", help="The model."),
    ModuleFlag("dataset", "dataset", help="The dataset."),
]

# flags of features the port does not have, and the value that means off
_UNPORTED = {"compilation_cache_dir": None,
             "enable_check_numerics": None, "enable_xla": (None, False)}


def _format_hparams(predefined: dict) -> dict:
    """hparams-set dict -> top-level config (model.* kept, the rest
    nested into entry.params)."""
    out = {}
    predefined = dict(predefined or {})
    for key in ("model.class", "model", "model.params"):
        if key in predefined:
            out[key] = predefined.pop(key)
    if predefined:
        out["entry.params"] = predefined
    return out


_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _load_includes(paths):
    """Imports user plug-in files or modules so their @register calls
    run.  A file that lies in an importable package under this package's
    root is imported by its module name, and a file is loaded once
    however often it is named."""
    for path in flatten_string_list(paths):
        if not os.path.exists(path):
            importlib.import_module(path)
            logging.info("Imported plug-in module %s", path)
            continue
        full = os.path.realpath(path)
        rel = os.path.relpath(full, _PACKAGE_ROOT)
        parts = rel[:-len(".py")].split(os.sep)
        if not rel.startswith("..") and rel.endswith(".py") and all(
                os.path.exists(os.path.join(_PACKAGE_ROOT, *parts[:i],
                                            "__init__.py"))
                for i in range(1, len(parts))):
            importlib.import_module(".".join(parts))
        else:
            name = "neurst_tpu_torch_userdef_" + "".join(
                c if c.isalnum() else "_" for c in full)
            if name not in sys.modules:
                spec = importlib.util.spec_from_file_location(name, full)
                module = importlib.util.module_from_spec(spec)
                sys.modules[name] = module
                try:
                    spec.loader.exec_module(module)
                except BaseException:
                    del sys.modules[name]
                    raise
        logging.info("Imported plug-in file %s", path)


def parse_and_merge(argv):
    """Resolves the full configuration from argv (plug-ins first)."""
    argv_dict, _ = flags_core.get_argv_dict(argv)
    _load_includes(argv_dict.get("include"))
    cfg_files = load_from_config_path(
        flatten_string_list(argv_dict.get("config_paths")))
    model_dir = argv_dict.get("model_dir") or cfg_files.get("model_dir")
    hparams = _format_hparams(get_hyper_parameters(
        argv_dict.get("hparams_set") or cfg_files.get("hparams_set")))
    base = {}
    model_dirs = flatten_string_list(model_dir)
    if model_dirs and ModelConfigs.exists(model_dirs[0]):
        base = ModelConfigs.load(model_dirs[0])
    merged = deep_merge_dict(deep_merge_dict(base, hparams), cfg_files)
    # entries also read their flags from the top level: seed entry.params
    # with it, so default-filling never overrides a user value set there
    top_level = {k: v for k, v in merged.items()
                 if k not in ("entry", "entry.class", "entry.params")}
    merged["entry.params"] = deep_merge_dict(
        top_level, merged.get("entry.params") or {}, local_overwrite=False)
    return flags_core.parse_flags(FLAG_LIST, argv, existing=merged)


def _set_quantization(args):
    """The global quantization config, before any module is built: QAT
    from ``enable_quant`` / ``quant_params``; int8 serving (refused for a
    trainer entry) with a QAT config turned off first, its bits kept for
    the int8 grid.  Without ``int8_serving`` it is turned off (the JAX
    CLI leaves an earlier call's on in the process)."""
    qp = args.get("quant_params")
    if isinstance(qp, str):
        qp = yaml.safe_load(qp)
    global_init(bool(args.get("enable_quant")), **(qp or {}))
    if not args.get("int8_serving"):
        set_int8_serving(False)
        return
    entry = get_registered_class(args.get("entry.class"), "entry")
    if isinstance(entry, type) and issubclass(entry, Trainer):
        raise ValueError("--int8_serving is inference-only")
    qat_bits = 8
    if quant_enabled():
        qat_bits = int(get_global_config().get("quant_bits") or 8)
        logging.info("int8_serving of a QAT checkpoint: learned clip "
                     "ranges drive the int8 scales (quant_bits=%d); "
                     "activation fake-quant is dropped", qat_bits)
        global_init(False)
    set_int8_serving(True, qat_bits=qat_bits,
                     activations=bool(args.get("int8_activations")),
                     static_activation_scales=bool(
                         args.get("int8_static_activations")))


def run_experiment(args):
    on = sorted(k for k, off in _UNPORTED.items()
                if args.get(k) not in (off if isinstance(off, tuple)
                                       else (off,)))
    if on:
        raise NotImplementedError(f"not ported: --{', --'.join(on)}")
    device = resolve_device(args.get("device"))
    if args.get("distributed_init") \
            or int(os.environ.get("WORLD_SIZE") or 1) > 1:
        # --distributed_init, or torchrun's environment
        device = distributed_initialize(
            args.get("worker_hosts"), args.get("task_index"),
            device if args.get("device") else None)
    _set_quantization(args)
    entry_cls = get_registered_class(args.get("entry.class"), "entry")
    is_train = isinstance(entry_cls, type) and issubclass(entry_cls, Trainer)
    task = build_task(args)
    custom_dataset = build_dataset(args) if args.get("dataset.class") \
        else None
    model = None
    if args.get("model.class"):
        model_params = dict(args.get("model.params") or {})
        if not is_train:
            # the pipeline shapes the training step only
            model_params = strip_training_only_model_flags(model_params)
        if args.get("dtype"):
            model_params["dtype"] = args["dtype"]
        model = task.build_model({"model.class": args["model.class"],
                                  "model.params": model_params},
                                 device=device)
    entry_args = deep_merge_dict(dict(args), args.get("entry.params") or {})
    entry = build_exp({"entry.class": args.get("entry.class"),
                       "entry.params": entry_args},
                      task=task, model=model, custom_dataset=custom_dataset,
                      model_dir=args.get("model_dir"))
    return entry.run()


def cli_main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    if argv is None:
        argv = sys.argv[1:]
    args = parse_and_merge(argv)
    if not args.get("entry.class"):
        raise ValueError("--entry must be specified (predict, train, eval, "
                         "sequence_evaluator, validation or export).")
    flags_core.verbose_flags(args)
    return run_experiment(args)


if __name__ == "__main__":
    cli_main()
