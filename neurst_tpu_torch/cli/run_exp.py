"""The main CLI of the port:
``python -m neurst_tpu_torch.cli.run_exp --entry
predict|train|eval|sequence_evaluator|validation ...``
(counterpart of ``neurst_tpu/cli/run_exp.py``).

Config precedence as in the JAX package: command line > ``config_paths``
files > ``hparams_set`` > the model dir's ``model_configs.yml``; the
top-level config seeds ``entry.params``.  ``--device`` picks the card
(the current CUDA device by default; without CUDA it raises unless
``--device cpu`` is given, which runs every kernel's plain version).

Flags of features the port lacks raise ``NotImplementedError`` when set:
QAT and int8 serving, ``--include`` plug-ins, multi-host initialization,
the XLA compilation cache, ``enable_xla: true``, NaN checks and any
``distribution_strategy`` but one device.  The ``predict``, ``train``, ``eval``, ``sequence_evaluator``
and ``validation`` entries are ported (the recipes' ``trainer`` is
``train`` by its class name); the trainer refuses the features it lacks
itself (``exps/trainer.py``).
"""

import logging
import sys

import neurst_tpu_torch  # noqa: F401 - fills the registries
from neurst_tpu_torch.data.datasets.dataset import build_dataset
from neurst_tpu_torch.exps.base_experiment import build_exp
from neurst_tpu_torch.models.model import resolve_device
from neurst_tpu_torch.tasks.task import build_task
from neurst_tpu_torch.utils import flags_core
from neurst_tpu_torch.utils.configurable import (
    ModelConfigs, deep_merge_dict, flatten_string_list, load_from_config_path,
    strip_training_only_model_flags)
from neurst_tpu_torch.utils.flags_core import Flag, ModuleFlag
from neurst_tpu_torch.utils.hparams_sets import get_hyper_parameters

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
         help="Kept for recipe compatibility: none or one_device (any "
              "other strategy raises)."),
    Flag("dtype", dtype=Flag.TYPE.STRING, default=None,
         help="The computation dtype (bfloat16/float32)."),
    Flag("enable_check_numerics", dtype=Flag.TYPE.BOOLEAN, default=None,
         help="NaN checking (not ported)."),
    Flag("enable_xla", dtype=Flag.TYPE.BOOLEAN, default=None,
         help="Kept for recipe compatibility: XLA compilation is not "
              "ported (true raises)."),
    Flag("enable_quant", dtype=Flag.TYPE.BOOLEAN, default=False,
         help="Quantization-aware training (not ported)."),
    Flag("quant_params", dtype=Flag.TYPE.STRING, default=None,
         help="A dict of parameters for quantization (not ported)."),
    Flag("int8_serving", dtype=Flag.TYPE.BOOLEAN, default=False,
         help="Serve with int8-stored dense kernels (not ported)."),
    Flag("int8_activations", dtype=Flag.TYPE.BOOLEAN, default=False,
         help="int8 activations with --int8_serving (not ported)."),
    Flag("int8_static_activations", dtype=Flag.TYPE.BOOLEAN, default=False,
         help="Static int8 activation scales (not ported)."),
    Flag("int8_calibration_batches", dtype=Flag.TYPE.INTEGER, default=4,
         help="Batches that calibrate static int8 scales (not ported)."),
    Flag("include", dtype=Flag.TYPE.STRING, default=None, multiple=True,
         help="Plug-in files with custom @register components (not "
              "ported)."),
    Flag("seed", dtype=Flag.TYPE.INTEGER, default=0,
         help="The global random seed."),
    Flag("distributed_init", dtype=Flag.TYPE.BOOLEAN, default=None,
         help="Multi-host initialization (not ported)."),
    Flag("compilation_cache_dir", dtype=Flag.TYPE.STRING, default=None,
         help="The JAX package's XLA compilation cache (not ported)."),
    Flag("worker_hosts", dtype=Flag.TYPE.STRING, default=None,
         help="Comma-separated worker addresses (not ported)."),
    Flag("task_index", dtype=Flag.TYPE.INTEGER, default=None,
         help="This process's index into worker_hosts (not ported)."),
    Flag("device", dtype=Flag.TYPE.STRING, default=None,
         help="The torch device to run on ('cpu' runs the plain versions "
              "of the kernels); the current CUDA device by default."),
    ModuleFlag("entry", "entry", help="The program entry."),
    ModuleFlag("task", "task", help="The binding task."),
    ModuleFlag("model", "model", help="The model."),
    ModuleFlag("dataset", "dataset", help="The dataset."),
]

# flags of features the port does not have, and the value that means off
_UNPORTED = {"enable_quant": False, "quant_params": None,
             "int8_serving": False, "int8_activations": False,
             "int8_static_activations": False, "include": None,
             "distributed_init": None, "worker_hosts": None,
             "task_index": None, "compilation_cache_dir": None,
             "enable_check_numerics": None, "enable_xla": (None, False)}
# the strategies that mean one device, which is what the port runs
_ONE_DEVICE_STRATEGIES = (None, "", "none", "one_device", "onedevice")


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


def parse_and_merge(argv):
    """Resolves the full configuration from argv."""
    argv_dict, _ = flags_core.get_argv_dict(argv)
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


def run_experiment(args):
    on = sorted(k for k, off in _UNPORTED.items()
                if args.get(k) not in (off if isinstance(off, tuple)
                                       else (off,)))
    if on:
        raise NotImplementedError(f"not ported: --{', --'.join(on)}")
    strategy = args.get("distribution_strategy")
    if (strategy.lower() if isinstance(strategy, str) else strategy) \
            not in _ONE_DEVICE_STRATEGIES:
        raise NotImplementedError(f"distribution_strategy {strategy} is not "
                                  f"ported (one device only)")
    device = resolve_device(args.get("device"))
    task = build_task(args)
    custom_dataset = build_dataset(args) if args.get("dataset.class") \
        else None
    model = None
    if args.get("model.class"):
        model_params = strip_training_only_model_flags(
            args.get("model.params"))
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
                         "sequence_evaluator or validation).")
    flags_core.verbose_flags(args)
    return run_experiment(args)


if __name__ == "__main__":
    cli_main()
