"""Typed flags with recursive, registry-aware parsing (the port's copy of
``neurst_tpu/utils/flags_core.py``, same semantics).

* ``Flag``: a typed scalar/list flag (INT/BOOL/FLOAT/STRING).  String
  values are YAML-parsed, so dict and list literals can be passed on the
  command line.
* ``ModuleFlag``: a ``{name}.class`` + ``{name}.params`` pair whose
  classes come from a registry.  Once the class is known, its own
  ``class_or_method_args()`` flags are parsed from argv into
  ``{name}.params``, recursively.
* ``COMMON_DATA_ARGS``: shared batching/shape flags.

The parser is hand-rolled over argv (``--key value``, ``--key=value``,
bare boolean flags): the flag set is only known after the classes are
chosen.
"""

import json
import logging
from typing import Any, Dict, List, Optional

import yaml

from neurst_tpu_torch.utils.registry import REGISTRIES, get_registered_class

__all__ = ["Flag", "ModuleFlag", "COMMON_DATA_ARGS", "parse_flags",
           "yaml_load_checking", "get_argv_dict", "verbose_flags"]


class Flag(object):
    """A typed flag definition."""

    class TYPE:
        INTEGER = "int"
        FLOAT = "float"
        STRING = "str"
        BOOLEAN = "bool"

    is_module_flag = False

    def __init__(self, name, dtype=None, default=None, help="",
                 multiple=False, choices=None):
        self.name = name
        self.dtype = dtype or Flag.TYPE.STRING
        self.default = default
        self.help = help
        self.multiple = multiple
        self.choices = choices

    def convert(self, value):
        """Converts a raw (string or python) value to the flag's type."""
        if value is None:
            return None
        if self.multiple:
            if isinstance(value, str):
                value = yaml_load_checking(value)
            if not isinstance(value, (list, tuple)):
                value = [value]
            return [self._convert_one(v) for v in value]
        return self._convert_one(value)

    def _convert_one(self, value):
        if value is None:
            return None
        if self.dtype == Flag.TYPE.INTEGER:
            return int(value)
        if self.dtype == Flag.TYPE.FLOAT:
            return float(value)
        if self.dtype == Flag.TYPE.BOOLEAN:
            if isinstance(value, str):
                return value.strip().lower() in ("true", "1", "yes", "y")
            return bool(value)
        # STRING: YAML-parsed to allow dict/list literal values
        return yaml_load_checking(value)


class ModuleFlag(object):
    """A ``{name}.class`` + ``{name}.params`` flag pair bound to a
    registry."""

    is_module_flag = True

    def __init__(self, name, module_name=None, default=None, help=""):
        self.name = name
        self.module_name = module_name or name
        self.default = default
        self.help = help

    @property
    def cls_key(self):
        return f"{self.name}.class"

    @property
    def params_key(self):
        return f"{self.name}.params"


COMMON_DATA_ARGS = [
    Flag("batch_size", dtype=Flag.TYPE.INTEGER, default=None,
         help="The number of samples (or tokens) per batch (global)."),
    Flag("batch_by_tokens", dtype=Flag.TYPE.BOOLEAN, default=None,
         help="Whether to batch the data by the number of tokens."),
    Flag("shuffle_buffer", dtype=Flag.TYPE.INTEGER, default=None,
         help="The buffer size for data shuffling."),
    Flag("cache_dataset", dtype=Flag.TYPE.BOOLEAN, default=None,
         help="Whether to cache the processed dataset in memory."),
    Flag("max_src_len", dtype=Flag.TYPE.INTEGER, default=None,
         help="The maximum source length of training data."),
    Flag("max_trg_len", dtype=Flag.TYPE.INTEGER, default=None,
         help="The maximum target length of training data."),
    Flag("truncate_src", dtype=Flag.TYPE.BOOLEAN, default=None,
         help="Whether to truncate source to max_src_len."),
    Flag("truncate_trg", dtype=Flag.TYPE.BOOLEAN, default=None,
         help="Whether to truncate target to max_trg_len."),
]


def yaml_load_checking(value):
    """YAML-parses a string value, falling back to the raw string."""
    if not isinstance(value, str):
        return value
    try:
        loaded = yaml.safe_load(value)
    except Exception:
        return value
    # a word YAML reads as null stays the word
    if loaded is None and value.strip() not in ("", "null", "~", "None"):
        return value
    return loaded


def get_argv_dict(argv: List[str]):
    """Scans argv into an ordered {key: raw_value} dict.

    Supports ``--key value``, ``--key=value``, repeated keys (kept as a
    list) and bare boolean flags (value True).  Returns (dict,
    leftovers), the leftovers being positional tokens.
    """
    out: Dict[str, Any] = {}
    leftovers = []
    i, n = 0, len(argv)
    while i < n:
        tok = argv[i]
        if not tok.startswith("--"):
            leftovers.append(tok)
            i += 1
            continue
        body = tok[2:]
        if "=" in body:
            key, val = body.split("=", 1)
            i += 1
        elif i + 1 < n and not argv[i + 1].startswith("--"):
            key, val = body, argv[i + 1]
            i += 2
        else:
            key, val = body, True
            i += 1
        if key not in out:
            out[key] = val
        elif isinstance(out[key], list):
            out[key].append(val)
        else:
            out[key] = [out[key], val]
    return out, leftovers


def _lookup_argv(argv_dict, consumed, *keys):
    for k in keys:
        if k in argv_dict:
            consumed.add(k)
            return argv_dict[k]
    return None


def _parse_flag_list(flag_list, argv_dict, consumed, existing: dict):
    """Parses Flags/ModuleFlags against an argv dict over ``existing``
    (config-file values); the command line wins."""
    result = dict(existing or {})
    for f in flag_list:
        if f.is_module_flag:
            _parse_module_flag(f, argv_dict, consumed, result)
            continue
        raw = _lookup_argv(argv_dict, consumed, f.name)
        if raw is not None:
            result[f.name] = f.convert(raw)
        else:
            result[f.name] = f.convert(result.get(f.name, f.default))
        if f.choices and result[f.name] is not None \
                and result[f.name] not in f.choices:
            raise ValueError(f"--{f.name} must be one of {f.choices}, "
                             f"got {result[f.name]}")
    return result


def _parse_module_flag(mf: ModuleFlag, argv_dict, consumed, result: dict):
    """Picks the class of a ModuleFlag, then parses that class's own
    flags into ``{name}.params``."""
    # class: --{name} or --{name}.class > existing config > default
    raw_cls = _lookup_argv(argv_dict, consumed, mf.name, mf.cls_key)
    cls_name = raw_cls if raw_cls is not None else result.get(
        mf.cls_key, result.get(mf.name))
    existing_params = dict(result.get(mf.params_key) or {})
    # a whole {class: ..., params: ...} dict under the short name: its
    # params survive even when the command line re-states the class
    short = result.get(mf.name)
    if isinstance(short, dict):
        existing_params = _deep_merge(existing_params,
                                      short.get("params") or {})
        if cls_name is raw_cls is None or isinstance(cls_name, dict):
            cls_name = short.get("class")
    if isinstance(cls_name, dict):
        cls_name = cls_name.get("class")
    if cls_name is None:
        cls_name = mf.default
    result.pop(mf.name, None)
    result[mf.cls_key] = cls_name
    raw_params = _lookup_argv(argv_dict, consumed, mf.params_key)
    if raw_params is not None:
        parsed = yaml_load_checking(raw_params)
        if not isinstance(parsed, dict):
            raise ValueError(f"--{mf.params_key} must be a YAML dict")
        existing_params = _deep_merge(existing_params, parsed)
    if cls_name is None:
        result[mf.params_key] = existing_params
        return
    cls = get_registered_class(cls_name, mf.module_name) \
        if mf.module_name in REGISTRIES else None
    if cls is not None and hasattr(cls, "class_or_method_args"):
        result[mf.params_key] = _parse_flag_list(
            cls.class_or_method_args(), argv_dict, consumed, existing_params)
    else:
        result[mf.params_key] = existing_params


def _deep_merge(base: dict, update: dict) -> dict:
    out = dict(base)
    for k, v in (update or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def parse_flags(flag_list, argv: List[str],
                existing: Optional[dict] = None) -> dict:
    """Parses argv against ``flag_list`` over ``existing`` (config-file
    values).  Returns the resolved nested dict."""
    argv_dict, _ = get_argv_dict(argv)
    consumed: set = set()
    result = _parse_flag_list(flag_list, argv_dict, consumed, existing or {})
    for k in argv_dict:
        if k not in consumed:
            logging.debug("Unrecognized flag: --%s", k)
    return result


def verbose_flags(args: dict, title="Parsed flags"):
    logging.info("========== %s ==========\n%s", title,
                 json.dumps(args, indent=2, default=str))
