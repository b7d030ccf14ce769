"""Config-file loading and merging, and the model dir's saved config (the
port's copy of ``neurst_tpu/utils/configurable.py``).

``load_from_config_path`` merges YAML/JSON files in order;
``deep_merge_dict`` merges recursively; ``ModelConfigs`` reads and writes
``model_configs.yml`` in a model dir, so inference rebuilds the exact
task and model with no flags.  Both packages' trainers write that file
in the same YAML, and each package reads the other's.
"""

import copy
import json
import logging
import os
from typing import List, Optional, Union

import yaml

__all__ = ["deep_merge_dict", "load_from_config_path", "ModelConfigs",
           "flatten_string_list", "strip_training_only_model_flags"]

MODEL_CONFIG_YAML_FILENAME = "model_configs.yml"


def flatten_string_list(paths: Union[str, List[str], None]) -> List[str]:
    """Accepts 'a,b', ['a', 'b,c'] etc. and returns a flat list."""
    if paths is None:
        return []
    if isinstance(paths, str):
        paths = [paths]
    out = []
    for p in paths:
        if isinstance(p, str):
            out.extend(x.strip() for x in p.split(",") if x.strip())
        elif isinstance(p, (list, tuple)):
            out.extend(flatten_string_list(list(p)))
        elif p is not None:
            out.append(p)
    return out


def strip_training_only_model_flags(model_params: Optional[dict]) -> dict:
    """Drops the model flags that only shape the training step (pipeline
    stages and micro-batches): inference rebuilds the model without
    them."""
    return {k: v for k, v in (model_params or {}).items()
            if not k.endswith((".pipeline_stages",
                               ".pipeline_microbatches"))}


def deep_merge_dict(base: dict, update: Optional[dict],
                    local_overwrite: bool = True) -> dict:
    """Recursively merges ``update`` into ``base``; update wins on
    conflicts.  With ``local_overwrite=False`` a copy is returned and the
    inputs are kept intact."""
    if not local_overwrite:
        base = copy.deepcopy(base)
    if update is None:
        return base
    for k, v in update.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            deep_merge_dict(base[k], v, local_overwrite=True)
        else:
            base[k] = copy.deepcopy(v) if isinstance(v, (dict, list)) else v
    return base


def _load_file(path: str):
    with open(path, "r", encoding="utf-8") as f:
        if path.endswith(".json"):
            return json.load(f)
        return yaml.safe_load(f)


def load_from_config_path(config_paths, ignore_missing: bool = False) -> dict:
    """Loads and merges a list of YAML/JSON config files, in order."""
    merged: dict = {}
    for path in flatten_string_list(config_paths):
        if not os.path.exists(path):
            if ignore_missing:
                logging.warning("Config path not found (ignored): %s", path)
                continue
            raise FileNotFoundError(f"Config file not found: {path}")
        logging.info("Loading config from %s", path)
        cfg = _load_file(path)
        if cfg:
            if not isinstance(cfg, dict):
                raise ValueError(f"Config file {path} must contain a mapping")
            merged = deep_merge_dict(merged, cfg)
    return merged


class ModelConfigs(object):
    """The full resolved configuration kept in a model directory (written
    by a trainer; JSON text is valid YAML too)."""

    @staticmethod
    def dump(model_configs: dict, output_dir: str):
        """Writes ``model_configs.yml`` into ``output_dir`` atomically."""
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.join(output_dir, MODEL_CONFIG_YAML_FILENAME)
        with open(path + ".tmp", "w", encoding="utf-8") as f:
            yaml.safe_dump(_yaml_safe(model_configs), f,
                           default_flow_style=False, sort_keys=False)
        os.replace(path + ".tmp", path)
        logging.info("Saved model configs to %s", path)

    @staticmethod
    def load(model_dir: str) -> dict:
        path = model_dir
        if os.path.isdir(model_dir):
            path = os.path.join(model_dir, MODEL_CONFIG_YAML_FILENAME)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"Could not find {MODEL_CONFIG_YAML_FILENAME} under "
                f"{model_dir}")
        cfg = _load_file(path)
        logging.info("Loaded model configs from %s", path)
        return cfg or {}

    @staticmethod
    def exists(model_dir: str) -> bool:
        return os.path.exists(
            os.path.join(model_dir, MODEL_CONFIG_YAML_FILENAME))


def _yaml_safe(x):
    """numpy scalars and tuples -> plain Python for YAML."""
    if isinstance(x, dict):
        return {str(k): _yaml_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_yaml_safe(v) for v in x]
    if hasattr(x, "item") and callable(getattr(x, "item")):
        try:
            return x.item()
        except (TypeError, ValueError):
            return str(x)
    return x
