"""Named hyper-parameter sets (the port's counterpart of
``neurst_tpu/utils/hparams_sets.py``): a name resolves to the config dict
(model, optimizer, learning-rate schedule) registered under it, or else
to the one a registered model's ``build_model_args_by_name`` returns for
it (parametric names such as ``transformer_512_6e_6d_8h_dp0.1``)."""

import logging
from typing import Callable, Dict, Optional

from neurst_tpu_torch.utils.registry import REGISTRIES

__all__ = ["register_hparams_set", "get_hyper_parameters",
           "registered_hparams_names"]

_HPARAMS_SETS: Dict[str, Callable[[], dict]] = {}


def register_hparams_set(name):
    """Decorator: ``@register_hparams_set("transformer_base")``."""
    def wrap(fn):
        if name in _HPARAMS_SETS:
            raise LookupError(f"hparams set '{name}' already registered")
        _HPARAMS_SETS[name] = fn
        return fn
    return wrap


def registered_hparams_names():
    """The names registered with ``register_hparams_set``, sorted."""
    return sorted(_HPARAMS_SETS)


def get_hyper_parameters(name: Optional[str]) -> dict:
    """The config dict of an hparams-set name ({} if name is None)."""
    if not name:
        return {}
    if name in _HPARAMS_SETS:
        return _HPARAMS_SETS[name]() or {}
    for cls in dict.fromkeys((REGISTRIES.get("model") or {}).values()):
        try:
            params = cls.build_model_args_by_name(name)
        except Exception:
            params = None
        if params:
            logging.info("hparams_set '%s' resolved by %s", name,
                         cls.__name__)
            return params
    raise LookupError(f"Unknown hparams set: {name}")
