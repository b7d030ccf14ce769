"""Named hyper-parameter sets (the port's counterpart of
``neurst_tpu/utils/hparams_sets.py``): a name resolves to the config dict
(model, optimizer, learning-rate schedule) that a registered model's
``build_model_args_by_name`` returns for it."""

import logging
from typing import Optional

from neurst_tpu_torch.utils.registry import REGISTRIES

__all__ = ["get_hyper_parameters"]


def get_hyper_parameters(name: Optional[str]) -> dict:
    """The config dict of an hparams-set name ({} if name is None)."""
    if not name:
        return {}
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
