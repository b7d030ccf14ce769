"""Model base and registry (counterpart of ``neurst_tpu/models/model.py``).

In the JAX package a model is a spec object around a pure flax module
and parameters travel separately.  Here a model is an ``nn.Module`` that
owns its parameters.  ``build_model`` constructs it without allocating
(on the meta device) and then allocates it, uninitialised, on the
requested device: its weights are loaded through
``utils/param_bridge.load_flat_params``, which fails unless every
parameter is filled.
"""

from typing import Any, Dict, Optional

import torch
from torch import nn

from neurst_tpu_torch.utils.registry import setup_registry

__all__ = ["BaseModel", "build_model", "register_model", "dtype_by_name",
           "resolve_device"]


def dtype_by_name(name: Optional[str]) -> torch.dtype:
    return {None: torch.float32, "float32": torch.float32,
            "fp32": torch.float32, "bfloat16": torch.bfloat16,
            "bf16": torch.bfloat16, "float16": torch.float16}[name]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    current CUDA device.  Without ``device`` and without CUDA this
    raises: the port never carries on on the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU; pass "
                           "device='cpu' to run its plain versions on "
                           "the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class BaseModel(nn.Module):
    """Holds the config ``args``; subclasses build the layers."""

    def __init__(self, args: Dict[str, Any]):
        super().__init__()
        self.args = dict(args or {})

    @staticmethod
    def default_params() -> Dict[str, Any]:
        return {}

    @classmethod
    def build_model_args_by_name(cls, name: str) -> Optional[dict]:
        """A named hparams set (e.g. ``speech_transformer_s``)."""
        return None

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def _create_model(cls, args, src_meta=None, trg_meta=None, device=None):
    device = resolve_device(device)
    with torch.device("meta"):
        model = cls(args, src_meta or {}, trg_meta or {})
    return model.to_empty(device=device).eval()


build_model, register_model = setup_registry(
    "model", base_class=BaseModel, create_fn=_create_model)
