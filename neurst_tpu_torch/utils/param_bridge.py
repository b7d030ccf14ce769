"""Carries the JAX package's parameters into the port.

``flat_to_state_dict(flat, model)`` takes ``neurst_tpu``'s flat
parameters (name -> numpy array, as its ``flatten_params`` gives them
and as its ``.npz`` checkpoints store them) and returns ``model``'s
``state_dict``.  Names are the same paths with ``/`` -> ``.``; the
layouts change as follows:

* dense kernels: flax ``[in, out]`` -> ``nn.Linear`` ``[out, in]``
  (the port keeps torch's layout and transposes here);
* fused attention projections: ``qkv_transform`` / ``q_transform`` /
  ``kv_transform`` kernels ``[D, n, N, H]`` -> ``[n * N * H, D]``, their
  biases ``[n, N, H]`` -> ``[n * N * H]``; ``output_transform`` kernel
  ``[N, H, D]`` -> ``[D, N * H]``;
* conv kernels ``[kh, kw, in, out]`` -> ``[out, in, kh, kw]``;
* the scan-stacked layout ``<stack>/layers/layer/...`` (a leading
  layer axis) is unstacked into ``<stack>/layer_<i>/...``;
* bfloat16 arrays (also raw ``|V2`` bytes) become float32, exactly.

It raises on any name it does not consume and on any port parameter it
did not fill.  Gradients share their parameters' names and shapes, so a
JAX gradient tree maps onto the port's names the same way.
"""

import re
from typing import Dict

import numpy as np
import torch

from neurst_tpu_torch.utils.checkpoints import bf16_bytes_to_float32

__all__ = ["flat_to_state_dict", "load_flat_params"]

_SCAN_RE = re.compile(r"^(.*)/layers/layer/(.*)$")
_FUSED_PROJ = ("qkv_transform", "q_transform", "kv_transform")


def _unstack_scan_layers(flat: Dict[str, np.ndarray]):
    out = {}
    for name, value in flat.items():
        m = _SCAN_RE.match(name)
        if m is None:
            out[name] = value
            continue
        for i, layer_value in enumerate(np.asarray(value)):
            out[f"{m.group(1)}/layer_{i}/{m.group(2)}"] = layer_value
    return out


def _to_torch_layout(name: str, a: np.ndarray):
    """(torch name, array in the port's layout) for one flax leaf."""
    parts = name.split("/")
    module, leaf = (parts[-2] if len(parts) > 1 else ""), parts[-1]
    if leaf == "kernel":
        if module in _FUSED_PROJ:
            a = a.reshape(a.shape[0], -1).T
        elif module == "output_transform":
            a = a.reshape(-1, a.shape[-1]).T
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:
            a = a.T
        else:
            raise ValueError(f"{name}: no port layout for a kernel of "
                             f"shape {a.shape}")
        leaf = "weight"
    elif leaf == "bias" and module in _FUSED_PROJ:
        a = a.reshape(-1)
    return ".".join(parts[:-1] + [leaf]), a


def flat_to_state_dict(flat: Dict[str, np.ndarray], model: torch.nn.Module
                       ) -> Dict[str, torch.Tensor]:
    """``neurst_tpu`` flat params -> ``model``'s state_dict (float32 CPU
    tensors).  Raises on unconsumed names, shape mismatches and port
    parameters left unfilled."""
    target = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    state, unknown = {}, []
    for name, value in _unstack_scan_layers(flat).items():
        a = bf16_bytes_to_float32(np.asarray(value)).astype(np.float32)
        torch_name, a = _to_torch_layout(name, a)
        if torch_name not in target:
            unknown.append(name)
            continue
        if tuple(a.shape) != target[torch_name]:
            raise ValueError(f"{name}: shape {a.shape} does not fit "
                             f"{torch_name} {target[torch_name]}")
        state[torch_name] = torch.from_numpy(np.ascontiguousarray(a))
    if unknown:
        raise KeyError(f"parameters the port does not have: "
                       f"{sorted(unknown)}")
    missing = sorted(set(target) - set(state))
    if missing:
        raise KeyError(f"port parameters not filled: {missing}")
    return state


def load_flat_params(model: torch.nn.Module, flat: Dict[str, np.ndarray]):
    """Loads ``neurst_tpu`` flat params into ``model`` (on its device and
    in its parameters' dtypes).  Returns ``model``."""
    model.load_state_dict(flat_to_state_dict(flat, model))
    return model
