"""Carries the JAX package's parameters into the port.

``flat_to_state_dict(flat, model)`` takes ``neurst_tpu``'s flat
parameters (name -> numpy array, as its ``flatten_params`` gives them
and as its ``.npz`` checkpoints store them) and returns ``model``'s
``state_dict``.  Names are the same paths with ``/`` -> ``.``: the
modalities of both models (the speech model's ``input_audio_modality``,
the text model's ``input_symbol_modality`` or, with a shared table,
``shared_symbol_modality``, and ``target_symbol_modality``), the encoder
and decoder layers and their attention projections; the untied
softmax's ``output_linear`` kernel, a learned position table
(``<modality>/position_weights``, taken as it is), and LightConv's
``layer_<i>_conv`` layers (``in_proj``, ``out_proj``, the dynamic
convolution's ``conv_weight_linear`` as dense kernels; the lightweight
``conv_shared_weight`` [H, K] as it is); the pretrained trunks' names:
BERT's (``word_embedding``, ``position_embedding``,
``token_type_embedding`` as they are, ``emb_ln``, ``pooler``, and
CTNMT's ``bert/`` sub-tree with its ``ds_gate_w`` / ``ds_gate_u``),
GPT-2's decoder without ``cross_attention``, and wav2vec 2.0's
``feature_conv_<i>``, ``feature_gn``, ``feature_proj(_ln)``,
``pos_conv`` and ``post_extract_ln``.  The layouts change as
follows:

* dense kernels: flax ``[in, out]`` -> ``nn.Linear`` ``[out, in]``
  (the port keeps torch's layout and transposes here);
* fused attention projections: ``qkv_transform`` / ``q_transform`` /
  ``kv_transform`` kernels ``[D, n, N, H]`` -> ``[n * N * H, D]``, their
  biases ``[n, N, H]`` -> ``[n * N * H]``; ``output_transform`` kernel
  ``[N, H, D]`` -> ``[D, N * H]``;
* conv kernels ``[kh, kw, in, out]`` -> ``[out, in, kh, kw]``, and 1-D
  conv kernels ``[k, in / groups, out]`` -> ``[out, in / groups, k]``
  (wav2vec 2.0's feature convolutions and grouped ``pos_conv``);
* the scan-stacked layout ``<stack>/layers/layer/...`` (a leading
  layer axis) is unstacked into ``<stack>/layer_<i>/...``, and so are the
  pipeline's ``<stack>/layers/pipeline/stages/layers/layer/...`` (leading
  [stages, layers a stage]: stage s, layer j is layer s * P + j) and the
  MoE block scan ``<stack>/layers/block_layer_<j>/...`` (block b holds
  layer b * f + j);
* the MoE layers' ``router_kernel`` [H, E] and stacked expert weights
  ``expert_dense{1,2}_{kernel,bias}`` [E, ...] keep the JAX layouts;
* QAT's ``kernel_clip_max`` / ``output_clip_max`` scalars are taken as
  they are; int8 serving's ``kernel_q`` (int8, kept int8) has its
  kernel's layout and a fused projection's ``kernel_scale`` [n, N, H]
  becomes [n * N * H];
* bfloat16 arrays (also raw ``|V2`` bytes) become float32, exactly.

It raises on any name it does not consume and on any port parameter it
did not fill.  Gradients share their parameters' names and shapes, so a
JAX gradient tree maps onto the port's names the same way.

``state_dict_to_flat(model)`` is the exact inverse: the port's parameters
as ``neurst_tpu`` flat params in float32, in the per-layer layout
``<stack>/layer_<i>/...``, which the JAX package's ``restore_into``
bridges to its scan-stacked models.  The port's checkpoints are written
through it, so the JAX package reads them.
"""

import re
from typing import Dict, Optional

import numpy as np
import torch

from neurst_tpu_torch.utils.checkpoints import bf16_bytes_to_float32

__all__ = ["flat_to_state_dict", "load_flat_params", "state_dict_to_flat",
           "jax_layout", "to_jax_name", "to_torch_layout",
           "unstack_scan_layers"]

_PIPE_RE = re.compile(r"^(.*)/layers/pipeline/stages/layers/layer/(.*)$")
_SCAN_RE = re.compile(r"^(.*)/layers/layer/(.*)$")
_BLOCK_RE = re.compile(r"^(.*)/layers/block_layer_(\d+)/(.*)$")
_FUSED_PROJ = ("qkv_transform", "q_transform", "kv_transform")
# the dense kernels' leaves: the float kernel and the int8 serving one
_KERNELS = ("kernel", "kernel_q")


def _contiguous(a):
    """A C-contiguous copy of ``a`` of the same shape (a 0-d scalar, a
    QAT clip, stays 0-d)."""
    return np.ascontiguousarray(a).reshape(np.shape(a))


def unstack_scan_layers(flat: Dict[str, np.ndarray]):
    """The per-layer names of the scan layouts: the pipeline's
    ``<stack>/layers/pipeline/stages/layers/layer/`` [S, P, ...], whose
    stage s holds layers s * P + j, ``<stack>/layers/layer/`` [L, ...]
    and the MoE block scan ``<stack>/layers/block_layer_<j>/`` [L / f,
    ...], whose block b holds layers b * f + j (f the number of block
    layers under the stack)."""
    block_size = {}
    for name in flat:
        m = _BLOCK_RE.match(name)
        if m is not None:
            block_size[m.group(1)] = max(block_size.get(m.group(1), 0),
                                         int(m.group(2)) + 1)
    out = {}
    for name, value in flat.items():
        m = _PIPE_RE.match(name)
        if m is not None:
            value = np.asarray(value)
            for i, layer_value in enumerate(
                    value.reshape((-1,) + value.shape[2:])):
                out[f"{m.group(1)}/layer_{i}/{m.group(2)}"] = layer_value
            continue
        m = _SCAN_RE.match(name)
        if m is not None:
            for i, layer_value in enumerate(np.asarray(value)):
                out[f"{m.group(1)}/layer_{i}/{m.group(2)}"] = layer_value
            continue
        m = _BLOCK_RE.match(name)
        if m is not None:
            f, j = block_size[m.group(1)], int(m.group(2))
            for b, layer_value in enumerate(np.asarray(value)):
                out[f"{m.group(1)}/layer_{b * f + j}/{m.group(3)}"] = \
                    layer_value
            continue
        out[name] = value
    return out


def _to_torch_layout(name: str, a: np.ndarray):
    """(torch name, array in the port's layout) for one flax leaf."""
    parts = name.split("/")
    module, leaf = (parts[-2] if len(parts) > 1 else ""), parts[-1]
    if leaf in _KERNELS:
        if module in _FUSED_PROJ:
            a = a.reshape(a.shape[0], -1).T
        elif module == "output_transform":
            a = a.reshape(-1, a.shape[-1]).T
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 3:
            a = a.transpose(2, 1, 0)
        elif a.ndim == 2:
            a = a.T
        else:
            raise ValueError(f"{name}: no port layout for a kernel of "
                             f"shape {a.shape}")
        if leaf == "kernel":
            leaf = "weight"
    elif leaf in ("bias", "kernel_scale") and module in _FUSED_PROJ:
        a = a.reshape(-1)
    return ".".join(parts[:-1] + [leaf]), a


def to_torch_layout(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``neurst_tpu`` flat arrays (any subset, e.g. per-parameter masks)
    -> {port name: array in the port's layout}, unchecked against a
    model."""
    return dict(_to_torch_layout(name, np.asarray(value))
                for name, value in unstack_scan_layers(flat).items())


def flat_to_state_dict(flat: Dict[str, np.ndarray], model: torch.nn.Module
                       ) -> Dict[str, torch.Tensor]:
    """``neurst_tpu`` flat params -> ``model``'s state_dict (float32 CPU
    tensors).  Raises on unconsumed names, shape mismatches and port
    parameters left unfilled."""
    target = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    state, unknown = {}, []
    for name, value in unstack_scan_layers(flat).items():
        a = np.asarray(value)
        a = a if a.dtype == np.int8 else \
            bf16_bytes_to_float32(a).astype(np.float32)
        torch_name, a = _to_torch_layout(name, a)
        if torch_name not in target:
            unknown.append(name)
            continue
        if tuple(a.shape) != target[torch_name]:
            raise ValueError(f"{name}: shape {a.shape} does not fit "
                             f"{torch_name} {target[torch_name]}")
        state[torch_name] = torch.from_numpy(_contiguous(a))
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


def _to_jax_layout(name: str, a: np.ndarray, attention: torch.nn.Module,
                   shard: bool = False):
    """(flax name, array in flax's layout, a view where the layout allows)
    for one port parameter, the inverse of ``_to_torch_layout``;
    ``attention`` is the module two levels up (the attention layer of a
    projection).  ``shard``: ``a`` is this rank's tensor-parallel part."""
    parts = name.split(".")
    owner, leaf = (parts[-2] if len(parts) > 1 else ""), parts[-1]
    if owner in _FUSED_PROJ or owner == "output_transform":
        # a whole tensor of a tensor-parallel layer holds all its ranks'
        # heads, a rank's part its own
        heads = attention.num_heads * (
            1 if shard else getattr(attention, "tp_size", 1))
        head_dim = attention.head_dim
    if leaf in ("weight", "kernel_q"):
        if owner in _FUSED_PROJ:
            a = a.T.reshape(a.shape[1], -1, heads, head_dim)
        elif owner == "output_transform":
            a = a.T.reshape(heads, head_dim, a.shape[0])
        elif a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        elif a.ndim == 3:
            a = a.transpose(2, 1, 0)
        elif a.ndim == 2:
            a = a.T
        else:
            raise ValueError(f"{name}: no flax layout for a weight of "
                             f"shape {a.shape}")
        if leaf == "weight":
            leaf = "kernel"
    elif leaf in ("bias", "kernel_scale") and owner in _FUSED_PROJ:
        a = a.reshape(-1, heads, head_dim)
    return "/".join(parts[:-1] + [leaf]), a


def _layout_owner(model: torch.nn.Module, name: str) -> torch.nn.Module:
    return model.get_submodule(name.rsplit(".", 2)[0]) \
        if name.count(".") >= 2 else model


def state_dict_to_flat(model: torch.nn.Module,
                       tensors: Optional[Dict[str, torch.Tensor]] = None,
                       shards: bool = False) -> Dict[str, np.ndarray]:
    """``model``'s parameters (or ``tensors``, named as they are, e.g.
    the float32 master of bf16 params) -> ``neurst_tpu`` flat params
    (float32 numpy arrays, per-layer names), the inverse of
    ``flat_to_state_dict``.  ``shards``: the tensors are this rank's
    tensor-parallel parts, each carried to the part of the JAX-layout
    array that it is."""
    if tensors is None:
        tensors = dict(model.named_parameters())
    flat = {}
    for name, p in tensors.items():
        p = p.detach()
        jax_name, a = _to_jax_layout(
            name, (p.float() if p.is_floating_point() else p).cpu().numpy(),
            _layout_owner(model, name), shards)
        flat[jax_name] = _contiguous(a)
    return flat


def jax_layout(model: torch.nn.Module, name: str, shape,
               shard: bool = False):
    """(flax name, shape in flax's layout) of port parameter ``name`` of
    ``shape`` (``shard`` as in ``state_dict_to_flat``), without its
    data."""
    jax_name, a = _to_jax_layout(
        name, np.broadcast_to(np.float32(0), tuple(shape)),
        _layout_owner(model, name), shard)
    return jax_name, tuple(a.shape)


def to_jax_name(name: str) -> str:
    """The JAX package's flat name of a port parameter (every port
    ``weight`` is a dense or conv kernel)."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)
