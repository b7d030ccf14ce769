"""Model base and registry (counterpart of ``neurst_tpu/models/model.py``).

In the JAX package a model is a spec object around a pure flax module
and parameters travel separately.  Here a model is an ``nn.Module`` that
owns its parameters.  ``build_model`` constructs it without allocating
(on the meta device) and then allocates it, uninitialised, on the
requested device: its weights are either loaded through
``utils/param_bridge.load_flat_params``, which fails unless every
parameter is filled, or drawn by ``init_params``.
"""

import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from neurst_tpu_torch.layers.attentions.multi_head_attention import \
    MultiHeadAttention
from neurst_tpu_torch.layers.common_layers import LayerNorm, WordEmbedding
from neurst_tpu_torch.utils.registry import setup_registry

__all__ = ["BaseModel", "build_model", "register_model", "dtype_by_name",
           "resolve_device", "lecun_normal"]


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


def lecun_normal(shape, generator):
    """flax's ``lecun_normal``: a normal truncated at 2 std with variance
    1 / fan_in.  Torch layouts put the output axis first ([out, in] and
    [out, in, kh, kw]), so the fan-in is the size of the rest."""
    fan_in = math.prod(shape[1:])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    draw = torch.empty(shape)
    return nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def _glorot_uniform(shape, generator):
    """flax's ``glorot_uniform`` on an [out, in] weight: uniform with
    variance 2 / (fan_in + fan_out).  The fused attention kernels
    [D, n, N, H] and [N, H, D] are initialised flattened to [in, out], so
    the port's [out, in] Linear weights see the same fans."""
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit


class BaseModel(nn.Module):
    """Holds the config ``args``; subclasses build the layers."""

    def __init__(self, args: Dict[str, Any]):
        super().__init__()
        self.args = dict(args or {})

    @classmethod
    def build_model_args_by_name(cls, name: str) -> Optional[dict]:
        """A named hparams set (e.g. ``speech_transformer_s``)."""
        return None

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
        """Draws every parameter in place with the JAX package's
        initializers: ``glorot_uniform`` for the attention projections,
        ``lecun_normal`` for the other dense and conv kernels,
        ``normal(D^-0.5)`` for embedding and learned position tables,
        ones and zeros for LayerNorm, zeros for biases, the QAT clips
        from the quantization config; a module with
        parameters of another kind draws them in its
        ``init_own_params(generator)``.  Values are drawn on the CPU from
        ``generator`` (a framework cannot match another's random bits;
        the distributions match).  Returns ``dict(named_parameters())``;
        raises if a parameter was left undrawn."""
        glorot = {id(m) for attention in self.modules()
                  if isinstance(attention, MultiHeadAttention)
                  for m in attention.children()}
        filled = set()
        with torch.no_grad():
            for module in self.modules():
                own = dict(module.named_parameters(recurse=False))
                if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                    draw = (_glorot_uniform if id(module) in glorot
                            else lecun_normal)
                    module.weight.copy_(draw(module.weight.shape, generator))
                    if callable(getattr(module, "init_extra_params", None)):
                        module.init_extra_params()  # QAT clips
                elif isinstance(module, LayerNorm):
                    module.scale.fill_(1.0)
                elif isinstance(module, WordEmbedding) and module.int8:
                    # int8 serving placeholders (the JAX init's zeros and
                    # ones); a checkpoint fills them
                    module.weights_q.zero_()
                    module.weights_scale.fill_(1.0)
                    for name, table in own.items():
                        if name == "position_weights":
                            table.copy_(torch.randn(
                                table.shape, generator=generator)
                                * module.embedding_dim ** -0.5)
                elif isinstance(module, WordEmbedding):
                    for table in own.values():
                        if table is not module.bias:
                            table.copy_(torch.randn(
                                table.shape, generator=generator)
                                * module.embedding_dim ** -0.5)
                elif callable(getattr(module, "init_own_params", None)):
                    module.init_own_params(generator)
                else:
                    continue
                for name, p in own.items():
                    if name == "bias":
                        p.zero_()
                    filled.add(id(p))
        missing = [n for n, p in self.named_parameters()
                   if id(p) not in filled]
        if missing:
            raise KeyError(f"init_params has no initializer for {missing}")
        return dict(self.named_parameters())


def _create_model(cls, args, src_meta=None, trg_meta=None, device=None,
                  **metas):
    """``metas``: a model's further vocabulary metas (the multi-task
    speech model's ``asr_meta``)."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = cls(args, src_meta or {}, trg_meta or {}, **metas)
    return model.to_empty(device=device).eval()


build_model, register_model = setup_registry(
    "model", base_class=BaseModel, create_fn=_create_model)
