"""Common transformer building blocks (counterpart of
``neurst_tpu/layers/common_layers.py``).

Parameters are stored in float32 (or bf16 after
``utils/param_policy.cast_params_for_inference`` or, for training,
``optimizers/master_weights.cast_params_bf16``) and cast to the compute
``dtype`` where they are used, as the flax modules do.  Dense
weights use ``torch.nn.Linear``'s ``[out, in]`` layout;
``utils/param_bridge`` transposes the flax ``[in, out]`` kernels.
Training threads ``is_training`` and a dropout key
(``utils/rng.DropoutKey``, one stream per site) through every module, as
the flax modules thread their 'dropout' rng; ``apply_dropout`` is the
port of ``neurst_tpu``'s, on the mask kernel of ``ops/fused_dropout.py``.
Modules are built without drawing random numbers; their
weights come from ``utils/param_bridge`` or the model's ``init_params``.
"""

import math

import torch
from torch import nn
from torch.nn import functional as F

from neurst_tpu_torch.ops.fused_dropout import dropout, quantized_site
from neurst_tpu_torch.ops.fused_ffn import fused_ffn, fused_ffn_available

__all__ = ["LayerNorm", "TransformerFFN", "WordEmbedding",
           "sinusoidal_position_signal", "sinusoidal_position_signal_at",
           "linear", "apply_dropout",
           "activation_by_name"]

_ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_approx": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "silu": F.silu,
    "tanh": torch.tanh,
}


def activation_by_name(name):
    """The JAX package's activations (``jax.nn.gelu`` approximates with
    tanh unless told not to, so "gelu" is the exact erf form and
    "gelu_approx" the tanh one; swish and silu are x * sigmoid(x));
    None and "linear" are the identity."""
    if name is None or name == "linear":
        return lambda x: x
    if name not in _ACTIVATIONS:
        raise KeyError(f"unknown activation {name!r}")
    return _ACTIVATIONS[name]


def apply_dropout(x, rate: float, is_training: bool, key=None):
    """Inverted dropout with the site's ``key``: the identity outside
    training or at rate 0.  At a site the TPU path sends through its
    mask kernel (>= 65536 elements, last dim % 128 == 0) the rate is
    quantized to 1/256, elsewhere exact, as in ``neurst_tpu``'s
    ``apply_dropout``.  A training rate > 0 without a key raises."""
    if not is_training or not rate:
        return x
    if key is None:
        raise ValueError(f"dropout rate {rate} in training needs a dropout "
                         f"key (utils.rng.DropoutKey)")
    return dropout(x, rate, key, quantized_site(x.shape))


def linear(layer: nn.Linear, x, dtype):
    """``layer`` applied in the compute dtype (weights cast at use)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class LayerNorm(nn.Module):
    """LayerNorm with float32 statistics regardless of compute dtype;
    parameters ``scale`` and ``bias`` as in flax."""

    def __init__(self, dim: int, epsilon: float = 1e-6,
                 dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        y = F.layer_norm(x.float(), x.shape[-1:], self.scale.float(),
                         self.bias.float(), self.epsilon)
        return y.to(self.dtype)


class TransformerFFN(nn.Module):
    """dense1 -> activation -> dropout -> dense2.  Where the JAX
    package's gate says so (``ops/fused_ffn.fused_ffn_available``: relu,
    training at enough rows) the fused FFN kernels run it, else the plain
    composite; both take the same parameters and the same dropout
    site."""

    def __init__(self, input_size: int, filter_size: int, output_size: int,
                 activation: str = "relu", dropout_rate: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.activation = activation
        self._activate = activation_by_name(activation)
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.dense1 = nn.Linear(input_size, filter_size)
        self.dense2 = nn.Linear(filter_size, output_size)

    def forward(self, x, is_training: bool = False, dropout_key=None):
        rate = self.dropout_rate if is_training else 0.0
        rows = x.numel() // x.shape[-1]
        if fused_ffn_available(x.shape[-1], self.dense1.out_features,
                               self.activation, rows, is_training, rate):
            return fused_ffn(x.to(self.dtype), self.dense1.weight,
                             self.dense1.bias, self.dense2.weight,
                             self.dense2.bias, rate,
                             dropout_key if rate else None)
        h = self._activate(linear(self.dense1, x, self.dtype))
        h = apply_dropout(h, self.dropout_rate, is_training, dropout_key)
        return linear(self.dense2, h, self.dtype)


def sinusoidal_position_signal(length: int, channels: int, start: int = 0,
                               min_timescale: float = 1.0,
                               max_timescale: float = 1.0e4,
                               dtype=torch.float32, device=None):
    """T2T-layout sinusoids: [length, channels] = concat(sin, cos), the
    odd channel zero-padded."""
    position = torch.arange(length, dtype=torch.float32,
                            device=device) + float(start)
    return sinusoidal_position_signal_at(position, channels, min_timescale,
                                         max_timescale, dtype)


def sinusoidal_position_signal_at(positions, channels: int,
                                  min_timescale: float = 1.0,
                                  max_timescale: float = 1.0e4,
                                  dtype=torch.float32):
    """The same sinusoids at explicit ``positions`` [...] (a speculative
    decode's per-row times) -> [..., channels]."""
    position = positions.float()
    device = position.device
    num_timescales = channels // 2
    log_timescale_increment = (
        math.log(float(max_timescale) / float(min_timescale))
        / max(float(num_timescales) - 1.0, 1.0))
    inv_timescales = min_timescale * torch.exp(
        torch.arange(num_timescales, dtype=torch.float32, device=device)
        * -log_timescale_increment)
    scaled_time = position[..., None] * inv_timescales
    signal = torch.cat([torch.sin(scaled_time), torch.cos(scaled_time)],
                       dim=-1)
    if channels % 2:
        signal = F.pad(signal, (0, 1))
    return signal.to(dtype)


class WordEmbedding(nn.Module):
    """Embedding table ``weights`` [V, D] with the tied pre-softmax
    projection ``attend`` (+ ``bias`` [V] when the softmax is shared).
    ``timing='sinusoids'`` scales by sqrt(D) and adds the signal;
    ``timing='emb'`` adds rows of a learned table ``position_weights``
    [max_positions, D] (unscaled), as the JAX module does."""

    def __init__(self, vocab_size: int, embedding_dim: int,
                 share_softmax_weights: bool = False, use_bias: bool = True,
                 timing=None, max_positions: int = 512, dtype=torch.float32):
        super().__init__()
        if timing not in (None, "sinusoids", "emb"):
            raise ValueError(f"Unknown timing: {timing}")
        self.embedding_dim = embedding_dim
        self.timing = timing
        self.dtype = dtype
        self.weights = nn.Parameter(torch.empty(vocab_size, embedding_dim))
        if share_softmax_weights and use_bias:
            self.bias = nn.Parameter(torch.zeros(vocab_size))
        else:
            self.bias = None
        if timing == "emb":
            self.position_weights = nn.Parameter(
                torch.empty(max_positions, embedding_dim))

    def forward(self, ids, time=None):
        """ids [B, L] (or [B] with a scalar ``time``) -> [B, L, D] / [B, D].
        A ``time`` tensor [B] (a speculative decode's per-row times) puts
        row b's tokens at positions time[b] + [0, L)."""
        emb = self.weights[ids].to(self.dtype)
        if self.timing is None:
            return emb
        squeeze = ids.dim() == 1
        if squeeze:
            emb = emb[:, None, :]
        length = emb.shape[1]
        if isinstance(time, torch.Tensor) and time.dim() == 1:
            positions = time[:, None] + torch.arange(length,
                                                     device=time.device)
            if self.timing == "sinusoids":
                emb = emb * (self.embedding_dim ** 0.5) \
                    + sinusoidal_position_signal_at(
                        positions, self.embedding_dim, dtype=emb.dtype)
            else:
                emb = emb + self.position_weights[positions].to(emb.dtype)
            return emb[:, 0, :] if squeeze else emb
        start = 0 if time is None else int(time)
        if self.timing == "sinusoids":
            signal = sinusoidal_position_signal(
                length, self.embedding_dim, start=start, dtype=emb.dtype,
                device=emb.device)
            emb = emb * (self.embedding_dim ** 0.5) + signal[None]
        else:
            # lax.dynamic_slice clamps the start so the slice fits
            table = self.position_weights
            start = max(0, min(start, table.shape[0] - length))
            emb = emb + table[start:start + length].to(emb.dtype)[None]
        return emb[:, 0, :] if squeeze else emb

    def attend(self, features):
        """[..., D] -> float32 logits [..., V] through the tied table.
        Products of compute-dtype values accumulate in float32, as the
        JAX ``preferred_element_type=float32`` dot does."""
        w = self.weights.to(features.dtype)
        logits = torch.matmul(features.float(), w.float().t())
        if self.bias is not None:
            logits = logits + self.bias.float()
        return logits
