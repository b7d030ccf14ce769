"""Common transformer building blocks (counterpart of
``neurst_tpu/layers/common_layers.py``).

Parameters are stored in float32 (or bf16 after
``utils/param_policy.cast_params_for_inference`` or, for training,
``optimizers/master_weights.cast_params_bf16``) and cast to the compute
``dtype`` where they are used, as the flax modules do.  Dense
weights use ``torch.nn.Linear``'s ``[out, in]`` layout;
``utils/param_bridge`` transposes the flax ``[in, out]`` kernels.
Training threads ``is_training`` through every module as the flax
modules do; dropout itself is not ported, so ``apply_dropout`` is the
identity at rate 0 or outside training and raises on a rate > 0 in
training.  Modules are built without drawing random numbers; their
weights come from ``utils/param_bridge`` or the model's ``init_params``.
"""

import math

import torch
from torch import nn
from torch.nn import functional as F

__all__ = ["LayerNorm", "TransformerFFN", "WordEmbedding",
           "sinusoidal_position_signal", "linear", "apply_dropout"]


def apply_dropout(x, rate: float, is_training: bool):
    """Inverted dropout: the identity outside training or at rate 0; a
    rate > 0 in training is not ported yet and raises."""
    if not is_training or not rate:
        return x
    raise NotImplementedError(
        f"dropout (rate {rate}) in training is not ported yet; set the "
        f"dropout rates to 0 to train with the port")


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
    """dense1 -> relu -> dropout -> dense2 (the JAX module's plain path,
    which runs wherever its fused FFN kernel is off)."""

    def __init__(self, input_size: int, filter_size: int, output_size: int,
                 activation: str = "relu", dropout_rate: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        if activation != "relu":
            raise NotImplementedError(
                f"ffn activation {activation!r}: the port has relu")
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.dense1 = nn.Linear(input_size, filter_size)
        self.dense2 = nn.Linear(filter_size, output_size)

    def forward(self, x, is_training: bool = False):
        h = torch.relu(linear(self.dense1, x, self.dtype))
        h = apply_dropout(h, self.dropout_rate, is_training)
        return linear(self.dense2, h, self.dtype)


def sinusoidal_position_signal(length: int, channels: int, start: int = 0,
                               min_timescale: float = 1.0,
                               max_timescale: float = 1.0e4,
                               dtype=torch.float32, device=None):
    """T2T-layout sinusoids: [length, channels] = concat(sin, cos), the
    odd channel zero-padded."""
    position = torch.arange(length, dtype=torch.float32,
                            device=device) + float(start)
    num_timescales = channels // 2
    log_timescale_increment = (
        math.log(float(max_timescale) / float(min_timescale))
        / max(float(num_timescales) - 1.0, 1.0))
    inv_timescales = min_timescale * torch.exp(
        torch.arange(num_timescales, dtype=torch.float32, device=device)
        * -log_timescale_increment)
    scaled_time = position[:, None] * inv_timescales[None, :]
    signal = torch.cat([torch.sin(scaled_time), torch.cos(scaled_time)],
                       dim=1)
    if channels % 2:
        signal = F.pad(signal, (0, 1))
    return signal.to(dtype)


class WordEmbedding(nn.Module):
    """Embedding table ``weights`` [V, D] with the tied pre-softmax
    projection ``attend`` (+ ``bias`` [V] when the softmax is shared).
    ``timing='sinusoids'`` scales by sqrt(D) and adds the signal."""

    def __init__(self, vocab_size: int, embedding_dim: int,
                 share_softmax_weights: bool = False, use_bias: bool = True,
                 timing=None, dtype=torch.float32):
        super().__init__()
        if timing not in (None, "sinusoids"):
            raise NotImplementedError(f"timing {timing!r}: the port has "
                                      "sinusoids")
        self.embedding_dim = embedding_dim
        self.timing = timing
        self.dtype = dtype
        self.weights = nn.Parameter(torch.empty(vocab_size, embedding_dim))
        if share_softmax_weights and use_bias:
            self.bias = nn.Parameter(torch.zeros(vocab_size))
        else:
            self.bias = None

    def forward(self, ids, time=None):
        """ids [B, L] (or [B] with a scalar ``time``) -> [B, L, D] / [B, D]."""
        emb = self.weights[ids].to(self.dtype)
        if self.timing is None:
            return emb
        squeeze = ids.dim() == 1
        if squeeze:
            emb = emb[:, None, :]
        signal = sinusoidal_position_signal(
            emb.shape[1], self.embedding_dim,
            start=0 if time is None else time, dtype=emb.dtype,
            device=emb.device)
        emb = emb * (self.embedding_dim ** 0.5) + signal[None]
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
