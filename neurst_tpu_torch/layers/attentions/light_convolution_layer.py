"""Lightweight and dynamic convolutions (Pay Less Attention, Wu et al.
2019; counterpart of
``neurst_tpu/layers/attentions/light_convolution_layer.py``).

A GLU input projection, a depthwise convolution whose softmax-normalised
weights come in ``num_heads`` groups shared over the channels of a group
(``lightweight``: one [H, K] table; ``dynamic``: predicted at each
position by a linear of the projected input), weight dropout, and an
output projection.  The windows are materialised as [B, T, K, C]
(``_unfold``), as in the JAX module.  Decoding keeps a [B, K, C] buffer
of the last K projected inputs in the cache; a step shifts it by one and
returns a new buffer, so beam search reorders it like any other cache
leaf.
"""

import torch
from torch import nn
from torch.nn import functional as F

from neurst_tpu_torch.layers.common_layers import apply_dropout, linear

__all__ = ["LightConvolutionLayer"]


def _unfold(x, kernel_size: int, causal: bool):
    """x [B, T, C] -> sliding windows [B, T, K, C] (causal: the K - 1
    positions before each one; else centred, the odd one to the left)."""
    if causal:
        pad_left, pad_right = kernel_size - 1, 0
    else:
        pad_left = (kernel_size - 1) // 2
        pad_right = kernel_size - 1 - pad_left
    x = F.pad(x, (0, 0, pad_left, pad_right))
    t = x.shape[1] - kernel_size + 1
    return torch.stack([x[:, k:k + t] for k in range(kernel_size)], dim=2)


class LightConvolutionLayer(nn.Module):

    def __init__(self, input_dim: int, kernel_size: int, num_heads: int,
                 conv_dim: int, output_dim: int,
                 conv_type: str = "lightweight", use_glu: bool = True,
                 weight_dropout_rate: float = 0.0, dtype=torch.float32):
        super().__init__()
        if conv_type not in ("lightweight", "dynamic"):
            raise ValueError(f"conv_type {conv_type!r}: lightweight or "
                             f"dynamic")
        if conv_dim % num_heads:
            raise ValueError(f"conv_dim {conv_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.kernel_size = kernel_size
        self.num_heads = num_heads
        self.conv_dim = conv_dim
        self.conv_type = conv_type
        self.use_glu = use_glu
        self.weight_dropout_rate = weight_dropout_rate
        self.dtype = dtype
        self.in_proj = nn.Linear(input_dim, conv_dim * (2 if use_glu else 1))
        self.out_proj = nn.Linear(conv_dim, output_dim)
        if conv_type == "lightweight":
            self.conv_shared_weight = nn.Parameter(
                torch.empty(num_heads, kernel_size))
        else:
            self.conv_weight_linear = nn.Linear(
                conv_dim, num_heads * kernel_size, bias=False)

    def init_own_params(self, generator):
        """flax's ``lecun_normal`` on the [H, K] table (fan-in H)."""
        from neurst_tpu_torch.models.model import lecun_normal
        if self.conv_type == "lightweight":
            self.conv_shared_weight.copy_(lecun_normal(
                (self.kernel_size, self.num_heads), generator).t())

    def _conv_weights(self, h, batch, length):
        """Softmax-normalised weights [B, T, H, K] in the compute dtype
        (the softmax in float32)."""
        if self.conv_type == "lightweight":
            w = torch.softmax(self.conv_shared_weight.float(),
                              dim=-1).to(self.dtype)
            return w[None, None].expand(batch, length, self.num_heads,
                                        self.kernel_size)
        w = linear(self.conv_weight_linear, h, self.dtype).view(
            batch, length, self.num_heads, self.kernel_size)
        return torch.softmax(w.float(), dim=-1).to(self.dtype)

    def forward(self, x, causal=False, cache=None, decode_step=None,
                is_training=False, dropout_key=None):
        """x [B, T, D] -> ([B, T, output_dim], cache).  With a cache and a
        ``decode_step`` (T = 1) the window is the cache's buffer shifted
        by the step's input, and the returned cache holds the new
        buffer."""
        batch = x.shape[0]
        h = linear(self.in_proj, x, self.dtype)
        if self.use_glu:
            a, b = h.chunk(2, dim=-1)
            h = a * torch.sigmoid(b)
        if cache is not None and decode_step is not None:
            buf = torch.cat([cache["conv"][:, 1:],
                             h[:, :1].to(cache["conv"].dtype)], dim=1)
            cache = {"conv": buf}
            windows = buf[:, None]
            length = 1
        else:
            windows = _unfold(h, self.kernel_size, causal)
            length = h.shape[1]
        w = self._conv_weights(h, batch, length)
        if is_training and self.weight_dropout_rate:
            w = apply_dropout(w.contiguous(), self.weight_dropout_rate,
                              is_training, dropout_key)
        head_dim = self.conv_dim // self.num_heads
        windows = windows.reshape(batch, length, self.kernel_size,
                                  self.num_heads, head_dim)
        out = torch.einsum("btkhd,bthk->bthd", windows.to(self.dtype), w)
        out = out.reshape(batch, length, self.conv_dim)
        return linear(self.out_proj, out, self.dtype), cache

    def make_cache(self, batch_size: int, device=None):
        return {"conv": torch.zeros(
            (batch_size, self.kernel_size, self.conv_dim), dtype=self.dtype,
            device=device)}
