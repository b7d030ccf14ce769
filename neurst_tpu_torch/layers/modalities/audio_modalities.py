"""Audio input modality (counterpart of
``neurst_tpu/layers/modalities/audio_modalities.py``): N x (Conv2d
stride s -> optional float32 LayerNorm over channels -> ReLU), flatten
(freq, channel) per frame, dense projection to the model dim, sinusoid
timing.

The flax module convolves NHWC [B, T, F, C] after padding k // 2 on
both sides and a VALID stride-s convolution; here the convolution runs
in NCHW [B, C, T, F] with ``padding = k // 2``, which is the same
function, and the result is permuted back to [B, T', F', C] before the
LayerNorm and the flatten, so ``output_dense`` sees the features in the
(F', C) order it was trained on.
"""

import torch
from torch import nn
from torch.nn import functional as F

from neurst_tpu_torch.layers.common_layers import (LayerNorm, linear,
                                                   sinusoidal_position_signal)

__all__ = ["AudioConv2dSubsampling", "subsampled_length"]


def subsampled_length(length, num_layers: int = 2, strides: int = 2):
    """Ceil-division of ``length`` by ``strides``, ``num_layers`` times
    (python ints or integer tensors)."""
    for _ in range(num_layers):
        length = -((-length) // strides)
    return length


def _conv_out(size: int, kernel: int, stride: int) -> int:
    pad = kernel // 2
    return (size + 2 * pad - kernel) // stride + 1


class AudioConv2dSubsampling(nn.Module):

    def __init__(self, embedding_dim: int, feature_dim: int = 80,
                 feature_channels: int = 1, channels: int = 256,
                 kernel_size: int = 3, strides: int = 2,
                 layer_norm: bool = True, num_layers: int = 2,
                 timing: str = "sinusoids", dtype=torch.float32):
        super().__init__()
        if timing not in ("sinusoids", None):
            raise ValueError(f"AudioConv2dSubsampling supports timing="
                             f"'sinusoids' or None, got {timing!r}")
        self.embedding_dim = embedding_dim
        self.kernel_size = kernel_size
        self.strides = strides
        self.layer_norm = layer_norm
        self.num_layers = num_layers
        self.timing = timing
        self.dtype = dtype
        in_ch, freq = feature_channels, feature_dim
        for i in range(1, num_layers + 1):
            self.add_module(f"conv{i}", nn.Conv2d(
                in_ch, channels, kernel_size, stride=strides,
                padding=kernel_size // 2))
            if layer_norm:
                self.add_module(f"ln{i}", LayerNorm(channels, 1e-6, dtype))
            in_ch = channels
            freq = _conv_out(freq, kernel_size, strides)
        self.output_dense = nn.Linear(freq * channels, embedding_dim)

    def forward(self, inputs):
        """inputs [B, T, feat_dim, channels] -> [B, T', embedding_dim]."""
        if inputs.dim() != 4:
            raise ValueError(f"expected [B, T, F, C], got "
                             f"{tuple(inputs.shape)}")
        x = inputs.to(self.dtype).permute(0, 3, 1, 2)      # [B, C, T, F]
        for i in range(1, self.num_layers + 1):
            conv = getattr(self, f"conv{i}")
            x = F.conv2d(x, conv.weight.to(self.dtype),
                         conv.bias.to(self.dtype), stride=self.strides,
                         padding=self.kernel_size // 2)
            x = x.permute(0, 2, 3, 1)                     # [B, T, F, C]
            if self.layer_norm:
                x = getattr(self, f"ln{i}")(x)
            x = torch.relu(x)
            if i < self.num_layers:
                x = x.permute(0, 3, 1, 2)
        b, t = x.shape[0], x.shape[1]
        x = linear(self.output_dense, x.reshape(b, t, -1), self.dtype)
        if self.timing == "sinusoids":
            x = x * (self.embedding_dim ** 0.5) + sinusoidal_position_signal(
                t, self.embedding_dim, dtype=x.dtype, device=x.device)[None]
        return x
