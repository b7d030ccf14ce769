"""The light-convolution encoder stack (counterpart of
``neurst_tpu/layers/encoders/light_convolution_encoder.py``): a layer is
a centred (non-causal) convolution block and an FFN block, pre-norm or
post-norm.  Padded positions are zeroed at the input and after every
convolution block, so no window reads them.  Layer i's kernel size is
``kernel_sizes[i]`` (the last repeats).  Names follow the JAX module:
``layer_<i>_conv``, ``layer_<i>_conv_ln``, ``layer_<i>_ffn``,
``layer_<i>_ffn_ln``, ``output_ln``.

Dropout: layer i draws from stream ``SIDE_ENCODER << 16 | i << 4`` plus
the site (conv weights, conv block output, FFN hidden, FFN block
output)."""

import torch
from torch import nn

from neurst_tpu_torch.layers.attentions.light_convolution_layer import \
    LightConvolutionLayer
from neurst_tpu_torch.layers.common_layers import (LayerNorm, TransformerFFN,
                                                   apply_dropout)
from neurst_tpu_torch.utils.rng import SIDE_ENCODER, at_site

__all__ = ["LightConvolutionEncoder", "layer_kernel_sizes"]

# dropout sites of a layer
CONV_WEIGHT, CONV_OUT, CROSS_ATTENTION, CROSS_ATTENTION_OUT, FFN, FFN_OUT = \
    range(6)


def layer_kernel_sizes(kernel_sizes, num_layers):
    """Per-layer kernel sizes, the last one repeated up to
    ``num_layers``."""
    kernels = list(kernel_sizes)
    while len(kernels) < num_layers:
        kernels.append(kernels[-1])
    return kernels


class LightConvolutionEncoder(nn.Module):

    def __init__(self, num_layers: int, hidden_size: int, num_heads: int,
                 filter_size: int, kernel_sizes=(3, 7, 15, 31, 31, 31, 31),
                 conv_type: str = "lightweight", use_glu: bool = True,
                 ffn_activation: str = "relu",
                 weight_dropout_rate: float = 0.0,
                 ffn_dropout_rate: float = 0.0,
                 layer_postprocess_dropout_rate: float = 0.0,
                 post_normalize: bool = False,
                 layer_postprocess_epsilon: float = 1e-6,
                 attention_dropout_rate: float = 0.0, dtype=torch.float32):
        """``attention_dropout_rate`` is accepted and unused: the encoder
        has no attention (the JAX module drops the key)."""
        super().__init__()
        del attention_dropout_rate
        self.num_layers = num_layers
        self.post_normalize = post_normalize
        self.layer_postprocess_dropout_rate = layer_postprocess_dropout_rate
        kernels = layer_kernel_sizes(kernel_sizes, num_layers)
        for i in range(num_layers):
            self.add_module(f"layer_{i}_conv", LightConvolutionLayer(
                hidden_size, kernels[i], num_heads, hidden_size, hidden_size,
                conv_type, use_glu, weight_dropout_rate, dtype))
            self.add_module(f"layer_{i}_conv_ln", LayerNorm(
                hidden_size, layer_postprocess_epsilon, dtype))
            self.add_module(f"layer_{i}_ffn", TransformerFFN(
                hidden_size, filter_size, hidden_size, ffn_activation,
                ffn_dropout_rate, dtype))
            self.add_module(f"layer_{i}_ffn_ln", LayerNorm(
                hidden_size, layer_postprocess_epsilon, dtype))
        if not post_normalize:
            self.output_ln = LayerNorm(hidden_size,
                                       layer_postprocess_epsilon, dtype)

    def _block(self, ln, x, fn, is_training, key):
        y = fn(x if self.post_normalize else ln(x))
        y = x + apply_dropout(y, self.layer_postprocess_dropout_rate,
                              is_training, key)
        return ln(y) if self.post_normalize else y

    def forward(self, inputs, inputs_padding, is_training=False,
                dropout_key=None):
        """inputs [B, T, D]; inputs_padding [B, T] float (1 = pad)."""
        keep = (1.0 - inputs_padding)[:, :, None]
        x = inputs * keep.to(inputs.dtype)
        for i in range(self.num_layers):
            key = at_site(dropout_key, SIDE_ENCODER << 16 | i << 4)
            conv = getattr(self, f"layer_{i}_conv")
            ffn = getattr(self, f"layer_{i}_ffn")
            x = self._block(
                getattr(self, f"layer_{i}_conv_ln"), x,
                lambda y: conv(y, causal=False, is_training=is_training,
                               dropout_key=at_site(key, CONV_WEIGHT))[0],
                is_training, at_site(key, CONV_OUT))
            x = x * keep.to(x.dtype)
            x = self._block(
                getattr(self, f"layer_{i}_ffn_ln"), x,
                lambda y: ffn(y, is_training, at_site(key, FFN)),
                is_training, at_site(key, FFN_OUT))
        if not self.post_normalize:
            x = self.output_ln(x)
        return x
