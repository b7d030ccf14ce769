"""The light-convolution decoder stack (counterpart of
``neurst_tpu/layers/decoders/light_convolution_decoder.py``): a layer is
a causal convolution block, a cross-attention block and an FFN block.
The decoding cache holds each layer's convolution buffer and the
precomputed cross-attention keys and values:

    {"layer_<i>": {"conv": [B, K, D], "memory": {"keys", "values"}}}

A step returns a new cache (new buffers, the same memory), which beam
search reorders as a whole: the cache has no self-attention state for an
ancestor matrix to index.  Names follow the JAX module (``layer_<i>_conv``,
``layer_<i>_conv_ln``, ``layer_<i>_cross_attention``,
``layer_<i>_cross_ln``, ``layer_<i>_ffn``, ``layer_<i>_ffn_ln``,
``output_ln``).  Dropout: layer i draws from stream
``side << 16 | i << 4`` plus the site.
"""

import torch
from torch import nn

from neurst_tpu_torch.layers import layer_utils
from neurst_tpu_torch.layers.attentions.light_convolution_layer import \
    LightConvolutionLayer
from neurst_tpu_torch.layers.attentions.multi_head_attention import \
    MultiHeadAttention
from neurst_tpu_torch.layers.common_layers import (LayerNorm, TransformerFFN,
                                                   apply_dropout)
from neurst_tpu_torch.layers.encoders.light_convolution_encoder import (
    CONV_OUT, CONV_WEIGHT, CROSS_ATTENTION, CROSS_ATTENTION_OUT, FFN, FFN_OUT,
    layer_kernel_sizes)
from neurst_tpu_torch.utils.rng import SIDE_DECODER, at_site

__all__ = ["LightConvolutionDecoder"]


class LightConvolutionDecoder(nn.Module):

    def __init__(self, num_layers: int, hidden_size: int, num_heads: int,
                 filter_size: int, kernel_sizes=(3, 7, 15, 31, 31, 31),
                 conv_type: str = "lightweight", use_glu: bool = True,
                 ffn_activation: str = "relu",
                 weight_dropout_rate: float = 0.0,
                 attention_dropout_rate: float = 0.0,
                 ffn_dropout_rate: float = 0.0,
                 layer_postprocess_dropout_rate: float = 0.0,
                 post_normalize: bool = False,
                 layer_postprocess_epsilon: float = 1e-6,
                 dtype=torch.float32, side: int = SIDE_DECODER):
        super().__init__()
        self.num_layers = num_layers
        self.side = side
        self.post_normalize = post_normalize
        self.layer_postprocess_dropout_rate = layer_postprocess_dropout_rate
        kernels = layer_kernel_sizes(kernel_sizes, num_layers)
        for i in range(num_layers):
            self.add_module(f"layer_{i}_conv", LightConvolutionLayer(
                hidden_size, kernels[i], num_heads, hidden_size, hidden_size,
                conv_type, use_glu, weight_dropout_rate, dtype))
            self.add_module(f"layer_{i}_conv_ln", LayerNorm(
                hidden_size, layer_postprocess_epsilon, dtype))
            self.add_module(f"layer_{i}_cross_attention", MultiHeadAttention(
                num_heads, hidden_size, attention_dropout_rate, dtype=dtype))
            self.add_module(f"layer_{i}_cross_ln", LayerNorm(
                hidden_size, layer_postprocess_epsilon, dtype))
            self.add_module(f"layer_{i}_ffn", TransformerFFN(
                hidden_size, filter_size, hidden_size, ffn_activation,
                ffn_dropout_rate, dtype))
            self.add_module(f"layer_{i}_ffn_ln", LayerNorm(
                hidden_size, layer_postprocess_epsilon, dtype))
        if not post_normalize:
            self.output_ln = LayerNorm(hidden_size,
                                       layer_postprocess_epsilon, dtype)

    def _layer(self, i, part):
        return getattr(self, f"layer_{i}_{part}")

    def _block(self, ln, x, fn, is_training, key):
        y = fn(x if self.post_normalize else ln(x))
        y = x + apply_dropout(y, self.layer_postprocess_dropout_rate,
                              is_training, key)
        return ln(y) if self.post_normalize else y

    def create_decoding_internal_cache(self, encoder_outputs,
                                       decode_padded_length: int):
        """Zeroed convolution buffers + precomputed cross k/v (the
        length is unused: a buffer holds the last K inputs)."""
        del decode_padded_length
        batch = encoder_outputs.shape[0]
        cache = {}
        for i in range(self.num_layers):
            k, v = self._layer(i, "cross_attention").compute_kv(
                encoder_outputs)
            cache[f"layer_{i}"] = {
                "conv": self._layer(i, "conv").make_cache(
                    batch, encoder_outputs.device)["conv"],
                "memory": {"keys": k, "values": v}}
        return cache

    def forward(self, inputs, memory=None, memory_padding=None, cache=None,
                decode_step=None, decode_lagging=None, beam_anc=None,
                is_training=False, dropout_key=None):
        """Teacher forcing: ``inputs`` [B, T, D]; stepwise decode:
        ``inputs`` [B, 1, D] at ``decode_step`` with a cache from
        ``create_decoding_internal_cache``.  ``decode_lagging`` and
        ``beam_anc`` are accepted for the decoders' common signature and
        unused, as in the JAX module.  Returns (outputs, new cache)."""
        del decode_lagging, beam_anc
        memory_bias = None
        if memory_padding is not None:
            memory_bias = layer_utils.input_padding_to_bias(memory_padding)
        x = inputs
        new_cache = {} if cache is not None else None
        for i in range(self.num_layers):
            layer_cache = None if cache is None else cache[f"layer_{i}"]
            key = at_site(dropout_key, self.side << 16 | i << 4)
            conv_cache = {}

            def conv_fn(y, i=i, layer_cache=layer_cache, key=key):
                out, upd = self._layer(i, "conv")(
                    y, causal=True, cache=None if layer_cache is None
                    else {"conv": layer_cache["conv"]},
                    decode_step=decode_step, is_training=is_training,
                    dropout_key=at_site(key, CONV_WEIGHT))
                conv_cache["conv"] = upd
                return out

            x = self._block(self._layer(i, "conv_ln"), x, conv_fn,
                            is_training, at_site(key, CONV_OUT))
            if new_cache is not None:
                new_cache[f"layer_{i}"] = {
                    "conv": conv_cache["conv"]["conv"],
                    "memory": layer_cache["memory"]}
            cross = self._layer(i, "cross_attention")
            x = self._block(
                self._layer(i, "cross_ln"), x,
                lambda y, layer_cache=layer_cache, key=key: cross(
                    y, memory=memory, bias=memory_bias,
                    cache=None if layer_cache is None
                    else layer_cache["memory"], is_training=is_training,
                    dropout_key=at_site(key, CROSS_ATTENTION)),
                is_training, at_site(key, CROSS_ATTENTION_OUT))
            ffn = self._layer(i, "ffn")
            x = self._block(
                self._layer(i, "ffn_ln"), x,
                lambda y, key=key: ffn(y, is_training, at_site(key, FFN)),
                is_training, at_site(key, FFN_OUT))
        if not self.post_normalize:
            x = self.output_ln(x)
        return x, new_cache
