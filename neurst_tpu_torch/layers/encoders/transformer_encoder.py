"""Transformer encoder stack (counterpart of
``neurst_tpu/layers/encoders/transformer_encoder.py``, the per-layer
layout).  Layers are registered as ``layer_<i>`` so parameter names
match the JAX package's; a scan-stacked checkpoint (the MoE block scan's
too) is unstacked by ``utils/param_bridge``.  With ``moe_num_experts`` >
1 every ``moe_layer_frequency``-th layer (1, 3, 5, ... at 2) has an MoE
FFN."""

import torch
from torch import nn

from neurst_tpu_torch.layers import layer_utils
from neurst_tpu_torch.layers.common_layers import LayerNorm
from neurst_tpu_torch.layers.transformer_layers import (
    TransformerEncoderLayer, moe_layer_kwargs)
from neurst_tpu_torch.utils.rng import SIDE_ENCODER, at_site

__all__ = ["TransformerEncoder"]


class TransformerEncoder(nn.Module):

    def __init__(self, num_layers: int, hidden_size: int,
                 num_attention_heads: int, filter_size: int,
                 ffn_activation: str = "relu", post_normalize: bool = False,
                 layer_postprocess_epsilon: float = 1e-6,
                 attention_monotonic: bool = False,
                 enable_flash_attention: bool = False,
                 attention_dropout_rate: float = 0.0,
                 ffn_dropout_rate: float = 0.0,
                 layer_postprocess_dropout_rate: float = 0.0,
                 dtype=torch.float32, side: int = SIDE_ENCODER,
                 moe_num_experts: int = 0, moe_layer_frequency: int = 2,
                 moe_top_k: int = 1, moe_capacity_factor: float = 1.25,
                 moe_aux_loss_coef: float = 0.01,
                 moe_router_jitter: float = 0.01):
        super().__init__()
        self.num_layers = num_layers
        self.side = side
        self.post_normalize = post_normalize
        self.attention_monotonic = bool(attention_monotonic)
        self.enable_flash_attention = bool(enable_flash_attention)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(
                hidden_size, num_attention_heads, filter_size,
                ffn_activation, post_normalize, layer_postprocess_epsilon,
                attention_dropout_rate, ffn_dropout_rate,
                layer_postprocess_dropout_rate, dtype,
                **moe_layer_kwargs(i, moe_num_experts, moe_layer_frequency,
                                   moe_top_k, moe_capacity_factor,
                                   moe_aux_loss_coef, moe_router_jitter)))
        if not post_normalize:
            self.output_ln = LayerNorm(hidden_size,
                                       layer_postprocess_epsilon, dtype)

    def forward(self, inputs, inputs_padding, is_training=False,
                dropout_key=None):
        """inputs [B, T, D]; inputs_padding [B, T] float (1 = pad).
        Padding is contiguous on the right, so with flash attention a
        per-row valid length encodes it for the kernel.  Layer i draws
        its dropout masks from stream ``side << 16 | i << 4`` of
        ``dropout_key`` (``side`` is ``SIDE_ENCODER`` unless the model
        gives another)."""
        flash_lengths = bias = None
        if self.enable_flash_attention:
            flash_lengths = (1.0 - inputs_padding).sum(dim=1).to(torch.int32)
        else:
            bias = layer_utils.input_padding_to_bias(inputs_padding)
            if self.attention_monotonic:
                bias = bias + layer_utils.causal_self_attention_bias(
                    inputs.shape[1], device=inputs.device)
        x = inputs
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(
                x, bias, flash_lengths=flash_lengths,
                flash_causal=self.attention_monotonic,
                is_training=is_training,
                dropout_key=at_site(dropout_key, self.side << 16 | i << 4))
        if not self.post_normalize:
            x = self.output_ln(x)
        return x
