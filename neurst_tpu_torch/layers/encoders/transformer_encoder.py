"""Transformer encoder stack (counterpart of
``neurst_tpu/layers/encoders/transformer_encoder.py``, the per-layer
layout).  Layers are registered as ``layer_<i>`` so parameter names
match the JAX package's; a scan-stacked checkpoint (the MoE block scan's
and the pipeline's too) is unstacked by ``utils/param_bridge``.  With
``moe_num_experts`` > 1 every ``moe_layer_frequency``-th layer (1, 3, 5,
... at 2) has an MoE FFN.

``pipeline_stages`` > 1 runs the layers as a GPipe pipeline in training
(``layers/pipeline.py``) over the mesh's "stage" group (``stage_group``,
set by ``parallel.apply_mesh``); the output is broadcast from the last
stage, so every stage's decoder cross-attends to it.
``enable_ring_attention`` shards the time axis over ``ring_group`` (the
group of ``ring_attention_axis``): the batch is gathered over the group,
each rank keeps its T / p positions through the stack (LayerNorm and FFN
are per position; self-attention is ``ops/ring_attention.py``), and the
output is gathered once along time and cut back to the rank's rows.  T
must divide the group, as the JAX package asserts.  Ring attention takes
precedence over flash attention and has no attention dropout, as in the
JAX package."""

import torch
from torch import nn

from neurst_tpu_torch.layers import layer_utils
from neurst_tpu_torch.layers.common_layers import LayerNorm
from neurst_tpu_torch.layers.pipeline import (ENCODER_TAG, check_pipeline,
                                              gpipe)
from neurst_tpu_torch.layers.transformer_layers import (
    TransformerEncoderLayer, moe_layer_kwargs)
from neurst_tpu_torch.parallel import collectives
from neurst_tpu_torch.utils.rng import SIDE_ENCODER, at_shard, at_site

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
                 moe_router_jitter: float = 0.01,
                 pipeline_stages: int = 1, pipeline_microbatches: int = 0,
                 enable_ring_attention: bool = False,
                 ring_attention_axis: str = "data"):
        super().__init__()
        self.num_layers = num_layers
        self.side = side
        self.post_normalize = post_normalize
        self.attention_monotonic = bool(attention_monotonic)
        self.enable_flash_attention = bool(enable_flash_attention)
        self.enable_ring_attention = bool(enable_ring_attention)
        self.ring_attention_axis = ring_attention_axis
        self.pipeline_stages = int(pipeline_stages or 1)
        self.pipeline_microbatches = int(pipeline_microbatches or 0)
        check_pipeline(self.pipeline_stages, moe_num_experts,
                       self.enable_flash_attention,
                       self.enable_ring_attention)
        # set by parallel.apply_mesh (None: one rank)
        self.stage_group = self.ring_group = None
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
        if self.enable_ring_attention:
            return self._ring_forward(inputs, inputs_padding, is_training,
                                      dropout_key)
        flash_lengths = bias = None
        if self.enable_flash_attention:
            flash_lengths = (1.0 - inputs_padding).sum(dim=1).to(torch.int32)
        else:
            bias = layer_utils.input_padding_to_bias(inputs_padding)
            if self.attention_monotonic:
                bias = bias + layer_utils.causal_self_attention_bias(
                    inputs.shape[1], device=inputs.device)
        def run(x, lo, hi, args, key):
            for i in range(lo, hi):
                x = getattr(self, f"layer_{i}")(
                    x, args["bias"], flash_lengths=flash_lengths,
                    flash_causal=self.attention_monotonic,
                    is_training=is_training,
                    dropout_key=at_site(key, self.side << 16 | i << 4))
            return x

        if self.pipeline_stages > 1 and is_training:
            x = gpipe(self, run, inputs, {"bias": bias}, self.num_layers,
                      self.pipeline_stages, self.pipeline_microbatches,
                      self.stage_group, ENCODER_TAG, dropout_key)
            x = collectives.broadcast_from(
                x, collectives.group_size(self.stage_group) - 1,
                self.stage_group)
        else:
            x = run(inputs, 0, self.num_layers, {"bias": bias}, dropout_key)
        if not self.post_normalize:
            x = self.output_ln(x)
        return x

    def _ring_forward(self, inputs, inputs_padding, is_training,
                      dropout_key):
        group = self.ring_group
        p, r = collectives.group_size(group), collectives.group_rank(group)
        batch = inputs.shape[0]
        x = collectives.gather_sum_from(inputs, 0, group)
        padding = collectives.all_gather(inputs_padding.float(), 0, group)
        t = x.shape[1]
        if t % p:
            raise ValueError(f"ring attention: time axis {t} not divisible "
                             f"by the {self.ring_attention_axis} axis ({p})")
        t_local = t // p
        lengths = (1.0 - padding).sum(dim=1).to(torch.int32)
        x = x[:, r * t_local:(r + 1) * t_local]
        # the time shards draw masks of their own
        key = at_shard(dropout_key, r, field=1) if p > 1 else dropout_key
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(
                x, None, ring=(group, lengths),
                flash_causal=self.attention_monotonic,
                is_training=is_training,
                dropout_key=at_site(key, self.side << 16 | i << 4))
        if not self.post_normalize:
            x = self.output_ln(x)
        x = collectives.gather_sum_from(x, 1, group)
        return x[r * batch:(r + 1) * batch]
