"""Transformer encoder/decoder blocks (counterpart of
``neurst_tpu/layers/transformer_layers.py``): pre-norm (LN -> sublayer
-> dropout -> residual) or post-norm (sublayer -> dropout -> residual
-> LN).  With ``moe_num_experts`` > 1 the FFN sublayer is
``layers/moe.MoeFFN``.

Every dropout site of a layer has its own stream: the layer's key
(stream ``side << 16 | layer << 4``, set by the stack) plus the site's
number below, so no two sites of a step draw the same mask."""

import torch
from torch import nn

from neurst_tpu_torch.layers.attentions.multi_head_attention import (
    MultiHeadAttention, MultiHeadSelfAttention)
from neurst_tpu_torch.layers.common_layers import (LayerNorm, TransformerFFN,
                                                   apply_dropout)
from neurst_tpu_torch.layers.moe import MoeFFN
from neurst_tpu_torch.utils.rng import at_site

__all__ = ["TransformerEncoderLayer", "TransformerDecoderLayer",
           "moe_layer_kwargs"]

# dropout sites of a layer, in a fixed order
SELF_ATTENTION, SELF_ATTENTION_OUT, CROSS_ATTENTION, CROSS_ATTENTION_OUT, \
    FFN, FFN_OUT = range(6)


def moe_layer_kwargs(i, num_experts, frequency, top_k, capacity_factor,
                     aux_loss_coef, router_jitter):
    """Layer i's MoE arguments: an MoE FFN in every ``frequency``-th
    layer ((i + 1) % frequency == 0) when there is more than one expert,
    else none."""
    if int(num_experts or 0) <= 1 or (i + 1) % max(1, int(frequency)):
        return {}
    return dict(moe_num_experts=num_experts, moe_top_k=top_k,
                moe_capacity_factor=capacity_factor,
                moe_aux_loss_coef=aux_loss_coef,
                moe_router_jitter=router_jitter)


class _LayerCommon(nn.Module):
    """Self-attention and FFN sublayers with their LayerNorms."""

    def __init__(self, hidden_size: int, num_attention_heads: int,
                 filter_size: int, ffn_activation: str = "relu",
                 post_normalize: bool = False,
                 layer_postprocess_epsilon: float = 1e-6,
                 attention_dropout_rate: float = 0.0,
                 ffn_dropout_rate: float = 0.0,
                 layer_postprocess_dropout_rate: float = 0.0,
                 dtype=torch.float32, moe_num_experts: int = 0,
                 moe_top_k: int = 1, moe_capacity_factor: float = 1.25,
                 moe_aux_loss_coef: float = 0.01,
                 moe_router_jitter: float = 0.01):
        super().__init__()
        self.post_normalize = post_normalize
        self.layer_postprocess_dropout_rate = layer_postprocess_dropout_rate
        self.self_attention = MultiHeadSelfAttention(
            num_attention_heads, hidden_size, attention_dropout_rate,
            dtype=dtype)
        self.self_attention_ln = LayerNorm(
            hidden_size, layer_postprocess_epsilon, dtype)
        if int(moe_num_experts) > 1:
            self.ffn = MoeFFN(
                hidden_size, int(moe_num_experts), filter_size, hidden_size,
                top_k=int(moe_top_k),
                capacity_factor=float(moe_capacity_factor),
                aux_loss_coef=float(moe_aux_loss_coef),
                router_jitter=float(moe_router_jitter),
                activation=ffn_activation, dropout_rate=ffn_dropout_rate,
                dtype=dtype)
        else:
            self.ffn = TransformerFFN(hidden_size, filter_size, hidden_size,
                                      activation=ffn_activation,
                                      dropout_rate=ffn_dropout_rate,
                                      dtype=dtype)
        self.ffn_ln = LayerNorm(hidden_size, layer_postprocess_epsilon, dtype)

    def _prepost(self, ln, x, sublayer, is_training=False, key=None):
        y = sublayer(x if self.post_normalize else ln(x))
        y = x + apply_dropout(y, self.layer_postprocess_dropout_rate,
                              is_training, key)
        return ln(y) if self.post_normalize else y


class TransformerEncoderLayer(_LayerCommon):

    def forward(self, x, attention_bias=None, flash_lengths=None,
                flash_causal=False, is_training=False, dropout_key=None,
                ring=None):
        """``ring`` (a ring group and the global key lengths) runs the
        self-attention over the time shards of ``x``."""
        x = self._prepost(
            self.self_attention_ln, x,
            lambda y: self.self_attention(
                y, bias=attention_bias, flash_lengths=flash_lengths,
                flash_causal=flash_causal, is_training=is_training,
                dropout_key=at_site(dropout_key, SELF_ATTENTION),
                ring=ring),
            is_training, at_site(dropout_key, SELF_ATTENTION_OUT))
        return self._prepost(
            self.ffn_ln, x,
            lambda y: self.ffn(y, is_training, at_site(dropout_key, FFN)),
            is_training, at_site(dropout_key, FFN_OUT))


class TransformerDecoderLayer(_LayerCommon):

    def __init__(self, hidden_size: int, num_attention_heads: int,
                 filter_size: int, ffn_activation: str = "relu",
                 post_normalize: bool = False,
                 layer_postprocess_epsilon: float = 1e-6,
                 attention_dropout_rate: float = 0.0,
                 ffn_dropout_rate: float = 0.0,
                 layer_postprocess_dropout_rate: float = 0.0,
                 dtype=torch.float32, with_cross_attention: bool = True,
                 **moe):
        super().__init__(hidden_size, num_attention_heads, filter_size,
                         ffn_activation, post_normalize,
                         layer_postprocess_epsilon, attention_dropout_rate,
                         ffn_dropout_rate, layer_postprocess_dropout_rate,
                         dtype, **moe)
        self.with_cross_attention = with_cross_attention
        if with_cross_attention:
            self.cross_attention = MultiHeadAttention(
                num_attention_heads, hidden_size, attention_dropout_rate,
                dtype=dtype)
            self.cross_attention_ln = LayerNorm(
                hidden_size, layer_postprocess_epsilon, dtype)

    def memorize_memory(self, memory):
        """Precomputed cross-attention k/v for decoding."""
        k, v = self.cross_attention.compute_kv(memory)
        return {"memory": {"keys": k, "values": v}}

    def forward(self, x, self_attention_bias=None, memory=None,
                memory_bias=None, cache=None, decode_step=None,
                self_flash_causal=False, cross_flash_lengths=None,
                beam_anc=None, is_training=False, dropout_key=None):
        """-> [B, F, D].  ``cache`` (stepwise decode) holds "self" (written
        in place) and "memory" (the precomputed cross k/v).
        ``self_flash_causal`` / ``cross_flash_lengths`` (teacher forcing
        only) run both attentions through the flash kernel."""
        flash_lengths = None
        if self_flash_causal and cache is None:
            flash_lengths = torch.full((x.shape[0],), x.shape[1],
                                       dtype=torch.int32, device=x.device)
        x = self._prepost(
            self.self_attention_ln, x,
            lambda y: self.self_attention(
                y, bias=self_attention_bias,
                cache=None if cache is None else cache["self"],
                decode_step=decode_step, flash_lengths=flash_lengths,
                flash_causal=self_flash_causal, beam_anc=beam_anc,
                is_training=is_training,
                dropout_key=at_site(dropout_key, SELF_ATTENTION)),
            is_training, at_site(dropout_key, SELF_ATTENTION_OUT))
        if self.with_cross_attention:
            x = self._prepost(
                self.cross_attention_ln, x,
                lambda y: self.cross_attention(
                    y, memory=memory, bias=memory_bias,
                    cache=None if cache is None else cache["memory"],
                    flash_lengths=cross_flash_lengths,
                    is_training=is_training,
                    dropout_key=at_site(dropout_key, CROSS_ATTENTION)),
                is_training, at_site(dropout_key, CROSS_ATTENTION_OUT))
        return self._prepost(
            self.ffn_ln, x,
            lambda y: self.ffn(y, is_training, at_site(dropout_key, FFN)),
            is_training, at_site(dropout_key, FFN_OUT))
