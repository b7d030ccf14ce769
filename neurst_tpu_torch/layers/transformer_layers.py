"""Transformer encoder/decoder blocks (counterpart of
``neurst_tpu/layers/transformer_layers.py``): pre-norm (LN -> sublayer
-> dropout -> residual) or post-norm (sublayer -> dropout -> residual
-> LN).

Every dropout site of a layer has its own stream: the layer's key
(stream ``side << 16 | layer << 4``, set by the stack) plus the site's
number below, so no two sites of a step draw the same mask."""

import torch
from torch import nn

from neurst_tpu_torch.layers.attentions.multi_head_attention import (
    MultiHeadAttention, MultiHeadSelfAttention)
from neurst_tpu_torch.layers.common_layers import (LayerNorm, TransformerFFN,
                                                   apply_dropout)
from neurst_tpu_torch.utils.rng import at_site

__all__ = ["TransformerEncoderLayer", "TransformerDecoderLayer"]

# dropout sites of a layer, in a fixed order
SELF_ATTENTION, SELF_ATTENTION_OUT, CROSS_ATTENTION, CROSS_ATTENTION_OUT, \
    FFN, FFN_OUT = range(6)


class _LayerCommon(nn.Module):
    """Self-attention and FFN sublayers with their LayerNorms."""

    def __init__(self, hidden_size: int, num_attention_heads: int,
                 filter_size: int, ffn_activation: str = "relu",
                 post_normalize: bool = False,
                 layer_postprocess_epsilon: float = 1e-6,
                 attention_dropout_rate: float = 0.0,
                 ffn_dropout_rate: float = 0.0,
                 layer_postprocess_dropout_rate: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.post_normalize = post_normalize
        self.layer_postprocess_dropout_rate = layer_postprocess_dropout_rate
        self.self_attention = MultiHeadSelfAttention(
            num_attention_heads, hidden_size, attention_dropout_rate,
            dtype=dtype)
        self.self_attention_ln = LayerNorm(
            hidden_size, layer_postprocess_epsilon, dtype)
        self.ffn = TransformerFFN(hidden_size, filter_size, hidden_size,
                                  activation=ffn_activation,
                                  dropout_rate=ffn_dropout_rate, dtype=dtype)
        self.ffn_ln = LayerNorm(hidden_size, layer_postprocess_epsilon, dtype)

    def _prepost(self, ln, x, sublayer, is_training=False, key=None):
        y = sublayer(x if self.post_normalize else ln(x))
        y = x + apply_dropout(y, self.layer_postprocess_dropout_rate,
                              is_training, key)
        return ln(y) if self.post_normalize else y


class TransformerEncoderLayer(_LayerCommon):

    def forward(self, x, attention_bias=None, flash_lengths=None,
                flash_causal=False, is_training=False, dropout_key=None):
        x = self._prepost(
            self.self_attention_ln, x,
            lambda y: self.self_attention(
                y, bias=attention_bias, flash_lengths=flash_lengths,
                flash_causal=flash_causal, is_training=is_training,
                dropout_key=at_site(dropout_key, SELF_ATTENTION)),
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
                 dtype=torch.float32):
        super().__init__(hidden_size, num_attention_heads, filter_size,
                         ffn_activation, post_normalize,
                         layer_postprocess_epsilon, attention_dropout_rate,
                         ffn_dropout_rate, layer_postprocess_dropout_rate,
                         dtype)
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
        x = self._prepost(
            self.cross_attention_ln, x,
            lambda y: self.cross_attention(
                y, memory=memory, bias=memory_bias,
                cache=None if cache is None else cache["memory"],
                flash_lengths=cross_flash_lengths, is_training=is_training,
                dropout_key=at_site(dropout_key, CROSS_ATTENTION)),
            is_training, at_site(dropout_key, CROSS_ATTENTION_OUT))
        return self._prepost(
            self.ffn_ln, x,
            lambda y: self.ffn(y, is_training, at_site(dropout_key, FFN)),
            is_training, at_site(dropout_key, FFN_OUT))
