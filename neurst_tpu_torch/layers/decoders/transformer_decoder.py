"""Transformer decoder stack with an explicit decoding cache
(counterpart of ``neurst_tpu/layers/decoders/transformer_decoder.py``,
the per-layer layout).

The cache is a dict
    {"layer_0": {"self": {keys, values}, "memory": {keys, values}}, ...}
with self keys/values [B, max_decode_len, N, H] (static shape, written
in place at each step) and memory keys/values [B, src_len, N, H]
(precomputed once).  A decoder without cross-attention (GPT-2's,
``with_cross_attention=False``, as the JAX decoder's switch) has no
``cross_attention`` blocks and no "memory" entries.  With
``moe_num_experts`` > 1 every ``moe_layer_frequency``-th layer has an MoE
FFN, as in the encoder.

``pipeline_stages`` > 1 runs the layers as a GPipe pipeline in training
(``layers/pipeline.py``) over the mesh's "stage" group (``stage_group``):
each stage's layers cross-attend to their micro-batch of the memory, and
the output is the last stage's (zeros on the other stages).  Under tensor
parallelism ``num_heads`` is this rank's (the cache holds the local
heads).
"""

import torch
from torch import nn

from neurst_tpu_torch.layers import layer_utils
from neurst_tpu_torch.layers.common_layers import LayerNorm
from neurst_tpu_torch.layers.pipeline import (DECODER_TAG, check_pipeline,
                                              gpipe)
from neurst_tpu_torch.layers.transformer_layers import (
    TransformerDecoderLayer, moe_layer_kwargs)
from neurst_tpu_torch.utils.rng import SIDE_DECODER, at_site

__all__ = ["TransformerDecoder"]


class TransformerDecoder(nn.Module):

    def __init__(self, num_layers: int, hidden_size: int,
                 num_attention_heads: int, filter_size: int,
                 ffn_activation: str = "relu", post_normalize: bool = False,
                 layer_postprocess_epsilon: float = 1e-6,
                 enable_flash_attention: bool = False,
                 attention_dropout_rate: float = 0.0,
                 ffn_dropout_rate: float = 0.0,
                 layer_postprocess_dropout_rate: float = 0.0,
                 with_cross_attention: bool = True,
                 dtype=torch.float32, side: int = SIDE_DECODER,
                 moe_num_experts: int = 0, moe_layer_frequency: int = 2,
                 moe_top_k: int = 1, moe_capacity_factor: float = 1.25,
                 moe_aux_loss_coef: float = 0.01,
                 moe_router_jitter: float = 0.01,
                 pipeline_stages: int = 1, pipeline_microbatches: int = 0):
        super().__init__()
        self.num_layers = num_layers
        self.pipeline_stages = int(pipeline_stages or 1)
        self.pipeline_microbatches = int(pipeline_microbatches or 0)
        check_pipeline(self.pipeline_stages, moe_num_experts,
                       bool(enable_flash_attention), encoder=False)
        self.stage_group = None  # set by parallel.apply_mesh
        self.with_cross_attention = with_cross_attention
        self.side = side
        self.num_heads = num_attention_heads
        self.head_dim = hidden_size // num_attention_heads
        self.post_normalize = post_normalize
        self.enable_flash_attention = bool(enable_flash_attention)
        self.dtype = dtype
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerDecoderLayer(
                hidden_size, num_attention_heads, filter_size,
                ffn_activation, post_normalize, layer_postprocess_epsilon,
                attention_dropout_rate, ffn_dropout_rate,
                layer_postprocess_dropout_rate, dtype,
                with_cross_attention=with_cross_attention,
                **moe_layer_kwargs(i, moe_num_experts, moe_layer_frequency,
                                   moe_top_k, moe_capacity_factor,
                                   moe_aux_loss_coef, moe_router_jitter)))
        if not post_normalize:
            self.output_ln = LayerNorm(hidden_size,
                                       layer_postprocess_epsilon, dtype)

    def _layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def create_decoding_internal_cache(self, encoder_outputs,
                                       decode_padded_length: int,
                                       batch_size=None, device=None):
        """Zeroed self-attention buffers + precomputed cross k/v (without
        cross-attention ``encoder_outputs`` is None and ``batch_size`` and
        ``device`` size the buffers)."""
        batch = batch_size if encoder_outputs is None \
            else encoder_outputs.shape[0]
        device = device if encoder_outputs is None \
            else encoder_outputs.device
        cache = {}
        for i, layer in enumerate(self._layers()):
            def zeros():
                return torch.zeros(
                    (batch, decode_padded_length, self.num_heads,
                     self.head_dim), dtype=self.dtype,
                    device=device)
            layer_cache = {"self": {"keys": zeros(), "values": zeros()}}
            if self.with_cross_attention:
                layer_cache.update(layer.memorize_memory(encoder_outputs))
            cache[f"layer_{i}"] = layer_cache
        return cache

    @staticmethod
    def _lagging_bias(length, src_len, decode_step, lagging, device):
        if decode_step is None:
            return layer_utils.waitk_cross_attention_bias(
                length, src_len, lagging, device=device)
        if not isinstance(decode_step, int):
            raise NotImplementedError(
                "decode_lagging (wait-k) with per-row decode times "
                "(speculative decode) is unsupported")
        allowed = torch.arange(src_len, device=device) < (
            decode_step + torch.as_tensor(lagging, device=device))
        return torch.where(allowed, 0.0,
                           layer_utils.NEG_INF)[None, None, None, :]

    def forward(self, inputs, memory=None, memory_padding=None, cache=None,
                decode_step=None, decode_lagging=None, beam_anc=None,
                is_training=False, dropout_key=None):
        """Teacher forcing: ``inputs`` [B, T, D] under a causal mask.
        Stepwise decode: ``inputs`` [B, 1, D] at int ``decode_step`` with
        a cache from ``create_decoding_internal_cache`` (updated in
        place); or ``inputs`` [B, k, D] at per-row times ``decode_step``
        [B] (speculative decode's verification: row b's tokens at
        positions decode_step[b] + [0, k)).  ``beam_anc`` [B, beam,
        max_len]: the beam ancestor matrix the self-attention reads the
        cache through (single-token steps only).  Layer i draws
        its dropout masks from stream ``side << 16 | i << 4`` of
        ``dropout_key`` (``side`` is ``SIDE_DECODER`` unless the model
        gives another).

        ``decode_lagging`` (wait-k; an int or a 0-d tensor) masks the
        cross-attention so target position i sees source positions
        < i + lagging (at a decode step: < step + lagging); the mask is
        arbitrary, so both attentions then stay on the dense path.

        Returns (outputs, cache)."""
        use_flash = (self.enable_flash_attention and decode_step is None
                     and cache is None and decode_lagging is None)
        self_bias = memory_bias = cross_flash_lengths = None
        if decode_step is None:
            if not use_flash:
                self_bias = layer_utils.causal_self_attention_bias(
                    inputs.shape[1], device=inputs.device)
        else:
            max_len = cache["layer_0"]["self"]["keys"].shape[1]
            positions = torch.arange(max_len, device=inputs.device)
            if isinstance(decode_step, int):
                self_bias = torch.where(
                    positions <= decode_step, 0.0,
                    layer_utils.NEG_INF)[None, None, None, :]
            else:
                # per-row times [B] (speculative decode): query slot j of
                # row b sits at decode_step[b] + j and sees the cache
                # positions up to it -> [B, 1, k, max_len]
                qpos = decode_step[:, None] + torch.arange(
                    inputs.shape[1], device=inputs.device)
                self_bias = torch.where(
                    positions[None, None, None, :] <= qpos[:, None, :, None],
                    0.0, layer_utils.NEG_INF)
        if memory_padding is not None:
            if use_flash:
                cross_flash_lengths = (1.0 - memory_padding).sum(
                    dim=1).to(torch.int32)
            else:
                memory_bias = layer_utils.input_padding_to_bias(
                    memory_padding)
                if decode_lagging is not None:
                    memory_bias = memory_bias + self._lagging_bias(
                        inputs.shape[1], memory_padding.shape[1],
                        decode_step, decode_lagging, inputs.device)
        def run(x, lo, hi, args, key):
            for i in range(lo, hi):
                x = getattr(self, f"layer_{i}")(
                    x, self_attention_bias=self_bias,
                    memory=args["memory"], memory_bias=args["memory_bias"],
                    cache=None if cache is None else cache[f"layer_{i}"],
                    decode_step=decode_step, self_flash_causal=use_flash,
                    cross_flash_lengths=cross_flash_lengths,
                    beam_anc=beam_anc, is_training=is_training,
                    dropout_key=at_site(key, self.side << 16 | i << 4))
            return x

        args = {"memory": memory, "memory_bias": memory_bias}
        if self.pipeline_stages > 1 and is_training and cache is None:
            x = gpipe(self, run, inputs, args, self.num_layers,
                      self.pipeline_stages, self.pipeline_microbatches,
                      self.stage_group, DECODER_TAG, dropout_key)
        else:
            x = run(inputs, 0, self.num_layers, args, dropout_key)
        if not self.post_normalize:
            x = self.output_ln(x)
        return x, cache
