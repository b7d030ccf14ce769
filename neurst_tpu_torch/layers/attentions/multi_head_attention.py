"""Multi-head attention with a static-shape decode cache (counterpart of
``neurst_tpu/layers/attentions/multi_head_attention.py``).

Fused projections: ``qkv_transform`` (self) and ``q_transform`` /
``kv_transform`` (cross) are single denses whose outputs split as [...,
n_proj, heads, head_dim], matching the flax kernels [D, n_proj, N, H];
each dense is ``quant_layers.dense_general``'s (an ``nn.Linear``, or
under QAT or int8 serving the quantized dense with one clip or scale
set per JAX module).  Logits and softmax run in float32 whatever the
compute dtype; training in bf16 keeps only the bf16 probabilities for
the backward (``_SoftmaxBf16Residual``), as the JAX module does.
Attention dropout takes the site's key (``dropout_key``): the dense path
drops the weights through ``apply_dropout``, the flash path inside the
kernels, as the JAX module's ``_flash_dropout`` does.

The decode cache is a dict {"keys", "values"} of [B * beam, max_len,
N, H] buffers.  Unlike the functional JAX update, ``decode_step``
writes the step's key/value into those buffers in place, so a decode
step allocates no new cache.  Under beam search the rows never move:
``_attend_indirect`` reads position j of row q from beam row
``beam_anc[b, q, j]``, selected with a gather (the JAX module selects
the same dot products with a one-hot).

Tensor parallelism (``parallel.apply_mesh`` sets ``tp_group`` and cuts
the projections to this rank's heads): the q/k/v projections are
column-parallel (their input goes through ``collectives.copy_to``), the
attention runs on the local heads (the flash kernels included), and the
output projection is row-parallel: its partial sums are all-reduced
(``reduce_from``) before its bias is added once (``common_layers.
row_linear``; a quantized projection runs its own row-parallel form, its
fake quant or int8 scales included).  Attention dropout then folds the
rank's model coordinate into the site's key.  With ``ring``
(a ring group and the global key lengths) the self-attention runs as
``ops/ring_attention.py`` over the time shards, without dropout.
"""

import torch
from torch import nn

from neurst_tpu_torch.layers.common_layers import (apply_dropout, linear,
                                                   row_linear)
from neurst_tpu_torch.layers.quantization.quant_layers import dense_general
from neurst_tpu_torch.ops.flash_attention import flash_attention
from neurst_tpu_torch.ops.ring_attention import ring_self_attention
from neurst_tpu_torch.parallel import collectives
from neurst_tpu_torch.utils.rng import at_shard

__all__ = ["MultiHeadAttention", "MultiHeadSelfAttention"]


class _SoftmaxBf16Residual(torch.autograd.Function):
    """softmax(z float32) stored, and saved for the backward, as bf16:
    dz = p (dp - sum(dp p)) from the rounded p, so the float32 [B, N, F, T]
    probabilities are not kept alive between forward and backward."""

    @staticmethod
    def forward(ctx, z):
        p = torch.softmax(z, dim=-1).to(torch.bfloat16)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, dp):
        p32 = ctx.saved_tensors[0].float()
        dp32 = dp.float()
        return p32 * (dp32 - (dp32 * p32).sum(dim=-1, keepdim=True))


class MultiHeadAttention(nn.Module):
    """Cross-attention (q from the query; k/v from memory or a cache)."""

    def __init__(self, num_heads: int, num_units: int,
                 attention_dropout_rate: float = 0.0, dtype=torch.float32):
        super().__init__()
        if num_units % num_heads:
            raise ValueError(f"num_units {num_units} is not a multiple of "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.head_dim = num_units // num_heads
        self.attention_dropout_rate = attention_dropout_rate
        self.dtype = dtype
        # tensor parallelism (parallel.apply_mesh): the model group, this
        # rank's place in it and the group's size
        self.tp_group, self.tp_rank, self.tp_size = None, 0, 1
        self._build_projections(num_units)
        self.output_transform = dense_general(num_units, num_units)

    def _build_projections(self, num_units):
        self.q_transform = dense_general(num_units, num_units)
        self.kv_transform = dense_general(num_units, 2 * num_units)

    def _proj(self, layer, x, n_proj):
        """-> [B, L, n_proj, N, H] in the compute dtype (N the local
        heads)."""
        y = linear(layer, collectives.copy_to(x, self.tp_group), self.dtype)
        return y.view(*y.shape[:-1], n_proj, self.num_heads, self.head_dim)

    def _output(self, out):
        """[B, F, N, H] -> output_transform -> [B, F, D]."""
        out = out.reshape(*out.shape[:2], -1)
        return row_linear(self.output_transform, out, self.dtype,
                          self.tp_group)

    def _site(self, dropout_key):
        """The attention dropout key of this rank's heads."""
        if self.tp_size > 1:
            return at_shard(dropout_key, self.tp_rank)
        return dropout_key

    def _attend(self, q, k, v, bias, is_training=False, dropout_key=None):
        """q [B, F, N, H], k/v [B, T, N, H], bias broadcastable to
        [B, N, F, T]."""
        q = q * (self.head_dim ** -0.5)
        logits = torch.einsum("btnh,bfnh->bnft", k.float(), q.float())
        if bias is not None:
            logits = logits + bias.float()
        if is_training and self.dtype == torch.bfloat16:
            weights = _SoftmaxBf16Residual.apply(logits)
        else:
            weights = torch.softmax(logits, dim=-1).to(self.dtype)
        weights = apply_dropout(weights, self.attention_dropout_rate,
                                is_training, self._site(dropout_key))
        out = torch.einsum("bnft,btnh->bfnh", weights, v.to(self.dtype))
        return self._output(out)

    def _flash(self, q, k, v, lengths, causal, is_training, dropout_key):
        """The flash kernels (differentiable), with the attention dropout
        inside them in training."""
        rate = self.attention_dropout_rate if is_training else 0.0
        return self._output(flash_attention(
            q, k, v, lengths, causal=causal, dropout_rate=rate,
            dropout_key=self._site(dropout_key) if rate else None))

    def compute_kv(self, memory):
        """Projects memory to (k, v), each [B, T, N, H]."""
        kv = self._proj(self.kv_transform, memory, 2)
        return kv[:, :, 0], kv[:, :, 1]

    def forward(self, query, memory=None, bias=None, cache=None,
                flash_lengths=None, is_training=False, dropout_key=None):
        """-> [B, F, D].  With ``flash_lengths`` (valid key counts, no
        cache) the flash kernels compute the attention."""
        q = self._proj(self.q_transform, query, 1)[:, :, 0]
        if cache is not None:
            k, v = cache["keys"], cache["values"]
        else:
            k, v = self.compute_kv(memory)
        if cache is None and flash_lengths is not None:
            return self._flash(q, k, v, flash_lengths, False, is_training,
                               dropout_key)
        if cache is not None and q.shape[0] != k.shape[0]:
            # beam-shared k/v: the [B * beam] query rows join the query
            # axis of their sentence's [B] memory, then split again
            b = k.shape[0]
            beam, f = q.shape[0] // b, q.shape[1]
            qg = q.reshape(b, beam * f, *q.shape[2:])
            out = self._attend(qg, k, v, bias)
            return out.reshape(b * beam, f, out.shape[-1])
        return self._attend(q, k, v, bias, is_training, dropout_key)


class MultiHeadSelfAttention(MultiHeadAttention):
    """Self-attention with a fused qkv projection and the static cache."""

    def _build_projections(self, num_units):
        self.qkv_transform = dense_general(num_units, 3 * num_units)

    def _attend_indirect(self, q, k, v, bias, beam_anc):
        """Decode-step attention reading the cache through the beam
        ancestor matrix: position j of row (b, q) lives at beam row
        ``beam_anc[b, q, j]`` of its sentence.

        q [BB, 1, N, H]; k/v [BB, T, N, H]; beam_anc int64 [B, beam, T]
        with BB = B * beam."""
        batch, beam, t_len = beam_anc.shape
        idx = beam_anc[:, :, :, None, None].expand(
            batch, beam, t_len, self.num_heads, self.head_dim)

        def select(x):
            xg = x.reshape(batch, beam, t_len, self.num_heads, self.head_dim)
            return torch.gather(xg, 1, idx).reshape(x.shape)

        return self._attend(q, select(k), select(v), bias)

    def forward(self, query, bias=None, cache=None, decode_step=None,
                flash_lengths=None, flash_causal=False, beam_anc=None,
                is_training=False, dropout_key=None, ring=None):
        """Self-attention over ``query`` [B, F, D] -> [B, F, D].

        With ``flash_lengths`` (no cache) the flash kernels compute it
        (key-length mask, optional causal).  Incremental mode
        (``decode_step`` an int): the step's key/value are written into
        ``cache`` at ``decode_step`` in place; the caller's ``bias`` masks
        positions after it.  With per-row times (``decode_step`` a [B]
        tensor) row b's keys/values are written at ``decode_step[b]`` on,
        and no ``beam_anc`` is read."""
        qkv = self._proj(self.qkv_transform, query, 3)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cache is None and ring is not None:
            group, lengths = ring
            return self._output(ring_self_attention(
                q, k, v, group, lengths, causal=flash_causal))
        if cache is None and flash_lengths is not None:
            return self._flash(q, k, v, flash_lengths, flash_causal,
                               is_training, dropout_key)
        if cache is not None and decode_step is not None:
            f = q.shape[1]
            if isinstance(decode_step, int):
                cache["keys"][:, decode_step:decode_step + f] = k
                cache["values"][:, decode_step:decode_step + f] = v
            else:
                # per-row times [B] (speculative decode): row b's f slots
                # land at decode_step[b] + [0, f); the caller sizes the
                # cache so that no window runs off its end
                rows = torch.arange(q.shape[0], device=q.device)[:, None]
                cols = decode_step[:, None] + torch.arange(f,
                                                           device=q.device)
                cache["keys"][rows, cols] = k.to(cache["keys"].dtype)
                cache["values"][rows, cols] = v.to(cache["values"].dtype)
            k, v = cache["keys"], cache["values"]
            if beam_anc is not None and f == 1 \
                    and isinstance(decode_step, int):
                return self._attend_indirect(q, k, v, bias, beam_anc)
        return self._attend(q, k, v, bias, is_training, dropout_key)
