"""Mask/bias and beam helpers (counterpart of
``neurst_tpu/layers/layer_utils.py``, the subset the decode path uses).

Conventions as in the JAX package: ``padding`` is float, 1.0 at PAD and
0.0 at tokens; attention biases are additive, 0 where attendable and
``NEG_INF`` where masked.  A decoding cache is a nested dict of tensors;
the subtrees under ``CACHE_SKIP_KEYS`` are shared by a sentence's beams
and stay ``[B, ...]``.
"""

import torch

__all__ = ["NEG_INF", "CACHE_SKIP_KEYS", "input_length_to_padding",
           "input_padding_to_bias", "causal_self_attention_bias",
           "waitk_cross_attention_bias",
           "stack_beam_size", "stack_beam_size_selective",
           "gather_beams_selective", "self_cache_time_len",
           "cache_has_only_self_state"]

NEG_INF = -1.0e9
CACHE_SKIP_KEYS = ("memory", "memory_padding")


def input_length_to_padding(lengths, max_len: int):
    """[B] lengths -> [B, L] float padding (1.0 = pad)."""
    positions = torch.arange(max_len, device=lengths.device)[None, :]
    return (positions >= lengths[:, None]).float()


def input_padding_to_bias(padding, dtype=torch.float32):
    """[B, L] float padding -> [B, 1, 1, L] additive bias."""
    return (padding * NEG_INF).to(dtype)[:, None, None, :]


def causal_self_attention_bias(length: int, device=None,
                               dtype=torch.float32):
    """[1, 1, L, L] additive bias masking j > i (future positions)."""
    mask = torch.triu(torch.full((length, length), NEG_INF,
                                 dtype=torch.float32, device=device),
                      diagonal=1)
    return mask.to(dtype)[None, None]


def waitk_cross_attention_bias(query_len: int, memory_len: int, lagging,
                               device=None, dtype=torch.float32):
    """[1, 1, query_len, memory_len] wait-k bias: target position i sees
    source positions < i + ``lagging`` (an int or a 0-d tensor)."""
    q_pos = torch.arange(query_len, device=device)[:, None]
    m_pos = torch.arange(memory_len, device=device)[None, :]
    allowed = m_pos < q_pos + torch.as_tensor(lagging, device=device)
    return torch.where(allowed, 0.0, NEG_INF).to(dtype)[None, None]


def stack_beam_size(x, beam_size: int):
    """[B, ...] -> [B * beam, ...] by repeating each batch entry."""
    return torch.repeat_interleave(x, beam_size, dim=0)


def _map_cache(nested, fn, skip_keys, under_skip=False):
    if isinstance(nested, dict):
        return {k: _map_cache(v, fn, skip_keys,
                              under_skip or k in skip_keys)
                for k, v in nested.items()}
    if under_skip or nested is None:
        return nested
    return fn(nested)


def stack_beam_size_selective(nested, beam_size: int,
                              skip_keys=CACHE_SKIP_KEYS):
    """Tiles a cache to [B * beam, ...], leaving the subtrees under
    ``skip_keys`` (encoder-derived, identical across a sentence's beams)
    at [B, ...]."""
    return _map_cache(nested, lambda t: stack_beam_size(t, beam_size),
                      skip_keys)


def gather_beams_selective(nested, beam_indices, skip_keys=CACHE_SKIP_KEYS):
    """Reorders the leading batch*beam axis of every leaf outside
    ``skip_keys`` by ``beam_indices``."""
    return _map_cache(nested, lambda t: t.index_select(0, beam_indices),
                      skip_keys)


def _leaves_with_self_flag(nested, skip_keys=(), self_keys=("self",),
                           under_self=False):
    if isinstance(nested, dict):
        for k, v in nested.items():
            if k not in skip_keys:
                yield from _leaves_with_self_flag(
                    v, skip_keys, self_keys, under_self or k in self_keys)
    elif nested is not None:
        yield nested, under_self


def cache_has_only_self_state(nested, skip_keys=CACHE_SKIP_KEYS) -> bool:
    """True iff every step-indexed leaf (outside ``skip_keys``) lives
    under a ``"self"`` subtree (or is the ``"beam_anc"`` matrix), and
    there is at least one: the static [B, max_len, N, H] buffers that
    cache indirection reads through the ancestor matrix
    (``cache_is_prefix_chunkable`` in the JAX package)."""
    flags = [s for _, s in _leaves_with_self_flag(
        nested, skip_keys, ("self", "beam_anc"))]
    return bool(flags) and all(flags)


def self_cache_time_len(nested) -> int:
    """Time-axis length of the first ``"self"`` cache leaf."""
    for leaf, under_self in _leaves_with_self_flag(nested):
        if under_self:
            return leaf.shape[1]
    raise ValueError("cache has no 'self' leaves")
