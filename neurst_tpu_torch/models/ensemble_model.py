"""Decode-time ensembles (the port's counterpart of
``neurst_tpu/models/ensemble_model.py``).

Several restored models behind the generation interface beam search
drives (``prepare_generation``).  Each member encodes the source and
keeps its own decoding cache; at every step the members' distributions
are mixed in probability space with the normalized weights,
p = sum_i w_i softmax(z_i), and the search receives logits whose
log-softmax is log p.

The logits handed back are member 0's own plus a per-token correction,

    z_0 + log sum_i w_i exp(l_i - l_0),    l_i = log_softmax(z_i),

which differs from log p by the constant logsumexp(z_0) a row, so the
search's log-softmax gives log p; the sum is taken relative to its
largest term, so no exponential overflows.  Where every member gives
member 0's logits (one model dir named twice) every term is w_i exp(0),
the correction is exactly 0, and the search sees the single model's
logits bit for bit: the ensemble then reproduces its hypotheses exactly.

The beam search's ancestor matrix (``beam_anc``, cache indirection) lives
at the top of the ensemble's cache and is handed to each member's
decoder; cache indirection is used only where every member allows it.
"""

from typing import List, Optional, Sequence

import torch

__all__ = ["EncoderDecoderEnsembleModel"]


class EncoderDecoderEnsembleModel(object):
    """``models``: restored models on one device; ``weights``: one a
    model (equal where None), normalized to sum to 1."""

    def __init__(self, models: List,
                 weights: Optional[Sequence[float]] = None):
        if not models:
            raise ValueError("an ensemble needs at least one model")
        if weights is None:
            weights = [1.0 / len(models)] * len(models)
        if len(weights) != len(models):
            raise ValueError(f"{len(weights)} ensemble weights for "
                             f"{len(models)} models")
        total = sum(weights)
        self.models = list(models)
        self.weights = [w / total for w in weights]

    @property
    def device(self) -> torch.device:
        return self.models[0].device

    def prepare_generation(self, inputs, decode_padded_length: int):
        """Every member's ``prepare_generation`` on ``inputs``; returns
        (symbols_to_logits_fn, generation_initializer) with the members'
        caches under ``model_<i>`` and member 0's eos / unk ids."""
        fns, inits = [], []
        for model in self.models:
            fn, init = model.prepare_generation(inputs, decode_padded_length)
            fns.append(fn)
            inits.append(init)
        weights = torch.tensor(self.weights, dtype=torch.float32,
                               device=self.device)[:, None, None]

        def symbols_to_logits_fn(ids, cache, time):
            anc = cache.get("beam_anc")
            new_cache = {} if anc is None else {"beam_anc": anc}
            logits = []
            for i, fn in enumerate(fns):
                cache_i = cache[f"model_{i}"]
                if anc is not None:
                    cache_i = dict(cache_i, beam_anc=anc)
                z, cache_i = fn(ids, cache_i, time)
                new_cache[f"model_{i}"] = {
                    k: v for k, v in cache_i.items() if k != "beam_anc"}
                logits.append(z.float())
            first = torch.log_softmax(logits[0], dim=-1)
            diffs = torch.stack([torch.log_softmax(z, dim=-1) - first
                                 for z in logits])
            top = diffs.max(dim=0).values
            mixed = (torch.exp(diffs - top) * weights).sum(dim=0)
            return logits[0] + (top + torch.log(mixed)), new_cache

        generation_initializer = dict(inits[0])
        generation_initializer["decoder_internal_cache"] = {
            f"model_{i}": init["decoder_internal_cache"]
            for i, init in enumerate(inits)}
        generation_initializer["beam_cache_indirection_ok"] = all(
            init.get("beam_cache_indirection_ok") for init in inits)
        return symbols_to_logits_fn, generation_initializer
