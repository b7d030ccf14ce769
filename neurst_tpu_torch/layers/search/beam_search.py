"""Beam search as a Python loop over decode steps (counterpart of
``neurst_tpu/layers/search/beam_search.py``, same semantics): GNMT length
penalty, EOS forcing of finished beams, the UNK mask, the minimum
length, the t=0 restriction to beam 0, ``max_steps = min(enc_maxlen +
extra, max_len)``, the early exit once every beam has finished, and the
self-cache read through a beam ancestor matrix instead of a per-step
reorder.

The JAX loop's ``prefix_decode_chunk`` and ``decode_unroll`` are devices
of ``lax.while_loop`` and exact either way; they are accepted and
ignored here.  The early-exit test reads one flag from the device per
step.

``beam_step(decode_steps, state, time)`` is one step of the same search
as a function of tensors only, for ``torch.export`` (``exps/export.py``):
the state (``initial_beam_state``) holds the ids, the cache, finished
flags, scores, lengths and the predicted ids; ``time`` is a [B * beam]
tensor.  The decoder writes through its per-row-time path, the self
cache is reordered by a gather each step (no ancestor matrix), and the
t = 0 and minimum-length rules are ``torch.where``s of ``time``.  Either
way of reading the cache is exact; ``beam_search_result`` picks the
hypotheses from the final state.
"""

from typing import Callable

import torch

from neurst_tpu_torch.layers import layer_utils
from neurst_tpu_torch.layers.layer_utils import NEG_INF
from neurst_tpu_torch.layers.search.sequence_search import (
    SequenceSearch, register_search_layer)
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["sequence_beam_search", "BeamSearch", "initial_beam_state",
           "beam_step", "beam_search_result"]


def _length_penalty(lengths, alpha):
    """GNMT penalty; alpha None/negative -> 1/length."""
    lengths = lengths.float()
    if alpha is None or alpha < 0.0:
        return 1.0 / lengths.clamp_min(1.0)
    return ((5.0 + lengths) / 6.0) ** (-alpha)


def sequence_beam_search(symbols_to_logits_fn: Callable,
                         generation_initializer: dict,
                         top_k: int = 1,
                         beam_size: int = 4,
                         length_penalty: float = 0.6,
                         extra_decode_length: int = 50,
                         maximum_decode_length: int = 256,
                         minimum_decode_length: int = 0,
                         enable_unk: bool = False,
                         prefix_decode_chunk: int = 0,
                         decode_unroll: int = 1,
                         cache_indirection: bool = True):
    """Beam search over a stepwise decode function.

    symbols_to_logits_fn(ids [N], cache, t) -> (logits [N, V], cache),
    N = batch * beam.  ``generation_initializer`` as built by
    ``prepare_generation``.  ``prefix_decode_chunk`` and
    ``decode_unroll`` are ignored (see the module docstring).

    Returns (hypotheses int64 [B * top_k, maximum_decode_length],
    scores float32 [B * top_k])."""
    del prefix_decode_chunk, decode_unroll
    eos_id = int(generation_initializer["eos_id"])
    unk_id = None if enable_unk else generation_initializer.get("unk_id")
    decoder_input = generation_initializer["decoder_input"]
    device = decoder_input.device
    batch_size = decoder_input.shape[0]
    bb = batch_size * beam_size

    cache = layer_utils.stack_beam_size_selective(
        generation_initializer["decoder_internal_cache"], beam_size)
    input_ids = layer_utils.stack_beam_size(decoder_input.long(), beam_size)

    beam_range = torch.arange(beam_size, dtype=torch.long, device=device)
    use_indirection = (
        cache_indirection and beam_size > 1
        and bool(generation_initializer.get("beam_cache_indirection_ok"))
        and layer_utils.cache_has_only_self_state(cache))
    reorder_skip = layer_utils.CACHE_SKIP_KEYS
    if use_indirection:
        # row q's position-j key/value lives at beam row beam_anc[b, q, j]
        # of its sentence; identity start (the t=0 history is shared)
        full_len = layer_utils.self_cache_time_len(cache)
        cache = dict(cache, beam_anc=beam_range[None, :, None].expand(
            batch_size, beam_size, full_len).clone())
        reorder_skip = reorder_skip + ("self", "beam_anc")

    max_steps = layer_utils.max_decode_steps(
        generation_initializer, extra_decode_length, maximum_decode_length,
        minimum_decode_length)

    finished = torch.zeros(bb, dtype=torch.bool, device=device)
    log_probs_acc = torch.zeros(bb, dtype=torch.float32, device=device)
    lengths = torch.zeros(bb, dtype=torch.long, device=device)
    predicted = torch.zeros((bb, maximum_decode_length), dtype=torch.long,
                            device=device)
    beam_base = (torch.arange(bb, device=device) // beam_size) * beam_size
    not_first_beam = (torch.arange(bb, device=device) % beam_size) > 0

    # a prompt-prefilled decoder (GPT-2) writes step t at cache position
    # t + offset
    time_offset = int(generation_initializer.get("decode_time_offset", 0))
    time = 0
    while time < max_steps and not bool(finished.all()):
        if use_indirection:
            # a beam's own step-t entry is written to its own row
            cache["beam_anc"][:, :, time + time_offset] = beam_range[None, :]
        logits, new_cache = symbols_to_logits_fn(input_ids, cache, time)
        vocab_size = logits.shape[-1]
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        vocab = torch.arange(vocab_size, device=device)
        eos_onehot = vocab == eos_id

        # finished beams: force EOS (keep score), mask everything else
        finished_bias = torch.where(eos_onehot, 0.0, NEG_INF)[None, :]
        log_probs = torch.where(finished[:, None], finished_bias, log_probs)
        if unk_id is not None:
            log_probs = log_probs + torch.where(
                vocab == unk_id, NEG_INF, 0.0)[None, :]
        if minimum_decode_length > 0 and time < minimum_decode_length - 1:
            log_probs = log_probs + torch.where(
                eos_onehot, NEG_INF, 0.0)[None, :]

        cum = log_probs + log_probs_acc[:, None]
        next_length = lengths + 1 - finished.long()
        scores = cum * _length_penalty(next_length, length_penalty)[:, None]
        if time == 0:
            # all beams are identical at t=0: draw from beam 0 only
            scores = torch.where(not_first_beam[:, None],
                                 torch.full_like(scores, NEG_INF * 2.0),
                                 scores)

        _, top_idx = torch.topk(
            scores.reshape(batch_size, beam_size * vocab_size), beam_size,
            dim=-1)
        top_idx = top_idx.reshape(-1)
        word_ids = top_idx % vocab_size
        beam_ids = top_idx // vocab_size + beam_base

        lengths = next_length[beam_ids]
        log_probs_acc = cum.reshape(-1)[beam_ids * vocab_size + word_ids]
        predicted = predicted[beam_ids]
        predicted[:, time] = word_ids
        cache = layer_utils.gather_beams_selective(new_cache, beam_ids,
                                                   skip_keys=reorder_skip)
        if use_indirection:
            # the self cache stays in place; only the ancestor matrix
            # follows the beams
            local_ids = (top_idx // vocab_size).reshape(batch_size,
                                                        beam_size)
            anc = new_cache["beam_anc"]
            cache["beam_anc"] = torch.gather(
                anc, 1, local_ids[:, :, None].expand(-1, -1, anc.shape[-1]))
        finished = word_ids == eos_id
        input_ids = word_ids
        time += 1

    scores = (log_probs_acc * _length_penalty(lengths, length_penalty)
              ).reshape(batch_size, beam_size)
    top_scores, top_idx = torch.topk(scores, top_k, dim=-1)
    gather_idx = (top_idx + (torch.arange(batch_size, device=device)
                             * beam_size)[:, None]).reshape(-1)
    return predicted[gather_idx], top_scores.reshape(-1)


def initial_beam_state(generation_initializer: dict, beam_size: int,
                       maximum_decode_length: int) -> dict:
    """The state ``beam_step`` starts from: ids [B * beam] (the decoder
    input), the cache tiled to [B * beam] (the beam-shared subtrees stay
    [B]), finished (bool), scores (float32 accumulated log-probs),
    lengths (int64) and predicted ids [B * beam, maximum_decode_length]
    (int64)."""
    decoder_input = generation_initializer["decoder_input"]
    device = decoder_input.device
    bb = decoder_input.shape[0] * beam_size
    return {
        "ids": layer_utils.stack_beam_size(decoder_input.long(), beam_size),
        "cache": layer_utils.stack_beam_size_selective(
            generation_initializer["decoder_internal_cache"], beam_size),
        "finished": torch.zeros(bb, dtype=torch.bool, device=device),
        "scores": torch.zeros(bb, dtype=torch.float32, device=device),
        "lengths": torch.zeros(bb, dtype=torch.long, device=device),
        "predicted": torch.zeros((bb, maximum_decode_length),
                                 dtype=torch.long, device=device)}


def beam_step(decode_steps: Callable, state: dict, time: torch.Tensor, *,
              beam_size: int, eos_id: int, unk_id=None,
              length_penalty: float = 0.6,
              minimum_decode_length: int = 0) -> dict:
    """One step of ``sequence_beam_search`` on tensors only.

    decode_steps(ids [N, 1], cache, times [N]) -> (logits [N, 1, V],
    cache) is the model's per-row-time decode (the cache's self buffers
    are written in place); ``time`` [N] holds the step (every row the
    same).  ``unk_id`` None allows UNK.  Returns the next state."""
    ids, finished = state["ids"], state["finished"]
    device = ids.device
    bb = ids.shape[0]
    batch_size = bb // beam_size
    logits, new_cache = decode_steps(ids[:, None], state["cache"], time)
    log_probs = torch.log_softmax(logits[:, 0].float(), dim=-1)
    vocab_size = log_probs.shape[-1]
    vocab = torch.arange(vocab_size, device=device)
    eos_onehot = vocab == eos_id

    finished_bias = torch.where(eos_onehot, 0.0, NEG_INF)[None, :]
    log_probs = torch.where(finished[:, None], finished_bias, log_probs)
    if unk_id is not None:
        log_probs = log_probs + torch.where(
            vocab == unk_id, NEG_INF, 0.0)[None, :]
    if minimum_decode_length > 0:
        early = (time < minimum_decode_length - 1)[:, None]
        log_probs = torch.where(
            early, log_probs + torch.where(eos_onehot, NEG_INF,
                                           0.0)[None, :], log_probs)

    cum = log_probs + state["scores"][:, None]
    next_length = state["lengths"] + 1 - finished.long()
    scores = cum * _length_penalty(next_length, length_penalty)[:, None]
    # all beams are identical at t = 0: draw from beam 0 only
    rows = torch.arange(bb, device=device)
    first_step_mask = ((time == 0) & (rows % beam_size > 0))[:, None]
    scores = torch.where(first_step_mask,
                         torch.full_like(scores, NEG_INF * 2.0), scores)

    _, top_idx = torch.topk(
        scores.reshape(batch_size, beam_size * vocab_size), beam_size,
        dim=-1)
    top_idx = top_idx.reshape(-1)
    word_ids = top_idx % vocab_size
    beam_ids = top_idx // vocab_size + (rows // beam_size) * beam_size
    predicted = state["predicted"].index_select(0, beam_ids).scatter(
        1, time[:, None].long(), word_ids[:, None])
    return {
        "ids": word_ids,
        "cache": layer_utils.gather_beams_selective(new_cache, beam_ids),
        "finished": word_ids == eos_id,
        "scores": cum.reshape(-1)[beam_ids * vocab_size + word_ids],
        "lengths": next_length.index_select(0, beam_ids),
        "predicted": predicted}


def beam_search_result(state: dict, beam_size: int, top_k: int = 1,
                       length_penalty: float = 0.6):
    """(hypotheses int64 [B * top_k, max_len], scores float32
    [B * top_k]) of a final ``beam_step`` state, as
    ``sequence_beam_search`` returns them."""
    bb = state["scores"].shape[0]
    batch_size = bb // beam_size
    scores = (state["scores"] * _length_penalty(state["lengths"],
                                                length_penalty)
              ).reshape(batch_size, beam_size)
    top_scores, top_idx = torch.topk(scores, top_k, dim=-1)
    gather_idx = (top_idx + (torch.arange(batch_size, device=scores.device)
                             * beam_size)[:, None]).reshape(-1)
    return state["predicted"][gather_idx], top_scores.reshape(-1)


@register_search_layer("beam_search")
class BeamSearch(SequenceSearch):
    """Search layer wrapping ``sequence_beam_search``."""

    @staticmethod
    def class_or_method_args():
        return [
            Flag("beam_size", dtype=Flag.TYPE.INTEGER, default=4,
                 help="The beam width of beam search inference."),
            Flag("length_penalty", dtype=Flag.TYPE.FLOAT, default=0.6,
                 help="The length penalty (GNMT); negative for average "
                      "log-prob normalization."),
            Flag("top_k", dtype=Flag.TYPE.INTEGER, default=1,
                 help="The number of hypotheses returned per sample."),
            Flag("maximum_decode_length", dtype=Flag.TYPE.INTEGER,
                 default=256, help="The maximum decoding length."),
            Flag("minimum_decode_length", dtype=Flag.TYPE.INTEGER, default=0,
                 help="The minimum decoding length."),
            Flag("extra_decode_length", dtype=Flag.TYPE.INTEGER, default=50,
                 help="Decode up to source length + this many steps."),
            Flag("enable_unk", dtype=Flag.TYPE.BOOLEAN, default=False,
                 help="Whether UNK may be generated."),
            Flag("prefix_decode_chunk", dtype=Flag.TYPE.INTEGER, default=64,
                 help="Accepted and ignored (a device of the JAX loop; "
                      "exact either way)."),
            Flag("decode_unroll", dtype=Flag.TYPE.INTEGER, default=4,
                 help="Accepted and ignored (a device of the JAX loop; "
                      "exact either way)."),
            Flag("cache_indirection", dtype=Flag.TYPE.BOOLEAN, default=True,
                 help="Read the self kv-cache through a per-beam "
                      "ancestor-index matrix instead of reordering it "
                      "every step (exact)."),
            Flag("padded_decode", dtype=Flag.TYPE.BOOLEAN, default=True,
                 help="Decode into a static-shape cache (the only mode; "
                      "false raises)."),
            Flag("ensemble_weights", dtype=Flag.TYPE.STRING, default=None,
                 help="Comma-separated model weights for ensemble decode "
                      "(the predict entry reads them where --model_dir "
                      "names several dirs)."),
        ]

    def __init__(self, args=None):
        super().__init__(args)
        if self.args.get("padded_decode") is not None \
                and not self.args["padded_decode"]:
            raise NotImplementedError("padded_decode: false is not ported "
                                      "(decode is static-shape only)")

    def __call__(self, inputs: dict):
        a = self.args
        max_len = a.get("maximum_decode_length") or 256
        with torch.inference_mode():
            s2l, init = self.model.prepare_generation(
                inputs, decode_padded_length=max_len)
            return sequence_beam_search(
                s2l, init,
                top_k=a.get("top_k") or 1,
                beam_size=a.get("beam_size") or 4,
                length_penalty=(-1.0 if a.get("length_penalty") is None
                                else a["length_penalty"]),
                extra_decode_length=a.get("extra_decode_length") or 50,
                maximum_decode_length=max_len,
                minimum_decode_length=a.get("minimum_decode_length") or 0,
                enable_unk=bool(a.get("enable_unk")),
                cache_indirection=(True if a.get("cache_indirection") is None
                                   else bool(a["cache_indirection"])))
