"""Ancestral sampling with top-k / top-p (nucleus) filtering, as a Python
loop over decode steps (counterpart of
``neurst_tpu/layers/search/sampling.py``, same semantics): temperature,
the UNK mask and the minimum length in ``masked_step_log_probs`` (the one
definition of the target distribution), ``max_steps = max(min(enc_maxlen
+ extra, max_len), min_len)``, EOS forcing of finished samples and the
early exit once every sample has finished.

Draws come from an explicit ``torch.Generator`` on the logits' device
(``TopSampling`` seeds one from its ``seed`` flag): a step draws Exp(1)
noise q [N, V] and takes ``argmax(p / q)``, an exact draw from p and the
token ``torch.multinomial(p, 1)`` picks from the same generator.
``sampling_update`` is the one step body, of the eager loop and of the
exported step (``sampling_step``).  The draws cannot be the JAX
package's threefry draws; ``top_k=1`` (without a nucleus filter) is the
argmax in both and draws nothing.  The flags
``prefix_decode_chunk`` and ``decode_unroll`` (devices of the JAX while
loop, exact either way) are accepted and ignored.
"""

from typing import Callable

import torch

from neurst_tpu_torch.layers import layer_utils
from neurst_tpu_torch.layers.layer_utils import NEG_INF
from neurst_tpu_torch.layers.search.sequence_search import (
    SequenceSearch, register_search_layer)
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["masked_step_log_probs", "filter_log_probs", "sequence_sampling",
           "TopSampling", "sampling_step", "sampling_update",
           "exponential_draws"]


def masked_step_log_probs(logits, emit_index, eos_id, unk_id, temperature,
                          minimum_decode_length):
    """Temperature, UNK and minimum-length masked log-probs [..., V]:
    the target distribution of a step.  ``emit_index``: the 0-based output
    position (an int, or a tensor broadcasting over the leading axes)."""
    logits = logits.float()
    if temperature and temperature != 1.0:
        logits = logits / temperature
    lp = torch.log_softmax(logits, dim=-1)
    vocab = torch.arange(lp.shape[-1], device=lp.device)
    if unk_id is not None:
        lp = lp + torch.where(vocab == unk_id, NEG_INF, 0.0)
    if minimum_decode_length > 0:
        eos_mask = torch.where(vocab == eos_id, NEG_INF, 0.0)
        cond = torch.as_tensor(emit_index < minimum_decode_length - 1,
                               device=lp.device)
        lp = lp + torch.where(cond[..., None], eos_mask, 0.0)
    return lp


def _filter_top_k(log_probs, k):
    """Keeps the k largest entries (and their ties); NEG_INF elsewhere."""
    kth = torch.topk(log_probs, k, dim=-1).values[..., -1:]
    return torch.where(log_probs < kth, NEG_INF, log_probs)


def _filter_top_p(log_probs, p):
    """Nucleus filtering: keeps the smallest prefix of the sorted
    vocabulary whose probability mass exceeds ``p`` (an entry stays when
    the mass before it is < p)."""
    sorted_lp = torch.sort(log_probs, dim=-1, descending=True).values
    probs = torch.exp(sorted_lp)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p
    threshold = torch.where(keep_sorted, sorted_lp,
                            torch.full_like(sorted_lp, float("inf"))
                            ).min(dim=-1, keepdim=True).values
    return torch.where(log_probs < threshold, NEG_INF, log_probs)


def filter_log_probs(log_probs, top_k: int = 0, top_p: float = 1.0):
    """The top-k, then nucleus, filter of ``log_probs`` [..., V]
    (NEG_INF at the entries dropped): what a sample is drawn from."""
    if top_k and top_k > 0:
        log_probs = _filter_top_k(log_probs, top_k)
    if top_p and top_p < 1.0:
        log_probs = _filter_top_p(log_probs, top_p)
    return log_probs


def sequence_sampling(symbols_to_logits_fn: Callable,
                      generation_initializer: dict,
                      generator: torch.Generator = None,
                      top_k: int = 0, top_p: float = 1.0,
                      temperature: float = 1.0, num_samples: int = 1,
                      extra_decode_length: int = 50,
                      maximum_decode_length: int = 256,
                      minimum_decode_length: int = 0,
                      enable_unk: bool = False):
    """Samples sequences stepwise over ``symbols_to_logits_fn(ids [N],
    cache, t) -> (logits [N, V], cache)``, N = batch * num_samples.

    Returns (ids int64 [B * num_samples, maximum_decode_length], scores
    float32 [B * num_samples], the summed log-probs of the drawn
    tokens)."""
    eos_id = int(generation_initializer["eos_id"])
    unk_id = None if enable_unk else generation_initializer.get("unk_id")
    decoder_input = generation_initializer["decoder_input"]
    device = decoder_input.device
    bb = decoder_input.shape[0] * num_samples
    greedy = top_k == 1 and (not top_p or top_p >= 1.0)
    if not greedy and generator is None:
        raise ValueError("sampling needs a torch.Generator (top_k=1 "
                         "without top_p is the argmax and needs none)")

    # the memory stays [B, ...]: the samples of a sentence share it
    cache = layer_utils.stack_beam_size_selective(
        generation_initializer["decoder_internal_cache"], num_samples)
    input_ids = layer_utils.stack_beam_size(decoder_input.long(),
                                            num_samples)
    max_steps = layer_utils.max_decode_steps(
        generation_initializer, extra_decode_length, maximum_decode_length,
        minimum_decode_length)

    state = {"ids": input_ids, "cache": cache,
             "finished": torch.zeros(bb, dtype=torch.bool, device=device),
             "scores": torch.zeros(bb, dtype=torch.float32, device=device),
             "predicted": torch.zeros((bb, maximum_decode_length),
                                      dtype=torch.long, device=device)}
    time = 0
    while time < max_steps and not bool(state["finished"].all()):
        logits, cache = symbols_to_logits_fn(state["ids"], state["cache"],
                                             time)
        draws = None if greedy else exponential_draws(logits.shape,
                                                      generator, device)
        state = sampling_update(
            state, logits, cache, torch.full((bb,), time, device=device),
            draws, eos_id=eos_id, unk_id=unk_id, top_k=top_k, top_p=top_p,
            temperature=temperature,
            minimum_decode_length=minimum_decode_length)
        time += 1
    return state["predicted"], state["scores"]


def exponential_draws(shape, generator, device) -> torch.Tensor:
    """The float32 Exp(1) draws [N, V] of a sampling step: the draws that
    one ``torch.multinomial(p, 1, generator=generator)`` of probabilities
    [N, V] takes from its generator, whose pick ``argmax(p / q)`` (ATen's
    one-sample path) ``sampling_update`` takes too."""
    return torch.empty(shape, dtype=torch.float32,
                       device=device).exponential_(1, generator=generator)


def sampling_update(state: dict, logits: torch.Tensor, cache,
                    time: torch.Tensor, draws, *, eos_id: int, unk_id=None,
                    top_k: int = 0, top_p: float = 1.0,
                    temperature: float = 1.0,
                    minimum_decode_length: int = 0) -> dict:
    """The state after a step of ``sequence_sampling`` (ids, cache,
    finished, scores, predicted) from the step's logits [N, V] and
    ``cache``: ``time`` [N] the step, ``draws`` [N, V] its
    ``exponential_draws`` (unused for the argmax of ``top_k`` 1)."""
    finished = state["finished"]
    log_probs = masked_step_log_probs(logits, time, eos_id, unk_id,
                                      temperature, minimum_decode_length)
    if top_k == 1 and (not top_p or top_p >= 1.0):
        sampled = log_probs.argmax(dim=-1)
    else:
        probs = torch.softmax(filter_log_probs(log_probs, top_k, top_p),
                              dim=-1)
        sampled = (probs / draws).argmax(dim=-1)
    sampled = torch.where(finished, eos_id, sampled)
    step_lp = log_probs.gather(1, sampled[:, None])[:, 0]
    return dict(state, ids=sampled, cache=cache,
                finished=finished | (sampled == eos_id),
                scores=state["scores"] + torch.where(finished, 0.0, step_lp),
                predicted=state["predicted"].scatter(
                    1, time[:, None].long(), sampled[:, None]))


def sampling_step(decode_steps: Callable, state: dict, time: torch.Tensor,
                  draws: torch.Tensor, **search) -> dict:
    """One step of ``sequence_sampling`` on tensors only (the exported
    sampling step): ``state`` as ``beam_search.initial_beam_state`` gives
    it at beam ``num_samples``, ``decode_steps(ids [N, 1], cache, times
    [N])`` the model's per-row-time decode, ``search`` the keywords of
    ``sampling_update``.  Returns the next state."""
    logits, cache = decode_steps(state["ids"][:, None], state["cache"], time)
    return sampling_update(state, logits[:, 0], cache, time, draws, **search)


@register_search_layer("top_sampling", "sampling")
class TopSampling(SequenceSearch):

    @staticmethod
    def class_or_method_args():
        return [
            Flag("top_k", dtype=Flag.TYPE.INTEGER, default=0,
                 help="Sample from the top-k tokens (0 = whole vocab)."),
            Flag("top_p", dtype=Flag.TYPE.FLOAT, default=1.0,
                 help="Nucleus sampling probability mass (1.0 = off)."),
            Flag("temperature", dtype=Flag.TYPE.FLOAT, default=1.0,
                 help="Softmax temperature."),
            Flag("num_samples", dtype=Flag.TYPE.INTEGER, default=1,
                 help="The number of samples per input."),
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
            Flag("seed", dtype=Flag.TYPE.INTEGER, default=0,
                 help="The sampling random seed."),
        ]

    def __call__(self, inputs: dict):
        """(ids, scores) of ``sequence_sampling``, drawn by a generator on
        the model's device seeded with ``seed``."""
        a = self.args
        max_len = a.get("maximum_decode_length") or 256
        generator = torch.Generator(device=self.model.device)
        generator.manual_seed(int(a.get("seed") or 0))
        with torch.inference_mode():
            s2l, init = self.model.prepare_generation(
                inputs, decode_padded_length=max_len)
            return sequence_sampling(
                s2l, init, generator,
                top_k=a.get("top_k") or 0,
                top_p=a.get("top_p") or 1.0,
                temperature=a.get("temperature") or 1.0,
                num_samples=a.get("num_samples") or 1,
                extra_decode_length=a.get("extra_decode_length") or 50,
                maximum_decode_length=max_len,
                minimum_decode_length=a.get("minimum_decode_length") or 0,
                enable_unk=bool(a.get("enable_unk")))
