"""Speculative decoding (counterpart of
``neurst_tpu/layers/search/speculative.py``, same semantics): a draft
proposes ``k`` tokens a row, the target verifies them in one multi-token
pass at per-row times (``prepare_speculative`` -> ``decode_steps``), and
the longest agreeing prefix commits with the target's own next token as
the correction, so greedy output equals the target's greedy decode.  The
draft is a second model or the self-drafting n-gram lookup
(``make_ngram_draft``); ``speculative_beam_search`` replays the exact
beam update over one verification pass; sampling verifies by
acceptance-rejection (min(1, p / q), residual resample), which keeps
every emitted token distributed as plain sampling from the target.

The JAX package runs one ``lax.while_loop`` on the device; here the loop
is Python and reads one value from the device a target pass (the
finished flags, with the committed count in the beam search), not one a
token.  Caches are written in place at each row's time and are sized
``maximum_decode_length + k`` by the layer, so no k-wide window runs off
the end (torch indexing does not clamp, where JAX's
``dynamic_update_slice`` does).  Rejected draft positions keep stale
keys and values: the decode bias masks them, and the next window, which
starts at the row's first uncommitted position, overwrites them before
they are read.  Sampling draws come from a ``torch.Generator``, not
threefry.

As in the JAX package, the ``SpeculativeDecode`` layer decodes greedily
(or samples) whatever ``beam_size`` says (ROADMAP R14):
``speculative_beam_search`` is reached only by calling it.
"""

import functools
import logging

import torch

from neurst_tpu_torch.layers import layer_utils
from neurst_tpu_torch.layers.layer_utils import NEG_INF
from neurst_tpu_torch.layers.quantization.quant_layers import \
    int8_static_act_enabled
from neurst_tpu_torch.layers.search.beam_search import _length_penalty
from neurst_tpu_torch.layers.search.sampling import (filter_log_probs,
                                                     masked_step_log_probs)
from neurst_tpu_torch.layers.search.sequence_search import (
    SequenceSearch, register_search_layer)
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["make_ngram_draft", "ngram_steps", "speculative_greedy_decode",
           "initial_speculative_state", "speculative_greedy_step",
           "speculative_sampling_step",
           "speculative_result", "speculative_beam_search",
           "SpeculativeDecode"]


def make_ngram_draft(batch, buffer_len, vocab_size, ngram=3, prefix=None,
                     device=None):
    """The self-drafting n-gram lookup (prompt-lookup decoding): each
    draft step proposes the continuation of the most recent earlier
    occurrence of the current (ngram - 1)-token suffix among the tokens
    fed so far, optionally preceded by a lookup ``prefix`` [B, P] (the
    source ids of a shared vocabulary, an LM's prompt; -1 at pads, which
    no token equals).  A miss proposes the last token again.

    Returns (steps_fn(ids [B, 1], cache, times [B]) -> (one-hot logits
    [B, 1, V] x 1e4, cache), initializer): the draft "cache" is the token
    buffer [B, P + ``buffer_len``], written in place at P + times, which
    must cover ``maximum_decode_length + k``."""
    if prefix is not None:
        device = prefix.device
    gen = torch.full((batch, buffer_len), -1, dtype=torch.long,
                     device=device)
    p_len = 0 if prefix is None else prefix.shape[1]
    init_buf = gen if prefix is None \
        else torch.cat([prefix.long(), gen], dim=1)
    steps_fn = ngram_steps(batch, p_len + buffer_len, p_len, vocab_size,
                           ngram, device)
    return steps_fn, {"decoder_internal_cache": {"buffer": init_buf}}


def ngram_steps(batch, total_len, prefix_len, vocab_size, ngram=3,
                device=None):
    """``make_ngram_draft``'s steps_fn over a token buffer [B, total_len]
    whose first ``prefix_len`` positions hold the lookup prefix."""
    n = int(ngram)
    if n < 2:
        raise ValueError(f"ngram draft needs ngram >= 2, got {n}")
    p_len = prefix_len
    n_windows = total_len - (n - 1)
    if n_windows < 1:
        raise ValueError(f"buffer ({total_len}) shorter than the ngram "
                         f"window ({n})")
    rows = torch.arange(batch, device=device)
    offs = torch.arange(n - 1, device=device) - (n - 2)
    starts = torch.arange(n_windows, device=device)[None, :]

    def steps_fn(ids, cache, times):
        buf = cache["buffer"]
        ids0 = ids[:, 0].long()
        pos = p_len + times
        buf[rows, pos] = ids0
        # the last n-1 known tokens ending at pos (clamped early indices
        # repeat position 0; the continuation bound masks their windows)
        suffix = buf.gather(1, (pos[:, None] + offs).clamp_min(0))
        windows = torch.stack([buf[:, i:n_windows + i]
                               for i in range(n - 1)], dim=-1)
        cont = buf[:, n - 1:]
        # the continuation at start + n - 1 must be known already, which
        # also excludes the trivial self-match
        ok = (windows == suffix[:, None, :]).all(dim=-1) \
            & (starts + (n - 1) <= pos[:, None])
        best = torch.where(ok, starts, -1).max(dim=1).values
        proposal = cont.gather(1, best.clamp_min(0)[:, None])[:, 0]
        proposal = torch.where(best >= 0, proposal, ids0)
        proposal = proposal.clamp(0, vocab_size - 1)
        logits = torch.nn.functional.one_hot(
            proposal, vocab_size).float() * 1e4
        return logits[:, None, :], {"buffer": buf}

    return steps_fn


def initial_speculative_state(target_init, draft_init, k: int,
                              max_steps, maximum_decode_length: int):
    """The state ``speculative_greedy_step`` starts from: the last token
    (the decoder input), times, finished flags, summed log-probs, the
    predicted ids [B, maximum_decode_length + k], the step limit [B] and
    both caches."""
    last = target_init["decoder_input"].long()
    batch, device = last.shape[0], last.device
    limit = torch.as_tensor(max_steps, device=device).expand(batch)
    return {"last": last,
            "times": torch.zeros(batch, dtype=torch.long, device=device),
            "finished": limit <= 0,
            "log_probs": torch.zeros(batch, dtype=torch.float32,
                                     device=device),
            "predicted": torch.zeros((batch, maximum_decode_length + k),
                                     dtype=torch.long, device=device),
            "limit": limit.clone(),
            "target_cache": target_init["decoder_internal_cache"],
            "draft_cache": draft_init["decoder_internal_cache"]}


def speculative_greedy_step(target_steps_fn, draft_steps_fn, state: dict,
                            *, k: int, eos_id: int, unk_id=None,
                            minimum_decode_length: int = 0) -> dict:
    """One greedy pass of ``speculative_greedy_decode`` on tensors only
    (the exported speculative step): the draft proposes k tokens a row,
    the target verifies them in one k-token pass, and the longest
    agreeing prefix commits with the target's own next token.  Returns
    the next state."""
    last, times = state["last"], state["times"]
    slot = torch.arange(k, device=last.device)[None, :]

    def masked(logits, emit_index):
        return masked_step_log_probs(logits, emit_index, eos_id, unk_id,
                                     1.0, minimum_decode_length)

    draft_cache = state["draft_cache"]
    last_d, d_tokens = last, []
    for j in range(k):
        logits_d, draft_cache = draft_steps_fn(last_d[:, None], draft_cache,
                                               times + j)
        last_d = masked(logits_d[:, 0], times + j).argmax(dim=-1)
        d_tokens.append(last_d)
    d = torch.stack(d_tokens, dim=1)
    logits_t, target_cache = target_steps_fn(
        torch.cat([last[:, None], d[:, :k - 1]], dim=1),
        state["target_cache"], times)
    lp_t = masked(logits_t, times[:, None] + slot)
    g = lp_t.argmax(dim=-1)
    # the longest agreeing prefix n, then n + 1 tokens (capped at k): the
    # accepted drafts and the target's correction
    n = (d == g).long().cumprod(dim=1).sum(dim=1)
    return _commit(state, g, lp_t, (n + 1).clamp_max(k), eos_id,
                   target_cache, draft_cache)


def speculative_sampling_step(target_steps_fn, draft_steps_fn, state: dict,
                              *, k: int, eos_id: int, generator, unk_id=None,
                              minimum_decode_length: int = 0,
                              temperature: float = 1.0, top_k: int = 0,
                              top_p: float = 1.0) -> dict:
    """One sampling pass of ``speculative_greedy_decode``: k drafts drawn
    from the draft's filtered distribution q, accepted with probability
    min(1, p / q) against the target's p, the first rejected slot
    resampled from norm(max(p - q, 0)); draws from ``generator``.
    Returns the next state."""
    last, times = state["last"], state["times"]
    device = last.device
    slot = torch.arange(k, device=device)[None, :]
    rows = torch.arange(last.shape[0], device=device)

    def masked(logits, emit_index):
        return masked_step_log_probs(logits, emit_index, eos_id, unk_id,
                                     temperature, minimum_decode_length)

    def filtered(lp):
        """The distribution plain sampling draws from."""
        return torch.log_softmax(filter_log_probs(lp, top_k, top_p), dim=-1)

    def draw(log_probs):
        return torch.multinomial(torch.exp(log_probs), 1,
                                 generator=generator)[:, 0]

    # draft: k tokens, one step at a time
    draft_cache = state["draft_cache"]
    last_d, d_tokens, q_rows = last, [], []
    for j in range(k):
        logits_d, draft_cache = draft_steps_fn(last_d[:, None], draft_cache,
                                               times + j)
        q_rows.append(filtered(masked(logits_d[:, 0], times + j)))
        last_d = draw(q_rows[-1])
        d_tokens.append(last_d)
    d = torch.stack(d_tokens, dim=1)

    # target: all k in one multi-token pass
    logits_t, target_cache = target_steps_fn(
        torch.cat([last[:, None], d[:, :k - 1]], dim=1),
        state["target_cache"], times)
    lp_t = masked(logits_t, times[:, None] + slot)
    plp = filtered(lp_t)
    qlp = torch.stack(q_rows, dim=1)
    p_at_d = plp.gather(2, d[..., None])[..., 0]
    q_at_d = qlp.gather(2, d[..., None])[..., 0]
    u = torch.rand(p_at_d.shape, generator=generator,
                   device=device).clamp_min(1e-20)
    accept = torch.log(u) < (p_at_d - q_at_d)
    n = accept.long().cumprod(dim=1).sum(dim=1)
    # the residual at the first rejected slot; a row with n == k never
    # uses its correction
    reject = n.clamp_max(k - 1)
    plp_r, qlp_r = plp[rows, reject], qlp[rows, reject]
    residual = (torch.exp(plp_r) - torch.exp(qlp_r)).clamp_min(0.0)
    total = residual.sum(dim=-1, keepdim=True)
    # p ~= q leaves (almost) no rejection mass: fall back to p
    res_lp = torch.where(
        total > 0.0, torch.log(residual.clamp_min(1e-38)
                               / total.clamp_min(1e-38)), plp_r)
    correction = draw(res_lp)
    g = torch.where(slot == n[:, None], correction[:, None], d)
    return _commit(state, g, lp_t, (n + 1).clamp_max(k), eos_id,
                   target_cache, draft_cache)


def _commit(state: dict, g, lp_t, m, eos_id: int, target_cache,
            draft_cache) -> dict:
    """The state after a pass that commits the first ``m`` [B] tokens of
    its window ``g`` [B, k] (their target log-probs in ``lp_t`` [B, k,
    V]): an EOS inside the window ends it (inclusive), the step limit
    caps it, and finished rows commit nothing."""
    last, times, finished = state["last"], state["times"], state["finished"]
    k = g.shape[1]
    slot = torch.arange(k, device=g.device)[None, :]
    rows = torch.arange(g.shape[0], device=g.device)[:, None]
    is_eos = (g == eos_id) & (slot < m[:, None])
    first_eos = torch.where(is_eos, slot, k).min(dim=1).values
    hit_eos = first_eos < k
    m = torch.where(hit_eos, first_eos + 1, m)
    m = torch.minimum(m, (state["limit"] - times).clamp_min(0))
    m = torch.where(finished, 0, m)
    predicted = state["predicted"].clone()
    predicted[rows, times[:, None] + slot] = g
    step_lp = lp_t.gather(2, g[..., None])[..., 0]
    return dict(
        state, last=torch.where(
            m > 0, g.gather(1, (m - 1).clamp_min(0)[:, None])[:, 0], last),
        times=times + m,
        finished=finished | (hit_eos & (m > 0))
        | (times + m >= state["limit"]),
        log_probs=state["log_probs"] + torch.where(
            slot < m[:, None], step_lp, 0.0).sum(dim=1),
        predicted=predicted, target_cache=target_cache,
        draft_cache=draft_cache)


def speculative_result(state: dict, eos_id: int,
                       maximum_decode_length: int):
    """(ids int64 [B, maximum_decode_length], scores) of a final state:
    EOS beyond each row's length, as the plain searches force it."""
    predicted, times = state["predicted"], state["times"]
    positions = torch.arange(predicted.shape[1], device=predicted.device)
    ids = torch.where(positions[None, :] < times[:, None], predicted,
                      eos_id)[:, :maximum_decode_length]
    return ids, state["log_probs"]


def speculative_greedy_decode(target_steps_fn, target_init,
                              draft_steps_fn, draft_init,
                              speculative_k: int = 4,
                              extra_decode_length: int = 50,
                              maximum_decode_length: int = 256,
                              minimum_decode_length: int = 0,
                              enable_unk: bool = False,
                              sampling: bool = False,
                              generator: torch.Generator = None,
                              temperature: float = 1.0,
                              top_k: int = 0,
                              top_p: float = 1.0,
                              return_stats: bool = False):
    """Greedy (or sampling) decode of the target, accelerated by a draft.

    ``target_steps_fn`` / ``draft_steps_fn``: fn(ids [B, k], cache, times
    [B]) -> (logits [B, k, V], cache), the ``prepare_speculative``
    closures (or ``make_ngram_draft``'s); the inits give the caches (eos,
    bos and unk come from the target's).  With ``sampling`` the drafts are
    drawn from the draft's filtered distribution q and accepted with
    probability min(1, p / q) against the target's p (``temperature``,
    ``top_k``, ``top_p`` as ``top_sampling`` defines it), the first
    rejected slot resampled from norm(max(p - q, 0)); draws come from
    ``generator``.

    Returns (ids int64 [B, maximum_decode_length], scores float32 [B], the
    summed target log-probs of the emitted tokens); with ``return_stats``
    also {"target_passes": int, "tokens_emitted": int64 [B]}."""
    k = int(speculative_k)
    if k < 1:
        raise ValueError(f"speculative_k must be >= 1, got {k}")
    if sampling and generator is None:
        raise ValueError("speculative sampling needs a torch.Generator")
    eos_id = int(target_init["eos_id"])
    unk_id = None if enable_unk else target_init.get("unk_id")
    max_steps = layer_utils.max_decode_steps(
        target_init, extra_decode_length, maximum_decode_length,
        minimum_decode_length)

    if sampling:
        step = functools.partial(
            speculative_sampling_step, generator=generator,
            temperature=temperature, top_k=top_k, top_p=top_p)
    else:
        step = speculative_greedy_step
    state = initial_speculative_state(target_init, draft_init, k, max_steps,
                                      maximum_decode_length)
    passes = 0
    while not bool(state["finished"].all()):
        state = step(target_steps_fn, draft_steps_fn, state, k=k,
                     eos_id=eos_id, unk_id=unk_id,
                     minimum_decode_length=minimum_decode_length)
        passes += 1
    predicted, log_probs = speculative_result(state, eos_id,
                                              maximum_decode_length)
    if return_stats:
        return predicted, log_probs, {"target_passes": passes,
                                      "tokens_emitted": state["times"]}
    return predicted, log_probs


def speculative_beam_search(target_steps_fn, target_init,
                            draft_steps_fn, draft_init,
                            beam_size: int = 4,
                            speculative_k: int = 4,
                            top_k: int = 1,
                            length_penalty: float = 0.6,
                            extra_decode_length: int = 50,
                            maximum_decode_length: int = 256,
                            minimum_decode_length: int = 0,
                            enable_unk: bool = False,
                            return_stats: bool = False):
    """Beam search of the target accelerated by a draft; the output is
    ``sequence_beam_search``'s.

    Each pass, every one of the B x beam rows drafts k tokens along its
    own hypothesis, one target pass verifies them all, and the beam
    update (GNMT penalty, EOS forcing of finished beams, the UNK and
    minimum-length masks, the t = 0 restriction to beam 0) is replayed
    over the k precomputed logits.  Replayed step j is exact while every
    surviving beam's transitions before j stayed on its predecessor's
    draft; the first step that leaves it is still exact and ends the
    window, so m = min(n + 1, k) steps commit a pass.  The target cache
    rows (and the draft's) are then gathered by the composed ancestor map.
    The draft fns must be built for B x beam rows (beam-major).

    Returns (hypotheses int64 [B * top_k, maximum_decode_length], scores
    float32 [B * top_k]); with ``return_stats`` also {"target_passes",
    "tokens_emitted"}."""
    k = int(speculative_k)
    if k < 1 or beam_size < 1:
        raise ValueError(f"speculative_k {k} and beam_size {beam_size} "
                         f"must be >= 1")
    eos_id = int(target_init["eos_id"])
    unk_id = None if enable_unk else target_init.get("unk_id")
    bos = target_init["decoder_input"].long()
    device = bos.device
    batch_size = bos.shape[0]
    bb = batch_size * beam_size
    max_steps = layer_utils.max_decode_steps(
        target_init, extra_decode_length, maximum_decode_length,
        minimum_decode_length)

    cache = layer_utils.stack_beam_size_selective(
        target_init["decoder_internal_cache"], beam_size)
    draft_cache = draft_init["decoder_internal_cache"]
    input_ids = layer_utils.stack_beam_size(bos, beam_size)
    beam_base = (torch.arange(bb, device=device) // beam_size) * beam_size
    not_first_beam = (torch.arange(bb, device=device) % beam_size) > 0
    finished = torch.zeros(bb, dtype=torch.bool, device=device)
    log_probs_acc = torch.zeros(bb, dtype=torch.float32, device=device)
    lengths = torch.zeros(bb, dtype=torch.long, device=device)
    predicted = torch.zeros((bb, maximum_decode_length + k),
                            dtype=torch.long, device=device)
    identity = torch.arange(bb, device=device)
    time = passes = 0
    all_finished = False
    while time < max_steps and not all_finished:
        times = torch.full((bb,), time, dtype=torch.long, device=device)
        last_d, d_tokens = input_ids, []
        for j in range(k):
            logits_d, draft_cache = draft_steps_fn(last_d[:, None],
                                                   draft_cache, times + j)
            last_d = masked_step_log_probs(
                logits_d[:, 0], time + j, eos_id, unk_id, 1.0,
                minimum_decode_length).argmax(dim=-1)
            d_tokens.append(last_d)
        d = torch.stack(d_tokens, dim=1)
        logits_t, cache = target_steps_fn(
            torch.cat([input_ids[:, None], d[:, :k - 1]], dim=1), cache,
            times)
        vocab = torch.arange(logits_t.shape[-1], device=device)
        eos_onehot = vocab == eos_id

        # replay the beam updates on the precomputed logits
        lp_c, fin_c, len_c = log_probs_acc, finished, lengths
        anc, on_draft, pred_c = identity, torch.ones_like(finished), \
            predicted
        steps = []
        for j in range(k):
            cur_time = time + j
            lp = torch.log_softmax(logits_t[anc, j].float(), dim=-1)
            lp = torch.where(fin_c[:, None],
                             torch.where(eos_onehot, 0.0, NEG_INF)[None, :],
                             lp)
            if unk_id is not None:
                lp = lp + torch.where(vocab == unk_id, NEG_INF,
                                      0.0)[None, :]
            if minimum_decode_length > 0 \
                    and cur_time < minimum_decode_length - 1:
                lp = lp + torch.where(eos_onehot, NEG_INF, 0.0)[None, :]
            cum = lp + lp_c[:, None]
            next_length = len_c + 1 - fin_c.long()
            scores = cum * _length_penalty(next_length,
                                           length_penalty)[:, None]
            if cur_time == 0:
                scores = torch.where(not_first_beam[:, None],
                                     torch.full_like(scores, NEG_INF * 2.0),
                                     scores)
            _, top_idx = torch.topk(
                scores.reshape(batch_size, -1), beam_size, dim=-1)
            top_idx = top_idx.reshape(-1)
            word_ids = top_idx % scores.shape[-1]
            beam_ids = top_idx // scores.shape[-1] + beam_base

            # a finished predecessor's forced EOS consults no logits, so
            # it cannot invalidate later steps
            anc_next = anc[beam_ids]
            on_draft = on_draft[beam_ids] & (
                (d[anc_next, j] == word_ids) | fin_c[beam_ids])
            len_c = next_length[beam_ids]
            lp_c = cum.reshape(-1)[beam_ids * scores.shape[-1] + word_ids]
            pred_c = pred_c[beam_ids]
            pred_c[:, cur_time] = word_ids
            fin_c = word_ids == eos_id
            anc = anc_next
            steps.append((word_ids, lp_c, fin_c, len_c, anc, pred_c,
                          on_draft.all()))
        # n leading steps whose transitions all stayed on the draft, and
        # whether every beam has finished after each step: one read from
        # the device a pass
        flags = torch.stack([s[-1] for s in steps]).long().cumprod(dim=0)
        read = torch.cat([flags.sum()[None], torch.stack(
            [s[2].all() for s in steps]).long()]).tolist()
        m = min(read[0] + 1, k, max(max_steps - time, 1))
        (input_ids, log_probs_acc, finished, lengths, anc, predicted,
         _) = steps[m - 1]
        all_finished = bool(read[m])
        cache = layer_utils.gather_beams_selective(cache, anc)
        draft_cache = layer_utils.gather_beams_selective(draft_cache, anc,
                                                         skip_keys=())
        time += m
        passes += 1

    scores = (log_probs_acc * _length_penalty(lengths, length_penalty)
              ).reshape(batch_size, beam_size)
    top_scores, top_idx = torch.topk(scores, top_k, dim=-1)
    gather_idx = (top_idx + (torch.arange(batch_size, device=device)
                             * beam_size)[:, None]).reshape(-1)
    hypotheses = predicted[gather_idx, :maximum_decode_length]
    if return_stats:
        return hypotheses, top_scores.reshape(-1), {
            "target_passes": passes, "tokens_emitted": lengths[gather_idx]}
    return hypotheses, top_scores.reshape(-1)


def _vocab_size(model):
    """The generated side's vocabulary size."""
    return getattr(model, "generation_meta", model.trg_meta)["vocab_size"]


@register_search_layer("speculative_decode", "speculative")
class SpeculativeDecode(SequenceSearch):
    """Greedy decode (or sampling) of the bound model accelerated by a
    draft: a model restored from ``draft_model_dir`` (its
    ``model_configs.yml`` and newest checkpoint; it must share the
    target's target-side vocabulary), or the n-gram lookup
    (``draft_method: ngram``)."""

    @staticmethod
    def class_or_method_args():
        return [
            Flag("draft_model_dir", dtype=Flag.TYPE.STRING, default=None,
                 help="Model dir of the (small) draft model: "
                      "model_configs.yml + checkpoint; must share the "
                      "target's target-side vocabulary."),
            Flag("draft_method", dtype=Flag.TYPE.STRING, default="model",
                 choices=["model", "ngram"],
                 help="'model': a draft model from --draft_model_dir. "
                      "'ngram': self-drafting prompt lookup over the "
                      "tokens so far (and optionally the source or "
                      "prompt); no second model."),
            Flag("draft_ngram", dtype=Flag.TYPE.INTEGER, default=3,
                 help="n-gram order for --draft_method ngram (the "
                      "matched suffix is n-1 tokens)."),
            Flag("draft_lookup_source", dtype=Flag.TYPE.BOOLEAN,
                 default=False,
                 help="With --draft_method ngram: also match against "
                      "the source token ids (requires a shared "
                      "source/target vocabulary, e.g. joint BPE)."),
            Flag("speculative_k", dtype=Flag.TYPE.INTEGER, default=4,
                 help="Draft tokens proposed (and verified in one "
                      "target pass) per iteration."),
            Flag("beam_size", dtype=Flag.TYPE.INTEGER, default=1,
                 help="Declared as in the JAX layer, which decodes "
                      "greedily whatever it says (ROADMAP R14); "
                      "speculative_beam_search is a function."),
            Flag("length_penalty", dtype=Flag.TYPE.FLOAT, default=0.6,
                 help="GNMT length penalty alpha (unused by the layer, "
                      "R14)."),
            Flag("top_hypotheses", dtype=Flag.TYPE.INTEGER, default=1,
                 help="Hypotheses per sentence (unused by the layer, "
                      "R14)."),
            Flag("sampling", dtype=Flag.TYPE.BOOLEAN, default=False,
                 help="Distribution-preserving speculative sampling "
                      "(accept with min(1, p/q), residual resample) "
                      "instead of greedy verification."),
            Flag("temperature", dtype=Flag.TYPE.FLOAT, default=1.0,
                 help="Softmax temperature (sampling mode)."),
            Flag("top_k", dtype=Flag.TYPE.INTEGER, default=0,
                 help="Sample from the top-k tokens (sampling mode)."),
            Flag("top_p", dtype=Flag.TYPE.FLOAT, default=1.0,
                 help="Nucleus mass (sampling mode)."),
            Flag("seed", dtype=Flag.TYPE.INTEGER, default=0,
                 help="The sampling random seed."),
            Flag("maximum_decode_length", dtype=Flag.TYPE.INTEGER,
                 default=256, help="The maximum decoding length."),
            Flag("minimum_decode_length", dtype=Flag.TYPE.INTEGER, default=0,
                 help="The minimum decoding length."),
            Flag("extra_decode_length", dtype=Flag.TYPE.INTEGER, default=50,
                 help="Decode up to source length + this many steps."),
            Flag("enable_unk", dtype=Flag.TYPE.BOOLEAN, default=False,
                 help="Whether UNK may be generated."),
        ]

    def __init__(self, args=None, draft_model=None):
        super().__init__(args)
        self.draft_model = draft_model
        self.last_stats = None

    def prepare(self):
        """Restores the draft model (once, before the first batch)."""
        if self.draft_model is not None \
                or self.args.get("draft_method") == "ngram":
            return
        draft_dir = self.args.get("draft_model_dir")
        if not draft_dir:
            raise ValueError("speculative_decode needs --draft_model_dir "
                             "(or a draft model passed programmatically)")
        from neurst_tpu_torch.exps.base_experiment import BaseExperiment
        from neurst_tpu_torch.tasks.task import build_task
        from neurst_tpu_torch.utils.configurable import (
            ModelConfigs, strip_training_only_model_flags)
        if int8_static_act_enabled():
            # the draft restores outside the generator's calibration:
            # uncalibrated scales would serve garbage proposals
            raise NotImplementedError(
                "--int8_static_activations is not supported with "
                "speculative decoding (the draft model is never "
                "calibrated); use dynamic --int8_activations")
        cfg = ModelConfigs.load(draft_dir)
        cfg["model.params"] = strip_training_only_model_flags(
            cfg.get("model.params"))
        model = build_task(cfg).build_model(cfg, device=self.model.device)
        self.draft_model = BaseExperiment(model=model,
                                          model_dir=draft_dir
                                          ).restore_params()
        logging.info("Draft model %s from %s", type(model).__name__,
                     draft_dir)

    def _ngram_draft(self, inputs, batch, buffer_len):
        """The lookup draft: its context is the LM prompt (a 2-D
        ``trg_input``) and, with ``draft_lookup_source``, the source ids
        (-1 at pads)."""
        device = self.model.device
        parts = []
        trg_input = inputs.get("trg_input")
        if trg_input is not None and trg_input.ndim == 2:
            parts.append(torch.as_tensor(trg_input, device=device).long())
        if self.args.get("draft_lookup_source"):
            src = inputs.get("src")
            src = None if src is None else torch.as_tensor(src)
            if src is None or src.dim() != 2 or src.is_floating_point():
                raise ValueError("--draft_lookup_source needs integer "
                                 "source token ids (text tasks with a "
                                 "shared vocabulary)")
            src = src.to(device).long()
            pad = inputs.get("src_padding")
            if pad is not None:
                src = torch.where(torch.as_tensor(pad, device=device) > 0,
                                  -1, src)
            parts.append(src)
        return make_ngram_draft(
            batch, buffer_len, _vocab_size(self.model),
            ngram=self.args.get("draft_ngram") or 3,
            prefix=torch.cat(parts, dim=1) if parts else None,
            device=device)

    def __call__(self, inputs: dict):
        a = self.args
        self.prepare()
        max_len = a.get("maximum_decode_length") or 256
        k = a.get("speculative_k") or 4
        sampling = bool(a.get("sampling"))
        generator = None
        if sampling:
            generator = torch.Generator(device=self.model.device)
            generator.manual_seed(int(a.get("seed") or 0))
        with torch.inference_mode():
            t_fn, t_init = self.model.prepare_speculative(
                inputs, decode_padded_length=max_len + k)
            if a.get("draft_method") == "ngram":
                d_fn, d_init = self._ngram_draft(
                    inputs, t_init["decoder_input"].shape[0], max_len + k)
            else:
                if _vocab_size(self.draft_model) != _vocab_size(self.model):
                    raise ValueError("draft/target vocabulary sizes differ")
                d_fn, d_init = self.draft_model.prepare_speculative(
                    inputs, decode_padded_length=max_len + k)
            ids, scores, self.last_stats = speculative_greedy_decode(
                t_fn, t_init, d_fn, d_init, speculative_k=k,
                extra_decode_length=a.get("extra_decode_length") or 50,
                maximum_decode_length=max_len,
                minimum_decode_length=a.get("minimum_decode_length") or 0,
                enable_unk=bool(a.get("enable_unk")), sampling=sampling,
                generator=generator,
                temperature=a.get("temperature") or 1.0,
                top_k=a.get("top_k") or 0, top_p=a.get("top_p") or 1.0,
                return_stats=True)
        return ids, scores
