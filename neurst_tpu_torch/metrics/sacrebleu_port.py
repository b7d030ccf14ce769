"""Detokenized corpus BLEU and chrF, the port's own: sacrebleu 2.6.0's
``corpus_bleu`` and ``corpus_chrf`` at the arguments the JAX package's
``SacreBLEU`` metric passes, for hosts without sacrebleu.

* ``corpus_bleu(hyps, ref_streams, tokenize="13a", lowercase=False)``:
  the ``13a`` (mteval-v13a) or ``zh`` tokenizer, ``exp`` smoothing, no
  effective order, n-grams up to 4, several reference streams (a
  segment's n-gram counts are the maximum over its references; its
  reference length is the closest to the hypothesis, the shorter on a
  tie).
* ``corpus_chrf(hyps, ref_streams)``: character n-grams up to 6, no word
  n-grams, beta 2, whitespace removed, no epsilon smoothing; each segment
  takes its best-scoring reference.

sacrebleu's ``ja-mecab`` tokenizer needs MeCab, which neither this port
nor its hosts carry; the JAX metric falls back to ``13a`` when it is
missing, and so ``SacreBLEU`` asks for ``13a`` for Japanese here.
Scores are floats on sacrebleu's scale (0-100).
"""

import math
import re
from collections import Counter

__all__ = ["corpus_bleu", "corpus_chrf", "tokenize_13a", "tokenize_zh"]

_RE_13A = ((re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
           (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
           (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
           (re.compile(r"([0-9])(-)"), r"\1 \2 "))
# sacrebleu.tokenizers.tokenizer_zh._UCODE_RANGES, compared as strings
# as sacrebleu does: a five-digit ``\u`` escape there is a code point and
# a digit, so those two ranges end up U+2001..U+2A6D and U+2F81..U+2FA1
_ZH_RANGES = (
    ("\u3400", "\u4db5"), ("\u4e00", "\u9fa5"), ("\u9fa6", "\u9fbb"),
    ("\uf900", "\ufa2d"), ("\ufa30", "\ufa6a"), ("\ufa70", "\ufad9"),
    ("\u20000", "\u2a6d6"), ("\u2f800", "\u2fa1d"), ("\uff00", "\uffef"),
    ("\u2e80", "\u2eff"), ("\u3000", "\u303f"), ("\u31c0", "\u31ef"),
    ("\u2f00", "\u2fdf"), ("\u2ff0", "\u2fff"), ("\u3100", "\u312f"),
    ("\u31a0", "\u31bf"), ("\ufe10", "\ufe1f"), ("\ufe30", "\ufe4f"),
    ("\u2600", "\u26ff"), ("\u2700", "\u27bf"), ("\u3200", "\u32ff"),
    ("\u3300", "\u33ff"))
MAX_ORDER = 4
CHAR_ORDER = 6
BETA = 2


def _post_tokenize(line):
    for regexp, sub in _RE_13A:
        line = regexp.sub(sub, line)
    return " ".join(line.split())


def tokenize_13a(line):
    line = line.replace("<skipped>", "").replace("-\n", "")
    line = line.replace("\n", " ")
    if "&" in line:
        line = line.replace("&quot;", '"').replace("&amp;", "&")
        line = line.replace("&lt;", "<").replace("&gt;", ">")
    return _post_tokenize(f" {line} ")


def _is_chinese_char(ch):
    return any(start <= ch <= end for start, end in _ZH_RANGES)


def tokenize_zh(line):
    return _post_tokenize("".join(
        f" {ch} " if _is_chinese_char(ch) else ch for ch in line.strip()))


_TOKENIZERS = {"13a": tokenize_13a, "zh": tokenize_zh}


def _ngrams(tokens, max_order):
    return Counter(tuple(tokens[i:i + n]) for n in range(1, max_order + 1)
                   for i in range(len(tokens) - n + 1))


def _check(hyps, ref_streams):
    if isinstance(hyps, str) or not hyps or not isinstance(hyps[0], str):
        raise TypeError("hypotheses should be a non-empty sequence of "
                        "strings")
    if not ref_streams or isinstance(ref_streams[0], str):
        raise TypeError("references should be a sequence of sequences of "
                        "strings")


def _segments(ref_streams):
    """Each segment's references, undefined (None) ones dropped."""
    return [[r for r in refs if r is not None] for refs in zip(*ref_streams)]


def _closest_ref_len(hyp_len, ref_lens):
    closest_diff, closest_len = -1, -1
    for ref_len in ref_lens:
        diff = abs(hyp_len - ref_len)
        if closest_diff == -1 or diff < closest_diff:
            closest_diff, closest_len = diff, ref_len
        elif diff == closest_diff and ref_len < closest_len:
            closest_len = ref_len
    return closest_len


def corpus_bleu(hyps, ref_streams, tokenize="13a", lowercase=False):
    """sacrebleu's ``corpus_bleu(hyps, ref_streams, tokenize=tokenize,
    lowercase=lowercase).score``."""
    _check(hyps, ref_streams)
    tok = _TOKENIZERS[tokenize]

    def prep(sent):
        return tok((sent.lower() if lowercase else sent).rstrip())
    sys_len, ref_len = 0, 0
    correct, total = [0] * MAX_ORDER, [0] * MAX_ORDER
    for hyp, refs in zip(hyps, _segments(ref_streams)):
        ref_ngrams, ref_lens = Counter(), []
        for ref in refs:
            tokens = prep(ref).split()
            ref_lens.append(len(tokens))
            for ng, c in _ngrams(tokens, MAX_ORDER).items():
                ref_ngrams[ng] = max(ref_ngrams[ng], c)
        tokens = prep(hyp).split()
        sys_len += len(tokens)
        ref_len += _closest_ref_len(len(tokens), ref_lens)
        for ng, c in _ngrams(tokens, MAX_ORDER).items():
            total[len(ng) - 1] += c
            if ng in ref_ngrams:
                correct[len(ng) - 1] += min(c, ref_ngrams[ng])
    bp = 1.0
    if sys_len < ref_len:
        bp = math.exp(1 - ref_len / sys_len) if sys_len > 0 else 0.0
    if not any(correct):
        return 0.0
    precisions = [0.0] * MAX_ORDER
    smooth = 1.0
    for n in range(MAX_ORDER):
        if total[n] == 0:
            break
        if correct[n] == 0:
            smooth *= 2
            precisions[n] = 100.0 / (smooth * total[n])
        else:
            precisions[n] = 100.0 * correct[n] / total[n]
    return bp * math.exp(sum(math.log(p) if p else -9999999999
                             for p in precisions) / MAX_ORDER)


def _char_ngrams(line):
    line = "".join(line.split())
    return [Counter(line[i:i + n] for i in range(len(line) - n + 1))
            for n in range(1, CHAR_ORDER + 1)]


def _f_score(stats):
    eps, factor = 1e-16, BETA ** 2
    avg_prec, avg_rec, effective_order = 0.0, 0.0, 0
    for i in range(CHAR_ORDER):
        n_hyp, n_ref, n_match = stats[3 * i:3 * i + 3]
        prec = n_match / n_hyp if n_hyp > 0 else eps
        rec = n_match / n_ref if n_ref > 0 else eps
        if n_hyp > 0 and n_ref > 0:
            avg_prec += prec
            avg_rec += rec
            effective_order += 1
    if effective_order == 0:
        return 0.0
    avg_prec /= effective_order
    avg_rec /= effective_order
    if not avg_prec + avg_rec:
        return 0.0
    return 100 * ((1 + factor) * avg_prec * avg_rec
                  / (factor * avg_prec + avg_rec))


def corpus_chrf(hyps, ref_streams):
    """sacrebleu's ``corpus_chrf(hyps, ref_streams).score``."""
    _check(hyps, ref_streams)
    corpus = [0] * (3 * CHAR_ORDER)
    for hyp, refs in zip(hyps, _segments(ref_streams)):
        hyp_ngrams = _char_ngrams(hyp)
        best_stats, best_f = [], -1.0
        for ref in refs:
            stats = []
            for h, r in zip(hyp_ngrams, _char_ngrams(ref)):
                match = sum(min(c, r[ng]) for ng, c in h.items() if ng in r)
                stats += [sum(h.values()) if r else 0, sum(r.values()),
                          match]
            f = _f_score(stats)
            if f > best_f:
                best_f, best_stats = f, stats
        for i, v in enumerate(best_stats):
            corpus[i] += v
    return _f_score(corpus)
