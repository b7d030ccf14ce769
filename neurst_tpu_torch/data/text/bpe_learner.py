"""Byte-pair-encoding code learning, subword-nmt compatible (the port's
copy of ``neurst_tpu/data/text/bpe_learner.py``).

Learns merge operations with the classic BPE algorithm (Sennrich et al.
2016) in its v0.2 form (the end-of-word marker fused onto the last
character, the convention ``data/text/bpe.BPE`` applies) and writes codes
files the BPE tokenizer loads.  Pair statistics are updated per merge
through an index of the words that hold each pair, so learning costs
O(corpus + merges x affected words).
"""

import collections
from typing import Dict, Iterable, List, Tuple

from neurst_tpu_torch.data.text.bpe import BPE

__all__ = ["count_words", "learn_bpe", "write_codes", "apply_and_count"]

Word = Tuple[str, ...]


def count_words(lines: Iterable[str]) -> Dict[str, int]:
    counts: Dict[str, int] = collections.Counter()
    for line in lines:
        for tok in line.strip().split():
            counts[tok] += 1
    return dict(counts)


def _initial_word(token: str) -> Word:
    # v0.2: the end-of-word marker is fused onto the final character
    return tuple(token[:-1]) + (token[-1] + "</w>",)


def _pairs_of(word: Word):
    return zip(word[:-1], word[1:])


def learn_bpe(word_counts: Dict[str, int], num_symbols: int,
              min_frequency: int = 2) -> List[Tuple[str, str]]:
    """Learns up to `num_symbols` merge operations from word counts."""
    words: List[Word] = []
    freqs: List[int] = []
    for token, freq in sorted(word_counts.items()):
        if not token:
            continue
        words.append(_initial_word(token))
        freqs.append(freq)

    stats: Dict[Tuple[str, str], int] = collections.defaultdict(int)
    index: Dict[Tuple[str, str], collections.Counter] = \
        collections.defaultdict(collections.Counter)
    for wi, (word, freq) in enumerate(zip(words, freqs)):
        for pair in _pairs_of(word):
            stats[pair] += freq
            index[pair][wi] += 1

    merges: List[Tuple[str, str]] = []
    for _ in range(num_symbols):
        if not stats:
            break
        # most frequent pair; ties broken lexicographically for
        # deterministic, subword-nmt-compatible output
        best = max(stats, key=lambda p: (stats[p], p))
        if stats[best] < min_frequency:
            break
        merges.append(best)
        first, second = best
        new_sym = first + second

        affected = list(index[best].items())
        del stats[best]
        del index[best]
        for wi, _ in affected:
            word = words[wi]
            freq = freqs[wi]
            # remove old pair contributions of this word
            for pair in _pairs_of(word):
                if pair == best:
                    continue
                stats[pair] -= freq
                index[pair][wi] -= 1
                if index[pair][wi] <= 0:
                    del index[pair][wi]
                if stats[pair] <= 0:
                    stats.pop(pair, None)
                    index.pop(pair, None)

            merged: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(new_sym)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            new_word = tuple(merged)
            words[wi] = new_word

            # add new pair contributions
            for pair in _pairs_of(new_word):
                if pair == best:
                    continue
                stats[pair] += freq
                index[pair][wi] += 1
        stats.pop(best, None)
        index.pop(best, None)
    return merges


def write_codes(path: str, merges: List[Tuple[str, str]]):
    with open(path, "w", encoding="utf-8") as fw:
        fw.write("#version: 0.2\n")
        for a, b in merges:
            fw.write(f"{a} {b}\n")


def apply_and_count(word_counts: Dict[str, int],
                    merges: List[Tuple[str, str]],
                    separator: str = "@@") -> Dict[str, int]:
    """Applies the merges to every word and counts the resulting
    subword units (for ``--write-vocabulary`` style vocab files)."""
    bpe = BPE(separator=separator)
    bpe.init_subtokenizer(
        ["#version: 0.2"] + [f"{a} {b}" for a, b in merges])
    out: Dict[str, int] = collections.Counter()
    for token, freq in word_counts.items():
        units = bpe._encode_word(token)
        for i, u in enumerate(units):
            if i < len(units) - 1:
                u = u + separator
            out[u] += freq
    return dict(out)


def write_vocabulary(path: str, unit_counts: Dict[str, int]):
    with open(path, "w", encoding="utf-8") as fw:
        for tok, freq in sorted(unit_counts.items(),
                                key=lambda kv: (-kv[1], kv[0])):
            fw.write(f"{tok} {freq}\n")
