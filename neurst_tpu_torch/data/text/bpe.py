"""Byte-pair-encoding tokenizer compatible with subword-nmt codes files
(the port's copy of ``neurst_tpu/data/text/bpe.py``): ``#version: 0.2``
codes, ``@@ `` continuation markers, glossaries, and vocabulary-
constrained splitting (out-of-vocabulary merges are undone
recursively).
"""

import re
from typing import Dict, List, Optional, Tuple

from neurst_tpu_torch.data.text.tokenizer import Tokenizer, register_tokenizer
from neurst_tpu_torch.data.text.vocab import Vocab

__all__ = ["BPE"]


@register_tokenizer("bpe")
class BPE(Tokenizer):

    def __init__(self, language="en", glossaries=None, vocabulary=None,
                 separator="@@", **kwargs):
        super().__init__(language=language, glossaries=glossaries)
        self._separator = separator
        self._merge_ranks: Optional[Dict[Tuple[str, str], int]] = None
        self._version = (0, 2)
        self._vocab = None
        if vocabulary is not None:
            self._load_vocab(vocabulary)
        self._cache: Dict[str, Tuple[str, ...]] = {}
        self._glossary_re = None
        if self._glossaries:
            self._glossary_re = re.compile(
                "(?:" + "|".join(re.escape(g) for g in self._glossaries) + ")")

    def _load_vocab(self, vocabulary):
        """Vocabulary constraint: subwords must appear in this set."""
        if isinstance(vocabulary, str):
            tokens = Vocab.load_tokens(vocab_path=vocabulary)
        elif isinstance(vocabulary, (list, set)):
            tokens = list(vocabulary)
        else:
            return
        self._vocab = set(tokens)

    def init_subtokenizer(self, codes):
        """Loads a subword-nmt codes file (path or list of merge lines)."""
        if isinstance(codes, str):
            with open(codes, "r", encoding="utf-8") as f:
                lines = f.read().splitlines()
        else:
            lines = list(codes)
        offset = 0
        if lines and lines[0].startswith("#version:"):
            ver = lines[0].split(":")[1].strip()
            major, minor = ver.split(".")[:2]
            self._version = (int(major), int(minor))
            offset = 1
        ranks: Dict[Tuple[str, str], int] = {}
        for i, line in enumerate(lines[offset:]):
            parts = line.split()
            if len(parts) < 2:
                continue
            pair = (parts[0], parts[1])
            if pair not in ranks:
                ranks[pair] = i
        self._merge_ranks = ranks
        self._cache = {}

    # ------------------------------------------------------------------ #

    def _encode_word(self, orig: str) -> Tuple[str, ...]:
        if orig in self._cache:
            return self._cache[orig]
        if self._merge_ranks is None:
            raise ValueError("BPE codes are not initialized; call "
                             "init_subtokenizer(codes) first.")
        if not orig:
            return tuple()
        if self._version == (0, 1):
            word = tuple(orig) + ("</w>",)
        else:  # 0.2: end-of-word marker fused onto the last char
            word = tuple(orig[:-1]) + (orig[-1] + "</w>",)

        while len(word) > 1:
            pairs = [(self._merge_ranks.get(p, float("inf")), i, p)
                     for i, p in enumerate(zip(word[:-1], word[1:]))]
            rank, _, best = min(pairs)
            if rank == float("inf"):
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)

        # strip the end-of-word marker
        if word[-1] == "</w>":
            word = word[:-1]
        elif word[-1].endswith("</w>"):
            word = word[:-1] + (word[-1][:-4],)

        if self._vocab is not None:
            word = tuple(self._split_oov(word, orig))
        self._cache[orig] = word
        return word

    def _split_oov(self, units, orig: str) -> List[str]:
        """Recursively undoes merges whose result is out of vocabulary."""
        out: List[str] = []
        n = len(units)
        for i, unit in enumerate(units):
            is_last = (i == n - 1)
            written = unit if is_last else unit + self._separator
            if written in self._vocab or unit in self._vocab:
                out.append(unit)
            else:
                out.extend(self._recursive_split(unit, is_last))
        return out

    def _recursive_split(self, segment: str, final: bool) -> List[str]:
        try:
            if final:
                left, right = self._reverse_merge(segment + "</w>")
                right = right[:-4]
            else:
                left, right = self._reverse_merge(segment)
        except (KeyError, ValueError):
            return [segment]
        out: List[str] = []
        if (left + self._separator) in self._vocab:
            out.append(left)
        else:
            out.extend(self._recursive_split(left, False))
        if (final and right in self._vocab) or \
                (not final and (right + self._separator) in self._vocab):
            out.append(right)
        else:
            out.extend(self._recursive_split(right, final))
        return out

    def _reverse_merge(self, merged: str) -> Tuple[str, str]:
        """Finds the highest-priority merge that produces `merged`."""
        best = None
        for (a, b), rank in self._merge_ranks.items():
            if a + b == merged:
                if best is None or rank < best[0]:
                    best = (rank, a, b)
        if best is None:
            raise KeyError(merged)
        return best[1], best[2]

    # ------------------------------------------------------------------ #

    def _isolate_glossaries(self, word: str) -> List[str]:
        if not self._glossary_re:
            return [word]
        pieces = []
        last = 0
        for m in self._glossary_re.finditer(word):
            if m.start() > last:
                pieces.append(word[last:m.start()])
            pieces.append(m.group())
            last = m.end()
        if last < len(word):
            pieces.append(word[last:])
        return pieces

    def tokenize(self, text, return_str=False):
        text = self._convert_to_str(text)
        out: List[str] = []
        for word in text.strip().split():
            segs = []
            for piece in self._isolate_glossaries(word):
                if self._glossaries and piece in self._glossaries:
                    segs.append(piece)
                else:
                    segs.extend(self._encode_word(piece))
            for i, seg in enumerate(segs):
                if i < len(segs) - 1:
                    out.append(seg + self._separator)
                else:
                    out.append(seg)
        return self._output_wrapper(out, return_str)

    def detokenize(self, text, return_str=True):
        text = self._convert_to_str(text)
        joined = text.replace(self._separator + " ", "")
        # trailing continuation marker (e.g. truncated hypothesis)
        if joined.endswith(self._separator):
            joined = joined[: -len(self._separator)]
        return self._output_wrapper(joined, return_str)
