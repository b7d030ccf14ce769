"""GPT-2's byte-level BPE as the HuggingFace fast tokenizer runs it
(``tokenizers``' ``ByteLevel`` pre-tokenizer and decoder and ``BPE``
model), with no ``transformers``, ``tokenizers`` or ``regex`` package.

* The pre-tokenizer splits text with GPT-2's pattern,
  ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|``
  ``\\s+(?!\\S)|\\s+``, written for ``re`` with the letter, number and
  whitespace classes of ``tokenizers`` (``hf_unicode_tables``: Python's
  ``\\s`` also holds U+001C-U+001F, and its Unicode tables are older),
  then maps each piece's UTF-8 bytes to printable characters
  (``bytes_to_unicode``).  With ``add_prefix_space`` a piece that does
  not start with a space gets one.
* The model merges the characters of a piece pair by pair, the pair of
  lowest merge rank first, until no pair has a rank (a cache keeps each
  piece's result).
* The decoder maps the characters back to bytes and decodes them as
  UTF-8, an invalid sequence as U+FFFD.
"""

import re

from neurst_tpu_torch.data.text import hf_unicode_tables as tables

__all__ = ["bytes_to_unicode", "ByteLevelPreTokenizer", "BPE",
           "byte_level_decode"]


def bytes_to_unicode():
    """{byte: character}: the printable Latin-1 bytes as themselves, the
    rest as the characters from U+0100 on, in byte order."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


BYTE_ENCODER = bytes_to_unicode()
BYTE_DECODER = {c: b for b, c in BYTE_ENCODER.items()}
_L = tables.char_class(tables.LETTER)
_N = tables.char_class(tables.NUMBER)
_S = tables.char_class(tables.WHITESPACE)
GPT2_PATTERN = re.compile(
    f"'s|'t|'re|'ve|'m|'ll|'d| ?[{_L}]+| ?[{_N}]+| ?[^{_S}{_L}{_N}]+"
    f"|[{_S}]+(?![^{_S}])|[{_S}]+")


class ByteLevelPreTokenizer(object):

    def __init__(self, add_prefix_space=False):
        self.add_prefix_space = add_prefix_space

    def __call__(self, text):
        """The byte-level pieces of ``text``."""
        if self.add_prefix_space and not text.startswith(" "):
            text = " " + text
        return ["".join(BYTE_ENCODER[b] for b in piece.encode("utf-8"))
                for piece in GPT2_PATTERN.findall(text)]


class BPE(object):
    """Byte-pair merges over ``vocab`` ({token: id}) by the rank of each
    pair in ``merges`` ([(left, right)], first the most frequent)."""

    def __init__(self, vocab, merges, unk_token=None, ignore_merges=False):
        self.vocab = vocab
        self.ranks = {}
        for rank, (left, right) in enumerate(merges):
            if left + right not in vocab:
                raise ValueError(f"BPE: the merge {left!r} {right!r} makes "
                                 "a token the vocabulary lacks")
            self.ranks.setdefault((left, right), rank)
        self.unk_token = unk_token
        self.ignore_merges = ignore_merges
        self._cache = {}

    def __call__(self, piece):
        out = self._cache.get(piece)
        if out is None:
            out = self._cache[piece] = self._merge(piece)
        return out

    def _merge(self, piece):
        if self.ignore_merges and piece in self.vocab:
            return [piece]
        word = []
        for c in piece:
            if c in self.vocab:
                word.append(c)
            elif self.unk_token is not None:
                word.append(self.unk_token)
        ranks = self.ranks
        while len(word) > 1:
            best = min((ranks.get(pair, float("inf")), i)
                       for i, pair in enumerate(zip(word, word[1:])))
            if best[0] == float("inf"):
                break
            left, right = word[best[1]], word[best[1] + 1]
            merged, i = [], 0
            while i < len(word):
                if i + 1 < len(word) and word[i] == left \
                        and word[i + 1] == right:
                    merged.append(left + right)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        return word


def byte_level_decode(tokens):
    """The text of byte-level ``tokens``: a token whose characters all
    map to bytes gives those bytes, any other its UTF-8."""
    data = bytearray()
    for token in tokens:
        codes = [BYTE_DECODER.get(c) for c in token]
        data.extend(token.encode("utf-8") if None in codes else codes)
    return data.decode("utf-8", errors="replace")
