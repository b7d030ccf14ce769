r"""Invertible wordpiece subtokenizer, Tensor2Tensor style (the port's copy
of ``neurst_tpu/data/text/subtokenizer.py``).

* text splits into alternating alphanumeric / non-alphanumeric tokens;
* each token is escaped (``\`` -> ``\\``, ``_`` -> ``\u``,
  out-of-alphabet chars -> ``\<codepoint>;``) and suffixed with ``_``;
* escaped tokens are greedily segmented into the longest subtokens
  present in the vocabulary;
* decoding concatenates, unescapes, and re-inserts separating spaces
  between adjacent alphanumeric tokens, a lossless round trip;
* vocabulary building binary-searches a count threshold so the final
  vocabulary lands near ``target_vocab_size``.
"""

import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

from neurst_tpu_torch.data.text.tokenizer import Tokenizer, register_tokenizer
from neurst_tpu_torch.data.text.vocab import Vocab

__all__ = ["Subtokenizer"]

_ALPHANUMERIC = set(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789")
_UNESCAPE_RE = re.compile(r"\\u|\\\\|\\([0-9]+);")


def _split_to_tokens(text: str) -> List[str]:
    """Splits into alternating alnum / non-alnum runs, dropping single
    spaces between alphanumeric tokens (re-inserted on decode)."""
    if not text:
        return []
    tokens = []
    start = 0
    is_alnum = [ch in _ALPHANUMERIC for ch in text]
    for pos in range(1, len(text)):
        if is_alnum[pos] != is_alnum[pos - 1]:
            token = text[start:pos]
            if token != " " or start == 0:
                tokens.append(token)
            start = pos
    tokens.append(text[start:])
    return tokens


def _join_tokens(tokens: List[str]) -> str:
    """Inverse of _split_to_tokens."""
    out = []
    is_alnum = [bool(t) and t[0] in _ALPHANUMERIC for t in tokens]
    for i, token in enumerate(tokens):
        if i > 0 and is_alnum[i - 1] and is_alnum[i]:
            out.append(" ")
        out.append(token)
    return "".join(out)


def _escape_token(token: str, alphabet: set) -> str:
    token = token.replace("\\", "\\\\").replace("_", "\\u")
    return "".join(ch if ch in alphabet and ch != "\n"
                   else f"\\{ord(ch)};" for ch in token) + "_"


def _unescape_token(escaped: str) -> str:
    if escaped.endswith("_"):
        escaped = escaped[:-1]

    def sub(m):
        if m.group(1) is None:
            return "_" if m.group(0) == "\\u" else "\\"
        try:
            return chr(int(m.group(1)))
        except (ValueError, OverflowError):
            return "�"
    return _UNESCAPE_RE.sub(sub, escaped)


@register_tokenizer("subtokenizer", "wordpiece")
class Subtokenizer(Tokenizer):
    """T2T wordpiece working over a subtoken vocabulary file."""

    def __init__(self, language="en", glossaries=None, vocabulary=None,
                 **kwargs):
        super().__init__(language=language, glossaries=glossaries)
        self._subtoken_to_id: Dict[str, int] = {}
        self._max_subtoken_len = 1
        self._alphabet: set = set()
        self._cache: Dict[str, List[str]] = {}
        if vocabulary is not None and isinstance(vocabulary, str) \
                and vocabulary.endswith((".txt", ".subtokens", ".vocab")):
            try:
                self.init_subtokenizer(vocabulary)
            except OSError:
                pass

    def init_subtokenizer(self, codes):
        """`codes` = subtoken vocab file (one per line, possibly quoted)
        or a list of subtokens."""
        if isinstance(codes, str):
            tokens = Vocab.load_tokens(vocab_path=codes)
        else:
            tokens = list(codes)
        self._load_subtokens(tokens)

    def _load_subtokens(self, tokens: List[str]):
        self._subtoken_to_id = {t: i for i, t in enumerate(tokens)}
        self._max_subtoken_len = max((len(t) for t in tokens), default=1)
        self._alphabet = {ch for t in tokens for ch in t
                          if not t.startswith("\\") or len(t) == 1}
        # alphabet = all single-character subtokens, unescaped view
        self._alphabet |= {t for t in tokens if len(t) == 1}
        self._cache = {}

    @property
    def vocab_list(self) -> List[str]:
        inv = sorted(self._subtoken_to_id.items(), key=lambda kv: kv[1])
        return [t for t, _ in inv]

    # ------------------------------------------------------------ #

    def _escaped_token_to_subtokens(self, escaped: str) -> List[str]:
        out = []
        start = 0
        n = len(escaped)
        while start < n:
            end = min(n, start + self._max_subtoken_len)
            while end > start:
                cand = escaped[start:end]
                if cand in self._subtoken_to_id:
                    out.append(cand)
                    break
                end -= 1
            else:
                # cannot match even a single char: emit replacement
                out.append(escaped[start])
            start = max(end, start + 1)
        return out

    def tokenize(self, text, return_str=False):
        if not self._subtoken_to_id:
            raise ValueError("Subtokenizer vocabulary not initialized")
        text = self._convert_to_str(text)
        subtokens: List[str] = []
        for token in _split_to_tokens(text):
            if token in self._cache:
                subtokens.extend(self._cache[token])
                continue
            escaped = _escape_token(token, self._alphabet)
            pieces = self._escaped_token_to_subtokens(escaped)
            self._cache[token] = pieces
            subtokens.extend(pieces)
        return self._output_wrapper(subtokens, return_str)

    def detokenize(self, text, return_str=True):
        text = self._convert_to_str(text)
        pieces = text.split()
        tokens = []
        current = []
        for p in pieces:
            current.append(p)
            if p.endswith("_"):
                tokens.append(_unescape_token("".join(current)))
                current = []
        if current:
            tokens.append(_unescape_token("".join(current)))
        return self._output_wrapper(_join_tokens(tokens), return_str)

    # --------------------- vocabulary building -------------------- #

    @classmethod
    def build_from_corpus(cls, corpus: Iterable[str],
                          target_vocab_size: int = 32768,
                          max_subtoken_length: int = 20,
                          num_iterations: int = 4,
                          reserved_tokens: Optional[List[str]] = None
                          ) -> "Subtokenizer":
        """Builds a subtoken vocabulary near `target_vocab_size`
        (binary search on min_count)."""
        token_counts: Dict[str, int] = defaultdict(int)
        for line in corpus:
            for token in _split_to_tokens(line.strip()):
                token_counts[token] += 1
        alphabet = {ch for token in token_counts for ch in token}
        alphabet |= set("\\_u;0123456789")

        def build(min_count: int) -> List[str]:
            subtokens = set(alphabet)
            # iterate: segment with current vocab, count candidates
            current = cls._make(sorted(subtokens), alphabet)
            for _ in range(num_iterations):
                cand_counts: Dict[str, int] = defaultdict(int)
                for token, count in token_counts.items():
                    escaped = _escape_token(token, alphabet)
                    pieces = current._escaped_token_to_subtokens(escaped)
                    start = 0
                    for piece in pieces:
                        for end in range(
                                start + 1,
                                min(len(escaped),
                                    start + max_subtoken_length) + 1):
                            cand_counts[escaped[start:end]] += count
                        start += len(piece)
                keep = {s for s, c in cand_counts.items()
                        if c >= min_count}
                keep |= alphabet
                # longest first so greedy matching favors long pieces
                current = cls._make(
                    sorted(keep, key=lambda s: (-len(s), s)), alphabet)
            return current.vocab_list

        # binary search min_count for target size
        lo, hi = 1, 1000
        best = build(lo)
        while lo < hi:
            mid = (lo + hi) // 2
            vocab = build(mid)
            if abs(len(vocab) - target_vocab_size) \
                    < abs(len(best) - target_vocab_size):
                best = vocab
            if len(vocab) > target_vocab_size:
                lo = mid + 1
            else:
                hi = mid - 1
        reserved = reserved_tokens or []
        return cls._make(reserved + [t for t in best
                                     if t not in reserved], alphabet)

    @classmethod
    def _make(cls, tokens: List[str], alphabet: set) -> "Subtokenizer":
        st = cls()
        st._load_subtokens(list(tokens))
        st._alphabet = set(alphabet)
        return st

    def save_vocab(self, path: str):
        with open(path, "w", encoding="utf-8") as f:
            for t in self.vocab_list:
                f.write("'" + t + "'\n")
