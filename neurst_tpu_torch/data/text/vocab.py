"""Token <-> id vocabulary (the port's copy of
``neurst_tpu/data/text/vocab.py``).

One token per line (a trailing frequency column is dropped), or a GPT-2
style ``.json`` mapping {token: id}, read in id order; a quoted single
token is unquoted, so NeurST vocabulary files load unchanged.
"""

import json
import random
from typing import List, Optional, Union

__all__ = ["Vocab", "PaddingMode"]


def _json_tokens(mapping, path):
    """The tokens of a {token: id} vocabulary in id order (the JAX
    package takes the file's key order, which is not the id order of a
    ``vocab.json`` that a tokenizer's ``save_pretrained`` sorted by key:
    ROADMAP R17)."""
    tokens = sorted(mapping, key=mapping.get)
    if [mapping[t] for t in tokens] != list(range(len(tokens))):
        raise ValueError(f"{path}: the ids of a .json vocabulary must be "
                         "0 to its size - 1")
    return tokens


class PaddingMode(object):
    DEFAULT = 1
    EOS_AS_PADDING = 2


class Vocab(object):
    """An ordered token list with O(1) token->id lookup."""

    def __init__(self, tokens: List[str], extra_tokens: Optional[List[str]] = None,
                 lowercase: bool = False):
        if not isinstance(tokens, list):
            raise ValueError("`tokens` must be a list of string tokens")
        if lowercase:
            seen = set()
            deduped = []
            for t in tokens:
                t = t.lower()
                if t not in seen:
                    seen.add(t)
                    deduped.append(t)
            tokens = deduped
        self._token_list = list(tokens)
        self._extra_tokens = list(extra_tokens or [])
        for t in self._extra_tokens:
            if t not in self._token_list:
                self._token_list.append(t)
        self._token_to_id = {w: i for i, w in enumerate(self._token_list)}
        self._lowercase = lowercase

    @property
    def tokens(self) -> List[str]:
        return self._token_list

    @property
    def vocab_size(self) -> int:
        return len(self._token_list)

    def load_tokens(vocab_path: Optional[str] = None,
                    tokens: Optional[List[str]] = None) -> List[str]:
        """Loads and cleans a token list from a file or a raw list."""
        if not ((vocab_path is None) ^ (tokens is None)):
            raise ValueError("Provide exactly one of `vocab_path`/`tokens`.")
        skip_empty = True
        if vocab_path is not None:
            with open(vocab_path, "r", encoding="utf-8") as f:
                if vocab_path.endswith(".json"):  # GPT-2 style vocab
                    tokens = _json_tokens(json.load(f), vocab_path)
                    skip_empty = False
                else:
                    tokens = [line.rstrip("\n") for line in f]
        cleaned = []
        for word in tokens:
            if len(word) > 1 and ((word.startswith("'") and word.endswith("'"))
                                  or (word.startswith('"') and word.endswith('"'))):
                word = word[1:-1]
            elif word.strip() != "" and skip_empty:
                # "token freq" lines: keep the token column only
                word = word.strip().split()[0]
            if word == "" and skip_empty:
                continue
            cleaned.append(word)
        return cleaned

    @staticmethod
    def get_unique(codebook, token: str) -> str:
        """Returns `token`, suffixed with digits until unseen in codebook."""
        while token in codebook:
            token += str(random.choice(range(10)))
        return token

    @staticmethod
    def load_from_file(vocab_path: str, extra_tokens=None, lowercase=False):
        return Vocab(Vocab.load_tokens(vocab_path=vocab_path),
                     extra_tokens, lowercase)

    def map_token_to_id(self, tokens: Union[str, List[str]],
                        unknown_default: Optional[int] = None):
        def _map(t):
            if self._lowercase and t not in self._extra_tokens:
                t = t.lower()
            return self._token_to_id.get(t, unknown_default)
        if isinstance(tokens, list):
            return [_map(t) for t in tokens]
        return _map(tokens)

    def map_id_to_token(self, ids: Union[int, List[int]]):
        if isinstance(ids, list):
            return [self._token_list[int(i)] for i in ids]
        return self._token_list[int(ids)]

    def __contains__(self, token):
        return token in self._token_to_id

    def __len__(self):
        return self.vocab_size
