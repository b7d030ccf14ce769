"""SentencePiece (``spm`` / ``sentencepiece``), the port's own: the
JAX package's ``neurst_tpu/data/text/spm.py`` interface over an encoder
and decoder written after SentencePiece 0.2.0 (``sentencepiece_processor``,
``unigram_model``, ``bpe_model``), with neither ``sentencepiece`` nor
``protobuf``.

``init_subtokenizer(path)`` reads a ``.model`` file
(``utils/sentencepiece_model.py``); ``tokenize`` is ``EncodeAsPieces``:
the text normalized (``spm_normalizer.py``), then

* unigram: the Viterbi path over the pieces' float32 scores (user-defined
  pieces get SentencePiece's bonus, ``length x max score - 0.1``; a
  character no piece starts takes the unknown score, min score - 10);
* BPE: the adjacent pair whose merged piece has the highest score merged
  first (the leftmost on a tie), user-defined pieces frozen whole, unused
  pieces split back into the pair that made them;
* word and char models: a piece a ``▁``-started word or a character;

a run of unknown pieces becomes one unknown piece (its text as it was
normalized), or its UTF-8 bytes as ``<0xNN>`` pieces where the model sets
``byte_fallback``.  ``detokenize`` is ``DecodePieces``: control pieces
vanish, ``<unk>`` reads as the model's unknown surface, byte pieces are
decoded as UTF-8 (an invalid byte as U+FFFD), ``▁`` as a space, and the
leading ``▁`` of the text is dropped; a denormalizer charsmap, where the
model has one, is applied last.
"""

import heapq
import struct

from neurst_tpu_torch.data.text.spm_normalizer import (SPACE, Normalizer,
                                                       decode_utf8,
                                                       one_char_len)
from neurst_tpu_torch.data.text.tokenizer import Tokenizer, register_tokenizer
from neurst_tpu_torch.utils import sentencepiece_model as spmodel

__all__ = ["SentencePieceTokenizer", "SentencePieceProcessor"]

_FLT_MAX = 3.4028234663852886e+38
_FLT_MIN = 1.1754943508222875e-38
_UNK_PENALTY = 10.0


def _f32(x):
    """``x`` rounded to float32, as SentencePiece stores a path score."""
    return struct.unpack("<f", struct.pack("<f", x))[0]


class SentencePieceProcessor(object):
    """``encode_as_pieces`` / ``decode_pieces`` of one model."""

    def __init__(self, model):
        if model.treat_whitespace_as_suffix:
            raise NotImplementedError(
                "treat_whitespace_as_suffix models are not supported")
        if model.model_type not in (spmodel.UNIGRAM, spmodel.BPE,
                                    spmodel.WORD, spmodel.CHAR):
            raise ValueError(f"unknown SentencePiece model_type "
                             f"{model.model_type}")
        self._model = model
        self._types = [p.type for p in model.pieces]
        self._scores = [p.score for p in model.pieces]
        self._pieces, self._reserved = {}, {}
        self._unk_id = -1
        user_defined, byte_found = [], set()
        for i, p in enumerate(model.pieces):
            if not p.piece:
                raise ValueError("a SentencePiece piece must not be empty")
            table = self._pieces if p.type in (
                spmodel.NORMAL, spmodel.USER_DEFINED, spmodel.UNUSED) \
                else self._reserved
            key = p.piece.encode("utf-8")
            if key in table:
                raise ValueError(f"{p.piece} is already defined")
            table[key] = i
            if p.type == spmodel.USER_DEFINED:
                user_defined.append(p.piece)
            elif p.type == spmodel.UNKNOWN:
                if self._unk_id >= 0:
                    raise ValueError("unk is already defined")
                self._unk_id = i
            elif p.type == spmodel.BYTE:
                if not model.byte_fallback:
                    raise ValueError(f"byte piece {p.piece} is found although "
                                     "`byte_fallback` is false")
                byte_found.add(self._piece_to_byte(p.piece))
        if self._unk_id < 0:
            raise ValueError("unk is not defined")
        if model.byte_fallback and byte_found != set(range(256)):
            raise ValueError("there are not 256 byte pieces although "
                             "`byte_fallback` is true")
        self._normalizer = Normalizer(model.normalizer_spec, user_defined)
        spec = model.denormalizer_spec
        self._denormalizer = Normalizer(spec) \
            if spec is not None and spec.precompiled_charsmap else None
        normal = [p.score for p in model.pieces if p.type == spmodel.NORMAL]
        self._min_score = min(normal + [_FLT_MAX])
        self._max_score = max(normal + [_FLT_MIN])
        self._max_len = max(map(len, self._pieces), default=0)
        self._prefixes = {k[:n] for k in self._pieces
                          for n in range(1, len(k) + 1)}

    @staticmethod
    def _piece_to_byte(piece):
        if (len(piece) == 6 and piece.startswith("<0x") and piece[5] == ">"
                and all(c in "0123456789ABCDEF" for c in piece[3:5])):
            return int(piece[3:5], 16)
        return -1

    def piece_to_id(self, piece):
        key = piece.encode("utf-8") if isinstance(piece, str) else piece
        return self._reserved.get(key, self._pieces.get(key, self._unk_id))

    def _is(self, i, kind):
        return 0 <= i < len(self._types) and self._types[i] == kind

    # ------------------------------ models ------------------------------ #

    def _encode_unigram(self, data):
        size = len(data)
        unk_score = _f32(self._min_score - _UNK_PENALTY)
        # best path ending at each byte: [score, start, id]
        best = [[0.0, -1, -1] for _ in range(size + 1)]
        start = 0
        while start < size:
            till_here = best[start][0]
            mblen = min(one_char_len(data[start]), size - start)
            single = False
            for end in range(start + 1, min(size, start + self._max_len) + 1):
                key = data[start:end]
                if key not in self._prefixes:
                    break
                i = self._pieces.get(key)
                if i is None or self._types[i] == spmodel.UNUSED:
                    continue
                length = end - start
                score = (length * self._max_score - 0.1
                         if self._types[i] == spmodel.USER_DEFINED
                         else self._scores[i])
                cand = score + till_here
                node = best[end]
                if node[1] == -1 or cand > node[0]:
                    best[end] = [_f32(cand), start, i]
                if length == mblen:
                    single = True
            if not single:
                cand = _f32(unk_score + till_here)
                node = best[start + mblen]
                if node[1] == -1 or cand > node[0]:
                    best[start + mblen] = [cand, start, self._unk_id]
            start += mblen
        out, end = [], size
        while end > 0:
            _, s, i = best[end]
            out.append((data[s:end], i))
            end = s
        return out[::-1]

    def _encode_bpe(self, data):
        # symbols: [piece bytes, prev, next, frozen]
        symbols, pos = [], 0
        while pos < len(data):
            n = self._normalizer.user_match(data, pos)
            frozen = n > 0
            if not frozen:
                n = min(one_char_len(data[pos]), len(data) - pos)
            symbols.append([data[pos:pos + n], len(symbols) - 1,
                            len(symbols) + 1, frozen])
            pos += n
        if symbols:
            symbols[-1][2] = -1
        agenda, rev_merge = [], {}

        def add_pair(left, right):
            if left == -1 or right == -1 or symbols[left][3] \
                    or symbols[right][3]:
                return
            piece = symbols[left][0] + symbols[right][0]
            i = self._pieces.get(piece)
            if i is None:
                return
            heapq.heappush(agenda, (-self._scores[i], left, right,
                                    len(piece)))
            if self._types[i] == spmodel.UNUSED:
                rev_merge[piece] = (symbols[left][0], symbols[right][0])

        for i in range(1, len(symbols)):
            add_pair(i - 1, i)
        while agenda:
            _, left, right, size = heapq.heappop(agenda)
            lsym, rsym = symbols[left], symbols[right]
            if not lsym[0] or not rsym[0] or \
                    len(lsym[0]) + len(rsym[0]) != size:
                continue
            lsym[0] += rsym[0]
            lsym[2] = rsym[2]
            if rsym[2] >= 0:
                symbols[rsym[2]][1] = left
            rsym[0] = b""
            add_pair(lsym[1], left)
            add_pair(left, lsym[2])
        out = []

        def resegment(w):
            i = self.piece_to_id(w)
            if not self._is(i, spmodel.UNUSED) or w not in rev_merge:
                out.append((w, i))
                return
            resegment(rev_merge[w][0])
            resegment(rev_merge[w][1])
        index = 0 if symbols else -1
        while index != -1:
            resegment(symbols[index][0])
            index = symbols[index][2]
        return out

    def _encode_word(self, data):
        words, pos = [], 0
        while pos < len(data):
            if data.startswith(SPACE, pos) or not words:
                words.append(b"")
            n = min(one_char_len(data[pos]), len(data) - pos)
            words[-1] += data[pos:pos + n]
            pos += n
        return [(w, self.piece_to_id(w)) for w in words]

    def _encode_char(self, data):
        out, pos = [], 0
        while pos < len(data):
            n = min(one_char_len(data[pos]), len(data) - pos)
            char = data[pos:pos + n]
            out.append((char, self.piece_to_id(char)))
            pos += n
        return out

    # ---------------------------- interface ----------------------------- #

    def encode_as_pieces(self, text):
        data = self._normalizer.normalize(text)
        encode = {spmodel.UNIGRAM: self._encode_unigram,
                  spmodel.BPE: self._encode_bpe,
                  spmodel.WORD: self._encode_word,
                  spmodel.CHAR: self._encode_char}[self._model.model_type]
        pieces, prev_unk = [], False
        for w, i in encode(data):
            unk = self._is(i, spmodel.UNKNOWN)
            if unk and self._model.byte_fallback:
                pieces.extend(f"<0x{b:02X}>" for b in w)
            elif unk and prev_unk:
                pieces[-1] += w.decode("utf-8")
            else:
                pieces.append(w.decode("utf-8"))
            prev_unk = unk
        return pieces

    def _decode_piece(self, piece, i, is_bos_ws):
        """(surface, whether a leading ``▁`` was consumed)."""
        spec = self._model.normalizer_spec
        if self._is(i, spmodel.CONTROL):
            return "", False
        if self._is(i, spmodel.UNKNOWN):
            if self._model.pieces[i].piece == piece:
                return self._model.unk_surface, False
            return piece, False
        has_bos_ws = False
        if is_bos_ws and (spec.add_dummy_prefix
                          or spec.remove_extra_whitespaces):
            has_bos_ws = piece.startswith("▁")
            if has_bos_ws:
                piece = piece[1:]
            if spec.remove_extra_whitespaces:
                has_bos_ws = False
        return piece.replace("▁", " "), has_bos_ws

    def decode_pieces(self, pieces):
        ids = [self.piece_to_id(p) for p in pieces]
        out, pending = [], bytearray()  # out: the text's non-empty parts

        def flush():
            pos = 0
            while pos < len(pending):
                cp, n = decode_utf8(pending, pos)
                out.append("�" if cp is None else chr(cp))
                pos += n
            pending.clear()
        is_bos_ws, bos_ws_seen = True, False
        for piece, i in zip(pieces, ids):
            if self._is(i, spmodel.BYTE):
                pending.append(self._piece_to_byte(piece))
                continue
            flush()
            if bos_ws_seen or out:
                is_bos_ws = False
            surface, has_bos_ws = self._decode_piece(piece, i, is_bos_ws)
            if surface:
                out.append(surface)
            bos_ws_seen |= has_bos_ws
        flush()
        text = "".join(out)
        if self._denormalizer is not None:
            text = self._denormalizer.normalize(text).decode("utf-8")
        return text


@register_tokenizer("spm", "sentencepiece")
class SentencePieceTokenizer(Tokenizer):

    def __init__(self, language="en", glossaries=None, **kwargs):
        super().__init__(language=language, glossaries=glossaries)
        self._sp = None

    def init_subtokenizer(self, codes):
        """``codes`` is the path to a trained ``.model`` file."""
        self._sp = SentencePieceProcessor(spmodel.read_model(codes))

    def tokenize(self, text, return_str=False):
        if self._sp is None:
            raise ValueError("spm model not initialized")
        pieces = self._sp.encode_as_pieces(self._convert_to_str(text))
        return self._output_wrapper(pieces, return_str)

    def detokenize(self, text, return_str=True):
        if self._sp is None:
            raise ValueError("spm model not initialized")
        out = self._sp.decode_pieces(self._convert_to_str(text).split())
        return self._output_wrapper(out, return_str)
