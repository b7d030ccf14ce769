"""A reader of SentencePiece's ``.model`` files, the port's own: the
``ModelProto`` message of ``sentencepiece_model.proto`` decoded from the
protobuf wire format by hand, with neither ``sentencepiece`` nor
``protobuf``.

``read_model(path_or_bytes)`` returns a ``SentencePieceModel``: the
pieces (piece, score, type), the ``trainer_spec`` fields the encoder and
decoder read (``model_type``, the unk / bos / eos / pad ids and pieces,
``unk_surface``, ``byte_fallback``, ``treat_whitespace_as_suffix``), the
``normalizer_spec`` and the ``denormalizer_spec`` (name,
``precompiled_charsmap``, ``add_dummy_prefix``,
``remove_extra_whitespaces``, ``escape_whitespaces``).  A field that is
absent takes the proto2 default of the ``.proto``; a field the reader
does not know is skipped by its wire type.
"""

import struct
from dataclasses import dataclass, field
from typing import List, Optional

__all__ = ["SentencePieceModel", "NormalizerSpec", "Piece", "read_model",
           "NORMAL", "UNKNOWN", "CONTROL", "USER_DEFINED", "UNUSED", "BYTE",
           "UNIGRAM", "BPE", "WORD", "CHAR"]

# ModelProto.SentencePiece.Type
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
# TrainerSpec.ModelType
UNIGRAM, BPE, WORD, CHAR = 1, 2, 3, 4


@dataclass
class Piece:
    piece: str
    score: float = 0.0
    type: int = NORMAL


@dataclass
class NormalizerSpec:
    name: str = ""
    precompiled_charsmap: bytes = b""
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True


@dataclass
class SentencePieceModel:
    pieces: List[Piece] = field(default_factory=list)
    model_type: int = UNIGRAM
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    unk_piece: str = "<unk>"
    bos_piece: str = "<s>"
    eos_piece: str = "</s>"
    pad_piece: str = "<pad>"
    unk_surface: str = " ⁇ "
    byte_fallback: bool = False
    treat_whitespace_as_suffix: bool = False
    normalizer_spec: NormalizerSpec = field(default_factory=NormalizerSpec)
    denormalizer_spec: Optional[NormalizerSpec] = None


def _varint(buf, pos):
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint in a SentencePiece model")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf):
    """(field number, value) of a message: ints for varints and fixed
    widths, bytes for length-delimited fields; groups (wire types 3 and
    4, deprecated) are skipped whole."""
    out, pos, depth = [], 0, 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        number, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:
            size, pos = _varint(buf, pos)
            if pos + size > len(buf):
                raise ValueError("truncated field in a SentencePiece model")
            value = bytes(buf[pos:pos + size])
            pos += size
        elif wire == 5:
            value = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        elif wire in (3, 4):
            depth += 1 if wire == 3 else -1
            if depth < 0:
                raise ValueError("unbalanced group in a SentencePiece model")
            continue
        else:
            raise ValueError(f"unknown protobuf wire type {wire}")
        if depth == 0:
            out.append((number, value))
    return out


def _int32(v):
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _float(v):
    return struct.unpack("<f", struct.pack("<I", v))[0]


def _piece(buf):
    p = Piece("")
    for number, value in _fields(buf):
        if number == 1:
            p.piece = value.decode("utf-8")
        elif number == 2:
            p.score = _float(value)
        elif number == 3:
            p.type = value
    return p


def _normalizer(buf):
    spec = NormalizerSpec()
    for number, value in _fields(buf):
        if number == 1:
            spec.name = value.decode("utf-8")
        elif number == 2:
            spec.precompiled_charsmap = value
        elif number == 3:
            spec.add_dummy_prefix = bool(value)
        elif number == 4:
            spec.remove_extra_whitespaces = bool(value)
        elif number == 5:
            spec.escape_whitespaces = bool(value)
    return spec


# TrainerSpec field number -> (attribute, decoder)
_TRAINER = {3: ("model_type", int), 40: ("unk_id", _int32),
            41: ("bos_id", _int32), 42: ("eos_id", _int32),
            43: ("pad_id", _int32), 45: ("unk_piece", bytes.decode),
            46: ("bos_piece", bytes.decode), 47: ("eos_piece", bytes.decode),
            48: ("pad_piece", bytes.decode),
            44: ("unk_surface", bytes.decode), 35: ("byte_fallback", bool),
            24: ("treat_whitespace_as_suffix", bool)}


def read_model(path_or_bytes) -> SentencePieceModel:
    """Decodes a serialized ``ModelProto`` (a path or its bytes)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    model = SentencePieceModel()
    for number, value in _fields(data):
        if number == 1:
            model.pieces.append(_piece(value))
        elif number == 2:
            for n, v in _fields(value):
                if n in _TRAINER:
                    name, decode = _TRAINER[n]
                    setattr(model, name, decode(v))
        elif number == 3:
            model.normalizer_spec = _normalizer(value)
        elif number == 5:
            model.denormalizer_spec = _normalizer(value)
    return model
