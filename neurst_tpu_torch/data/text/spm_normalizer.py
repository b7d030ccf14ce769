"""SentencePiece's text normalizer, the port's own: the rules of a
model's ``normalizer_spec`` applied as ``normalizer.cc`` applies them,
on UTF-8 bytes.

* ``CharsMap``: the ``precompiled_charsmap``, a Darts-clone double array
  (a little-endian uint32 of its size in bytes, then its units) with the
  NUL-terminated normalized strings after it.  ``longest_match`` reads
  the longest key that prefixes the input, as ``commonPrefixSearch``
  does; an empty charsmap (the ``identity`` rule) maps nothing.
* ``Normalizer``: one prefix at a time (a user-defined piece whole, else
  the charsmap's longest match, else one character), with the whitespace
  handling around it: leading, trailing and repeated whitespace removed
  (``remove_extra_whitespaces``), a dummy ``▁`` prefix
  (``add_dummy_prefix``) and spaces written as ``▁``
  (``escape_whitespaces``).
"""

import struct

__all__ = ["CharsMap", "Normalizer", "one_char_len", "SPACE"]

SPACE = "▁".encode("utf-8")


def one_char_len(byte):
    """The length of the UTF-8 sequence a lead byte starts, as
    SentencePiece's ``OneCharLen`` reads it (a stray trail byte counts
    as one)."""
    return (1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 3, 4)[byte >> 4]


def decode_utf8(data, pos):
    """(code point or None, length) of the character at ``pos``: None for
    a malformed sequence, which is consumed one byte at a time."""
    b0 = data[pos]
    if b0 < 0x80:
        return b0, 1
    n = len(data) - pos
    for length, mask, lead, low in ((2, 0xE0, 0xC0, 0x80),
                                    (3, 0xF0, 0xE0, 0x800),
                                    (4, 0xF8, 0xF0, 0x10000)):
        if b0 & mask == lead:
            if n < length:
                break
            cp = b0 & (0x7F >> length)
            for k in range(1, length):
                b = data[pos + k]
                if b & 0xC0 != 0x80:
                    return None, 1
                cp = (cp << 6) | (b & 0x3F)
            if cp >= low and (cp < 0xD800 or 0xE000 <= cp <= 0x10FFFF):
                return cp, length
            break
    return None, 1


class CharsMap(object):
    """A precompiled charsmap: ``longest_match(data, pos)`` is (the
    normalized bytes, the length of the key) of the longest key at
    ``pos``, or None."""

    def __init__(self, blob=b""):
        self._units, self._strings = (), b""
        if not blob:
            return
        if len(blob) < 4:
            raise ValueError("precompiled charsmap shorter than its header")
        size = struct.unpack_from("<I", blob, 0)[0]
        if size % 4 or 4 + size > len(blob):
            raise ValueError(f"precompiled charsmap: a trie of {size} "
                             f"bytes in a blob of {len(blob)}")
        self._units = struct.unpack_from(f"<{size // 4}I", blob, 4)
        self._strings = bytes(blob[4 + size:])

    def __bool__(self):
        return bool(self._units)

    def common_prefix_search(self, data, pos=0):
        """[(value, key length)] of every key that prefixes
        ``data[pos:]``, shortest first."""
        units, out = self._units, []
        if not units:
            return out
        node = units[0] >> 10 << ((units[0] & 0x200) >> 6)
        for i in range(pos, len(data)):
            byte = data[i]
            node ^= byte
            if node >= len(units):
                break
            unit = units[node]
            if unit & 0x800000FF != byte:
                break
            node ^= unit >> 10 << ((unit & 0x200) >> 6)
            if unit >> 8 & 1:
                if node >= len(units):
                    break
                out.append((units[node] & 0x7FFFFFFF, i + 1 - pos))
        return out

    def normalized(self, value):
        end = self._strings.find(b"\0", value)
        return self._strings[value:end if end >= 0 else len(self._strings)]

    def longest_match(self, data, pos=0):
        best = None
        for value, length in self.common_prefix_search(data, pos):
            if best is None or length > best[1]:
                best = (value, length)
        return None if best is None else (self.normalized(best[0]), best[1])


class Normalizer(object):
    """``normalize(text)`` -> the normalized UTF-8 bytes of ``text`` under
    a ``NormalizerSpec``; ``user_defined`` are the pieces that pass
    through unnormalized, matched longest first."""

    def __init__(self, spec, user_defined=()):
        self._spec = spec
        self._map = CharsMap(spec.precompiled_charsmap)
        self._user = {}
        for piece in user_defined:
            b = piece.encode("utf-8")
            self._user.setdefault(b[:1], set()).add(b)
        self._user_max = {k: max(map(len, v)) for k, v in self._user.items()}

    def user_match(self, data, pos):
        """The length of the longest user-defined piece at ``pos``, or 0."""
        cands = self._user.get(data[pos:pos + 1])
        if not cands:
            return 0
        for n in range(min(self._user_max[data[pos:pos + 1]],
                           len(data) - pos), 0, -1):
            if data[pos:pos + n] in cands:
                return n
        return 0

    def normalize_prefix(self, data, pos):
        """(normalized bytes, bytes consumed) of the prefix at ``pos``."""
        n = self.user_match(data, pos)
        if n:
            return data[pos:pos + n], n
        match = self._map.longest_match(data, pos) if self._map else None
        if match is not None:
            return match
        cp, n = decode_utf8(data, pos)
        if cp is None:
            return "�".encode("utf-8"), 1
        return data[pos:pos + n], n

    def normalize(self, text):
        spec = self._spec
        data = text.encode("utf-8") if isinstance(text, str) else text
        pos, size = 0, len(data)
        if spec.remove_extra_whitespaces:
            while pos < size:
                sp, n = self.normalize_prefix(data, pos)
                if sp != b" ":
                    break
                pos += n
        if pos == size:
            return b""
        space = SPACE if spec.escape_whitespaces else b" "
        out = bytearray(space if spec.add_dummy_prefix else b"")
        is_prev_space = spec.remove_extra_whitespaces
        while pos < size:
            sp, n = self.normalize_prefix(data, pos)
            if is_prev_space:
                sp = sp.lstrip(b" ")
            if sp:
                out += sp.replace(b" ", space)
                is_prev_space = sp.endswith(b" ")
            pos += n
            if not spec.remove_extra_whitespaces:
                is_prev_space = False
        if spec.remove_extra_whitespaces:
            while out.endswith(space):
                del out[-len(space):]
        return bytes(out)
