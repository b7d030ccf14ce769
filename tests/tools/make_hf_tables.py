"""Writes ``neurst_tpu_torch/data/text/hf_unicode_tables.py``: the
character classes of the HuggingFace ``tokenizers`` package (0.22.2,
the fast tokenizers ``AutoTokenizer`` builds for the JAX package), which
the port's WordPiece and byte-level BPE tokenizers read instead of
``unicodedata``.  The ``tokenizers`` tables are of another Unicode
version than Python's (letters and numbers assigned since, the
punctuation and mark classes of an older release), and its ``\\s`` is
not Python's (U+001C-U+001F are not whitespace there), so each class is
read from the oracle itself, one code point at a time:

* ``LETTER``, ``NUMBER``, ``WHITESPACE``: ``\\p{L}``, ``\\p{N}`` and
  ``\\s`` of the ``ByteLevel`` pre-tokenizer's pattern: a character that
  joins ``a`` into one piece is a letter, ``1`` a number, ``!`` neither
  (nor whitespace); what joins none is whitespace.  ``WHITESPACE`` is
  also what ``BertPreTokenizer`` splits at and removes.
* ``CONTROL``: what ``BertNormalizer``'s ``clean_text`` removes (it maps
  the rest of ``WHITESPACE`` to a space).
* ``PUNCTUATION``: what ``BertPreTokenizer`` isolates.
* ``NONSPACING_MARK``: what ``BertNormalizer``'s ``strip_accents``
  removes after its NFD.
* ``LOWER``, ``STRIP``: the code points whose lowercase or whose
  ``strip_accents`` output differs from Python's (``str.lower`` of the
  character; NFD without ``NONSPACING_MARK``), with the oracle's.

Surrogates (U+D800-U+DFFF) are left out: no UTF-8 text holds them.

    python tests/tools/make_hf_tables.py
"""

import os
import unicodedata

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(REPO, "neurst_tpu_torch", "data", "text",
                   "hf_unicode_tables.py")
CODE_POINTS = [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]
CLASSES = ("LETTER", "NUMBER", "WHITESPACE", "CONTROL", "PUNCTUATION",
           "NONSPACING_MARK")


CHAR_CLASS = '''def char_class(ranges):
    """The body of a regular-expression character class of ``ranges``."""
    return "".join(f"\\\\U{lo:08x}-\\\\U{hi:08x}" for lo, hi in ranges)
'''


def oracle_classes():
    """{class: sorted code points}, {"LOWER"/"STRIP": {code point:
    text}} from ``tokenizers``."""
    from tokenizers import normalizers, pre_tokenizers
    byte_level = pre_tokenizers.ByteLevel(add_prefix_space=False,
                                          use_regex=True)
    bert_pre = pre_tokenizers.BertPreTokenizer()

    def bert(**flags):
        kw = dict(clean_text=False, handle_chinese_chars=False,
                  strip_accents=False, lowercase=False)
        kw.update(flags)
        return normalizers.BertNormalizer(**kw)
    clean, strip, lower = (bert(clean_text=True), bert(strip_accents=True),
                           bert(lowercase=True))
    out = {name: [] for name in CLASSES}
    lowers, strips = {}, {}
    for cp in CODE_POINTS:
        c = chr(cp)
        space = False
        if len(byte_level.pre_tokenize_str("a" + c)) == 1:
            out["LETTER"].append(cp)
        elif len(byte_level.pre_tokenize_str("1" + c)) == 1:
            out["NUMBER"].append(cp)
        elif len(byte_level.pre_tokenize_str("!" + c)) != 1:
            out["WHITESPACE"].append(cp)
            space = True
        if clean.normalize_str("a" + c + "a") == "aa":
            out["CONTROL"].append(cp)
        pieces = len(bert_pre.pre_tokenize_str("a" + c + "a"))
        if pieces == 3:
            out["PUNCTUATION"].append(cp)
        if (pieces == 2) != space:
            raise AssertionError(f"U+{cp:04X}: BertPreTokenizer and "
                                 "ByteLevel disagree on whitespace")
        if strip.normalize_str(c) == "":
            out["NONSPACING_MARK"].append(cp)
        if lower.normalize_str(c) != c.lower():
            lowers[cp] = lower.normalize_str(c)
    marks = set(out["NONSPACING_MARK"])
    for cp in CODE_POINTS:
        c = chr(cp)
        ours = "".join(ch for ch in unicodedata.normalize("NFD", c)
                       if ord(ch) not in marks)
        if strip.normalize_str(c) != ours:
            strips[cp] = strip.normalize_str(c)
    return out, {"LOWER": lowers, "STRIP": strips}


def ranges(code_points):
    """Sorted code points as closed (lo, hi) ranges."""
    out = []
    for cp in code_points:
        if out and out[-1][1] == cp - 1:
            out[-1][1] = cp
        else:
            out.append([cp, cp])
    return [tuple(r) for r in out]


def render(classes, overrides):
    import tokenizers
    lines = [
        '"""Character classes of the HuggingFace ``tokenizers`` package '
        f'{tokenizers.__version__}',
        "(written by ``tests/tools/make_hf_tables.py``; do not edit).",
        "",
        "Each class is a tuple of closed code-point ranges (lo, hi).  "
        "``LOWER`` and",
        "``STRIP`` map the code points whose lowercase or accent-stripped "
        "form",
        'differs from Python\'s to the ``tokenizers`` one."""', ""]
    for name in CLASSES:
        lines.append(f"{name} = (")
        row = "   "
        for lo, hi in ranges(classes[name]):
            item = f" (0x{lo:x}, 0x{hi:x}),"
            if len(row) + len(item) > 79:
                lines.append(row)
                row = "   "
            row += item
        lines += [row, ")", ""]
    for name in ("LOWER", "STRIP"):
        lines.append(f"{name} = {{")
        for cp, text in sorted(overrides[name].items()):
            escaped = "".join(f"\\U{ord(ch):08x}" for ch in text)
            lines.append(f'    0x{cp:x}: "{escaped}",')
        lines += ["}", ""]
    lines += ["", CHAR_CLASS]
    return "\n".join(lines).rstrip("\n") + "\n"


def main():
    classes, overrides = oracle_classes()
    with open(OUT, "w", encoding="ascii") as f:
        f.write(render(classes, overrides))
    print(f"wrote {OUT}: " + ", ".join(
        f"{k} {len(ranges(v))} ranges" for k, v in classes.items())
        + f", {len(overrides['LOWER'])} lowercase and "
        f"{len(overrides['STRIP'])} strip overrides")


if __name__ == "__main__":
    main()
