"""Writes ``neurst_tpu_torch/data/text/moses_data/``: the data the port's
Moses tokenizer reads, generated from the sacremoses package installed
beside the JAX package (sacremoses 0.1.1).

* ``nonbreaking_prefixes/nonbreaking_prefix.<lang>``: sacremoses' files,
  byte for byte (they come from the Moses decoder's
  ``scripts/share/nonbreaking_prefixes``).
* ``perluniprops.txt``: each Perl Unicode Properties class sacremoses
  carries (``data/perluniprops/<name>.txt``, a list of characters), one
  line a class: ``<name>\\t<lo>-<hi> <cp> ...`` in hexadecimal code
  points, the closed ranges of the class's characters (a lone code
  point for a range of one).  The classes are
  not derived from ``unicodedata``: Python's Unicode tables are newer
  than the Perluniprops files, and the two differ on recently assigned
  code points.

sacremoses interpolates these character lists into regular-expression
character classes; a list holding ``\\``, ``]``, ``[``, ``^`` or ``-``
would read there as something else than its characters, so every class
the port reads is checked to hold none of them.

    python tests/tools/make_moses_tables.py

sacremoses is distributed under the MIT License:

    MIT License

    Copyright (c) 2020 alvations

    Permission is hereby granted, free of charge, to any person obtaining
    a copy of this software and associated documentation files (the
    "Software"), to deal in the Software without restriction, including
    without limitation the rights to use, copy, modify, merge, publish,
    distribute, sublicense, and/or sell copies of the Software, and to
    permit persons to whom the Software is furnished to do so, subject to
    the following conditions:

    The above copyright notice and this permission notice shall be
    included in all copies or substantial portions of the Software.

    THE SOFTWARE IS PROVIDED "AS IS", WITHOUT WARRANTY OF ANY KIND,
    EXPRESS OR IMPLIED, INCLUDING BUT NOT LIMITED TO THE WARRANTIES OF
    MERCHANTABILITY, FITNESS FOR A PARTICULAR PURPOSE AND NONINFRINGEMENT.
    IN NO EVENT SHALL THE AUTHORS OR COPYRIGHT HOLDERS BE LIABLE FOR ANY
    CLAIM, DAMAGES OR OTHER LIABILITY, WHETHER IN AN ACTION OF CONTRACT,
    TORT OR OTHERWISE, ARISING FROM, OUT OF OR IN CONNECTION WITH THE
    SOFTWARE OR THE USE OR OTHER DEALINGS IN THE SOFTWARE.
"""

import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(REPO, "neurst_tpu_torch", "data", "text", "moses_data")
# the classes the port's tokenizer and detokenizer read
USED = ("IsN", "IsAlnum", "IsSc", "IsSo", "IsAlpha", "IsLower", "Han",
        "Hangul", "Hiragana", "Katakana")
CLASS_SPECIAL = set("\\][^-")
NOTICE = """\
Data of the port's Moses tokenizer, generated by
tests/tools/make_moses_tables.py from sacremoses 0.1.1.

nonbreaking_prefixes/: the nonbreaking-prefix lists of the Moses
statistical machine translation system
(https://github.com/moses-smt/mosesdecoder,
scripts/share/nonbreaking_prefixes; GNU LGPL 2.1), as sacremoses
distributes them, byte for byte.

perluniprops.txt: sacremoses' Perl Unicode Properties character lists
(extracted with Unicode::Tussle), as code-point ranges.

sacremoses: MIT License, Copyright (c) 2020 alvations.  Permission is
hereby granted, free of charge, to any person obtaining a copy of this
software and associated documentation files (the "Software"), to deal in
the Software without restriction, including without limitation the
rights to use, copy, modify, merge, publish, distribute, sublicense,
and/or sell copies of the Software, and to permit persons to whom the
Software is furnished to do so, subject to the following conditions: the
above copyright notice and this permission notice shall be included in
all copies or substantial portions of the Software.  THE SOFTWARE IS
PROVIDED "AS IS", WITHOUT WARRANTY OF ANY KIND, EXPRESS OR IMPLIED.
"""


def ranges(chars):
    """The closed code-point ranges of a set of characters."""
    out = []
    for cp in sorted(set(map(ord, chars))):
        if out and cp == out[-1][1] + 1:
            out[-1][1] = cp
        else:
            out.append([cp, cp])
    return out


def perluniprops_classes():
    """{name: characters} of every class in sacremoses' data (the
    ``-unichars-au`` variants, which sacremoses never reads, aside)."""
    import sacremoses
    from sacremoses.corpus import Perluniprops
    data = os.path.join(os.path.dirname(sacremoses.__file__), "data",
                        "perluniprops")
    names = sorted(f[:-4] for f in os.listdir(data)
                   if f.endswith(".txt") and "-unichars-" not in f)
    pup = Perluniprops()
    return {name: "".join(pup.chars(name)) for name in names}


def main():
    import sacremoses
    classes = perluniprops_classes()
    for name in USED:
        bad = CLASS_SPECIAL & set(classes[name])
        assert not bad, (name, bad)
    if os.path.isdir(OUT):
        shutil.rmtree(OUT)
    prefixes = os.path.join(OUT, "nonbreaking_prefixes")
    os.makedirs(prefixes)
    src = os.path.join(os.path.dirname(sacremoses.__file__), "data",
                       "nonbreaking_prefixes")
    for name in sorted(os.listdir(src)):
        shutil.copyfile(os.path.join(src, name),
                        os.path.join(prefixes, name))
    with open(os.path.join(OUT, "perluniprops.txt"), "w",
              encoding="ascii") as f:
        for name, chars in classes.items():
            f.write(name + "\t" + " ".join(
                f"{lo:x}-{hi:x}" if hi > lo else f"{lo:x}"
                for lo, hi in ranges(chars)) + "\n")
    with open(os.path.join(OUT, "NOTICE"), "w") as f:
        f.write(NOTICE)
    print(f"wrote {len(os.listdir(prefixes))} prefix lists and "
          f"{len(classes)} classes under {OUT}")


if __name__ == "__main__":
    main()
