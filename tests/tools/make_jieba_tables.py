"""Writes ``neurst_tpu_torch/data/text/jieba_data/``: the data the port's
jieba segmenter reads, taken from the jieba package installed beside the
JAX package (jieba 0.42.1).

* ``dict.txt.gz``: jieba's main dictionary (``jieba/dict.txt``: one
  ``word frequency tag`` a line), byte for byte, gzipped.
* ``hmm.json.gz``: the HMM of ``jieba/finalseg`` (``prob_start``,
  ``prob_trans``, ``prob_emit``): the start, transition and emission
  log-probabilities of the states B, M, E and S, as JSON (each float
  written as its shortest repr, so it reads back to the same double).
* ``NOTICE``: jieba's origin and its MIT notice.

The gzip streams carry no name and no time, so a rerun writes the same
bytes.

    python tests/tools/make_jieba_tables.py
"""

import gzip
import io
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(REPO, "neurst_tpu_torch", "data", "text", "jieba_data")

NOTICE = """\
Data of the port's jieba segmenter, generated by
tests/tools/make_jieba_tables.py from jieba {version}
(https://github.com/fxsjy/jieba, "Chinese Words Segmentation
Utilities", by Sun, Junyi; MIT License, as its package metadata states).

dict.txt.gz: jieba's main dictionary (jieba/dict.txt), byte for byte.
hmm.json.gz: the start, transition and emission log-probabilities of
jieba/finalseg (prob_start.py, prob_trans.py, prob_emit.py).

The MIT License (MIT)

Copyright (c) 2013 Sun Junyi

Permission is hereby granted, free of charge, to any person obtaining a
copy of this software and associated documentation files (the
"Software"), to deal in the Software without restriction, including
without limitation the rights to use, copy, modify, merge, publish,
distribute, sublicense, and/or sell copies of the Software, and to
permit persons to whom the Software is furnished to do so, subject to
the following conditions:

The above copyright notice and this permission notice shall be included
in all copies or substantial portions of the Software.

THE SOFTWARE IS PROVIDED "AS IS", WITHOUT WARRANTY OF ANY KIND, EXPRESS
OR IMPLIED, INCLUDING BUT NOT LIMITED TO THE WARRANTIES OF
MERCHANTABILITY, FITNESS FOR A PARTICULAR PURPOSE AND NONINFRINGEMENT.
IN NO EVENT SHALL THE AUTHORS OR COPYRIGHT HOLDERS BE LIABLE FOR ANY
CLAIM, DAMAGES OR OTHER LIABILITY, WHETHER IN AN ACTION OF CONTRACT,
TORT OR OTHERWISE, ARISING FROM, OUT OF OR IN CONNECTION WITH THE
SOFTWARE OR THE USE OR OTHER DEALINGS IN THE SOFTWARE.
"""


def gzipped(data):
    """``data`` gzipped at level 9, with no file name and time 0."""
    buf = io.BytesIO()
    with gzip.GzipFile(filename="", mode="wb", fileobj=buf, compresslevel=9,
                       mtime=0) as f:
        f.write(data)
    return buf.getvalue()


def tables():
    """{file name: bytes} of the data directory."""
    import jieba
    from jieba.finalseg import prob_emit, prob_start, prob_trans
    root = os.path.dirname(jieba.__file__)
    with open(os.path.join(root, "dict.txt"), "rb") as f:
        dictionary = f.read()
    hmm = {"start": prob_start.P, "trans": prob_trans.P,
           "emit": prob_emit.P}
    return {"dict.txt.gz": gzipped(dictionary),
            "hmm.json.gz": gzipped(json.dumps(
                hmm, ensure_ascii=False, sort_keys=True).encode("utf-8")),
            "NOTICE": NOTICE.format(version=jieba.__version__).encode()}


def main():
    os.makedirs(OUT, exist_ok=True)
    for name, data in tables().items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        print(f"wrote {os.path.join(OUT, name)} ({len(data)} bytes)")


if __name__ == "__main__":
    main()
