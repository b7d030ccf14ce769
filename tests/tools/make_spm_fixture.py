"""Writes ``tests/fixtures/spm/``: SentencePiece ``.model`` files for the
port's reader, normalizer and encoder, built without ``sentencepiece``:
the ``ModelProto`` is filled through protobuf with transformers'
``sentencepiece_model_pb2_new``, the pieces and scores are learned here
from a seeded corpus, and the precompiled charsmap is a Darts-clone
double array this tool builds itself (``build_charsmap``).

* ``unigram.model``: unigram, the ``identity`` rule (no charsmap),
  user-defined pieces ``<sep>`` and ``@@``;
* ``unigram_nfkc.model``: unigram with the tool's charsmap (``CHARSMAP``:
  full-width forms, ligatures, a composed ring, spaces and a deleted
  zero-width space);
* ``unigram_bytes.model``: unigram, the charsmap and ``byte_fallback``
  with its 256 ``<0xNN>`` pieces;
* ``bpe.model``: BPE (merges learned on the corpus, scored by rank),
  identity, user-defined ``<sep>``;
* ``bpe_bytes.model``: BPE with the charsmap and ``byte_fallback``.

Some characters of the corpus (``q``, ``z``, ``ß``, the CJK ones) are left
out of every vocabulary, so that encoding meets unknown characters.
``corpus.txt`` is the corpus; ``charsmap.bin`` the charsmap alone.

    python tests/tools/make_spm_fixture.py
"""

import math
import os
import struct
from collections import Counter

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(REPO, "tests", "fixtures", "spm")
SPACE = "▁"
WORDS = ("the a of to and in is that for it as with was on be by at this "
         "from have not are but or an they which one you all were her "
         "she there would their we him been has when who will more no if "
         "out so said what up its about into than them can only other new "
         "some could time these two may then do first any my now such like "
         "our over man me even most made after also did many before must "
         "through back years where much your way well down should because "
         "each just those people how too little state good very make world "
         "still own see men work long get here between both life being "
         "under never day same another know while last might us great old "
         "year off come since against go came right used take three quiz "
         "jazz fizz straße naïve café déjà vu 東京 中文 日本語 123 2026 "
         "3.14 e-mail U.S. Mr. it's don't").split()
EXCLUDED = set("qzß東京中文日本語")
USER_DEFINED = ("<sep>", "@@")
# the tool's charsmap: key -> normalized text
CHARSMAP = {chr(0xFF21 + i): chr(0x41 + i) for i in range(26)}
CHARSMAP.update({chr(0xFF41 + i): chr(0x61 + i) for i in range(26)})
CHARSMAP.update({chr(0xFF10 + i): chr(0x30 + i) for i in range(10)})
CHARSMAP.update({"\ufb01": "fi", "\ufb02": "fl", "\ufb00": "ff",
                 "\u2026": "...", "\u3000": " ", "\t": " ", "\u00a0": " ",
                 "\u2460": "1", "A\u030a": "\u00c5", "a\u030a": "\u00e5",
                 "\u200b": "", "\u00b4": " \u0301", "\u2122": "TM",
                 "\u00bd": "1\u20442"})


def corpus(rng, n=400):
    lines = []
    for _ in range(n):
        k = int(rng.randint(3, 14))
        lines.append(" ".join(WORDS[int(i)] for i in
                              rng.zipf(1.3, size=k) % len(WORDS)))
    return lines


def word_counts(lines):
    return Counter(SPACE + w for line in lines for w in line.split())


def unigram_pieces(counts, max_len=6, size=420):
    """(piece, log-probability) of the most frequent substrings of the
    corpus's words (every kept character among them)."""
    subs = Counter()
    for w, c in counts.items():
        for i in range(len(w)):
            for j in range(i + 1, min(len(w), i + max_len) + 1):
                subs[w[i:j]] += c * (j - i)
    chars = {p for p in subs if len(p) == 1}
    keep = [p for p, _ in subs.most_common()
            if not set(p) & EXCLUDED and p not in chars][:size]
    keep += sorted(c for c in chars if c not in EXCLUDED)
    total = sum(subs[p] for p in keep)
    return [(p, math.log(subs[p] / total)) for p in keep]


def bpe_pieces(counts, merges=300):
    """(piece, score) of BPE learned on the words: the merged pieces by
    rank (score -rank), then the characters."""
    words = {tuple(c for c in w): n for w, n in counts.items()
             if not set(w) & EXCLUDED}
    out = []
    for rank in range(merges):
        pairs = Counter()
        for w, n in words.items():
            for a, b in zip(w, w[1:]):
                pairs[a, b] += n
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        out.append((a + b, -float(rank)))
        merged = {}
        for w, n in words.items():
            new, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == (a, b):
                    new.append(a + b)
                    i += 2
                else:
                    new.append(w[i])
                    i += 1
            merged[tuple(new)] = merged.get(tuple(new), 0) + n
        words = merged
    chars = sorted({c for w in counts for c in w} - EXCLUDED)
    out += [(c, -float(len(out) + i)) for i, c in enumerate(chars)]
    seen, uniq = set(), []
    for p, s in out:
        if p not in seen:
            seen.add(p)
            uniq.append((p, s))
    return uniq


def build_charsmap(mapping):
    """A precompiled charsmap: uint32 trie size, Darts-clone units (label
    in bits 0-7, has-leaf bit 8, offset << 10; a leaf unit is bit 31 and
    the value), then the NUL-terminated normalized strings."""
    strings, values = bytearray(), {}
    for key in sorted(mapping):
        values[key.encode("utf-8")] = len(strings)
        strings += mapping[key].encode("utf-8") + b"\0"
    trie = {}
    for key, value in values.items():
        node = trie
        for b in key:
            node = node.setdefault(b, {})
        node[None] = value
    # a base (node position ^ offset) serves one node only, or a walk from
    # one node could follow another's children
    units, used, bases = {0: 0}, {0}, set()
    todo = [(trie, 0)]
    while todo:
        node, pos = todo.pop(0)
        labels = sorted(b for b in node if b is not None)
        children = ([0] if None in node else []) + labels
        offset = 1
        while pos ^ offset in bases or any(
                pos ^ offset ^ label in used for label in children):
            offset += 1
        assert offset < 1 << 21
        units[pos] = units.get(pos, 0) | offset << 10
        base = pos ^ offset
        bases.add(base)
        used.update(base ^ label for label in children)
        if None in node:
            units[base] = 1 << 31 | node[None]
        for label in labels:
            child = node[label]
            units[base ^ label] = label | (1 << 8 if None in child else 0)
            todo.append((child, base ^ label))
    size = (max(units) | 0xFF) + 1
    array = [units.get(i, 0) for i in range(size)]
    return (struct.pack("<I", 4 * size) + struct.pack(f"<{size}I", *array)
            + bytes(strings))


def model_proto(pieces, model_type, charsmap=b"", byte_fallback=False,
                user_defined=USER_DEFINED, name="identity"):
    from transformers.utils import sentencepiece_model_pb2_new as pb
    m = pb.ModelProto()
    spec = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    if byte_fallback:
        spec += [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
    spec += [(p, 0.0, 4) for p in user_defined]
    spec += [(p, s, 1) for p, s in pieces if p not in user_defined]
    for p, s, t in spec:
        sp = m.pieces.add()
        sp.piece, sp.score, sp.type = p, s, t
    m.trainer_spec.model_type = model_type
    m.trainer_spec.vocab_size = len(spec)
    m.trainer_spec.byte_fallback = byte_fallback
    m.trainer_spec.unk_id, m.trainer_spec.bos_id = 0, 1
    m.trainer_spec.eos_id, m.trainer_spec.pad_id = 2, -1
    m.normalizer_spec.name = name
    m.normalizer_spec.precompiled_charsmap = charsmap
    m.normalizer_spec.add_dummy_prefix = True
    m.normalizer_spec.remove_extra_whitespaces = True
    m.normalizer_spec.escape_whitespaces = True
    return m.SerializeToString()


def main():
    rng = np.random.RandomState(7)
    lines = corpus(rng)
    counts = word_counts(lines)
    charsmap = build_charsmap(CHARSMAP)
    uni, bpe = unigram_pieces(counts), bpe_pieces(counts)
    models = {
        "unigram": model_proto(uni, 1),
        "unigram_nfkc": model_proto(uni, 1, charsmap, name="nfkc_tool"),
        "unigram_bytes": model_proto(uni, 1, charsmap, True,
                                     name="nfkc_tool"),
        "bpe": model_proto(bpe, 2, user_defined=("<sep>",)),
        "bpe_bytes": model_proto(bpe, 2, charsmap, True, (),
                                 name="nfkc_tool")}
    os.makedirs(OUT, exist_ok=True)
    for name, data in models.items():
        with open(os.path.join(OUT, f"{name}.model"), "wb") as f:
            f.write(data)
    with open(os.path.join(OUT, "charsmap.bin"), "wb") as f:
        f.write(charsmap)
    with open(os.path.join(OUT, "corpus.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {len(models)} models under {OUT}")


if __name__ == "__main__":
    main()
