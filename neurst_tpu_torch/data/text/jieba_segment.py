"""jieba's default segmentation, ``jieba.cut(sentence, cut_all=False,
HMM=True)`` of jieba 0.42.1, with no ``jieba`` package: the port reads
jieba's dictionary and HMM tables from ``jieba_data/`` (written by
``tests/tools/make_jieba_tables.py``; jieba's MIT notice is in
``jieba_data/NOTICE``).

A sentence is split into blocks of CJK characters, ASCII letters and
digits and ``+#&._%-`` (each cut by the dictionary) and the rest (split
at ``\\r\\n`` and whitespace, other characters one by one).  A block is
cut along the route of highest log frequency through the DAG of its
dictionary words; a run of single characters that the dictionary does
not hold as a word goes to the HMM (Viterbi over the states B, M, E, S),
which finds words the dictionary lacks.

The dictionary loads once per process, at first use.  Words added with
``add_word`` (glossaries) belong to one ``JiebaSegmenter``: unlike
jieba's global ``add_word``, they change no other segmenter.
"""

import gzip
import io
import json
import os
import re
import threading
from math import log

__all__ = ["JiebaSegmenter"]

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jieba_data")

# jieba/__init__.py: the blocks the dictionary cuts, and the separators of
# the rest
RE_HAN_DEFAULT = re.compile("([\u4e00-\u9fd5a-zA-Z0-9+#&\\._%\\-]+)")
RE_SKIP_DEFAULT = re.compile("(\r\n|\\s)")
# jieba/__init__.py: ASCII letters and digits, which cut without the HMM
# joins
RE_ENG = re.compile("[a-zA-Z0-9]")
# jieba/finalseg: the runs the HMM cuts, and the Latin words and numbers
# it keeps whole
RE_HMM_HAN = re.compile("([\u4e00-\u9fd5]+)")
RE_HMM_SKIP = re.compile("([a-zA-Z0-9]+(?:\\.\\d+)?%?)")
MIN_FLOAT = -3.14e100
PREV_STATUS = {"B": "ES", "M": "MB", "S": "SE", "E": "BM"}

_LOCK = threading.Lock()
_TABLES = {}


def _read(name):
    with gzip.open(os.path.join(DATA, name), "rb") as f:
        return f.read()


def dictionary():
    """(prefix dictionary, total frequency) of jieba's main dictionary:
    every word with its frequency and every prefix of a word that is not
    a word itself with 0 (jieba's ``gen_pfdict``)."""
    with _LOCK:
        if "dict" not in _TABLES:
            freq, total = {}, 0
            for lineno, line in enumerate(io.BytesIO(_read("dict.txt.gz")),
                                          1):
                line = line.strip().decode("utf-8")
                try:
                    word, count = line.split(" ")[:2]
                    count = int(count)
                except ValueError:
                    raise ValueError(f"invalid jieba dictionary entry at line "
                                     f"{lineno}: {line}") from None
                freq[word] = count
                total += count
                for i in range(len(word)):
                    freq.setdefault(word[:i + 1], 0)
            _TABLES["dict"] = (freq, total)
        return _TABLES["dict"]


def hmm():
    """(start, transition, emission) log-probabilities of the HMM."""
    with _LOCK:
        if "hmm" not in _TABLES:
            tables = json.loads(_read("hmm.json.gz").decode("utf-8"))
            _TABLES["hmm"] = (tables["start"], tables["trans"],
                              tables["emit"])
        return _TABLES["hmm"]


def viterbi(obs):
    """The most likely B/M/E/S states of the characters ``obs``
    (``finalseg.viterbi``: the same sums in the same order, so ties
    resolve as jieba's do)."""
    start_p, trans_p, emit_p = hmm()
    states = "BMES"
    v = [{}]
    path = {}
    for y in states:
        v[0][y] = start_p[y] + emit_p[y].get(obs[0], MIN_FLOAT)
        path[y] = [y]
    for t in range(1, len(obs)):
        v.append({})
        newpath = {}
        for y in states:
            em_p = emit_p[y].get(obs[t], MIN_FLOAT)
            prob, state = max(
                (v[t - 1][y0] + trans_p[y0].get(y, MIN_FLOAT) + em_p, y0)
                for y0 in PREV_STATUS[y])
            v[t][y] = prob
            newpath[y] = path[state] + [y]
        path = newpath
    _, state = max((v[len(obs) - 1][y], y) for y in "ES")
    return path[state]


def _hmm_words(sentence):
    """A run of CJK characters cut by the HMM."""
    states = viterbi(sentence)
    begin = nexti = 0
    for i, char in enumerate(sentence):
        pos = states[i]
        if pos == "B":
            begin = i
        elif pos == "E":
            yield sentence[begin:i + 1]
            nexti = i + 1
        elif pos == "S":
            yield char
            nexti = i + 1
    if nexti < len(sentence):
        yield sentence[nexti:]


def hmm_cut(sentence):
    """``finalseg.cut``: CJK runs by the HMM, Latin words and numbers
    whole, the rest as it comes."""
    for blk in RE_HMM_HAN.split(sentence):
        if RE_HMM_HAN.match(blk):
            yield from _hmm_words(blk)
        else:
            for x in RE_HMM_SKIP.split(blk):
                if x:
                    yield x


class JiebaSegmenter(object):
    """jieba's accurate mode over the main dictionary and the words added
    to this segmenter."""

    def __init__(self, words=()):
        self._freq, self._total = dictionary()
        if words:
            self._freq = dict(self._freq)
        for word in words:
            self.add_word(word)

    def add_word(self, word):
        """jieba's ``add_word(word)``: its frequency is ``suggest_freq``'s,
        the least that cuts the word out whole."""
        freq = self.suggest_freq(word)
        self._freq[word] = freq
        self._total += freq
        for i in range(len(word)):
            self._freq.setdefault(word[:i + 1], 0)

    def suggest_freq(self, word):
        """jieba's ``suggest_freq(word, tune=False)`` for a word that
        should be cut out whole."""
        ftotal = float(self._total)
        freq = 1
        for seg in self.cut(word, hmm=False):
            freq *= self._freq.get(seg, 1) / ftotal
        return max(int(freq * self._total) + 1, self._freq.get(word, 1))

    def _dag(self, sentence):
        """{start: [ends]} of the dictionary words in ``sentence``."""
        freq = self._freq
        dag = {}
        n = len(sentence)
        for k in range(n):
            ends = []
            i = k
            frag = sentence[k]
            while i < n and frag in freq:
                if freq[frag]:
                    ends.append(i)
                i += 1
                frag = sentence[k:i + 1]
            if not ends:
                ends.append(k)
            dag[k] = ends
        return dag

    def _route(self, sentence, dag):
        """jieba's ``calc``: from each position, (best log probability of
        the rest, end of the first word)."""
        freq = self._freq
        n = len(sentence)
        route = {n: (0, 0)}
        logtotal = log(self._total)
        for idx in range(n - 1, -1, -1):
            route[idx] = max((log(freq.get(sentence[idx:x + 1]) or 1)
                              - logtotal + route[x + 1][0], x)
                             for x in dag[idx])
        return route

    def _cut_dag(self, sentence):
        """A block along its route; runs of single characters that are
        not a dictionary word go to the HMM."""
        route = self._route(sentence, self._dag(sentence))
        x = 0
        buf = ""
        n = len(sentence)
        while x < n:
            y = route[x][1] + 1
            word = sentence[x:y]
            if y - x == 1:
                buf += word
            else:
                if buf:
                    yield from self._flush(buf)
                    buf = ""
                yield word
            x = y
        if buf:
            yield from self._flush(buf)

    def _flush(self, buf):
        if len(buf) == 1:
            yield buf
        elif not self._freq.get(buf):
            yield from hmm_cut(buf)
        else:
            yield from buf

    def _cut_dag_no_hmm(self, sentence):
        route = self._route(sentence, self._dag(sentence))
        x = 0
        n = len(sentence)
        buf = ""
        while x < n:
            y = route[x][1] + 1
            word = sentence[x:y]
            if len(word) == 1 and RE_ENG.match(word):
                buf += word
            else:
                if buf:
                    yield buf
                    buf = ""
                yield word
            x = y
        if buf:
            yield buf

    def cut(self, sentence, hmm=True):
        """The words of ``sentence`` in order (jieba's ``cut`` with
        ``cut_all=False``), whitespace included."""
        cut_block = self._cut_dag if hmm else self._cut_dag_no_hmm
        for blk in RE_HAN_DEFAULT.split(sentence):
            if not blk:
                continue
            if RE_HAN_DEFAULT.match(blk):
                yield from cut_block(blk)
            else:
                for x in RE_SKIP_DEFAULT.split(blk):
                    if RE_SKIP_DEFAULT.match(x):
                        yield x
                    else:
                        yield from x
