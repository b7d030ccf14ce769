"""The port's own jieba (``jieba_segment`` over the dictionary and HMM
tables it carries) against the jieba package: ``jieba.cut`` on seeded
lines (dictionary words by frequency, runs the HMM cuts, numbers,
Latin words, punctuation, ``\\r\\n`` and full-width spaces), the JAX
``jieba`` tokenizer's ``tokenize`` / ``detokenize``, glossaries, and the
committed data and goldens.  All exact.

jieba's ``add_word`` changes its global dictionary, so everything that
adds words on the JAX side runs in a fresh interpreter (started when
the module's fixture is first used, beside the port's side)."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

jieba = pytest.importorskip("jieba")
pytest.importorskip("jax")

from neurst_tpu_torch.data.text import build_tokenizer  # noqa: E402
from neurst_tpu_torch.data.text.jieba_segment import (  # noqa: E402
    JiebaSegmenter, dictionary)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "fixtures", "text_goldens",
                       "tokenizer_goldens.json")
N_LINES = 2000
jieba.setLogLevel(60)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tests", "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TOOL = _tool("make_tokenizer_goldens")
GLOSSARIES = TOOL.GLOSSARIES
GLOSSARY_TEXTS = ["李小福是创新办主任也是云计算方面的专家",
                  "我们用深度学习框架做语音翻译"] + [
    f"我们讨论{w}的问题" for w in GLOSSARIES]

# the JAX side: tokenizers with glossaries, then one without (which sees
# them too: jieba's dictionary is global)
JAX_GLOSSARY_SIDE = r"""
import json, sys
import jieba
jieba.setLogLevel(60)
from neurst_tpu.data.text.jieba_tokenizer import JiebaTokenizer
texts, glossaries, lines = json.loads(sys.argv[1])
plain_first = [JiebaTokenizer().tokenize(t) for t in texts]
with_glossaries = JiebaTokenizer(glossaries=glossaries)
out = {"plain_first": plain_first,
       "glossaries": [with_glossaries.tokenize(t) for t in texts],
       "glossary_detok": [with_glossaries.detokenize(
           with_glossaries.tokenize(t)) for t in texts],
       "plain_after": [JiebaTokenizer().tokenize(t) for t in texts],
       "golden_lines": [list(jieba.cut(s)) for s in lines]}
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def goldens():
    with open(GOLDENS, encoding="utf-8") as f:
        return json.load(f)["jieba"]


@pytest.fixture(scope="module")
def jax_glossary_process(goldens):
    """The JAX side in a fresh interpreter, started with the module's
    first test so that it imports while the port's side runs."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    args = json.dumps([GLOSSARY_TEXTS, GLOSSARIES,
                       goldens["glossary_lines"]])
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_GLOSSARY_SIDE, args], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.wait()


@pytest.fixture(scope="module")
def jax_glossary_side(jax_glossary_process):
    """The JAX side's results."""
    out, err = jax_glossary_process.communicate(timeout=300)
    assert jax_glossary_process.returncode == 0, err[-3000:]
    line = next(x for x in out.splitlines() if x.startswith("JSON"))
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def lines(jax_glossary_process):
    return TOOL.jieba_lines(N_LINES, 7)


def test_cut_equals_jieba_on_seeded_lines(lines):
    seg = JiebaSegmenter()
    differ = [s for s in lines if list(seg.cut(s)) != list(jieba.cut(s))]
    assert not differ, differ[:5]


def test_lines_exercise_the_hmm_and_the_skipped_blocks(lines):
    """Some words of the seeded lines are not in the dictionary (the HMM
    found them), and ``\\r\\n``, full-width spaces and numbers with a
    decimal or percent sign come out whole."""
    freq, _ = dictionary()
    seg = JiebaSegmenter()
    words = [w for s in lines for w in seg.cut(s)]
    hmm_words = {w for w in words if len(w) > 1 and not freq.get(w)
                 and "一" <= w[0] <= "鿕"}
    assert len(hmm_words) > 100
    for kind in ("\r\n", "　"):
        assert kind in words
    assert any(w.endswith("%") and "." in w for w in words)


def test_tokenizer_equals_the_jax_tokenizer(lines):
    from neurst_tpu.data.text.tokenizer import build_tokenizer as jax_build
    ours = build_tokenizer({"tokenizer.class": "jieba",
                            "tokenizer.params": {"language": "zh"}})
    theirs = jax_build({"tokenizer.class": "jieba",
                        "tokenizer.params": {"language": "zh"}})
    for s in lines[:400]:
        tokens = theirs.tokenize(s, return_str=True)
        assert ours.tokenize(s, return_str=True) == tokens
        assert ours.tokenize(s) == theirs.tokenize(s)
        assert ours.detokenize(tokens) == theirs.detokenize(tokens)
        assert all(t.strip() for t in ours.tokenize(s))


def test_glossaries_equal_the_jax_tokenizer(jax_glossary_side):
    tok = build_tokenizer({"tokenizer.class": "jieba_segment",
                           "tokenizer.params": {"glossaries": GLOSSARIES}})
    got = [tok.tokenize(t) for t in GLOSSARY_TEXTS]
    assert got == jax_glossary_side["glossaries"]
    assert [tok.detokenize(t) for t in got] == \
        jax_glossary_side["glossary_detok"]
    for word in GLOSSARIES:
        assert any(word in t for t in got), word


def test_glossaries_belong_to_one_tokenizer(jax_glossary_side):
    """The kept difference: a JAX tokenizer adds its glossaries to
    jieba's global dictionary, so one built after it cuts with them; the
    port's glossaries stay with their tokenizer."""
    build_tokenizer({"tokenizer.class": "jieba",
                     "tokenizer.params": {"glossaries": GLOSSARIES}})
    after = build_tokenizer("jieba")
    got = [after.tokenize(t) for t in GLOSSARY_TEXTS]
    assert got == jax_glossary_side["plain_first"]
    assert jax_glossary_side["plain_after"] == \
        jax_glossary_side["glossaries"]
    assert got != jax_glossary_side["plain_after"]


def test_data_is_current():
    """``jieba_data/`` is what ``tests/tools/make_jieba_tables.py``
    writes from the installed jieba, byte for byte."""
    data = os.path.join(REPO, "neurst_tpu_torch", "data", "text",
                        "jieba_data")
    tables = _tool("make_jieba_tables").tables()
    assert sorted(os.listdir(data)) == sorted(tables)
    for name, want in tables.items():
        with open(os.path.join(data, name), "rb") as f:
            assert f.read() == want, name


def test_goldens_are_current(goldens, jax_glossary_side):
    """The committed jieba goldens: their lines are the generator's,
    their cuts jieba's (the glossary cuts from the fresh interpreter,
    after ``add_word``), and the port gives them."""
    assert goldens["lines"] == TOOL.jieba_lines(TOOL.JIEBA_LINES, 23)
    assert goldens["cut"] == [list(jieba.cut(s)) for s in goldens["lines"]]
    assert goldens["glossaries"] == GLOSSARIES
    assert goldens["glossary_cut"] == jax_glossary_side["golden_lines"]
    seg = JiebaSegmenter(GLOSSARIES)
    assert [list(seg.cut(s)) for s in goldens["glossary_lines"]] == \
        goldens["glossary_cut"]


def test_an_empty_or_blank_line_has_no_tokens():
    tok = build_tokenizer("jieba")
    for text in ("", "   ", "\r\n", "　"):
        assert tok.tokenize(text) == []
        assert tok.tokenize(text, return_str=True) == ""
