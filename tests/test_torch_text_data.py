"""The port's text data layer against the JAX package's, on the same
numpy-seeded inputs, all identical: the character, jieba and wordpiece
tokenizers and ``cjk_deseg``; BPE codes learned from
``tests/examples/train.src``; bucket boundaries, their association,
``clean_by_length`` and token-bucketed TRAIN batches; the text datasets
(``parallel_text`` with gzip, ``multiple_parallel_text``,
``in_memory_parallel_text``, ``mono_text``, ``parallel_tfrecord``) and
their sharding; ``MixedTrainDataset``'s sample order and
``MultipleDataset``'s examples and weights; the ``translation`` task's
TRAIN / EVAL / INFER batches; ``compound_split_bleu`` within 1e-6.

The record reader's crc32c (``csrc/crc32c.cpp``, built with the host
compiler) equals its numpy version and ``google_crc32c`` bit for bit, by
both of its routes; the reader checks every record; a build that fails
raises instead of falling back to numpy.
"""

import gzip
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")

from neurst_tpu.data import dataset_utils as jax_du  # noqa: E402
from neurst_tpu.data.datasets.dataset import \
    build_dataset as jax_build_dataset  # noqa: E402
from neurst_tpu.data.recordio import RecordWriter as JaxRecordWriter  # noqa: E402
from neurst_tpu.data.recordio import \
    build_example as jax_build_example  # noqa: E402
from neurst_tpu.data.text import bpe_learner as jax_bpe_learner  # noqa: E402
from neurst_tpu.data.text.subtokenizer import \
    Subtokenizer as JaxSubtokenizer  # noqa: E402
from neurst_tpu.data.text.tokenizer import \
    build_tokenizer_by_name as jax_tokenizer  # noqa: E402
from neurst_tpu.metrics.compound_split_bleu import \
    CompoundSplitBleu as JaxCompoundSplitBleu  # noqa: E402
from neurst_tpu.tasks.task import build_task as jax_build_task  # noqa: E402
from neurst_tpu.utils.compat import ModeKeys  # noqa: E402

import neurst_tpu_torch  # noqa: E402,F401
from neurst_tpu_torch.data import dataset_utils as du  # noqa: E402
from neurst_tpu_torch.data import recordio as rio  # noqa: E402
from neurst_tpu_torch.data.datasets.dataset import build_dataset  # noqa: E402
from neurst_tpu_torch.data.text import bpe_learner  # noqa: E402
from neurst_tpu_torch.data.text.subtokenizer import Subtokenizer  # noqa: E402
from neurst_tpu_torch.data.text.tokenizer import (  # noqa: E402
    Tokenizer, build_tokenizer_by_name)
from neurst_tpu_torch.metrics.compound_split_bleu import \
    CompoundSplitBleu  # noqa: E402
from neurst_tpu_torch.ops import _build  # noqa: E402
from neurst_tpu_torch.tasks.task import build_task  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "tests", "examples")
TEXTS = ["Hello, world! It's a test.", "ab c", "你好 世界", "我爱北京天安门",
         "snake_case \\ back\\slash 3.5km ü-umlaut", "", "  spaced  out ",
         "well-known state-of-the-art results"]


def _lines(name):
    with open(os.path.join(EXAMPLES, name)) as f:
        return [line.strip() for line in f]


def _same_batches(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name, language", [
    ("character", "zh"), ("character", "en"), ("char", "ja"),
    ("jieba", "zh")])
def test_tokenizers_match(name, language):
    if name == "jieba":
        pytest.importorskip("jieba")
    ours = build_tokenizer_by_name(name, language=language)
    theirs = jax_tokenizer(name, language=language)
    for text in TEXTS:
        tokens = theirs.tokenize(text, return_str=True)
        assert ours.tokenize(text, return_str=True) == tokens
        assert ours.tokenize(text) == theirs.tokenize(text)
        assert ours.detokenize(tokens) == theirs.detokenize(tokens)


def test_cjk_deseg_matches():
    from neurst_tpu.data.text.tokenizer import Tokenizer as JaxTokenizer
    for text in TEXTS + ["你 好 world 世 界", " 你 好 ", "a 你 b"]:
        assert Tokenizer.cjk_deseg(text) == JaxTokenizer.cjk_deseg(text)


def test_subtokenizer_vocabulary_and_round_trip_match():
    corpus = _lines("train.src") + TEXTS
    ours = Subtokenizer.build_from_corpus(corpus, target_vocab_size=80,
                                          num_iterations=2,
                                          reserved_tokens=["<pad>"])
    theirs = JaxSubtokenizer.build_from_corpus(corpus, target_vocab_size=80,
                                               num_iterations=2,
                                               reserved_tokens=["<pad>"])
    assert ours.vocab_list == theirs.vocab_list
    for text in TEXTS + corpus[:20]:
        pieces = theirs.tokenize(text, return_str=True)
        assert ours.tokenize(text, return_str=True) == pieces
        assert ours.detokenize(pieces) == theirs.detokenize(pieces)
    # lossless where no subtoken holds a space (ROADMAP R7)
    for text in ["abc_def\\x", "tok5 tok12_tok3", "3.5km\\u"]:
        assert ours.detokenize(ours.tokenize(text, return_str=True)) == text


def test_subtokenizer_vocab_file_loads_the_same(tmp_path):
    st = JaxSubtokenizer.build_from_corpus(_lines("train.src"),
                                           target_vocab_size=60,
                                           num_iterations=2)
    path = str(tmp_path / "vocab.subtokens")
    st.save_vocab(path)
    ours, theirs = Subtokenizer(vocabulary=path), JaxSubtokenizer(
        vocabulary=path)
    assert ours.vocab_list == theirs.vocab_list == st.vocab_list
    for text in _lines("dev.src") + TEXTS:
        assert ours.tokenize(text) == theirs.tokenize(text)


@pytest.mark.parametrize("symbols, min_frequency", [(50, 2), (400, 1)])
def test_bpe_codes_learned_from_the_corpus_match(tmp_path, symbols,
                                                 min_frequency):
    counts = bpe_learner.count_words(_lines("train.src"))
    assert counts == jax_bpe_learner.count_words(_lines("train.src"))
    merges = bpe_learner.learn_bpe(counts, symbols, min_frequency)
    assert merges == jax_bpe_learner.learn_bpe(counts, symbols,
                                               min_frequency)
    assert len(merges) > 10
    assert bpe_learner.apply_and_count(counts, merges) == \
        jax_bpe_learner.apply_and_count(counts, merges)
    for module, name in ((bpe_learner, "ours"), (jax_bpe_learner, "jax")):
        module.write_codes(str(tmp_path / f"{name}.codes"), merges)
        module.write_vocabulary(str(tmp_path / f"{name}.vocab"),
                                module.apply_and_count(counts, merges))
    for suffix in ("codes", "vocab"):
        assert (tmp_path / f"ours.{suffix}").read_text() == \
            (tmp_path / f"jax.{suffix}").read_text()


@pytest.mark.parametrize("max_length, multiple", [
    (16, 8), (100, 8), (128, 8), (128, 16), (256, 64), (3, 8), (20, 1)])
def test_bucket_boundaries_match(max_length, multiple):
    ours = du.create_batch_bucket_boundaries(max_length,
                                             length_multiple=multiple)
    assert ours == jax_du.create_batch_bucket_boundaries(
        max_length, length_multiple=multiple)
    other = du.create_batch_bucket_boundaries(2 * max_length + 5,
                                              length_multiple=multiple)
    for a, b in ((ours, other), (other, ours), (ours, ours)):
        assert du.associated_bucket_boundaries(a, b) == \
            jax_du.associated_bucket_boundaries(a, b)


def test_clean_by_length_matches():
    rng = np.random.RandomState(5)
    for _ in range(50):
        ex = {"feature": list(range(rng.randint(0, 20))),
              "label": list(range(rng.randint(0, 20)))}
        limits = {"feature": int(rng.randint(0, 20)),
                  "label": [None, 0, 10][rng.randint(3)]}
        assert du.clean_by_length(ex, limits) == \
            jax_du.clean_by_length(ex, limits)


@pytest.mark.parametrize("budget, multiple", [(256, 8), (1000, 16),
                                              (64, 8)])
def test_token_bucketed_batches_match(budget, multiple):
    rng = np.random.RandomState(budget)
    examples = [{"feature": rng.randint(4, 50, rng.randint(1, 40)).tolist(),
                 "label": rng.randint(4, 50, rng.randint(1, 40)).tolist(),
                 "tag": str(i)} for i in range(300)]
    bounds = du.associated_bucket_boundaries(
        du.create_batch_bucket_boundaries(32), du.create_batch_bucket_boundaries(
            24))
    args = (budget, {"feature": bounds[0], "label": bounds[1]},
            {"feature": 1, "label": 2},
            lambda ex: {"feature": len(ex["feature"]),
                        "label": len(ex["label"])})
    _same_batches(
        du.batch_by_tokens_bucketed(iter(examples), *args,
                                    batch_size_multiple=multiple,
                                    extra_fields=("tag",)),
        jax_du.batch_by_tokens_bucketed(iter(examples), *args,
                                        batch_size_multiple=multiple,
                                        extra_fields=("tag",)))
    with pytest.raises(ValueError):
        list(du.batch_by_tokens_bucketed(iter(examples), *args,
                                         drop_oversized=False))


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The fixture corpus as plain and gzip files, two seeded parallel
    corpora, and ``parallel_tfrecord`` records of projected ids written
    by the JAX package."""
    root = str(tmp_path_factory.mktemp("text"))
    rng = np.random.RandomState(11)
    paths = {}
    for side in ("src", "trg"):
        paths[side] = os.path.join(EXAMPLES, f"train.{side}")
        paths[side + ".gz"] = os.path.join(root, f"train.{side}.gz")
        with open(paths[side], "rb") as f, \
                gzip.open(paths[side + ".gz"], "wb") as g:
            shutil.copyfileobj(f, g)
    for name, n in (("a", 23), ("b", 7)):
        for side in ("src", "trg"):
            paths[f"{name}.{side}"] = os.path.join(root, f"{name}.{side}")
            with open(paths[f"{name}.{side}"], "w") as f:
                for i in range(n):
                    f.write(f"{name} {side} {i} " + " ".join(
                        f"w{x}" for x in rng.randint(0, 30,
                                                     rng.randint(1, 9)))
                            + "\n")
    paths["records"] = os.path.join(root, "train.tfrecords")
    with JaxRecordWriter(paths["records"]) as w:
        for _ in range(37):
            w.write(jax_build_example({
                "feature": rng.randint(3, 40, rng.randint(1, 20)).astype(
                    np.int64),
                "label": rng.randint(3, 40, rng.randint(1, 20)).astype(
                    np.int64)}))
    return paths


def _dataset_specs(paths):
    return [
        {"dataset.class": "parallel_text",
         "dataset.params": {"src_file": paths["src"],
                            "trg_file": paths["trg"]}},
        {"dataset.class": "ParallelTextDataset",
         "dataset.params": {"src_file": paths["src.gz"],
                            "trg_file": paths["trg.gz"],
                            "data_is_processed": True}},
        {"dataset.class": "parallel_text",
         "dataset.params": {"src_file": paths["src"]}},
        {"dataset.class": "multiple_parallel_text",
         "dataset.params": {"src_files": [paths["a.src"], paths["b.src"]],
                            "trg_files": [paths["a.trg"], paths["b.trg"]]}},
        {"dataset.class": "in_memory_parallel_text",
         "dataset.params": {"src_list": ["x y", "z"],
                            "trg_list": ["1 2", "3"]}},
        {"dataset.class": "mono_text",
         "dataset.params": {"data_file": paths["trg.gz"]}},
        {"dataset.class": "parallel_tfrecord",
         "dataset.params": {"data_path": paths["records"]}},
    ]


@pytest.mark.parametrize("spec", range(7))
@pytest.mark.parametrize("shard", [(0, 1), (1, 3)])
def test_text_datasets_match(corpora, spec, shard):
    args = _dataset_specs(corpora)[spec]
    ours, theirs = build_dataset(args), jax_build_dataset(args)
    assert ours.status == theirs.status
    got = list(ours.build_iterator(shard_id=shard[0],
                                   total_shards=shard[1])())
    want = list(theirs.build_iterator(shard_id=shard[0],
                                      total_shards=shard[1])())
    assert got == want and got
    assert ours.targets == theirs.targets
    assert ours.num_samples == theirs.num_samples
    if hasattr(theirs, "sources"):
        assert ours.sources == theirs.sources


def test_corrupt_record_ends_its_file(corpora, tmp_path):
    """Every record's crc32c is checked: a flipped byte in the 4th record
    ends the file there, as in the JAX reader."""
    data = bytearray(open(corpora["records"], "rb").read())
    offset = 0
    for _ in range(3):
        offset += 8 + 4 + int.from_bytes(data[offset:offset + 8],
                                         "little") + 4
    data[offset + 8 + 4 + 2] ^= 0xFF
    path = str(tmp_path / "bad.tfrecords")
    with open(path, "wb") as f:
        f.write(bytes(data))
    args = {"dataset.class": "parallel_tfrecord",
            "dataset.params": {"data_path": path}}
    got = list(build_dataset(args).build_iterator()())
    assert len(got) == 3
    assert got == list(jax_build_dataset(args).build_iterator()())
    with pytest.raises(IOError, match="crc"):
        list(rio.record_iterator(path, check_crc=True))


@pytest.mark.parametrize("sampler", [
    {"data_sampler.class": "data_sampler",
     "data_sampler.params": {"sample_ratios": {"a": 0.3, "b": 0.7}}},
    {"data_sampler.class": "temperature_sampler",
     "data_sampler.params": {"temperature": 2.0}},
    {}])
@pytest.mark.parametrize("seed, shard", [(0, (0, 1)), (5, (1, 2))])
def test_mixed_train_sample_order_matches(corpora, sampler, seed, shard):
    args = {"dataset.class": "mixed_train", "dataset.params": dict(
        {"data_files": {
            "a": {"src_file": corpora["a.src"], "trg_file": corpora["a.trg"]},
            "b": {"dataset.class": "parallel_text",
                  "dataset.params": {"src_file": corpora["b.src"],
                                     "trg_file": corpora["b.trg"]}}},
         "seed": seed}, **sampler)}
    ours, theirs = build_dataset(args), jax_build_dataset(args)
    assert ours.num_samples is theirs.num_samples is None
    take = []
    for ds in (ours, theirs):
        it = ds.build_iterator(shard_id=shard[0], total_shards=shard[1])()
        take.append([next(it) for _ in range(200)])
    assert take[0] == take[1]
    assert {ex["dataset_key"] for ex in take[0]} == {"a", "b"}


def test_multiple_dataset_matches(corpora):
    args = {"dataset.class": "MultipleDataset", "dataset.params": {
        "multiple_datasets": {
            name: {"dataset.class": "parallel_text",
                   "dataset.params": {"src_file": corpora[f"{name}.src"],
                                      "trg_file": corpora[f"{name}.trg"]}}
            for name in ("b", "a")},
        "sample_weights": "{a: 1.0, b: 3.0}"}}
    ours, theirs = build_dataset(args), jax_build_dataset(args)
    assert ours.sample_weights == theirs.sample_weights == {"a": 0.25,
                                                            "b": 0.75}
    assert sorted(ours.datasets) == sorted(theirs.datasets)
    assert list(ours.build_iterator()()) == list(theirs.build_iterator()())


def _task_args(**extra):
    pipeline = {"vocab_path": os.path.join(EXAMPLES, "vocab.txt")}
    return {"task.class": "translation", "task.params": dict(
        {"src_data_pipeline.class": "TextDataPipeline",
         "src_data_pipeline.params": pipeline,
         "trg_data_pipeline.class": "TextDataPipeline",
         "trg_data_pipeline.params": pipeline,
         "shuffle_buffer": 0, "max_src_len": 16, "max_trg_len": 16},
        **extra)}


@pytest.mark.parametrize("mode, extra", [
    ("train", {"batch_by_tokens": True, "batch_size": 64}),
    ("train", {"batch_by_tokens": True, "batch_size": 200,
               "truncate_src": True, "truncate_trg": True,
               "max_src_len": 6, "max_trg_len": 5,
               "target_begin_of_sentence": "eos"}),
    ("train", {"batch_size": 16, "pad_length_multiple": 4}),
    ("eval", {"batch_size": 7}),
    ("infer", {"batch_size": 5, "gpu_efficient_level": 3}),
    ("infer", {"pad_length_multiple": 16})])
def test_translation_batches_match(corpora, mode, extra):
    mode = {"train": ModeKeys.TRAIN, "eval": ModeKeys.EVAL,
            "infer": ModeKeys.INFER}[mode]
    args = _task_args(**extra)
    ds_args = _dataset_specs(corpora)[0]
    ours, theirs = build_task(args), jax_build_task(args)
    assert ours.get_config() == theirs.get_config()
    _same_batches(
        ours.create_batch_iterator(build_dataset(ds_args), mode)(),
        theirs.create_batch_iterator(jax_build_dataset(ds_args), mode)())


def test_translation_records_batches_match(corpora):
    """PROJECTED ids from ``parallel_tfrecord`` skip the pipeline."""
    args = _task_args(batch_by_tokens=True, batch_size=128)
    ds_args = _dataset_specs(corpora)[6]
    _same_batches(
        build_task(args).create_batch_iterator(build_dataset(ds_args),
                                               ModeKeys.TRAIN)(),
        jax_build_task(args).create_batch_iterator(
            jax_build_dataset(ds_args), ModeKeys.TRAIN)())


def test_compound_split_bleu_matches():
    rng = np.random.RandomState(2)
    words = ["state-of-the-art", "well-known", "a", "model", "x-y", "-",
             "results", "are", "good"]
    hyps = [" ".join(rng.choice(words, rng.randint(3, 12)))
            for _ in range(40)]
    refs = [" ".join(rng.choice(words, rng.randint(3, 12)))
            for _ in range(40)]
    values = []
    for groundtruth in (refs, [[r, h] for r, h in zip(refs, hyps)]):
        ours = CompoundSplitBleu()(hyps, groundtruth)
        values.append(ours["CompoundSplitBleu"])
        theirs = JaxCompoundSplitBleu()(hyps, groundtruth)
        assert sorted(ours) == sorted(theirs) == [
            "CompoundSplitBleu", "UncasedCompoundSplitBleu"]
        for k in theirs:
            assert abs(ours[k] - theirs[k]) <= 1e-6
    assert 0 < values[0] < values[1] == 100


@pytest.mark.parametrize("seed", range(4))
def test_native_crc32c_matches_numpy_and_google(seed):
    """Random lengths 0-1 MB; both routes of the library (the crc32
    instruction where the CPU has it, the slicing-by-8 tables)."""
    google_crc32c = pytest.importorskip("google_crc32c")
    rng = np.random.RandomState(seed)
    lengths = [0, 1, 7, 8, 9, 4095] + rng.randint(0, 1 << 20, 4).tolist()
    lib = rio._native()
    for n in lengths:
        data = rng.bytes(n)
        want = google_crc32c.value(data)
        assert rio.crc32c(data) == want, n
        assert rio.crc32c_numpy(data) == want, n
        assert lib.neurst_crc32c_tables(data, len(data)) == want, n
    assert rio.crc32c(bytearray(b"123456789")) == 0xE3069283


def test_crc32c_build_failure_raises(tmp_path, monkeypatch):
    """A library that does not build raises; the reader does not fall
    back to numpy."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "torch_kernels")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setenv("CXX", shutil.which("false") or "/bin/false")
    rio._native.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="build failed"):
            rio.crc32c(b"abc")
    finally:
        rio._native.cache_clear()
