"""The port's data layer against the JAX package's, on the same
numpy-seeded inputs: TFRecord/Example files each package writes read the
same in the other (crc32c included); vocabulary, BPE and Moses
encode -> decode; the text pipeline; ``batch_fixed_size``; the
speech2text INFER and EVAL batches of an ``audio_tfrecord`` file;
BLEU and WER.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

from neurst_tpu.data import dataset_utils as jax_du  # noqa: E402
from neurst_tpu.data import recordio as jax_rio  # noqa: E402
from neurst_tpu.data.data_pipelines.text_data_pipeline import \
    TextDataPipeline as JaxTextDataPipeline  # noqa: E402
from neurst_tpu.data.datasets.dataset import \
    build_dataset as jax_build_dataset  # noqa: E402
from neurst_tpu.data.text.bpe import BPE as JaxBPE  # noqa: E402
from neurst_tpu.data.text.moses import \
    MosesTokenizer as JaxMosesTokenizer  # noqa: E402
from neurst_tpu.data.text.vocab import Vocab as JaxVocab  # noqa: E402
from neurst_tpu.metrics.bleu import BLEU as JaxBLEU  # noqa: E402
from neurst_tpu.metrics.wer import WER as JaxWER  # noqa: E402
from neurst_tpu.tasks.task import build_task as jax_build_task  # noqa: E402
from neurst_tpu.utils.compat import ModeKeys  # noqa: E402

import neurst_tpu_torch  # noqa: E402,F401
from neurst_tpu_torch.data import dataset_utils as du  # noqa: E402
from neurst_tpu_torch.data import recordio as rio  # noqa: E402
from neurst_tpu_torch.data.data_pipelines.text_data_pipeline import \
    TextDataPipeline  # noqa: E402
from neurst_tpu_torch.data.datasets.dataset import build_dataset  # noqa: E402
from neurst_tpu_torch.data.text.bpe import BPE  # noqa: E402
from neurst_tpu_torch.data.text.moses import MosesTokenizer  # noqa: E402
from neurst_tpu_torch.data.text.vocab import Vocab  # noqa: E402
from neurst_tpu_torch.metrics.bleu import BLEU  # noqa: E402
from neurst_tpu_torch.metrics.wer import WER  # noqa: E402
from neurst_tpu_torch.tasks.task import build_task  # noqa: E402

WORDS = ["the", "cat", "sat", "on", "mat", "dog", "ran", "a", "big",
         "red", "house", "we", "saw", "it", "Hello", "world", ",", "."]
CODES = ["#version: 0.2", "a t</w>", "o g</w>", "o u", "ou s", "ous e</w>",
         "m a", "a n</w>", "e d</w>", "i g</w>", "t h", "th e</w>", "s a",
         "sa t</w>", "o n</w>", "l l", "ll o</w>", "w o", "r l", "rl d</w>"]
SENTENCES = ["Hello, world. The cat sat on the mat!",
             "We saw a big red house (it's \"new\").",
             "dogs ran 3.5 km -- fast",
             "", "  spaced   out  text  "]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(WORDS + ["c@@", "d@@", "og", "ma@@", "t", "s@@",
                                   "ran", "h@@", "ouse", "Hel@@", "lo"])
                + "\n")
    codes = os.path.join(root, "codes.bpe")
    with open(codes, "w") as f:
        f.write("\n".join(CODES) + "\n")
    return root, vocab, codes


@pytest.mark.parametrize("n", [0, 1, 63, 256, 4097, 70001, 300000])
def test_crc32c_matches_the_jax_package(n):
    data = np.random.RandomState(n).randint(0, 256, n).astype(
        np.uint8).tobytes()
    assert rio.crc32c(data) == jax_rio._crc32c(data)


def _examples(rng, n=5):
    out = []
    for i in range(n):
        out.append({
            "audio": rng.randn(int(rng.randint(1, 40)) * 4).astype(
                np.float32),
            "ids": rng.randint(-5, 2 ** 40, size=int(rng.randint(0, 6))),
            "text": " ".join(rng.choice(WORDS, 3)) + f" {i} ü"})
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_records_read_the_same_in_both_packages(tmp_path, writer):
    rng = np.random.RandomState(1)
    examples = _examples(rng)
    path = str(tmp_path / "x.tfrecords")
    mod = jax_rio if writer == "jax" else rio
    with mod.RecordWriter(path) as w:
        for ex in examples:
            w.write(mod.build_example(ex))
    for reader in (jax_rio, rio):
        got = [reader.parse_example(r)
               for r in reader.record_iterator(path, check_crc=True)]
        assert len(got) == len(examples)
        for ex, g in zip(examples, got):
            np.testing.assert_array_equal(g["audio"], ex["audio"])
            np.testing.assert_array_equal(g["ids"], ex["ids"])
            assert g["text"] == [ex["text"].encode("utf-8")]
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    raw[20] ^= 0xFF  # inside the first record's payload
    with open(path, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(IOError):
        list(rio.record_iterator(path, check_crc=True))


def test_vocab_bpe_moses_encode_decode_match(files):
    _, vocab, codes = files
    assert Vocab.load_from_file(vocab).tokens == \
        JaxVocab.load_from_file(vocab).tokens
    bpe, jbpe = BPE(vocabulary=vocab), JaxBPE(vocabulary=vocab)
    bpe.init_subtokenizer(codes)
    jbpe.init_subtokenizer(codes)
    moses, jmoses = MosesTokenizer(), JaxMosesTokenizer()
    for text in SENTENCES:
        tok = moses.tokenize(text, return_str=True)
        assert tok == jmoses.tokenize(text, return_str=True)
        sub = bpe.tokenize(tok, return_str=True)
        assert sub == jbpe.tokenize(tok, return_str=True)
        assert bpe.detokenize(sub) == jbpe.detokenize(sub)
        assert moses.detokenize(bpe.detokenize(sub)) == \
            jmoses.detokenize(jbpe.detokenize(sub))


def test_text_pipeline_matches(files):
    _, vocab, codes = files
    kwargs = dict(vocab_path=vocab, language="en", tokenizer="moses",
                  subtokenizer="bpe", subtokenizer_codes=codes)
    port, jax_p = TextDataPipeline(**kwargs), JaxTextDataPipeline(**kwargs)
    assert port.meta == jax_p.meta
    rng = np.random.RandomState(2)
    for text in SENTENCES:
        ids = port.encode(text)
        assert ids == jax_p.encode(text)
        assert port.decode(ids) == jax_p.decode(ids)
    for _ in range(5):
        ids = rng.randint(0, port.meta["vocab_size"], 12).tolist()
        assert port.decode(ids) == jax_p.decode(ids)


@pytest.mark.parametrize("multiple", [1, 8])
def test_batch_fixed_size_matches(multiple):
    rng = np.random.RandomState(3)
    examples = [{"ids": rng.randint(0, 50, int(rng.randint(1, 20))).tolist(),
                 "n": i} for i in range(11)]
    ours = list(du.batch_fixed_size(iter(examples), 4, {"ids": 7}, ["ids"],
                                    pad_length_multiple=multiple,
                                    extra_fields=("n",)))
    theirs = list(jax_du.batch_fixed_size(iter(examples), 4, {"ids": 7},
                                          ["ids"],
                                          pad_length_multiple=multiple,
                                          extra_fields=("n",)))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert du.round_up(13, 8) == jax_du.round_up(13, 8) == 16
    assert du.adjust_batch_size(None, 4, 2) == jax_du.adjust_batch_size(
        None, 4, 2) == 8
    np.testing.assert_array_equal(du.pad_to([1, 2, 3], 5, 0),
                                  jax_du.pad_to([1, 2, 3], 5, 0))


def test_batch_fixed_size_keeps_float_features():
    """The port's batcher keeps audio features float32 (the JAX one casts
    them to int32: ROADMAP R5)."""
    audio = np.asarray([0.7, -1.6, 2.2], np.float32)
    batch = next(du.batch_fixed_size(iter([{"audio": audio}]), 2,
                                     {"audio": 0}, ["audio"],
                                     pad_length_multiple=4))
    assert batch["audio"].dtype == np.float32
    np.testing.assert_array_equal(batch["audio"][0][:3], audio)
    assert batch["audio"][0][3] == 0.0
    np.testing.assert_array_equal(batch["sample_mask"], [1.0, 0.0])


@pytest.mark.parametrize("mode", [ModeKeys.INFER, ModeKeys.EVAL])
def test_speech2text_batches_match(files, tmp_path, mode):
    """An ``audio_tfrecord`` file of 6 ST utterances (whole-number
    features, see R5; raw translation text) through each package's
    dataset and speech2text batch iterator, 4 a batch."""
    _, vocab, codes = files
    rng = np.random.RandomState(4)
    path = str(tmp_path / "st.tfrecords")
    with rio.RecordWriter(path) as w:
        for _ in range(6):
            frames = int(rng.randint(1, 90))
            w.write(rio.build_example({
                "audio": np.round(3 * rng.randn(frames * 8)).astype(
                    np.float32),
                "translation": " ".join(rng.choice(WORDS, 4))}))
    task_cfg = {"task.class": "speech2text", "task.params": {
        "audio_feature_dim": 8, "batch_size": 4,
        "transcript_data_pipeline.class": "TextDataPipeline",
        "transcript_data_pipeline.params": {
            "vocab_path": vocab, "tokenizer": "moses", "subtokenizer": "bpe",
            "subtokenizer_codes": codes}}}
    ds_cfg = {"dataset.class": "audio_tfrecord", "dataset.params": {
        "data_path": path, "transcript_key": "translation"}}
    results = []
    for build_t, build_d in ((build_task, build_dataset),
                             (jax_build_task, jax_build_dataset)):
        task, ds = build_t(task_cfg), build_d(ds_cfg)
        assert ds.status["transcript"] == "raw"
        batches = list(task.create_batch_iterator(ds, mode)())
        results.append((batches, ds.targets))
    (ours, our_targets), (theirs, their_targets) = results
    assert our_targets == their_targets and len(our_targets) == 6
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        assert a["src"].dtype == np.float32
        assert a["src"].shape[1] % 64 == 0
    assert ours[-1]["sample_mask"].tolist() == [1, 1, 0, 0]
    assert ours[-1]["src_length"][2:].tolist() == [0, 0]


def test_bleu_and_wer_match():
    rng = np.random.RandomState(5)
    refs = [" ".join(rng.choice(WORDS, int(rng.randint(3, 12))))
            for _ in range(20)]
    hyps = [" ".join(r.split()[:-1] + list(rng.choice(WORDS, 2)))
            if i % 3 else r for i, r in enumerate(refs)]
    for ours, theirs in ((BLEU(), JaxBLEU()),
                         (BLEU({"language": "zh"}), JaxBLEU({"language": "zh"})),
                         (WER(), JaxWER())):
        a, b = ours(hyps, refs), theirs(hyps, refs)
        assert a.keys() == b.keys()
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-6 and a[k] > 0.0
