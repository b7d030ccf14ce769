"""The port's TensorFlow-free checkpoint reader (``utils/converters/
tf_bundle.py``) and the reference goldens through the port alone.

* Every fixture dir under ``tests/fixtures/reference_goldens/*tf_ckpt*``
  is read in a fresh interpreter that never imports TensorFlow (nor JAX).
  That interpreter also converts each fixture and decodes its golden
  corpus (text dev sets, speech features, the toy model's logits and beam
  ids) through the port's pipeline, model and beam search on the CPU in
  float32: every hypothesis equals the original NeurST's.
* Where TensorFlow is installed, every variable (the object graph's
  strings too) and its dtype equal ``tf.train.load_checkpoint``'s,
  bitwise, and the port's ``neurst_transformer`` conversion of each dir
  equals the JAX converter's (which reads through TensorFlow) bitwise.
* A flipped data byte, a flipped index byte, a compressed block and a
  big-endian header each raise.
"""

import glob
import json
import os
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest

from neurst_tpu_torch.utils.converters import build_converter
from neurst_tpu_torch.utils.converters.tf_bundle import (BundleReader,
                                                         load_bundle,
                                                         resolve_prefix)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = sorted(glob.glob(os.path.join(
    REPO, "tests", "fixtures", "reference_goldens", "*tf_ckpt*")))
IDS = [os.path.basename(p) for p in FIXTURES]


def test_fixtures_read_and_goldens_decode_without_tensorflow_or_jax():
    code = (
        "import json, sys\n"
        "import chip_smoke\n"
        "from neurst_tpu_torch.utils.converters.tf_bundle import "
        "load_bundle\n"
        f"for d in {FIXTURES!r}:\n"
        "    assert load_bundle(d)\n"
        "out = chip_smoke.reference_golden_decodes('cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('tensorflow', 'jax', 'jaxlib', 'flax', 'neurst_tpu'))\n"
        "print(json.dumps({'goldens': out, 'leaked': bad}))\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["leaked"] == []
    assert sorted(result["goldens"]) == sorted(IDS)
    for fixture, row in result["goldens"].items():
        assert row["matched"] == row["total"] > 0, (fixture, row)
    assert result["goldens"]["corpus_tf_ckpt_wide"]["total"] == 240


@pytest.mark.parametrize("path", FIXTURES, ids=IDS)
def test_every_variable_equals_tensorflow_bitwise(path):
    tf = pytest.importorskip("tensorflow")
    reader = tf.train.load_checkpoint(path)
    dtypes = reader.get_variable_to_dtype_map()
    ours = BundleReader(path)
    assert ours.dtypes() == {k: v.name for k, v in dtypes.items()}
    shapes = reader.get_variable_to_shape_map()
    assert ours.shapes() == {k: tuple(v) for k, v in shapes.items()}
    for key in dtypes:
        want, got = reader.get_tensor(key), ours.get_tensor(key)
        if dtypes[key].name == "string":
            assert np.asarray(want, object).tolist() == got.tolist(), key
        else:
            assert got.dtype == want.dtype and got.shape == want.shape, key
            assert got.tobytes() == want.tobytes(), key


@pytest.mark.parametrize("path", FIXTURES, ids=IDS)
def test_neurst_transformer_conversion_equals_jax(path):
    pytest.importorskip("tensorflow")
    pytest.importorskip("jax")
    from neurst_tpu.utils.converters.converter import \
        build_converter as jax_converter
    args = {"converter.class": "neurst_transformer",
            "converter.params": {"num_heads": 4}}
    ours = build_converter(args).convert_to_flat(path)
    want = jax_converter(args).convert_to_flat(path)
    # the key order follows each reader's (the SSTable's here,
    # TensorFlow's dtype map there)
    assert sorted(ours) == sorted(want)
    for key in want:
        assert ours[key].dtype == want[key].dtype, key
        assert ours[key].tobytes() == want[key].tobytes(), key


def _copy(tmp_path, name="tf_ckpt"):
    src = os.path.join(REPO, "tests", "fixtures", "reference_goldens", name)
    dst = str(tmp_path / name)
    shutil.copytree(src, dst)
    return dst, resolve_prefix(dst)


def _flip(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0x40]))


def test_a_corrupted_data_byte_raises(tmp_path):
    d, prefix = _copy(tmp_path)
    assert load_bundle(d)
    _flip(prefix + ".data-00000-of-00001", 1000)
    with pytest.raises(ValueError, match="crc32c mismatch"):
        load_bundle(d)


@pytest.mark.parametrize("offset", [10, 200])
def test_a_corrupted_index_block_raises(tmp_path, offset):
    d, prefix = _copy(tmp_path)
    _flip(prefix + ".index", offset)
    with pytest.raises(ValueError, match="crc32c mismatch"):
        BundleReader(d)


def _rewrite_block(prefix, mutate):
    """Rewrites the index's first data block (its bytes and trailer,
    a valid crc32c recomputed) through ``mutate(block, kind) -> (block,
    kind)``; the block keeps its size."""
    from neurst_tpu_torch.data.recordio import crc32c
    from neurst_tpu_torch.utils.converters import tf_bundle as tb
    path = prefix + ".index"
    with open(path, "rb") as f:
        data = bytearray(f.read())
    footer = bytes(data[-48:])
    _, _, pos = tb._block_handle(footer, 0)
    index_offset, index_size, _ = tb._block_handle(footer, pos)
    index = bytes(data[index_offset:index_offset + index_size])
    _, handle = next(tb._block_entries(index, path))
    offset, size, _ = tb._block_handle(handle, 0)
    block, kind = mutate(bytes(data[offset:offset + size]),
                         data[offset + size])
    assert len(block) == size
    data[offset:offset + size] = block
    data[offset + size] = kind
    crc = tb._masked(crc32c(bytes(data[offset:offset + size + 1])))
    data[offset + size + 1:offset + size + 5] = struct.pack("<I", crc)
    with open(path, "wb") as f:
        f.write(bytes(data))


def test_a_compressed_block_raises(tmp_path):
    d, prefix = _copy(tmp_path)
    _rewrite_block(prefix, lambda block, kind: (block, 1))
    with pytest.raises(ValueError, match="compression type 1"):
        BundleReader(d)


def test_a_big_endian_bundle_raises(tmp_path):
    """The header entry (key "", the first of the first block: num_shards
    1 and a VersionDef; proto3 leaves LITTLE, the default, out) rewritten
    in its 6 bytes to num_shards 1 and endianness BIG."""
    d, prefix = _copy(tmp_path)
    header = bytes.fromhex("08011a020801")

    def big_endian(block, kind):
        assert block[3:9] == header  # after (shared, unshared, size)
        return block[:3] + bytes.fromhex("080108011001") + block[9:], kind

    _rewrite_block(prefix, big_endian)
    with pytest.raises(ValueError, match="big-endian"):
        BundleReader(d)
