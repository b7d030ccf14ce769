"""The orbax checkpoint format of the port (``utils/zstd``, its C++ zstd
decoder, ``utils/ocdbt``, ``utils/zarr``, ``utils/orbax_checkpoints``
and ``--checkpoint_format orbax``) against TensorStore, zstandard and the
JAX package on the CPU.  The port imports none of them; they are the
oracles here.

* zstd: the port's decoder against ``zstandard`` on random, repetitive,
  text and float frames at levels 1-19 (with and without the content
  checksum and size), several frames and skippable frames in one buffer,
  the zarr chunks of a JAX-written checkpoint; a dictionary frame and a
  corrupted checksum raise.
* OCDBT both ways through TensorStore: stores TensorStore writes (one
  node; several nodes with a small node limit and indirect values above a
  small inline limit; several versions and data files) read by the port,
  and the port's stores (one process, and the root manifest over two
  process stores) read by TensorStore.
* zarr both ways through TensorStore's zarr driver over OCDBT.
* The JAX package's ``save_checkpoint_orbax`` of arrays sharded over the
  8 CPU devices (model and data axes, bfloat16 and int32 included) read
  by the port bitwise; the port's checkpoint read by the JAX package's
  ``restore_checkpoint_orbax`` bitwise, without and with a template.
* Both CLIs on ``tests/examples/example_train_moe.yml`` (constant lr):
  a port ``--checkpoint_format orbax`` run resumed half-way equals the
  npz run resumed there bitwise and the JAX package predicts from it as the
  port does; the port resumes a JAX orbax dir from its Adam state (the
  JAX ``ckpt-N.optstate.orbax``) as the JAX trainer does (losses 1e-5,
  weights 2 lr) and predicts from it as the JAX package does; the
  validation sidecar reads ``ckpt-N.orbax``.
"""

import json
import os
import shutil
import struct
import time

import numpy as np
import pytest
import yaml

jax = pytest.importorskip("jax")
ts = pytest.importorskip("tensorstore")
zstandard = pytest.importorskip("zstandard")

import port_test_support  # noqa: E402,F401  (one torch thread per worker)
from neurst_tpu.tasks.task import build_task as jax_build_task  # noqa: E402
from neurst_tpu.utils import checkpoints as jax_ckpt  # noqa: E402
from neurst_tpu.utils import orbax_checkpoints as jax_orbax  # noqa: E402

from neurst_tpu_torch.cli import run_exp as port_run_exp  # noqa: E402
from neurst_tpu_torch.exps import trainer as port_trainer  # noqa: E402
from neurst_tpu_torch.training import validator as port_validator  # noqa: E402
from neurst_tpu_torch.utils import checkpoints as port_ckpt  # noqa: E402
from neurst_tpu_torch.utils import ocdbt, zstd  # noqa: E402
from neurst_tpu_torch.utils import orbax_checkpoints as port_orbax  # noqa: E402
from neurst_tpu_torch.utils import zarr as port_zarr  # noqa: E402

from port_test_support import (JAX_CLI_SIDE, REPO,  # noqa: E402
                               TrainerLossLog, start_jax_side)

# ------------------------------------------------------------------ zstd


def _payloads(rng):
    out = []
    for n in (0, 1, 7, 300, 5000, 140000):
        out.append(rng.bytes(n))
        out.append((b"abcabcabd" * (n // 9 + 1))[:n])
        out.append(" ".join(str(x) for x in rng.randint(
            0, 60, n // 3 + 1)).encode()[:n])
        out.append((0.02 * rng.randn(n // 4 + 1)).astype(np.float32)
                   .tobytes())
        bits = (0.02 * rng.randn(n // 2 + 1)).astype(np.float32) \
            .view(np.uint32) >> 16
        out.append(bits.astype(np.uint16).tobytes())
    return out


@pytest.mark.parametrize("level", [1, 3, 9, 15, 19, -5])
def test_zstd_decoder_matches_zstandard(level):
    for i, data in enumerate(_payloads(np.random.RandomState(level + 50))):
        for checksum in (True, False):
            frame = zstandard.ZstdCompressor(
                level=level, write_checksum=checksum,
                write_content_size=checksum).compress(data)
            assert zstd.decompress(frame) == data, (i, checksum)


def test_zstd_frames_in_one_buffer_and_skippable_frames():
    a = zstandard.ZstdCompressor(level=3).compress(b"hello " * 100)
    b = zstandard.ZstdCompressor(level=19).compress(bytes(range(256)) * 50)
    skip = struct.pack("<II", 0x184D2A53, 5) + b"12345"
    assert zstd.decompress(a + skip + b) == b"hello " * 100 \
        + bytes(range(256)) * 50
    # a streamed frame without a content size
    c = zstandard.ZstdCompressor(level=5)
    stream = c.compressobj()
    data = np.random.RandomState(1).bytes(300000)
    frame = stream.compress(data) + stream.flush()
    assert zstd.decompress(frame) == data


def test_zstd_rejects_dictionaries_and_corruption():
    samples = [f"sample {i} text text".encode() * 20 for i in range(200)]
    dictionary = zstandard.train_dictionary(1024, samples)
    frame = zstandard.ZstdCompressor(dict_data=dictionary).compress(
        samples[3])
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(frame)
    good = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
        b"checked " * 1000)
    bad = good[:-1] + bytes([good[-1] ^ 1])
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bad)
    with pytest.raises(ValueError):
        zstd.decompress(good[:len(good) // 2])
    with pytest.raises(ValueError, match="not a zstd frame"):
        zstd.decompress(b"plain bytes")


def test_zstd_real_checkpoint_chunks(jax_sharded):
    """Every zstd-compressed value of a JAX-written checkpoint (the zarr
    chunks; TensorStore's nodes are checked by the reads below)."""
    path, _ = jax_sharded
    store = ocdbt.OcdbtReader(path)
    frames = [store.get(k) for k in store.keys()]
    frames = [f for f in frames if f[:4] == b"\x28\xb5\x2f\xfd"]
    assert len(frames) >= 8
    for frame in frames:
        # TensorStore's frames carry no content size: a streaming read
        want = zstandard.ZstdDecompressor().decompressobj().decompress(frame)
        assert zstd.decompress(frame) == want


# ----------------------------------------------------------------- OCDBT


def _ts_store(path, **config):
    spec = {"driver": "ocdbt", "base": f"file://{path}"}
    if config:
        spec["config"] = config
    return ts.KvStore.open(spec).result()


def _ts_items(path):
    kv = _ts_store(path)
    return {k: kv.read(k).result().value for k in kv.list().result()}


STORE_CASES = {
    "one_node": ({"compression": {"id": "zstd"}}, 1, 12),
    "many_nodes": ({"max_decoded_node_bytes": 300,
                    "max_inline_value_bytes": 20,
                    "compression": {"id": "zstd"}}, 1, 60),
    "versions": ({"max_decoded_node_bytes": 400,
                  "max_inline_value_bytes": 30,
                  "version_tree_arity_log2": 2}, 9, 6),
}


@pytest.mark.parametrize("case", list(STORE_CASES))
def test_port_reads_tensorstore_stores(case, tmp_path):
    config, commits, keys = STORE_CASES[case]
    rng = np.random.RandomState(len(case))
    kv = _ts_store(str(tmp_path / "kv"), **config)
    for c in range(commits):
        with ts.Transaction() as txn:
            for i in range(keys):
                kv.with_transaction(txn)[f"k{c:02d}/{i:03d}"] = rng.bytes(
                    int(rng.randint(0, 200)))
    want = _ts_items(str(tmp_path / "kv"))
    got = ocdbt.OcdbtReader(str(tmp_path / "kv"))
    assert got.keys() == sorted(want)
    for key, value in want.items():
        assert got.get(key) == value
    if case != "one_node":
        # a tree of several levels, values stored out of line
        assert got.height > 0
        assert any(r.inline is None for r in got.refs.values())
    if case == "versions":
        assert got.generation > 4
        assert len(os.listdir(tmp_path / "kv" / "d")) > 1


def test_tensorstore_reads_port_stores(tmp_path):
    rng = np.random.RandomState(7)
    items = {f"a{i:03d}/x".encode(): rng.bytes(int(rng.randint(0, 3000)))
             for i in range(60)}
    ocdbt.write_store(str(tmp_path / "one"), items)
    assert _ts_items(str(tmp_path / "one")) == items
    parts = [dict(list(items.items())[i::2]) for i in range(2)]
    for i, part in enumerate(parts):
        ocdbt.write_store(str(tmp_path / "two" / f"ocdbt.process_{i}"),
                          part)
    ocdbt.write_root(str(tmp_path / "two"),
                     ["ocdbt.process_0", "ocdbt.process_1"])
    assert _ts_items(str(tmp_path / "two")) == items
    reader = ocdbt.OcdbtReader(str(tmp_path / "two"))
    assert all(reader.get(k) == v for k, v in items.items())


def test_ocdbt_checks_its_crc(tmp_path):
    ocdbt.write_store(str(tmp_path / "s"), {b"k": b"v" * 10})
    path = tmp_path / "s" / "manifest.ocdbt"
    data = bytearray(path.read_bytes())
    data[20] ^= 0xFF
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="crc32c"):
        ocdbt.OcdbtReader(str(tmp_path / "s"))


# ------------------------------------------------------------------ zarr


def _ts_zarr(path, name, **extra):
    spec = {"driver": "zarr", "kvstore": {
        "driver": "ocdbt", "base": f"file://{path}", "path": f"{name}/"}}
    spec.update(extra)
    return ts.open(spec, **({"create": True} if "metadata" in extra
                            else {})).result()


def test_zarr_both_ways_through_tensorstore(tmp_path):
    rng = np.random.RandomState(3)
    array = rng.randn(7, 10).astype(np.float32)
    ints = rng.randint(-5, 5, (9,)).astype(np.int64)
    path = str(tmp_path / "ts")
    _ts_zarr(path, "a", metadata={
        "shape": [7, 10], "chunks": [3, 4], "dtype": "<f4",
        "compressor": {"id": "zstd", "level": 1}}).write(array).result()
    _ts_zarr(path, "b", metadata={
        "shape": [9], "chunks": [9], "dtype": "<i8",
        "compressor": None}).write(ints).result()
    store = ocdbt.OcdbtReader(path)
    np.testing.assert_array_equal(port_zarr.read_array(store, "a"), array)
    np.testing.assert_array_equal(port_zarr.read_array(store, "b"), ints)
    # the port's chunks (edge chunks padded), read by TensorStore
    items = {"c/.zarray": port_zarr.zarray(array.shape, (4, 6), "<f4")}
    for i in range(2):
        for j in range(2):
            block = array[i * 4:(i + 1) * 4, j * 6:(j + 1) * 6]
            items[f"c/{i}.{j}"] = port_zarr.chunk_bytes(block, (4, 6))
    items.update({"d/.zarray": port_zarr.zarray(ints.shape, ints.shape,
                                                "<i8"),
                  "d/0": port_zarr.chunk_bytes(ints, ints.shape)})
    ocdbt.write_store(str(tmp_path / "port"), items)
    np.testing.assert_array_equal(
        _ts_zarr(str(tmp_path / "port"), "c").read().result(), array)
    np.testing.assert_array_equal(
        _ts_zarr(str(tmp_path / "port"), "d").read().result(), ints)


# ------------------------------------------------- orbax, JAX package


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """A JAX ``save_checkpoint_orbax`` of arrays sharded over the CPU
    devices (as ``tests/parallel/test_orbax_checkpoints.py``), a
    bfloat16 and an int32 array among them."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from neurst_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(model_parallel=2)
    rng = np.random.RandomState(0)

    def put(a, *spec):
        return jax.device_put(a, NamedSharding(mesh, PartitionSpec(*spec)))

    params = {
        "layer": {
            "kernel": put(rng.randn(8, 24).astype(np.float32), "model"),
            "experts": put(rng.randn(8, 6, 4).astype(np.float32), "data"),
            "bias": jax.device_put(np.ones([8], np.float32)),
            "half": put(jnp.asarray(rng.randn(16, 6), jnp.bfloat16),
                        None, "model"),
            "big": put(rng.randn(96, 128).astype(np.float32), "data",
                       "model")},
        "count": jax.device_put(np.int32(7))}
    model_dir = str(tmp_path_factory.mktemp("jax_orbax") / "m")
    path = jax_orbax.save_checkpoint_orbax(model_dir, 10, params)
    flat = {k: np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                          else v)
            for k, v in jax_ckpt.flatten_params(params).items()}
    return path, flat


def test_port_reads_jax_sharded_orbax_bitwise(jax_sharded):
    path, want = jax_sharded
    got = port_ckpt.restore_checkpoint_params(path)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert got[name].dtype == value.dtype, name
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    assert port_ckpt.latest_checkpoint(os.path.dirname(path)) == path
    # the sharded arrays are chunked by shard
    meta = json.loads(ocdbt.OcdbtReader(path).get("layer.big/.zarray"))
    assert meta["chunks"] != meta["shape"]


def test_committed_jax_checkpoint_reads_bitwise():
    """``tests/fixtures/orbax_jax`` (``tests/tools/make_orbax_fixture.py``:
    the JAX package's orbax save, zstd chunks, a bfloat16 array), which
    ``chip_smoke.py`` reads on the card: the port's read equals its
    ``flat.npz`` and the JAX package's own restore."""
    fixture = os.path.join(REPO, "tests", "fixtures", "orbax_jax")
    path = os.path.join(fixture, "ckpt-7.orbax")
    got = port_ckpt.restore_checkpoint_params(path)
    with np.load(os.path.join(fixture, "flat.npz")) as data:
        want = dict(data)
    theirs = jax_ckpt.restore_checkpoint_params(path)
    assert sorted(got) == sorted(want) == sorted(theirs)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
        np.testing.assert_array_equal(
            got[name], np.asarray(theirs[name]).astype(value.dtype))
    assert port_ckpt.latest_checkpoint(fixture) == path


def test_jax_reads_port_orbax_bitwise(tmp_path):
    import jax.numpy as jnp
    import torch
    rng = np.random.RandomState(2)
    half = torch.randn(5, 3).bfloat16()
    tree = {"enc": {"w": rng.randn(4, 3).astype(np.float32), "h": half},
            "step": np.asarray(11, np.int32),
            "wide": rng.randn(300, 70).astype(np.float32)}
    path = port_orbax.save_checkpoint_orbax(str(tmp_path / "m"), 3, tree)
    assert port_orbax.latest_orbax_checkpoint(str(tmp_path / "m")) == path
    for restored in (jax_orbax.restore_checkpoint_orbax(path),
                     jax_orbax.restore_checkpoint_orbax(path, {
                         "enc": {"w": jnp.zeros((4, 3)),
                                 "h": jnp.zeros((5, 3), jnp.bfloat16)},
                         "step": jnp.zeros((), jnp.int32),
                         "wide": jnp.zeros((300, 70))})):
        np.testing.assert_array_equal(np.asarray(restored["wide"]),
                                      tree["wide"])
        np.testing.assert_array_equal(np.asarray(restored["enc"]["w"]),
                                      tree["enc"]["w"])
        assert str(np.asarray(restored["enc"]["h"]).dtype) == "bfloat16"
        np.testing.assert_array_equal(
            np.asarray(restored["enc"]["h"]).astype(np.float32),
            half.float().numpy())
        assert int(np.asarray(restored["step"])) == 11
    # the port reads its own dir back exactly
    back = port_ckpt.restore_checkpoint_params(path)
    np.testing.assert_array_equal(back["enc/h"], half.float().numpy())
    np.testing.assert_array_equal(back["wide"], tree["wide"])


def test_save_checkpoint_orbax_keeps_the_newest(tmp_path):
    tree = {"w": np.ones((2, 2), np.float32)}
    model_dir = str(tmp_path / "m")
    for step in (10, 20, 30):
        port_orbax.save_checkpoint_orbax(model_dir, step, tree,
                                         max_to_keep=2)
        port_ckpt.save_opt_sidecar(os.path.join(
            model_dir, f"ckpt-{step}.orbax"), {"step": np.asarray(step)})
    left = sorted(os.listdir(model_dir))
    assert "ckpt-10.orbax" not in left and "ckpt-30.orbax" in left
    assert port_ckpt.list_checkpoints(model_dir) == [20, 30]
    assert jax_orbax.latest_orbax_checkpoint(model_dir).endswith(
        "ckpt-30.orbax")
    with pytest.raises(KeyError):
        port_orbax.restore_checkpoint_orbax(
            os.path.join(model_dir, "ckpt-30.orbax"), {"v": np.ones(2)})


# ------------------------------------------------------------ both CLIs

STEPS, LR = 4, 1e-3


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("orbax_cli"))
    with open(os.path.join(REPO, "tests", "examples",
                           "example_train_moe.yml")) as f:
        cfg = json.loads(json.dumps(yaml.safe_load(f)).replace(
            '"tests/examples/', f'"{REPO}/tests/examples/'))
    cfg["task.params"]["shuffle_buffer"] = 0
    for side in ("encoder", "decoder"):
        cfg["model.params"][f"{side}.moe_router_jitter"] = 0.0
    params = cfg["entry.params"]
    params.pop("lr_schedule.class")
    params.pop("lr_schedule.params")
    params["optimizer.params"]["learning_rate"] = LR
    params.update(train_steps=STEPS, save_checkpoint_steps=2,
                  summary_steps=1, enable_tensorboard=False)
    cfg["entry.class"] = "trainer"
    cfg_path = os.path.join(root, "moe.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    names = ("port_npz", "port_orbax", "jax_orbax")
    dirs = {n: os.path.join(root, n) for n in names}
    dirs["jax_resumed"] = os.path.join(root, "jax_resumed")
    dirs["port_on_jax"] = os.path.join(root, "port_on_jax")
    train = ["--entry", "train", "--config_paths", cfg_path]
    orbax = ["--checkpoint_format", "orbax"]
    predict_cfg = ["--entry", "predict", "--config_paths", os.path.join(
        REPO, "tests", "examples", "example_predict_seq2seq.yml"),
        "--dataset.params", json.dumps({
            "src_file": f"{REPO}/tests/examples/dev.src",
            "trg_file": f"{REPO}/tests/examples/dev.trg"})]

    def predict(model_dir, out):
        return predict_cfg + ["--model_dir", model_dir, "--output_file",
                              out]

    marks = {n: os.path.join(root, n + ".done")
             for n in ("seeded", "jax", "port")}
    out = {"root": root, "dirs": dirs}
    jax_restored = os.path.join(root, "jax_restored.npz")
    proc, log_path = start_jax_side(JAX_CLI_SIDE, root, "jax_side", [
        ["wait", marks["seeded"], None],
        ["train", train + orbax + ["--model_dir", dirs["jax_orbax"]],
         os.path.join(root, "jax_train.json")],
        ["exec", f"import shutil; shutil.copytree("
                 f"{dirs['jax_orbax']!r}, {dirs['jax_resumed']!r}); "
                 f"open({marks['jax']!r}, 'w').close()", None],
        ["train", train + orbax + ["--model_dir", dirs["jax_resumed"],
                                   "--train_steps", str(STEPS + 2)],
         os.path.join(root, "jax_resume.json")],
        ["predict", predict(dirs["jax_orbax"], os.path.join(
            root, "hyp.jax_on_jax")), os.path.join(root, "jax_pj.json")],
        ["wait", marks["port"], None],
        ["predict", predict(dirs["port_orbax"], os.path.join(
            root, "hyp.jax_on_port")), os.path.join(root, "jax_pp.json")],
        ["exec", "import numpy as np; "
                 "from neurst_tpu.utils.checkpoints import "
                 "restore_checkpoint_params as r; "
                 f"np.savez({jax_restored!r}, **{{k: np.asarray(v) for k, v "
                 f"in r({dirs['port_orbax']!r} + '/ckpt-{STEPS}.orbax')"
                 f".items()}})", None]])
    try:
        jtask = jax_build_task(cfg)
        jmodel = jtask.build_model({"model.class": cfg["model.class"],
                                    "model.params": cfg["model.params"]})
        seed_dir = os.path.join(root, "seed")
        jax_ckpt.save_checkpoint(seed_dir, 0, jax.tree_util.tree_map(
            np.asarray, jax.jit(jmodel.init_params)(jax.random.PRNGKey(1))))
        for n in names:
            shutil.copytree(seed_dir, dirs[n])
        open(marks["seeded"], "w").close()

        def port_train(argv):
            log = TrainerLossLog()
            saved, port_trainer.logging = port_trainer.logging, log
            try:
                port_run_exp.cli_main(train + argv + ["--device", "cpu"])
            finally:
                port_trainer.logging = saved
            return log.losses

        # both formats: 2 steps, then a resume to 4 (a resumed run reads
        # its data from the start again)
        out["npz_losses"] = port_train(["--model_dir", dirs["port_npz"],
                                        "--train_steps", "2"])
        out["npz_losses"] += port_train(["--model_dir", dirs["port_npz"]])
        out["orbax_losses"] = port_train(
            orbax + ["--model_dir", dirs["port_orbax"], "--train_steps",
                     "2"])
        out["orbax_losses"] += port_train(
            orbax + ["--model_dir", dirs["port_orbax"]])
        out["port_on_port"] = port_run_exp.cli_main(predict(
            dirs["port_orbax"], os.path.join(root, "hyp.port_on_port"))
            + ["--device", "cpu"])["hypotheses"]
        open(marks["port"], "w").close()
        seen = []
        record = port_validator.TrainingStatusRecorder.record

        def spy(self, step, value, params=None):
            seen.append((step, value))
            return record(self, step, value, params)

        port_validator.TrainingStatusRecorder.record = spy
        try:
            port_run_exp.cli_main([
                "--entry", "validation", "--model_dir", dirs["port_orbax"],
                "--config_paths", cfg_path, "--validator.class",
                "criterion_validator", "--validator.params", json.dumps({
                    "eval_dataset.class": "parallel_text",
                    "eval_dataset.params": {
                        "src_file": f"{REPO}/tests/examples/dev.src",
                        "trg_file": f"{REPO}/tests/examples/dev.trg"}}),
                "--waiting_interval", "1", "--maximum_waiting_time", "1",
                "--device", "cpu"])
        finally:
            port_validator.TrainingStatusRecorder.record = record
        out["validated"] = seen
        deadline = time.monotonic() + 420
        while not os.path.exists(marks["jax"]):
            assert proc.poll() is None, open(log_path).read()[-4000:]
            assert time.monotonic() < deadline, "JAX side timed out"
            time.sleep(0.2)
        shutil.copytree(dirs["jax_orbax"], dirs["port_on_jax"])
        out["port_resume"] = port_train(
            orbax + ["--model_dir", dirs["port_on_jax"], "--train_steps",
                     str(STEPS + 2)])
        out["port_on_jax"] = port_run_exp.cli_main(predict(
            dirs["jax_orbax"], os.path.join(root, "hyp.port_on_jax"))
            + ["--device", "cpu"])["hypotheses"]
        proc.wait(timeout=420)
    finally:
        proc.kill()
    with open(log_path) as f:
        assert proc.returncode == 0, f.read()[-4000:]
    for name in ("jax_train", "jax_resume", "jax_pj", "jax_pp"):
        with open(os.path.join(root, f"{name}.json")) as f:
            out[name] = json.load(f)
    with np.load(jax_restored) as data:
        out["jax_restored"] = dict(data)
    return out


def test_orbax_resume_equals_the_npz_resume(cli):
    d = cli["dirs"]
    assert cli["orbax_losses"] == cli["npz_losses"]
    ours = port_ckpt.restore_checkpoint_params(
        os.path.join(d["port_orbax"], f"ckpt-{STEPS}.orbax"))
    want = port_ckpt.restore_checkpoint_params(
        os.path.join(d["port_npz"], f"ckpt-{STEPS}.npz"))
    assert sorted(ours) == sorted(want)
    for name, value in want.items():
        np.testing.assert_array_equal(ours[name], value, err_msg=name)
    files = sorted(os.listdir(d["port_orbax"]))
    assert {"ckpt-2.orbax", f"ckpt-{STEPS}.orbax",
            f"ckpt-{STEPS}.torch_optstate.npz", "checkpoint.json",
            "model_configs.yml"} <= set(files)
    assert not any(f.endswith(".npz") and f.startswith("ckpt-")
                   and "optstate" not in f and f != "ckpt-0.npz"
                   for f in files)


def test_jax_reads_the_port_orbax_dir_bitwise(cli):
    ours = port_ckpt.restore_checkpoint_params(os.path.join(
        cli["dirs"]["port_orbax"], f"ckpt-{STEPS}.orbax"))
    theirs = cli["jax_restored"]
    assert sorted(ours) == sorted(theirs)
    for name, value in ours.items():
        np.testing.assert_array_equal(theirs[name], value, err_msg=name)


def test_jax_predicts_from_the_port_orbax_dir(cli):
    assert cli["jax_pp"]["hypotheses"] == cli["port_on_port"]
    assert len(cli["port_on_port"]) == 24


def test_port_resumes_a_jax_orbax_dir_from_its_adam_state(cli):
    """From JAX's ckpt-4.orbax and ckpt-4.optstate.orbax (constant lr, so
    no R6): the port's steps 5-6 and weights are the JAX trainer's own
    resume."""
    assert len(cli["port_resume"]) == len(cli["jax_resume"]) == 2
    np.testing.assert_allclose(cli["port_resume"], cli["jax_resume"],
                               rtol=1e-5)
    step = STEPS + 2
    ours = port_ckpt.restore_checkpoint_params(os.path.join(
        cli["dirs"]["port_on_jax"], f"ckpt-{step}.orbax"))
    want = port_ckpt.restore_checkpoint_params(os.path.join(
        cli["dirs"]["jax_resumed"], f"ckpt-{step}.orbax"))
    assert sorted(ours) == sorted(want)
    for name, value in want.items():
        assert float(np.abs(ours[name] - value).max()) <= 2 * LR, name


def test_port_predicts_from_a_jax_orbax_dir(cli):
    assert cli["port_on_jax"] == cli["jax_pj"]["hypotheses"]


def test_validation_sidecar_reads_orbax_checkpoints(cli):
    steps = [s for s, _ in cli["validated"]]
    assert steps == [0, 2, STEPS]
    assert all(np.isfinite(v) for _, v in cli["validated"])
