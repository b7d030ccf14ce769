"""The port's audio input against the JAX package's, on the CPU: the WAV,
SPHERE, FLAC and mp3 decoders (bitwise on the same bytes, and the same
errors), the numpy fbank and its extractor (max abs <= 1e-6, CMVN on and
off), ``device_logfbank`` against JAX's and against the host features
(< 2e-3, the bound of ``tests/data/test_device_fbank.py``; frame lengths
equal; padding exactly 0), the FLAC host library's build failure, and the
CLIs' small helpers.
"""

import importlib.util
import io
import os
import shutil
import struct
import wave

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import chip_smoke  # noqa: E402
from neurst_tpu.data.audio import log_mel_fbank as jax_fbank  # noqa: E402
from neurst_tpu.data.audio import mp3_io as jax_mp3  # noqa: E402
from neurst_tpu.data.audio import sph_io as jax_sph  # noqa: E402
from neurst_tpu.data.audio import wav_io as jax_wav  # noqa: E402
from neurst_tpu.data.audio.feature_extractor import \
    build_feature_extractor as jax_build_fe  # noqa: E402
from neurst_tpu.ops import device_fbank as jax_device  # noqa: E402
from neurst_tpu.utils import misc as jax_misc  # noqa: E402
from neurst_tpu_torch.data.audio import flac_io  # noqa: E402
from neurst_tpu_torch.data.audio import log_mel_fbank  # noqa: E402
from neurst_tpu_torch.data.audio import mp3_io, sph_io, wav_io  # noqa: E402
from neurst_tpu_torch.data.audio.feature_extractor import \
    build_feature_extractor  # noqa: E402
from neurst_tpu_torch.ops import _build  # noqa: E402
from neurst_tpu_torch.ops.device_fbank import (device_logfbank,  # noqa: E402
                                               num_frames)
from neurst_tpu_torch.utils import misc  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FBANK_TOL = 2e-3


def _load_flac_fixtures():
    """The FLAC encoder of ``tests/data/test_flac.py`` (verbatim, fixed
    order 2, LPC order 1, left/side stereo)."""
    spec = importlib.util.spec_from_file_location(
        "flac_fixtures", os.path.join(REPO, "tests", "data", "test_flac.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


FLAC = _load_flac_fixtures()


def _same(port, ref):
    """Both decoders' (waveform, rate), bitwise."""
    assert port[1] == ref[1]
    assert port[0].dtype == ref[0].dtype == np.float32
    np.testing.assert_array_equal(port[0], ref[0])


def _both(fn_port, fn_jax, data, *args):
    """The two decoders on the same bytes: equal results, or the same
    error type."""
    try:
        ref = fn_jax(data, *args)
    except Exception as e:  # noqa: BLE001 - compared below
        with pytest.raises(type(e)):
            fn_port(data, *args)
        return None
    port = fn_port(data, *args)
    _same(port, ref)
    return port


# ------------------------------------------------------------------ WAV


def _stdlib_wav(samples, width, channels=1, rate=16000):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(samples.tobytes())
    return buf.getvalue()


def _riff(fmt_tag, channels, bits, payload, rate=16000, extensible_sub=None):
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", fmt_tag, channels, rate, rate * block,
                      block, bits)
    if extensible_sub is not None:
        fmt += struct.pack("<HHI", 22, bits, 3) + struct.pack(
            "<H", extensible_sub) + b"\x00\x00\x00\x00\x10\x00\x80\x00" \
            b"\x00\xaa\x00\x38\x9b\x71"
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt \
        + b"data" + struct.pack("<I", len(payload)) + payload
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _wav_case(kind):
    rng = np.random.RandomState(sum(map(ord, kind)))
    if kind == "pcm8":
        return _stdlib_wav(rng.randint(0, 256, 300).astype(np.uint8), 1)
    if kind == "pcm16":
        return _stdlib_wav(rng.randint(-32768, 32768, 300).astype("<i2"), 2)
    if kind == "pcm16_stereo":
        return _stdlib_wav(rng.randint(-32768, 32768, 600).astype("<i2"), 2,
                           channels=2)
    if kind == "pcm24":
        v = rng.randint(-(1 << 23), 1 << 23, 300).astype("<i4")
        raw = v.view(np.uint8).reshape(-1, 4)[:, :3].copy()
        return _stdlib_wav(raw, 3)
    if kind == "pcm32":
        return _stdlib_wav(rng.randint(-(1 << 31), (1 << 31) - 1, 300,
                                       dtype=np.int64).astype("<i4"), 4)
    if kind == "float32":
        return _riff(3, 1, 32, (rng.randn(300) * 0.3).astype("<f4").tobytes())
    if kind == "float32_stereo":
        return _riff(3, 2, 32, (rng.randn(600) * 0.3).astype("<f4").tobytes())
    if kind == "extensible_pcm16":
        return _riff(0xFFFE, 1, 16, rng.randint(-32768, 32768, 300).astype(
            "<i2").tobytes(), extensible_sub=1)
    if kind == "extensible_float32":
        return _riff(0xFFFE, 1, 32, (rng.randn(300) * 0.3).astype(
            "<f4").tobytes(), extensible_sub=3)
    if kind == "not_riff":
        return b"RIFX" + b"\0" * 40
    raise ValueError(kind)


@pytest.mark.parametrize("kind", [
    "pcm8", "pcm16", "pcm16_stereo", "pcm24", "pcm32", "float32",
    "float32_stereo", "extensible_pcm16", "extensible_float32", "not_riff"])
def test_wav_decoders_match(kind):
    data = _wav_case(kind)
    out = _both(wav_io.decode_wav, jax_wav.decode_wav, data)
    if kind in ("pcm16", "pcm24", "float32", "extensible_pcm16"):
        assert out is not None and len(out[0]) == 300
    _both(wav_io.decode_audio, jax_wav.decode_audio, data, "wav")


def test_decode_audio_unknown_format_raises_alike():
    for decode in (wav_io.decode_audio, jax_wav.decode_audio):
        with pytest.raises(NotImplementedError):
            decode(b"\0" * 16, "ogg")


# ----------------------------------------------------------------- SPH


def _sph(payload, **fields):
    lines = ["NIST_1A", "   1024"]
    for k, v in fields.items():
        if isinstance(v, int):
            lines.append(f"{k} -i {v}")
        else:
            lines.append(f"{k} -s{len(str(v))} {v}")
    header = ("\n".join(lines + ["end_head"])).encode("ascii")
    return header + b"\0" * (1024 - len(header)) + payload


def _sph_case(kind):
    rng = np.random.RandomState(len(kind))
    pcm = rng.randint(-32768, 32768, 400).astype(np.int16)
    if kind == "pcm16_le":
        return _sph(pcm.astype("<i2").tobytes(), sample_rate=16000,
                    channel_count=1, sample_n_bytes=2,
                    sample_byte_format="01", sample_count=400,
                    sample_coding="pcm")
    if kind == "pcm16_be":
        return _sph(pcm.astype(">i2").tobytes(), sample_rate=8000,
                    channel_count=1, sample_n_bytes=2,
                    sample_byte_format="10", sample_count=400,
                    sample_coding="pcm")
    if kind == "stereo":
        return _sph(pcm.astype("<i2").tobytes(), sample_rate=16000,
                    channel_count=2, sample_n_bytes=2,
                    sample_byte_format="01", sample_count=200)
    if kind == "pcm8":
        return _sph(pcm.astype(np.int8).tobytes(), sample_rate=16000,
                    channel_count=1, sample_n_bytes=1, sample_coding="pcm")
    if kind in ("ulaw", "alaw"):
        return _sph(np.arange(256, dtype=np.uint8).tobytes(),
                    sample_rate=8000, channel_count=1, sample_n_bytes=1,
                    sample_coding=kind)
    if kind == "shorten":
        return _sph(b"\0" * 64, sample_rate=16000, channel_count=1,
                    sample_n_bytes=2,
                    sample_coding="pcm,embedded-shorten-v2.00")
    if kind == "no_magic":
        return b"NOTSPH" + b"\0" * 2000
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["pcm16_le", "pcm16_be", "stereo", "pcm8",
                                  "ulaw", "alaw", "shorten", "no_magic"])
def test_sph_decoders_match(kind):
    data = _sph_case(kind)
    out = _both(sph_io.decode_sph, jax_sph.decode_sph, data)
    if kind == "shorten":
        with pytest.raises(NotImplementedError, match="shorten"):
            sph_io.decode_sph(data)
    elif kind != "no_magic":
        assert out is not None and len(out[0]) > 0
    _both(wav_io.decode_audio, jax_wav.decode_audio, data, "sph")


def test_g711_tables_match():
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(sph_io.ulaw_to_linear(codes),
                                  jax_sph.ulaw_to_linear(codes))
    np.testing.assert_array_equal(sph_io.alaw_to_linear(codes),
                                  jax_sph.alaw_to_linear(codes))
    assert sph_io.ulaw_to_linear(np.uint8(0xFF)) == 0
    assert sph_io.alaw_to_linear(np.uint8(0xD5)) == 8


# ---------------------------------------------------------------- FLAC


@pytest.fixture(scope="module")
def jax_flac():
    from neurst_tpu.data.audio import flac_io as jax_flac_io
    if not jax_flac_io.flac_available():
        pytest.skip("the JAX package's flac decoder could not be built")
    return jax_flac_io


def _lpc_stream():
    t = np.arange(64)
    samples = (200 * np.cos(t / 7.0)).astype(np.int64)
    b = FLAC.BitWriter()
    FLAC._frame_header(b, len(samples), 0, 4)
    FLAC._lpc1_subframe(b, samples, 16)
    b.align()
    b.write(0, 16)
    return (b"fLaC" + FLAC._streaminfo(16000, 1, 16, len(samples))
            + bytes(b.bytes)), samples


def _flac_case(kind):
    rng = np.random.RandomState(len(kind))
    if kind == "verbatim":
        s = rng.randint(-3000, 3000, size=64).astype(np.int64)
        return FLAC._encode([(s, "verbatim")]), s
    if kind == "fixed2":
        s = (100 * np.sin(np.arange(64) / 5.0)).astype(np.int64)
        return FLAC._encode([(s, "fixed2")]), s
    if kind == "lpc":
        return _lpc_stream()
    if kind == "multi_frame":
        f1 = rng.randint(-500, 500, size=32).astype(np.int64)
        f2 = rng.randint(-500, 500, size=48).astype(np.int64)
        return FLAC._encode([(f1, "verbatim"), (f2, "verbatim")]), \
            np.concatenate([f1, f2])
    if kind == "left_side_stereo":
        left = rng.randint(-2000, 2000, size=32).astype(np.int64)
        right = rng.randint(-2000, 2000, size=32).astype(np.int64)
        return FLAC._encode([((left, left - right), "verbatim")],
                            channels=2), None
    if kind == "chip_smoke_encoder":
        pcm = chip_smoke._talk_pcm(rng, 9000, 16000)
        return chip_smoke.flac_encode(pcm, 16000, 4096), pcm
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["verbatim", "fixed2", "lpc", "multi_frame",
                                  "left_side_stereo", "chip_smoke_encoder"])
def test_flac_decoders_match(kind, jax_flac):
    data, pcm = _flac_case(kind)
    out = _both(flac_io.decode_flac, jax_flac.decode_flac, data)
    if pcm is not None:
        np.testing.assert_array_equal(out[0], pcm.astype(np.float32))
    _both(wav_io.decode_audio, jax_wav.decode_audio, data, "flac")


@pytest.mark.parametrize("data", [b"fLaC" + b"\x00" * 10,
                                  b"not a flac file"])
def test_flac_corrupt_stream_raises_alike(data, jax_flac):
    for decode in (flac_io.decode_flac, jax_flac.decode_flac):
        with pytest.raises(ValueError):
            decode(data)


def test_flac_build_failure_raises(tmp_path, monkeypatch):
    """A failed build of ``csrc/flac_decoder.cpp`` raises: no fallback
    (the JAX module reports ``flac_available() == False`` instead)."""
    flac_io.flac_available()   # build it in the real directory first
    copy = tmp_path / "torch_kernels"
    shutil.copytree(_build.BUILD_DIR, copy,
                    ignore=shutil.ignore_patterns("*.tmp"))
    for lib in copy.glob("libflac_decoder-*"):
        lib.unlink()
    monkeypatch.setattr(_build, "BUILD_DIR", copy)
    monkeypatch.setenv("CXX", "false")
    monkeypatch.delitem(_build._loaded, "flac_decoder", raising=False)
    flac_io._native.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="flac_decoder"):
            flac_io.decode_flac(_flac_case("verbatim")[0])
        with pytest.raises(RuntimeError):
            flac_io.flac_available()
        assert not list(copy.glob("libflac_decoder-*.so"))
    finally:
        flac_io._native.cache_clear()
        _build._loaded.pop("flac_decoder", None)


# ----------------------------------------------------------------- mp3


def test_mp3_gated_alike():
    """Without a backend both packages raise NotImplementedError naming
    the remedies (ffmpeg first); with one, both decode the same mp3 to
    the same waveform."""
    assert mp3_io.available_backend() == jax_mp3.available_backend()
    if mp3_io.available_backend() is None:
        for decode in (wav_io.decode_audio, jax_wav.decode_audio):
            with pytest.raises(NotImplementedError, match="ffmpeg"):
                decode(b"\xff\xfb\x90\x00" + b"\0" * 100, "mp3")
        return
    sample = None
    if mp3_io.available_backend() == "pygame":
        import pygame
        sample = os.path.join(os.path.dirname(pygame.__file__), "examples",
                              "data", "house_lo.mp3")
    if sample is None or not os.path.exists(sample):
        pytest.skip(f"no mp3 sample for backend "
                    f"{mp3_io.available_backend()}")
    with open(sample, "rb") as f:
        data = f.read()
    out = _both(wav_io.decode_audio, jax_wav.decode_audio, data, "mp3")
    assert out is not None and len(out[0]) > 1000
    assert mp3_io._frame_header_info(data) == jax_mp3._frame_header_info(data)


# --------------------------------------------------------- fbank (host)


def _signal(seed, n, scale=1000.0):
    return (np.random.RandomState(seed).randn(n) * scale).astype(np.float32)


@pytest.mark.parametrize("n", [200, 400, 401, 16000, 12345])
def test_numpy_fbank_functions_match(n):
    w = _signal(n, n)
    for name in ("hz2mel", "mel2hz"):
        x = np.linspace(0, 8000, 33)
        assert np.max(np.abs(getattr(log_mel_fbank, name)(x)
                             - getattr(jax_fbank, name)(x))) <= 1e-6
    for nfilt in (20, 80):
        assert np.max(np.abs(
            log_mel_fbank.get_filterbanks(nfilt, 512, 16000)
            - jax_fbank.get_filterbanks(nfilt, 512, 16000))) <= 1e-6
    pre = log_mel_fbank.preemphasis(w.astype(np.float64))
    assert np.max(np.abs(pre - jax_fbank.preemphasis(
        w.astype(np.float64)))) <= 1e-6
    frames = log_mel_fbank.framesig(pre, 400, 160)
    np.testing.assert_array_equal(frames, jax_fbank.framesig(pre, 400, 160))
    assert np.max(np.abs(log_mel_fbank.powspec(frames, 512)
                         - jax_fbank.powspec(frames, 512))) <= 1e-6
    for nfilt in (20, 80):
        got = log_mel_fbank.logfbank(w, nfilt=nfilt)
        assert got.shape == (num_frames(n), nfilt)
        assert np.max(np.abs(got - jax_fbank.logfbank(w, nfilt=nfilt))) \
            <= 1e-6


@pytest.mark.parametrize("params", [{}, {"nfilt": 40},
                                    {"nfilt": 80, "per_utt_cmvn": False},
                                    {"nfilt": 20, "winlen": 0.02,
                                     "winstep": 0.015, "nfft": 1024}])
@pytest.mark.parametrize("name", ["fbank", "log_mel_fbank"])
def test_fbank_extractor_matches(name, params):
    args = {"feature_extractor.class": name,
            "feature_extractor.params": params}
    port, ref = build_feature_extractor(args), jax_build_fe(args)
    assert type(port).__name__ == type(ref).__name__ == "LogMelFbank"
    assert port.feature_dim == ref.feature_dim
    for n in (1, 400, 401, 16000):
        assert port.seq_len_fn(n) == ref.seq_len_fn(n)
    for seed, n in ((0, 16000), (1, 7777)):
        w = _signal(seed, n)
        got, want = port(w, 16000), ref(w, 16000)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (port.seq_len_fn(n),
                                           port.feature_dim)
        assert np.max(np.abs(got - want)) <= 1e-6


def test_float_identity_extractor_matches():
    args = {"feature_extractor.class": "float_identity"}
    port, ref = build_feature_extractor(args), jax_build_fe(args)
    w = _signal(3, 99)
    np.testing.assert_array_equal(port(w, 16000), ref(w, 16000))
    assert port.feature_dim == ref.feature_dim == 1
    assert port.seq_len_fn(99) == ref.seq_len_fn(99) == 99


# ------------------------------------------------------- device fbank


def _batch(lens, seed=0):
    rng = np.random.RandomState(seed)
    batch = np.zeros([len(lens), max(lens)], np.float32)
    wavs = []
    for i, n in enumerate(lens):
        wavs.append((rng.randn(n) * 1000).astype(np.float32))
        batch[i, :n] = wavs[-1]
    return batch, wavs


def _empty_channels(nfilt):
    fb = log_mel_fbank.get_filterbanks(nfilt, 512, 16000)
    return np.nonzero(fb.sum(axis=1) == 0)[0]


@pytest.mark.parametrize("cmvn", [True, False])
def test_device_logfbank_matches_jax(cmvn):
    lens = [16000, 12345, 300, 400, 401]
    batch, _ = _batch(lens)
    feat, fl = device_logfbank(torch.from_numpy(batch), torch.tensor(lens),
                               nfilt=20, cmvn=cmvn)
    jf, jfl = jax_device.device_logfbank(
        jax.numpy.asarray(batch), jax.numpy.asarray(lens), nfilt=20,
        cmvn=cmvn)
    assert feat.dtype == torch.float32 and fl.dtype == torch.int32
    np.testing.assert_array_equal(fl.numpy(), np.asarray(jfl))
    assert feat.shape == np.asarray(jf).shape == (5, num_frames(16000), 20)
    assert np.max(np.abs(feat.numpy() - np.asarray(jf))) < FBANK_TOL
    for i, n in enumerate(lens):
        assert int(fl[i]) == num_frames(n) == jax_device.num_frames(n)
        assert bool((feat[i, int(fl[i]):] == 0).all())


@pytest.mark.parametrize("nfilt", [20, 80])
def test_device_logfbank_matches_host(nfilt):
    """Against the host extractor at the recipe's nfilt too.  At nfilt
    80 channel 2 has no FFT bin: the host's CMVN gives it its float64
    mean's rounding error over the 1e-10 floor (one value an utterance),
    the port 0; the bound holds on the other channels."""
    lens = [16000, 12345, 300, 400, 401]
    batch, wavs = _batch(lens, seed=nfilt)
    feat, fl = device_logfbank(torch.from_numpy(batch), torch.tensor(lens),
                               nfilt=nfilt)
    empty = _empty_channels(nfilt)
    full = np.setdiff1d(np.arange(nfilt), empty)
    assert list(empty) == ([2] if nfilt == 80 else [])
    extractor = log_mel_fbank.LogMelFbank({"nfilt": nfilt})
    for i, w in enumerate(wavs):
        host = extractor(w, 16000)
        got = feat[i, :int(fl[i])].numpy()
        assert int(fl[i]) == host.shape[0]
        assert np.max(np.abs(got[:, full] - host[:, full])) < FBANK_TOL
        assert (got[:, empty] == 0).all()
        assert (host[:, empty] == host[:1, empty]).all()
        assert bool((feat[i, int(fl[i]):] == 0).all())


def test_device_logfbank_without_cmvn_matches_logfbank():
    w = _signal(1, 8000, 500.0)
    feat, fl = device_logfbank(torch.from_numpy(w[None, :]), nfilt=20,
                               cmvn=False)
    host = log_mel_fbank.logfbank(w, nfilt=20)
    assert int(fl[0]) == host.shape[0]
    assert np.max(np.abs(feat[0].numpy() - host)) < FBANK_TOL


def test_jax_device_logfbank_misses_the_empty_channel():
    """R8: the JAX op's float32 CMVN of the empty channel 2 at nfilt 80
    amplifies its mean's rounding error to up to ~1 where the host gives
    ~0 and the port exactly 0; elsewhere both hold the bound."""
    lens = [16000, 12345]
    batch, wavs = _batch(lens)
    jf = np.asarray(jax_device.device_logfbank(
        jax.numpy.asarray(batch), jax.numpy.asarray(lens), nfilt=80)[0])
    feat = device_logfbank(torch.from_numpy(batch), torch.tensor(lens),
                           nfilt=80)[0].numpy()
    host = log_mel_fbank.LogMelFbank({"nfilt": 80})(wavs[0], 16000)
    frames = host.shape[0]
    assert np.max(np.abs(jf[0, :frames, 2] - host[:, 2])) > FBANK_TOL
    assert np.max(np.abs(feat[0, :frames, 2] - host[:, 2])) < FBANK_TOL
    full = np.setdiff1d(np.arange(80), [2])
    assert np.max(np.abs(jf[0, :frames][:, full] - host[:, full])) \
        < FBANK_TOL


# ------------------------------------------------------------- misc


def test_misc_helpers_match():
    tree = {"a": np.float32(1.5), "b": [np.arange(3), np.array(7)],
            "c": (np.int64(2), "x")}
    got = misc.to_numpy_or_python_type(tree)
    want = jax_misc.to_numpy_or_python_type(tree)
    assert got["a"] == want["a"] == 1.5
    np.testing.assert_array_equal(got["b"][0], want["b"][0])
    assert got["b"][1] == want["b"][1] == 7
    assert got["c"] == want["c"] == (2, "x")
    assert misc.to_numpy_or_python_type(torch.tensor(3.0)) == 3.0
    np.testing.assert_array_equal(
        misc.to_numpy_or_python_type({"t": torch.arange(4)})["t"],
        np.arange(4))
    assert misc.flatten_string_list("a,b") == \
        jax_misc.flatten_string_list("a,b")
    with misc.PseudoPool(4) as pool:
        assert pool.map(abs, [-1, 2]) == [1, 2]
        assert list(pool.imap(abs, [-3])) == [3]
    with misc.Timer() as timer:
        pass
    assert timer.elapsed >= 0.0
