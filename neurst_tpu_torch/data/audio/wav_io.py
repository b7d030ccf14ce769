"""Waveform decoding without external audio libraries (the port's copy of
``neurst_tpu/data/audio/wav_io.py``).

WAV (PCM 8/16/24/32-bit, IEEE float and WAVE_FORMAT_EXTENSIBLE) decodes
here, FLAC in the host library of ``flac_io``, NIST SPHERE in ``sph_io``;
mp3 probes host backends (``mp3_io``) and raises with the remedies when
none exists.
"""

import io
import struct
import wave
from typing import Tuple

import numpy as np

__all__ = ["decode_wav", "decode_audio"]


def decode_wav(data: bytes) -> Tuple[np.ndarray, int]:
    """bytes -> (float32 waveform in int16 scale, sample_rate).

    The waveform keeps the int16 value range (not [-1, 1]) to match
    python_speech_features-era pipelines; CMVN downstream makes the
    scale irrelevant, but log offsets stay comparable.
    """
    bio = io.BytesIO(data)
    try:
        with wave.open(bio, "rb") as w:
            rate = w.getframerate()
            sampwidth = w.getsampwidth()
            channels = w.getnchannels()
            frames = w.readframes(w.getnframes())
    except wave.Error:
        return _decode_wav_extensible(data)
    if sampwidth == 2:
        arr = np.frombuffer(frames, dtype="<i2").astype(np.float32)
    elif sampwidth == 1:
        arr = (np.frombuffer(frames, dtype=np.uint8).astype(np.float32)
               - 128.0) * 256.0
    elif sampwidth == 4:
        arr = np.frombuffer(frames, dtype="<i4").astype(np.float32) / 65536.0
    elif sampwidth == 3:
        raw = np.frombuffer(frames, dtype=np.uint8).reshape(-1, 3)
        arr = ((raw[:, 0].astype(np.int32))
               | (raw[:, 1].astype(np.int32) << 8)
               | (raw[:, 2].astype(np.int32) << 16))
        arr = np.where(arr >= 1 << 23, arr - (1 << 24), arr)
        arr = arr.astype(np.float32) / 256.0
    else:
        raise ValueError(f"Unsupported WAV sample width: {sampwidth}")
    if channels > 1:
        arr = arr.reshape(-1, channels).mean(axis=1)
    return arr, rate


def _decode_wav_extensible(data: bytes) -> Tuple[np.ndarray, int]:
    """Minimal RIFF parser for float-PCM / extensible wavs the stdlib
    refuses."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("Not a RIFF/WAVE file")
    pos = 12
    fmt = None
    payload = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        body = data[pos + 8:pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            payload = body
        pos += 8 + size + (size & 1)
    if fmt is None or payload is None:
        raise ValueError("Missing fmt/data chunk")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format == 3 and bits == 32:  # IEEE float
        arr = np.frombuffer(payload, dtype="<f4").astype(np.float32) \
            * 32768.0
    elif audio_format == 1 and bits == 16:
        arr = np.frombuffer(payload, dtype="<i2").astype(np.float32)
    else:
        raise ValueError(
            f"Unsupported WAV format={audio_format} bits={bits}")
    if channels > 1:
        arr = arr.reshape(-1, channels).mean(axis=1)
    return arr, rate


def decode_audio(data: bytes, fmt: str) -> Tuple[np.ndarray, int]:
    fmt = fmt.lower().lstrip(".")
    if fmt in ("wav", "wave"):
        return decode_wav(data)
    if fmt == "flac":
        from neurst_tpu_torch.data.audio.flac_io import decode_flac
        return decode_flac(data)
    if fmt in ("sph", "sphere", "nist"):
        from neurst_tpu_torch.data.audio.sph_io import decode_sph
        return decode_sph(data)
    if fmt == "mp3":
        from neurst_tpu_torch.data.audio.mp3_io import decode_mp3
        return decode_mp3(data)
    raise NotImplementedError(
        f"No decoder for '{fmt}' in this environment "
        f"(wav/flac/sph native; mp3 via ffmpeg/torchaudio when present).")
