"""NIST SPHERE (.sph) decoding (the port's copy of
``neurst_tpu/data/audio/sph_io.py``).

TED-LIUM ships 16 kHz 16-bit PCM SPHERE files: an ASCII key-value header
("NIST_1A" magic and the declared header size) followed by raw samples.
Codings: linear PCM (8/16-bit, either byte order), G.711 mu-law and
A-law.  Shorten-compressed payloads ("embedded-shorten") raise.
"""

from typing import Tuple

import numpy as np

__all__ = ["decode_sph", "ulaw_to_linear", "alaw_to_linear"]


def _build_ulaw_table() -> np.ndarray:
    # G.711 mu-law expansion (bias 0x84, idle code 0xFF -> 0)
    u = ~np.arange(256) & 0xFF
    sign = (u & 0x80) != 0
    exponent = (u >> 4) & 0x07
    mantissa = u & 0x0F
    sample = (((mantissa << 3) + 0x84) << exponent) - 0x84
    return np.where(sign, -sample, sample).astype(np.int16)


def _build_alaw_table() -> np.ndarray:
    # G.711 A-law expansion (XOR 0x55; sign bit set = positive;
    # idle code 0xD5 -> +8)
    a = np.arange(256) ^ 0x55
    sign = (a & 0x80) != 0
    exponent = (a >> 4) & 0x07
    mantissa = a & 0x0F
    sample = np.where(exponent == 0,
                      (mantissa << 4) + 8,
                      ((mantissa << 4) + 0x108) << np.maximum(
                          exponent - 1, 0))
    return np.where(sign, sample, -sample).astype(np.int16)


_ULAW = _build_ulaw_table()
_ALAW = _build_alaw_table()


def ulaw_to_linear(data: np.ndarray) -> np.ndarray:
    return _ULAW[np.asarray(data, np.uint8)]


def alaw_to_linear(data: np.ndarray) -> np.ndarray:
    return _ALAW[np.asarray(data, np.uint8)]


def _parse_header(data: bytes) -> Tuple[dict, int]:
    if data[:7] != b"NIST_1A":
        raise ValueError("Not a NIST SPHERE file (missing NIST_1A magic)")
    # line 2 is the total header size in bytes, right-justified ASCII
    try:
        header_size = int(data[8:16].split()[0])
    except (ValueError, IndexError):
        raise ValueError("Malformed SPHERE header size")
    fields = {}
    for line in data[16:header_size].decode("ascii", "replace").split("\n"):
        line = line.strip()
        if not line or line.startswith(";"):
            continue
        if line == "end_head":
            break
        parts = line.split(None, 2)
        if len(parts) != 3:
            continue
        key, tp, value = parts
        if tp.startswith("-i"):
            fields[key] = int(value)
        elif tp.startswith("-r"):
            fields[key] = float(value)
        else:  # -sN string
            fields[key] = value
    return fields, header_size


def decode_sph(data: bytes) -> Tuple[np.ndarray, int]:
    """bytes -> (float32 waveform in int16 scale, sample_rate)."""
    fields, header_size = _parse_header(data)
    rate = int(fields.get("sample_rate", 16000))
    channels = int(fields.get("channel_count", 1))
    n_bytes = int(fields.get("sample_n_bytes", 2))
    coding = str(fields.get("sample_coding", "pcm")).lower()
    byte_fmt = str(fields.get("sample_byte_format",
                              "01" if n_bytes == 2 else "1"))
    payload = data[header_size:]
    n_samples = fields.get("sample_count")
    if "shorten" in coding:
        raise NotImplementedError(
            "SPHERE embedded-shorten compression is not supported; "
            "decompress with 'w_decode' or sph2pipe first.")
    if coding.startswith("ulaw") or coding.startswith("mu-law") \
            or coding.startswith("mulaw"):
        arr = ulaw_to_linear(
            np.frombuffer(payload, np.uint8)).astype(np.float32)
    elif coding.startswith("alaw"):
        arr = alaw_to_linear(
            np.frombuffer(payload, np.uint8)).astype(np.float32)
    elif coding.startswith("pcm") or coding == "raw":
        if n_bytes == 2:
            dtype = ">i2" if byte_fmt == "10" else "<i2"
            usable = (len(payload) // 2) * 2
            arr = np.frombuffer(payload[:usable], dtype).astype(np.float32)
        elif n_bytes == 1:
            arr = np.frombuffer(payload, np.int8).astype(np.float32) * 256.0
        else:
            raise ValueError(
                f"Unsupported SPHERE sample_n_bytes={n_bytes}")
    else:
        raise ValueError(f"Unsupported SPHERE sample_coding={coding!r}")
    if n_samples is not None:
        arr = arr[:int(n_samples) * channels]
    if channels > 1:
        arr = arr.reshape(-1, channels).mean(axis=1)
    return arr, rate
