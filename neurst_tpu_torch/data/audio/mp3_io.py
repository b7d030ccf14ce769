"""MP3 decoding through whichever backend the host provides (the port's
copy of ``neurst_tpu/data/audio/mp3_io.py``).

Probes, in order: the ``ffmpeg`` binary, ``torchaudio``, ``miniaudio``,
``pydub`` and ``pygame`` (SDL_mixer's dr_mp3 under SDL's dummy audio
driver).  With none of them it raises a NotImplementedError naming the
remedies; a host with none of them (the H100 machines this port is
measured on among them) decodes no mp3.
"""

import io
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

__all__ = ["decode_mp3", "available_backend"]

_BACKEND: Optional[str] = None
_PROBED = False


def available_backend() -> Optional[str]:
    """Returns the name of the first usable mp3 backend, or None."""
    global _BACKEND, _PROBED
    if _PROBED:
        return _BACKEND
    _PROBED = True
    if shutil.which("ffmpeg"):
        _BACKEND = "ffmpeg"
        return _BACKEND
    for mod in ("torchaudio", "miniaudio", "pydub"):
        try:
            __import__(mod)
            _BACKEND = mod
            return _BACKEND
        except ImportError:
            continue
    if _pygame_mixer() is not None and _pygame_decodes_mp3():
        _BACKEND = "pygame"
    return _BACKEND


def _pygame_mixer():
    """Imports pygame and verifies the mixer initializes headlessly
    (SDL dummy audio driver); returns the mixer module or None."""
    os.environ.setdefault("PYGAME_HIDE_SUPPORT_PROMPT", "1")
    os.environ.setdefault("SDL_AUDIODRIVER", "dummy")
    try:
        import pygame
    except ImportError:
        return None
    try:
        if pygame.mixer.get_init() is None:
            pygame.mixer.init()
            pygame.mixer.quit()
        return pygame.mixer
    except pygame.error:
        return None


def _pygame_decodes_mp3() -> bool:
    """Mixer init alone does not prove mp3 support (SDL_mixer can be
    built without dr_mp3/mpg123); probe by decoding the mp3 pygame
    itself ships.  Without that file the probe stays permissive —
    decode_mp3 still converts a failing Sound() into the documented
    NotImplementedError."""
    import pygame
    sample = os.path.join(os.path.dirname(pygame.__file__),
                          "examples", "data", "house_lo.mp3")
    if not os.path.exists(sample):
        return True
    try:
        with open(sample, "rb") as f:
            _via_pygame(f.read())
        return True
    except (pygame.error, ValueError, NotImplementedError):
        return False


def _via_ffmpeg(data: bytes) -> Tuple[np.ndarray, int]:
    # decode to s16le mono on stdout; ffmpeg reads the container itself
    probe = subprocess.run(
        ["ffmpeg", "-v", "error", "-i", "pipe:0", "-f", "s16le",
         "-ac", "1", "pipe:1"],
        input=data, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    if probe.returncode != 0:
        raise ValueError(
            f"ffmpeg failed to decode mp3: {probe.stderr.decode()[:500]}")
    arr = np.frombuffer(probe.stdout, "<i2").astype(np.float32)
    # the rate comes from the frame header (pure python) — spawning a
    # second subprocess (ffprobe) per clip would double the dominant
    # cost of corpus preparation
    rate = _frame_header_rate(data)
    return arr, rate


def _frame_header_info(data: bytes) -> Tuple[int, int]:
    # parse the first MPEG audio frame header: (sample_rate, channels)
    rates = {0: 44100, 1: 48000, 2: 32000}
    pos = 0
    if data[:3] == b"ID3":  # skip the ID3v2 tag
        size = ((data[6] & 0x7F) << 21) | ((data[7] & 0x7F) << 14) \
            | ((data[8] & 0x7F) << 7) | (data[9] & 0x7F)
        pos = 10 + size
    while pos + 4 <= len(data):
        if data[pos] == 0xFF and (data[pos + 1] & 0xE0) == 0xE0:
            version = (data[pos + 1] >> 3) & 0x03
            rate_idx = (data[pos + 2] >> 2) & 0x03
            mode = (data[pos + 3] >> 6) & 0x03  # 3 == single channel
            if rate_idx != 3:
                base = rates[rate_idx]
                channels = 1 if mode == 3 else 2
                if version == 3:       # MPEG-1
                    return base, channels
                if version == 2:       # MPEG-2
                    return base // 2, channels
                if version == 0:       # MPEG-2.5
                    return base // 4, channels
        pos += 1
    return 44100, 2


def _frame_header_rate(data: bytes) -> int:
    return _frame_header_info(data)[0]


def decode_mp3(data: bytes) -> Tuple[np.ndarray, int]:
    """bytes -> (float32 waveform in int16 scale, sample_rate)."""
    backend = available_backend()
    if backend == "ffmpeg":
        return _via_ffmpeg(data)
    if backend == "torchaudio":
        import torch
        import torchaudio
        wav, rate = torchaudio.load(io.BytesIO(data), format="mp3")
        arr = (wav.mean(dim=0) * 32768.0).to(torch.float32).numpy()
        return arr, int(rate)
    if backend == "miniaudio":
        import miniaudio
        dec = miniaudio.mp3_read_s16(data)
        arr = np.asarray(dec.samples, np.float32)
        if dec.nchannels > 1:
            arr = arr.reshape(-1, dec.nchannels).mean(axis=1)
        return arr, int(dec.sample_rate)
    if backend == "pydub":
        from pydub import AudioSegment
        seg = AudioSegment.from_file(io.BytesIO(data), format="mp3")
        seg = seg.set_channels(1).set_sample_width(2)
        arr = np.frombuffer(seg.raw_data, "<i2").astype(np.float32)
        return arr, int(seg.frame_rate)
    if backend == "pygame":
        return _via_pygame(data)
    raise NotImplementedError(
        "No mp3 decoder available on this host. Install ffmpeg (or "
        "torchaudio/miniaudio/pydub/pygame), or pre-convert the corpus "
        "to wav with examples' data-prep scripts.")


def _via_pygame(data: bytes) -> Tuple[np.ndarray, int]:
    """SDL_mixer decode at the file's native rate/channels (parsed from
    the frame header) so the mixer performs no resampling; the mixer is
    re-initialized only when those differ from the current state."""
    mixer = _pygame_mixer()
    if mixer is None:
        raise ValueError("pygame mixer unavailable for mp3 decode")
    rate, channels = _frame_header_info(data)
    init = mixer.get_init()
    if init is None or init[0] != rate or abs(init[1]) != 16 \
            or init[2] != channels:
        if init is not None:
            mixer.quit()
        mixer.init(frequency=rate, size=-16, channels=channels)
    import pygame
    try:
        snd = mixer.Sound(file=io.BytesIO(data))
    except pygame.error as e:
        # SDL_mixer built without an mp3 decoder reaches here with an
        # opaque 'Unsupported audio format'; surface the remedies
        raise NotImplementedError(
            "pygame/SDL_mixer on this host cannot decode mp3 "
            f"({e}). Install ffmpeg (or torchaudio/miniaudio/pydub), "
            "or pre-convert the corpus to wav.") from e
    arr = np.frombuffer(snd.get_raw(), np.int16).astype(np.float32)
    if channels > 1:
        arr = arr.reshape(-1, channels).mean(axis=1)
    return arr, rate
