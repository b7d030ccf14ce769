"""Log-mel filterbank features with per-utterance CMVN (the port's copy
of ``neurst_tpu/data/audio/log_mel_fbank.py``).

The python_speech_features algorithm in numpy float64: frame count
formula, zero padding, rectangular window, power spectrum
1/NFFT*|rfft|^2, HTK mel scale 2595*log10(1+hz/700), bin mapping
floor((NFFT+1)*hz/rate), eps flooring before the log; then per-utterance
mean/variance normalization.  ``ops/device_fbank.py`` computes the same
features with torch on the card.
"""

import math
from typing import Optional

import numpy as np

from neurst_tpu_torch.data.audio.feature_extractor import (
    FeatureExtractor, register_feature_extractor)
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["logfbank", "LogMelFbank", "get_filterbanks", "num_frames"]


def hz2mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, np.float64) / 700.0)


def mel2hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, np.float64) / 2595.0) - 1.0)


def get_filterbanks(nfilt: int, nfft: int, samplerate: int,
                    lowfreq: float = 0.0,
                    highfreq: Optional[float] = None) -> np.ndarray:
    """Triangular mel filterbank matrix [nfilt, nfft//2 + 1]."""
    highfreq = highfreq or samplerate / 2.0
    lowmel = hz2mel(lowfreq)
    highmel = hz2mel(highfreq)
    melpoints = np.linspace(lowmel, highmel, nfilt + 2)
    bins = np.floor((nfft + 1) * mel2hz(melpoints) / samplerate).astype(int)
    fbank = np.zeros([nfilt, nfft // 2 + 1])
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fbank[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(bins[j + 1], bins[j + 2]):
            fbank[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])
    return fbank


def framesig(signal: np.ndarray, frame_len: float, frame_step: float
             ) -> np.ndarray:
    """python_speech_features.sigproc.framesig with the default
    rectangular window: [num_frames, frame_len]."""
    slen = len(signal)
    frame_len = int(round(frame_len))
    frame_step = int(round(frame_step))
    if slen <= frame_len:
        numframes = 1
    else:
        numframes = 1 + int(math.ceil((slen - frame_len) / frame_step))
    padlen = int((numframes - 1) * frame_step + frame_len)
    padded = np.concatenate(
        [signal, np.zeros(padlen - slen, dtype=signal.dtype)])
    indices = (np.tile(np.arange(frame_len), (numframes, 1))
               + np.tile(np.arange(0, numframes * frame_step, frame_step),
                         (frame_len, 1)).T)
    return padded[indices.astype(np.int32)]


def num_frames(n_samples: int, samplerate: int = 16000,
               winlen: float = 0.025, winstep: float = 0.01) -> int:
    """The frame count of an n-sample utterance (``framesig``'s)."""
    frame_len = int(round(winlen * samplerate))
    frame_step = int(round(winstep * samplerate))
    if n_samples <= frame_len:
        return 1
    return 1 + int(math.ceil((n_samples - frame_len) / frame_step))


def preemphasis(signal: np.ndarray, coeff: float = 0.97) -> np.ndarray:
    return np.append(signal[0], signal[1:] - coeff * signal[:-1])


def powspec(frames: np.ndarray, nfft: int) -> np.ndarray:
    if frames.shape[1] > nfft:
        frames = frames[:, :nfft]
    spec = np.absolute(np.fft.rfft(frames, nfft))
    return 1.0 / nfft * np.square(spec)


def logfbank(signal, samplerate: int = 16000, winlen: float = 0.025,
             winstep: float = 0.01, nfilt: int = 80, nfft: int = 512,
             lowfreq: float = 0.0, highfreq: Optional[float] = None,
             preemph: float = 0.97) -> np.ndarray:
    """log mel filterbank energies [num_frames, nfilt] — the
    python_speech_features algorithm, reproduced."""
    signal = np.asarray(signal, np.float64)
    signal = preemphasis(signal, preemph)
    frames = framesig(signal, winlen * samplerate, winstep * samplerate)
    pspec = powspec(frames, nfft)
    fb = get_filterbanks(nfilt, nfft, samplerate, lowfreq, highfreq)
    feat = np.dot(pspec, fb.T)
    feat = np.where(feat == 0, np.finfo(np.float64).eps, feat)
    return np.log(feat)


@register_feature_extractor("fbank", "log_mel_fbank")
class LogMelFbank(FeatureExtractor):
    """logfbank + per-utterance CMVN."""

    def __init__(self, args=None):
        super().__init__(args)
        self._nfilt = int(self._args.get("nfilt") or 80)
        self._winlen = float(self._args.get("winlen") or 0.025)
        self._winstep = float(self._args.get("winstep") or 0.01)
        self._nfft = int(self._args.get("nfft") or 512)
        self._cmvn = self._args.get("per_utt_cmvn")
        if self._cmvn is None:
            self._cmvn = True

    @staticmethod
    def class_or_method_args():
        return [
            Flag("nfilt", dtype=Flag.TYPE.INTEGER, default=80,
                 help="The number of mel filterbanks."),
            Flag("winlen", dtype=Flag.TYPE.FLOAT, default=0.025,
                 help="The analysis window length in seconds."),
            Flag("winstep", dtype=Flag.TYPE.FLOAT, default=0.01,
                 help="The window step (stride) in seconds."),
            Flag("nfft", dtype=Flag.TYPE.INTEGER, default=512,
                 help="The FFT size."),
            Flag("per_utt_cmvn", dtype=Flag.TYPE.BOOLEAN, default=True,
                 help="Per-utterance mean/variance normalization."),
        ]

    @property
    def feature_dim(self):
        return self._nfilt

    def seq_len_fn(self, raw_len):
        return num_frames(raw_len, 16000, self._winlen, self._winstep)

    def __call__(self, signal, rate: int = 16000):
        feat = logfbank(signal, samplerate=rate, winlen=self._winlen,
                        winstep=self._winstep, nfilt=self._nfilt,
                        nfft=self._nfft)
        if self._cmvn:
            mean = np.mean(feat, axis=0)
            std = np.std(feat, axis=0)
            feat = (feat - mean) / np.maximum(std, 1e-10)
        return feat.astype(np.float32)
