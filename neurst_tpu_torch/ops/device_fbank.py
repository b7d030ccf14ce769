"""Log-mel fbank and per-utterance CMVN with torch on the waveforms'
device (the port's counterpart of ``neurst_tpu/ops/device_fbank.py``).

The host features (``data/audio/log_mel_fbank.py``, numpy float64) are the
reference; this is the same computation on a batch: the padded tail
masked before and after pre-emphasis, framing as a strided view,
``torch.fft.rfft``, the power spectrum against the mel filterbank by
``torch.matmul``, the log, and CMVN over each utterance's own frames
(shifted by its first frame, so that a constant channel comes out 0).
It computes in float64, as the host does, and returns float32: in
float32 (as the JAX op computes) a mel band far below its frame's energy,
as at the spectral nulls of a low-passed signal, took up to 1.6e-3 of
the 2e-3 the features are held to.  It is no Pallas kernel in the JAX
package either: torch ops serve, and no launch counter is kept.
"""

import functools
from typing import Optional

import numpy as np
import torch

from neurst_tpu_torch.data.audio.log_mel_fbank import (get_filterbanks,
                                                       num_frames)

__all__ = ["device_logfbank", "num_frames"]


@functools.lru_cache(maxsize=None)
def _filterbank_t(nfilt: int, nfft: int, samplerate: int) -> np.ndarray:
    """The mel filterbank, transposed: [nfft // 2 + 1, nfilt] float64."""
    return np.ascontiguousarray(get_filterbanks(nfilt, nfft, samplerate).T)


def device_logfbank(signals: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None,
                    samplerate: int = 16000, winlen: float = 0.025,
                    winstep: float = 0.01, nfilt: int = 80,
                    nfft: int = 512, preemph: float = 0.97,
                    cmvn: bool = True):
    """[B, S] waveforms (+ lengths [B]) -> ([B, F, nfilt] float32,
    frame lengths [B] int32), F the frame count of S samples.  Frames
    past an utterance's length are zero; CMVN statistics honour the
    mask."""
    signals = signals.to(torch.float64)
    device = signals.device
    b, slen = signals.shape
    if lengths is None:
        lengths = torch.full([b], slen, dtype=torch.int32, device=device)
    lengths = lengths.to(device=device, dtype=torch.int64)
    frame_len = int(round(winlen * samplerate))
    frame_step = int(round(winstep * samplerate))
    total_frames = num_frames(slen, samplerate, winlen, winstep)

    # pre-emphasis y[0] = x[0], y[t] = x[t] - a * x[t - 1] over the masked
    # signal; the host pads after pre-emphasis, so position `length` stays
    # 0 (not -a * x[length - 1]): the mask is applied again
    mask = (torch.arange(slen, device=device)[None, :]
            < lengths[:, None]).to(torch.float64)
    signals = signals * mask
    emphasized = torch.cat(
        [signals[:, :1], signals[:, 1:] - preemph * signals[:, :-1]], dim=1)
    emphasized = emphasized * mask
    pad = (total_frames - 1) * frame_step + frame_len - slen
    emphasized = torch.nn.functional.pad(emphasized, (0, max(pad, 0)))

    frames = emphasized.unfold(1, frame_len, frame_step)  # [B, F, len]
    spec = torch.fft.rfft(frames, n=nfft, dim=-1)
    pspec = (spec.real ** 2 + spec.imag ** 2) / nfft      # [B, F, nfft/2+1]
    fb = torch.as_tensor(_filterbank_t(nfilt, nfft, samplerate),
                         device=device)
    feat = torch.matmul(pspec, fb)                        # [B, F, nfilt]
    feat = torch.log(torch.clamp_min(feat, float(np.finfo(np.float64).eps)))

    # each utterance's frame count, by the host formula
    fl = torch.where(
        lengths <= frame_len, torch.ones_like(lengths),
        1 + torch.div(lengths - frame_len + frame_step - 1, frame_step,
                      rounding_mode="floor"))
    fmask = (torch.arange(total_frames, device=device)[None, :]
             < fl[:, None]).to(torch.float64)[..., None]
    if cmvn:
        # statistics of the features less the first frame's: a constant
        # channel (a mel band no FFT bin falls in, at log(eps)) centres to
        # exactly 0, where its mean would miss by an ulp and the 1e-10
        # floor of the deviation would blow that up (the host's features
        # carry that noise: up to ~0.06 at nfilt 80)
        feat = feat - feat[:, :1]
        n = torch.clamp_min(fmask.sum(dim=1, keepdim=True), 1.0)
        mean = (feat * fmask).sum(dim=1, keepdim=True) / n
        var = (torch.square(feat - mean) * fmask).sum(dim=1,
                                                      keepdim=True) / n
        feat = (feat - mean) / torch.sqrt(var + 1e-20)
    return (feat * fmask).to(torch.float32), fl.to(torch.int32)
