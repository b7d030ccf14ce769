"""SpecAugment on the host (the port's copy of the numpy side of
``neurst_tpu/utils/audio_lib.py``): the LB / LD / SM / SS presets and
n-times frequency and time masking with maximum widths F / T and the
time-mask bound ratio p; no time warping, as in the JAX package.

``apply_numpy`` draws from ``np.random`` (or the given ``RandomState``)
with the same calls in the same order as the JAX package's, so one seeded
generator gives both packages bitwise equal masks.
"""

from typing import Optional

import numpy as np
import yaml

__all__ = ["SpecAugment"]


class SpecAugment(object):

    _PREDEF_SETTINGS = {
        "LB": {"time_wrap_w": 80, "freq_mask_n": 1, "freq_mask_f": 27,
               "time_mask_n": 1, "time_mask_t": 100, "time_mask_p": 1.},
        "LD": {"time_wrap_w": 80, "freq_mask_n": 2, "freq_mask_f": 27,
               "time_mask_n": 2, "time_mask_t": 100, "time_mask_p": 1.},
        "SM": {"time_wrap_w": 40, "freq_mask_n": 2, "freq_mask_f": 15,
               "time_mask_n": 2, "time_mask_t": 70, "time_mask_p": 0.2},
        "SS": {"time_wrap_w": 40, "freq_mask_n": 2, "freq_mask_f": 27,
               "time_mask_n": 2, "time_mask_t": 70, "time_mask_p": 0.2},
    }

    def __init__(self, time_wrap_w=0, freq_mask_n=1, freq_mask_f=27,
                 time_mask_n=1, time_mask_t=100, time_mask_p=1.0,
                 mask_value=None):
        # time_wrap_w is accepted for the presets' sake and not applied
        self._freq_mask_n = freq_mask_n
        self._freq_mask_f = freq_mask_f
        self._time_mask_n = time_mask_n
        self._time_mask_t = time_mask_t
        self._time_mask_p = time_mask_p
        self._mask_value = mask_value
        if not (time_mask_t > 0 and freq_mask_f > 0):
            raise ValueError("SpecAugment needs time_mask_t > 0 and "
                             "freq_mask_f > 0")

    @classmethod
    def build(cls, setting):
        """A preset name ("LB"), a YAML string or a dict -> SpecAugment;
        None -> None."""
        if setting is None:
            return None
        if isinstance(setting, str):
            setting = yaml.safe_load(setting)
        if isinstance(setting, str):
            setting = cls._PREDEF_SETTINGS.get(setting)
        if setting is None:
            return None
        if not isinstance(setting, dict):
            raise ValueError(f"Unknown SpecAugment setting: {setting}")
        return cls(**setting)

    def apply_numpy(self, spectrogram: np.ndarray,
                    rng: Optional[np.random.RandomState] = None
                    ) -> np.ndarray:
        """spectrogram [T, F] -> a masked copy (masked with its mean
        unless ``mask_value`` is set)."""
        if rng is None:
            rng = np.random
        spec = np.array(spectrogram, copy=True)
        num_t, num_f = spec.shape
        mask_value = (self._mask_value if self._mask_value is not None
                      else float(spec.mean()))
        for _ in range(self._freq_mask_n):
            f = rng.randint(0, self._freq_mask_f)
            if num_f - f <= 0:
                continue
            f0 = rng.randint(0, num_f - f)
            spec[:, f0:f0 + f] = mask_value
        max_t = int(min(self._time_mask_t, self._time_mask_p * num_t))
        for _ in range(self._time_mask_n):
            if max_t <= 0:
                continue
            t = rng.randint(0, max_t)
            if num_t - t <= 0:
                continue
            t0 = rng.randint(0, num_t - t)
            spec[t0:t0 + t, :] = mask_value
        return spec

    __call__ = apply_numpy
