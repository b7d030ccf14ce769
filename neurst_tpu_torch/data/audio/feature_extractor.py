"""The audio feature extractor registry (the port's copy of
``neurst_tpu/data/audio/feature_extractor.py``)."""

import numpy as np

from neurst_tpu_torch.utils.registry import setup_registry

__all__ = ["FeatureExtractor", "build_feature_extractor",
           "register_feature_extractor"]


class FeatureExtractor(object):
    """Maps a 1-D waveform (float array) to a feature sequence."""

    def __init__(self, args=None):
        self._args = dict(args or {})

    @staticmethod
    def class_or_method_args():
        return []

    @property
    def feature_dim(self) -> int:
        raise NotImplementedError

    def seq_len_fn(self, raw_len: int) -> int:
        """Number of output frames for a waveform of `raw_len` samples."""
        raise NotImplementedError

    def __call__(self, signal, rate: int):
        raise NotImplementedError


def _create_fe(cls, args, **kwargs):
    return cls(args, **kwargs)


build_feature_extractor, register_feature_extractor = setup_registry(
    "feature_extractor", base_class=FeatureExtractor, create_fn=_create_fe)


@register_feature_extractor("float_identity")
class FloatIdentity(FeatureExtractor):
    """Pass-through (pre-extracted features or raw waveform models)."""

    @property
    def feature_dim(self):
        return 1

    def seq_len_fn(self, raw_len):
        return raw_len

    def __call__(self, signal, rate):
        return np.asarray(signal, np.float32)
