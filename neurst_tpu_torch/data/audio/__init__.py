from neurst_tpu_torch.data.audio.feature_extractor import (  # noqa: F401
    FeatureExtractor, build_feature_extractor, register_feature_extractor)
from neurst_tpu_torch.data.audio import log_mel_fbank  # noqa: F401
