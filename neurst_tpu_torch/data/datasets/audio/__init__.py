from neurst_tpu_torch.data.datasets.audio import \
    audio_record_dataset  # noqa: F401
from neurst_tpu_torch.data.datasets.audio import \
    raw_audio_dataset  # noqa: F401
