from neurst_tpu_torch.data.datasets.audio import \
    audio_record_dataset  # noqa: F401
