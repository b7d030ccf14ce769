"""The parallel-corpus base (the part of
``neurst_tpu/data/datasets/parallel_text_dataset.py`` the audio datasets
extend; the text datasets are not ported yet)."""

from neurst_tpu_torch.data.datasets.dataset import TextGenDataset

__all__ = ["AbstractParallelDataset"]


class AbstractParallelDataset(TextGenDataset):
    """Parallel corpus: feature (source) + label (target text)."""
