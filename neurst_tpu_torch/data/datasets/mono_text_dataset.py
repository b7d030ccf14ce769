"""Monolingual text dataset (the port's copy of
``neurst_tpu/data/datasets/mono_text_dataset.py``): one text file (gzip
where the name ends in ``.gz``), one {"feature": line} example a line."""

from typing import Optional

from neurst_tpu_torch.data.datasets.dataset import (TextGenDataset,
                                                    register_dataset)
from neurst_tpu_torch.data.datasets.parallel_text_dataset import (
    _PROCESSED_FLAG, _TextStatus, _read_lines, open_maybe_gz)
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["MonoTextDataset"]


@register_dataset("mono_text")
class MonoTextDataset(_TextStatus, TextGenDataset):

    def __init__(self, args: Optional[dict] = None):
        super().__init__(args)
        self._data_file = self._args.get("data_file")
        self._data_is_processed = bool(self._args.get("data_is_processed"))

    @staticmethod
    def class_or_method_args():
        return [Flag("data_file", dtype=Flag.TYPE.STRING, default=None,
                     help="The text file."),
                _PROCESSED_FLAG]

    def build_iterator(self, map_func=None, shard_id=0, total_shards=1):
        def gen():
            with open_maybe_gz(self._data_file) as f:
                for idx, line in enumerate(f):
                    if total_shards > 1 and idx % total_shards != shard_id:
                        continue
                    example = {"feature": line.strip()}
                    if map_func is not None:
                        example = map_func(example)
                    if example is not None:
                        yield example
        return gen

    @property
    def targets(self):
        if self._targets is None and self._data_file:
            self._targets = _read_lines(self._data_file)
        return self._targets
