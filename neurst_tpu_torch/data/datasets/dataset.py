"""Datasets (the port's copy of ``neurst_tpu/data/datasets/dataset.py``).

A Dataset exposes a plain Python generator (``build_iterator``) of
example dicts; the task's batcher turns it into numpy batches.  Sharding
for several hosts is round-robin by ``shard_id`` / ``total_shards``.
"""

import logging
from typing import Callable, Iterator, Optional

from neurst_tpu_torch.data.recordio import (glob_record_files, parse_example,
                                            record_iterator)
from neurst_tpu_torch.utils.compat import DataStatus
from neurst_tpu_torch.utils.flags_core import Flag
from neurst_tpu_torch.utils.registry import setup_registry

__all__ = ["Dataset", "TextGenDataset", "RecordDataset",
           "build_dataset", "register_dataset"]


class Dataset(object):
    """Base dataset: an iterable of example dicts."""

    def __init__(self, args: Optional[dict] = None):
        self._args = dict(args or {})

    @property
    def args(self):
        return self._args

    @property
    def status(self):
        """DataStatus of the fields this dataset yields."""
        return DataStatus.RAW

    @property
    def fields(self) -> Optional[dict]:
        """Record field declaration ({name: dtype str}) or None."""
        return None

    @staticmethod
    def class_or_method_args():
        return []

    def build_iterator(self, map_func: Optional[Callable] = None,
                       shard_id: int = 0, total_shards: int = 1
                       ) -> Callable[[], Iterator[dict]]:
        """A zero-arg callable producing a fresh iterator; ``map_func``
        transforms each example on the fly (a task's preprocess fn)."""
        raise NotImplementedError

    @property
    def num_samples(self) -> Optional[int]:
        """The number of examples, counted by a scan (None where the
        dataset cannot iterate)."""
        try:
            return sum(1 for _ in self.build_iterator()())
        except NotImplementedError:
            return None


class TextGenDataset(Dataset):
    """A dataset with (optional) reference targets."""

    def __init__(self, args: Optional[dict] = None):
        super().__init__(args)
        self._targets = None
        self._raw_targets = None

    @property
    def targets(self):
        return self._targets

    @property
    def raw_targets(self):
        """Raw (untokenized) references, for detokenized metrics."""
        return self._raw_targets or self._targets


class RecordDataset(Dataset):
    """Datasets stored as TFRecord-format files of ``tf.train.Example``."""

    def __init__(self, args: Optional[dict] = None):
        super().__init__(args)
        self._data_path = self._args.get("data_path")

    @property
    def status(self):
        return DataStatus.PROJECTED

    @staticmethod
    def class_or_method_args():
        return [
            Flag("data_path", dtype=Flag.TYPE.STRING, default=None,
                 help="The path (file/dir/glob) to the record files."),
            Flag("shuffle_files", dtype=Flag.TYPE.BOOLEAN, default=True,
                 help="Whether to shuffle file order between epochs."),
        ]

    def build_iterator(self, map_func=None, shard_id=0, total_shards=1):
        files = glob_record_files(self._data_path)
        if not files:
            raise FileNotFoundError(
                f"No record files matched: {self._data_path}")

        def gen():
            idx = 0
            for fpath in files:
                # the TFRecord format has no resync point: a framing or
                # crc error ends this file, and the next file goes on
                records = record_iterator(fpath, check_crc=True)
                while True:
                    try:
                        record = next(records)
                    except StopIteration:
                        break
                    except (IOError, EOFError, ValueError) as e:
                        logging.warning("corrupt record in %s (%s); "
                                        "skipping the rest of this file",
                                        fpath, e)
                        break
                    idx += 1
                    if total_shards > 1 and (idx - 1) % total_shards \
                            != shard_id:
                        continue
                    try:
                        example = self.parse_record(parse_example(record))
                    except Exception as e:  # noqa: BLE001 - any decode err
                        logging.warning("unparseable record %d in %s (%s: "
                                        "%s); skipped", idx - 1, fpath,
                                        type(e).__name__, e)
                        continue
                    if map_func is not None:
                        example = map_func(example)
                    if example is not None:
                        yield example
        return gen

    def parse_record(self, parsed: dict) -> dict:
        """Post-processes a parsed record dict (override per dataset)."""
        return parsed


build_dataset, register_dataset = setup_registry("dataset",
                                                 base_class=Dataset)
