"""Parallel text datasets (the port's copy of
``neurst_tpu/data/datasets/parallel_text_dataset.py``): a source and a
target text file (``parallel_text``), lists of such pairs
(``multiple_parallel_text``), lists of strings in memory
(``in_memory_parallel_text``) and one direction of a multilingual corpus
(``multilingual_translation_dataset``).  A file whose name ends in
``.gz`` is read through gzip.  Examples are {"feature": source line,
"label": target line}, stripped; sharding is round-robin by line."""

import gzip
from typing import Optional

from neurst_tpu_torch.data.datasets.dataset import (TextGenDataset,
                                                    register_dataset)
from neurst_tpu_torch.utils.compat import DataStatus
from neurst_tpu_torch.utils.configurable import flatten_string_list
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["AbstractParallelDataset", "ParallelTextDataset",
           "MultipleParallelTextDataset", "InMemoryParallelTextDataset",
           "MultilingualTranslationDataset", "open_maybe_gz"]


def open_maybe_gz(path):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8")
    return open(path, "r", encoding="utf-8")


def _read_lines(path):
    with open_maybe_gz(path) as f:
        return [line.strip() for line in f]


class AbstractParallelDataset(TextGenDataset):
    """Parallel corpus: feature (source) + label (target text)."""

    @property
    def sources(self):
        """Raw source texts (for logging and cascades)."""
        return None


def _pairs(src_files, trg_files, map_func, shard_id, total_shards):
    """Examples of the (source, target) file pairs in turn, sharded
    round-robin over their lines together."""
    idx = 0
    for i, src_file in enumerate(src_files):
        trg_file = trg_files[i] if trg_files else None
        fsrc = open_maybe_gz(src_file)
        ftrg = open_maybe_gz(trg_file) if trg_file else None
        try:
            while True:
                src = fsrc.readline()
                if not src:
                    break
                trg = ftrg.readline() if ftrg else None
                idx += 1
                if total_shards > 1 and (idx - 1) % total_shards != shard_id:
                    continue
                example = {"feature": src.strip()}
                if trg is not None:
                    example["label"] = trg.strip()
                if map_func is not None:
                    example = map_func(example)
                if example is not None:
                    yield example
        finally:
            fsrc.close()
            if ftrg:
                ftrg.close()


class _TextStatus(object):
    """RAW text, or PROCESSED (tokenized) with ``data_is_processed``."""

    @property
    def status(self):
        return (DataStatus.PROCESSED if self._data_is_processed
                else DataStatus.RAW)


_PROCESSED_FLAG = Flag("data_is_processed", dtype=Flag.TYPE.BOOLEAN,
                       default=None,
                       help="Whether the text data is already tokenized.")


@register_dataset("parallel_text")
class ParallelTextDataset(_TextStatus, AbstractParallelDataset):

    def __init__(self, args: Optional[dict] = None):
        super().__init__(args)
        self._src_file = self._args.get("src_file")
        self._trg_file = self._args.get("trg_file")
        self._data_is_processed = bool(self._args.get("data_is_processed"))
        self._sources = None

    @staticmethod
    def class_or_method_args():
        return [
            Flag("src_file", dtype=Flag.TYPE.STRING, default=None,
                 help="The source-side text file."),
            Flag("trg_file", dtype=Flag.TYPE.STRING, default=None,
                 help="The target-side text file."),
            _PROCESSED_FLAG,
        ]

    def build_iterator(self, map_func=None, shard_id=0, total_shards=1):
        if not self._src_file:
            raise ValueError("`src_file` must be provided for "
                             "ParallelTextDataset.")
        trg = [self._trg_file] if self._trg_file else None
        return lambda: _pairs([self._src_file], trg, map_func, shard_id,
                              total_shards)

    @property
    def sources(self):
        if self._sources is None and self._src_file:
            self._sources = _read_lines(self._src_file)
        return self._sources

    @property
    def targets(self):
        if self._targets is None and self._trg_file:
            self._targets = _read_lines(self._trg_file)
        return self._targets


@register_dataset("multiple_parallel_text")
class MultipleParallelTextDataset(_TextStatus, AbstractParallelDataset):
    """Several parallel corpora read one after another."""

    def __init__(self, args: Optional[dict] = None):
        super().__init__(args)
        self._src_files = flatten_string_list(self._args.get("src_files"))
        self._trg_files = flatten_string_list(self._args.get("trg_files"))
        self._data_is_processed = bool(self._args.get("data_is_processed"))
        if self._trg_files and len(self._src_files) != len(self._trg_files):
            raise ValueError("src_files and trg_files must pair up.")

    @staticmethod
    def class_or_method_args():
        return [
            Flag("src_files", dtype=Flag.TYPE.STRING, default=None,
                 multiple=True, help="The source-side text files."),
            Flag("trg_files", dtype=Flag.TYPE.STRING, default=None,
                 multiple=True, help="The target-side text files."),
            _PROCESSED_FLAG,
        ]

    def build_iterator(self, map_func=None, shard_id=0, total_shards=1):
        return lambda: _pairs(self._src_files, self._trg_files, map_func,
                              shard_id, total_shards)

    @property
    def targets(self):
        if self._targets is None and self._trg_files:
            self._targets = [t for f in self._trg_files
                             for t in _read_lines(f)]
        return self._targets


@register_dataset("in_memory_parallel_text")
class InMemoryParallelTextDataset(_TextStatus, AbstractParallelDataset):
    """A parallel corpus held in memory: built from an args dict
    (``src_list``, ``trg_list``, ``data_is_processed``) or from the lists
    themselves."""

    def __init__(self, args_or_src=None, trg_list=None,
                 data_is_processed=False):
        if isinstance(args_or_src, dict) and "src_list" not in args_or_src:
            args = args_or_src
            src_list, trg_list = args.get("src_list"), args.get("trg_list")
            data_is_processed = bool(args.get("data_is_processed"))
        else:
            src_list = args_or_src
            args = {"src_list": src_list, "trg_list": trg_list,
                    "data_is_processed": data_is_processed}
        super().__init__(args)
        self._src_list = list(src_list or [])
        self._trg_list = list(trg_list) if trg_list else None
        self._data_is_processed = data_is_processed

    def build_iterator(self, map_func=None, shard_id=0, total_shards=1):
        def gen():
            for idx, src in enumerate(self._src_list):
                if total_shards > 1 and idx % total_shards != shard_id:
                    continue
                example = {"feature": src}
                if self._trg_list is not None:
                    example["label"] = self._trg_list[idx]
                if map_func is not None:
                    example = map_func(example)
                if example is not None:
                    yield example
        return gen

    @property
    def sources(self):
        return self._src_list

    @property
    def targets(self):
        if self._targets is None:
            self._targets = self._trg_list
        return self._targets

    @property
    def num_samples(self):
        return len(self._src_list)


@register_dataset("multilingual_translation_dataset")
class MultilingualTranslationDataset(ParallelTextDataset):
    """A parallel corpus of one language direction: every example also
    carries ``src_lang`` and ``trg_lang`` (the multilingual task's tags;
    ``mixed_train`` combines several directions)."""

    def __init__(self, args: Optional[dict] = None):
        super().__init__(args)
        self._src_lang = self._args.get("src_lang")
        self._trg_lang = self._args.get("trg_lang")

    @staticmethod
    def class_or_method_args():
        return ParallelTextDataset.class_or_method_args() + [
            Flag("src_lang", dtype=Flag.TYPE.STRING, default=None,
                 help="The source language code."),
            Flag("trg_lang", dtype=Flag.TYPE.STRING, default=None,
                 help="The target language code."),
        ]

    def build_iterator(self, map_func=None, shard_id=0, total_shards=1):
        base = super().build_iterator(None, shard_id, total_shards)

        def gen():
            for example in base():
                example = dict(example, src_lang=self._src_lang,
                               trg_lang=self._trg_lang)
                if map_func is not None:
                    example = map_func(example)
                if example is not None:
                    yield example
        return gen
