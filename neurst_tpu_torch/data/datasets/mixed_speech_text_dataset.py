"""Mixed speech and text training data (the port's copy of
``neurst_tpu/data/datasets/mixed_speech_text_dataset.py``): named ASR
record corpora, ST triple corpora and MT text corpora, one corpus drawn
per example by the ``DataSampler``'s ratios (by size where none are
given) from ``random.Random(seed + shard_id)``.  Every example is tagged
``task_of`` ("asr", "st" or "mt") and ``dataset_key`` ("<kind>:<name>"),
so a joint-training task can route its loss; a corpus that runs out
starts again.  No task of either package consumes it yet.
"""

import random
from typing import Optional

import yaml

from neurst_tpu_torch.data.datasets.data_sampler import build_data_sampler
from neurst_tpu_torch.data.datasets.dataset import (Dataset, build_dataset,
                                                    register_dataset)
from neurst_tpu_torch.utils.compat import DataStatus
from neurst_tpu_torch.utils.flags_core import Flag, ModuleFlag

__all__ = ["MixedSpeechTextRecordDataset"]


def _build_group(paths, cls_name, common):
    out = {}
    if isinstance(paths, str):
        paths = yaml.safe_load(paths)
    for name, path in (paths or {}).items():
        params = dict(common or {})
        params["data_path"] = path
        out[name] = build_dataset({"dataset.class": cls_name,
                                   "dataset.params": params})
    return out


@register_dataset("mixed_speech_text", "MixedSpeechTextTrainRecordDataset")
class MixedSpeechTextRecordDataset(Dataset):

    def __init__(self, args: Optional[dict] = None):
        super().__init__(args)
        a = self._args
        self._groups = {}
        for kind, default_cls in (("asr", "audio_tfrecord"),
                                  ("st", "audio_triple_tfrecord"),
                                  ("mt", "parallel_tfrecord")):
            common = a.get(f"{kind}_common_properties")
            if isinstance(common, str):
                common = yaml.safe_load(common)
            group = _build_group(a.get(f"{kind}_record_paths"),
                                 a.get(f"{kind}_data_class") or default_cls,
                                 common)
            for name, ds in group.items():
                self._groups[f"{kind}:{name}"] = (kind, ds)
        if not self._groups:
            raise ValueError("mixed_speech_text requires at least one of "
                             "asr/st/mt_record_paths")
        self._sampler = build_data_sampler({
            "data_sampler.class": a.get("data_sampler.class")
            or "data_sampler",
            "data_sampler.params": a.get("data_sampler.params") or {}})
        self._seed = a.get("seed") or 0

    @staticmethod
    def class_or_method_args():
        flags = []
        for kind in ("asr", "st", "mt"):
            flags.extend([
                Flag(f"{kind}_record_paths", dtype=Flag.TYPE.STRING,
                     default=None,
                     help=f"Dict of name -> record path for {kind} data."),
                Flag(f"{kind}_data_class", dtype=Flag.TYPE.STRING,
                     default=None,
                     help=f"The dataset class for {kind} records."),
                Flag(f"{kind}_common_properties", dtype=Flag.TYPE.STRING,
                     default=None,
                     help=f"Common dataset params for {kind} records."),
            ])
        flags.append(ModuleFlag("data_sampler", "data_sampler",
                                help="Cross-corpus sampling strategy."))
        flags.append(Flag("seed", dtype=Flag.TYPE.INTEGER, default=0,
                          help="Sampling seed."))
        return flags

    @property
    def status(self):
        return DataStatus.PROJECTED

    def build_iterator(self, map_func=None, shard_id=0, total_shards=1):
        sizes = {}
        for name, (_, ds) in self._groups.items():
            try:
                sizes[name] = ds.num_samples or 1
            except Exception:
                sizes[name] = 1
        ratios = self._sampler.normalized_ratios(sizes)
        names = sorted(ratios)
        weights = [ratios[n] for n in names]

        def gen():
            rng = random.Random(self._seed + shard_id)
            iters = {}
            while True:
                name = rng.choices(names, weights=weights, k=1)[0]
                kind, ds = self._groups[name]
                if name not in iters:
                    iters[name] = ds.build_iterator(
                        shard_id=shard_id, total_shards=total_shards)()
                try:
                    ex = next(iters[name])
                except StopIteration:
                    iters[name] = ds.build_iterator(
                        shard_id=shard_id, total_shards=total_shards)()
                    try:
                        ex = next(iters[name])
                    except StopIteration:
                        continue
                ex = dict(ex)
                ex["task_of"] = kind
                ex["dataset_key"] = name
                if map_func is not None:
                    ex = map_func(ex)
                if ex is not None:
                    yield ex
        return gen

    @property
    def num_samples(self):
        return None
