"""Multi-corpus datasets (the port's copy of
``neurst_tpu/data/datasets/mixed_train_dataset.py``).

``MixedTrainDataset`` is an endless mixture of named sub-datasets: each
example's sub-dataset is drawn by a data sampler from
``random.Random(seed + shard_id)`` (the generator and the draws the JAX
package makes, so one seed gives both the same order), and a sub-dataset
that runs out starts again.  ``MultipleDataset`` is a finite union of
named sub-datasets with metric weights, read in name order; the predict
and eval entries run each on its own and weigh the results.  Examples
carry their sub-dataset's name as ``dataset_key``.
"""

import random
from typing import Dict, Optional

import yaml

from neurst_tpu_torch.data.datasets.data_sampler import build_data_sampler
from neurst_tpu_torch.data.datasets.dataset import (Dataset, build_dataset,
                                                    register_dataset)
from neurst_tpu_torch.utils.compat import DataStatus
from neurst_tpu_torch.utils.flags_core import Flag, ModuleFlag

__all__ = ["MixedTrainDataset", "MultipleDataset"]


def _yaml_dict(value):
    value = value or {}
    return yaml.safe_load(value) if isinstance(value, str) else value


def _common_status(datasets):
    statuses = {ds.status for ds in datasets}
    return statuses.pop() if len(statuses) == 1 else DataStatus.RAW


def _tagged(example, name, map_func):
    example = dict(example)
    example.setdefault("dataset_key", name)
    return map_func(example) if map_func is not None else example


@register_dataset("mixed_train", "MixedTrainDataset")
class MixedTrainDataset(Dataset):

    def __init__(self, args: Optional[dict] = None):
        super().__init__(args)
        common_cls = self._args.get("dataset_class") or "parallel_text"
        self._datasets: Dict[str, Dataset] = {}
        for name, params in _yaml_dict(self._args.get("data_files")).items():
            if isinstance(params, dict) and "dataset.class" in params:
                self._datasets[name] = build_dataset(params)
            else:
                self._datasets[name] = build_dataset(
                    {"dataset.class": common_cls, "dataset.params": params})
        self._sampler = build_data_sampler(
            {"data_sampler.class": self._args.get("data_sampler.class")
             or "data_sampler",
             "data_sampler.params":
                 self._args.get("data_sampler.params") or {}})
        self._seed = self._args.get("seed") or 0

    @staticmethod
    def class_or_method_args():
        return [
            Flag("data_files", dtype=Flag.TYPE.STRING, default=None,
                 help="A dict of name -> sub-dataset params."),
            Flag("dataset_class", dtype=Flag.TYPE.STRING,
                 default="parallel_text",
                 help="The dataset class for the data files."),
            ModuleFlag("data_sampler", "data_sampler",
                       help="The cross-corpus sampling strategy."),
            Flag("seed", dtype=Flag.TYPE.INTEGER, default=0,
                 help="The sampling random seed."),
        ]

    @property
    def datasets(self):
        return self._datasets

    @property
    def status(self):
        return _common_status(self._datasets.values())

    def build_iterator(self, map_func=None, shard_id=0, total_shards=1):
        sizes = {}
        for name, ds in self._datasets.items():
            try:
                sizes[name] = ds.num_samples or 1
            except Exception:  # noqa: BLE001 - a size is only a weight
                sizes[name] = 1
        ratios = self._sampler.normalized_ratios(sizes)
        unknown = set(ratios) - set(self._datasets)
        if unknown:
            raise ValueError(
                f"data_sampler ratios name unknown sub-datasets {unknown}; "
                f"known: {sorted(self._datasets)}")
        names = sorted(ratios)
        weights = [ratios[n] for n in names]

        def fresh(name):
            return self._datasets[name].build_iterator(
                shard_id=shard_id, total_shards=total_shards)()

        def gen():
            rng = random.Random(self._seed + shard_id)
            iters, empty = {}, set()
            while True:
                name = rng.choices(names, weights=weights, k=1)[0]
                if name in empty:
                    continue
                if name not in iters:
                    iters[name] = fresh(name)
                example = next(iters[name], None)
                if example is None:
                    iters[name] = fresh(name)
                    example = next(iters[name], None)
                    if example is None:
                        empty.add(name)
                        if len(empty) == len(names):
                            raise RuntimeError(
                                "All sub-datasets of MixedTrainDataset are "
                                f"empty: {names}")
                        continue
                example = _tagged(example, name, map_func)
                if example is not None:
                    yield example
        return gen

    @property
    def num_samples(self):
        return None  # endless


@register_dataset("multiple_datasets", "MultipleDataset")
class MultipleDataset(Dataset):

    def __init__(self, args: Optional[dict] = None):
        super().__init__(args)
        self._datasets = {
            name: build_dataset(params) for name, params in
            _yaml_dict(self._args.get("multiple_datasets")).items()}
        weights = _yaml_dict(self._args.get("sample_weights"))
        total = sum(weights.get(n, 1.0) for n in self._datasets)
        self._sample_weights = {n: weights.get(n, 1.0) / total
                                for n in self._datasets}

    @staticmethod
    def class_or_method_args():
        return [
            Flag("multiple_datasets", dtype=Flag.TYPE.STRING, default=None,
                 help="A dict of name -> {dataset.class, dataset.params}."),
            Flag("sample_weights", dtype=Flag.TYPE.STRING, default=None,
                 help="A dict of name -> metric weight."),
        ]

    @property
    def datasets(self):
        return self._datasets

    @property
    def sample_weights(self):
        return self._sample_weights

    @property
    def status(self):
        return _common_status(self._datasets.values())

    def build_iterator(self, map_func=None, shard_id=0, total_shards=1):
        def gen():
            for name in sorted(self._datasets):
                for example in self._datasets[name].build_iterator(
                        shard_id=shard_id, total_shards=total_shards)():
                    example = _tagged(example, name, map_func)
                    if example is not None:
                        yield example
        return gen
