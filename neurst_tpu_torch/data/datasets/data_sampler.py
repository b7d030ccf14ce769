"""Multi-corpus sampling (the port's copy of
``neurst_tpu/data/datasets/data_sampler.py``): ``DataSampler`` weighs each
sub-dataset by an explicit ratio (by its size where none is given),
``TemperatureSampler`` by size^(1/T)."""

from typing import Dict

import yaml

from neurst_tpu_torch.utils.flags_core import Flag
from neurst_tpu_torch.utils.registry import setup_registry

__all__ = ["DataSampler", "TemperatureSampler", "build_data_sampler"]


class DataSampler(object):
    """Samples a dataset name by normalized weights."""

    def __init__(self, args=None):
        self._args = dict(args or {})
        ratios = self._args.get("sample_ratios")
        if isinstance(ratios, str):
            ratios = yaml.safe_load(ratios)
        self._sample_ratios: Dict[str, float] = dict(ratios or {})

    @staticmethod
    def class_or_method_args():
        return [Flag("sample_ratios", dtype=Flag.TYPE.STRING, default=None,
                     help="A dict of dataset name -> sampling weight.")]

    def get_sample_ratios(self, sample_sizes: Dict[str, int]
                          ) -> Dict[str, float]:
        if self._sample_ratios:
            return dict(self._sample_ratios)
        return {k: float(v) for k, v in sample_sizes.items()}

    def normalized_ratios(self, sample_sizes: Dict[str, int]
                          ) -> Dict[str, float]:
        ratios = self.get_sample_ratios(sample_sizes)
        total = sum(ratios.values())
        return {k: v / total for k, v in ratios.items()}


class TemperatureSampler(DataSampler):
    """ratio_i proportional to size_i^(1/T): T = 1 by size, large T
    uniform."""

    def __init__(self, args=None):
        super().__init__(args)
        self._temperature = float(self._args.get("temperature") or 5.0)

    @staticmethod
    def class_or_method_args():
        return DataSampler.class_or_method_args() + [
            Flag("temperature", dtype=Flag.TYPE.FLOAT, default=5.0,
                 help="The sampling temperature T.")]

    def get_sample_ratios(self, sample_sizes):
        return {k: float(v) ** (1.0 / self._temperature)
                for k, v in sample_sizes.items()}


build_data_sampler, register_data_sampler = setup_registry(
    "data_sampler", base_class=DataSampler)

register_data_sampler(DataSampler)
register_data_sampler(TemperatureSampler)
