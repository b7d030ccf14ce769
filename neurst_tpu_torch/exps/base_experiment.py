"""Experiment ("entry") base and registry (the port's copy of
``neurst_tpu/exps/base_experiment.py``): an entry holds (task, model,
custom_dataset, model_dir) and implements ``run``."""

from typing import Optional

from neurst_tpu_torch.utils.registry import setup_registry

__all__ = ["BaseExperiment", "build_exp", "register_exp"]


class BaseExperiment(object):

    def __init__(self, args=None, task=None, model=None,
                 custom_dataset=None, model_dir: Optional[str] = None):
        self._args = dict(args or {})
        self._task = task
        self._model = model
        self._custom_dataset = custom_dataset
        self._model_dir = model_dir

    @property
    def task(self):
        return self._task

    @property
    def model(self):
        return self._model

    @property
    def custom_dataset(self):
        return self._custom_dataset

    @property
    def model_dir(self):
        return self._model_dir

    @staticmethod
    def class_or_method_args():
        return []

    def run(self):
        raise NotImplementedError


build_exp, register_exp = setup_registry("entry", base_class=BaseExperiment)
