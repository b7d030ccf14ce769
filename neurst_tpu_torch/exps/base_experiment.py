"""Experiment ("entry") base and registry (the port's copy of
``neurst_tpu/exps/base_experiment.py``): an entry holds (task, model,
custom_dataset, model_dir) and implements ``run``."""

import logging
from typing import Optional

import torch

from neurst_tpu_torch.utils import checkpoints as ckpt_lib
from neurst_tpu_torch.utils.param_policy import (cast_params_for_inference,
                                                 restore_inference_params)
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
    def args(self):
        return self._args

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

    def restore_params(self):
        """Loads ``checkpoint_path`` (the model dir's newest checkpoint by
        default) into the model, bf16 at rest for a bf16 model; without a
        checkpoint the model keeps a seeded random init, as the JAX
        entries do (another random draw)."""
        path = self._args.get("checkpoint_path")
        if path is None and self._model_dir:
            path = ckpt_lib.latest_checkpoint(self._model_dir)
        if path is None:
            logging.warning("No checkpoint found; using random init.")
            self._model.init_params(torch.Generator().manual_seed(0))
            return cast_params_for_inference(
                self._model, self._model.args.get("dtype"))
        restore_inference_params(self._model,
                                 ckpt_lib.restore_checkpoint_params(path))
        logging.info("Restored %s model from %s", type(self).__name__, path)
        return self._model


build_exp, register_exp = setup_registry("entry", base_class=BaseExperiment)
