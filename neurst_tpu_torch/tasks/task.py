"""Task base and registry (the port's copy of
``neurst_tpu/tasks/task.py``).

A Task binds the data layer to the model's inputs:
``get_data_preprocess_fn`` (raw example -> projected features),
``create_batch_iterator`` (dataset -> numpy batches), ``example_to_input``
(batch -> model input dict), ``build_model`` (a registry model bound to
the task's vocabulary metas) and ``get_eval_metric``.
"""

from typing import Callable, Optional

from neurst_tpu_torch.layers.quantization.quant_layers import (
    get_global_config, quant_enabled)
from neurst_tpu_torch.utils.compat import DataStatus
from neurst_tpu_torch.utils.flags_core import COMMON_DATA_ARGS
from neurst_tpu_torch.utils.registry import setup_registry

__all__ = ["Task", "build_task", "register_task"]


class Task(object):

    def __init__(self, args=None):
        self._args = dict(args or {})

    @property
    def args(self):
        return self._args

    @staticmethod
    def class_or_method_args():
        return list(COMMON_DATA_ARGS)

    def get_config(self) -> dict:
        """The task's serializable configuration (for
        ``model_configs.yml``)."""
        return {}

    def model_configs(self, model) -> dict:
        """Everything needed to rebuild the task and the model: the
        ``model_configs.yml`` a trainer writes and both packages read,
        with the quantization config under QAT (``enable_quant``,
        ``quant_params``), so predict rebuilds the QAT layers."""
        cfg = {"task.class": type(self).__name__,
               "task.params": self.get_config(),
               "model.class": type(model).__name__,
               "model.params": dict(model.args)}
        if quant_enabled():
            qcfg = get_global_config()
            qcfg.pop("enable_quant", None)
            cfg["enable_quant"] = True
            cfg["quant_params"] = qcfg
        return cfg

    def build_model(self, args, name=None, **kwargs):
        raise NotImplementedError

    def get_data_preprocess_fn(self, mode, data_status=DataStatus.RAW,
                               args: Optional[dict] = None) -> Callable:
        raise NotImplementedError

    def get_data_postprocess_fn(self, data_status, **kwargs) -> Callable:
        return lambda x: x

    def example_to_input(self, batch_of_data: dict, mode) -> dict:
        raise NotImplementedError

    def create_batch_iterator(self, ds, mode, args: Optional[dict] = None,
                              num_replicas_in_sync: int = 1,
                              shard_id: int = 0, total_shards: int = 1):
        """A zero-arg callable producing an iterator of numpy batches
        (model inputs, through ``example_to_input``)."""
        raise NotImplementedError

    def get_eval_metric(self, args, name="metric", ds=None):
        raise NotImplementedError

    def eval_targets(self, dataset):
        """Reference targets for generation eval: the dataset's."""
        return getattr(dataset, "raw_targets", None) \
            or getattr(dataset, "targets", None)


build_task, register_task = setup_registry("task", base_class=Task)
