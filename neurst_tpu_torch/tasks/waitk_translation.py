"""The wait-k translation task (the port's counterpart of
``neurst_tpu/tasks/waitk_translation.py``): ``translation`` that forwards
``wait_k`` to the model build (``waitk_transformer`` by default) and
gives each TRAIN batch a 0-d int32 ``waitk_lagging`` field, drawn from
the configured laggings.  The draws come from a ``numpy.random.Generator``
that ``create_batch_iterator`` seeds with the TRAIN batch args' ``seed``
(the trainer's), where the JAX task uses the global ``random`` module."""

import numpy as np

from neurst_tpu_torch.models.waitk_transformer import wait_k_choices
from neurst_tpu_torch.tasks.task import register_task
from neurst_tpu_torch.tasks.translation import Translation
from neurst_tpu_torch.utils.compat import ModeKeys
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["WaitkTranslation"]


@register_task("waitk_translation")
class WaitkTranslation(Translation):

    def __init__(self, args=None):
        super().__init__(args)
        self._wait_k = wait_k_choices(self._args.get("wait_k", 3))
        self._lagging_rng = None  # seeded by a TRAIN batch iterator

    @staticmethod
    def class_or_method_args():
        return Translation.class_or_method_args() + [
            Flag("wait_k", dtype=Flag.TYPE.STRING, default=3,
                 help="The wait-k lagging (int or list for training-time "
                      "sampling)."),
        ]

    def get_config(self):
        cfg = super().get_config()
        cfg["wait_k"] = self._wait_k
        return cfg

    def build_model(self, args, name=None, **kwargs):
        params = dict(args.get("model.params") or {})
        params.setdefault("wait_k", self._wait_k if len(self._wait_k) > 1
                          else self._wait_k[0])
        return super().build_model(
            {"model.class": args.get("model.class") or "waitk_transformer",
             "model.params": params}, name=name, **kwargs)

    def create_batch_iterator(self, ds, mode, args=None,
                              num_replicas_in_sync=1, shard_id=0,
                              total_shards=1):
        if mode == ModeKeys.TRAIN:
            self._lagging_rng = np.random.default_rng(
                int((args or {}).get("seed") or 0))
        return super().create_batch_iterator(
            ds, mode, args, num_replicas_in_sync, shard_id, total_shards)

    def example_to_input(self, batch_of_data, mode):
        input_dict = super().example_to_input(batch_of_data, mode)
        if mode == ModeKeys.TRAIN:
            input_dict["waitk_lagging"] = np.asarray(
                self._wait_k[self._lagging_rng.integers(len(self._wait_k))],
                np.int32)
        return input_dict
