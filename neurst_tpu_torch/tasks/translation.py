"""The translation task (the port's copy of
``neurst_tpu/tasks/translation.py``): ``Seq2Seq`` with the recipes'
``gpu_efficient_level`` (0-5), which picks ``pad_length_multiple`` (8, 8,
16, 32, 64, 64) where that flag is not given."""

from neurst_tpu_torch.tasks.seq2seq import Seq2Seq
from neurst_tpu_torch.tasks.task import register_task
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["Translation"]

_LEVEL_TO_MULTIPLE = {0: 8, 1: 8, 2: 16, 3: 32, 4: 64, 5: 64}


@register_task("translation")
class Translation(Seq2Seq):

    def __init__(self, args=None):
        super().__init__(args)
        level = self._args.get("gpu_efficient_level")
        if self._args.get("pad_length_multiple") is None \
                and level is not None:
            self._args["pad_length_multiple"] = _LEVEL_TO_MULTIPLE.get(
                int(level), 8)

    @staticmethod
    def class_or_method_args():
        return Seq2Seq.class_or_method_args() + [
            Flag("gpu_efficient_level", dtype=Flag.TYPE.INTEGER, default=None,
                 help="The recipes' knob (0-5) for pad_length_multiple "
                      "{8, 8, 16, 32, 64, 64}."),
            Flag("pad_length_multiple", dtype=Flag.TYPE.INTEGER, default=8,
                 help="Pad sequence dims to this multiple (bounds the set "
                      "of batch shapes)."),
            Flag("auto_scaling_batch_size", dtype=Flag.TYPE.BOOLEAN,
                 default=None,
                 help="Kept for recipe compatibility (no-op: one device)."),
        ]
