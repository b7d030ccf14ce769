"""PruneTune mask-aware generation, a plug-in reached through
``--include`` (the port's counterpart of
``examples/prune_tune/src/mask_sequence_generator.py``; entries
``mask_predict`` and ``mask_generation``).

The restored weights are multiplied by a mask, so the network decoded is
exactly the masked subnetwork the recipe trained.  The mask comes from
``--mask_pkl`` (a pickle or ``.npz`` of {flat parameter name: mask} in
the JAX package's names and layouts) or ``--mask_from_ckpt`` (a pruned
general-domain model dir: its nonzero weights).

Usage:
    python -m neurst_tpu_torch.cli.run_exp --entry mask_predict \\
        --include neurst_tpu_torch/contrib/prune_tune/mask_sequence_generator.py \\
        --mask_from_ckpt general_model_dir ... (the predict flags)
"""

import logging
import pickle

import numpy as np
import torch

from neurst_tpu_torch.exps.base_experiment import register_exp
from neurst_tpu_torch.exps.sequence_generator import SequenceGenerator
from neurst_tpu_torch.utils import checkpoints as ckpt_lib
from neurst_tpu_torch.utils.flags_core import Flag
from neurst_tpu_torch.utils.param_bridge import to_torch_layout

__all__ = ["MaskSequenceGenerator", "load_mask"]


def load_mask(path: str):
    """{flat name: mask} from a ``.npz`` or a pickled dict."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: np.asarray(data[k]) for k in data.files}
    with open(path, "rb") as f:
        loaded = pickle.load(f)
    if not isinstance(loaded, dict):
        raise ValueError("mask_pkl must hold a {param_name: mask} dict")
    return {k: np.asarray(v) for k, v in loaded.items()}


@register_exp("mask_predict", "mask_generation")
class MaskSequenceGenerator(SequenceGenerator):
    """Sequence generation with a parameter mask applied after the
    restore."""

    def __init__(self, args, **kwargs):
        super().__init__(args, **kwargs)
        flat = None
        if self._args.get("mask_pkl"):
            logging.info("Loading mask from %s", self._args["mask_pkl"])
            flat = load_mask(self._args["mask_pkl"])
        elif self._args.get("mask_from_ckpt"):
            path = ckpt_lib.latest_checkpoint(self._args["mask_from_ckpt"])
            logging.info("Deriving mask from pruned checkpoint %s", path)
            flat = {name: (np.asarray(w) != 0.0).astype(np.float32)
                    for name, w in
                    ckpt_lib.restore_checkpoint_params(path).items()}
        self._masks = None if flat is None else to_torch_layout(flat)

    @staticmethod
    def class_or_method_args():
        return SequenceGenerator.class_or_method_args() + [
            Flag("mask_pkl", dtype=Flag.TYPE.STRING, default=None,
                 help="Path to a {param_name: mask} pickle/.npz file."),
            Flag("mask_from_ckpt", dtype=Flag.TYPE.STRING, default=None,
                 help="Derive the mask from this pruned checkpoint dir "
                      "(mask = weight != 0)."),
        ]

    def restore_params(self):
        model = super().restore_params()
        if self._masks is None:
            return model
        applied = 0
        with torch.no_grad():
            for name, p in model.named_parameters():
                mask = self._masks.get(name)
                if mask is not None:
                    p.mul_(torch.from_numpy(mask).to(p.device, p.dtype))
                    applied += 1
        logging.info("mask applied to %d params (%d unmasked)", applied,
                     sum(1 for _ in model.parameters()) - applied)
        return model
