"""Checkpoint converters (the port's copy of
``neurst_tpu/utils/converters/converter.py``).

A Converter maps a public checkpoint (fairseq, Google BERT, OpenAI GPT-2,
wav2vec 2.0, or the original NeurST's TensorFlow Transformer) to the
JAX package's flat name -> array mapping, which the port's
``utils/param_bridge`` loads and its ``pretrain_model`` restore reads.
``convert`` writes that mapping as a ``ckpt-N.npz`` + ``checkpoint.json``
directory, the same files the JAX package's converter writes, so either
package reads it.
"""

from typing import Dict

import numpy as np

from neurst_tpu_torch.utils.registry import setup_registry

__all__ = ["Converter", "build_converter", "register_converter"]


class Converter(object):

    def __init__(self, args=None):
        self._args = dict(args or {})

    @staticmethod
    def class_or_method_args():
        return []

    def convert_to_flat(self, from_path: str) -> Dict[str, np.ndarray]:
        """Loads the foreign checkpoint and returns the flat mapping."""
        raise NotImplementedError

    def convert(self, from_path: str, to_path: str, step: int = 0):
        """Foreign checkpoint -> an npz checkpoint dir.  Returns its
        path."""
        from neurst_tpu_torch.utils.checkpoints import (save_checkpoint,
                                                        unflatten_params)
        flat = self.convert_to_flat(from_path)
        return save_checkpoint(to_path, step, unflatten_params(flat),
                               max_to_keep=None)

    @staticmethod
    def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
        """A .pt/.bin torch checkpoint as numpy arrays (a nested "model",
        "state_dict" or "model_state_dict" dict is taken)."""
        import torch

        # fairseq checkpoints pickle their training args (an argparse
        # Namespace or omegaconf config) beside the weights, which the
        # weights-only unpickler refuses; the JAX package loads them the
        # same way
        state = torch.load(path, map_location="cpu", weights_only=False)
        for key in ("model", "state_dict", "model_state_dict"):
            if isinstance(state, dict) and key in state \
                    and isinstance(state[key], dict):
                state = state[key]
                break
        return {k: np.asarray(v.detach().cpu().numpy())
                if hasattr(v, "detach") else np.asarray(v)
                for k, v in state.items()
                if hasattr(v, "shape") or isinstance(v, np.ndarray)}


def _create_converter(cls, args, **kwargs):
    return cls(args, **kwargs)


build_converter, register_converter = setup_registry(
    "converter", base_class=Converter, create_fn=_create_converter)
