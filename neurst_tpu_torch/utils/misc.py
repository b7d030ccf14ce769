"""Small helpers the CLIs share (the port's copy of the part of
``neurst_tpu/utils/misc.py`` they import)."""

import time

import numpy as np

from neurst_tpu_torch.utils.configurable import \
    flatten_string_list  # noqa: F401 - re-exported

__all__ = ["to_numpy_or_python_type", "flatten_string_list", "PseudoPool",
           "Timer"]


def to_numpy_or_python_type(tensors):
    """Converts (nested) tensors and arrays to numpy arrays and Python
    scalars."""
    def _convert(t):
        if type(t).__module__.startswith("torch"):
            t = t.detach().cpu().numpy()
        if isinstance(t, np.ndarray):
            return t.item() if t.ndim == 0 else t
        if isinstance(t, np.generic):
            return t.item()
        return t
    if isinstance(tensors, dict):
        return {k: to_numpy_or_python_type(v) for k, v in tensors.items()}
    if isinstance(tensors, (list, tuple)):
        return type(tensors)(to_numpy_or_python_type(v) for v in tensors)
    return _convert(tensors)


class PseudoPool(object):
    """Serial stand-in for multiprocessing.Pool (one-CPU hosts,
    debugging)."""

    def __init__(self, processes=None):
        self._processes = processes

    def map(self, fn, iterable):
        return [fn(x) for x in iterable]

    def imap(self, fn, iterable):
        for x in iterable:
            yield fn(x)

    def close(self):
        pass

    def join(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *args):
        pass


class Timer(object):
    """Context-manager wall-clock timer."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *args):
        self.elapsed = time.perf_counter() - self.start
