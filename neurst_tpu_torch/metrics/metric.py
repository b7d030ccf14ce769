"""Metric protocol and registry (the port's copy of the part of
``neurst_tpu/metrics/metric.py`` the predict entry uses; the validators'
model-selection helpers wait for the trainer)."""

from neurst_tpu_torch.utils.registry import setup_registry

__all__ = ["Metric", "build_metric", "register_metric"]


class Metric(object):
    """A named scalar (or dict of scalars) quality measure."""

    def __init__(self, args=None):
        self._args = dict(args or {})

    @staticmethod
    def class_or_method_args():
        return []

    def call(self, hypothesis, groundtruth) -> dict:
        raise NotImplementedError

    def __call__(self, hypothesis, groundtruth) -> dict:
        """{name: value} of hypotheses against references."""
        return self.call(hypothesis, groundtruth)


build_metric, register_metric = setup_registry("metric", base_class=Metric)
