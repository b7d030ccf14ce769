"""Metric protocol and registry (the port's copy of
``neurst_tpu/metrics/metric.py``): a metric scores hypotheses against
references, and names its primary value (``flag``) and which of two
results is better, which the validators use to pick checkpoints."""

from neurst_tpu_torch.utils.registry import setup_registry

__all__ = ["Metric", "MetricWrapper", "build_metric", "register_metric"]


class Metric(object):
    """A named scalar (or dict of scalars) quality measure."""

    def __init__(self, args=None):
        self._args = dict(args or {})
        self._flag = None

    @property
    def flag(self):
        """The key of the primary value, used for model selection."""
        return self._flag

    @staticmethod
    def class_or_method_args():
        return []

    def greater_or_eq(self, result1, result2) -> bool:
        """Whether result1 is at least as good as result2 (higher is
        better unless a metric says otherwise)."""
        return self.get_value(result1) >= self.get_value(result2)

    def get_value(self, result) -> float:
        if isinstance(result, dict):
            return float(result[self.flag])
        return float(result)

    def call(self, hypothesis, groundtruth) -> dict:
        raise NotImplementedError

    def __call__(self, hypothesis, groundtruth) -> dict:
        """{name: value} of hypotheses against references."""
        return self.call(hypothesis, groundtruth)


class MetricWrapper(Metric):
    """A loss-like value (a criterion's NLL) in the Metric protocol."""

    def __init__(self, flag: str, greater_is_better: bool = False):
        super().__init__({})
        self._flag = flag
        self._greater_is_better = greater_is_better

    def greater_or_eq(self, result1, result2):
        v1, v2 = self.get_value(result1), self.get_value(result2)
        return v1 >= v2 if self._greater_is_better else v1 <= v2

    def call(self, hypothesis, groundtruth):
        raise NotImplementedError("MetricWrapper holds external values")


build_metric, register_metric = setup_registry("metric", base_class=Metric)
