"""Criterion base and registry (counterpart of
``neurst_tpu/criterions/criterion.py``)."""

import torch

from neurst_tpu_torch.utils.registry import setup_registry

__all__ = ["Criterion", "build_criterion", "register_criterion"]


class Criterion(object):
    """Maps (model_inp, model_out) -> per-sample loss statistics."""

    def __init__(self, args=None):
        self._args = dict(args or {})

    @staticmethod
    def class_or_method_args():
        return []

    def __call__(self, model_inp: dict, model_out):
        """Returns a tuple of per-sample statistics tensors."""
        raise NotImplementedError

    def reduce_loss(self, model_inp: dict, model_out):
        """Scalar training loss."""
        raise NotImplementedError

    def reduce_loss_terms(self, model_inp: dict, model_out):
        """(loss_sum, denom): the loss over several micro-batches is
        sum(loss_sums) / sum(denoms).  Criterions that normalize by a
        batch-dependent count override this; by default every
        micro-batch weighs the same, (reduce_loss, 1)."""
        loss = self.reduce_loss(model_inp, model_out)
        return loss, torch.ones((), dtype=torch.float32, device=loss.device)

    def reduce_metrics(self, eval_res_list) -> dict:
        """Aggregates the statistics of many batches into metrics."""
        raise NotImplementedError

    def reduce_sample_metrics(self, eval_res) -> list:
        """Per-sample metric dicts of one batch's statistics (for the
        ``sequence_evaluator`` entry)."""
        raise NotImplementedError

    def as_metric(self):
        """The Metric a validator selects checkpoints by."""
        raise NotImplementedError


build_criterion, register_criterion = setup_registry(
    "criterion", base_class=Criterion,
    create_fn=lambda cls, args: cls(args))
