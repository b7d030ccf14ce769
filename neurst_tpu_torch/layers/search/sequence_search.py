"""Sequence search base and registry (counterpart of
``neurst_tpu/layers/search/sequence_search.py``).  A search layer binds
to a model and maps inputs to hypotheses; the model owns its weights,
so a search is called with the inputs alone."""

from neurst_tpu_torch.utils.registry import setup_registry

__all__ = ["SequenceSearch", "build_search_layer", "register_search_layer"]


class SequenceSearch(object):

    def __init__(self, args=None):
        self.args = dict(args or {})
        self.model = None

    @staticmethod
    def class_or_method_args():
        return []

    def set_model(self, model):
        self.model = model

    def prepare(self):
        """Host-side setup before the first batch (a draft model's
        restore)."""

    def __call__(self, inputs: dict):
        """Returns (hypotheses [B * top_k, L], scores [B * top_k])."""
        raise NotImplementedError


build_search_layer, register_search_layer = setup_registry(
    "search_method", base_class=SequenceSearch)
