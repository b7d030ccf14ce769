"""Compound-split tokenized BLEU (the port's copy of
``neurst_tpu/metrics/compound_split_bleu.py``): fairseq's convention for
WMT en-de, a dash between two non-space characters becomes
``##AT##-##AT##`` between spaces before BLEU is taken."""

import re

from neurst_tpu_torch.metrics.bleu import BLEU
from neurst_tpu_torch.metrics.metric import register_metric

__all__ = ["CompoundSplitBleu", "compound_split"]


def compound_split(text: str) -> str:
    """'rich-text' -> 'rich ##AT##-##AT## text'."""
    return re.sub(r"(\S)-(\S)", r"\1 ##AT##-##AT## \2", text)


@register_metric("compound_split_bleu")
class CompoundSplitBleu(BLEU):

    def __init__(self, args=None, language="en"):
        super().__init__(args, language)
        self._flag = "CompoundSplitBleu"

    def call(self, hypothesis, groundtruth=None):
        hyp = [compound_split(h) for h in hypothesis]
        if groundtruth and isinstance(groundtruth[0], (list, tuple)):
            refs = [[compound_split(r) for r in rs] for rs in groundtruth]
        else:
            refs = [compound_split(r) for r in groundtruth]
        out = super().call(hyp, refs)
        return {"CompoundSplitBleu": out["BLEU"],
                "UncasedCompoundSplitBleu": out["UncasedBLEU"]}
