"""The wait-k Transformer for simultaneous translation (counterpart of
``neurst_tpu/models/waitk_transformer.py``).

Training masks the cross-attention with a lagging k: target position i
sees source positions < i + k.  ``wait_k`` is an int, or a list (YAML
text or a list) to draw k from per training batch; the task puts the
draw into the batch as the 0-d field ``waitk_lagging``.  Without that
field, and in decoding, the model masks with its ``wait_k`` property,
the smallest configured k.  A monotonic encoder
(``encoder.attention_monotonic``) gives a source prefix the states it
has under the full source, which the streaming interface
(``incremental_encode`` / ``incremental_decode``) rests on.
"""

import numpy as np
import yaml

from neurst_tpu_torch.models.model import register_model
from neurst_tpu_torch.models.transformer import Transformer
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["WaitkTransformer", "wait_k_choices"]


def wait_k_choices(wait_k):
    """The configured laggings as a list of ints: ``wait_k`` an int, a
    list, or the YAML text of either."""
    if isinstance(wait_k, str):
        wait_k = yaml.safe_load(wait_k)
    if isinstance(wait_k, (list, tuple)):
        return [int(k) for k in wait_k]
    return [int(wait_k)]


@register_model("waitk_transformer")
class WaitkTransformer(Transformer):

    @staticmethod
    def class_or_method_args():
        return Transformer.class_or_method_args() + [
            Flag("wait_k", dtype=Flag.TYPE.STRING, default=3,
                 help="The lagging k (int), or a list to sample from "
                      "during training (test-time wait-k)."),
        ]

    def __init__(self, args, src_meta, trg_meta):
        self._wait_k_choices = wait_k_choices(args.get("wait_k", 3))
        super().__init__(args, src_meta, trg_meta)

    @property
    def wait_k(self) -> int:
        """The inference-time lagging (the smallest configured k)."""
        return min(self._wait_k_choices)

    def sample_lagging(self, rng: np.random.Generator) -> int:
        """A training-time lagging drawn from the choices with ``rng``."""
        return int(self._wait_k_choices[rng.integers(
            len(self._wait_k_choices))])

    def decode_lagging_of(self, inputs):
        lagging = inputs.get("waitk_lagging")
        return self.wait_k if lagging is None else lagging

    def decode_step(self, ids, cache, step: int, decode_lagging=None):
        return super().decode_step(
            ids, cache, step, self.wait_k if decode_lagging is None
            else decode_lagging)

    def supports_fused_softmax_ce(self) -> bool:
        """The JAX module overrides its forward without the prelogits
        route (``neurst_tpu/models/encoder_decoder_model.py:383-397``
        gates on that), so a wait-k model trains through its logits in
        both packages."""
        return False

    # ---------------- streaming interface (SimulEval) -------------- #

    def incremental_encode(self, src_prefix, src_padding=None):
        """Encodes a (growing) source prefix [B, S] -> (encoder outputs,
        padding).  With a monotonic encoder the prefix's states equal
        their values under the full source."""
        if src_padding is None:
            src_padding = np.zeros(np.shape(src_prefix), np.float32)
        return self.encode({"src": src_prefix, "src_padding": src_padding})

    def incremental_decode(self, ids, cache, step: int):
        """One decode step against the current encoded prefix."""
        return self.decode_step(ids, cache, step)
