"""Loading pretrained trunks (the port's copy of
``neurst_tpu/layers/auto_pretrained_layer.py``).

``load_pretrained_flat`` converts a local HuggingFace or fairseq torch
checkpoint through the matching converter (``utils/converters``) into
the JAX package's flat names; ``load_pretrained_into`` fills a port
model's parameters with it by name, optionally under a sub-tree prefix:
``to_prefix="bert/"`` fills CTNMT's ``bert`` trunk, whose names the
converter writes without the prefix.
"""

import logging
from typing import Optional

__all__ = ["load_pretrained_flat", "load_pretrained_into"]

_CONVERTER_BY_KIND = {
    "bert": "google_bert",
    "gpt2": "openai_gpt2",
    "wav2vec2": "fairseq_wav2vec2",
    "fairseq": "fairseq_transformer",
}


def load_pretrained_flat(checkpoint_path: str, kind: str,
                         num_heads: Optional[int] = None) -> dict:
    """A torch checkpoint -> the flat name -> array mapping."""
    from neurst_tpu_torch.utils.converters import build_converter
    params = {}
    if num_heads:
        params["num_heads"] = num_heads
    converter = build_converter({
        "converter.class": _CONVERTER_BY_KIND.get(kind, kind),
        "converter.params": params})
    return converter.convert_to_flat(checkpoint_path)


def load_pretrained_into(model, checkpoint_path: str, kind: str,
                         num_heads: Optional[int] = None,
                         to_prefix: Optional[str] = None):
    """Fills ``model``'s parameters (a port model, in place) from the
    pretrained trunk by name, the names under ``to_prefix`` where given.
    Returns the JAX names restored."""
    from neurst_tpu_torch.utils.checkpoints import restore_into
    flat = load_pretrained_flat(checkpoint_path, kind, num_heads)
    if to_prefix:
        flat = {to_prefix + name: value for name, value in flat.items()}
    restored, _ = restore_into(model, flat)
    logging.info("Grafted %d pretrained parameters from %s", len(restored),
                 checkpoint_path)
    return restored
