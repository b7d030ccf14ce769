"""DataPipeline base: raw sample <-> model features (the port's copy of
``neurst_tpu/data/data_pipelines/data_pipeline.py``).
"""

import re

from neurst_tpu_torch.data.text.moses_normalize import normalize_punctuation
from neurst_tpu_torch.utils.registry import setup_registry

__all__ = ["DataPipeline", "build_data_pipeline", "register_data_pipeline",
           "lowercase_and_remove_punctuations"]

_PUNC_PATTERN = re.compile(
    r"[,\.\!\(\);:、\?\-\+=\"/><《》\[\]，。：；「」【】{}`@#\$%\^&\*]")


def lowercase_and_remove_punctuations(language, text, lowercase=True,
                                      remove_punctuation=True):
    """Normalizes transcripts before tokenization: optional lowercase,
    Moses punctuation normalization (non-CJK; the port's own normalizer),
    apostrophe re-joining, optional punctuation stripping, whitespace
    collapse."""
    if lowercase:
        text = text.lower()
    if language not in ("zh", "ja"):
        text = normalize_punctuation(text, language)
        for suf in ("s", "ve", "m", "t", "re"):
            text = text.replace(f"' {suf} ", f"'{suf} ")
    if remove_punctuation:
        text = _PUNC_PATTERN.sub(" ", text)
    return " ".join(text.strip().split())


class DataPipeline(object):
    """Converts one raw data sample to projected features and back."""

    def __init__(self, **kwargs):
        self._config = dict(kwargs)

    @property
    def config(self):
        return self._config

    @property
    def meta(self) -> dict:
        """Vocabulary/feature metadata (vocab_size, eos_id, ...)."""
        return {}

    def preprocess(self, input):
        """RAW -> PROCESSED (e.g. tokenization)."""
        return input

    def postprocess(self, input):
        """PROCESSED -> RAW (e.g. detokenization)."""
        return input

    def encode(self, input, is_processed=False):
        """RAW/PROCESSED -> PROJECTED (token ids / feature arrays)."""
        raise NotImplementedError

    def decode(self, input):
        """PROJECTED -> RAW (recovered text)."""
        raise NotImplementedError

    def text_pre_normalize(self, language, text, is_processed=False):
        """Normalization applied before tokenization; honors the
        pipeline's ``lowercase`` / ``remove_punctuation`` config
        (as in the JAX package)."""
        if is_processed or not isinstance(text, str):
            return text
        cfg = getattr(self, "_config", {}) or {}
        if cfg.get("lowercase") or cfg.get("remove_punctuation"):
            return lowercase_and_remove_punctuations(
                language, text, lowercase=bool(cfg.get("lowercase")),
                remove_punctuation=bool(cfg.get("remove_punctuation")))
        text = text.replace("\u2028", " ").replace("\u2029", " ")
        text = re.sub(r"\s+", " ", text).strip()
        return text


build_data_pipeline, register_data_pipeline = setup_registry(
    "data_pipeline", base_class=DataPipeline,
    create_fn=lambda cls, args, **kwargs: cls(**dict(args, **kwargs)))
