"""Mode keys and data status (the port's copy of the part of
``neurst_tpu/utils/compat.py`` the predict path uses)."""

__all__ = ["ModeKeys", "DataStatus"]


class ModeKeys(object):
    TRAIN = "train"
    EVAL = "eval"
    INFER = "infer"


class DataStatus(object):
    """Lifecycle of a data field:
    RAW -> (tokenize/extract) PROCESSED -> (map to ids/features) PROJECTED."""
    RAW = "raw"
    PROCESSED = "processed"
    PROJECTED = "projected"
