"""Mode keys, data status and the registered initial step (the port's
copy of the part of ``neurst_tpu/utils/compat.py`` the predict and train
paths use)."""

import os
import re
from typing import Optional

__all__ = ["ModeKeys", "DataStatus", "register_initial_step",
           "get_registered_initial_step", "hack_global_step"]


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


_GLOBALS = {}


def register_initial_step(step: int):
    """The step a (resumed) run starts at; schedules built afterwards
    count from it."""
    _GLOBALS["initial_global_step"] = int(step)


def get_registered_initial_step() -> int:
    return int(_GLOBALS.get("initial_global_step", 0))


def hack_global_step(path: str) -> Optional[int]:
    """The global step at the end of a checkpoint file or dir name, e.g.
    ``ckpt-1500`` or ``.../checkpoints/1500``; None without one."""
    if path is None:
        return None
    m = re.search(r"(\d+)$", os.path.basename(str(path).rstrip("/")))
    return int(m.group(1)) if m else None
