"""The validation sidecar entry ``validation`` (the port's copy of
``neurst_tpu/exps/validation.py``): a process beside the trainer that
polls ``model_dir`` every ``waiting_interval`` seconds, restores each new
``ckpt-N.npz`` (or ``ckpt-N.orbax`` directory, the sharded format) in
step order into the model (retrying a checkpoint that does not read yet,
skipping one rotated away) and runs the validator on it; it ends when the
validator asks for an early stop or when no new checkpoint came for
``maximum_waiting_time`` seconds.  The trainer and the sidecar share only
the directory."""

import logging
import os
import time

from neurst_tpu_torch.exps.base_experiment import BaseExperiment, register_exp
from neurst_tpu_torch.training.validator import build_validator
from neurst_tpu_torch.utils import checkpoints as ckpt_lib
from neurst_tpu_torch.utils.flags_core import Flag, ModuleFlag
from neurst_tpu_torch.utils.param_bridge import state_dict_to_flat

__all__ = ["Validation"]


def _read(path, attempts=5, pause_s=5):
    """The checkpoint's flat params; None when it was rotated away or
    does not read after ``attempts`` tries."""
    for attempt in range(attempts):
        try:
            return ckpt_lib.restore_checkpoint_params(path)
        except FileNotFoundError:
            logging.info("checkpoint %s already rotated away; skipping.",
                         path)
            return None
        except Exception as e:  # noqa: BLE001 - a writer may be mid-file
            logging.warning("retry %d reading %s: %s", attempt, path, e)
            time.sleep(pause_s)
    return None


@register_exp("validation")
class Validation(BaseExperiment):

    @staticmethod
    def class_or_method_args():
        return [
            ModuleFlag("validator", "validator",
                       default="seq_generation_validator",
                       help="The validator to run on each checkpoint."),
            Flag("waiting_interval", dtype=Flag.TYPE.INTEGER, default=120,
                 help="Seconds between checkpoint-directory polls."),
            Flag("maximum_waiting_time", dtype=Flag.TYPE.INTEGER,
                 default=3600,
                 help="Give up after this many seconds with no new "
                      "checkpoint."),
        ]

    def run(self):
        args = self._args
        validator = build_validator(args).build(self._task, self._model,
                                                self._model_dir)
        waiting_interval = int(args.get("waiting_interval") or 120)
        max_wait = int(args.get("maximum_waiting_time") or 3600)
        seen = set()
        idle_since = time.time()
        while True:
            steps = [s for s in ckpt_lib.list_checkpoints(self._model_dir)
                     if s not in seen]
            if not steps:
                if time.time() - idle_since > max_wait:
                    logging.info("No new checkpoint for %ds; exiting.",
                                 max_wait)
                    return
                time.sleep(waiting_interval)
                continue
            idle_since = time.time()
            for step in sorted(steps):
                seen.add(step)
                # a sharded-format trainer's checkpoint is a ckpt-N.orbax
                # directory
                flat = _read(ckpt_lib.checkpoint_path(self._model_dir,
                                                      step))
                if flat is None:
                    continue
                ckpt_lib.restore_into(self._model, flat)
                if validator.validate(step, state_dict_to_flat(self._model)):
                    logging.info("Validator requested early stop.")
                    return
