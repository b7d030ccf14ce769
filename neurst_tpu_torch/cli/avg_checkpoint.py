"""Offline checkpoint averaging (the port's copy of
``neurst_tpu/cli/avg_checkpoint.py``):

    python -m neurst_tpu_torch.cli.avg_checkpoint --model_dir D \\
        [--last_n 5] --output_dir OUT
    python -m neurst_tpu_torch.cli.avg_checkpoint --checkpoint_paths \\
        D/ckpt-6.npz D/ckpt-12.orbax --output_dir OUT

writes the element-wise mean as ``OUT/ckpt-<newest step>.npz`` and copies
the model dir's ``model_configs.yml`` beside it, so the predict entry
reads ``OUT`` as it is.
"""

import argparse
import logging
import os
import shutil

from neurst_tpu_torch.utils.checkpoints import (average_checkpoints,
                                                checkpoint_path,
                                                list_checkpoints,
                                                save_checkpoint)
from neurst_tpu_torch.utils.configurable import MODEL_CONFIG_YAML_FILENAME


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="Average checkpoints.")
    p.add_argument("--checkpoint_paths", nargs="+", default=None,
                   help="Explicit .npz / .orbax checkpoint paths to "
                        "average.")
    p.add_argument("--model_dir", default=None,
                   help="Average the latest N checkpoints in this dir.")
    p.add_argument("--last_n", type=int, default=5,
                   help="How many latest checkpoints to average.")
    p.add_argument("--output_dir", required=True,
                   help="Where to write the averaged checkpoint.")
    args = p.parse_args(argv)

    paths = args.checkpoint_paths
    if not paths:
        if not args.model_dir:
            raise ValueError("Provide --checkpoint_paths or --model_dir")
        paths = [checkpoint_path(args.model_dir, s)
                 for s in list_checkpoints(args.model_dir)[-args.last_n:]]
    logging.info("Averaging %d checkpoints: %s", len(paths), paths)
    step = max(int(os.path.basename(p).split("-")[1].split(".")[0])
               for p in paths)
    save_checkpoint(args.output_dir, step, average_checkpoints(paths),
                    max_to_keep=None)
    # the averaged dir is self-contained
    if args.model_dir:
        config = os.path.join(args.model_dir, MODEL_CONFIG_YAML_FILENAME)
        if os.path.exists(config):
            shutil.copy(config, os.path.join(args.output_dir,
                                             MODEL_CONFIG_YAML_FILENAME))
    logging.info("Averaged checkpoint written to %s", args.output_dir)


if __name__ == "__main__":
    main()
