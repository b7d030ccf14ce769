"""Lists a checkpoint's parameters: name, shape, dtype and norm (the
port's copy of ``neurst_tpu/cli/inspect_checkpoint.py``; host-only).
Takes a ``.npz`` checkpoint, a ``.orbax`` directory or a model dir (its
newest checkpoint of either format).

Usage:
    python -m neurst_tpu_torch.cli.inspect_checkpoint CKPT_OR_DIR \\
        [--pattern REGEX] [--values]
"""

import argparse
import os
import re

import numpy as np

from neurst_tpu_torch.utils.checkpoints import (latest_checkpoint,
                                                restore_checkpoint_params)


def main(argv=None):
    p = argparse.ArgumentParser(description="Inspect a checkpoint.")
    p.add_argument("checkpoint",
                   help="Path to a .npz / .orbax checkpoint or dir.")
    p.add_argument("--pattern", default=None,
                   help="Only show names matching this regex.")
    p.add_argument("--values", action="store_true",
                   help="Print tensor values (small tensors only).")
    args = p.parse_args(argv)

    path = args.checkpoint
    if os.path.isdir(path) and not path.rstrip("/").endswith(".orbax"):
        path = latest_checkpoint(path)
        if path is None:
            raise FileNotFoundError(f"no checkpoint in {args.checkpoint}")
    flat = restore_checkpoint_params(path)
    pat = re.compile(args.pattern) if args.pattern else None
    total = 0
    for name in sorted(flat):
        if pat and not pat.search(name):
            continue
        arr = flat[name]
        total += arr.size
        print(f"{name}  shape={list(arr.shape)} dtype={arr.dtype} "
              f"norm={float(np.linalg.norm(arr)):.4f}")
        if args.values and arr.size <= 32:
            print("   ", arr)
    print(f"Total parameters: {total} ({total / 1e6:.2f}M)")


if __name__ == "__main__":
    main()
