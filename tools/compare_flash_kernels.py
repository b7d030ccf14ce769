#!/usr/bin/env python3
"""Times the flash-attention kernels of several checkouts of the port on
one NVIDIA GPU, in turns, with this checkout's ``chip_smoke.py`` phases.

    python3 tools/compare_flash_kernels.py ROOT [ROOT ...] [--seed N]

Each ROOT is the root directory of a checkout (``.`` for this one; an
older commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  For each ROOT, in the order given, a fresh
process imports ``neurst_tpu_torch`` from it, builds its flash kernels
there and runs ``flash_fwd_kernel_phase``, ``flash_bwd_kernel_phase``
and ``flash_dropout_kernel_phase``: every case checks the kernel against
its plain version on the same inputs and times kernel, plain version,
SDPA and bound.  Give the roots as parent, change, change, parent to
compare two commits on one card.  Each phase row is printed as one JSON
line tagged with its run; then one line per run with the bf16 kernel
times by (kernel, case, dropout), and last the card's name and power
limit.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _one(root, seed):
    """Runs the flash phases against the package under ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("compare_flash_kernels: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from neurst_tpu_torch.ops import _build
    seconds = _build.build(["flash_attention_fwd", "flash_attention_bwd"])
    print(json.dumps({"built": {k: round(v, 2) for k, v in seconds.items()},
                      "package": os.path.dirname(_build.CSRC_DIR)}),
          flush=True)
    smoke.flash_fwd_kernel_phase(seed)
    smoke.flash_bwd_kernel_phase(seed)
    smoke.flash_dropout_kernel_phase(seed)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("roots", nargs="+")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--one", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.one:
        return _one(args.roots[0], args.seed)
    for i, root in enumerate(args.roots):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root,
             "--seed", str(args.seed)], capture_output=True, text=True,
            check=False, timeout=1200)
        sys.stderr.write(out.stderr[-4000:])
        times = {}
        for line in out.stdout.splitlines():
            if not line.startswith("{"):
                print(line, flush=True)
                continue
            row = json.loads(line)
            print(json.dumps({"run": i, "root": root, **row}), flush=True)
            if row.get("dtype") == "bfloat16":
                times[f"{row['kernel']} {row['case']} dropout "
                      f"{row.get('dropout', 0.0)}"] = row["kernel_ms"]
        print(json.dumps({"run": i, "root": root, "rc": out.returncode,
                          "bf16_kernel_ms": times}), flush=True)
        if out.returncode != 0:
            return out.returncode
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
