#!/usr/bin/env python3
"""Times the kernels of several checkouts of the port on one NVIDIA GPU,
in turns, with this checkout's ``chip_smoke.py`` phases.

    python3 tools/compare_flash_kernels.py ROOT [ROOT ...] [--seed N]
        [--phases flash,dropout,ffn,xent]

Each ROOT is the root directory of a checkout (``.`` for this one; an
older commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  For each ROOT, in the order given, a fresh
process imports ``neurst_tpu_torch`` from it, builds the kernels of the
named phases there and runs their ``chip_smoke.py`` kernel phases:
``flash`` (the default) runs ``flash_fwd_kernel_phase``,
``flash_bwd_kernel_phase`` and ``flash_dropout_kernel_phase``;
``dropout`` runs ``dropout_kernel_phase``; ``ffn`` runs
``ffn_kernel_phase``; ``xent`` runs ``xent_kernel_phase`` (the fused
linear xent); ``dispatch`` runs ``dispatch_phase`` (the host time a call
of the flash and fused-FFN forward wrappers); ``slice`` runs
``slice_phase`` (the speech decode requests).  Every case checks the kernel against its plain
version on the same inputs and times kernel, plain version, library call
(or composite) and bound.  Give the roots as parent, change, change,
parent to compare two commits on one card.  Each phase row is printed as
one JSON line tagged with its run; then one line per run with the bf16
kernel times by (kernel, case, rate), and last the card's name and power
limit.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# phase -> (kernel sources to build, chip_smoke phase functions)
PHASES = {
    "flash": (["flash_attention_fwd", "flash_attention_bwd"],
              ["flash_fwd_kernel_phase", "flash_bwd_kernel_phase",
               "flash_dropout_kernel_phase"]),
    "dropout": (["fused_dropout"], ["dropout_kernel_phase"]),
    "ffn": (["fused_ffn"], ["ffn_kernel_phase"]),
    "xent": (["fused_linear_xent"], ["xent_kernel_phase"]),
    "dispatch": (["flash_attention_fwd", "fused_ffn"], ["dispatch_phase"]),
    "slice": (["flash_attention_fwd"], ["slice_phase"]),
}


def _one(root, seed, phases):
    """Runs the named phases against the package under ``root``."""
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
    seconds = _build.build([name for p in phases for name in PHASES[p][0]])
    print(json.dumps({"built": {k: round(v, 2) for k, v in seconds.items()},
                      "package": os.path.dirname(_build.CSRC_DIR)}),
          flush=True)
    for p in phases:
        for fn in PHASES[p][1]:
            getattr(smoke, fn)(seed)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("roots", nargs="+")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--phases", default="flash",
                        help="comma-separated, of " + ", ".join(PHASES))
    parser.add_argument("--one", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown or not phases:
        parser.error(f"--phases: unknown {sorted(unknown)}; choose from "
                     f"{', '.join(PHASES)}")
    if args.one:
        return _one(args.roots[0], args.seed, phases)
    for i, root in enumerate(args.roots):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root,
             "--seed", str(args.seed), "--phases", ",".join(phases)],
            capture_output=True, text=True, check=False, timeout=1200)
        sys.stderr.write(out.stderr[-4000:])
        times = {}
        for line in out.stdout.splitlines():
            if not line.startswith("{"):
                print(line, flush=True)
                continue
            row = json.loads(line)
            print(json.dumps({"run": i, "root": root, **row}), flush=True)
            if row.get("dtype") == "bfloat16" and "kernel" in row:
                key = f"{row['kernel']} {row['case']}"
                if row["kernel"] != "fused_dropout":  # always rate 0.1
                    key += f" rate {row.get('dropout', row.get('rate', 0.0))}"
                times[key] = row["kernel_ms"]
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
