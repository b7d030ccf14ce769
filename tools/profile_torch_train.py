#!/usr/bin/env python3
"""Where one training step of the PyTorch port spends its time, on one
NVIDIA GPU.

    python3 tools/profile_torch_train.py [--seed N] [--steps N]

Builds the training slice that ``chip_smoke.py`` drives
(speech_transformer_s, encoder flash attention, bf16 with bf16 stored
params and an f32 master, dropout 0, 40 x 3000 frames, target 150),
runs two warm-up steps, then profiles whole steps with
``torch.profiler``.  For each step it prints one JSON line: wall time
(host clock, synchronised), device kernel time (the sum of the CUDA
kernels' durations), the device's busy share, the number of kernels
launched, the device time of the port's own kernels and the forty
kernels with the most device time.  The last line names the card and
its power limit.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from profile_torch_decode import _profile  # noqa: E402

# substrings of the CUDA kernel names of the port's hand-written kernels
OWN_KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel",
               "linear_xent_fwd_kernel", "linear_xent_dx_kernel",
               "linear_xent_dw_kernel")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=2)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs an NVIDIA GPU")
    import chip_smoke

    t = chip_smoke.TRAIN
    _, _, _, state, step = chip_smoke.build_train(args.seed)
    rng = np.random.RandomState(args.seed + 5)
    batches = [chip_smoke.train_batch(rng, "cuda", t["batch"], t["frames"],
                                      t["min_src"], t["trg_len"],
                                      t["min_trg"])
               for _ in range(2 + args.steps)]
    for batch in batches[:2]:
        state, _ = step(state, batch)
    for i, batch in enumerate(batches[2:]):
        (state, _), row = _profile(lambda: step(state, batch), top=40,
                                   own=OWN_KERNELS)
        print(json.dumps(dict(step=i, **row)), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"device": smi}))


if __name__ == "__main__":
    sys.exit(main())
