#!/usr/bin/env python3
"""Device time of each launch of the fused FFN backward, on one NVIDIA
GPU.

    python3 tools/profile_ffn_bwd.py [--root ROOT] [--rows 30000,6000]
        [--calls N] [--seed N]

Imports ``neurst_tpu_torch`` from ROOT (default: this checkout; an older
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists), builds its fused-FFN kernels, and for each row count draws the
inputs of ``chip_smoke.py``'s FFN phase (D 256, F 2048, bf16, dropout
0.1, the backward fed the forward's hd), then profiles N calls of
``fused_ffn_bwd`` with ``torch.profiler``.  One JSON line a row count:
the device ms a call of each CUDA kernel (the dx pass, the dW pass, the
sum) and of all of them.  The last line names the card and its power
limit.
"""

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--rows", default="30000,6000")
    parser.add_argument("--calls", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("profile_ffn_bwd: needs an NVIDIA GPU")
    from neurst_tpu_torch.ops import fused_ffn as ff
    from neurst_tpu_torch.utils.rng import DropoutKey

    dim, filter_size, rate = 256, 2048, 0.1
    for rows in (int(r) for r in args.rows.split(",")):
        rng = np.random.RandomState(args.seed + rows)

        def draw(*shape, scale=1.0, dtype=torch.bfloat16):
            return torch.from_numpy((scale * rng.randn(*shape)).astype(
                np.float32)).to("cuda", dtype)
        x, dy = draw(rows, dim), draw(rows, dim)
        w1 = draw(filter_size, dim, scale=dim ** -0.5)
        w2 = draw(dim, filter_size, scale=filter_size ** -0.5)
        b1 = draw(filter_size, scale=0.1, dtype=torch.float32)
        b2 = draw(dim, scale=0.1, dtype=torch.float32)
        key = DropoutKey(int(rng.randint(2 ** 31)), 7, stream=4)
        _, hd = ff.fused_ffn_fwd(x, w1, b1, w2, b2, rate, key, True)
        scale = ff._drop(rate, key)[1]
        for _ in range(3):
            ff.fused_ffn_bwd(x, w1, w2, hd, dy, scale)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.calls):
                ff.fused_ffn_bwd(x, w1, w2, hd, dy, scale)
            torch.cuda.synchronize()
        by_name = defaultdict(float)
        for event in prof.events():
            if event.device_type == torch.autograd.DeviceType.CUDA:
                by_name[event.name] += \
                    event.time_range.elapsed_us() / 1e3 / args.calls
        print(json.dumps({"rows": rows, "dim": dim, "filter": filter_size,
                          "dtype": "bfloat16", "rate": rate,
                          "package": os.path.abspath(args.root),
                          "ms_per_call": {k[:60]: v for k, v in
                                          by_name.items()},
                          "total_ms_per_call": sum(by_name.values())}),
              flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"device": smi}))


if __name__ == "__main__":
    sys.exit(main())
