#!/usr/bin/env python3
"""Device time of each launch of the fused FFN forward and backward and
of the fused linear xent forward and backward, on one NVIDIA GPU.

    python3 tools/profile_launches.py [--root ROOT]
        [--kernels ffn_fwd,ffn_bwd,xent_fwd,xent_bwd] [--rows 30000,6000]
        [--dim 256|512] [--xent 6000x8192x256] [--calls N] [--seed N]

Imports ``neurst_tpu_torch`` from ROOT (default: this checkout; an older
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists) and builds its kernels.  For each FFN row count it draws the
inputs of ``chip_smoke.py``'s FFN phase (D ``--dim``, F 2048, bf16, dropout
0.1, the backward fed the forward's hd); for each xent shape (R x V x D)
those of its xent phase (bf16, label smoothing 0.1).  It then profiles N
calls of the wrapper with ``torch.profiler``.  One JSON line a kernel
and shape: the device ms a call of each CUDA kernel it launched (the
passes, the sums, the xent forward's combine) and of all of them.  The
last line names the card and its power limit.
"""

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict


def _per_call(calls, fn):
    """{CUDA kernel name: device ms a call} over ``calls`` calls of fn."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = defaultdict(float)
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            by_name[event.name[:60]] += \
                event.time_range.elapsed_us() / 1e3 / calls
    return dict(by_name)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--kernels",
                        default="ffn_fwd,ffn_bwd,xent_fwd,xent_bwd")
    parser.add_argument("--rows", default="30000,6000")
    parser.add_argument("--dim", type=int, default=256, choices=(256, 512))
    parser.add_argument("--xent", default="6000x8192x256")
    parser.add_argument("--calls", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_launches: needs an NVIDIA GPU")
    from neurst_tpu_torch.ops import fused_ce as fc
    from neurst_tpu_torch.ops import fused_ffn as ff
    from neurst_tpu_torch.utils.rng import DropoutKey

    kernels = args.kernels.split(",")
    package = os.path.abspath(args.root)

    def draw(rng, *shape, scale=1.0, dtype=torch.bfloat16):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(
            np.float32)).to("cuda", dtype)

    dim, filter_size, rate = args.dim, 2048, 0.1
    for rows in (int(r) for r in args.rows.split(",") if r):
        if not {"ffn_fwd", "ffn_bwd"} & set(kernels):
            break
        rng = np.random.RandomState(args.seed + rows)
        x, dy = draw(rng, rows, dim), draw(rng, rows, dim)
        w1 = draw(rng, filter_size, dim, scale=dim ** -0.5)
        w2 = draw(rng, dim, filter_size, scale=filter_size ** -0.5)
        b1 = draw(rng, filter_size, scale=0.1, dtype=torch.float32)
        b2 = draw(rng, dim, scale=0.1, dtype=torch.float32)
        key = DropoutKey(int(rng.randint(2 ** 31)), 7, stream=4)
        _, hd = ff.fused_ffn_fwd(x, w1, b1, w2, b2, rate, key, True)
        scale = ff._drop(rate, key)[1]
        calls = {
            "ffn_fwd": lambda: ff.fused_ffn_fwd(x, w1, b1, w2, b2, rate, key,
                                                True),
            "ffn_bwd": lambda: ff.fused_ffn_bwd(x, w1, w2, hd, dy, scale)}
        for name in ("ffn_fwd", "ffn_bwd"):
            if name in kernels:
                ms = _per_call(args.calls, calls[name])
                print(json.dumps({
                    "kernel": name, "rows": rows, "dim": dim,
                    "filter": filter_size, "dtype": "bfloat16",
                    "rate": rate, "package": package, "ms_per_call": ms,
                    "total_ms_per_call": sum(ms.values())}), flush=True)
    for shape in (s for s in args.xent.split(",") if s):
        if not {"xent_fwd", "xent_bwd"} & set(kernels):
            break
        rows, vocab, d = (int(v) for v in shape.split("x"))
        rng = np.random.RandomState(args.seed + rows)
        x = draw(rng, rows, d)
        w = draw(rng, vocab, d, scale=d ** -0.5)
        bias = draw(rng, vocab, scale=0.1, dtype=torch.float32)
        labels = torch.from_numpy(rng.randint(0, vocab, size=rows).astype(
            np.int32)).cuda()
        g = torch.from_numpy(rng.rand(rows).astype(np.float32)).cuda()
        c, low = 0.9, 0.1 / (vocab - 1)
        _, lse = fc.fused_linear_xent_fwd(x, w, bias, labels, c, low)
        calls = {
            "xent_fwd": lambda: fc.fused_linear_xent_fwd(x, w, bias, labels,
                                                         c, low),
            "xent_bwd": lambda: fc.fused_linear_xent_bwd(
                x, w, bias, labels, lse, g, c, low)}
        for name in ("xent_fwd", "xent_bwd"):
            if name in kernels:
                ms = _per_call(args.calls, calls[name])
                print(json.dumps({
                    "kernel": name, "rows": rows, "vocab": vocab, "dim": d,
                    "dtype": "bfloat16", "package": package,
                    "ms_per_call": ms,
                    "total_ms_per_call": sum(ms.values())}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"device": smi}))


if __name__ == "__main__":
    sys.exit(main())
