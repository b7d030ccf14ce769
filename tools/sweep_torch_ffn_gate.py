#!/usr/bin/env python3
"""Sweeps the port's fused-FFN gate on one NVIDIA GPU: the fused FFN
against the composite at each row count and mode.

    python3 tools/sweep_torch_ffn_gate.py [--dim 256|512]
        [--rows 1024,2048,...] [--modes train,train_drop,infer] [--seed N]

For each mode and row count it builds the layer the model runs
(``layers.common_layers.TransformerFFN``, D 256 (speech_transformer_s)
or 512 (transformer_base), F 2048, bf16 weights and compute) and times
it twice with ``chip_smoke.time_ms`` (device
time), once with the gate forced to the fused kernels and once to the
composite (linear -> relu -> the port's dropout -> linear): in ``train``
(dropout 0) and ``train_drop`` (the recipe's 0.1, with a dropout key)
the forward and the backward through autograd, in ``infer`` the
forward alone with no hidden saved.  One JSON line a (mode, rows): both
times and their ratio; then one line a mode with the smallest measured
row count from which fused wins at every larger count
(``ops.kernel_gates.min_rows_from_sweep``); last the card's name and
power limit.  ``ops/kernel_gates.py`` records the table the gate takes.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ROWS = (1024, 2048, 4096, 6000, 8192, 12000, 16384, 30000, 32768)
RATES = {"train": 0.0, "train_drop": 0.1, "infer": 0.0}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dim", type=int, default=256, choices=(256, 512))
    parser.add_argument("--rows", default=",".join(map(str, ROWS)))
    parser.add_argument("--modes", default=",".join(RATES))
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("sweep_torch_ffn_gate: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from neurst_tpu_torch.layers import common_layers
    from neurst_tpu_torch.ops.kernel_gates import min_rows_from_sweep
    from neurst_tpu_torch.utils.rng import DropoutKey

    dim, filter_size = args.dim, 2048
    rng = np.random.RandomState(args.seed)
    torch.manual_seed(args.seed)
    gate = common_layers.fused_ffn_available
    try:
        for mode in args.modes.split(","):
            rate = RATES[mode]
            training = mode != "infer"
            ffn = common_layers.TransformerFFN(
                dim, filter_size, dim, dropout_rate=rate,
                dtype=torch.bfloat16).to("cuda", torch.bfloat16)
            ffn.requires_grad_(training)
            params = list(ffn.parameters())
            key = DropoutKey(int(rng.randint(2 ** 31)), 7, stream=4) \
                if rate else None
            table = {}
            for rows in (int(r) for r in args.rows.split(",")):
                x = torch.from_numpy(rng.randn(rows, dim).astype(
                    np.float32)).to("cuda", torch.bfloat16)
                dy = torch.from_numpy(rng.randn(rows, dim).astype(
                    np.float32)).to("cuda", torch.bfloat16)
                leaves = [x.requires_grad_(training)] + params

                def call():
                    if not training:
                        with torch.no_grad():
                            return ffn(x, False)
                    return torch.autograd.grad(ffn(x, True, key), leaves, dy)

                times = {}
                for path, fused in (("fused_ms", True),
                                    ("composite_ms", False)):
                    common_layers.fused_ffn_available = \
                        lambda *a, fused=fused, **k: fused
                    times[path] = chip_smoke.time_ms(call, iters=20)
                table[rows] = (times["fused_ms"], times["composite_ms"])
                print(json.dumps({"mode": mode, "rows": rows, "dim": dim,
                                  "filter": filter_size, "rate": rate,
                                  **times, "fused_over_composite":
                                  times["fused_ms"] / times["composite_ms"]}),
                      flush=True)
            print(json.dumps({"mode": mode, "table": table,
                              "min_rows": min_rows_from_sweep(table)}),
                  flush=True)
    finally:
        common_layers.fused_ffn_available = gate
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"device": smi}))


if __name__ == "__main__":
    sys.exit(main())
