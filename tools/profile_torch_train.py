#!/usr/bin/env python3
"""Where one training step of the PyTorch port spends its time, on one
NVIDIA GPU.

    python3 tools/profile_torch_train.py [--model M] [--seed N] [--steps N]
        [--dropout R] [--quant] [--shape B,L]

Builds a training cell that ``chip_smoke.py`` drives: by default the
speech slice (speech_transformer_s, encoder flash attention, bf16 with
bf16 stored params and an f32 master, 40 x 3000 frames, target 150;
dropout 0, or with ``--dropout 0.1`` the recipe's rate at every site and
a dropout key); with ``--model transformer_base`` the NMT cell
(bench.py's train cell: [256, 128] ids, vocabulary 32768, bf16 with
bf16 stored params and an f32 master, dropout 0.1 unless ``--dropout``
says otherwise); with ``--model multi_task_speech_transformer`` the
joint ASR + ST step of ``chip_smoke.py``'s multitask_train phase (the
same speech model with a transcript decoder, 40 x 3000 frames, both
targets 120, the joint criterion, dropout 0.1 unless ``--dropout`` says
otherwise).  ``--quant`` trains the speech slice or ``transformer_base``
under QAT with ``examples/quality/mt_synth_qat.yml``'s quant params (the
step adds the clips' L2 term); ``--shape B,L`` sets transformer_base's
batch (default bench.py's 256,128; 256,16 is about one 4096-token
micro-batch of ``mt_synth_base.yml``).  It
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
# (bf16 and float32 instantiations alike; row_product_bf16_kernel is the
# dW pass of both the FFN and the xent backward)
OWN_KERNELS = ("flash_fwd_", "flash_dq_", "flash_dkv_",
               "linear_xent_fwd_kernel", "linear_xent_fwd_bf16_kernel",
               "linear_xent_combine_kernel", "linear_xent_dx_kernel",
               "linear_xent_dx_bf16_kernel", "linear_xent_dw_kernel",
               "linear_xent_sum_kernel", "dropout_kernel", "ffn_fwd_kernel",
               "ffn_fwd_bf16_kernel", "ffn_fwd_bf16_wide_kernel",
               "ffn_fwd_sum_kernel", "ffn_dx_",
               "ffn_dw_kernel", "ffn_dw_sum_kernel",
               "row_product_bf16_kernel")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--model", default="speech_transformer_s",
                        choices=("speech_transformer_s", "transformer_base",
                                 "multi_task_speech_transformer"))
    parser.add_argument("--quant", action="store_true",
                        help="quantization-aware training")
    parser.add_argument("--shape", default=None,
                        help="transformer_base batch B,L")
    parser.add_argument("--dropout", type=float, default=None,
                        help="rate of every dropout site (default: 0 for "
                             "the speech slice, whose recipe has 0.1; 0.1 "
                             "for transformer_base)")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs an NVIDIA GPU")
    import chip_smoke
    from neurst_tpu_torch.utils.rng import make_key

    rng = np.random.RandomState(args.seed + 5)
    qp = None
    if args.quant:
        from neurst_tpu_torch.layers.quantization.quant_layers import \
            global_init
        if args.model == "multi_task_speech_transformer":
            raise SystemExit("--quant profiles the speech slice or "
                             "transformer_base")
        qp = chip_smoke._qat_quant_params()
        global_init(True, **qp)
    if args.model == "transformer_base":
        t = chip_smoke.NMT_TRAIN
        shape = [int(v) for v in args.shape.split(",")] if args.shape \
            else [t["batch"], t["length"]]
        dropout = 0.1 if args.dropout is None else args.dropout
        _, _, _, state, step = chip_smoke.build_nmt_train(
            args.seed, dropout=dropout, quant_params=qp)
        batches = [chip_smoke.nmt_batch(rng, "cuda", *shape, t["vocab"],
                                        t["vocab"])
                   for _ in range(2 + args.steps)]
    elif args.model == "multi_task_speech_transformer":
        t = chip_smoke.TRAIN
        dropout = 0.1 if args.dropout is None else args.dropout
        if dropout != 0.1:
            raise SystemExit("the joint step runs its recipe's dropout 0.1")
        _, _, _, state, step = chip_smoke.build_multitask_train(args.seed)
        batches = [chip_smoke.multitask_batch(
            rng, "cuda", t["batch"], t["frames"],
            chip_smoke.MULTITASK_TASK["max_trg_len"])
            for _ in range(2 + args.steps)]
    else:
        t = chip_smoke.TRAIN
        dropout = args.dropout or 0.0
        _, _, _, state, step = chip_smoke.build_train(
            args.seed, dropout=dropout, quant_params=qp)
        batches = [chip_smoke.train_batch(rng, "cuda", t["batch"],
                                          t["frames"], t["min_src"],
                                          t["trg_len"], t["min_trg"])
                   for _ in range(2 + args.steps)]
    key = make_key(args.seed + 7) if dropout else None
    for batch in batches[:2]:
        state, _ = step(state, batch, key)
    for i, batch in enumerate(batches[2:]):
        (state, _), row = _profile(lambda: step(state, batch, key), top=40,
                                   own=OWN_KERNELS)
        print(json.dumps(dict(step=i, model=args.model, dropout=dropout,
                              quant=args.quant, **row)), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"device": smi}))


if __name__ == "__main__":
    sys.exit(main())
