#!/usr/bin/env python3
"""Drives the PyTorch port's serving, training and predict paths on one
NVIDIA GPU and holds every kernel against its plain PyTorch version.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line (any failure raises and the script
exits non-zero):

1. device   -- requires CUDA; the card's name and power limit.
2. build    -- compiles every kernel from ``neurst_tpu_torch/csrc``.
3. kernel   -- each kernel against its plain version on the card, in f32
               and bf16, at its path's shape and at a ragged shape; times
               of the kernel, the plain version, one PyTorch library call
               of the same function where there is one, and the card's
               bound.  Flash forward (decode shape, ragged causal and the
               training shape [40, 750, 4, 64]; a head dim it is not
               built for is refused), flash dq and
               dk/dv (training shape [40, 750, 4, 64] with lengths {750,
               375, 1, 0, drawn}, and ragged causal), fused linear xent
               forward and backward ([6000, 256] x 8192 with bias,
               R = 37, V = 650, R = 1000, V = 8190 and [4096, 512] x
               32768; two backward calls bitwise equal), fused softmax
               xent forward and backward
               ([6000, 8192] f32 and bf16, [32768, 32768] bf16, ragged
               [67, 512], [9, 5120] and [37, 650]; no path runs them).
4. slice    -- ``speech_transformer_s`` (encoder flash attention on,
               bf16, vocab 8192) with seeded random weights in the JAX
               package's flat layout, loaded through ``param_bridge``,
               answers 3 requests of 16 x 1024 frames with beam-4 decode
               (max 64 steps); the launch counts of the run.
5. encoder cross-check -- the same weights and batch with flash off.
6. reference check -- the same weights in float32, a small request, on
               the card and on the CPU (plain versions): encoder outputs,
               hypotheses and scores agree.
   predict  -- the predict CLI (``neurst_tpu_torch.cli.run_exp``)
               in-process over a model dir, vocabulary, BPE codes and an
               ``audio_tfrecord`` file of 64 utterances written from the
               seed, with the MuST-C recipe's prediction config (beam 4,
               length penalty -1, max 150, BLEU) and batch_size 16: 64
               samples, 12 flash launches a batch, hypotheses equal to
               ``BeamSearch`` called directly; samples/s, the wall split,
               first-batch latency, peak memory; then float32 CLI runs on
               the card and the CPU agree on 4 short utterances.
               With attention dropout 0.1: the flash kernels against the
               plain versions with the same mask (and the mask read
               bitwise); the dropout mask kernel ([30000, 256] quantized
               rate, [37, 200] and [37, 199] exact rate, an unaligned
               flat view; bitwise, keep rate within 5 sigma, mean(y) /
               mean(x)); the fused FFN forward and backward (D 256: R =
               30000, 6000, 2000 and 37; D 512: R = 32768, 2000 and 37;
               F 2048, rate 0 and 0.1; its mask bitwise; two backward
               calls bitwise equal); the fused linear xent also at the
               NMT cell's [32768, 512] x 32768 (bf16).
7. train    -- ``speech_transformer_s`` trained in its MuST-C recipe's
               largest bucket (40 x 3000 frames, target 150), bf16 with
               bf16 stored params and an f32 master, encoder flash
               attention, dropout 0, label smoothing 0.1, Adam and the
               noam schedule: 2 warm-up and 5 timed steps on fresh seeded
               batches, then the forward / backward / optimizer split;
               launches per step of every kernel against the
               configuration; finite loss and grad norm, and moved
               parameters.
8. train_dropout -- the same with the recipe's dropout 0.1 at every
               site and a dropout key: also the same (key, step) gives a
               bitwise equal loss and the next step another.
   train_base, train_base_bf16 -- bench.py's train cell (``NMT_TRAIN``):
               ``transformer_base`` on [256, 128] token ids, vocabulary
               32768, bf16 compute, dropout 0.1 at every site with a
               dropout key, label smoothing 0.1, Adam, noam, clip norm 1;
               float32 stored params, then bf16 params with an f32
               master: 2 warm-up and 5 timed steps, the split, target
               tokens/s, MFU (bench.py's FLOPs of a step over the step
               and the bf16 peak), peak memory, launches per step against
               the configuration (the fused FFN at D 512 in all 12
               layers), the (key, step) repeat.
9. train reference check -- the same weights in float32, 2 x 256 frames
               and target 16, dropout 0 and then 0.1: one step on the
               card and one on the CPU (plain versions) give the same
               loss, gradients, grad norm and updated parameters; then
               the same for ``transformer_128_2e_2d_4h`` on [2, 16] ids.
Then the kernel summary line (launches by path), and last the device
line.

The script imports nothing of JAX and nothing of ``neurst_tpu``.
"""

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# kernel-vs-plain tolerances (max abs error over o; lse in parentheses).
# float32: both sides sum in float32, in different orders.  bfloat16:
# the kernel rounds P to bf16 against the running row max, the plain
# version against the final one, and o itself is stored in bf16.
KERNEL_TOL = {"float32": (2e-5, 5e-5), "bfloat16": (3e-2, 1e-3)}
# flash vs plain encoder, bf16, 12 layers: the two paths round the
# attention probabilities at different places (max abs, mean abs)
ENCODER_TOL = (0.25, 0.02)
# float32 card vs CPU, whole path: sums in other orders only (encoder
# output max abs; beam score max abs); hypotheses must be equal
REFERENCE_TOL = (1e-4, 1e-4)

# flash backward, kernel vs plain: max abs error of dq, dk and dv, each
# relative to its largest |value|.  float32: both sides sum in float32;
# bf16: the outputs are stored in bf16 (2^-8 relative) and ds and p are
# rounded before the products, where a value one rounding step away
# flips one bf16 ulp of a summand
BWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# fused linear xent, kernel vs plain: xent and lse max abs (float32 sums
# of 256 products and of V exponentials in other orders); dx, dW and db
# relative to their largest |value| (bf16: dx and dW stored in bf16, and
# dz rounded before both products)
XENT_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-4, 1e-2)}
# float32 card vs CPU, one training step of the whole model: loss and
# grad norm relative; each gradient by its relative L2 error (sums in
# other orders through 18 layers, and a FFN ReLU whose pre-activation
# sits at zero may flip between the two, which moves a few summands of
# that layer's dense1 gradient: measured 1e-3 at worst, median 3e-6 of
# the largest |value|); updated parameters within 2 lr + 1e-6 (Adam's
# first update is ~lr * sign(g), so a near-zero gradient whose sign
# differs moves a weight by up to 2 lr)
TRAIN_REF_TOL = (1e-4, 5e-3)
# fused FFN, kernel vs plain on the same inputs (y and hd; the gradients
# from the same hd and dy), each relative to its largest |value|.
# float32: sums of D or F products in other orders (the kernel's FMA
# loops against cuBLAS).  bf16: both sides multiply the same bf16 values
# and accumulate in float32, in other orders, and round hd, dh, y and the
# gradients to bf16, where a sum one rounding step away flips one bf16
# ulp (2^-8 relative) of a summand or an output
FFN_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 1e-2)}
# dropout kernel vs plain: bitwise (the same Philox words, one float32
# multiply, one rounding); the masks of the dropout, FFN and flash
# kernels are compared bitwise too
DROPOUT_RATE = 0.1

SLICE = dict(model="speech_transformer_s", batch=16, frames=1024,
             feature_dim=80, vocab=8192, beam=4, max_decode=64,
             requests=3, min_src=600)
# the MuST-C ST recipe's largest bucket (batch_size 120000 frames,
# max_src_len 3000, max_trg_len 150): 40 utterances x 3000 frames; the
# train phase runs it in the configuration bench.py's flash training cell
# uses (dropout 0), the train_dropout phase with the recipe's dropout 0.1
# at every site
TRAIN = dict(model="speech_transformer_s", batch=40, frames=3000,
             min_src=2400, trg_len=150, min_trg=100, feature_dim=80,
             vocab=8192, label_smoothing=0.1, warmup=2, steps=5, split=2)
# bench.py's train cell (bench.py:160-164, 864-923): transformer_base, the
# WMT14 recipe's model (examples/translation/task_args_bpe.yml), at
# [256, 128] seeded token ids with no padding and a vocabulary of 32768
# on both sides, bf16 compute, dropout 0.1 at every site, label smoothing
# 0.1, Adam (0.9, 0.98, 1e-9), noam (dmodel 512, warmup 4000), clip norm
# 1; once with float32 stored params, once with bf16 params and a float32
# master.  The float32 card-vs-CPU check trains transformer_128_2e_2d_4h
# on [2, 16].
NMT_TRAIN = dict(model="transformer_base", batch=256, length=128,
                 vocab=32768, label_smoothing=0.1, clip_norm=1.0, warmup=2,
                 steps=5, split=2, check_model="transformer_128_2e_2d_4h",
                 check_batch=2, check_length=16, check_src_vocab=384,
                 check_trg_vocab=256)
# the predict CLI as the MuST-C recipe runs it on tst-COMMON
# (examples/speech_transformer/must-c/st_prediction_args.yml: beam 4,
# length penalty -1, at most 150 tokens, BLEU) with batch_size 16: 64
# utterances of 300-3000 frames (1-30 s), translations of 5-60 words; the
# float32 card-vs-CPU check decodes 4 utterances of 300-600 frames
PREDICT = dict(model="speech_transformer_s", utterances=64, batch=16,
               min_frames=300, max_frames=3000, min_words=5, max_words=60,
               feature_dim=80, vocab=8192, check_utterances=4,
               check_max_frames=600)
PREDICT_ARGS = {
    "entry.class": "predict",
    "entry.params": {
        "search_method.class": "beam_search",
        "search_method.params": {"beam_size": 4, "length_penalty": -1,
                                 "maximum_decode_length": 150},
        "metric.class": "bleu"},
    "dataset.class": "audio_tfrecord",
    "dataset.params": {"feature_key": "audio",
                       "transcript_key": "translation"},
    "batch_size": PREDICT["batch"]}


def emit(obj):
    print(json.dumps(obj), flush=True)


def device_phase():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs the "
                         "port on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def build_phase():
    from neurst_tpu_torch.ops import _build
    start = time.perf_counter()
    compiled = _build.build()
    ptxas = {}
    for name in _build.KERNEL_SOURCES:
        log = _build.library_path(name).with_suffix(".log")
        ptxas[name] = [line.strip() for line in log.read_text().splitlines()
                       if "registers" in line or "smem" in line] \
            if log.exists() else []
    emit({"phase": "build", "seconds": round(time.perf_counter() - start, 2),
          "compiled": {k: round(v, 2) for k, v in compiled.items()},
          "ptxas": ptxas})


# spin-kernel cycles per second of host time to cover (above the H100's
# top SM clock, so the spin outlasts the host's queueing)
SPIN_CYCLES_PER_S = 2.5e9


def time_ms(fn, iters=30, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls.  A
    spin kernel queued ahead keeps the card busy while the host queues
    the calls, so the events time the device's work alone, not the host's
    wrappers and launches between calls (which exceed the work of a
    kernel of a few tens of microseconds)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host = time.perf_counter()
    fn()
    host = time.perf_counter() - host
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * host * iters + 1e-3, 2.0)
                          * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops, dtype):
    """(least time in ms, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the operations over the dtype's peak
    rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).replace("torch.", "")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _valid_keys_and_pairs(lengths, t, causal):
    """Keys some query may attend (the first ``length`` of each row) and
    valid (query, key) pairs of one head, over the batch."""
    keys = pairs = 0
    for length in lengths.tolist():
        length = max(0, min(int(length), t))
        keys += length
        if causal:
            pairs += sum(min(r + 1, length) for r in range(t))
        else:
            pairs += t * length
    return keys, pairs


def attention_bound_ms(q, lengths, causal, kernel="fwd"):
    """Least time for one flash kernel on these inputs.  Bytes: every
    q-side row of q, o (or dO, dq) and the [B, N, T] float32 statistics
    once, k and v (and dk, dv read side) over the keys some query may
    attend, dk and dv written over all keys, lengths once.  Operations:
    2 H per product per valid (query, key) pair: 2 products forward
    (q k^T, p v), 3 in dq (q k^T, dO v^T, ds k), 4 in dk/dv (and ds^T q,
    p^T dO)."""
    b, t, n, h = q.shape
    elem = q.element_size()
    keys, pairs = _valid_keys_and_pairs(lengths, t, causal)
    row = b * t * n * h * elem
    stats = b * n * t * 4
    nbytes, products = {
        "fwd": (2 * row + 2 * keys * n * h * elem + stats, 2),
        "dq": (3 * row + 2 * keys * n * h * elem + 2 * stats, 3),
        "dkv": (4 * row + 2 * keys * n * h * elem + 2 * stats, 4),
    }[kernel]
    return bound_ms(nbytes + b * 4, 2.0 * h * n * pairs * products, q.dtype)


def xent_bound_ms(x, w, kernel):
    """Least time for the fused linear xent forward (x, W, bias, labels
    read; xent and lse written; 2 R V D operations) or backward (x, W,
    bias, labels, lse, g read; dx, dW, db written; 6 R V D: the logits
    again and the two gradient products)."""
    rows, dim = x.shape
    vocab = w.shape[0]
    elem = x.element_size()
    operands = (rows + vocab) * dim * elem
    if kernel == "fwd":
        return bound_ms(operands + vocab * 4 + rows * 12,
                        2.0 * rows * vocab * dim, x.dtype)
    return bound_ms(2 * operands + 2 * vocab * 4 + rows * 12,
                    6.0 * rows * vocab * dim, x.dtype)


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _abs_err(got, want):
    return float((got.float() - want.float()).abs().max())


def flash_fwd_kernel_phase(seed):
    """flash_attention_fwd against flash_attention_reference."""
    import torch
    from torch.nn import functional as F

    from neurst_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_reference)

    rng = np.random.RandomState(seed)
    b, n, h = SLICE["batch"], 4, 64
    t_main = SLICE["frames"] // 4
    main_lengths = [t_main, 150, 1, 0] + list(
        rng.randint(1, t_main + 1, size=b - 4))
    # the training slice's encoder shape, drawn as flash_bwd_kernel_phase
    # draws its main case: the dropout-0 training step launches the
    # forward there 12 times a step
    train_rng = np.random.RandomState(seed + 10)
    t_train = TRAIN["frames"] // 4
    train_lengths = [t_train, t_train // 2, 1, 0] + list(
        train_rng.randint(1, t_train + 1, size=TRAIN["batch"] - 4))
    cases = [("main", t_main, main_lengths, False, rng),
             ("ragged_causal", 200, list(rng.randint(0, 201, size=4)), True,
              rng),
             ("train", t_train, train_lengths, False, train_rng)]
    results = {}
    for case, t, lengths, causal, case_rng in cases:
        for dtype in (torch.float32, torch.bfloat16):
            bb = len(lengths)
            # the main path hands the kernel strided slices of the fused
            # qkv projection
            qkv = torch.from_numpy(case_rng.randn(bb, t, 3, n, h).astype(
                np.float32)).to("cuda", dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            o, lse = flash_attention_fwd(q, k, v, lens, causal)
            o_ref, lse_ref = flash_attention_reference(q, k, v, lens, causal)
            torch.cuda.synchronize()
            err = float((o.float() - o_ref.float()).abs().max())
            lse_err = float((lse - lse_ref).abs().max())
            name = str(dtype).replace("torch.", "")
            tol, lse_tol = KERNEL_TOL[name]
            if not (err <= tol and lse_err <= lse_tol):
                raise AssertionError(
                    f"flash_attention_fwd {case} {name}: max abs err "
                    f"{err} (tol {tol}), lse {lse_err} (tol {lse_tol})")
            kernel_ms = time_ms(lambda: flash_attention_fwd(
                q, k, v, lens, causal))
            plain_ms = time_ms(lambda: flash_attention_reference(
                q, k, v, lens, causal))
            col = torch.arange(t, device="cuda")
            mask = (col[None, :] < lens[:, None])[:, None, None, :]
            if causal:
                mask = mask & (col[None, :] <= col[:, None])[None, None]
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
            bound_ms, bound_by = attention_bound_ms(q, lens, causal)
            row = {"phase": "kernel", "kernel": "flash_attention_fwd",
                   "case": case, "dtype": name, "shape": [bb, t, n, h],
                   "causal": causal, "max_abs_err": err, "tol": tol,
                   "lse_max_abs_err": lse_err, "lse_tol": lse_tol,
                   "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by}
            emit(row)
            results[(case, name)] = row
    # a head dim the kernel is not built for is refused before launch
    before = flash_attention_fwd.launches
    try:
        flash_attention_fwd(q[..., :32], k[..., :32], v[..., :32], lens)
    except ValueError:
        pass
    else:
        raise AssertionError("flash_attention_fwd took head_dim 32")
    if flash_attention_fwd.launches != before:
        raise AssertionError("a refused call counted a launch")
    return results


def _key_mask(lens, t, causal):
    """The boolean [B, 1, T, T] mask ``scaled_dot_product_attention``
    takes for the kernels' key-length (and causal) mask."""
    import torch
    col = torch.arange(t, device="cuda")
    mask = (col[None, :] < lens[:, None])[:, None, None, :]
    if causal:
        mask = mask & (col[None, :] <= col[:, None])[None, None]
    return mask


def flash_bwd_kernel_phase(seed):
    """flash_attention_dq and flash_attention_dkv against the plain
    backward on the same (q, k, v, dO, lse, delta), at the training
    slice's encoder shape and at a ragged causal shape.  The library
    time is the backward of ``scaled_dot_product_attention`` with a
    boolean key mask (forward + backward, minus forward), which computes
    dq, dk and dv together; so does the plain version."""
    import torch
    from torch.nn import functional as F

    from neurst_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(seed + 10)
    b, n, h = TRAIN["batch"], 4, 64
    t_main = TRAIN["frames"] // 4
    main_lengths = [t_main, t_main // 2, 1, 0] + list(
        rng.randint(1, t_main + 1, size=b - 4))
    cases = [("main", t_main, main_lengths, False),
             ("ragged_causal", 200, list(rng.randint(0, 201, size=4)), True)]
    results = {}
    for case, t, lengths, causal in cases:
        for dtype in (torch.float32, torch.bfloat16):
            bb = len(lengths)
            qkv = torch.from_numpy(rng.randn(bb, t, 3, n, h).astype(
                np.float32)).to("cuda", dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            do = torch.from_numpy(rng.randn(bb, t, n, h).astype(
                np.float32)).to("cuda", dtype)
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            o, lse = fa.flash_attention_fwd(q, k, v, lens, causal)
            delta = fa._delta(o, do)
            args = (q, k, v, do, lse, delta, lens, causal)
            got = (fa.flash_attention_dq(*args),) + fa.flash_attention_dkv(
                *args)
            want = fa._bwd_plain(*args)
            torch.cuda.synchronize()
            name = str(dtype).replace("torch.", "")
            rel = {g: _rel_err(x, y) for g, x, y in zip(
                ("dq", "dk", "dv"), got, want)}
            err = {g: _abs_err(x, y) for g, x, y in zip(
                ("dq", "dk", "dv"), got, want)}
            if max(rel.values()) > BWD_TOL[name]:
                raise AssertionError(f"flash backward {case} {name}: "
                                     f"relative errors {rel} (tol "
                                     f"{BWD_TOL[name]})")
            plain_ms = time_ms(lambda: fa._bwd_plain(*args), iters=5)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            mask = _key_mask(lens, t, causal)

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)

            library_ms = time_ms(lambda: torch.autograd.grad(
                sdpa(), (qt, kt, vt), do.transpose(1, 2))) - time_ms(sdpa)
            for kernel, fn, outs in (
                    ("dq", fa.flash_attention_dq, ("dq",)),
                    ("dkv", fa.flash_attention_dkv, ("dk", "dv"))):
                bound, bound_by = attention_bound_ms(q, lens, causal, kernel)
                row = {"phase": "kernel",
                       "kernel": f"flash_attention_{kernel}", "case": case,
                       "dtype": name, "shape": [bb, t, n, h],
                       "causal": causal,
                       "max_abs_err": max(err[g] for g in outs),
                       "rel_err": {g: rel[g] for g in outs},
                       "tol": BWD_TOL[name],
                       "kernel_ms": time_ms(lambda: fn(*args)),
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": bound, "bound_by": bound_by}
                emit(row)
                results[(kernel, case, name)] = row
    return results


def _xent_fwd_plan(fc, rows, vocab, dim, dtype, launches):
    """The forward's plan at this shape (bf16: ``fwd_plan``; float32: the
    FMA kernel's 32-row tiles over the whole vocabulary) with the
    launches one call counted, which must be ``fwd_launches``.  None for
    a package without ``fwd_plan`` (an older checkout that
    ``tools/compare_flash_kernels.py`` times)."""
    import torch
    if not hasattr(fc, "fwd_plan"):
        return None
    splits, tile_rows = 1, 32
    if dtype == torch.bfloat16:
        splits, _, tile_rows, _ = fc.fwd_plan(rows, vocab, dim)
    want = fc.fwd_launches(rows, vocab, dim, dtype)
    if launches != want:
        raise AssertionError(f"fused_linear_xent_fwd [{rows}, {dim}] x "
                             f"{vocab} {dtype}: {launches} launches, "
                             f"expected {want}")
    return {"splits": splits, "tile_rows": tile_rows, "launches": launches}


def xent_kernel_phase(seed):
    """fused_linear_xent_fwd and _bwd against their plain versions on the
    same inputs, at the training slice's shape (6000 target rows, d 256,
    the 8192-word tied softmax with its bias), at a ragged one, at one
    whose row tiles and vocabulary split both end ragged (1000 rows,
    8190 words), at d 512 (4096 rows, 32768 words) and, in bf16 alone,
    at the NMT train cell's [32768, 512] x 32768; two backward
    calls of each must give the same bits, and the forward's row carries
    its plan (vocabulary splits, tile rows, launches a call: counted, and
    held to ``fwd_launches``).  No single PyTorch call computes this
    function: ``label_smoothing`` of ``cross_entropy`` spreads eps over
    all V classes where NeurST spreads it over V - 1, so ``library_ms``
    is null and the time of ``F.cross_entropy(F.linear(...))`` is
    printed beside it as a composite."""
    import torch
    from torch.nn import functional as F

    from neurst_tpu_torch.ops import fused_ce as fc

    rng = np.random.RandomState(seed + 20)
    smoothing = TRAIN["label_smoothing"]
    both = (torch.float32, torch.bfloat16)
    cases = [("main", TRAIN["batch"] * TRAIN["trg_len"], TRAIN["vocab"],
              256, both), ("ragged", 37, 650, 256, both),
             ("ragged_split", 1000, 8190, 256, both),
             ("d512", 4096, 32768, 512, both),
             ("nmt_train", NMT_TRAIN["batch"] * NMT_TRAIN["length"],
              NMT_TRAIN["vocab"], 512, (torch.bfloat16,))]
    results = {}
    for case, rows, vocab, dim, dtypes in cases:
        c, low = 1.0 - smoothing, smoothing / (vocab - 1)
        for dtype in dtypes:
            def draw(*shape, scale=1.0):
                return torch.from_numpy(
                    (scale * rng.randn(*shape)).astype(np.float32)).cuda()
            x = draw(rows, dim).to(dtype)
            w = draw(vocab, dim, scale=dim ** -0.5).to(dtype)
            bias = draw(vocab, scale=0.1)
            labels = torch.from_numpy(rng.randint(0, vocab, size=rows).astype(
                np.int32)).cuda()
            g = torch.from_numpy(rng.rand(rows).astype(np.float32)).cuda()
            fwd_args = (x, w, bias, labels, c, low)
            before = fc.fused_linear_xent_fwd.launches
            xent, lse = fc.fused_linear_xent_fwd(*fwd_args)
            plan = _xent_fwd_plan(fc, rows, vocab, dim, dtype,
                                  fc.fused_linear_xent_fwd.launches - before)
            bwd_args = (x, w, bias, labels, lse, g, c, low)
            grads = fc.fused_linear_xent_bwd(*bwd_args)
            # no atomics: a second call of each gives the same bits
            fwd_repeat = all(torch.equal(a, b_) for a, b_ in zip(
                (xent, lse), fc.fused_linear_xent_fwd(*fwd_args)))
            repeat = all(torch.equal(a, b_) for a, b_ in zip(
                grads, fc.fused_linear_xent_bwd(*bwd_args)))
            ref_xent, ref_lse = fc._fwd_plain(*fwd_args)
            ref_grads = fc._bwd_plain(*bwd_args)
            torch.cuda.synchronize()
            name = str(dtype).replace("torch.", "")
            val_tol, grad_tol = XENT_TOL[name]
            fwd_err = max(_abs_err(xent, ref_xent), _abs_err(lse, ref_lse))
            rel = {k: _rel_err(a, b_) for k, a, b_ in zip(
                ("dx", "dw", "db"), grads, ref_grads)}
            if fwd_err > val_tol or max(rel.values()) > grad_tol \
                    or not (repeat and fwd_repeat):
                raise AssertionError(
                    f"fused_linear_xent {case} {name}: xent/lse err "
                    f"{fwd_err} (tol {val_tol}), gradients {rel} (tol "
                    f"{grad_tol}), two forward calls equal: {fwd_repeat}, "
                    f"two backward calls equal: {repeat}")
            leaves = [t.detach().requires_grad_() for t in (x, w)]

            def composite():
                return F.cross_entropy(
                    F.linear(leaves[0], leaves[1], bias.to(dtype)),
                    labels.long(), label_smoothing=smoothing)

            composite_fwd = time_ms(composite)
            composite_bwd = time_ms(lambda: torch.autograd.grad(
                composite(), leaves)) - composite_fwd
            for kernel, fn, args, plain, err, composite_ms in (
                    ("fwd", fc.fused_linear_xent_fwd, fwd_args,
                     fc._fwd_plain, fwd_err, composite_fwd),
                    ("bwd", fc.fused_linear_xent_bwd, bwd_args,
                     fc._bwd_plain, max(_abs_err(a, b_) for a, b_ in zip(
                         grads, ref_grads)), composite_bwd)):
                bound, bound_by = xent_bound_ms(x, w, kernel)
                row = {"phase": "kernel",
                       "kernel": f"fused_linear_xent_{kernel}",
                       "case": case, "dtype": name,
                       "shape": [rows, dim, vocab], "max_abs_err": err,
                       "tol": val_tol if kernel == "fwd" else grad_tol,
                       "kernel_ms": time_ms(lambda: fn(*args), iters=10),
                       "plain_ms": time_ms(lambda: plain(*args), iters=5),
                       "library_ms": None,
                       "composite_cross_entropy_linear_ms": composite_ms,
                       "bound_ms": bound, "bound_by": bound_by}
                if kernel == "fwd":
                    row["plan"] = plan
                    row["bitwise_repeat"] = fwd_repeat
                else:
                    row["rel_err"] = rel
                    row["bitwise_repeat"] = repeat
                emit(row)
                results[(kernel, case, name)] = row
    return results


# fused_softmax_xent, kernel vs plain: xent and lse relative to their
# largest |value| (float32 sums of V terms in other orders, expf against
# torch's exp); dz max abs in float32 (p = exp(z - lse) one expf ulp
# apart, and where V p is near 1 the two terms cancel, so the error is
# absolute, not relative); in bf16, both round float32 values that may
# differ by that much, so dz may differ by it plus one bf16 ulp of the
# element (reported as ulps beyond the float32 tolerance)
SOFTMAX_XENT_TOL = {"xent": 1e-5, "float32": 1e-6, "bfloat16": 1.0}


def _bf16_ulps(got, want, slack):
    """Largest |got - want| - ``slack`` in units of the bf16 ulp of the
    larger of the two, elementwise (0 where within ``slack``)."""
    import torch
    a, b = got.float(), want.float()
    big = a.abs().maximum(b.abs()).clamp_min(1e-38)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7.0)
    return float(((a - b).abs() - slack).clamp_min(0.0).div(ulp).max())


def softmax_xent_bound_ms(z, kernel):
    """Least time for fused_softmax_xent: bytes, the R V logits read once
    (and, backward, dz written once) plus the int32 labels and the float32
    row vectors (xent, lse out; lse, g in); operations, ~4 float32 ones a
    logit (subtract, exp, two adds; backward about 6)."""
    rows, vocab = z.shape
    logits = rows * vocab * z.element_size()
    if kernel == "fwd":
        return bound_ms(logits + rows * 12, 4.0 * rows * vocab, "float32")
    return bound_ms(2 * logits + rows * 12, 6.0 * rows * vocab, "float32")


def softmax_xent_kernel_phase(seed):
    """fused_softmax_xent_fwd and _bwd (rows 6-7) against their plain
    versions on the same logits: the recipe's target rows x vocabulary
    [6000, 8192] in float32 and bf16, bench.py's transformer_base train
    cell [32768, 32768] (256 x 128 tokens, vocabulary 32768) in bf16, the
    JAX tests' ragged [67, 512] (bf16) and [9, 5120] (float32, labels in
    the last partial 4096-column block), and [37, 650] (bf16, a
    vocabulary that takes the one-element loads).  The library call is
    ``F.cross_entropy(z.float(), y, label_smoothing=V low)``, the same
    function (see ``tests/test_torch_fused_ce.py``), and its backward.
    No path launches these kernels: launches stay 0."""
    import torch
    from torch.nn import functional as F

    from neurst_tpu_torch.ops import fused_ce as fc

    smoothing = TRAIN["label_smoothing"]
    cases = [("main", 6000, 8192, torch.float32),
             ("main", 6000, 8192, torch.bfloat16),
             ("bench_train", 32768, 32768, torch.bfloat16),
             ("ragged_rows", 67, 512, torch.bfloat16),
             ("ragged_vocab", 9, 5120, torch.float32),
             ("odd_vocab", 37, 650, torch.bfloat16)]
    gen = torch.Generator(device="cuda").manual_seed(seed + 60)
    results = {}
    for case, rows, vocab, dtype in cases:
        name = str(dtype).replace("torch.", "")
        c, low = 1.0 - smoothing, smoothing / (vocab - 1)
        z = (2.0 * torch.randn(rows, vocab, device="cuda", generator=gen)
             ).to(dtype)
        lo = 4096 if case == "ragged_vocab" else 0
        labels = torch.randint(lo, vocab, (rows,), device="cuda",
                               generator=gen, dtype=torch.int32)
        g = torch.rand(rows, device="cuda", generator=gen)
        xent, lse = fc.fused_softmax_xent_fwd(z, labels, c, low)
        dz = fc.fused_softmax_xent_bwd(z, labels, lse, g, c, low)
        ref_xent, ref_lse = fc._softmax_fwd_plain(z, labels, c, low)
        ref_dz = fc._softmax_bwd_plain(z, labels, ref_lse, g, c, low)
        torch.cuda.synchronize()
        fwd_err = max(_rel_err(xent, ref_xent), _rel_err(lse, ref_lse))
        dz_err = (_abs_err(dz, ref_dz) if dtype == torch.float32
                  else _bf16_ulps(dz, ref_dz, SOFTMAX_XENT_TOL["float32"]))
        if not (fwd_err <= SOFTMAX_XENT_TOL["xent"]
                and dz_err <= SOFTMAX_XENT_TOL[name]):
            raise AssertionError(
                f"fused_softmax_xent {case} {name}: xent/lse relative err "
                f"{fwd_err} (tol {SOFTMAX_XENT_TOL['xent']}), dz err "
                f"{dz_err} (tol {SOFTMAX_XENT_TOL[name]})")
        leaf = z.detach().requires_grad_()

        def library():
            return F.cross_entropy(leaf.float(), labels.long(),
                                   label_smoothing=vocab * low,
                                   reduction="none")

        big = rows * vocab > 1 << 28
        library_fwd = time_ms(library, iters=3 if big else 10)
        library_bwd = time_ms(lambda: torch.autograd.grad(
            library(), leaf, g), iters=3 if big else 10) - library_fwd
        fwd_args, bwd_args = (z, labels, c, low), (z, labels, lse, g, c, low)
        for kernel, fn, args, plain, err, library_ms in (
                ("fwd", fc.fused_softmax_xent_fwd, fwd_args,
                 fc._softmax_fwd_plain, fwd_err, library_fwd),
                ("bwd", fc.fused_softmax_xent_bwd, bwd_args,
                 fc._softmax_bwd_plain, dz_err, library_bwd)):
            bound, bound_by = softmax_xent_bound_ms(z, kernel)
            row = {"phase": "kernel",
                   "kernel": f"fused_softmax_xent_{kernel}", "case": case,
                   "dtype": name, "shape": [rows, vocab],
                   "max_abs_err": (_abs_err(xent, ref_xent) if kernel == "fwd"
                                   else _abs_err(dz, ref_dz)),
                   "err": err, "err_kind": (
                       "relative" if kernel == "fwd" else
                       "abs" if dtype == torch.float32
                       else "bf16 ulps beyond 1e-6"),
                   "tol": (SOFTMAX_XENT_TOL["xent"] if kernel == "fwd"
                           else SOFTMAX_XENT_TOL[name]),
                   "kernel_ms": time_ms(lambda: fn(*args),
                                        iters=5 if big else 20),
                   "plain_ms": time_ms(lambda: plain(*args), iters=3),
                   "library_ms": library_ms,
                   "bound_ms": bound, "bound_by": bound_by}
            emit(row)
            results[(kernel, case, name)] = row
        del z, labels, g, xent, lse, dz, ref_xent, ref_lse, ref_dz, leaf
        torch.cuda.empty_cache()
    return results


def _site_key(rng, stream):
    from neurst_tpu_torch.utils.rng import DropoutKey
    return DropoutKey(int(rng.randint(2 ** 31)), int(rng.randint(2 ** 31)),
                      stream=stream)


def _keep_rate_ok(kept, keep_p, n):
    """Whether a kept share lies within 5 sigma of its binomial
    expectation."""
    return abs(kept - keep_p) <= 5 * math.sqrt(keep_p * (1 - keep_p) / n)


def dropout_kernel_phase(seed):
    """fused_dropout_apply (the mask kernel) against its plain version:
    the encoder's postprocess site [30000, 256] (rate quantized to 1/256),
    a ragged [37, 200] (exact rate), a [37, 199] whose length is not a
    whole number of 16-byte vectors (a scalar tail), and a flat view
    ``buf[1:]`` whose pointer is not 16-byte aligned (the kernel gathers
    its vectors).  Outputs and masks bitwise equal; the kept share within
    5 sigma of its expectation; mean(y) / mean(x) within 5 sigma (plus
    half a bf16 ulp) of 1.  The library call is ``F.dropout`` (its own
    generator)."""
    import torch
    from torch.nn import functional as F

    from neurst_tpu_torch.ops import fused_dropout as fd

    rng = np.random.RandomState(seed + 30)
    key = _site_key(rng, 1 << 16 | 1)
    rows = TRAIN["batch"] * TRAIN["frames"] // 4
    results = {}
    for case, shape in (("main", (rows, 256)), ("ragged", (37, 200)),
                        ("ragged_tail", (37, 199)),
                        ("unaligned", (100003,))):
        threshold, scale = fd.threshold_and_scale(
            DROPOUT_RATE, fd.quantized_site(shape))
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            if case == "unaligned":
                buf = torch.from_numpy((rng.rand(shape[0] + 1) + 0.5).astype(
                    np.float32)).to("cuda", dtype)
                x = buf[1:]
                if x.data_ptr() % 16 == 0 or not x.is_contiguous():
                    raise AssertionError("dropout unaligned case: the view "
                                         "is aligned")
            else:
                x = torch.from_numpy((rng.rand(*shape) + 0.5).astype(
                    np.float32)).to("cuda", dtype)
            y = fd.fused_dropout_apply(x, key, threshold, scale)
            want = fd.dropout_reference(x, key, threshold, scale)
            torch.cuda.synchronize()
            n = x.numel()
            keep_p = 1.0 - threshold / 2.0 ** 32
            kept = float((y != 0).float().mean())
            xf = x.float()
            se = scale * math.sqrt(keep_p * (1 - keep_p)
                                   * float((xf * xf).sum())) / float(xf.sum())
            ratio = float(y.float().mean() / xf.mean())
            err = _abs_err(y, want)
            same_mask = bool(torch.equal(y != 0, want != 0))
            ulp = 2.0 ** -9 if dtype == torch.bfloat16 else 0.0
            if not (same_mask and err == 0.0
                    and _keep_rate_ok(kept, keep_p, n)
                    and abs(ratio - 1.0) <= 5 * se + ulp):
                raise AssertionError(
                    f"fused_dropout {case} {name}: masks equal {same_mask}, "
                    f"max abs err {err}, kept {kept} (expected {keep_p}), "
                    f"mean ratio {ratio}")
            bound, bound_by = bound_ms(2 * n * x.element_size(), 0, dtype)
            row = {"phase": "kernel", "kernel": "fused_dropout",
                   "case": case, "dtype": name, "shape": list(shape),
                   "offset_bytes": x.data_ptr() % 16,
                   "quantized": fd.quantized_site(shape),
                   "threshold": threshold, "scale": scale,
                   "masks_equal": same_mask, "max_abs_err": err, "tol": 0.0,
                   "kept": kept, "keep_expected": keep_p,
                   "mean_y_over_mean_x": ratio,
                   "kernel_ms": time_ms(lambda: fd.fused_dropout_apply(
                       x, key, threshold, scale)),
                   "plain_ms": time_ms(lambda: fd.dropout_reference(
                       x, key, threshold, scale), iters=5),
                   "library_ms": time_ms(lambda: F.dropout(
                       x, DROPOUT_RATE, True)),
                   "bound_ms": bound, "bound_by": bound_by}
            emit(row)
            results[(case, name)] = row
    return results


def ffn_bound_ms(x, filter_size, kernel):
    """Least time for the fused FFN forward (x, W1, W2, biases read; y
    and, in training, hd written; 4 R D F operations) or backward (x,
    W1, W2, hd, dy read; dx, dW1, dW2, db1, db2 written; 8 R D F)."""
    rows, dim = x.shape
    dtype, elem = x.dtype, x.element_size()
    weights = 2 * dim * filter_size * elem
    if kernel == "fwd":
        nbytes = (2 * rows * dim + rows * filter_size) * elem + weights \
            + 4 * (dim + filter_size)
        return bound_ms(nbytes, 4.0 * rows * dim * filter_size, dtype)
    nbytes = (3 * rows * dim + rows * filter_size) * elem + 2 * weights \
        + 4 * (dim + filter_size)
    return bound_ms(nbytes, 8.0 * rows * dim * filter_size, dtype)


def ffn_kernel_phase(seed):
    """fused_ffn_fwd and _bwd against their plain versions on the same
    inputs (the backward fed the plain forward's hd), at D 256: the
    slice's encoder rows (30,000), decoder rows (6,000; the bf16 forward
    splits the filter over two blocks a row tile), 2,000 (four, with a
    ragged last tile) and a ragged 37; at D 512: the NMT train cell's
    32,768 rows, 2,000 and 37; F 2048, rate 0 and 0.1 (a package built
    for D 256 alone, an older checkout that
    ``tools/compare_flash_kernels.py`` times, runs the D 256 cases).  The
    dropout mask is compared bitwise with b1
    = 100 (every pre-activation positive, so hd is 0 exactly where
    dropped) and its kept share checked; two backward calls must give
    the same bits.  No single PyTorch call computes the function:
    ``library_ms`` is null and ``linear -> relu -> dropout -> linear`` is
    timed beside it as a composite."""
    import torch
    from torch.nn import functional as F

    from neurst_tpu_torch.ops import fused_ffn as ff

    rng = np.random.RandomState(seed + 40)
    filter_size = 2048
    key = _site_key(rng, 1 << 16 | 4)
    cases = [("main", TRAIN["batch"] * TRAIN["frames"] // 4, 256),
             ("decoder", TRAIN["batch"] * TRAIN["trg_len"], 256),
             ("split", 2000, 256), ("ragged", 37, 256),
             ("d512", NMT_TRAIN["batch"] * NMT_TRAIN["length"], 512),
             ("d512_split", 2000, 512), ("d512_ragged", 37, 512)]
    results = {}
    for case, rows, dim in cases:
        if dim not in ff.DIMS:
            continue
        for rate in (0.0, DROPOUT_RATE):
            k = key if rate else None
            drop = ff._drop(rate, k)
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).replace("torch.", "")

                def draw(*shape, scale=1.0, dt=dtype):
                    return torch.from_numpy((scale * rng.randn(*shape)).astype(
                        np.float32)).to("cuda", dt)
                x, dy = draw(rows, dim), draw(rows, dim)
                w1 = draw(filter_size, dim, scale=dim ** -0.5)
                w2 = draw(dim, filter_size, scale=filter_size ** -0.5)
                b1 = draw(filter_size, scale=0.1, dt=torch.float32)
                b2 = draw(dim, scale=0.1, dt=torch.float32)
                fwd_args = (x, w1, b1, w2, b2, rate, k, True)
                y, hd = ff.fused_ffn_fwd(*fwd_args)
                y_ref, hd_ref = ff._fwd_plain(x, w1, b1, w2, b2, drop, True)
                bwd_args = (x, w1, w2, hd_ref, dy, drop[1])
                grads = ff.fused_ffn_bwd(*bwd_args)
                ref_grads = ff._bwd_plain(*bwd_args)
                # no atomics: a second call gives the same bits
                repeat = all(torch.equal(a, b_) for a, b_ in zip(
                    grads, ff.fused_ffn_bwd(*bwd_args)))
                if not repeat:
                    raise AssertionError(f"fused_ffn {case} rate {rate} "
                                         f"{name}: two backward calls differ")
                mask = {}
                if rate:
                    big = torch.full_like(b1, 100.0)
                    _, hd_m = ff.fused_ffn_fwd(x, w1, big, w2, b2, rate, k,
                                               True)
                    _, hd_mr = ff._fwd_plain(x, w1, big, w2, b2, drop, True)
                    keep_p = 1.0 - drop[0] / 2.0 ** 32
                    kept = float((hd_m != 0).float().mean())
                    mask = {"masks_equal": bool(torch.equal(hd_m == 0,
                                                            hd_mr == 0)),
                            "kept": kept, "keep_expected": keep_p}
                    if not (mask["masks_equal"]
                            and _keep_rate_ok(kept, keep_p, hd_m.numel())):
                        raise AssertionError(f"fused_ffn {case} {name}: "
                                             f"dropout mask {mask}")
                torch.cuda.synchronize()
                fwd_rel = {"y": _rel_err(y, y_ref), "hd": _rel_err(hd, hd_ref)}
                bwd_rel = {g: _rel_err(a, b_) for g, a, b_ in zip(
                    ("dx", "dw1", "dw2", "db1", "db2"), grads, ref_grads)}
                fwd_tol, bwd_tol = FFN_TOL[name]
                if max(fwd_rel.values()) > fwd_tol \
                        or max(bwd_rel.values()) > bwd_tol:
                    raise AssertionError(
                        f"fused_ffn {case} rate {rate} {name}: forward "
                        f"{fwd_rel} (tol {fwd_tol}), backward {bwd_rel} "
                        f"(tol {bwd_tol})")
                leaves = [t.detach().requires_grad_()
                          for t in (x, w1, b1, w2, b2)]

                def composite():
                    h = F.relu(F.linear(leaves[0], leaves[1],
                                        leaves[2].to(dtype)))
                    h = F.dropout(h, rate, True)
                    return F.linear(h, leaves[3], leaves[4].to(dtype))

                composite_fwd = time_ms(composite, iters=10)
                composite_bwd = time_ms(lambda: torch.autograd.grad(
                    composite(), leaves, dy), iters=10) - composite_fwd
                for kernel, fn, args, plain, pargs, rel, comp in (
                        ("fwd", ff.fused_ffn_fwd, fwd_args, ff._fwd_plain,
                         (x, w1, b1, w2, b2, drop, True), fwd_rel,
                         composite_fwd),
                        ("bwd", ff.fused_ffn_bwd, bwd_args, ff._bwd_plain,
                         bwd_args, bwd_rel, composite_bwd)):
                    bound, bound_by = ffn_bound_ms(x, filter_size, kernel)
                    outs = (y, hd) if kernel == "fwd" else grads
                    refs = (y_ref, hd_ref) if kernel == "fwd" else ref_grads
                    row = dict({
                        "phase": "kernel", "kernel": f"fused_ffn_{kernel}",
                        "case": case, "dtype": name, "rate": rate,
                        "shape": [rows, dim, filter_size],
                        "max_abs_err": max(_abs_err(a, b_) for a, b_ in
                                           zip(outs, refs)),
                        "rel_err": rel,
                        "tol": fwd_tol if kernel == "fwd" else bwd_tol,
                        "kernel_ms": time_ms(lambda: fn(*args), iters=10),
                        "plain_ms": time_ms(lambda: plain(*pargs), iters=3),
                        "library_ms": None,
                        "composite_linear_relu_dropout_linear_ms": comp,
                        "bound_ms": bound, "bound_by": bound_by}, **mask)
                    if kernel == "bwd":
                        row["bitwise_repeat"] = repeat
                    emit(row)
                    results[(kernel, case, rate, name)] = row
    return results


def _identity_mask_check(fa, key):
    """The flash forward's and dk/dv kernel's dropout masks, read
    directly: with q = 0 every valid probability is 1/T, and with k, v
    and dO the identity, o[b, q, n, j] = pm[b, n, q, j] and
    dv[b, j, n, q] = pm[b, n, q, j]; both must be nonzero exactly where
    the generator keeps (b, n, q, j), in float32."""
    import torch

    from neurst_tpu_torch.ops.fused_dropout import (dropout_keep_mask,
                                                    threshold_and_scale)
    b, t, n, h = 2, 64, 4, 64
    eye = torch.eye(t, device="cuda")[None, :, None, :].expand(
        b, t, n, h).contiguous()
    q = torch.zeros_like(eye)
    lens = torch.full((b,), t, dtype=torch.int32, device="cuda")
    o, lse = fa.flash_attention_fwd(q, eye, eye, lens, False, DROPOUT_RATE,
                                    key)
    _, dv = fa.flash_attention_dkv(q, eye, eye, eye, lse, fa._delta(o, eye),
                                   lens, False, DROPOUT_RATE, key)
    keep = dropout_keep_mask((b, n, t, t), key,
                             threshold_and_scale(DROPOUT_RATE, False)[0],
                             "cuda")
    fwd_ok = bool(torch.equal(o.permute(0, 2, 1, 3) != 0, keep))
    dkv_ok = bool(torch.equal(dv.permute(0, 2, 3, 1) != 0, keep))
    if not (fwd_ok and dkv_ok):
        raise AssertionError(f"flash dropout masks: forward {fwd_ok}, "
                             f"dk/dv {dkv_ok}")
    return {"forward": fwd_ok, "dkv": dkv_ok}


def flash_dropout_kernel_phase(seed):
    """The flash kernels with attention dropout 0.1 against the plain
    versions with the same mask, at the training slice's encoder shape
    ([40, 750, 4, 64], lengths {750, 375, 1, 0, drawn}) and ragged causal
    [4, 200]; the masks read bitwise (``_identity_mask_check``).  The
    library times are ``scaled_dot_product_attention`` with
    ``dropout_p=0.1`` (its own generator), forward and backward."""
    import torch
    from torch.nn import functional as F

    from neurst_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(seed + 50)
    key = _site_key(rng, 1 << 16)
    masks = _identity_mask_check(fa, key)
    b, n, h = TRAIN["batch"], 4, 64
    t_main = TRAIN["frames"] // 4
    main_lengths = [t_main, t_main // 2, 1, 0] + list(
        rng.randint(1, t_main + 1, size=b - 4))
    cases = [("main", t_main, main_lengths, False),
             ("ragged_causal", 200, list(rng.randint(0, 201, size=4)), True)]
    results = {}
    for case, t, lengths, causal in cases:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            bb = len(lengths)
            qkv = torch.from_numpy(rng.randn(bb, t, 3, n, h).astype(
                np.float32)).to("cuda", dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            do = torch.from_numpy(rng.randn(bb, t, n, h).astype(
                np.float32)).to("cuda", dtype)
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            fwd_args = (q, k, v, lens, causal, DROPOUT_RATE, key)
            o, lse = fa.flash_attention_fwd(*fwd_args)
            o_ref, lse_ref = fa.flash_attention_reference(*fwd_args)
            delta = fa._delta(o, do)
            args = (q, k, v, do, lse, delta, lens, causal, DROPOUT_RATE, key)
            got = (fa.flash_attention_dq(*args),) + fa.flash_attention_dkv(
                *args)
            want = fa._bwd_plain(*args[:8], fa._drop_consts(DROPOUT_RATE,
                                                            key))
            torch.cuda.synchronize()
            tol, lse_tol = KERNEL_TOL[name]
            fwd_err = _abs_err(o, o_ref)
            lse_err = _abs_err(lse, lse_ref)
            rel = {g: _rel_err(x, y) for g, x, y in zip(
                ("dq", "dk", "dv"), got, want)}
            if fwd_err > tol or lse_err > lse_tol \
                    or max(rel.values()) > BWD_TOL[name]:
                raise AssertionError(
                    f"flash dropout {case} {name}: o err {fwd_err} (tol "
                    f"{tol}), lse {lse_err}, gradients {rel} (tol "
                    f"{BWD_TOL[name]})")
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            mask = _key_mask(lens, t, causal)

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, dropout_p=DROPOUT_RATE)

            library_fwd = time_ms(sdpa)
            library_bwd = time_ms(lambda: torch.autograd.grad(
                sdpa(), (qt, kt, vt), do.transpose(1, 2))) - library_fwd
            plain_bwd = time_ms(lambda: fa._bwd_plain(
                *args[:8], fa._drop_consts(DROPOUT_RATE, key)), iters=3)
            for kernel, fn, fargs, err, plain_ms, library_ms in (
                    ("fwd", fa.flash_attention_fwd, fwd_args, fwd_err,
                     time_ms(lambda: fa.flash_attention_reference(*fwd_args),
                             iters=3), library_fwd),
                    ("dq", fa.flash_attention_dq, args, rel["dq"], plain_bwd,
                     library_bwd),
                    ("dkv", fa.flash_attention_dkv, args,
                     max(rel["dk"], rel["dv"]), plain_bwd, library_bwd)):
                bound, bound_by = attention_bound_ms(q, lens, causal, kernel)
                row = {"phase": "kernel",
                       "kernel": f"flash_attention_{kernel}", "case": case,
                       "dtype": name, "shape": [bb, t, n, h],
                       "causal": causal, "dropout": DROPOUT_RATE,
                       "masks_equal": masks,
                       "max_abs_err": err,
                       "rel_err": rel if kernel != "fwd" else None,
                       "tol": tol if kernel == "fwd" else BWD_TOL[name],
                       "kernel_ms": time_ms(lambda: fn(*fargs)),
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": bound, "bound_by": bound_by}
                emit(row)
                results[(kernel, case, name)] = row
    return results


def _flat_drawers(flat, rng):
    """Functions that draw seeded arrays into ``flat``: kernels as
    fan-in-scaled normals, vectors as small normals, LayerNorm scale and
    bias around 1 and 0."""
    def kernel(name, shape, fan_in):
        flat[name] = (rng.randn(*shape) / math.sqrt(fan_in)).astype(
            np.float32)

    def vec(name, size, mean=0.0, std=0.02):
        flat[name] = (mean + std * rng.randn(size)).astype(np.float32)

    def norm(prefix, size):
        vec(f"{prefix}/scale", size, 1.0, 0.1)
        vec(f"{prefix}/bias", size, 0.0, 0.1)

    return kernel, vec, norm


def _stack_flat_params(flat, rng, p):
    """Seeded weights of the encoder and decoder stacks in the JAX
    package's flat layout (fused projections [D, n, N, H],
    output_transform [N, H, D], dense kernels [in, out])."""
    kernel, vec, norm = _flat_drawers(flat, rng)
    d = p["modality.dim"]

    def attention(prefix, n_heads, fused):
        h = d // n_heads
        projections = ([("qkv_transform", 3)] if fused
                       else [("q_transform", 1), ("kv_transform", 2)])
        for proj, n_proj in projections:
            kernel(f"{prefix}/{proj}/kernel", (d, n_proj, n_heads, h), d)
            flat[f"{prefix}/{proj}/bias"] = (0.02 * rng.randn(
                n_proj, n_heads, h)).astype(np.float32)
        kernel(f"{prefix}/output_transform/kernel", (n_heads, h, d), d)
        vec(f"{prefix}/output_transform/bias", d)

    def ffn(prefix, filter_size):
        kernel(f"{prefix}/dense1/kernel", (d, filter_size), d)
        vec(f"{prefix}/dense1/bias", filter_size)
        kernel(f"{prefix}/dense2/kernel", (filter_size, d), filter_size)
        vec(f"{prefix}/dense2/bias", d)

    for side in ("encoder", "decoder"):
        n_heads = p[f"{side}.num_attention_heads"]
        for i in range(p[f"{side}.num_layers"]):
            layer = f"{side}/layer_{i}"
            attention(f"{layer}/self_attention", n_heads, True)
            norm(f"{layer}/self_attention_ln", d)
            if side == "decoder":
                attention(f"{layer}/cross_attention", n_heads, False)
                norm(f"{layer}/cross_attention_ln", d)
            ffn(f"{layer}/ffn", p[f"{side}.filter_size"])
            norm(f"{layer}/ffn_ln", d)
        norm(f"{side}/output_ln", d)


def speech_transformer_flat_params(cfg, vocab, feature_dim, seed):
    """Seeded random weights for a SpeechTransformer in the JAX package's
    flat-name layout (flax shapes: dense kernels [in, out], fused
    projections [D, n, N, H], output_transform [N, H, D], conv kernels
    [kh, kw, in, out]).  Kernels are fan-in-scaled normals."""
    rng = np.random.RandomState(seed)
    p = cfg["model.params"]
    d, c = p["modality.dim"], p["modality.source.channels"]
    kh = p["modality.source.kernel_size"]
    stride = p["modality.source.strides"]
    flat = {}
    kernel, vec, norm = _flat_drawers(flat, rng)
    cin, freq = 1, feature_dim
    for i in (1, 2):
        kernel(f"input_audio_modality/conv{i}/kernel", (kh, kh, cin, c),
               kh * kh * cin)
        vec(f"input_audio_modality/conv{i}/bias", c)
        if p["modality.source.layer_norm"]:
            norm(f"input_audio_modality/ln{i}", c)
        cin, freq = c, (freq + 2 * (kh // 2) - kh) // stride + 1
    kernel("input_audio_modality/output_dense/kernel", (freq * c, d),
           freq * c)
    vec("input_audio_modality/output_dense/bias", d)
    _stack_flat_params(flat, rng, p)
    flat["target_symbol_modality/weights"] = (
        rng.randn(vocab, d) / math.sqrt(d)).astype(np.float32)
    vec("target_symbol_modality/bias", vocab)
    return flat


def transformer_flat_params(cfg, src_vocab, trg_vocab, seed):
    """Seeded random weights for a Transformer in the JAX package's
    flat-name layout: the stacks as for the speech model, the tied target
    table and its softmax bias, and the source table
    (``input_symbol_modality``; with a shared embedding one
    ``shared_symbol_modality`` serves both sides).  Tables are normals of
    variance 1 / D, as the JAX initializer draws them."""
    rng = np.random.RandomState(seed)
    p = cfg["model.params"]
    d = p["modality.dim"]
    flat = {}
    _stack_flat_params(flat, rng, p)
    target = ("shared_symbol_modality"
              if p.get("modality.share_source_target_embedding")
              else "target_symbol_modality")
    flat[f"{target}/weights"] = (
        rng.randn(trg_vocab, d) / math.sqrt(d)).astype(np.float32)
    flat[f"{target}/bias"] = (0.02 * rng.randn(trg_vocab)).astype(np.float32)
    if target == "target_symbol_modality":
        flat["input_symbol_modality/weights"] = (
            rng.randn(src_vocab, d) / math.sqrt(d)).astype(np.float32)
    return flat


def build_slice(seed, device="cuda", dtype="bfloat16"):
    """The slice's model (weights from ``seed`` in the JAX flat layout,
    loaded through ``param_bridge``; bf16 models store them in bf16), its
    beam search, and a function drawing one request of seeded random
    fbank frames."""
    import torch

    import neurst_tpu_torch
    from neurst_tpu_torch.models.speech_transformer import SpeechTransformer
    from neurst_tpu_torch.utils.param_bridge import load_flat_params
    from neurst_tpu_torch.utils.param_policy import cast_params_for_inference

    cfg = SpeechTransformer.build_model_args_by_name(SLICE["model"])
    params = dict(cfg["model.params"], dtype=dtype)
    params["encoder.enable_flash_attention"] = True
    trg_meta = {"vocab_size": SLICE["vocab"], "eos_id": 1, "bos_id": 2,
                "unk_id": 3}
    src_meta = {"audio_feature_dim": SLICE["feature_dim"],
                "audio_feature_channels": 1}
    model = neurst_tpu_torch.build_model(
        dict(cfg, **{"model.params": params}), src_meta=src_meta,
        trg_meta=trg_meta, device=device)
    flat = speech_transformer_flat_params(cfg, SLICE["vocab"],
                                          SLICE["feature_dim"], seed)
    load_flat_params(model, flat)
    cast_params_for_inference(model, params["dtype"])

    search = neurst_tpu_torch.build_search_layer({
        "search_method.class": "beam_search",
        "search_method.params": {
            "beam_size": SLICE["beam"],
            "maximum_decode_length": SLICE["max_decode"],
            "extra_decode_length": SLICE["max_decode"],
            "minimum_decode_length": SLICE["max_decode"] - 1}})
    search.set_model(model)

    rng = np.random.RandomState(seed + 1)
    b, frames = SLICE["batch"], SLICE["frames"]

    def request():
        return {"src": torch.from_numpy(rng.randn(
                    b, frames, SLICE["feature_dim"], 1).astype(np.float32)
                ).to(device),
                "src_length": torch.from_numpy(rng.randint(
                    SLICE["min_src"], frames + 1, size=b).astype(np.int32)
                ).to(device)}

    return model, search, request


def slice_phase(seed):
    import torch

    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts

    model, search, request = build_slice(seed)
    b, frames = SLICE["batch"], SLICE["frames"]
    num_layers = model.encoder.num_layers
    search(request())  # warm-up: cuBLAS/cuDNN handles and plans
    requests = [request() for _ in range(SLICE["requests"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    per_request, request_ms = [], []
    for inputs in requests:
        before = launch_counts()["flash_attention_fwd"]
        start = time.perf_counter()
        hyps, scores = search(inputs)
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - start) * 1e3)
        launches = launch_counts()["flash_attention_fwd"] - before
        per_request.append(launches)
        if tuple(hyps.shape) != (b, SLICE["max_decode"]):
            raise AssertionError(f"hypotheses {tuple(hyps.shape)}")
        if not bool(torch.isfinite(scores).all()):
            raise AssertionError("non-finite beam scores")
        if launches != num_layers:
            raise AssertionError(f"flash_attention_fwd ran {launches} "
                                 f"times in a request, expected "
                                 f"{num_layers}")
    # decode runs the flash forward only: no backward, no fused xent
    counts = {"flash_attention_fwd": launch_counts()["flash_attention_fwd"]}
    peak_bytes = torch.cuda.max_memory_allocated()
    if any(v == 0 for v in counts.values()):
        raise AssertionError(f"a kernel of the path never ran: {counts}")

    def encode_once():
        with torch.inference_mode():
            model.prepare_generation(requests[0], SLICE["max_decode"])
        torch.cuda.synchronize()

    encode_times = []
    for _ in range(5):
        start = time.perf_counter()
        encode_once()
        encode_times.append((time.perf_counter() - start) * 1e3)
    encode_ms = float(np.median(encode_times))
    total_ms = float(np.median(request_ms))
    emit({"phase": "slice", "model": SLICE["model"], "dtype": "bfloat16",
          "batch": b, "frames": frames, "beam": SLICE["beam"],
          "max_decode": SLICE["max_decode"], "requests": len(requests),
          "request_ms": request_ms, "utt_per_s": b / (total_ms / 1e3),
          "encode_ms": encode_ms, "step_loop_ms": total_ms - encode_ms,
          "launches": counts, "launches_per_request": per_request,
          "max_memory_allocated": peak_bytes,
          "hypotheses_head": hyps[0, :8].tolist()})
    return model, requests[0], counts


def _random_word(rng, low, high):
    return "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"),
                              int(rng.randint(low, high + 1))))


def write_predict_dir(seed, root):
    """Everything the predict CLI reads, from ``seed``, under ``root``: a
    model dir (``ckpt-1.npz`` of ``speech_transformer_flat_params`` in
    the JAX package's flat layout, written by the port's
    ``save_checkpoint``, and ``model_configs.yml`` as JSON text), a
    vocabulary of 8189 subword units (8192 with the pipeline's three
    control tokens) with BPE codes over them, ``audio_tfrecord`` files of
    fbank-like features with raw translations (the 64 utterances, and
    the 4 short ones of the card-vs-CPU check), and the recipe's
    prediction config as JSON.  The pipeline adds the Moses tokenizer
    where sacremoses imports."""
    from neurst_tpu_torch.data.recordio import RecordWriter, build_example
    from neurst_tpu_torch.data.text.moses import HAS_SACREMOSES
    from neurst_tpu_torch.models.speech_transformer import SpeechTransformer
    from neurst_tpu_torch.utils.checkpoints import save_checkpoint

    rng = np.random.RandomState(seed + 70)
    units = set()
    while len(units) < PREDICT["vocab"] - 3:
        unit = _random_word(rng, 1, 6)
        units.add(unit + "@@" if rng.rand() < 0.5 else unit)
    units = sorted(units)
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(units) + "\n")
    codes = os.path.join(root, "codes.bpe")
    with open(codes, "w") as f:
        f.write("#version: 0.2\n" + "\n".join(
            f"{u[0]} {u[1]}" for u in units if len(u) == 2) + "\n")
    pipeline = {"vocab_path": vocab, "language": "en",
                "subtokenizer": "bpe", "subtokenizer_codes": codes,
                "tokenizer": "moses" if HAS_SACREMOSES else None}

    cfg = SpeechTransformer.build_model_args_by_name(PREDICT["model"])
    params = dict(cfg["model.params"], dtype="bfloat16")
    params["encoder.enable_flash_attention"] = True
    model_dir = os.path.join(root, "model")
    save_checkpoint(model_dir, 1, speech_transformer_flat_params(
        cfg, PREDICT["vocab"], PREDICT["feature_dim"], seed))
    with open(os.path.join(model_dir, "model_configs.yml"), "w") as f:
        json.dump({"task.class": "SpeechToText", "task.params": {
                       "audio_feature_dim": PREDICT["feature_dim"],
                       "audio_feature_channels": 1,
                       "transcript_data_pipeline.class": "TextDataPipeline",
                       "transcript_data_pipeline.params": pipeline},
                   "model.class": "SpeechTransformer",
                   "model.params": params}, f, indent=1)

    out = {"model_dir": model_dir, "moses": HAS_SACREMOSES}
    for name, n, max_frames in (
            ("main", PREDICT["utterances"], PREDICT["max_frames"]),
            ("check", PREDICT["check_utterances"],
             PREDICT["check_max_frames"])):
        records = os.path.join(root, f"{name}.tfrecords")
        with RecordWriter(records) as w:
            for _ in range(n):
                frames = int(rng.randint(PREDICT["min_frames"],
                                         max_frames + 1))
                audio = rng.randn(frames, PREDICT["feature_dim"]).astype(
                    np.float32)
                words = [_random_word(rng, 2, 8) for _ in range(
                    rng.randint(PREDICT["min_words"],
                                PREDICT["max_words"] + 1))]
                w.write(build_example({"audio": audio.reshape(-1),
                                       "translation": " ".join(words)}))
        config = json.loads(json.dumps(PREDICT_ARGS))
        config["dataset.params"]["data_path"] = records
        config["entry.params"]["output_file"] = os.path.join(
            root, f"hypo.{name}.txt")
        out[name] = os.path.join(root, f"predict.{name}.json")
        with open(out[name], "w") as f:
            json.dump(config, f, indent=1)
    return out


def direct_hypotheses(argv, device):
    """The hypotheses of the CLI's batches from ``BeamSearch`` called
    directly on a model restored by hand, decoded by the task's pipeline
    (rows that ``sample_mask`` drops skipped)."""
    from neurst_tpu_torch.cli import run_exp
    from neurst_tpu_torch.data.datasets.dataset import build_dataset
    from neurst_tpu_torch.layers.search.beam_search import BeamSearch
    from neurst_tpu_torch.tasks.task import build_task
    from neurst_tpu_torch.utils.checkpoints import (latest_checkpoint,
                                                    restore_checkpoint_params)
    from neurst_tpu_torch.utils.compat import DataStatus, ModeKeys
    from neurst_tpu_torch.utils.param_policy import restore_inference_params

    args = run_exp.parse_and_merge(argv)
    task, ds = build_task(args), build_dataset(args)
    model = task.build_model({"model.class": args["model.class"],
                              "model.params": args["model.params"]},
                             device=device)
    restore_inference_params(model, restore_checkpoint_params(
        latest_checkpoint(args["model_dir"])))
    search = BeamSearch(PREDICT_ARGS["entry.params"]["search_method.params"])
    search.set_model(model)
    decode = task.get_data_postprocess_fn(DataStatus.PROJECTED)
    out = []
    for batch in task.create_batch_iterator(ds, ModeKeys.INFER,
                                            args["entry.params"])():
        hyps, _ = search(batch)
        for row, keep in zip(hyps.cpu().tolist(), batch["sample_mask"]):
            if keep:
                out.append(decode(row))
    return out


def predict_phase(seed):
    """The predict CLI (``neurst_tpu_torch.cli.run_exp``) in-process on
    the card, over a model dir and records written from ``seed``: 64
    samples and 64 output lines; flash forward launches = 12 a batch;
    the CLI's hypotheses equal, string for string, those of
    ``BeamSearch`` called directly on the same batches; BLEU computed
    (random weights: its value means nothing); samples/s, the wall
    split, the first batch's latency and peak memory.  Then the float32
    card-vs-CPU check: the CLI on 4 short utterances with ``--dtype
    float32`` gives the same hypotheses with ``--device cuda`` and
    ``--device cpu``.  Returns the launch counts of the CLI run."""
    import torch

    from neurst_tpu_torch.cli import run_exp
    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "predict_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        start = time.perf_counter()
        paths = write_predict_dir(seed, root)
        write_s = time.perf_counter() - start
        argv = ["--config_paths", paths["main"], "--model_dir",
                paths["model_dir"]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        start = time.perf_counter()
        result = run_exp.cli_main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - start
        counts = launch_counts()
        peak_bytes = torch.cuda.max_memory_allocated()
        with open(os.path.join(root, "hypo.main.txt")) as f:
            lines = f.read().splitlines()
        batches = -(-PREDICT["utterances"] // PREDICT["batch"])
        direct = direct_hypotheses(argv, "cuda")
        check = {}
        for device in ("cuda", "cpu"):
            check[device] = run_exp.cli_main(
                ["--config_paths", paths["check"], "--model_dir",
                 paths["model_dir"], "--dtype", "float32", "--device",
                 device])["hypotheses"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    flash = counts["flash_attention_fwd"]
    row = {"phase": "predict", "model": PREDICT["model"], "dtype": "bfloat16",
           "tokenizer": "moses + bpe" if paths["moses"]
           else "bpe (sacremoses missing: no Moses)",
           "samples": result["samples"], "output_lines": len(lines),
           "batches": batches, "batch_size": PREDICT["batch"],
           "flash_fwd_launches": flash,
           "flash_fwd_expected": 12 * batches,
           "BLEU": result["BLEU"], "UncasedBLEU": result["UncasedBLEU"],
           "samples_per_s": result["samples_per_sec"],
           "cli_wall_s": wall_s, "write_inputs_s": write_s,
           "timing_s": result["timing"],
           "max_memory_allocated": peak_bytes,
           "hypotheses_equal_direct_beam_search": result["hypotheses"]
           == direct,
           "f32_card_vs_cpu_hypotheses_equal": check["cuda"] == check["cpu"],
           "f32_check_samples": len(check["cpu"]),
           "hypothesis_head": result["hypotheses"][0][:80]}
    emit(row)
    if not (result["samples"] == len(lines) == PREDICT["utterances"]
            and flash == 12 * batches
            and row["hypotheses_equal_direct_beam_search"]
            and row["f32_card_vs_cpu_hypotheses_equal"]
            and len(check["cpu"]) == PREDICT["check_utterances"]
            and math.isfinite(result["BLEU"])):
        raise AssertionError(f"predict phase failed: {row}")
    return {"flash_attention_fwd": flash}


def encoder_cross_check_phase(model, inputs):
    import torch
    with torch.inference_mode():
        model.encoder.enable_flash_attention = True
        flash, padding = model.encode(inputs)
        model.encoder.enable_flash_attention = False
        plain, _ = model.encode(inputs)
        model.encoder.enable_flash_attention = True
    valid = (padding == 0)[..., None]
    diff = ((flash.float() - plain.float()).abs() * valid)
    max_err = float(diff.max())
    mean_err = float(diff.sum() / (valid.sum() * flash.shape[-1]))
    finite = bool(torch.isfinite(flash.float()).all())
    emit({"phase": "encoder_cross_check", "shape": list(flash.shape),
          "max_abs_err": max_err, "mean_abs_err": mean_err,
          "tol": list(ENCODER_TOL), "finite": finite})
    if not (finite and max_err <= ENCODER_TOL[0]
            and mean_err <= ENCODER_TOL[1]):
        raise AssertionError("flash and plain encoder outputs disagree")


def reference_check_phase(seed):
    """The whole path in float32 on the card (flash kernel included)
    against the same path on the CPU, where every kernel runs its plain
    version and which the CPU tests hold against the JAX package: a
    small request of 2 x 256 frames."""
    import torch
    outputs = {}
    for device in ("cuda", "cpu"):
        model, search, _ = build_slice(seed, device, "float32")
        rng = np.random.RandomState(seed + 2)
        inputs = {"src": torch.from_numpy(rng.randn(
                      2, 256, SLICE["feature_dim"], 1).astype(np.float32)
                  ).to(device),
                  "src_length": torch.tensor([256, 173], dtype=torch.int32,
                                             device=device)}
        with torch.inference_mode():
            enc, _ = model.encode(inputs)
        hyps, scores = search(inputs)
        outputs[device] = (enc.cpu(), hyps.cpu(), scores.cpu())
    enc_err = float((outputs["cuda"][0] - outputs["cpu"][0]).abs().max())
    same_hyps = bool(torch.equal(outputs["cuda"][1], outputs["cpu"][1]))
    score_err = float((outputs["cuda"][2] - outputs["cpu"][2]).abs().max())
    emit({"phase": "reference_check", "dtype": "float32",
          "encoder_max_abs_err": enc_err, "encoder_tol": REFERENCE_TOL[0],
          "hypotheses_equal": same_hyps, "score_max_abs_err": score_err,
          "score_tol": REFERENCE_TOL[1]})
    if not (enc_err <= REFERENCE_TOL[0] and same_hyps
            and score_err <= REFERENCE_TOL[1]):
        raise AssertionError("the card's float32 path disagrees with the "
                             "CPU path")


def build_train(seed, device="cuda", dtype="bfloat16", dropout=0.0):
    """The training slice through the entry points the JAX trainer uses:
    ``build_model`` with weights from ``seed`` in the JAX flat layout
    (through ``param_bridge``), the recipe's noam schedule and Adam,
    and, for a bf16 model, bf16 stored params with an f32 master (the
    trainer's default for a bf16 model); the label-smoothed criterion,
    ``TrainState.create`` and ``make_train_step``.  ``dropout`` is the
    rate of all six dropout sites (the recipe's is 0.1)."""
    import neurst_tpu_torch
    from neurst_tpu_torch.models.speech_transformer import SpeechTransformer
    from neurst_tpu_torch.optimizers.master_weights import (
        cast_params_bf16, with_bf16_params)
    from neurst_tpu_torch.optimizers.optimizers import create_optax_chain
    from neurst_tpu_torch.parallel import TrainState, make_train_step
    from neurst_tpu_torch.utils.param_bridge import load_flat_params

    cfg = SpeechTransformer.build_model_args_by_name(TRAIN["model"])
    params = dict(cfg["model.params"], dtype=dtype)
    params["encoder.enable_flash_attention"] = True
    for side in ("encoder", "decoder"):
        for rate in ("attention_dropout_rate", "ffn_dropout_rate",
                     "layer_postprocess_dropout_rate"):
            params[f"{side}.{rate}"] = dropout
    model = neurst_tpu_torch.build_model(
        dict(cfg, **{"model.params": params}),
        src_meta={"audio_feature_dim": TRAIN["feature_dim"],
                  "audio_feature_channels": 1},
        trg_meta={"vocab_size": TRAIN["vocab"], "eos_id": 1, "bos_id": 2,
                  "unk_id": 3}, device=device)
    load_flat_params(model, speech_transformer_flat_params(
        cfg, TRAIN["vocab"], TRAIN["feature_dim"], seed))
    lr = neurst_tpu_torch.build_lr_schedule(cfg)
    tx = create_optax_chain(neurst_tpu_torch.build_optimizer(cfg), lr)
    if dtype == "bfloat16":
        cast_params_bf16(model)
        tx = with_bf16_params(tx)
    criterion = neurst_tpu_torch.build_criterion({
        "criterion.class": "label_smoothed_cross_entropy",
        "criterion.params": {"label_smoothing": TRAIN["label_smoothing"]}})
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, criterion, tx, lr_schedule=lr)
    return model, criterion, tx, state, step


def train_batch(rng, device, batch, frames, min_src, trg_len, min_trg):
    """A bucketed batch of seeded fbank frames and token ids: source
    lengths in [min_src, frames], target lengths in [min_trg, trg_len]
    with ``trg_padding`` marking the rest."""
    import torch
    trg_lengths = rng.randint(min_trg, trg_len + 1, size=batch)
    arrays = {
        "src": rng.randn(batch, frames, TRAIN["feature_dim"], 1).astype(
            np.float32),
        "src_length": rng.randint(min_src, frames + 1, size=batch).astype(
            np.int32),
        "trg_input": rng.randint(4, TRAIN["vocab"], size=(batch, trg_len)),
        "trg": rng.randint(4, TRAIN["vocab"], size=(batch, trg_len)),
        "trg_padding": (np.arange(trg_len)[None] >= trg_lengths[:, None]
                        ).astype(np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def expected_launches(model, enc_rows, dec_rows, dropout):
    """Kernel launches of one training step, from the configuration and
    the wrappers' plans: the encoder's flash kernels once a layer; the
    fused xent forward's launches (its combine too where it splits the
    vocabulary) and its backward's; the fused FFN
    where its gate says so, with its forward's launches at each row count
    and three backward launches; with dropout, the mask kernel at every
    site the kernels above do not cover (two postprocess sites an encoder
    layer, three a decoder layer, the decoder's two attention-weight
    sites, the FFN hidden where it is not fused), once forward and once
    backward."""
    from neurst_tpu_torch.ops.fused_ce import bwd_launches
    from neurst_tpu_torch.ops.fused_ce import \
        fwd_launches as xent_fwd_launches
    from neurst_tpu_torch.ops.fused_ffn import (fused_ffn_available,
                                                fwd_launches)
    enc, dec = model.encoder, model.decoder
    dense1 = enc.layer_0.ffn.dense1
    dtype = enc.layer_0.ffn.dtype  # the compute dtype of FFN and xent
    rate = DROPOUT_RATE if dropout else 0.0

    def fused(rows):
        return fused_ffn_available(dense1.in_features, dense1.out_features,
                                   "relu", rows, True, rate)

    flash = enc.num_layers if enc.enable_flash_attention else 0
    layers = [(enc.num_layers, enc_rows), (dec.num_layers, dec_rows)]
    ffn = sum(n * fused(rows) for n, rows in layers)
    ffn_fwd = sum(n * fused(rows) * fwd_launches(
        rows, dense1.out_features, dense1.in_features, dtype)
        for n, rows in layers)
    sites = 0
    if dropout:
        sites = enc.num_layers * (2 + (not enc.enable_flash_attention)
                                  + (not fused(enc_rows)))
        sites += dec.num_layers * (5 + (not fused(dec_rows)))
    return {"flash_attention_fwd": flash, "flash_attention_dq": flash,
            "flash_attention_dkv": flash,
            "fused_linear_xent_fwd": xent_fwd_launches(
                dec_rows, model.trg_meta["vocab_size"], dense1.in_features,
                dtype),
            "fused_linear_xent_bwd": bwd_launches(dtype),
            "fused_softmax_xent_fwd": 0, "fused_softmax_xent_bwd": 0,
            "fused_dropout": 2 * sites, "fused_ffn_fwd": ffn_fwd,
            "fused_ffn_bwd": 3 * ffn}


def _drive_train(model, criterion, tx, state, step, batches, warmup,
                 steps, key, expected):
    """``warmup`` steps, then ``steps`` timed steps (launches per step of
    every kernel held to ``expected``), then the step's three parts
    timed apart on the remaining batches.  Checks finite losses and grad
    norms, that every stored parameter moved (the float32 master's, with
    bf16 params), and with ``key`` that the same (key, step) gives a
    bitwise equal loss and the next step another.  Returns the
    measurements and the launch totals."""
    import torch

    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
    from neurst_tpu_torch.optimizers.optimizers import apply_updates
    from neurst_tpu_torch.utils.rng import fold_in

    timed = batches[warmup:warmup + steps]
    has_master = isinstance(state.opt_state, dict) \
        and "master" in state.opt_state
    stored = state.opt_state["master"] if has_master else state.params
    stored0 = {n: m.detach().clone() for n, m in stored.items()}
    live0 = {n: p.detach().clone() for n, p in state.params.items()} \
        if has_master else stored0
    for batch in batches[:warmup]:
        state, _ = step(state, batch, key)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, per_step, metrics = [], [], []
    totals = dict.fromkeys(expected, 0)
    for batch in timed:
        reset_launch_counts()
        start = time.perf_counter()
        state, m = step(state, batch, key)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
        counts = launch_counts()
        per_step.append(counts)
        for name in totals:
            totals[name] += counts[name]
        metrics.append({k: float(v) for k, v in m.items()})
        if counts != expected:
            raise AssertionError(f"launches in a train step {counts}, "
                                 f"expected {expected}")
    peak_bytes = torch.cuda.max_memory_allocated()
    if not all(np.isfinite([m["loss"], m["grad_norm"]]).all()
               for m in metrics):
        raise AssertionError(f"non-finite loss or grad norm: {metrics}")
    stored = state.opt_state["master"] if has_master else state.params
    unmoved = [n for n in stored if torch.equal(stored[n], stored0[n])]
    if unmoved:
        raise AssertionError(f"parameters that did not move: {unmoved}")
    live_moved = sum(int((p.detach() != live0[n]).sum())
                     for n, p in state.params.items())
    determinism = None
    if key is not None:
        losses = [float(step.compute_grads(state.params, timed[0],
                                           fold_in(key, s))[0])
                  for s in (state.step, state.step, state.step + 1)]
        determinism = {"same_step": losses[:2], "next_step": losses[2]}
        if losses[0] != losses[1] or losses[0] == losses[2]:
            raise AssertionError(f"dropout losses of (step, step, step + 1): "
                                 f"{losses}")

    # the step's parts timed apart: forward (with the criterion),
    # backward, optimizer update
    params = state.params
    split = []
    for batch in batches[warmup + steps:]:
        marks = [time.perf_counter()]
        out, aux = model.call_train(
            batch, model.supports_fused_softmax_ce(),
            None if key is None else fold_in(key, state.step))
        loss = criterion.reduce_loss(batch, out) + aux
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        updates, state.opt_state = tx.update(dict(zip(params, grads)),
                                             state.opt_state, params)
        apply_updates(params, updates)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        split.append([(b_ - a) * 1e3 for a, b_ in zip(marks, marks[1:])])
    return {"steps": len(timed), "step_ms": step_ms,
            "step_ms_median": float(np.median(step_ms)),
            "split_ms": {k: float(np.median([s_[i] for s_ in split]))
                         for i, k in enumerate(("forward", "backward",
                                                "optimizer"))},
            "split_runs_ms": split, "max_memory_allocated": peak_bytes,
            "launches_per_step": per_step,
            "loss": [m["loss"] for m in metrics],
            "grad_norm": [m["grad_norm"] for m in metrics],
            "lr": [m["lr"] for m in metrics],
            "live_values_moved": live_moved,
            "stored_tensors_moved": len(stored),
            "expected_launches_per_step": expected,
            "dropout_determinism": determinism}, totals


def train_phase(seed, dropout=False):
    """The speech training slice: warm-up steps, then timed steps on
    fresh batches (launches per step of every kernel checked against the
    configuration), then the step's three parts timed apart.  With
    ``dropout`` (the recipe's 0.1 at every site) the step takes a dropout
    key, and the same (key, step) must give a bitwise equal loss while
    the next step's masks give another."""
    from neurst_tpu_torch.utils.rng import make_key

    model, criterion, tx, state, step = build_train(
        seed, dropout=DROPOUT_RATE if dropout else 0.0)
    key = make_key(seed + 7) if dropout else None
    rng = np.random.RandomState(seed + 3)
    batches = [train_batch(rng, "cuda", TRAIN["batch"], TRAIN["frames"],
                           TRAIN["min_src"], TRAIN["trg_len"],
                           TRAIN["min_trg"])
               for _ in range(TRAIN["warmup"] + TRAIN["steps"]
                              + TRAIN["split"])]
    expected = expected_launches(
        model, TRAIN["batch"] * TRAIN["frames"] // 4,
        TRAIN["batch"] * TRAIN["trg_len"], dropout)
    out, totals = _drive_train(model, criterion, tx, state, step, batches,
                               TRAIN["warmup"], TRAIN["steps"], key,
                               expected)
    timed = batches[TRAIN["warmup"]:TRAIN["warmup"] + TRAIN["steps"]]
    median_s = out["step_ms_median"] / 1e3
    tokens = float(np.mean([float((1.0 - b["trg_padding"]).sum())
                            for b in timed]))
    frames = float(np.mean([float(b["src_length"].sum()) for b in timed]))
    emit(dict({"phase": "train_dropout" if dropout else "train",
               "model": TRAIN["model"], "dtype": "bfloat16",
               "dropout": DROPOUT_RATE if dropout else 0.0,
               "bf16_params": True, "batch": TRAIN["batch"],
               "frames": TRAIN["frames"], "trg_len": TRAIN["trg_len"],
               "target_tokens_per_s": tokens / median_s,
               "frames_per_s": frames / median_s}, **out))
    return totals


def build_nmt_train(seed, device="cuda", dtype="bfloat16", bf16_params=True,
                    dropout=DROPOUT_RATE, model_name=None, src_vocab=None,
                    trg_vocab=None):
    """The NMT training cell through the entry points the JAX trainer
    uses: ``build_model("transformer")`` with weights from ``seed`` in
    the JAX flat layout (through ``param_bridge``), the hparams set's
    Adam and noam schedule with bench.py's clip norm, with bf16 params
    and an f32 master where ``bf16_params`` (bench.py's
    ``with_bf16_params`` variant), the label-smoothed criterion,
    ``TrainState.create`` and ``make_train_step``.  ``dropout`` is the
    rate of all six dropout sites (the hparams set's is 0.1)."""
    import neurst_tpu_torch
    from neurst_tpu_torch.models.transformer import Transformer
    from neurst_tpu_torch.optimizers.master_weights import (
        cast_params_bf16, with_bf16_params)
    from neurst_tpu_torch.optimizers.optimizers import create_optax_chain
    from neurst_tpu_torch.parallel import TrainState, make_train_step
    from neurst_tpu_torch.utils.param_bridge import load_flat_params

    src_vocab = src_vocab or NMT_TRAIN["vocab"]
    trg_vocab = trg_vocab or NMT_TRAIN["vocab"]
    cfg = Transformer.build_model_args_by_name(
        model_name or NMT_TRAIN["model"])
    params = dict(cfg["model.params"], dtype=dtype)
    for side in ("encoder", "decoder"):
        for rate in ("attention_dropout_rate", "ffn_dropout_rate",
                     "layer_postprocess_dropout_rate"):
            params[f"{side}.{rate}"] = dropout
    cfg = dict(cfg, **{"model.params": params})

    def meta(vocab):
        return {"vocab_size": vocab, "eos_id": 1, "bos_id": 2, "unk_id": 3}

    model = neurst_tpu_torch.build_model(
        cfg, src_meta=meta(src_vocab), trg_meta=meta(trg_vocab),
        device=device)
    load_flat_params(model, transformer_flat_params(cfg, src_vocab,
                                                    trg_vocab, seed))
    lr = neurst_tpu_torch.build_lr_schedule(cfg)
    tx = create_optax_chain(neurst_tpu_torch.build_optimizer(cfg), lr,
                            clip_norm=NMT_TRAIN["clip_norm"])
    if bf16_params:
        cast_params_bf16(model)
        tx = with_bf16_params(tx)
    criterion = neurst_tpu_torch.build_criterion({
        "criterion.class": "label_smoothed_cross_entropy",
        "criterion.params": {
            "label_smoothing": NMT_TRAIN["label_smoothing"]}})
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, criterion, tx, lr_schedule=lr)
    return model, criterion, tx, state, step


def nmt_batch(rng, device, batch, length, src_vocab, trg_vocab):
    """bench.py's train batch: seeded token ids [batch, length] on both
    sides, no padding."""
    import torch
    arrays = {
        "src": rng.randint(4, src_vocab, size=(batch, length)),
        "src_padding": np.zeros((batch, length), np.float32),
        "trg_input": rng.randint(4, trg_vocab, size=(batch, length)),
        "trg": rng.randint(4, trg_vocab, size=(batch, length)),
        "trg_padding": np.zeros((batch, length), np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def train_flops(n_src_tok, n_trg_tok, dmodel=512, layers=6, ffn=2048,
                vocab=32768, batch=256, length=128):
    """bench.py's analytic transformer_base train FLOPs
    (``bench.py:425-441`` ``_train_flops``: forward + 2x backward = 3x
    forward; the matmuls, the tied softmax and the attention scores and
    context at full length)."""
    enc_mat = layers * (4 * dmodel * dmodel + 2 * dmodel * ffn)
    dec_mat = layers * (8 * dmodel * dmodel + 2 * dmodel * ffn)
    softmax_mat = dmodel * vocab
    fwd_mat = 2 * (enc_mat * n_src_tok
                   + (dec_mat + softmax_mat) * n_trg_tok)
    att = 4 * dmodel * layers * batch * 3 * length * length
    return 3 * (fwd_mat + att)


def nmt_train_phase(seed, bf16_params):
    """The NMT train cell (``NMT_TRAIN``): transformer_base at
    [256, 128], dropout 0.1 with a dropout key, float32 stored params or
    bf16 params with an f32 master.  Target tokens/s, MFU (bench.py's
    FLOPs over the median step and the bf16 peak), the split and peak
    memory; launches per step held to the configuration (attention runs
    dense: flash is off)."""
    from neurst_tpu_torch.utils.rng import make_key

    t = NMT_TRAIN
    model, criterion, tx, state, step = build_nmt_train(
        seed, bf16_params=bf16_params)
    key = make_key(seed + 9)
    rng = np.random.RandomState(seed + 10)
    batches = [nmt_batch(rng, "cuda", t["batch"], t["length"], t["vocab"],
                         t["vocab"])
               for _ in range(t["warmup"] + t["steps"] + t["split"])]
    rows = t["batch"] * t["length"]
    expected = expected_launches(model, rows, rows, True)
    layers = model.encoder.num_layers + model.decoder.num_layers
    if expected["fused_ffn_bwd"] != 3 * layers:
        raise AssertionError(f"every FFN of the cell must run the fused "
                             f"FFN at D 512: {expected}")
    out, totals = _drive_train(model, criterion, tx, state, step, batches,
                               t["warmup"], t["steps"], key, expected)
    median_s = out["step_ms_median"] / 1e3
    flops = train_flops(rows, rows, batch=t["batch"], length=t["length"],
                        vocab=t["vocab"])
    emit(dict({"phase": "train_base_bf16" if bf16_params else "train_base",
               "model": t["model"], "dtype": "bfloat16",
               "dropout": DROPOUT_RATE, "bf16_params": bf16_params,
               "batch": t["batch"], "length": t["length"],
               "vocab": t["vocab"],
               "target_tokens_per_s": rows / median_s,
               "train_flops": flops,
               "mfu": flops / median_s / PEAK_FLOPS["bfloat16"]}, **out))
    return totals


def train_reference_check_phase(seed, dropout=False, nmt=False):
    """One float32 training step on a small batch, on the card (kernels)
    and on the CPU (plain versions, which the CPU tests hold against the
    JAX package's step): the full-width speech model on 2 x 256 frames,
    or with ``nmt`` the text model ``NMT_TRAIN["check_model"]`` on
    [2, 16] ids; with ``dropout`` at the recipe's 0.1, whose masks the
    kernels and the plain versions draw bit for bit alike."""
    import torch

    from neurst_tpu_torch.utils.rng import fold_in, make_key
    key = make_key(seed + 8) if dropout else None
    rate = DROPOUT_RATE if dropout else 0.0
    t = NMT_TRAIN
    outs = {}
    for device in ("cuda", "cpu"):
        if nmt:
            model, _, _, state, step = build_nmt_train(
                seed, device, "float32", False, rate, t["check_model"],
                t["check_src_vocab"], t["check_trg_vocab"])
            batch = nmt_batch(np.random.RandomState(seed + 4), device,
                              t["check_batch"], t["check_length"],
                              t["check_src_vocab"], t["check_trg_vocab"])
        else:
            model, _, _, state, step = build_train(seed, device, "float32",
                                                   rate)
            batch = train_batch(np.random.RandomState(seed + 4), device, 2,
                                256, 200, 16, 10)
        loss, _, grads = step.compute_grads(
            state.params, batch, None if key is None else fold_in(key, 0))
        state, metrics = step(state, batch, key)
        outs[device] = (float(loss), {n: g.cpu() for n, g in grads.items()},
                        {k: float(v) for k, v in metrics.items()},
                        {n: p.detach().cpu() for n, p in state.params.items()})
    (loss, grads, metrics, params), (ref_loss, ref_grads, ref_metrics,
                                     ref_params) = outs["cuda"], outs["cpu"]
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    norm_err = abs(metrics["grad_norm"] - ref_metrics["grad_norm"]) \
        / ref_metrics["grad_norm"]
    grad_err, worst = max(
        (float((grads[n] - ref_grads[n]).norm()
               / ref_grads[n].norm().clamp_min(1e-30)), n)
        for n in ref_grads)
    param_err = max(_abs_err(params[n], ref_params[n]) for n in ref_params)
    param_tol = 2 * ref_metrics["lr"] + 1e-6
    shape = ({"model": t["check_model"], "batch": t["check_batch"],
              "length": t["check_length"]} if nmt else
             {"model": TRAIN["model"], "batch": 2, "frames": 256,
              "trg_len": 16})
    emit({"phase": "train_reference_check", "dtype": "float32",
          "dropout": rate, **shape, "loss_rel_err": loss_err,
          "grad_norm_rel_err": norm_err, "max_grad_rel_l2_err": grad_err,
          "worst_grad": worst,
          "max_param_abs_err": param_err,
          "tol": [TRAIN_REF_TOL[0], TRAIN_REF_TOL[1], param_tol],
          "loss": loss, "grad_norm": metrics["grad_norm"]})
    if not (loss_err <= TRAIN_REF_TOL[0] and norm_err <= TRAIN_REF_TOL[0]
            and grad_err <= TRAIN_REF_TOL[1] and param_err <= param_tol):
        raise AssertionError("the card's float32 train step disagrees with "
                             "the CPU step")


def _summary_row(name, row, launches, by_path, extra):
    """The kernel's summary entry from its phase row at the main shape;
    ``extra`` maps a label ("with_dropout", "nmt_train") to the row of
    another case whose numbers ride along under that label."""
    def numbers(r):
        return {"max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
    out = dict({"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches,
                "launches_by_path": by_path}, **numbers(row))
    for label, other in extra.items():
        out[label] = dict(numbers(other), shape=other["shape"])
    return out


SOURCES = {
    "flash_attention_fwd": "neurst_tpu_torch/csrc/flash_attention_fwd.cu",
    "flash_attention_dq": "neurst_tpu_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_dkv": "neurst_tpu_torch/csrc/flash_attention_bwd.cu",
    "fused_linear_xent_fwd": "neurst_tpu_torch/csrc/fused_linear_xent.cu",
    "fused_linear_xent_bwd": "neurst_tpu_torch/csrc/fused_linear_xent.cu",
    "fused_softmax_xent_fwd": "neurst_tpu_torch/csrc/fused_softmax_xent.cu",
    "fused_softmax_xent_bwd": "neurst_tpu_torch/csrc/fused_softmax_xent.cu",
    "fused_dropout": "neurst_tpu_torch/csrc/fused_dropout.cu",
    "fused_ffn_fwd": "neurst_tpu_torch/csrc/fused_ffn.cu",
    "fused_ffn_bwd": "neurst_tpu_torch/csrc/fused_ffn.cu"}
REPLACES = {
    "flash_attention_fwd": "neurst_tpu/ops/flash_attention.py:96",
    "flash_attention_dq": "neurst_tpu/ops/flash_attention.py:176",
    "flash_attention_dkv": "neurst_tpu/ops/flash_attention.py:244",
    "fused_linear_xent_fwd": "neurst_tpu/ops/fused_ce.py:252",
    "fused_linear_xent_bwd": "neurst_tpu/ops/fused_ce.py:299",
    "fused_softmax_xent_fwd": "neurst_tpu/ops/fused_ce.py:59",
    "fused_softmax_xent_bwd": "neurst_tpu/ops/fused_ce.py:105",
    "fused_dropout": "neurst_tpu/ops/fused_dropout.py:67",
    "fused_ffn_fwd": "neurst_tpu/ops/fused_ffn.py:121",
    "fused_ffn_bwd": "neurst_tpu/ops/fused_ffn.py:149"}


# kernels no path of either package runs: the JAX package calls
# fused_softmax_xent only from its tests (its criterion's logits path is
# plain jnp, its train step takes the projection-fused rows 4-5), so the
# port does not wire it into a path either; their launches stay 0
OFF_PATH = {"fused_softmax_xent_fwd", "fused_softmax_xent_bwd"}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    device_phase()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_phase()
    fwd_rows = flash_fwd_kernel_phase(args.seed)
    bwd_rows = flash_bwd_kernel_phase(args.seed)
    flash_drop_rows = flash_dropout_kernel_phase(args.seed)
    xent_rows = xent_kernel_phase(args.seed)
    softmax_rows = softmax_xent_kernel_phase(args.seed)
    dropout_rows = dropout_kernel_phase(args.seed)
    ffn_rows = ffn_kernel_phase(args.seed)
    model, inputs, decode_counts = slice_phase(args.seed)
    encoder_cross_check_phase(model, inputs)
    del model
    reference_check_phase(args.seed)
    predict_counts = predict_phase(args.seed)
    by_path = {"train": train_phase(args.seed),
               "train_dropout": train_phase(args.seed, dropout=True),
               "train_base": nmt_train_phase(args.seed, bf16_params=False),
               "train_base_bf16": nmt_train_phase(args.seed,
                                                  bf16_params=True),
               "decode": decode_counts, "predict": predict_counts}
    for nmt in (False, True):
        train_reference_check_phase(args.seed, nmt=nmt)
        train_reference_check_phase(args.seed, dropout=True, nmt=nmt)
    main_bf16 = ("main", "bfloat16")
    rows = {  # name -> (main row, {label: row of another case})
        "flash_attention_fwd": (fwd_rows[main_bf16], {
            "with_dropout": flash_drop_rows[("fwd",) + main_bf16]}),
        "flash_attention_dq": (bwd_rows[("dq",) + main_bf16], {
            "with_dropout": flash_drop_rows[("dq",) + main_bf16]}),
        "flash_attention_dkv": (bwd_rows[("dkv",) + main_bf16], {
            "with_dropout": flash_drop_rows[("dkv",) + main_bf16]}),
        "fused_softmax_xent_fwd": (softmax_rows[("fwd",) + main_bf16], {}),
        "fused_softmax_xent_bwd": (softmax_rows[("bwd",) + main_bf16], {}),
        "fused_dropout": (dropout_rows[main_bf16], {})}
    for kernel in ("fwd", "bwd"):
        rows[f"fused_linear_xent_{kernel}"] = (
            xent_rows[(kernel,) + main_bf16],
            {"nmt_train": xent_rows[(kernel, "nmt_train", "bfloat16")]})
        rows[f"fused_ffn_{kernel}"] = (
            ffn_rows[(kernel, "main", DROPOUT_RATE, "bfloat16")],
            {"nmt_train": ffn_rows[(kernel, "d512", DROPOUT_RATE,
                                    "bfloat16")]})
    summary = []
    for name, (row, extra) in rows.items():
        counts = {path: c[name] for path, c in by_path.items() if name in c}
        if name not in OFF_PATH and not any(counts.values()):
            raise AssertionError(f"{name} never ran on the main paths")
        summary.append(_summary_row(name, row, sum(counts.values()), counts,
                                    extra))
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
