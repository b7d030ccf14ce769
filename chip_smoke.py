#!/usr/bin/env python3
"""Drives the PyTorch port's serving path on one NVIDIA GPU and holds
every kernel on that path against its plain PyTorch version.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line (any failure raises and the script
exits non-zero):

1. device   -- requires CUDA; the card's name and power limit.
2. build    -- compiles every kernel from ``neurst_tpu_torch/csrc``.
3. kernel   -- each kernel against its plain version on the card, at the
               main path's shape and at a ragged causal shape, in f32 and
               bf16; times of the kernel, the plain version, one PyTorch
               library call of the same function, and the card's bound;
               a head dim the kernel is not built for is refused.
4. slice    -- ``speech_transformer_s`` (encoder flash attention on,
               bf16, vocab 8192) with seeded random weights in the JAX
               package's flat layout, loaded through ``param_bridge``,
               answers 3 requests of 16 x 1024 frames with beam-4 decode
               (max 64 steps); the launch counts of the run.
5. encoder cross-check -- the same weights and batch with flash off.
6. reference check -- the same weights in float32, a small request, on
               the card and on the CPU (plain versions): encoder outputs,
               hypotheses and scores agree.
Then the kernel summary line, and last the device line.

The script imports nothing of JAX and nothing of ``neurst_tpu``.
"""

import argparse
import json
import math
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

SLICE = dict(model="speech_transformer_s", batch=16, frames=1024,
             feature_dim=80, vocab=8192, beam=4, max_decode=64,
             requests=3, min_src=600)


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


def time_ms(fn, iters=30, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(q, lengths, causal):
    """Least time for one flash forward on these inputs: q read and o
    and lse written over all rows, k and v read over the keys some query
    may attend (the first ``length`` of each row), lengths read once,
    over the memory rate; the products over the valid (query, key) pairs
    over the dtype's peak rate."""
    b, t, n, h = q.shape
    elem = q.element_size()
    keys = pairs = 0
    for length in lengths.tolist():
        length = max(0, min(int(length), t))
        keys += length
        if causal:
            pairs += sum(min(r + 1, length) for r in range(t))
        else:
            pairs += t * length
    nbytes = ((2 * b * t + 2 * keys) * n * h * elem + b * n * t * 4
              + b * 4)
    flops = 4.0 * h * n * pairs
    dtype = str(q.dtype).replace("torch.", "")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(seed):
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
    cases = [("main", t_main, main_lengths, False),
             ("ragged_causal", 200, list(rng.randint(0, 201, size=4)), True)]
    results = {}
    for case, t, lengths, causal in cases:
        for dtype in (torch.float32, torch.bfloat16):
            bb = len(lengths)
            # the main path hands the kernel strided slices of the fused
            # qkv projection
            qkv = torch.from_numpy(rng.randn(bb, t, 3, n, h).astype(
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

    def kernel(name, shape, fan_in):
        flat[name] = (rng.randn(*shape) / math.sqrt(fan_in)).astype(
            np.float32)

    def vec(name, size, mean=0.0, std=0.02):
        flat[name] = (mean + std * rng.randn(size)).astype(np.float32)

    def norm(prefix, size):
        vec(f"{prefix}/scale", size, 1.0, 0.1)
        vec(f"{prefix}/bias", size, 0.0, 0.1)

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
    flat["target_symbol_modality/weights"] = (
        rng.randn(vocab, d) / math.sqrt(d)).astype(np.float32)
    vec("target_symbol_modality/bias", vocab)
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
    counts = launch_counts()
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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    device_phase()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_phase()
    kernel_rows = kernel_phase(args.seed)
    model, inputs, counts = slice_phase(args.seed)
    encoder_cross_check_phase(model, inputs)
    del model
    reference_check_phase(args.seed)
    main_row = kernel_rows[("main", "bfloat16")]
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "neurst_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "neurst_tpu/ops/flash_attention.py:96",
        "launches": counts["flash_attention_fwd"],
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
