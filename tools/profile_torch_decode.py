#!/usr/bin/env python3
"""Where one decode request of the PyTorch port spends its time, on one
NVIDIA GPU.

    python3 tools/profile_torch_decode.py [--seed N] [--requests N]

Builds the slice that ``chip_smoke.py`` drives (speech_transformer_s,
encoder flash attention, bf16, seeded weights, 16 x 1024 frames, beam 4,
64 steps), runs a warm-up request, then profiles the encode
(``prepare_generation``) and the step loop (``sequence_beam_search``)
separately with ``torch.profiler``.  For each part it prints one JSON
line: wall time (host clock, synchronised), device kernel time (the sum
of the CUDA kernels' durations), the device's busy share, the number of
kernels launched and the ten kernels with the most device time.  The
last line names the card and its power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _profile(fn, top=10, own=()):
    """(fn's result, {wall_ms, device_kernel_ms, device_busy_share,
    kernels, top_kernels_ms}); with ``own`` (kernel-name substrings) also
    the device ms of the kernels whose names hold each."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    by_name = defaultdict(float)
    count = 0
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            by_name[event.name] += event.time_range.elapsed_us() / 1e3
            count += 1
    device_ms = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    row = {"wall_ms": wall_ms, "device_kernel_ms": device_ms,
           "device_busy_share": device_ms / wall_ms if wall_ms else 0,
           "kernels": count,
           "top_kernels_ms": {k[:80]: v for k, v in ranked}}
    if own:
        row["own_kernels_ms"] = {o: sum(v for k, v in by_name.items()
                                        if o in k) for o in own}
    return out, row


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--requests", type=int, default=2)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_decode: needs an NVIDIA GPU")
    import chip_smoke
    from neurst_tpu_torch.layers.search.beam_search import \
        sequence_beam_search

    model, search, request = chip_smoke.build_slice(args.seed)
    s = chip_smoke.SLICE
    search(request())
    for i in range(args.requests):
        inputs = request()
        with torch.inference_mode():
            (s2l, init), encode = _profile(
                lambda: model.prepare_generation(inputs, s["max_decode"]))
            _, loop = _profile(lambda: sequence_beam_search(
                s2l, init, beam_size=s["beam"],
                maximum_decode_length=s["max_decode"],
                extra_decode_length=s["max_decode"],
                minimum_decode_length=s["max_decode"] - 1))
        for part, row in (("encode", encode), ("step_loop", loop)):
            print(json.dumps(dict(request=i, part=part, **row)), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"device": smi}))


if __name__ == "__main__":
    sys.exit(main())
