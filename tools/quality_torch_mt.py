#!/usr/bin/env python3
"""The PyTorch port's quality run of ``examples/quality/mt_synth_base.yml``
on one NVIDIA GPU.

    python3 tools/quality_torch_mt.py [--steps N] [--device D]
        [--output PATH] [--model_dir DIR]

Trains the recipe as it stands (``transformer_base``, bf16 with bf16
stored params and an f32 master, update_cycle 2, noam warmup 800, 1200
steps, on the committed synthetic-reversal corpus
``examples/quality/{train,dev}.{src,trg}``) through ``run_exp --entry
train``, with its inline ``seq_generation_validator`` every 200 steps on
all 500 dev lines (beam 4, BLEU), and a log every 50 steps.  ``--steps``
cuts the run (the validator still runs every 200 steps).  It prints one
JSON object, which ``--output`` also receives where it is given: the
loss trajectory and its quarter means (the trajectory passes, as
QUALITY_r05.json's ``loss_monotone_by_quarter`` asks, when they fall
strictly), the validation BLEU trajectory, the wall seconds, and the
card's name and power limit.  The model dir
(``build/quality_torch_mt`` by default) is removed at the end.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--output", default=None)
    parser.add_argument("--model_dir", default=os.path.join(
        REPO, "build", "quality_torch_mt"))
    args = parser.parse_args(argv)

    import yaml

    import chip_smoke
    from neurst_tpu_torch.tasks.translation import Translation

    recipe = os.path.join(REPO, "examples", "quality", "mt_synth_base.yml")
    with open(recipe) as f:
        cfg = json.loads(json.dumps(yaml.safe_load(f)).replace(
            '"examples/quality/', f'"{REPO}/examples/quality/'))
    cfg["entry.class"] = "trainer"
    cfg["entry.params"]["enable_tensorboard"] = False
    if args.steps:
        cfg["entry.params"]["train_steps"] = args.steps
    shutil.rmtree(args.model_dir, ignore_errors=True)
    os.makedirs(args.model_dir)
    path = os.path.join(args.model_dir, "recipe.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    card = None
    if args.device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    start = time.perf_counter()
    try:
        _, seen = chip_smoke.run_trainer(
            ["--config_paths", path, "--model_dir", args.model_dir,
             "--device", args.device], Translation)
    finally:
        shutil.rmtree(args.model_dir, ignore_errors=True)
    wall_s = time.perf_counter() - start
    losses = [w["loss"] for w in seen["windows"]]
    q = max(1, len(losses) // 4)
    quarters = [float(np.mean(losses[i * q:(i + 1) * q])) for i in range(4)]
    result = {
        "recipe": "examples/quality/mt_synth_base.yml",
        "steps": cfg["entry.params"]["train_steps"], "device": args.device,
        "card": card,
        "loss_trajectory": [[w["step"], w["loss"]] for w in seen["windows"]],
        "loss_quarters": quarters,
        "loss_monotone_by_quarter": all(
            a > b for a, b in zip(quarters, quarters[1:])),
        "valid_bleu_trajectory": [[v["step"], v["value"]]
                                  for v in seen["validations"]],
        "validate_s": seen["validate_s"],
        "step_s_median": float(np.median(
            [w["secs_per_step"] for w in seen["windows"][1:]])),
        "wall_s": wall_s}
    if args.output:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)),
                    exist_ok=True)
        with open(args.output, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
