"""Scores a hypothesis file against one or more reference files (the
port's copy of ``neurst_tpu/cli/text_metric.py``; host-only).

Usage:
    python -m neurst_tpu_torch.cli.text_metric --metric bleu \\
        --hypo_file hyp.txt --ref_file ref.txt [ref2.txt ...]
"""

import argparse

import neurst_tpu_torch  # noqa: F401 - fills the registries
from neurst_tpu_torch.metrics.metric import build_metric


def main(argv=None):
    p = argparse.ArgumentParser(description="Score hypotheses vs refs.")
    p.add_argument("--metric", default="bleu",
                   help="bleu/sacre_bleu/wer/compound_split_bleu/...")
    p.add_argument("--language", default="en")
    p.add_argument("--hypo_file", required=True)
    p.add_argument("--ref_file", required=True, nargs="+")
    args = p.parse_args(argv)

    with open(args.hypo_file, encoding="utf-8") as f:
        hyps = [line.strip() for line in f]
    refs_streams = []
    for rf in args.ref_file:
        with open(rf, encoding="utf-8") as f:
            refs_streams.append([line.strip() for line in f])
    if len(refs_streams) == 1:
        refs = refs_streams[0]
    else:
        refs = [list(rs) for rs in zip(*refs_streams)]
    metric = build_metric({"metric.class": args.metric,
                           "metric.params": {"language": args.language}})
    print(metric(hyps, refs))


if __name__ == "__main__":
    main()
