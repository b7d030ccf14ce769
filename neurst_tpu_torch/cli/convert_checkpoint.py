"""Checkpoint conversion CLI (the port's copy of
``neurst_tpu/cli/convert_checkpoint.py``):

    python -m neurst_tpu_torch.cli.convert_checkpoint \\
        --converter google_bert --from_path bert.bin --to_path bert_ckpt \\
        [--num_heads 12]

writes ``<to_path>/ckpt-0.npz`` and ``checkpoint.json`` in the JAX
package's flat names, the files the JAX CLI writes.  The converters are
``fairseq_transformer`` / ``fairseq_transformer2``, ``google_bert``,
``openai_gpt2``, ``fairseq_wav2vec2`` (torch ``.pt`` / ``.bin`` state
dicts) and ``neurst_transformer`` (the original NeurST's TensorFlow
checkpoints, read without TensorFlow).  Host-only: no device is used.
"""

import argparse
import logging

from neurst_tpu_torch.utils.converters import build_converter


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="Convert a public checkpoint.")
    p.add_argument("--converter", required=True,
                   help="fairseq_transformer / openai_gpt2 / google_bert ...")
    p.add_argument("--from_path", required=True,
                   help="The foreign checkpoint path (.pt/.bin).")
    p.add_argument("--to_path", required=True,
                   help="Output directory for the converted checkpoint.")
    p.add_argument("--num_heads", type=int, default=None,
                   help="Attention head count for fused-projection "
                        "reshapes.")
    args = p.parse_args(argv)
    params = {}
    if args.num_heads:
        params["num_heads"] = args.num_heads
    converter = build_converter({"converter.class": args.converter,
                                 "converter.params": params})
    path = converter.convert(args.from_path, args.to_path)
    logging.info("Converted checkpoint written to %s", path)
    return path


if __name__ == "__main__":
    main()
