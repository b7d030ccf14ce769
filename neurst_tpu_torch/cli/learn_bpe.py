"""Learns (joint) BPE codes and per-file vocabularies (the port's copy of
``neurst_tpu/cli/learn_bpe.py``).  Codes are written in subword-nmt v0.2
format, loadable by ``--subtokenizer bpe --subtokenizer_codes``.

Usage:
    python -m neurst_tpu_torch.cli.learn_bpe \
        --input train.en.tok.txt train.de.tok.txt \
        --symbols 8000 \
        --output codes.bpe \
        --write_vocabulary vocab.en vocab.de

Learning stops early where no pair reaches ``--min_frequency``; the log
says how many merges were written.
"""

import argparse
import logging
import sys


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(
        description="Learn (joint) BPE codes and vocabularies.")
    p.add_argument("--input", nargs="+", required=True,
                   help="Tokenized input file(s); codes are learned "
                        "jointly over all of them.")
    p.add_argument("--symbols", type=int, default=10000,
                   help="Number of merge operations to learn.")
    p.add_argument("--output", required=True, help="Output codes file.")
    p.add_argument("--write_vocabulary", nargs="*", default=None,
                   help="Optional per-input-file vocabulary outputs "
                        "(same order/arity as --input).")
    p.add_argument("--min_frequency", type=int, default=2,
                   help="Stop when the best pair is rarer than this.")
    args = p.parse_args(argv)

    if args.write_vocabulary and \
            len(args.write_vocabulary) != len(args.input):
        p.error("--write_vocabulary needs one path per --input file")

    from neurst_tpu_torch.data.text.bpe_learner import (
        apply_and_count, count_words, learn_bpe, write_codes,
        write_vocabulary)

    per_file_counts = []
    for path in args.input:
        with open(path, encoding="utf-8") as f:
            per_file_counts.append(count_words(f))
        logging.info("Counted %d distinct tokens in %s",
                     len(per_file_counts[-1]), path)

    joint = {}
    for counts in per_file_counts:
        for tok, freq in counts.items():
            joint[tok] = joint.get(tok, 0) + freq
    merges = learn_bpe(joint, args.symbols,
                       min_frequency=args.min_frequency)
    write_codes(args.output, merges)
    logging.info("Wrote %d merges to %s", len(merges), args.output)

    if args.write_vocabulary:
        for path, counts in zip(args.write_vocabulary, per_file_counts):
            units = apply_and_count(counts, merges)
            write_vocabulary(path, units)
            logging.info("Wrote %d subword types to %s", len(units), path)


if __name__ == "__main__":
    sys.exit(main())
