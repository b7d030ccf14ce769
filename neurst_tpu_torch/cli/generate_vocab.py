"""Vocabulary generation CLI (the port's copy of
``neurst_tpu/cli/generate_vocab.py``): counts whitespace tokens of
(tokenized) text and writes ``token<tab>frequency`` lines, most frequent
first; ``--wordpiece`` builds a wordpiece subtoken vocabulary instead.
"""

import argparse
import sys
from collections import Counter


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate a vocabulary file.")
    p.add_argument("--input", required=True, nargs="+",
                   help="Tokenized text file(s).")
    p.add_argument("--output", required=True, help="Output vocab file.")
    p.add_argument("--min_frequency", type=int, default=0,
                   help="Drop tokens rarer than this.")
    p.add_argument("--max_vocab_size", type=int, default=None,
                   help="Keep at most this many tokens.")
    p.add_argument("--lowercase", action="store_true",
                   help="Lowercase tokens before counting.")
    p.add_argument("--extra_slots", type=int, default=0,
                   help="Append this many unused slot tokens.")
    p.add_argument("--wordpiece", action="store_true",
                   help="Build a T2T wordpiece subtoken vocabulary "
                        "instead of a word vocabulary.")
    p.add_argument("--wordpiece_target_size", type=int, default=32768,
                   help="Target subtoken vocabulary size.")
    args = p.parse_args(argv)

    if args.wordpiece:
        from neurst_tpu_torch.data.text.subtokenizer import Subtokenizer

        def corpus():
            for path in args.input:
                with open(path, "r", encoding="utf-8") as f:
                    yield from f
        st = Subtokenizer.build_from_corpus(
            corpus(), target_vocab_size=args.wordpiece_target_size)
        st.save_vocab(args.output)
        print(f"Wrote {len(st.vocab_list)} subtokens to {args.output}",
              file=sys.stderr)
        return

    counter: Counter = Counter()
    for path in args.input:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                tokens = line.strip().split()
                if args.lowercase:
                    tokens = [t.lower() for t in tokens]
                counter.update(tokens)
    items = [(t, c) for t, c in counter.most_common()
             if c >= args.min_frequency]
    if args.max_vocab_size:
        items = items[:args.max_vocab_size]
    with open(args.output, "w", encoding="utf-8") as f:
        for t, c in items:
            f.write(f"{t}\t{c}\n")
        for i in range(args.extra_slots):
            f.write(f"<unused{i}>\t0\n")
    print(f"Wrote {len(items) + args.extra_slots} tokens to {args.output}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
