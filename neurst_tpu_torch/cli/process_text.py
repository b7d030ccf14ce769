"""Text (de)tokenization CLI (the port's copy of
``neurst_tpu/cli/process_text.py``): ``--tokenizer`` moses / bpe /
character / jieba / ..., line by line from ``--input`` (else stdin) to
``--output`` (else stdout).  Moses and ``--normalize_punctuation`` need
``sacremoses``."""

import argparse
import sys

import neurst_tpu_torch  # noqa: F401
from neurst_tpu_torch.data.text.tokenizer import build_tokenizer_by_name


def main(argv=None):
    p = argparse.ArgumentParser(description="Tokenize/detokenize text.")
    p.add_argument("--tokenizer", required=True,
                   help="moses/bpe/character/jieba/spm/...")
    p.add_argument("--language", default="en")
    p.add_argument("--subtokenizer_codes", default=None,
                   help="BPE codes / spm model path.")
    p.add_argument("--detokenize", action="store_true")
    p.add_argument("--normalize_punctuation", action="store_true",
                   help="Normalize punctuation before tokenizing "
                        "(replaces the moses normalize-punctuation + "
                        "remove-non-printing-char perl stages of the "
                        "upstream NeurST recipes).")
    p.add_argument("--input", default=None, help="Input file (else stdin).")
    p.add_argument("--output", default=None,
                   help="Output file (else stdout).")
    args = p.parse_args(argv)

    normalize = None
    if args.normalize_punctuation:
        import re

        import sacremoses
        norm = sacremoses.MosesPunctNormalizer(lang=args.language)
        nonprint = re.compile(r"[\x00-\x08\x0b-\x1f\x7f-\x9f]")

        def normalize(s):
            return nonprint.sub("", norm.normalize(s))

    tok = build_tokenizer_by_name(args.tokenizer, language=args.language)
    if args.subtokenizer_codes:
        tok.init_subtokenizer(args.subtokenizer_codes)
    fin = open(args.input, encoding="utf-8") if args.input else sys.stdin
    fout = open(args.output, "w", encoding="utf-8") if args.output \
        else sys.stdout
    for line in fin:
        line = line.rstrip("\n")
        if normalize is not None:
            line = normalize(line)
        if args.detokenize:
            fout.write(tok.detokenize(line, return_str=True) + "\n")
        else:
            fout.write(tok.tokenize(line, return_str=True) + "\n")


if __name__ == "__main__":
    main()
