"""Dumps the transcripts and translations of an audio corpus or of record
files, one line an example (the port's copy of
``neurst_tpu/cli/extract_audio_transcripts.py``).

Usage:
    python -m neurst_tpu_torch.cli.extract_audio_transcripts \
        --dataset MuSTC --extraction train --input_tarball X.tar.gz \
        --output_transcript_file train.en.txt \
        --output_translation_file train.de.txt

``--transcript_file`` / ``--translation_file`` are accepted too.  Host
only: no device is touched.
"""

import logging
import sys

import neurst_tpu_torch  # noqa: F401
from neurst_tpu_torch.cli.run_exp import parse_and_merge
from neurst_tpu_torch.data.datasets.dataset import build_dataset
from neurst_tpu_torch.utils.flags_core import get_argv_dict


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    argv = argv if argv is not None else sys.argv[1:]
    argv_dict, _ = get_argv_dict(argv)
    args = parse_and_merge(argv)
    dataset = build_dataset(args)
    # --output_*_file and --*_file: both spellings work
    transcript_file = (argv_dict.get("transcript_file")
                       or argv_dict.get("output_transcript_file"))
    translation_file = (argv_dict.get("translation_file")
                        or argv_dict.get("output_translation_file"))
    ft = open(transcript_file, "w", encoding="utf-8") \
        if transcript_file else None
    fl = open(translation_file, "w", encoding="utf-8") \
        if translation_file else None
    n = 0
    for ex in dataset.build_iterator()():
        if ft is not None and "transcript" in ex:
            t = ex["transcript"]
            ft.write((t if isinstance(t, str) else " ".join(map(str, t)))
                     + "\n")
        if fl is not None and "translation" in ex:
            t = ex["translation"]
            fl.write((t if isinstance(t, str) else " ".join(map(str, t)))
                     + "\n")
        n += 1
    logging.info("Extracted %d examples", n)
    for f in (ft, fl):
        if f:
            f.close()


if __name__ == "__main__":
    main()
