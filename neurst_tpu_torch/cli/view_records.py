"""Record-file inspection CLI (the port's copy of
``neurst_tpu/cli/view_records.py``): prints the first examples of
TFRecord-format files, or with ``--stats`` field length statistics."""

import argparse

import numpy as np

from neurst_tpu_torch.data.recordio import (glob_record_files,
                                            parse_example, record_iterator)


def main(argv=None):
    p = argparse.ArgumentParser(description="Peek into TFRecord files.")
    p.add_argument("path", help="Record file / dir / glob.")
    p.add_argument("--count", type=int, default=3,
                   help="How many examples to print.")
    p.add_argument("--stats", action="store_true",
                   help="Scan all records and print field statistics.")
    args = p.parse_args(argv)

    files = glob_record_files(args.path)
    if not files:
        raise FileNotFoundError(args.path)
    shown = 0
    totals = {}
    n = 0
    for fpath in files:
        for record in record_iterator(fpath):
            ex = parse_example(record)
            n += 1
            if shown < args.count:
                print(f"--- example {shown} ({fpath}) ---")
                for k, v in ex.items():
                    arr = np.asarray(v) if not isinstance(v, list) else v
                    if isinstance(arr, list):
                        print(f"  {k}: bytes x{len(arr)}: "
                              f"{[x[:40] for x in arr[:2]]}")
                    else:
                        print(f"  {k}: {arr.dtype}{list(arr.shape)} "
                              f"{arr.reshape(-1)[:8]}...")
                shown += 1
            if args.stats:
                for k, v in ex.items():
                    if not isinstance(v, list):
                        totals.setdefault(k, []).append(len(np.asarray(v)))
            elif shown >= args.count:
                break
        if not args.stats and shown >= args.count:
            break
    if args.stats:
        print(f"\ntotal examples: {n}")
        for k, lens in totals.items():
            print(f"  {k}: mean_len={np.mean(lens):.1f} "
                  f"max={np.max(lens)} min={np.min(lens)}")


if __name__ == "__main__":
    main()
