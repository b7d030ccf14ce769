"""Audio record statistics (the port's copy of
``neurst_tpu/cli/audio_analysis.py``): frame and transcript length
distributions of audio records and their ratio, the input for
``experimental_frame_transcript_ratio`` in 2-D bucketing."""

import argparse

import numpy as np

from neurst_tpu_torch.data.recordio import (glob_record_files,
                                            parse_example, record_iterator)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Analyze audio records (lengths + frame/transcript "
                    "ratio).")
    p.add_argument("data_path", help="Record file/dir/glob.")
    p.add_argument("--audio_feature_dim", type=int, default=80)
    p.add_argument("--audio_feature_channels", type=int, default=1)
    p.add_argument("--audio_key", default="audio")
    p.add_argument("--transcript_key", default="transcript")
    args = p.parse_args(argv)

    elems = args.audio_feature_dim * args.audio_feature_channels
    frames, trans_lens, ratios = [], [], []
    for f in glob_record_files(args.data_path):
        for record in record_iterator(f):
            ex = parse_example(record)
            if args.audio_key not in ex:
                continue
            n_frames = len(np.asarray(ex[args.audio_key])) // elems
            frames.append(n_frames)
            t = ex.get(args.transcript_key)
            if t is not None and len(t) > 0:
                trans_lens.append(len(t))
                ratios.append(n_frames / len(t))
    frames = np.asarray(frames)
    print(f"examples: {len(frames)}")
    print(f"frames:  mean={frames.mean():.1f} p50={np.percentile(frames,50):.0f} "
          f"p95={np.percentile(frames,95):.0f} max={frames.max()}")
    if trans_lens:
        tl = np.asarray(trans_lens)
        r = np.asarray(ratios)
        print(f"transcript: mean={tl.mean():.1f} "
              f"p95={np.percentile(tl,95):.0f} max={tl.max()}")
        print(f"frame/transcript ratio: mean={r.mean():.2f} "
              f"p50={np.percentile(r,50):.2f} "
              f"(use as --experimental_frame_transcript_ratio)")


if __name__ == "__main__":
    main()
