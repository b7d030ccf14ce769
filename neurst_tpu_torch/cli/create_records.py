"""Offline sharded preprocessing into TFRecord-format files (the port's
copy of ``neurst_tpu/cli/create_records.py``).

Builds the dataset and, where ``--task`` is given, runs the task's TRAIN
preprocess function over it (RAW -> PROJECTED once, offline); without a
task it stores what the dataset yields (e.g. fbank features and raw
transcripts from a raw-audio corpus).  Writes ``--output_template``
shards (``%5.5d-of-%5.5d`` style, else ``-NNNNN-of-NNNNN`` appended).
``--processor_id`` / ``--num_processors`` split the input round-robin
between processes; ``--num_output_shards`` is the global shard count,
of which this processor writes ``--output_range_begin`` ..
``--output_range_end`` (by default its equal share), examples going
round-robin over its shards.

Usage:
    python -m neurst_tpu_torch.cli.create_records \
        --dataset MuSTC --extraction train --input_tarball X.tar.gz \
        --feature_extractor.class fbank \
        --feature_extractor.params '{"nfilt": 80}' \
        --output_template train.tfrecords-%5.5d-of-%5.5d \
        --num_output_shards 8 [--processor_id 0 --num_processors 1]

Host only: no device is touched.
"""

import logging
import os
import sys

import numpy as np

from neurst_tpu_torch.cli.run_exp import parse_and_merge
from neurst_tpu_torch.data.datasets.dataset import build_dataset
from neurst_tpu_torch.data.recordio import RecordWriter, build_example
from neurst_tpu_torch.tasks.task import build_task
from neurst_tpu_torch.utils.compat import ModeKeys
from neurst_tpu_torch.utils.flags_core import get_argv_dict


def _to_feature_dict(example: dict) -> dict:
    out = {}
    for k, v in example.items():
        arr = np.asarray(v)
        if arr.dtype.kind == "f":
            out[k] = arr.astype(np.float32)
        elif arr.dtype.kind in ("i", "u"):
            out[k] = arr.astype(np.int64)
        elif arr.dtype.kind in ("U", "S", "O"):
            out[k] = [str(v).encode("utf-8")]
        else:
            raise ValueError(f"Unsupported field {k}: {arr.dtype}")
    return out


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    argv = argv if argv is not None else sys.argv[1:]
    argv_dict, _ = get_argv_dict(argv)
    args = parse_and_merge(argv)
    processor_id = int(argv_dict.get("processor_id", 0))
    num_processors = int(argv_dict.get("num_processors", 1))
    num_output_shards = int(argv_dict.get("num_output_shards", 1))
    template = argv_dict.get("output_template")
    if template is None:
        raise ValueError("--output_template is required "
                         "(e.g. train.tfrecords-%5.5d-of-%5.5d)")

    dataset = build_dataset(args)
    if args.get("task.class"):
        task = build_task(args)
        preprocess = task.get_data_preprocess_fn(ModeKeys.TRAIN,
                                                 dataset.status)
    else:
        # no task: store what the dataset yields (e.g. fbank features +
        # raw transcripts from a RawAudioDataset, as the recipes' stage
        # 02 runs it)
        preprocess = None

    # the shards this processor writes: the explicit range, else its
    # equal share by processor_id
    shards_per_proc = num_output_shards // num_processors
    begin = int(argv_dict.get("output_range_begin",
                              processor_id * shards_per_proc))
    end = int(argv_dict.get("output_range_end", begin + shards_per_proc))
    own = list(range(begin, end))
    writers = []
    for s in own:
        path = template % (s, num_output_shards) if "%" in template \
            else f"{template}-{s:05d}-of-{num_output_shards:05d}"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        writers.append(RecordWriter(path))

    n = 0
    it = dataset.build_iterator(map_func=preprocess,
                                shard_id=processor_id,
                                total_shards=num_processors)()
    for example in it:
        w = writers[n % len(writers)]
        w.write(build_example(_to_feature_dict(example)))
        n += 1
        if n % 1000 == 0:
            logging.info("Processed %d examples", n)
    for w in writers:
        w.close()
    logging.info("Done: %d examples into %d shards", n, len(writers))


if __name__ == "__main__":
    main()
