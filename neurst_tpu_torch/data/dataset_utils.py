"""Host-side data helpers (the part of ``neurst_tpu/data/dataset_utils.py``
the predict and train paths use): fixed-size inference batches whose
sequence dims are padded to a multiple, the last batch filled up to the
batch size with rows that ``sample_mask`` marks 0; a streaming reservoir
shuffle; and a prefetching thread between the reader and the consumer.

One difference from the JAX package: a field of float arrays (audio
features) keeps float32 in its batch.  The JAX batcher builds every field
as int32 and so truncates features to integers
(``neurst_tpu/data/dataset_utils.py:312-317``).
"""

import logging
import queue
import random
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

__all__ = ["round_up", "adjust_batch_size", "pad_to", "batch_fixed_size",
           "shuffle_iterator", "prefetch_iterator"]


def round_up(x: int, multiple: int) -> int:
    return ((int(x) + multiple - 1) // multiple) * multiple


def adjust_batch_size(batch_size: Optional[int] = None,
                      batch_size_per_replica: Optional[int] = None,
                      num_replicas: int = 1,
                      verbose: bool = True) -> int:
    """The global batch size from a global or a per-replica value."""
    if batch_size_per_replica:
        global_bs = batch_size_per_replica * max(num_replicas, 1)
        if verbose:
            logging.info("Global batch size = %d (%d per replica x %d "
                         "replicas)", global_bs, batch_size_per_replica,
                         num_replicas)
        return global_bs
    if not batch_size:
        raise ValueError("Either batch_size or batch_size_per_replica "
                         "must be provided.")
    if verbose:
        logging.info("Global batch size = %d", batch_size)
    return batch_size


def pad_to(ids: Sequence[int], length: int, pad_value) -> np.ndarray:
    arr = np.full([length], pad_value, dtype=np.int32)
    n = min(len(ids), length)
    arr[:n] = np.asarray(ids[:n], dtype=np.int32)
    return arr


def batch_fixed_size(iterator: Iterator[dict],
                     batch_size: int,
                     padding_values: Dict[str, int],
                     fields: Sequence[str],
                     pad_length_multiple: int = 8,
                     fixed_lengths: Optional[Dict[str, int]] = None,
                     extra_fields: Sequence[str] = ()
                     ) -> Iterator[Dict[str, np.ndarray]]:
    """Fixed-batch-size padded batching (inference/eval).

    Sequence dims are padded to ``fixed_lengths`` when given, else to the
    batch's longest rounded up to ``pad_length_multiple``.  A short final
    batch is padded to the full batch size and flagged by
    ``sample_mask``.  Fields of float arrays batch as float32, the others
    as int32.
    """
    buf = []

    def emit() -> Dict[str, np.ndarray]:
        n = len(buf)
        batch: Dict[str, np.ndarray] = {}
        for f in fields:
            if fixed_lengths and fixed_lengths.get(f):
                length = fixed_lengths[f]
            else:
                length = round_up(max(len(ex[f]) for ex in buf),
                                  pad_length_multiple)
            dtype = np.float32 if any(
                isinstance(ex[f], np.ndarray) and ex[f].dtype.kind == "f"
                for ex in buf) else np.int32
            arr = np.full([batch_size, length], padding_values.get(f, 0),
                          dtype=dtype)
            lens = np.zeros([batch_size], dtype=np.int32)
            for j, ex in enumerate(buf):
                ids = ex[f][:length]
                arr[j, :len(ids)] = np.asarray(ids, dtype=dtype)
                lens[j] = len(ids)
            batch[f] = arr
            batch[f + "_length"] = lens
        mask = np.zeros([batch_size], dtype=np.float32)
        mask[:n] = 1.0
        batch["sample_mask"] = mask
        for f in extra_fields:
            batch[f] = np.asarray([ex.get(f) for ex in buf]
                                  + [None] * (batch_size - n), dtype=object)
        buf.clear()
        return batch

    for example in iterator:
        buf.append(example)
        if len(buf) >= batch_size:
            yield emit()
    if buf:
        yield emit()


def shuffle_iterator(it: Iterator, buffer_size: int,
                     seed: Optional[int] = None) -> Iterator:
    """A streaming shuffle through a reservoir of ``buffer_size`` items
    (``random.Random(seed)``; the JAX package's algorithm, so one seed
    gives both the same order)."""
    rng = random.Random(seed)
    buf = []
    for x in it:
        buf.append(x)
        if len(buf) >= buffer_size:
            idx = rng.randrange(len(buf))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf


def prefetch_iterator(it: Iterator, buffer_size: int = 64) -> Iterator:
    """Runs ``it`` in a daemon thread, ``buffer_size`` items ahead of the
    consumer.  An error upstream is raised in the consumer after the
    items before it; abandoning the generator (the trainer stopping at
    ``train_steps``) stops the thread instead of leaving it blocked on a
    full queue."""
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    end = object()
    err: List[BaseException] = []
    stop = threading.Event()

    def worker():
        try:
            for x in it:
                while not stop.is_set():
                    try:
                        q.put(x, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 - raised in the consumer
            err.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(end, timeout=0.5)
                    break
                except queue.Full:
                    continue

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            x = q.get()
            if x is end:
                if err:
                    raise err[0]
                return
            yield x
    finally:
        stop.set()
