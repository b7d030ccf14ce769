"""Host-side data helpers (the port's copy of
``neurst_tpu/data/dataset_utils.py``): geometric length buckets and their
src/trg association, token-budget bucketed TRAIN batches of a bounded set
of shapes, fixed-size inference batches whose sequence dims are padded to
a multiple, the last batch filled up to the batch size with rows that
``sample_mask`` marks 0; a streaming reservoir shuffle; and a prefetching
thread between the reader and the consumer.

One difference from the JAX package: a field of float arrays (audio
features) keeps float32 in its batch.  The JAX batcher builds every field
as int32 and so truncates features to integers
(``neurst_tpu/data/dataset_utils.py:312-317``).
"""

import logging
import math
import queue
import random
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["round_up", "adjust_batch_size", "pad_to", "batch_fixed_size",
           "shuffle_iterator", "prefetch_iterator",
           "create_batch_bucket_boundaries", "associated_bucket_boundaries",
           "clean_by_length", "batch_by_tokens_bucketed"]

_MIN_BUCKET_BOUNDARY = 8
_BUCKET_BOUNDARY_SCALE = 1.1


def round_up(x: int, multiple: int) -> int:
    return ((int(x) + multiple - 1) // multiple) * multiple


def create_batch_bucket_boundaries(
        max_length: int, min_boundary: int = _MIN_BUCKET_BOUNDARY,
        boundary_scale: float = _BUCKET_BOUNDARY_SCALE,
        length_multiple: int = 8) -> List[int]:
    """Geometric boundaries from ``min_boundary`` (x ``boundary_scale``
    each) up to ``max_length``, which the last covers; each rounded up to
    ``length_multiple``, duplicates dropped."""
    raw = []
    x = min_boundary
    while x < max_length:
        raw.append(x)
        x = max(x + 1, int(x * boundary_scale))
    raw.append(max(max_length, min_boundary))
    out = []
    for b in raw:
        b = round_up(b, length_multiple)
        if not out or b > out[-1]:
            out.append(b)
    return out


def associated_bucket_boundaries(a: List[int], b: List[int]
                                 ) -> Tuple[List[int], List[int]]:
    """Resamples two boundary lists to the shorter one's length, position
    by position, so one bucket index names a (src, trg) pair."""
    la, lb = len(a), len(b)
    if la == lb:
        return a, b
    step_a, step_b = (la / lb, 1.0) if la > lb else (1.0, lb / la)
    out_a, out_b = [], []
    for i in range(1, min(la, lb) + 1):
        out_a.append(a[int(math.ceil(i * step_a)) - 1])
        out_b.append(b[int(math.ceil(i * step_b)) - 1])
    return out_a, out_b


def clean_by_length(example: dict,
                    max_lens: Dict[str, Optional[int]]) -> Optional[dict]:
    """None when a listed field of ``example`` exceeds its max length."""
    for key, max_len in max_lens.items():
        if max_len and key in example and len(example[key]) > max_len:
            return None
    return example


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


def batch_by_tokens_bucketed(
        iterator: Iterator[dict],
        batch_size_in_tokens: int,
        bucket_boundaries: Dict[str, List[int]],
        padding_values: Dict[str, int],
        length_fn: Callable[[dict], Dict[str, int]],
        batch_size_multiple: int = 8,
        extra_fields: Sequence[str] = (),
        drop_oversized: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Token-budget bucketed batches of a bounded set of shapes.

    An example goes to the first bucket whose boundary holds every field
    (``bucket_boundaries``: {field: associated boundary list}); examples
    no bucket holds are dropped (or raise without ``drop_oversized``).
    Bucket i's batch size is the budget over its largest boundary,
    rounded down to ``batch_size_multiple`` and at least that; a full
    bucket is emitted as [batch size, boundary] int32 arrays per field,
    with ``<field>_length`` and ``sample_mask``, and every non-empty
    bucket is emitted, filled up with masked rows, at the end."""
    fields = list(bucket_boundaries)
    num_buckets = len(bucket_boundaries[fields[0]])
    for f in fields:
        if len(bucket_boundaries[f]) != num_buckets:
            raise ValueError("bucket boundary lists must be associated "
                             "(equal length)")
    sizes = []
    for i in range(num_buckets):
        max_len = max(bucket_boundaries[f][i] for f in fields)
        bs = max(batch_size_in_tokens // max_len, 1)
        sizes.append(max(bs // batch_size_multiple * batch_size_multiple,
                         batch_size_multiple))
    shapes = sorted({(sizes[i],) + tuple(bucket_boundaries[f][i]
                                         for f in fields)
                     for i in range(num_buckets)})
    logging.info("bucketed batching: %d buckets, %d distinct shapes: %s",
                 num_buckets, len(shapes), shapes)
    buckets: List[List[dict]] = [[] for _ in range(num_buckets)]

    def emit(i: int) -> Dict[str, np.ndarray]:
        examples, buckets[i] = buckets[i], []
        bs = sizes[i]
        batch: Dict[str, np.ndarray] = {}
        for f in fields:
            arr = np.full([bs, bucket_boundaries[f][i]],
                          padding_values.get(f, 0), dtype=np.int32)
            for j, ex in enumerate(examples):
                arr[j, :len(ex[f])] = np.asarray(ex[f], dtype=np.int32)
            batch[f] = arr
        for f in fields:
            lens = np.zeros([bs], dtype=np.int32)
            lens[:len(examples)] = [len(ex[f]) for ex in examples]
            batch[f + "_length"] = lens
        mask = np.zeros([bs], dtype=np.float32)
        mask[:len(examples)] = 1.0
        batch["sample_mask"] = mask
        for f in extra_fields:
            batch[f] = np.asarray([ex.get(f) for ex in examples]
                                  + [None] * (bs - len(examples)),
                                  dtype=object)
        return batch

    for example in iterator:
        lengths = length_fn(example)
        i = next((i for i in range(num_buckets)
                  if all(lengths[f] <= bucket_boundaries[f][i]
                         for f in fields)), None)
        if i is None:
            if drop_oversized:
                continue
            raise ValueError(f"Example exceeds largest bucket: {lengths}")
        buckets[i].append(example)
        if len(buckets[i]) >= sizes[i]:
            yield emit(i)
    for i in range(num_buckets):
        if buckets[i]:
            yield emit(i)
