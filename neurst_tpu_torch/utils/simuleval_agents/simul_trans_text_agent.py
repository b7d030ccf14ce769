"""The wait-k simultaneous text translation agent (counterpart of
``neurst_tpu/utils/simuleval_agents/simul_trans_text_agent.py``).

The policy READs while ``len(read) - len(written) < k`` and source
remains, else WRITEs one greedy decode step.  On each READ the
(monotonic) encoder re-encodes the source prefix, padded to a multiple
of ``pad_multiple`` so the encoder sees few shapes; the decoding cache is
rebuilt for the new prefix (each layer's cross-attention keys and values)
while each layer's self-attention keys and values, the unchanged target
prefix, carry over.  The agent reads with its own ``k``; the decoder
masks with the model's lagging (its smallest configured k), as in the
JAX agent.

``neurst_tpu_torch/cli/simuleval_cli.py`` drives it offline or against a
SimulEval server.
"""

from typing import List, Optional

import numpy as np
import torch

__all__ = ["SimulTransTextAgent", "average_lagging", "READ", "WRITE"]

READ = "READ"
WRITE = "WRITE"


def average_lagging(delays: List[int], src_len: int, trg_len: int) -> float:
    """AL (Ma et al., 2019): the mean over the first tau outputs of
    d_t - (t - 1) * src_len / trg_len, tau the first t with
    d_t = |src|."""
    if not delays:
        return 0.0
    gamma = trg_len / max(src_len, 1)
    tau = len(delays)
    for t, d in enumerate(delays, start=1):
        if d >= src_len:
            tau = t
            break
    vals = [delays[t - 1] - (t - 1) / gamma for t in range(1, tau + 1)]
    return float(np.mean(vals))


class SimulTransTextAgent(object):
    """Streams one sentence at a time through a wait-k model (a
    ``WaitkTransformer`` on its device)."""

    def __init__(self, model, k: Optional[int] = None,
                 max_decode_len: int = 200, pad_multiple: int = 8):
        self._model = model
        self._k = k if k is not None else model.wait_k
        self._max_decode_len = max_decode_len
        self._pad_multiple = pad_multiple

    def policy(self, n_read: int, n_written: int, src_exhausted: bool,
               finished: bool) -> str:
        if finished:
            return WRITE
        if not src_exhausted and n_read - n_written < self._k:
            return READ
        return WRITE

    def translate(self, src_ids: List[int], eos_id: int,
                  bos_id: Optional[int] = None):
        """(output ids, delays): delays[i] = source tokens read before
        output i was written."""
        it = iter(src_ids)

        def read_fn():
            try:
                return [next(it)]
            except StopIteration:
                return None

        return self.translate_stream(read_fn, eos_id, bos_id=bos_id)

    def _encode_prefix(self, src_ids, eos_id, cache):
        """The decoding cache of the padded prefix, carrying ``cache``'s
        self-attention state over."""
        n_read = len(src_ids)
        pad_len = -(-n_read // self._pad_multiple) * self._pad_multiple
        src = np.full([1, pad_len], eos_id, np.int32)
        src[0, :n_read] = src_ids
        padding = np.zeros([1, pad_len], np.float32)
        padding[0, n_read:] = 1.0
        enc, pad = self._model.incremental_encode(src, padding)
        new_cache = self._model.init_cache(enc, pad, self._max_decode_len)
        if cache is not None:
            for name, layer in new_cache["layers"].items():
                layer["self"] = cache["layers"][name]["self"]
        return new_cache

    def translate_stream(self, read_fn, eos_id: int,
                         bos_id: Optional[int] = None, on_write=None):
        """The streaming form: ``read_fn()`` gives the next source
        segment (a list of ids), or None once the source is exhausted;
        ``on_write(token_id)`` is called for every written unit.  Stops
        at EOS or after ``max_decode_len`` outputs.  Returns (output ids,
        delays)."""
        last_id = bos_id if bos_id is not None else eos_id
        device = self._model.device
        cache = None
        src_ids: List[int] = []
        out_ids: List[int] = []
        delays: List[int] = []
        exhausted = False
        with torch.inference_mode():
            while len(out_ids) < self._max_decode_len:
                action = self.policy(len(src_ids), len(out_ids), exhausted,
                                     False)
                if cache is None:
                    action = READ  # something must be encoded first
                if action == READ and not exhausted:
                    segment = read_fn()
                    if segment is None:
                        exhausted = True
                        if cache is None:
                            break  # an empty source
                        continue
                    src_ids.extend(segment)
                    cache = self._encode_prefix(src_ids, eos_id, cache)
                    continue
                logits, cache = self._model.incremental_decode(
                    torch.tensor([last_id], device=device), cache,
                    len(out_ids))
                next_id = int(logits.argmax(dim=-1)[0])
                if next_id == eos_id:
                    break
                out_ids.append(next_id)
                delays.append(len(src_ids))
                last_id = next_id
                if on_write is not None:
                    on_write(next_id)
        return out_ids, delays
