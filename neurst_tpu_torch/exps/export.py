"""The serving export entry (the port's counterpart of
``neurst_tpu/exps/export.py``; entries ``export``,
``generation_savedmodel`` and ``sequence_generator_savedmodel``).

The JAX package serializes one StableHLO module of its jitted search.
Here ``torch.export`` captures two programs at the fixed
``export_batch_size`` x ``export_src_length``, and ``load_exported``
runs the search loop over them in Python, without the model's code:

* ``generation.pt2``: the encoder and the decoder's initial state (the
  cross-attention keys and values, the zeroed self cache tiled to the
  beams, the ids, flags, scores, lengths and predicted ids of
  ``layers/search/beam_search.initial_beam_state``) and the longest
  source, from text ids (``src``, ``src_padding``), speech features
  (``src`` [B, T, dim, channels], ``src_length``) or, with
  ``--export_raw_audio``, waveforms (``audio``, ``audio_length``:
  ``ops/device_fbank.device_logfbank`` runs inside the program);
* ``generation_step.pt2``: one ``beam_step`` at per-row times.

The flash-attention and fused-FFN forwards are custom ops
(``neurst_tpu_torch::flash_attention_fwd``, ``::fused_ffn_fwd``), nodes
of the programs that launch the kernels on the card.  The directory also
holds ``generation.graph.txt`` (both programs' text, the counterpart of
``generation.stablehlo.mlir``), ``ckpt-0.npz`` (the served weights in
the JAX package's names: bf16 at rest widened exactly, int8 tables under
``--int8_serving``) and ``model_configs.yml``.  Programs are captured on
the model's device and a loaded program runs there (``load_exported``
moves it where asked).

Only ``beam_search`` exports (greedy search is beam 1); another
``search_method`` raises.
"""

import json
import logging
import os
import shutil

import torch
import yaml

from neurst_tpu_torch.exps.base_experiment import BaseExperiment, register_exp
from neurst_tpu_torch.layers.search.beam_search import (BeamSearch,
                                                        beam_search_result,
                                                        beam_step,
                                                        initial_beam_state)
# registers the custom ops that a loaded program calls
from neurst_tpu_torch.ops import flash_attention, fused_ffn  # noqa: F401
from neurst_tpu_torch.ops.device_fbank import device_logfbank
from neurst_tpu_torch.utils import checkpoints as ckpt_lib
from neurst_tpu_torch.utils.flags_core import Flag, ModuleFlag
from neurst_tpu_torch.utils.param_bridge import state_dict_to_flat
from neurst_tpu_torch.utils.registry import get_registered_class

__all__ = ["GenerationExporter", "ExportedGeneration", "load_exported",
           "ENCODE_FILE", "STEP_FILE"]

ENCODE_FILE = "generation.pt2"
STEP_FILE = "generation_step.pt2"
_CONFIG = "generation.json"


def _split_cache(cache):
    """(fixed, carry): the beam-shared subtrees (cross-attention keys and
    values, memory padding) and the per-beam self cache."""
    fixed = {"memory_padding": cache["memory_padding"], "layers": {}}
    carry = {}
    for name, layer in cache["layers"].items():
        fixed["layers"][name] = {k: v for k, v in layer.items()
                                 if k != "self"}
        carry[name] = layer["self"]
    return fixed, carry


def _join_cache(fixed, carry_self):
    return {"memory_padding": fixed["memory_padding"],
            "layers": {name: dict(layer, self=carry_self[name])
                       for name, layer in fixed["layers"].items()}}


class _EncodeProgram(torch.nn.Module):
    """inputs -> {"fixed", "carry", "src_maxlen"} of the search."""

    def __init__(self, model, beam_size, max_len, fbank=None):
        super().__init__()
        self.model = model
        self.beam_size = beam_size
        self.max_len = max_len
        self.fbank = fbank

    def forward(self, inputs):
        if self.fbank is not None:
            feats, frames = device_logfbank(
                inputs["audio"], inputs["audio_length"], **self.fbank)
            inputs = {"src": feats[..., None], "src_length": frames}
        enc, src_padding = self.model.encode(inputs)
        cache = self.model.init_cache(enc, src_padding, self.max_len)
        batch = enc.shape[0]
        state = initial_beam_state(
            {"decoder_input": torch.full((batch,), self.model.bos_id,
                                         dtype=torch.long,
                                         device=enc.device),
             "decoder_internal_cache": cache}, self.beam_size, self.max_len)
        fixed, carry_self = _split_cache(state.pop("cache"))
        state["self"] = carry_self
        return {"fixed": fixed, "carry": state,
                "src_maxlen": (1.0 - src_padding).sum(dim=1).max()}


class _StepProgram(torch.nn.Module):
    """(fixed, carry, time [B * beam]) -> the next carry."""

    def __init__(self, model, search):
        super().__init__()
        self.model = model
        self.search = search

    def forward(self, fixed, carry, time):
        state = dict(carry)
        state["cache"] = _join_cache(fixed, state.pop("self"))
        out = beam_step(self.model.decode_steps, state, time, **self.search)
        _, out["self"] = _split_cache(out.pop("cache"))
        return out


def _example_inputs(task, args, batch, src_len, device):
    """(example inputs, device_logfbank kwargs or None) of the input form:
    raw audio, speech features or text ids."""
    feat_dim = getattr(task, "_audio_feature_dim", None)
    if args.get("export_raw_audio"):
        if feat_dim is None:
            raise ValueError("--export_raw_audio requires a speech task "
                             "(audio_feature_dim).")
        channels = getattr(task, "_audio_feature_channels", 1)
        if channels != 1:
            raise ValueError(
                f"--export_raw_audio supports single-channel fbank "
                f"features only (task has audio_feature_channels="
                f"{channels}; delta channels are not computed on the "
                f"device): export on features instead.")
        fbank = {"samplerate": int(args.get("export_sample_rate") or 16000),
                 "nfilt": feat_dim}
        extra = args.get("export_fbank_params")
        if isinstance(extra, str):
            extra = yaml.safe_load(extra)
        fbank.update(extra or {})
        return {"audio": torch.zeros((batch, src_len), device=device),
                "audio_length": torch.full((batch,), src_len,
                                           dtype=torch.int32,
                                           device=device)}, fbank
    if feat_dim is not None:
        channels = getattr(task, "_audio_feature_channels", 1)
        return {"src": torch.zeros((batch, src_len, feat_dim, channels),
                                   device=device),
                "src_length": torch.full((batch,), src_len,
                                         dtype=torch.int32,
                                         device=device)}, None
    return {"src": torch.zeros((batch, src_len), dtype=torch.int32,
                               device=device),
            "src_padding": torch.zeros((batch, src_len), device=device)}, None


@register_exp("export", "generation_savedmodel",
              "sequence_generator_savedmodel")
class GenerationExporter(BaseExperiment):

    @staticmethod
    def class_or_method_args():
        return [
            ModuleFlag("search_method", "search_method",
                       default="beam_search",
                       help="The search layer (beam_search only)."),
            Flag("export_path", dtype=Flag.TYPE.STRING, default=None,
                 help="Output directory for the exported programs."),
            Flag("export_batch_size", dtype=Flag.TYPE.INTEGER, default=8,
                 help="The fixed serving batch size."),
            Flag("export_src_length", dtype=Flag.TYPE.INTEGER, default=128,
                 help="The fixed padded source length (tokens for text "
                      "models, fbank frames for speech models, raw "
                      "samples when --export_raw_audio)."),
            Flag("export_raw_audio", dtype=Flag.TYPE.BOOLEAN,
                 default=None,
                 help="Speech models: serve raw waveforms; log-mel fbank "
                      "and CMVN run on the device inside the program. "
                      "Single-channel fbank features only."),
            Flag("export_sample_rate", dtype=Flag.TYPE.INTEGER,
                 default=16000,
                 help="Serving sample rate for --export_raw_audio; must "
                      "match the rate the training features used."),
            Flag("export_fbank_params", dtype=Flag.TYPE.STRING,
                 default=None,
                 help="Overrides for the on-device extractor, e.g. "
                      "'{winlen: 0.025, winstep: 0.01, nfft: 512}'; must "
                      "mirror the data-prep feature_extractor config."),
        ]

    def run(self):
        args = self._args
        name = args.get("search_method.class") or "beam_search"
        if get_registered_class(name, "search_method") is not BeamSearch:
            raise ValueError(
                f"export supports search_method beam_search only (greedy "
                f"search is beam_size 1), not {name}")
        search = BeamSearch(args.get("search_method.params") or {}).args
        beam = int(search.get("beam_size") or 4)
        max_len = int(search.get("maximum_decode_length") or 256)
        lp = search.get("length_penalty")
        step_args = {
            "beam_size": beam, "eos_id": int(self._model.generation_meta[
                "eos_id"]),
            "unk_id": None if search.get("enable_unk")
            else self._model.generation_meta.get("unk_id"),
            "length_penalty": -1.0 if lp is None else float(lp),
            "minimum_decode_length": int(
                search.get("minimum_decode_length") or 0)}
        config = dict(step_args, top_k=int(search.get("top_k") or 1),
                      maximum_decode_length=max_len,
                      extra_decode_length=int(
                          search.get("extra_decode_length") or 50))
        export_path = args.get("export_path") or os.path.join(
            self._model_dir or ".", "export")
        os.makedirs(export_path, exist_ok=True)

        model = self.restore_params()
        batch = int(args.get("export_batch_size") or 8)
        src_len = int(args.get("export_src_length") or 128)
        example, fbank = _example_inputs(self._task, args, batch, src_len,
                                         model.device)
        config["inputs"] = sorted(example)
        encode = _EncodeProgram(model, beam, max_len, fbank)
        step = _StepProgram(model, step_args)
        with torch.no_grad():
            encode_ep = torch.export.export(encode, (example,))
            first = encode_ep.module()(example)
            time = torch.zeros_like(first["carry"]["ids"])
            step_ep = torch.export.export(
                step, (first["fixed"], first["carry"], time))
        torch.export.save(encode_ep, os.path.join(export_path, ENCODE_FILE),
                          extra_files={_CONFIG: json.dumps(config)})
        torch.export.save(step_ep, os.path.join(export_path, STEP_FILE))
        with open(os.path.join(export_path, "generation.graph.txt"),
                  "w") as f:
            f.write(f"# {ENCODE_FILE}\n{encode_ep}\n\n# {STEP_FILE}\n"
                    f"{step_ep}\n")
        ckpt_lib.save_checkpoint(export_path, 0, state_dict_to_flat(model),
                                 max_to_keep=None)
        cfg = os.path.join(self._model_dir or "", "model_configs.yml")
        if os.path.exists(cfg):
            shutil.copy(cfg, os.path.join(export_path, "model_configs.yml"))
        logging.info("Exported the generation programs to %s", export_path)
        return export_path


class ExportedGeneration(object):
    """The exported search, loaded: ``__call__(inputs)`` -> (hypotheses
    int64 [B * top_k, maximum_decode_length], scores float32 [B * top_k])
    as the beam search returns them.  ``inputs`` maps the export's input
    names (``config["inputs"]``) to tensors or arrays of its fixed
    shapes."""

    def __init__(self, path: str, device=None):
        extra = {_CONFIG: ""}
        encode = torch.export.load(os.path.join(path, ENCODE_FILE),
                                   extra_files=extra)
        step = torch.export.load(os.path.join(path, STEP_FILE))
        self.config = json.loads(extra[_CONFIG])
        if device is not None:
            from torch.export.passes import move_to_device_pass
            encode = move_to_device_pass(encode, device)
            step = move_to_device_pass(step, device)
        # inputs go where the programs' weights are
        self.device = next(iter(encode.state_dict.values())).device
        self._encode = encode.module()
        self._step = step.module()

    def __call__(self, inputs):
        c = self.config
        with torch.no_grad():
            out = self._encode({k: torch.as_tensor(v, device=self.device)
                                for k, v in inputs.items()})
            fixed, carry = out["fixed"], out["carry"]
            max_steps = max(min(int(out["src_maxlen"])
                                + c["extra_decode_length"],
                                c["maximum_decode_length"]),
                            c["minimum_decode_length"])
            time = torch.zeros_like(carry["ids"])
            step = 0
            while step < max_steps and not bool(carry["finished"].all()):
                carry = self._step(fixed, carry, time)
                time = time + 1
                step += 1
            return beam_search_result(carry, c["beam_size"], c["top_k"],
                                      c["length_penalty"])


def load_exported(path: str, device=None) -> ExportedGeneration:
    """The export in ``path`` as a callable search, on ``device`` (where
    it was exported by default)."""
    return ExportedGeneration(path, device)
