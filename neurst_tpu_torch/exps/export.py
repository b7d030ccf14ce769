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

``top_sampling`` exports the same encode program (the samples as
beams) and one ``sampling_step``, which takes the step's Exp(1) draws as
an input: the loader draws them from a ``torch.Generator`` seeded with
the search's ``seed``, as ``torch.multinomial`` draws them in the eager
search (``layers/search/sampling.exponential_draws``), so the loaded
search gives the eager ``top_sampling``'s tokens under that seed.
``speculative_decode`` (greedy verification: the layer decodes greedily
whatever its ``beam_size``, R14) exports an encode program (the target's
and a draft model's encoders and caches sized ``maximum_decode_length +
speculative_k``, or the n-gram draft's token buffer) and one
``speculative_greedy_step``: the k draft steps and the k-token target
pass that verifies them; its output is plain greedy decoding's.
Speculative sampling does not export (it raises), nor does any other
``search_method``.
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
from neurst_tpu_torch.layers.search.sampling import (TopSampling,
                                                     exponential_draws,
                                                     sampling_step)
from neurst_tpu_torch.layers.search.speculative import (
    SpeculativeDecode, _vocab_size, ngram_steps, speculative_greedy_step,
    speculative_result)
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


class _SampleStep(torch.nn.Module):
    """(fixed, carry, time [B * samples], draws [B * samples, V]) -> the
    next carry."""

    def __init__(self, model, search):
        super().__init__()
        self.model = model
        self.search = search

    def forward(self, fixed, carry, time, draws):
        state = dict(carry)
        state["cache"] = _join_cache(fixed, state.pop("self"))
        out = sampling_step(self.model.decode_steps, state, time, draws,
                            **self.search)
        _, out["self"] = _split_cache(out.pop("cache"))
        return {k: out[k] for k in carry}  # the carry's structure


class _SpecEncode(torch.nn.Module):
    """inputs -> {"fixed", "carry", "src_maxlen"} of the speculative
    search: the target's (and a draft model's) encoder and caches, or the
    n-gram draft's buffer (its lookup prefix the source ids, -1 at pads,
    with ``lookup_source``)."""

    def __init__(self, model, draft, length, buffer_len, lookup_source,
                 fbank=None):
        super().__init__()
        self.model = model
        self.draft = draft
        self.length = length
        self.buffer_len = buffer_len
        self.lookup_source = lookup_source
        self.fbank = fbank

    def forward(self, inputs):
        if self.fbank is not None:
            feats, frames = device_logfbank(
                inputs["audio"], inputs["audio_length"], **self.fbank)
            inputs = {"src": feats[..., None], "src_length": frames}
        enc, src_padding = self.model.encode(inputs)
        fixed, target_self = _split_cache(
            self.model.init_cache(enc, src_padding, self.length))
        batch, device = enc.shape[0], enc.device
        carry = {"last": torch.full((batch,), self.model.bos_id,
                                    dtype=torch.long, device=device),
                 "times": torch.zeros(batch, dtype=torch.long,
                                      device=device),
                 "log_probs": torch.zeros(batch, device=device),
                 "predicted": torch.zeros((batch, self.length),
                                          dtype=torch.long, device=device),
                 "self": target_self}
        fixed = {"target": fixed}
        if self.draft is not None:
            d_enc, d_padding = self.draft.encode(inputs)
            fixed["draft"], carry["draft_self"] = _split_cache(
                self.draft.init_cache(d_enc, d_padding, self.length))
        else:
            buf = torch.full((batch, self.buffer_len), -1, dtype=torch.long,
                             device=device)
            if self.lookup_source:
                src = torch.where(inputs["src_padding"] > 0, -1,
                                  inputs["src"].long())
                buf = torch.cat([src, buf], dim=1)
            carry["buffer"] = buf
        return {"fixed": fixed, "carry": carry,
                "src_maxlen": (1.0 - src_padding).sum(dim=1).max()}


class _SpecStep(torch.nn.Module):
    """(fixed, carry) -> the carry after one draft-and-verify pass."""

    def __init__(self, model, draft, search, ngram):
        super().__init__()
        self.model = model
        self.draft = draft
        self.search = search
        self.ngram = ngram

    def forward(self, fixed, carry):
        state = dict(carry)
        state["target_cache"] = _join_cache(fixed["target"],
                                            state.pop("self"))
        if self.draft is not None:
            state["draft_cache"] = _join_cache(fixed["draft"],
                                               state.pop("draft_self"))
            draft_fn = self.draft.decode_steps
        else:
            buf = state.pop("buffer")
            state["draft_cache"] = {"buffer": buf}
            draft_fn = ngram_steps(buf.shape[0], buf.shape[1],
                                   buf.shape[1] - self.ngram["length"],
                                   self.ngram["vocab_size"],
                                   self.ngram["n"], buf.device)
        out = speculative_greedy_step(self.model.decode_steps, draft_fn,
                                      state, **self.search)
        _, out["self"] = _split_cache(out.pop("target_cache"))
        draft_cache = out.pop("draft_cache")
        if self.draft is not None:
            _, out["draft_self"] = _split_cache(draft_cache)
        else:
            out["buffer"] = draft_cache["buffer"]
        return {k: out[k] for k in carry}  # the carry's structure


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
        cls = get_registered_class(name, "search_method")
        if cls not in (BeamSearch, TopSampling, SpeculativeDecode):
            raise ValueError(
                f"export supports search_method beam_search (greedy search "
                f"is beam_size 1), top_sampling and speculative_decode, not "
                f"{name}")
        search = cls(args.get("search_method.params") or {})
        a = search.args
        if cls is SpeculativeDecode and a.get("sampling"):
            raise ValueError("speculative sampling does not export; export "
                             "greedy speculative_decode or top_sampling")
        max_len = int(a.get("maximum_decode_length") or 256)
        meta = self._model.generation_meta
        eos_id = int(meta["eos_id"])
        unk_id = None if a.get("enable_unk") else meta.get("unk_id")
        min_len = int(a.get("minimum_decode_length") or 0)
        config = {"search": {BeamSearch: "beam_search",
                             TopSampling: "top_sampling",
                             SpeculativeDecode: "speculative_decode"}[cls],
                  "eos_id": eos_id, "minimum_decode_length": min_len,
                  "maximum_decode_length": max_len,
                  "extra_decode_length": int(
                      a.get("extra_decode_length") or 50)}
        export_path = args.get("export_path") or os.path.join(
            self._model_dir or ".", "export")
        os.makedirs(export_path, exist_ok=True)

        model = self.restore_params()
        batch = int(args.get("export_batch_size") or 8)
        src_len = int(args.get("export_src_length") or 128)
        example, fbank = _example_inputs(self._task, args, batch, src_len,
                                         model.device)
        config["inputs"] = sorted(example)
        if cls is BeamSearch:
            beam = int(a.get("beam_size") or 4)
            lp = a.get("length_penalty")
            step_args = {"beam_size": beam, "eos_id": eos_id,
                         "unk_id": unk_id,
                         "length_penalty": -1.0 if lp is None else float(lp),
                         "minimum_decode_length": min_len}
            config.update(step_args, top_k=int(a.get("top_k") or 1))
            encode = _EncodeProgram(model, beam, max_len, fbank)
            step = _StepProgram(model, step_args)
        elif cls is TopSampling:
            samples = int(a.get("num_samples") or 1)
            step_args = {"eos_id": eos_id, "unk_id": unk_id,
                         "top_k": int(a.get("top_k") or 0),
                         "top_p": float(a.get("top_p") or 1.0),
                         "temperature": float(a.get("temperature") or 1.0),
                         "minimum_decode_length": min_len}
            config.update(step_args, num_samples=samples,
                          seed=int(a.get("seed") or 0),
                          vocab_size=_vocab_size(model))
            encode = _EncodeProgram(model, samples, max_len, fbank)
            step = _SampleStep(model, step_args)
        else:
            k = int(a.get("speculative_k") or 4)
            draft = None
            if a.get("draft_method") != "ngram":
                search.set_model(model)
                search.prepare()
                draft = search.draft_model
                if _vocab_size(draft) != _vocab_size(model):
                    raise ValueError("draft/target vocabulary sizes differ")
            ngram = {"length": max_len + k, "vocab_size": _vocab_size(model),
                     "n": int(a.get("draft_ngram") or 3)}
            step_args = {"k": k, "eos_id": eos_id, "unk_id": unk_id,
                         "minimum_decode_length": min_len}
            config.update(speculative_k=k)
            encode = _SpecEncode(model, draft, max_len + k, max_len + k,
                                 bool(a.get("draft_lookup_source")), fbank)
            step = _SpecStep(model, draft, step_args, ngram)
        with torch.no_grad():
            encode_ep = torch.export.export(encode, (example,))
            first = encode_ep.module()(example)
            step_inputs = _step_inputs(config, first, model.device)
            step_ep = torch.export.export(step, step_inputs)
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
        logging.info("Exported the %s programs to %s", config["search"],
                     export_path)
        return export_path


def _max_steps(config, src_maxlen) -> int:
    """The searches' step limit (``layer_utils.max_decode_steps``)."""
    return max(min(int(src_maxlen) + config["extra_decode_length"],
                   config["maximum_decode_length"]),
               config["minimum_decode_length"])


def _step_inputs(config, encoded, device, generator=None, time=None):
    """The step program's inputs after the encode program's output: the
    carry (with the speculative limit and flags), and the beam and
    sampling steps' times (zero, or ``time``) and the sampling step's
    draws (from ``generator``, ones without one: the argmax ignores
    them)."""
    fixed, carry = encoded["fixed"], dict(encoded["carry"])
    if config["search"] == "speculative_decode":
        limit = torch.full_like(carry["times"],
                                _max_steps(config, encoded["src_maxlen"]))
        carry.update(limit=limit, finished=limit <= 0)
        return fixed, carry
    if time is None:
        time = torch.zeros_like(carry["ids"])
    if config["search"] == "beam_search":
        return fixed, carry, time
    shape = (carry["ids"].shape[0], config["vocab_size"])
    draws = torch.ones(shape, device=device) if generator is None \
        else exponential_draws(shape, generator, device)
    return fixed, carry, time, draws


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
        search = c.get("search", "beam_search")
        with torch.no_grad():
            out = self._encode({k: torch.as_tensor(v, device=self.device)
                                for k, v in inputs.items()})
            if search == "speculative_decode":
                fixed, carry = _step_inputs(c, out, self.device)
                while not bool(carry["finished"].all()):
                    carry = self._step(fixed, carry)
                return speculative_result(carry, c["eos_id"],
                                          c["maximum_decode_length"])
            max_steps = _max_steps(c, out["src_maxlen"])
            generator = None
            greedy = c.get("top_k") == 1 and c.get("top_p", 1.0) >= 1.0
            if search == "top_sampling" and not greedy:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(c["seed"])
            carry = out["carry"]
            time = torch.zeros_like(carry["ids"])
            step = 0
            while step < max_steps and not bool(carry["finished"].all()):
                inputs = _step_inputs(c, dict(out, carry=carry),
                                      self.device, generator, time)
                carry = self._step(*inputs)
                time = time + 1
                step += 1
            if search == "top_sampling":
                return carry["predicted"], carry["scores"]
            return beam_search_result(carry, c["beam_size"], c["top_k"],
                                      c["length_penalty"])


def load_exported(path: str, device=None) -> ExportedGeneration:
    """The export in ``path`` as a callable search, on ``device`` (where
    it was exported by default)."""
    return ExportedGeneration(path, device)
