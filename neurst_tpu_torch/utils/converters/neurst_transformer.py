"""The original NeurST's TensorFlow Transformer checkpoints -> the JAX
package's flat names (the port's copy of
``neurst_tpu/utils/converters/neurst_transformer.py``).

The original NeurST's checkpoints are its native format; this converter
lets its published and trained models decode here.  Its variable layout:
``MultiHeadDenseLayer``'s fused qkv kernel [d, 3d] splits q|k|v and is
reshaped head-major.

Accepted ``from_path``:
  * a ``.npz`` of {tf_variable_name: array}, or
  * a TF checkpoint prefix or directory, read by the port's own
    tensor-bundle reader (``utils/converters/tf_bundle.py``) where the
    JAX package imports TensorFlow: the port never imports TensorFlow,
    and the converted arrays are the JAX converter's, array for array.
"""

import re
from typing import Dict

import numpy as np

from neurst_tpu_torch.utils.converters.converter import (Converter,
                                                         register_converter)
from neurst_tpu_torch.utils.converters.tf_bundle import BundleReader
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["NeurstTransformer", "map_reference_variables"]

# (regex on the reference name WITHOUT the model-scope prefix) -> target
_LN_MAP = {
    "self_attention_prepost_wrapper/ln": "self_attention_ln",
    "encdec_attention_prepost_wrapper/ln": "cross_attention_ln",
    "ffn_prepost_wrapper/ln": "ffn_ln",
}


def _strip(name: str) -> str:
    name = name.split(":")[0]
    # drop the outermost model scope (SequenceToSequence/, Transformer/ ...)
    parts = name.split("/")
    if parts and parts[0] in ("SequenceToSequence", "Transformer",
                              "SpeechTransformer", "WaitkTransformer"):
        parts = parts[1:]
    return "/".join(parts)


def map_reference_variables(ref: Dict[str, np.ndarray],
                            num_heads: int) -> Dict[str, np.ndarray]:
    """Maps {reference tf name: array} -> our flat {path: array}."""
    out: Dict[str, np.ndarray] = {}
    n = num_heads
    for raw_name, value in ref.items():
        name = _strip(raw_name)
        v = np.asarray(value).astype(np.float32)

        # ---------- embeddings / softmax ----------
        m = re.match(
            r"(input|target)_symbol_modality(?:_posenc_wrapper)?/"
            r"(?:input|target)_symbol_modality/(?:emb|shared)/(weights|bias)",
            name)
        if m:
            side = ("input_symbol_modality" if m.group(1) == "input"
                    else "target_symbol_modality")
            out[f"{side}/{m.group(2)}"] = v
            continue

        # ---------- audio conv subsampling front-end ----------
        # (SpeechTransformer; conv kernels are HWIO in both TF and
        # flax, so values pass through; TF LayerNorm gamma/beta ->
        # flax scale/bias)
        m = re.match(
            r"input_audio_modality(?:_posenc_wrapper)?/"
            r"input_audio_modality/"
            r"(conv1|conv2|ln1|ln2|output_dense)/"
            r"(kernel|bias|gamma|beta)", name)
        if m:
            part, kind = m.group(1), m.group(2)
            kind = {"gamma": "scale", "beta": "bias"}.get(kind, kind)
            out[f"input_audio_modality/{part}/{kind}"] = v
            continue

        # ---------- encoder / decoder stacks ----------
        m = re.match(r"Transformer(Encoder|Decoder)/(.*)", name)
        if not m:
            continue  # optimizer slots etc.
        stack = "encoder" if m.group(1) == "Encoder" else "decoder"
        rest = m.group(2)

        if rest.startswith("output_ln/"):
            kind = rest.rsplit("/", 1)[1]
            out[f"{stack}/output_ln/" + ("scale" if kind == "gamma"
                                         else "bias")] = v
            continue

        lm = re.match(r"layer_(\d+)/(.*)", rest)
        if not lm:
            continue
        layer, sub = f"layer_{lm.group(1)}", lm.group(2)

        # layer norms
        for ref_ln, our_ln in _LN_MAP.items():
            if sub.startswith(ref_ln + "/"):
                kind = sub.rsplit("/", 1)[1]
                out[f"{stack}/{layer}/{our_ln}/"
                    + ("scale" if kind == "gamma" else "bias")] = v
                break
        else:
            am = re.match(
                r"(self_attention|encdec_attention)_prepost_wrapper/"
                r"(self_attention|encdec_attention)/"
                r"(qkv_transform|q_transform|kv_transform|output_transform)/"
                r"(kernel|bias)", sub)
            if am:
                att = ("self_attention" if am.group(1) == "self_attention"
                       else "cross_attention")
                proj, kind = am.group(3), am.group(4)
                base = f"{stack}/{layer}/{att}/{proj}/{kind}"
                if proj == "output_transform":
                    if kind == "kernel":  # [n*h, d] -> [n, h, d]
                        d_out = v.shape[-1]
                        out[base] = v.reshape(n, -1, d_out)
                    else:
                        out[base] = v
                else:
                    splits = {"qkv_transform": 3, "q_transform": 1,
                              "kv_transform": 2}[proj]
                    if kind == "kernel":  # [d, s*d'] -> [d, s, n, h]
                        d_in = v.shape[0]
                        out[base] = v.reshape(d_in, splits, n, -1)
                    else:                 # [s*d'] -> [s, n, h]
                        out[base] = v.reshape(splits, n, -1)
                continue
            fm = re.match(r"ffn_prepost_wrapper/ffn/"
                          r"(dense1|dense2)/(kernel|bias)", sub)
            if fm:
                out[f"{stack}/{layer}/ffn/{fm.group(1)}/{fm.group(2)}"] = v
    return out


@register_converter("neurst_transformer", "NeurstTransformer")
class NeurstTransformer(Converter):
    """Converts an original-NeurST TF Transformer checkpoint."""

    def __init__(self, args=None):
        super().__init__(args)
        self._num_heads = int(self._args.get("num_heads") or 8)

    @staticmethod
    def class_or_method_args():
        return [Flag("num_heads", dtype=Flag.TYPE.INTEGER, default=8,
                     help="The number of attention heads of the "
                          "source checkpoint's model.")]

    def convert_to_flat(self, from_path: str) -> Dict[str, np.ndarray]:
        if from_path.endswith(".npz"):
            with np.load(from_path) as data:
                ref = {k: data[k] for k in data.files}
        else:
            reader = BundleReader(from_path)
            ref = {}
            for key, dtype in reader.dtypes().items():
                if key.startswith("_") or dtype not in (
                        "float32", "float16", "bfloat16", "float64"):
                    continue  # object graph / save counters etc.
                # name-based checkpoint keys: the variable name with
                # "/" escaped as ".S", suffixed /.ATTRIBUTES/...
                name = key
                if "/.ATTRIBUTES/" in name:
                    name = name.split("/.ATTRIBUTES/")[0]
                name = name.replace(".S", "/")
                ref[name] = reader.get_tensor(key)
        flat = map_reference_variables(ref, self._num_heads)
        if not flat:
            raise ValueError(
                f"No reference transformer variables recognized in "
                f"{from_path}")
        return flat
