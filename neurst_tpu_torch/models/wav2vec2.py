"""The wav2vec 2.0 trunk (counterpart of ``neurst_tpu/models/wav2vec2.py``).

A 1-D convolutional feature encoder over the raw waveform (seven
512-channel convolutions, kernels 10/3/3/3/3/2/2, strides 5/2/2/2/2/2/2,
no bias, a per-channel group norm after the first, the exact gelu after
each), ``feature_proj_ln`` and ``feature_proj`` to the model width, the
grouped positional convolution ``pos_conv`` (kernel 128, 16 groups,
padded k // 2 on both sides, the trailing output dropped for an even
kernel) added through a gelu, ``post_extract_ln``, and a post-norm
``TransformerEncoder`` with the exact gelu.  Convolution kernels are
torch's ``[out, in / groups, k]``; ``utils/param_bridge`` maps the JAX
``[k, in / groups, out]`` kernels onto them.
"""

import torch
from torch import nn
from torch.nn import functional as F

from neurst_tpu_torch.layers.common_layers import LayerNorm, linear
from neurst_tpu_torch.layers.encoders.transformer_encoder import \
    TransformerEncoder
from neurst_tpu_torch.models.model import (BaseModel, dtype_by_name,
                                           register_model)
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["Wav2Vec2", "wav2vec2_output_length"]

_CONV_SPEC = ((512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
              (512, 3, 2), (512, 2, 2), (512, 2, 2))


def wav2vec2_output_length(n_samples):
    """Frames of the feature encoder for ``n_samples`` (an int or an
    integer tensor)."""
    length = n_samples
    for _, k, s in _CONV_SPEC:
        length = (length - k) // s + 1
    return length


class GroupNorm(nn.Module):
    """flax's ``GroupNorm`` (parameters ``scale`` and ``bias``) in
    float32 over [B, T, C]: statistics over T and the group's channels,
    the variance as E[x^2] - E[x]^2 floored at 0, as flax computes it."""

    def __init__(self, num_groups: int, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def init_own_params(self, generator):
        self.scale.fill_(1.0)

    def forward(self, x):
        b, t, c = x.shape
        g = x.float().reshape(b, t, self.num_groups, c // self.num_groups)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = ((g * g).mean(dim=(1, 3), keepdim=True)
               - mean.abs() ** 2).clamp_min(0.0)
        y = ((g - mean) * torch.rsqrt(var + self.epsilon)).reshape(b, t, c)
        return y * self.scale.float() + self.bias.float()


@register_model("wav2vec2")
class Wav2Vec2(BaseModel):

    def __init__(self, args, src_meta=None, trg_meta=None):
        super().__init__(args)
        a = self.args
        self.dtype = dtype_by_name(a.get("dtype"))
        hidden = a.get("hidden_size") or 768
        self.conv_pos_kernel = 128
        self.dropout_rate = a.get("dropout_rate") or 0.0
        in_ch = 1
        for i, (ch, k, s) in enumerate(_CONV_SPEC):
            self.add_module(f"feature_conv_{i}", nn.Conv1d(
                in_ch, ch, k, stride=s, bias=False))
            in_ch = ch
        self.feature_gn = GroupNorm(512, 512, 1e-5)
        self.feature_proj_ln = LayerNorm(512, 1e-5, self.dtype)
        self.feature_proj = nn.Linear(512, hidden)
        self.pos_conv = nn.Conv1d(hidden, hidden, self.conv_pos_kernel,
                                  groups=16)
        self.post_extract_ln = LayerNorm(hidden, 1e-5, self.dtype)
        self.encoder = TransformerEncoder(
            a.get("num_layers") or 12, hidden,
            a.get("num_attention_heads") or 12,
            a.get("filter_size") or 3072, ffn_activation="gelu",
            post_normalize=True, layer_postprocess_epsilon=1e-5,
            attention_dropout_rate=self.dropout_rate,
            ffn_dropout_rate=self.dropout_rate,
            layer_postprocess_dropout_rate=self.dropout_rate,
            dtype=self.dtype)

    @staticmethod
    def class_or_method_args():
        return [
            Flag("num_layers", dtype=Flag.TYPE.INTEGER, default=12,
                 help="The number of transformer layers."),
            Flag("hidden_size", dtype=Flag.TYPE.INTEGER, default=768,
                 help="The model dimension."),
            Flag("num_attention_heads", dtype=Flag.TYPE.INTEGER, default=12,
                 help="The number of attention heads."),
            Flag("filter_size", dtype=Flag.TYPE.INTEGER, default=3072,
                 help="The ffn filter size."),
            Flag("dropout_rate", dtype=Flag.TYPE.FLOAT, default=0.,
                 help="The dropout rate."),
            Flag("dtype", dtype=Flag.TYPE.STRING, default="bfloat16",
                 help="The computation dtype."),
        ]

    def _conv(self, conv: nn.Conv1d, x):
        """[B, T, C] -> [B, T', C'] in the compute dtype."""
        bias = None if conv.bias is None else conv.bias.to(self.dtype)
        y = F.conv1d(x.transpose(1, 2).to(self.dtype),
                     conv.weight.to(self.dtype), bias, stride=conv.stride,
                     groups=conv.groups)
        return y.transpose(1, 2)

    def extract_features(self, waveform):
        """waveform [B, n_samples] -> conv features [B, T', 512]."""
        x = waveform[:, :, None].to(self.dtype)
        for i in range(len(_CONV_SPEC)):
            x = self._conv(getattr(self, f"feature_conv_{i}"), x)
            if i == 0:
                x = self.feature_gn(x).to(self.dtype)
            x = F.gelu(x, approximate="none")
        return x

    def forward(self, inputs, is_training=False, dropout_key=None):
        """inputs: src [B, n_samples] raw waveform (+ src_length [B]).
        Returns {"encoder_outputs", "features", "padding"}."""
        if is_training and self.dropout_rate and dropout_key is None:
            raise ValueError(
                "training with dropout > 0 needs a dropout key "
                "(utils.rng.DropoutKey)")
        waveform = torch.as_tensor(inputs["src"], device=self.device)
        feats = self.extract_features(waveform)
        x = linear(self.feature_proj, self.feature_proj_ln(feats),
                   self.dtype)
        pad = self.conv_pos_kernel // 2
        pos = self._conv(self.pos_conv, F.pad(x, (0, 0, pad, pad)))
        if self.conv_pos_kernel % 2 == 0:
            pos = pos[:, :-1]
        x = x + F.gelu(pos, approximate="none")
        x = self.post_extract_ln(x)
        t = x.shape[1]
        if inputs.get("src_length") is not None:
            out_len = wav2vec2_output_length(torch.as_tensor(
                inputs["src_length"], device=self.device).long())
            padding = (torch.arange(t, device=self.device)[None, :]
                       >= out_len[:, None]).float()
        else:
            padding = torch.zeros((x.shape[0], t), device=self.device)
        enc = self.encoder(x, padding, is_training, dropout_key)
        return {"encoder_outputs": enc, "features": feats,
                "padding": padding}
