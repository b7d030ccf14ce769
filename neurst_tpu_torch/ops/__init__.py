"""Hand-written Hopper kernels, each beside its plain PyTorch version.

``KERNELS`` lists every kernel wrapper; each carries ``kernel_name``
and ``launches``, the count of its kernel launches."""

from neurst_tpu_torch.ops.flash_attention import (flash_attention_dkv,
                                                  flash_attention_dq,
                                                  flash_attention_fwd)
from neurst_tpu_torch.ops.fused_ce import (fused_linear_xent_bwd,
                                           fused_linear_xent_fwd,
                                           fused_softmax_xent_bwd,
                                           fused_softmax_xent_fwd)
from neurst_tpu_torch.ops.fused_dropout import fused_dropout_apply
from neurst_tpu_torch.ops.fused_ffn import fused_ffn_bwd, fused_ffn_fwd

KERNELS = (flash_attention_fwd, flash_attention_dq, flash_attention_dkv,
           fused_linear_xent_fwd, fused_linear_xent_bwd,
           fused_softmax_xent_fwd, fused_softmax_xent_bwd, fused_dropout_apply,
           fused_ffn_fwd, fused_ffn_bwd)


def reset_launch_counts():
    for wrapper in KERNELS:
        wrapper.launches = 0


def launch_counts():
    return {wrapper.kernel_name: wrapper.launches for wrapper in KERNELS}
