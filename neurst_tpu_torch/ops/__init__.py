"""Hand-written Hopper kernels, each beside its plain PyTorch version.

``KERNELS`` lists every kernel wrapper; each carries ``kernel_name``
and ``launches``, the count of its kernel launches."""

from neurst_tpu_torch.ops.flash_attention import flash_attention_fwd

KERNELS = (flash_attention_fwd,)


def reset_launch_counts():
    for wrapper in KERNELS:
        wrapper.launches = 0


def launch_counts():
    return {wrapper.kernel_name: wrapper.launches for wrapper in KERNELS}
