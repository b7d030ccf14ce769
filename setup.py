"""Setup for neurst_tpu (parity: /root/reference/setup.py console script)."""

from setuptools import find_packages, setup

setup(
    name="neurst-tpu",
    version="0.1.0",
    description=("TPU-native (JAX/XLA/Pallas) toolkit for speech "
                 "translation, ASR and NMT"),
    packages=find_packages(include=["neurst_tpu", "neurst_tpu.*",
                                    "neurst_tpu_torch", "neurst_tpu_torch.*"]),
    # the PyTorch/CUDA port builds its kernels from these sources and the
    # headers they include (philox.cuh), and its host crc32c from csrc/*.cpp
    package_data={"neurst_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                       "csrc/*.cpp"]},
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "numpy", "pyyaml",
    ],
    extras_require={
        "text": ["sacremoses", "jieba", "sacrebleu"],
    },
    entry_points={
        "console_scripts": [
            "neurst-tpu-run = neurst_tpu.cli.run_exp:cli_main",
            "neurst-tpu-torch-run = neurst_tpu_torch.cli.run_exp:cli_main",
            "neurst-tpu-torch-avg-checkpoint = "
            "neurst_tpu_torch.cli.avg_checkpoint:main",
        ],
    },
)
