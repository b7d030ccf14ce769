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
    # headers they include (philox.cuh), and its host libraries (crc32c,
    # the FLAC decoder, the zstd decoder of the orbax format) from
    # csrc/*.cpp
    # and its Moses tokenizer reads its data files (nonbreaking prefixes,
    # Perl Unicode Properties ranges), its jieba segmenter jieba's
    # dictionary and HMM tables
    package_data={"neurst_tpu_torch": [
        "csrc/*.cu", "csrc/*.cuh", "csrc/*.cpp",
        "data/text/moses_data/NOTICE", "data/text/moses_data/*.txt",
        "data/text/moses_data/nonbreaking_prefixes/*",
        "data/text/jieba_data/NOTICE", "data/text/jieba_data/*.gz"]},
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
            "neurst-tpu-torch-extract-audio-transcripts = "
            "neurst_tpu_torch.cli.extract_audio_transcripts:main",
            "neurst-tpu-torch-create-records = "
            "neurst_tpu_torch.cli.create_records:main",
            "neurst-tpu-torch-process-text = "
            "neurst_tpu_torch.cli.process_text:main",
            "neurst-tpu-torch-learn-bpe = "
            "neurst_tpu_torch.cli.learn_bpe:main",
            "neurst-tpu-torch-generate-vocab = "
            "neurst_tpu_torch.cli.generate_vocab:main",
            "neurst-tpu-torch-view-records = "
            "neurst_tpu_torch.cli.view_records:main",
            "neurst-tpu-torch-audio-analysis = "
            "neurst_tpu_torch.cli.audio_analysis:main",
            "neurst-tpu-torch-cascade-st = "
            "neurst_tpu_torch.cli.cascade_st:main",
            "neurst-tpu-torch-text-metric = "
            "neurst_tpu_torch.cli.text_metric:main",
            "neurst-tpu-torch-inspect-checkpoint = "
            "neurst_tpu_torch.cli.inspect_checkpoint:main",
            "neurst-tpu-torch-view-registry = "
            "neurst_tpu_torch.cli.view_registry:main",
            "neurst-tpu-torch-simuleval = "
            "neurst_tpu_torch.cli.simuleval_cli:main",
            "neurst-tpu-torch-convert-checkpoint = "
            "neurst_tpu_torch.cli.convert_checkpoint:main",
        ],
    },
)
