"""Quantization: QAT fake-quant layers and int8 serving (counterpart of
``neurst_tpu/layers/quantization/``)."""
