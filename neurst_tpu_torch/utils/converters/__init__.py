from neurst_tpu_torch.utils.converters.converter import (  # noqa: F401
    Converter, build_converter, register_converter)
from neurst_tpu_torch.utils.converters import fairseq_transformer  # noqa: F401
from neurst_tpu_torch.utils.converters import openai_gpt2  # noqa: F401
from neurst_tpu_torch.utils.converters import google_bert  # noqa: F401
from neurst_tpu_torch.utils.converters import fairseq_wav2vec2  # noqa: F401
from neurst_tpu_torch.utils.converters import neurst_transformer  # noqa: F401
