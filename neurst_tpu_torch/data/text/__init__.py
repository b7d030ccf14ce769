from neurst_tpu_torch.data.text.tokenizer import (Tokenizer,  # noqa: F401
                                                  build_tokenizer,
                                                  register_tokenizer)
from neurst_tpu_torch.data.text.vocab import PaddingMode, Vocab  # noqa: F401
from neurst_tpu_torch.data.text import bpe  # noqa: F401
from neurst_tpu_torch.data.text import character  # noqa: F401
from neurst_tpu_torch.data.text import moses  # noqa: F401
from neurst_tpu_torch.data.text import spm  # noqa: F401
from neurst_tpu_torch.data.text import jieba_tokenizer  # noqa: F401
from neurst_tpu_torch.data.text import huggingface_tokenizer  # noqa: F401
from neurst_tpu_torch.data.text import thai  # noqa: F401
from neurst_tpu_torch.data.text import subtokenizer  # noqa: F401
