from neurst_tpu_torch.data.datasets.dataset import (Dataset,  # noqa: F401
                                                    RecordDataset,
                                                    TextGenDataset,
                                                    build_dataset,
                                                    register_dataset)
from neurst_tpu_torch.data.datasets import parallel_text_dataset  # noqa: F401
from neurst_tpu_torch.data.datasets import mono_text_dataset  # noqa: F401
from neurst_tpu_torch.data.datasets import record_text_dataset  # noqa: F401
from neurst_tpu_torch.data.datasets import mixed_train_dataset  # noqa: F401
from neurst_tpu_torch.data.datasets import data_sampler  # noqa: F401
from neurst_tpu_torch.data.datasets import audio  # noqa: F401
from neurst_tpu_torch.data.datasets import \
    mixed_speech_text_dataset  # noqa: F401
