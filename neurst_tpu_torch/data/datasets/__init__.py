from neurst_tpu_torch.data.datasets.dataset import (Dataset,  # noqa: F401
                                                    RecordDataset,
                                                    TextGenDataset,
                                                    build_dataset,
                                                    register_dataset)
from neurst_tpu_torch.data.datasets import audio  # noqa: F401
