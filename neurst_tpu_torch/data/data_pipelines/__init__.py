from neurst_tpu_torch.data.data_pipelines.data_pipeline import (  # noqa: F401
    DataPipeline, build_data_pipeline, register_data_pipeline)
from neurst_tpu_torch.data.data_pipelines import \
    text_data_pipeline  # noqa: F401
from neurst_tpu_torch.data.data_pipelines import \
    bert_data_pipeline  # noqa: F401
from neurst_tpu_torch.data.data_pipelines import \
    gpt2_data_pipeline  # noqa: F401
