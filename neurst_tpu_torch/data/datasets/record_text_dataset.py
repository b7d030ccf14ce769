"""Record-backed parallel text (the port's copy of
``neurst_tpu/data/datasets/record_text_dataset.py``): TFRecord files of
``tf.train.Example`` with PROJECTED int64 "feature" / "label" id lists,
read through ``data/recordio.py`` with every record's crc32c checked."""

from neurst_tpu_torch.data.datasets.dataset import (RecordDataset,
                                                    register_dataset)
from neurst_tpu_torch.data.datasets.parallel_text_dataset import \
    AbstractParallelDataset

__all__ = ["ParallelRecordDataset"]


@register_dataset("parallel_tfrecord", "ParallelTFRecordDataset",
                  "parallel_tf_record_dataset")
class ParallelRecordDataset(RecordDataset, AbstractParallelDataset):

    @property
    def fields(self):
        return {"feature": "int64", "label": "int64"}

    def parse_record(self, parsed):
        return {k: (parsed[k].tolist() if hasattr(parsed[k], "tolist")
                    else parsed[k])
                for k in ("feature", "label") if k in parsed}
