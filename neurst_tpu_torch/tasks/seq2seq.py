"""The data-pipeline builder of ``neurst_tpu/tasks/seq2seq.py``, which the
speech task shares.  The text-to-text task itself is not ported yet."""

from neurst_tpu_torch.data.data_pipelines.data_pipeline import \
    build_data_pipeline

__all__ = ["build_pipeline"]


def build_pipeline(args, key):
    """The data pipeline configured under ``{key}.class`` /
    ``{key}.params`` (``TextDataPipeline`` by default)."""
    return build_data_pipeline({
        "data_pipeline.class": args.get(f"{key}.class") or "TextDataPipeline",
        "data_pipeline.params": args.get(f"{key}.params") or {}})
