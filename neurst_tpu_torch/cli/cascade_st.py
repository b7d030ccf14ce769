"""Cascade speech translation: an ASR model's transcripts through an MT
model (the port's counterpart of ``neurst_tpu/cli/cascade_st.py``).

Each side's model is rebuilt from its model dir (``model_configs.yml``,
newest checkpoint) and beam-decodes its input: the audio dataset for the
ASR side, the transcripts as an ``InMemoryParallelTextDataset`` for the
MT side.  The translations go to ``--output_file``; with ``--ref_file``
the MT task's metric (BLEU) is printed.  ``--device`` picks the card as
``run_exp`` does: the current CUDA device by default; without CUDA it
raises unless ``--device cpu`` is given.

Usage:
    python -m neurst_tpu_torch.cli.cascade_st \\
        --asr_model_dir asr_ckpt --mt_model_dir mt_ckpt \\
        --dataset audio_tfrecord --data_path test.tfrecords \\
        [--asr_beam_size 4 --mt_beam_size 4 ...] --output_file out.txt \\
        [--ref_file refs.txt] [--device cpu]
"""

import argparse
import logging

import numpy as np

import neurst_tpu_torch  # noqa: F401 - fills the registries
from neurst_tpu_torch.data.datasets.dataset import build_dataset
from neurst_tpu_torch.data.datasets.parallel_text_dataset import \
    InMemoryParallelTextDataset
from neurst_tpu_torch.exps.base_experiment import BaseExperiment
from neurst_tpu_torch.layers.search.sequence_search import build_search_layer
from neurst_tpu_torch.models.model import resolve_device
from neurst_tpu_torch.tasks.task import build_task
from neurst_tpu_torch.utils.compat import DataStatus, ModeKeys
from neurst_tpu_torch.utils.configurable import (
    ModelConfigs, strip_training_only_model_flags)


def _decode_dataset(model_dir, dataset, beam_size, max_len, batch_size,
                    device):
    """Rebuilds the task and model of ``model_dir`` on ``device`` and
    beam-decodes ``dataset``: (task, hypothesis strings)."""
    cfg = ModelConfigs.load(model_dir)
    cfg["model.params"] = strip_training_only_model_flags(
        cfg.get("model.params"))
    task = build_task(cfg)
    model = task.build_model(cfg, device=device)
    BaseExperiment(model=model, model_dir=model_dir).restore_params()
    search = build_search_layer({
        "search_method.class": "beam_search",
        "search_method.params": {"beam_size": beam_size,
                                 "maximum_decode_length": max_len}})
    search.set_model(model)
    decode_fn = task.get_data_postprocess_fn(DataStatus.PROJECTED)
    hypotheses = []
    it = task.create_batch_iterator(dataset, ModeKeys.INFER,
                                    {"batch_size": batch_size})
    for batch in it():
        model_inp = {k: v for k, v in batch.items()
                     if isinstance(v, np.ndarray) and v.dtype != object}
        hyp, _ = search(model_inp)
        hyp = hyp.cpu().numpy()
        mask = batch.get("sample_mask")
        bsz = mask.shape[0] if mask is not None else hyp.shape[0]
        top_k = hyp.shape[0] // bsz
        for i in range(bsz):
            if mask is not None and mask[i] == 0:
                continue
            hypotheses.append(decode_fn(hyp[i * top_k].tolist()))
    return task, hypotheses


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="Cascade ST (ASR -> MT).")
    p.add_argument("--asr_model_dir", required=True)
    p.add_argument("--mt_model_dir", required=True)
    p.add_argument("--dataset", required=True,
                   help="The audio dataset class (e.g. audio_tfrecord).")
    p.add_argument("--data_path", required=True)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--asr_beam_size", type=int, default=4)
    p.add_argument("--mt_beam_size", type=int, default=4)
    p.add_argument("--maximum_decode_length", type=int, default=160)
    p.add_argument("--output_file", default=None)
    p.add_argument("--ref_file", default=None,
                   help="Reference translations for BLEU.")
    p.add_argument("--device", default=None,
                   help="The torch device ('cpu' runs the plain versions "
                        "of the kernels); the current CUDA device by "
                        "default.")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    audio_ds = build_dataset({"dataset.class": args.dataset,
                              "dataset.params": {
                                  "data_path": args.data_path}})
    _, transcripts = _decode_dataset(
        args.asr_model_dir, audio_ds, args.asr_beam_size,
        args.maximum_decode_length, args.batch_size, device)
    logging.info("ASR produced %d transcripts", len(transcripts))

    text_ds = InMemoryParallelTextDataset(transcripts)
    mt_task, translations = _decode_dataset(
        args.mt_model_dir, text_ds, args.mt_beam_size,
        args.maximum_decode_length, args.batch_size, device)
    logging.info("MT produced %d translations", len(translations))

    if args.output_file:
        with open(args.output_file, "w", encoding="utf-8") as f:
            for t in translations:
                f.write(t + "\n")
    if args.ref_file:
        with open(args.ref_file, encoding="utf-8") as f:
            refs = [line.strip() for line in f][:len(translations)]
        metric = mt_task.get_eval_metric({})
        print(metric(translations, refs))


if __name__ == "__main__":
    main()
