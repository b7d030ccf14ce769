#!/usr/bin/env python3
"""Drives the PyTorch port's serving, training and predict paths on one
NVIDIA GPU and holds every kernel against its plain PyTorch version.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line (any failure raises and the script
exits non-zero):

1. device   -- requires CUDA; the card's name and power limit.
2. build    -- compiles every kernel from ``neurst_tpu_torch/csrc``.
3. kernel   -- each kernel against its plain version on the card, in f32
               and bf16, at its path's shape and at a ragged shape; times
               of the kernel, the plain version, one PyTorch library call
               of the same function where there is one, and the card's
               bound.  Flash forward (decode shape, ragged causal and the
               training shape [40, 750, 4, 64]; a head dim it is not
               built for is refused), flash dq and
               dk/dv (training shape [40, 750, 4, 64] with lengths {750,
               375, 1, 0, drawn}, and ragged causal), fused linear xent
               forward and backward ([6000, 256] x 8192 with bias,
               R = 37, V = 650, R = 1000, V = 8190 and [4096, 512] x
               32768; two backward calls bitwise equal), fused softmax
               xent forward and backward
               ([6000, 8192] f32 and bf16, [32768, 32768] bf16, ragged
               [67, 512], [9, 5120] and [37, 650]; no path runs them).
4. slice    -- ``speech_transformer_s`` (encoder flash attention on,
               bf16, vocab 8192) with seeded random weights in the JAX
               package's flat layout, loaded through ``param_bridge``,
               answers 3 requests of 16 x 1024 frames with beam-4 decode
               (max 64 steps); the launch counts of the run.
5. encoder cross-check -- the same weights and batch with flash off.
6. reference check -- the same weights in float32, a small request, on
               the card and on the CPU (plain versions): encoder outputs,
               hypotheses and scores agree.
   predict  -- the predict CLI (``neurst_tpu_torch.cli.run_exp``)
               in-process over a model dir, vocabulary, BPE codes and an
               ``audio_tfrecord`` file of 32 utterances written from the
               seed, with the MuST-C recipe's prediction config (beam 4,
               length penalty -1, max 150, BLEU) and batch_size 16: 32
               samples, 12 flash launches a batch, hypotheses equal to
               ``BeamSearch`` called directly; samples/s, the wall split,
               first-batch latency, peak memory; then float32 CLI runs on
               the card and the CPU agree on 4 short utterances.
               With attention dropout 0.1: the flash kernels against the
               plain versions with the same mask (and the mask read
               bitwise); the dropout mask kernel ([30000, 256] quantized
               rate, [37, 200] and [37, 199] exact rate, an unaligned
               flat view; bitwise, keep rate within 5 sigma, mean(y) /
               mean(x)); the fused FFN forward and backward (D 256: R =
               30000, 6000, 2000 and 37; D 512: R = 32768, 2000 and 37;
               F 2048, rate 0 and 0.1; its mask bitwise; two backward
               calls bitwise equal); the fused linear xent also at the
               NMT cell's [32768, 512] x 32768 (bf16); and the flash
               forward and backward at a TRAIN bucket's odd shape
               ([656, 46, 4, 64], the last row of length 0; f32 and bf16,
               dropout 0 and 0.1): finite, within the main shape's
               tolerances, the length-0 row's o, dq, dk, dv exactly 0.
7. train    -- ``speech_transformer_s`` trained in its MuST-C recipe's
               largest bucket (40 x 3000 frames, target 150), bf16 with
               bf16 stored params and an f32 master, encoder flash
               attention, dropout 0, label smoothing 0.1, Adam and the
               noam schedule: 2 warm-up and 5 timed steps on fresh seeded
               batches, then the forward / backward / optimizer split;
               launches per step of every kernel against the
               configuration; finite loss and grad norm, and moved
               parameters.
8. train_dropout -- the same with the recipe's dropout 0.1 at every
               site and a dropout key: also the same (key, step) gives a
               bitwise equal loss and the next step another.
   train_base, train_base_bf16 -- bench.py's train cell (``NMT_TRAIN``):
               ``transformer_base`` on [256, 128] token ids, vocabulary
               32768, bf16 compute, dropout 0.1 at every site with a
               dropout key, label smoothing 0.1, Adam, noam, clip norm 1;
               float32 stored params, then bf16 params with an f32
               master: 2 warm-up and 5 timed steps, the split, target
               tokens/s, MFU (bench.py's FLOPs of a step over the step
               and the bf16 peak), peak memory, launches per step against
               the configuration (the fused FFN at D 512 in all 12
               layers), the (key, step) repeat.
   trainer  -- the MuST-C recipe through ``run_exp --entry train``
               (``TRAINER``): run A, 12 steps on the top bucket (40 x
               <= 3000 frames, 100-150 target tokens), timed from the
               trainer's log windows, with the data-wait share of
               ``Trainer.run``, checkpoint seconds, peak memory and
               launches per step against the configuration; run B, the
               resume (step, Adam count and f32 master exact; first lr
               noam(13)); run C, one epoch over 128-3000 frames (a padded
               batch a bucket shape, finite losses and grad norms, first
               step time per shape); run D, ``avg_checkpoint`` of ckpt-6
               and ckpt-12, the predict entry on the average, and a
               float32 trainer on the card against the CPU
               (``speech_transformer_toy``, 2 steps).
   nmt_trainer -- the MuST-C MT recipe through ``run_exp --entry train``
               (``NMT_TRAINER``): ``translation`` token buckets of 32768
               tokens, ``transformer_base`` in bf16 with an f32 master
               and dropout 0.1, a seeded 4000-pair corpus with a 32768-word
               vocabulary a side; run A, 12 steps with the inline
               ``seq_generation_validator`` at step 12 (64 dev lines, beam
               4, lp 0.6, max 160 + 50); run B, 6 steps from
               ``parallel_tfrecord`` records: window tokens/s, data-wait
               share, checkpoint and validator seconds, peak memory, every
               step's launches of rows 4, 5, 8, 9, 10 against
               ``expected_launches`` at its bucket.
   nmt_predict -- the predict entry on run A's dir, must-c/
               mt_prediction_args.yml's form (MultipleDataset of dev and
               tst-COMMON, 128 lines each, batch 64, beam 4, lp 0.6, max
               180, BLEU), then the eval entry on the same sets:
               per-dataset samples/s and split, weighted metrics, the
               ``<file>.<name>`` outputs; no kernel launches.
   nmt_reference_check -- a 2-layer d 64 Transformer trained 2 steps and
               then predicting, in float32, on the card and on the CPU:
               losses, parameters and hypotheses agree.
   mt_quality -- examples/quality/mt_synth_base.yml cut to 300 steps and
               one validation on dev's first 128 lines: the quarter-mean
               loss falls, and the BLEU.
   audio_prep -- the MuST-C ST recipe's stages 02-03 through the port's
               CLIs (``AUDIO_PREP``), each a subprocess: prep_records, a
               seeded MuST-C tarball (16 talks of 60 s cut into 1-10 s
               train segments, 32 dev and 64 tst-COMMON segments) through
               extract_audio_transcripts and create_records (fbank, nfilt
               80; train by 1 and by 2 processors over 8 shards, the same
               records either way), and a LibriSpeech tarball of 32 FLAC
               files (``flac_encode``) whose decoded PCM must be bitwise
               the encoded one; record counts, and each record's frames =
               ``num_frames`` of its samples.  device_fbank,
               ``device_logfbank`` on 64 train segments read again from
               the tarball against their records' features (< 2e-3 on
               every channel with a filter; the empty channel 0), frame
               lengths equal, padding 0; its device ms against the host
               extractor's.  prep_project, learn_bpe (8000 symbols),
               process_text (bpe) and the triple records projected by
               ``MultiTaskSpeechTranslation`` (no Moses).  prep_train,
               ``run_exp --entry train`` with st_training_args.yml's task
               flags on the triple records (6 steps, a checkpoint at 6;
               every step's launches against ``expected_launches``);
               prep_predict, ``--entry predict`` in
               st_prediction_args.yml's form on tst-COMMON (12 flash
               launches a batch).  Wall seconds of each stage, audio
               seconds per wall second, megabytes of records, tokens/s,
               data-wait share, samples/s.
   multitask -- the joint ASR + ST recipe (``MULTITASK``): multitask_train,
               examples/multi_task_st/example_configs/multitask_st.yml
               through ``run_exp --entry train`` (its task flags and
               joint criterion; ``speech_transformer_s``, flash, dropout
               0.1, bf16 + f32 master) on 80 seeded triples of 2782-3000
               frames with 90-120-unit transcripts and translations, 12
               steps, a checkpoint every 6: every step's launches against
               ``expected_launches`` (the transcript decoder counted: 192
               dropout, 0 fused xent), both decoders' weights moving,
               window tokens/s of both sides, data wait, checkpoint
               seconds, peak memory, and the bare step at the top bucket
               beside train_dropout's; multitask_predict, ``--entry
               predict`` on 32 triples (batch 16, beam 4, max 150) on the
               translation head (BLEU) and the transcript head (WER), then
               ``--model_dir A,B`` (ckpt-12, ckpt-6) and ``A,A``, which
               must give A's hypotheses: 12 flash launches a batch a
               model; cascade, ``cascade_st`` from an ASR dir (6 steps of
               must-c/asr_training_args.yml's flags) to an MT dir (6 steps
               of mt_training_args.yml's, ``transformer_base``) with each
               side's samples/s and BLEU; multitask_reference_check, the
               joint trainer at ``speech_transformer_toy`` in float32 for
               2 steps and an ASR-head decode, card against CPU.
   waitk   -- examples/simultaneous_translation/waitk_training_args.yml
               (``WAITK``) on a seeded 4000-pair corpus with a joint BPE of
               2000 merges learned by the port's learn_bpe (vocabularies
               padded with unused entries to a multiple of 128):
               waitk_train, ``run_exp --entry train`` (``waitk_translation``
               drawing wait_k from [3, 5, 7, 9] a batch,
               ``waitk_transformer`` at transformer_base's widths with a
               monotonic flash encoder, dropout 0.1, bf16 + f32 master,
               25,000-token buckets, max 128 / 128, 6 steps and a
               checkpoint at 6: the laggings drawn, every step's
               launches against ``expected_launches``, window tokens/s,
               and one batch's float32 loss with the flash encoder against
               the dense one); waitk_simuleval, ``simuleval_cli`` offline
               over 16 sentences of 20-60 single-unit words (--wait_k 3,
               --max_decode_len 64: AL, CW, BLEU, sentences/s, the ms of a
               READ's re-encode and of a WRITE's step, 6 flash launches a
               READ) and online against a mock SimulEval server on
               127.0.0.1 over 8 of them (the agent's output ids and delays
               equal the offline ones); waitk_predict, ``--entry predict``
               with beam 4 over 64 sentences (6 flash launches a batch);
               lightconv_train / lightconv_predict, ``lightconv_base`` with
               the same data and buckets, dropout 0.1 at every site
               (convolution weights included), 6 steps, then beam 4 and
               top_sampling (top_k 8).  The kernel phase also holds the
               causal flash forward, dq and dk/dv at the wait-k bucket
               ([192, 128, 8, 64], dropout 0.1) and the forward at the
               streaming prefixes [1, 8-128, 8, 64] against their plain
               versions.
   pretrained -- slice 10 under ``build/pretrained_smoke/``: convert,
               four seeded state dicts in the public layouts at their
               published sizes (BERT-base cased, GPT-2 117M, wav2vec2-base,
               fairseq transformer_wmt_en_de) written with torch.save and
               converted by ``python -m neurst_tpu_torch.cli.
               convert_checkpoint`` (seconds, bytes); reference_golden,
               every original-NeurST TF fixture under
               tests/fixtures/reference_goldens converted by the port's
               TF-free reader and decoded in float32 on the card, every
               hypothesis equal to its golden; ctnmt, examples/ctnmt's
               dynamic_switch.yml at its widths (BERT-base 12 x 768 beside
               a 12-layer encoder and a 6-layer decoder of 768) through
               ``run_exp --entry train`` for 30 steps with the converted
               BERT restored under ``bert/`` (151 names) and frozen (its
               saved weights bf16(pretrain) bit for bit), every step's
               launches (the mask kernel at every dropout site, BERT's
               included; rows 1-5 and 9-10 0), then predict (beam 8, lp
               0.6, max 200) over 64 sentences, one step each of
               rate_schedule.yml (bert_as_encoder) and
               asy_distillation.yml (the KD criterion, a KD term > 0), and
               a float32 loss on the card against the CPU; gpt2_lm,
               ``gpt2_117m`` from the converted GPT-2 on 256-1024-token
               sequences (8192-token buckets, dropout 0.1): 20 steps, eval
               (PPL), predict (16 prompts continued 64 tokens by beam 4 and
               by top_sampling), float32 logits on the card against the
               CPU; wav2vec2, the converted wav2vec2-base over [8, 160000]
               samples in bf16 and float32 (499 frames), float32 against
               the CPU.
   long_audio -- bench.py's long-audio cells: ``speech_transformer_s``'s
               encoder over 4 x 8192 frames (T 2048), dense and flash,
               forward and forward + backward (bf16); the kernel phase
               holds the flash forward, dq and dk/dv at [4, 2048, 4, 64]
               against their plain versions.
   spec_*   -- speculative decoding through ``run_exp --entry predict``
               against plain greedy, in bfloat16 and float32 (target
               passes, tokens committed and host synchronisations a pass,
               samples/s; every row equal to plain greedy but from a
               near-tie, ``SPEC_TIE_TOL``): spec_speech after predict on
               its dir (n-gram, k 4; flash 12 a batch), spec_text after
               mt_quality on its dir (the committed n-gram and draft ymls,
               a 300-step transformer_256_3e_1d draft, sampling top_k 8),
               spec_gpt2 after gpt2_lm on its dir (prompt lookup, 64
               tokens).
   multilingual -- must-c/mt_training_args.yml's flags on the
               multilingual task (``MULTILINGUAL``): 12 steps of
               transformer_base over four directions of a seeded
               three-language corpus, every step a full bucket with its
               launches, each direction's share; 5 steps with the target
               tag on the source and ``enable_profiler`` (the trace holds
               the card's kernels); predict per direction (no tag in a
               hypothesis, R13's start token); one float32 batch's loss
               on the card against the CPU.
   qat_*    -- slice 12's quantization-aware training: qat_speech_step,
               ``speech_transformer_s`` under QAT (mt_synth_qat.yml's
               quant params) in bf16, flash on, dropout 0.1, on
               train_dropout's batches and key (launches per step: flash
               and the mask kernel, no fused FFN or xent; step ms and the
               losses beside train_dropout's); qat_train,
               examples/quality/mt_synth_base.yml with the
               mt_synth_qat.yml overlay through ``run_exp --entry train``
               cut to 300 steps, as mt_quality (every step's launches:
               the mask kernel only); qat_predict, ``--entry predict`` on
               its dir four ways (fake quant, int8 dynamic, int8 static
               from the learned clips and self-calibration, int8
               weight-only): BLEU and the share of hypotheses equal to
               the fake-quant ones.
   int8_serve -- each ``Int8Dense`` mode on the card against the CPU
               (int32 accumulators equal, float32 outputs within
               ``INT8_DENSE_TOL``); the slice's speech decode (16 x 1024
               frames, beam 4) and bench.py's batch-1 greedy
               ``transformer_base`` decode (source 32, 64 steps) in bf16
               and the three int8 modes: request ms, rows equal to bf16,
               weight bytes at rest.
   moe_*    -- moe_train, examples/moe's Switch overlay (8 experts, top-1,
               every 2nd FFN) on ``transformer_base`` at [128, 128],
               vocabulary 32768, beside the dense model as a bare step
               (target tokens/s at matched active FLOPs, launches per
               step against the configuration); moe_trainer and
               moe_predict, the overlay through ``--entry train`` (12
               steps on the mt_synth corpus) and ``--entry predict`` (128
               dev lines); the GShard top-2 overlay as a bare step beside
               them; then rows 4-5, 8 and 9-10 against their plain
               versions at the shapes this path gave them.
   orbax    -- the moe trainer writes ``--checkpoint_format orbax`` and
               moe_predict reads its ``ckpt-12.orbax``; the dir resumed
               for 2 steps, ``ckpt-14.orbax`` read back bitwise equal to
               the trainer's float32 master; the JAX package's checkpoint
               in ``tests/fixtures/orbax_jax`` read bitwise, and the C++
               zstd decoder's seconds on its frames repeated to a
               ``transformer_base`` checkpoint's bytes.
   dispatch -- the host time a call of the flash forward's and the fused
               FFN forward's wrappers (custom ops since slice 13) at
               shapes whose device work is a few us, beside its device
               time.
   export_speech -- the export entry (``run_exp --entry export``) on the
               predict phase's ``speech_transformer_s`` dir at the
               slice's shapes (16 x 1024 frames, beam 4, 64 steps): the
               encode program holds 12 flash custom-op nodes; reloaded
               with ``load_exported`` in a process of its own, its
               hypotheses on 3 requests equal the eager ``BeamSearch``'s
               on the card; export seconds, artifact bytes, request ms
               against eager.  export_sampling / export_speculative:
               ``top_sampling`` (under its seed) and greedy
               ``speculative_decode`` (the n-gram draft) exported and
               loaded on the card, each request's tokens equal to the
               eager search's, the speculative rows to plain greedy's.
   parallel -- 2 ranks of this script on the card (gloo), beside the audio
               prep: dp 2 and tp 2 transformer_base steps, dp 2 of the
               speech step, ring attention, the pipeline, decode, the
               train entry, and expert parallelism (``parallel_ep``: the
               Switch overlay with 4 of its 8 experts a rank, a float32
               step held to one rank's, bf16 steps timed and their
               launches counted); then a one-rank NCCL group.
   remat_step -- train_dropout's step with and without
               ``gradient_remat``: the first batch's loss bitwise equal,
               gradients within the bf16 backward tolerance, the forward
               kernels launched twice a step; step ms and peak memory.
   pruning_trainer / prune_tune -- examples/weight_pruning/
               training_args.yml as it is through ``run_exp --entry
               train`` on the text trainer's corpus and
               ``transformer_base`` (begin / end / frequency cut to 2 / 10
               / 4 for 12 steps): every step's launches against the
               unpruned configuration, the checkpoint's zeros at the
               schedule's target in every pruned variable and the
               excluded ones dense, a mask-refresh step's ms against a
               plain one; then 6 steps of the PruneTune plug-in
               (``--entry partial_tune --include``) with the dense slots
               bitwise frozen, and ``mask_predict`` on the tuned dir equal
               to ``predict`` on the general one.
9. train reference check -- the same weights in float32, 2 x 256 frames
               and target 16, dropout 0 and then 0.1: one step on the
               card and one on the CPU (plain versions) give the same
               loss, gradients, grad norm and updated parameters; then
               the same for ``transformer_128_2e_2d_4h`` on [2, 16] ids;
               then QAT's fake quant and ``QuantDense`` card against CPU
               on the same inputs (qat_dense_check), the whole QAT speech
               step's loss (qat_reference_check) and a float32 Switch
               MoE step (moe_reference_check) card against CPU.
Then the kernel summary line (launches by path), and last the device
line.

The script imports nothing of JAX and nothing of ``neurst_tpu``.
"""

import argparse
import ast
import contextlib
import glob
import io
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# kernel-vs-plain tolerances (max abs error over o; lse in parentheses).
# float32: both sides sum in float32, in different orders.  bfloat16:
# the kernel rounds P to bf16 against the running row max, the plain
# version against the final one, and o itself is stored in bf16.
KERNEL_TOL = {"float32": (2e-5, 5e-5), "bfloat16": (3e-2, 1e-3)}
# flash vs plain encoder, bf16, 12 layers: the two paths round the
# attention probabilities at different places (max abs, mean abs)
ENCODER_TOL = (0.25, 0.02)
# float32 card vs CPU, whole path: sums in other orders only (encoder
# output max abs; beam score max abs); hypotheses must be equal
REFERENCE_TOL = (1e-4, 1e-4)

# flash backward, kernel vs plain: max abs error of dq, dk and dv, each
# relative to its largest |value|.  float32: both sides sum in float32;
# bf16: the outputs are stored in bf16 (2^-8 relative) and ds and p are
# rounded before the products, where a value one rounding step away
# flips one bf16 ulp of a summand
BWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# fused linear xent, kernel vs plain: xent and lse max abs (float32 sums
# of 256 products and of V exponentials in other orders); dx, dW and db
# relative to their largest |value| (bf16: dx and dW stored in bf16, and
# dz rounded before both products)
XENT_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-4, 1e-2)}
# float32 card vs CPU, one training step of the whole model: loss and
# grad norm relative; each gradient by its relative L2 error (sums in
# other orders through 18 layers, and a FFN ReLU whose pre-activation
# sits at zero may flip between the two, which moves a few summands of
# that layer's dense1 gradient: measured 1e-3 at worst, median 3e-6 of
# the largest |value|); updated parameters within 2 lr + 1e-6 (Adam's
# first update is ~lr * sign(g), so a near-zero gradient whose sign
# differs moves a weight by up to 2 lr)
TRAIN_REF_TOL = (1e-4, 5e-3)
# fused FFN, kernel vs plain on the same inputs (y and hd; the gradients
# from the same hd and dy), each relative to its largest |value|.
# float32: sums of D or F products in other orders (the kernel's FMA
# loops against cuBLAS).  bf16: both sides multiply the same bf16 values
# and accumulate in float32, in other orders, and round hd, dh, y and the
# gradients to bf16, where a sum one rounding step away flips one bf16
# ulp (2^-8 relative) of a summand or an output
FFN_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 1e-2)}
# dropout kernel vs plain: bitwise (the same Philox words, one float32
# multiply, one rounding); the masks of the dropout, FFN and flash
# kernels are compared bitwise too
DROPOUT_RATE = 0.1

SLICE = dict(model="speech_transformer_s", batch=16, frames=1024,
             feature_dim=80, vocab=8192, beam=4, max_decode=64,
             requests=3, min_src=600)
# the MuST-C ST recipe's largest bucket (batch_size 120000 frames,
# max_src_len 3000, max_trg_len 150): 40 utterances x 3000 frames; the
# train phase runs it in the configuration bench.py's flash training cell
# uses (dropout 0), the train_dropout phase with the recipe's dropout 0.1
# at every site
TRAIN = dict(model="speech_transformer_s", batch=40, frames=3000,
             min_src=2400, trg_len=150, min_trg=100, feature_dim=80,
             vocab=8192, label_smoothing=0.1, warmup=2, steps=5, split=2)
# bench.py's train cell (bench.py:160-164, 864-923): transformer_base, the
# WMT14 recipe's model (examples/translation/task_args_bpe.yml), at
# [256, 128] seeded token ids with no padding and a vocabulary of 32768
# on both sides, bf16 compute, dropout 0.1 at every site, label smoothing
# 0.1, Adam (0.9, 0.98, 1e-9), noam (dmodel 512, warmup 4000), clip norm
# 1; once with float32 stored params, once with bf16 params and a float32
# master.  The float32 card-vs-CPU check trains transformer_128_2e_2d_4h
# on [2, 16].
NMT_TRAIN = dict(model="transformer_base", batch=256, length=128,
                 vocab=32768, label_smoothing=0.1, clip_norm=1.0, warmup=2,
                 steps=5, split=2, check_model="transformer_128_2e_2d_4h",
                 check_batch=2, check_length=16, check_src_vocab=384,
                 check_trg_vocab=256)
# the predict CLI as the MuST-C recipe runs it on tst-COMMON
# (examples/speech_transformer/must-c/st_prediction_args.yml: beam 4,
# length penalty -1, at most 150 tokens, BLEU) with batch_size 16: 32
# utterances of 300-3000 frames (1-30 s), translations of 5-60 words; the
# float32 card-vs-CPU check decodes 4 utterances of 300-600 frames
PREDICT = dict(model="speech_transformer_s", utterances=32, batch=16,
               min_frames=300, max_frames=3000, min_words=5, max_words=60,
               feature_dim=80, vocab=8192, check_utterances=4,
               check_max_frames=600)
PREDICT_ARGS = {
    "entry.class": "predict",
    "entry.params": {
        "search_method.class": "beam_search",
        "search_method.params": {"beam_size": 4, "length_penalty": -1,
                                 "maximum_decode_length": 150},
        "metric.class": "bleu"},
    "dataset.class": "audio_tfrecord",
    "dataset.params": {"feature_key": "audio",
                       "transcript_key": "translation"},
    "batch_size": PREDICT["batch"]}


_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase row also carries ``t_s``, the seconds since
    the script started (where a run's time goes, phase by phase)."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - _START)
    print(json.dumps(obj), flush=True)


def device_phase():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs the "
                         "port on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def build_phase():
    from neurst_tpu_torch.ops import _build
    start = time.perf_counter()
    compiled = _build.build()
    ptxas = {}
    for name in _build.KERNEL_SOURCES:
        log = _build.library_path(name).with_suffix(".log")
        ptxas[name] = [line.strip() for line in log.read_text().splitlines()
                       if "registers" in line or "smem" in line] \
            if log.exists() else []
    emit({"phase": "build", "seconds": round(time.perf_counter() - start, 2),
          "compiled": {k: round(v, 2) for k, v in compiled.items()},
          "ptxas": ptxas})


# spin-kernel cycles per second of host time to cover (above the H100's
# top SM clock, so the spin outlasts the host's queueing)
SPIN_CYCLES_PER_S = 2.5e9


def time_ms(fn, iters=30, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls.  A
    spin kernel queued ahead keeps the card busy while the host queues
    the calls, so the events time the device's work alone, not the host's
    wrappers and launches between calls (which exceed the work of a
    kernel of a few tens of microseconds)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host = time.perf_counter()
    fn()
    host = time.perf_counter() - host
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * host * iters + 1e-3, 2.0)
                          * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops, dtype):
    """(least time in ms, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the operations over the dtype's peak
    rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).replace("torch.", "")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _valid_keys_and_pairs(lengths, t, causal):
    """Keys some query may attend (the first ``length`` of each row) and
    valid (query, key) pairs of one head, over the batch."""
    keys = pairs = 0
    for length in lengths.tolist():
        length = max(0, min(int(length), t))
        keys += length
        if causal:
            pairs += sum(min(r + 1, length) for r in range(t))
        else:
            pairs += t * length
    return keys, pairs


def attention_bound_ms(q, lengths, causal, kernel="fwd"):
    """Least time for one flash kernel on these inputs.  Bytes: every
    q-side row of q, o (or dO, dq) and the [B, N, T] float32 statistics
    once, k and v (and dk, dv read side) over the keys some query may
    attend, dk and dv written over all keys, lengths once.  Operations:
    2 H per product per valid (query, key) pair: 2 products forward
    (q k^T, p v), 3 in dq (q k^T, dO v^T, ds k), 4 in dk/dv (and ds^T q,
    p^T dO)."""
    b, t, n, h = q.shape
    elem = q.element_size()
    keys, pairs = _valid_keys_and_pairs(lengths, t, causal)
    row = b * t * n * h * elem
    stats = b * n * t * 4
    nbytes, products = {
        "fwd": (2 * row + 2 * keys * n * h * elem + stats, 2),
        "dq": (3 * row + 2 * keys * n * h * elem + 2 * stats, 3),
        "dkv": (4 * row + 2 * keys * n * h * elem + 2 * stats, 4),
    }[kernel]
    return bound_ms(nbytes + b * 4, 2.0 * h * n * pairs * products, q.dtype)


def xent_bound_ms(x, w, kernel):
    """Least time for the fused linear xent forward (x, W, bias, labels
    read; xent and lse written; 2 R V D operations) or backward (x, W,
    bias, labels, lse, g read; dx, dW, db written; 6 R V D: the logits
    again and the two gradient products)."""
    rows, dim = x.shape
    vocab = w.shape[0]
    elem = x.element_size()
    operands = (rows + vocab) * dim * elem
    if kernel == "fwd":
        return bound_ms(operands + vocab * 4 + rows * 12,
                        2.0 * rows * vocab * dim, x.dtype)
    return bound_ms(2 * operands + 2 * vocab * 4 + rows * 12,
                    6.0 * rows * vocab * dim, x.dtype)


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _abs_err(got, want):
    return float((got.float() - want.float()).abs().max())


def flash_fwd_kernel_phase(seed):
    """flash_attention_fwd against flash_attention_reference."""
    import torch
    from torch.nn import functional as F

    from neurst_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_reference)

    rng = np.random.RandomState(seed)
    b, n, h = SLICE["batch"], 4, 64
    t_main = SLICE["frames"] // 4
    main_lengths = [t_main, 150, 1, 0] + list(
        rng.randint(1, t_main + 1, size=b - 4))
    # the training slice's encoder shape, drawn as flash_bwd_kernel_phase
    # draws its main case: the dropout-0 training step launches the
    # forward there 12 times a step
    train_rng = np.random.RandomState(seed + 10)
    t_train = TRAIN["frames"] // 4
    train_lengths = [t_train, t_train // 2, 1, 0] + list(
        train_rng.randint(1, t_train + 1, size=TRAIN["batch"] - 4))
    cases = [("main", t_main, main_lengths, False, rng),
             ("ragged_causal", 200, list(rng.randint(0, 201, size=4)), True,
              rng),
             ("train", t_train, train_lengths, False, train_rng)]
    results = {}
    for case, t, lengths, causal, case_rng in cases:
        for dtype in (torch.float32, torch.bfloat16):
            bb = len(lengths)
            # the main path hands the kernel strided slices of the fused
            # qkv projection
            qkv = torch.from_numpy(case_rng.randn(bb, t, 3, n, h).astype(
                np.float32)).to("cuda", dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            o, lse = flash_attention_fwd(q, k, v, lens, causal)
            o_ref, lse_ref = flash_attention_reference(q, k, v, lens, causal)
            torch.cuda.synchronize()
            err = float((o.float() - o_ref.float()).abs().max())
            lse_err = float((lse - lse_ref).abs().max())
            name = str(dtype).replace("torch.", "")
            tol, lse_tol = KERNEL_TOL[name]
            if not (err <= tol and lse_err <= lse_tol):
                raise AssertionError(
                    f"flash_attention_fwd {case} {name}: max abs err "
                    f"{err} (tol {tol}), lse {lse_err} (tol {lse_tol})")
            kernel_ms = time_ms(lambda: flash_attention_fwd(
                q, k, v, lens, causal))
            plain_ms = time_ms(lambda: flash_attention_reference(
                q, k, v, lens, causal))
            col = torch.arange(t, device="cuda")
            mask = (col[None, :] < lens[:, None])[:, None, None, :]
            if causal:
                mask = mask & (col[None, :] <= col[:, None])[None, None]
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
            bound_ms, bound_by = attention_bound_ms(q, lens, causal)
            row = {"phase": "kernel", "kernel": "flash_attention_fwd",
                   "case": case, "dtype": name, "shape": [bb, t, n, h],
                   "causal": causal, "max_abs_err": err, "tol": tol,
                   "lse_max_abs_err": lse_err, "lse_tol": lse_tol,
                   "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by}
            emit(row)
            results[(case, name)] = row
    # a head dim the kernel is not built for is refused before launch
    before = flash_attention_fwd.launches
    try:
        flash_attention_fwd(q[..., :32], k[..., :32], v[..., :32], lens)
    except ValueError:
        pass
    else:
        raise AssertionError("flash_attention_fwd took head_dim 32")
    if flash_attention_fwd.launches != before:
        raise AssertionError("a refused call counted a launch")
    return results


def _key_mask(lens, t, causal):
    """The boolean [B, 1, T, T] mask ``scaled_dot_product_attention``
    takes for the kernels' key-length (and causal) mask."""
    import torch
    col = torch.arange(t, device="cuda")
    mask = (col[None, :] < lens[:, None])[:, None, None, :]
    if causal:
        mask = mask & (col[None, :] <= col[:, None])[None, None]
    return mask


def flash_bwd_kernel_phase(seed):
    """flash_attention_dq and flash_attention_dkv against the plain
    backward on the same (q, k, v, dO, lse, delta), at the training
    slice's encoder shape and at a ragged causal shape.  The library
    time is the backward of ``scaled_dot_product_attention`` with a
    boolean key mask (forward + backward, minus forward), which computes
    dq, dk and dv together; so does the plain version."""
    import torch
    from torch.nn import functional as F

    from neurst_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(seed + 10)
    b, n, h = TRAIN["batch"], 4, 64
    t_main = TRAIN["frames"] // 4
    main_lengths = [t_main, t_main // 2, 1, 0] + list(
        rng.randint(1, t_main + 1, size=b - 4))
    cases = [("main", t_main, main_lengths, False),
             ("ragged_causal", 200, list(rng.randint(0, 201, size=4)), True)]
    results = {}
    for case, t, lengths, causal in cases:
        for dtype in (torch.float32, torch.bfloat16):
            bb = len(lengths)
            qkv = torch.from_numpy(rng.randn(bb, t, 3, n, h).astype(
                np.float32)).to("cuda", dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            do = torch.from_numpy(rng.randn(bb, t, n, h).astype(
                np.float32)).to("cuda", dtype)
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            o, lse = fa.flash_attention_fwd(q, k, v, lens, causal)
            delta = fa._delta(o, do)
            args = (q, k, v, do, lse, delta, lens, causal)
            got = (fa.flash_attention_dq(*args),) + fa.flash_attention_dkv(
                *args)
            want = fa._bwd_plain(*args)
            torch.cuda.synchronize()
            name = str(dtype).replace("torch.", "")
            rel = {g: _rel_err(x, y) for g, x, y in zip(
                ("dq", "dk", "dv"), got, want)}
            err = {g: _abs_err(x, y) for g, x, y in zip(
                ("dq", "dk", "dv"), got, want)}
            if max(rel.values()) > BWD_TOL[name]:
                raise AssertionError(f"flash backward {case} {name}: "
                                     f"relative errors {rel} (tol "
                                     f"{BWD_TOL[name]})")
            plain_ms = time_ms(lambda: fa._bwd_plain(*args), iters=5)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            mask = _key_mask(lens, t, causal)

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)

            library_ms = time_ms(lambda: torch.autograd.grad(
                sdpa(), (qt, kt, vt), do.transpose(1, 2))) - time_ms(sdpa)
            for kernel, fn, outs in (
                    ("dq", fa.flash_attention_dq, ("dq",)),
                    ("dkv", fa.flash_attention_dkv, ("dk", "dv"))):
                bound, bound_by = attention_bound_ms(q, lens, causal, kernel)
                row = {"phase": "kernel",
                       "kernel": f"flash_attention_{kernel}", "case": case,
                       "dtype": name, "shape": [bb, t, n, h],
                       "causal": causal,
                       "max_abs_err": max(err[g] for g in outs),
                       "rel_err": {g: rel[g] for g in outs},
                       "tol": BWD_TOL[name],
                       "kernel_ms": time_ms(lambda: fn(*args)),
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": bound, "bound_by": bound_by}
                emit(row)
                results[(kernel, case, name)] = row
    return results


def _xent_fwd_plan(fc, rows, vocab, dim, dtype, launches):
    """The forward's plan at this shape (bf16: ``fwd_plan``; float32: the
    FMA kernel's 32-row tiles over the whole vocabulary) with the
    launches one call counted, which must be ``fwd_launches``.  None for
    a package without ``fwd_plan`` (an older checkout that
    ``tools/compare_flash_kernels.py`` times)."""
    import torch
    if not hasattr(fc, "fwd_plan"):
        return None
    splits, tile_rows = 1, 32
    if dtype == torch.bfloat16:
        splits, _, tile_rows, _ = fc.fwd_plan(rows, vocab, dim)
    want = fc.fwd_launches(rows, vocab, dim, dtype)
    if launches != want:
        raise AssertionError(f"fused_linear_xent_fwd [{rows}, {dim}] x "
                             f"{vocab} {dtype}: {launches} launches, "
                             f"expected {want}")
    return {"splits": splits, "tile_rows": tile_rows, "launches": launches}


def xent_kernel_phase(seed, cases=None):
    """fused_linear_xent_fwd and _bwd against their plain versions on the
    same inputs, at the training slice's shape (6000 target rows, d 256,
    the 8192-word tied softmax with its bias), at a ragged one, at one
    whose row tiles and vocabulary split both end ragged (1000 rows,
    8190 words), at d 512 (4096 rows, 32768 words) and, in bf16 alone,
    at the NMT train cell's [32768, 512] x 32768 and at the LightConv
    trainer's [24576, 512] x 1536 (or at the given ``cases``, each
    (name, rows, vocab, dim, dtypes)); two backward
    calls of each must give the same bits, and the forward's row carries
    its plan (vocabulary splits, tile rows, launches a call: counted, and
    held to ``fwd_launches``).  No single PyTorch call computes this
    function: ``label_smoothing`` of ``cross_entropy`` spreads eps over
    all V classes where NeurST spreads it over V - 1, so ``library_ms``
    is null and the time of ``F.cross_entropy(F.linear(...))`` is
    printed beside it as a composite."""
    import torch
    from torch.nn import functional as F

    from neurst_tpu_torch.ops import fused_ce as fc

    rng = np.random.RandomState(seed + 20)
    smoothing = TRAIN["label_smoothing"]
    both = (torch.float32, torch.bfloat16)
    cases = cases or [
        ("main", TRAIN["batch"] * TRAIN["trg_len"], TRAIN["vocab"], 256,
         both), ("ragged", 37, 650, 256, both),
        ("ragged_split", 1000, 8190, 256, both),
        ("d512", 4096, 32768, 512, both),
        ("nmt_train", NMT_TRAIN["batch"] * NMT_TRAIN["length"],
         NMT_TRAIN["vocab"], 512, (torch.bfloat16,)),
        ("lightconv_train", WAITK["lightconv_xent_rows"],
         WAITK["target_vocab"], 512, (torch.bfloat16,))]
    results = {}
    for case, rows, vocab, dim, dtypes in cases:
        c, low = 1.0 - smoothing, smoothing / (vocab - 1)
        for dtype in dtypes:
            def draw(*shape, scale=1.0):
                return torch.from_numpy(
                    (scale * rng.randn(*shape)).astype(np.float32)).cuda()
            x = draw(rows, dim).to(dtype)
            w = draw(vocab, dim, scale=dim ** -0.5).to(dtype)
            bias = draw(vocab, scale=0.1)
            labels = torch.from_numpy(rng.randint(0, vocab, size=rows).astype(
                np.int32)).cuda()
            g = torch.from_numpy(rng.rand(rows).astype(np.float32)).cuda()
            fwd_args = (x, w, bias, labels, c, low)
            before = fc.fused_linear_xent_fwd.launches
            xent, lse = fc.fused_linear_xent_fwd(*fwd_args)
            plan = _xent_fwd_plan(fc, rows, vocab, dim, dtype,
                                  fc.fused_linear_xent_fwd.launches - before)
            bwd_args = (x, w, bias, labels, lse, g, c, low)
            grads = fc.fused_linear_xent_bwd(*bwd_args)
            # no atomics: a second call of each gives the same bits
            fwd_repeat = all(torch.equal(a, b_) for a, b_ in zip(
                (xent, lse), fc.fused_linear_xent_fwd(*fwd_args)))
            repeat = all(torch.equal(a, b_) for a, b_ in zip(
                grads, fc.fused_linear_xent_bwd(*bwd_args)))
            ref_xent, ref_lse = fc._fwd_plain(*fwd_args)
            ref_grads = fc._bwd_plain(*bwd_args)
            torch.cuda.synchronize()
            name = str(dtype).replace("torch.", "")
            val_tol, grad_tol = XENT_TOL[name]
            fwd_err = max(_abs_err(xent, ref_xent), _abs_err(lse, ref_lse))
            rel = {k: _rel_err(a, b_) for k, a, b_ in zip(
                ("dx", "dw", "db"), grads, ref_grads)}
            if fwd_err > val_tol or max(rel.values()) > grad_tol \
                    or not (repeat and fwd_repeat):
                raise AssertionError(
                    f"fused_linear_xent {case} {name}: xent/lse err "
                    f"{fwd_err} (tol {val_tol}), gradients {rel} (tol "
                    f"{grad_tol}), two forward calls equal: {fwd_repeat}, "
                    f"two backward calls equal: {repeat}")
            leaves = [t.detach().requires_grad_() for t in (x, w)]

            def composite():
                return F.cross_entropy(
                    F.linear(leaves[0], leaves[1], bias.to(dtype)),
                    labels.long(), label_smoothing=smoothing)

            composite_fwd = time_ms(composite)
            composite_bwd = time_ms(lambda: torch.autograd.grad(
                composite(), leaves)) - composite_fwd
            for kernel, fn, args, plain, err, composite_ms in (
                    ("fwd", fc.fused_linear_xent_fwd, fwd_args,
                     fc._fwd_plain, fwd_err, composite_fwd),
                    ("bwd", fc.fused_linear_xent_bwd, bwd_args,
                     fc._bwd_plain, max(_abs_err(a, b_) for a, b_ in zip(
                         grads, ref_grads)), composite_bwd)):
                bound, bound_by = xent_bound_ms(x, w, kernel)
                row = {"phase": "kernel",
                       "kernel": f"fused_linear_xent_{kernel}",
                       "case": case, "dtype": name,
                       "shape": [rows, dim, vocab], "max_abs_err": err,
                       "tol": val_tol if kernel == "fwd" else grad_tol,
                       "kernel_ms": time_ms(lambda: fn(*args), iters=10),
                       "plain_ms": time_ms(lambda: plain(*args), iters=5),
                       "library_ms": None,
                       "composite_cross_entropy_linear_ms": composite_ms,
                       "bound_ms": bound, "bound_by": bound_by}
                if kernel == "fwd":
                    row["plan"] = plan
                    row["bitwise_repeat"] = fwd_repeat
                else:
                    row["rel_err"] = rel
                    row["bitwise_repeat"] = repeat
                emit(row)
                results[(kernel, case, name)] = row
    return results


# fused_softmax_xent, kernel vs plain: xent and lse relative to their
# largest |value| (float32 sums of V terms in other orders, expf against
# torch's exp); dz max abs in float32 (p = exp(z - lse) one expf ulp
# apart, and where V p is near 1 the two terms cancel, so the error is
# absolute, not relative); in bf16, both round float32 values that may
# differ by that much, so dz may differ by it plus one bf16 ulp of the
# element (reported as ulps beyond the float32 tolerance)
SOFTMAX_XENT_TOL = {"xent": 1e-5, "float32": 1e-6, "bfloat16": 1.0}


def _bf16_ulps(got, want, slack):
    """Largest |got - want| - ``slack`` in units of the bf16 ulp of the
    larger of the two, elementwise (0 where within ``slack``)."""
    import torch
    a, b = got.float(), want.float()
    big = a.abs().maximum(b.abs()).clamp_min(1e-38)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7.0)
    return float(((a - b).abs() - slack).clamp_min(0.0).div(ulp).max())


def softmax_xent_bound_ms(z, kernel):
    """Least time for fused_softmax_xent: bytes, the R V logits read once
    (and, backward, dz written once) plus the int32 labels and the float32
    row vectors (xent, lse out; lse, g in); operations, ~4 float32 ones a
    logit (subtract, exp, two adds; backward about 6)."""
    rows, vocab = z.shape
    logits = rows * vocab * z.element_size()
    if kernel == "fwd":
        return bound_ms(logits + rows * 12, 4.0 * rows * vocab, "float32")
    return bound_ms(2 * logits + rows * 12, 6.0 * rows * vocab, "float32")


def softmax_xent_kernel_phase(seed):
    """fused_softmax_xent_fwd and _bwd (rows 6-7) against their plain
    versions on the same logits: the recipe's target rows x vocabulary
    [6000, 8192] in float32 and bf16, bench.py's transformer_base train
    cell [32768, 32768] (256 x 128 tokens, vocabulary 32768) in bf16, the
    JAX tests' ragged [67, 512] (bf16) and [9, 5120] (float32, labels in
    the last partial 4096-column block), and [37, 650] (bf16, a
    vocabulary that takes the one-element loads).  The library call is
    ``F.cross_entropy(z.float(), y, label_smoothing=V low)``, the same
    function (see ``tests/test_torch_fused_ce.py``), and its backward.
    No path launches these kernels: launches stay 0."""
    import torch
    from torch.nn import functional as F

    from neurst_tpu_torch.ops import fused_ce as fc

    smoothing = TRAIN["label_smoothing"]
    cases = [("main", 6000, 8192, torch.float32),
             ("main", 6000, 8192, torch.bfloat16),
             ("bench_train", 32768, 32768, torch.bfloat16),
             ("ragged_rows", 67, 512, torch.bfloat16),
             ("ragged_vocab", 9, 5120, torch.float32),
             ("odd_vocab", 37, 650, torch.bfloat16)]
    gen = torch.Generator(device="cuda").manual_seed(seed + 60)
    results = {}
    for case, rows, vocab, dtype in cases:
        name = str(dtype).replace("torch.", "")
        c, low = 1.0 - smoothing, smoothing / (vocab - 1)
        z = (2.0 * torch.randn(rows, vocab, device="cuda", generator=gen)
             ).to(dtype)
        lo = 4096 if case == "ragged_vocab" else 0
        labels = torch.randint(lo, vocab, (rows,), device="cuda",
                               generator=gen, dtype=torch.int32)
        g = torch.rand(rows, device="cuda", generator=gen)
        xent, lse = fc.fused_softmax_xent_fwd(z, labels, c, low)
        dz = fc.fused_softmax_xent_bwd(z, labels, lse, g, c, low)
        ref_xent, ref_lse = fc._softmax_fwd_plain(z, labels, c, low)
        ref_dz = fc._softmax_bwd_plain(z, labels, ref_lse, g, c, low)
        torch.cuda.synchronize()
        fwd_err = max(_rel_err(xent, ref_xent), _rel_err(lse, ref_lse))
        dz_err = (_abs_err(dz, ref_dz) if dtype == torch.float32
                  else _bf16_ulps(dz, ref_dz, SOFTMAX_XENT_TOL["float32"]))
        if not (fwd_err <= SOFTMAX_XENT_TOL["xent"]
                and dz_err <= SOFTMAX_XENT_TOL[name]):
            raise AssertionError(
                f"fused_softmax_xent {case} {name}: xent/lse relative err "
                f"{fwd_err} (tol {SOFTMAX_XENT_TOL['xent']}), dz err "
                f"{dz_err} (tol {SOFTMAX_XENT_TOL[name]})")
        leaf = z.detach().requires_grad_()

        def library():
            return F.cross_entropy(leaf.float(), labels.long(),
                                   label_smoothing=vocab * low,
                                   reduction="none")

        big = rows * vocab > 1 << 28
        library_fwd = time_ms(library, iters=3 if big else 10)
        library_bwd = time_ms(lambda: torch.autograd.grad(
            library(), leaf, g), iters=3 if big else 10) - library_fwd
        fwd_args, bwd_args = (z, labels, c, low), (z, labels, lse, g, c, low)
        for kernel, fn, args, plain, err, library_ms in (
                ("fwd", fc.fused_softmax_xent_fwd, fwd_args,
                 fc._softmax_fwd_plain, fwd_err, library_fwd),
                ("bwd", fc.fused_softmax_xent_bwd, bwd_args,
                 fc._softmax_bwd_plain, dz_err, library_bwd)):
            bound, bound_by = softmax_xent_bound_ms(z, kernel)
            row = {"phase": "kernel",
                   "kernel": f"fused_softmax_xent_{kernel}", "case": case,
                   "dtype": name, "shape": [rows, vocab],
                   "max_abs_err": (_abs_err(xent, ref_xent) if kernel == "fwd"
                                   else _abs_err(dz, ref_dz)),
                   "err": err, "err_kind": (
                       "relative" if kernel == "fwd" else
                       "abs" if dtype == torch.float32
                       else "bf16 ulps beyond 1e-6"),
                   "tol": (SOFTMAX_XENT_TOL["xent"] if kernel == "fwd"
                           else SOFTMAX_XENT_TOL[name]),
                   "kernel_ms": time_ms(lambda: fn(*args),
                                        iters=5 if big else 20),
                   "plain_ms": time_ms(lambda: plain(*args), iters=3),
                   "library_ms": library_ms,
                   "bound_ms": bound, "bound_by": bound_by}
            emit(row)
            results[(kernel, case, name)] = row
        del z, labels, g, xent, lse, dz, ref_xent, ref_lse, ref_dz, leaf
        torch.cuda.empty_cache()
    return results


def _site_key(rng, stream):
    from neurst_tpu_torch.utils.rng import DropoutKey
    return DropoutKey(int(rng.randint(2 ** 31)), int(rng.randint(2 ** 31)),
                      stream=stream)


def _keep_rate_ok(kept, keep_p, n):
    """Whether a kept share lies within 5 sigma of its binomial
    expectation."""
    return abs(kept - keep_p) <= 5 * math.sqrt(keep_p * (1 - keep_p) / n)


def dropout_kernel_phase(seed, cases=None, dtypes=None):
    """fused_dropout_apply (the mask kernel) against its plain version:
    the encoder's postprocess site [30000, 256] (rate quantized to 1/256),
    the text path's [32768, 512], a ragged [37, 200] (exact rate), a [37,
    199] whose length is not a whole number of 16-byte vectors (a scalar
    tail), and a flat view ``buf[1:]`` whose pointer is not 16-byte
    aligned (the kernel gathers its vectors); or the given ``cases``
    ((name, shape) each) in ``dtypes`` (default float32 and bf16).  Outputs and masks bitwise equal; the kept share within
    5 sigma of its expectation; mean(y) / mean(x) within 5 sigma (plus
    half a bf16 ulp) of 1.  The library call is ``F.dropout`` (its own
    generator)."""
    import torch
    from torch.nn import functional as F

    from neurst_tpu_torch.ops import fused_dropout as fd

    rng = np.random.RandomState(seed + 30)
    key = _site_key(rng, 1 << 16 | 1)
    rows = TRAIN["batch"] * TRAIN["frames"] // 4
    results = {}
    cases = cases or (("main", (rows, 256)),
                      ("nmt", (NMT_TRAIN["batch"] * NMT_TRAIN["length"],
                               512)),
                      ("ragged", (37, 200)), ("ragged_tail", (37, 199)),
                      ("unaligned", (100003,)))
    for case, shape in cases:
        threshold, scale = fd.threshold_and_scale(
            DROPOUT_RATE, fd.quantized_site(shape))
        for dtype in dtypes or (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            if case == "unaligned":
                buf = torch.from_numpy((rng.rand(shape[0] + 1) + 0.5).astype(
                    np.float32)).to("cuda", dtype)
                x = buf[1:]
                if x.data_ptr() % 16 == 0 or not x.is_contiguous():
                    raise AssertionError("dropout unaligned case: the view "
                                         "is aligned")
            else:
                x = torch.from_numpy((rng.rand(*shape) + 0.5).astype(
                    np.float32)).to("cuda", dtype)
            y = fd.fused_dropout_apply(x, key, threshold, scale)
            want = fd.dropout_reference(x, key, threshold, scale)
            torch.cuda.synchronize()
            n = x.numel()
            keep_p = 1.0 - threshold / 2.0 ** 32
            kept = float((y != 0).float().mean())
            xf = x.float()
            se = scale * math.sqrt(keep_p * (1 - keep_p)
                                   * float((xf * xf).sum())) / float(xf.sum())
            ratio = float(y.float().mean() / xf.mean())
            err = _abs_err(y, want)
            same_mask = bool(torch.equal(y != 0, want != 0))
            ulp = 2.0 ** -9 if dtype == torch.bfloat16 else 0.0
            if not (same_mask and err == 0.0
                    and _keep_rate_ok(kept, keep_p, n)
                    and abs(ratio - 1.0) <= 5 * se + ulp):
                raise AssertionError(
                    f"fused_dropout {case} {name}: masks equal {same_mask}, "
                    f"max abs err {err}, kept {kept} (expected {keep_p}), "
                    f"mean ratio {ratio}")
            bound, bound_by = bound_ms(2 * n * x.element_size(), 0, dtype)
            row = {"phase": "kernel", "kernel": "fused_dropout",
                   "case": case, "dtype": name, "shape": list(shape),
                   "offset_bytes": x.data_ptr() % 16,
                   "quantized": fd.quantized_site(shape),
                   "threshold": threshold, "scale": scale,
                   "masks_equal": same_mask, "max_abs_err": err, "tol": 0.0,
                   "kept": kept, "keep_expected": keep_p,
                   "mean_y_over_mean_x": ratio,
                   "kernel_ms": time_ms(lambda: fd.fused_dropout_apply(
                       x, key, threshold, scale)),
                   "plain_ms": time_ms(lambda: fd.dropout_reference(
                       x, key, threshold, scale), iters=5),
                   "library_ms": time_ms(lambda: F.dropout(
                       x, DROPOUT_RATE, True)),
                   "bound_ms": bound, "bound_by": bound_by}
            emit(row)
            results[(case, name)] = row
    return results


def ffn_bound_ms(x, filter_size, kernel):
    """Least time for the fused FFN forward (x, W1, W2, biases read; y
    and, in training, hd written; 4 R D F operations) or backward (x,
    W1, W2, hd, dy read; dx, dW1, dW2, db1, db2 written; 8 R D F)."""
    rows, dim = x.shape
    dtype, elem = x.dtype, x.element_size()
    weights = 2 * dim * filter_size * elem
    if kernel == "fwd":
        nbytes = (2 * rows * dim + rows * filter_size) * elem + weights \
            + 4 * (dim + filter_size)
        return bound_ms(nbytes, 4.0 * rows * dim * filter_size, dtype)
    nbytes = (3 * rows * dim + rows * filter_size) * elem + 2 * weights \
        + 4 * (dim + filter_size)
    return bound_ms(nbytes, 8.0 * rows * dim * filter_size, dtype)


def ffn_kernel_phase(seed, cases=None, dtypes=None):
    """fused_ffn_fwd and _bwd against their plain versions on the same
    inputs (the backward fed the plain forward's hd), at D 256: the
    slice's encoder rows (30,000), decoder rows (6,000; the bf16 forward
    splits the filter over two blocks a row tile), 2,000 (four, with a
    ragged last tile) and a ragged 37; at D 512: the NMT train cell's
    32,768 rows, 2,000 and 37 (or the given ``cases``, each (name, rows,
    D), in ``dtypes``, default float32 and bf16); F 2048, rate 0 and 0.1
    (a package built
    for D 256 alone, an older checkout that
    ``tools/compare_flash_kernels.py`` times, runs the D 256 cases).  The
    dropout mask is compared bitwise with b1
    = 100 (every pre-activation positive, so hd is 0 exactly where
    dropped) and its kept share checked; two backward calls must give
    the same bits.  No single PyTorch call computes the function:
    ``library_ms`` is null and ``linear -> relu -> dropout -> linear`` is
    timed beside it as a composite."""
    import torch
    from torch.nn import functional as F

    from neurst_tpu_torch.ops import fused_ffn as ff

    rng = np.random.RandomState(seed + 40)
    filter_size = 2048
    key = _site_key(rng, 1 << 16 | 4)
    cases = cases or [
        ("main", TRAIN["batch"] * TRAIN["frames"] // 4, 256),
        ("decoder", TRAIN["batch"] * TRAIN["trg_len"], 256),
        ("split", 2000, 256), ("ragged", 37, 256),
        ("d512", NMT_TRAIN["batch"] * NMT_TRAIN["length"], 512),
        ("d512_split", 2000, 512), ("d512_ragged", 37, 512)]
    results = {}
    for case, rows, dim in cases:
        if dim not in ff.DIMS:
            continue
        for rate in (0.0, DROPOUT_RATE):
            k = key if rate else None
            drop = ff._drop(rate, k)
            for dtype in dtypes or (torch.float32, torch.bfloat16):
                name = str(dtype).replace("torch.", "")

                def draw(*shape, scale=1.0, dt=dtype):
                    return torch.from_numpy((scale * rng.randn(*shape)).astype(
                        np.float32)).to("cuda", dt)
                x, dy = draw(rows, dim), draw(rows, dim)
                w1 = draw(filter_size, dim, scale=dim ** -0.5)
                w2 = draw(dim, filter_size, scale=filter_size ** -0.5)
                b1 = draw(filter_size, scale=0.1, dt=torch.float32)
                b2 = draw(dim, scale=0.1, dt=torch.float32)
                fwd_args = (x, w1, b1, w2, b2, rate, k, True)
                y, hd = ff.fused_ffn_fwd(*fwd_args)
                y_ref, hd_ref = ff._fwd_plain(x, w1, b1, w2, b2, drop, True)
                bwd_args = (x, w1, w2, hd_ref, dy, drop[1])
                grads = ff.fused_ffn_bwd(*bwd_args)
                ref_grads = ff._bwd_plain(*bwd_args)
                # no atomics: a second call gives the same bits
                repeat = all(torch.equal(a, b_) for a, b_ in zip(
                    grads, ff.fused_ffn_bwd(*bwd_args)))
                if not repeat:
                    raise AssertionError(f"fused_ffn {case} rate {rate} "
                                         f"{name}: two backward calls differ")
                mask = {}
                if rate:
                    big = torch.full_like(b1, 100.0)
                    _, hd_m = ff.fused_ffn_fwd(x, w1, big, w2, b2, rate, k,
                                               True)
                    _, hd_mr = ff._fwd_plain(x, w1, big, w2, b2, drop, True)
                    keep_p = 1.0 - drop[0] / 2.0 ** 32
                    kept = float((hd_m != 0).float().mean())
                    mask = {"masks_equal": bool(torch.equal(hd_m == 0,
                                                            hd_mr == 0)),
                            "kept": kept, "keep_expected": keep_p}
                    if not (mask["masks_equal"]
                            and _keep_rate_ok(kept, keep_p, hd_m.numel())):
                        raise AssertionError(f"fused_ffn {case} {name}: "
                                             f"dropout mask {mask}")
                torch.cuda.synchronize()
                fwd_rel = {"y": _rel_err(y, y_ref), "hd": _rel_err(hd, hd_ref)}
                bwd_rel = {g: _rel_err(a, b_) for g, a, b_ in zip(
                    ("dx", "dw1", "dw2", "db1", "db2"), grads, ref_grads)}
                fwd_tol, bwd_tol = FFN_TOL[name]
                if max(fwd_rel.values()) > fwd_tol \
                        or max(bwd_rel.values()) > bwd_tol:
                    raise AssertionError(
                        f"fused_ffn {case} rate {rate} {name}: forward "
                        f"{fwd_rel} (tol {fwd_tol}), backward {bwd_rel} "
                        f"(tol {bwd_tol})")
                leaves = [t.detach().requires_grad_()
                          for t in (x, w1, b1, w2, b2)]

                def composite():
                    h = F.relu(F.linear(leaves[0], leaves[1],
                                        leaves[2].to(dtype)))
                    h = F.dropout(h, rate, True)
                    return F.linear(h, leaves[3], leaves[4].to(dtype))

                composite_fwd = time_ms(composite, iters=10)
                composite_bwd = time_ms(lambda: torch.autograd.grad(
                    composite(), leaves, dy), iters=10) - composite_fwd
                for kernel, fn, args, plain, pargs, rel, comp in (
                        ("fwd", ff.fused_ffn_fwd, fwd_args, ff._fwd_plain,
                         (x, w1, b1, w2, b2, drop, True), fwd_rel,
                         composite_fwd),
                        ("bwd", ff.fused_ffn_bwd, bwd_args, ff._bwd_plain,
                         bwd_args, bwd_rel, composite_bwd)):
                    bound, bound_by = ffn_bound_ms(x, filter_size, kernel)
                    outs = (y, hd) if kernel == "fwd" else grads
                    refs = (y_ref, hd_ref) if kernel == "fwd" else ref_grads
                    row = dict({
                        "phase": "kernel", "kernel": f"fused_ffn_{kernel}",
                        "case": case, "dtype": name, "rate": rate,
                        "shape": [rows, dim, filter_size],
                        "max_abs_err": max(_abs_err(a, b_) for a, b_ in
                                           zip(outs, refs)),
                        "rel_err": rel,
                        "tol": fwd_tol if kernel == "fwd" else bwd_tol,
                        "kernel_ms": time_ms(lambda: fn(*args), iters=10),
                        "plain_ms": time_ms(lambda: plain(*pargs), iters=3),
                        "library_ms": None,
                        "composite_linear_relu_dropout_linear_ms": comp,
                        "bound_ms": bound, "bound_by": bound_by}, **mask)
                    if kernel == "bwd":
                        row["bitwise_repeat"] = repeat
                    emit(row)
                    results[(kernel, case, rate, name)] = row
    return results


def _identity_mask_check(fa, key):
    """The flash forward's and dk/dv kernel's dropout masks, read
    directly: with q = 0 every valid probability is 1/T, and with k, v
    and dO the identity, o[b, q, n, j] = pm[b, n, q, j] and
    dv[b, j, n, q] = pm[b, n, q, j]; both must be nonzero exactly where
    the generator keeps (b, n, q, j), in float32."""
    import torch

    from neurst_tpu_torch.ops.fused_dropout import (dropout_keep_mask,
                                                    threshold_and_scale)
    b, t, n, h = 2, 64, 4, 64
    eye = torch.eye(t, device="cuda")[None, :, None, :].expand(
        b, t, n, h).contiguous()
    q = torch.zeros_like(eye)
    lens = torch.full((b,), t, dtype=torch.int32, device="cuda")
    o, lse = fa.flash_attention_fwd(q, eye, eye, lens, False, DROPOUT_RATE,
                                    key)
    _, dv = fa.flash_attention_dkv(q, eye, eye, eye, lse, fa._delta(o, eye),
                                   lens, False, DROPOUT_RATE, key)
    keep = dropout_keep_mask((b, n, t, t), key,
                             threshold_and_scale(DROPOUT_RATE, False)[0],
                             "cuda")
    fwd_ok = bool(torch.equal(o.permute(0, 2, 1, 3) != 0, keep))
    dkv_ok = bool(torch.equal(dv.permute(0, 2, 3, 1) != 0, keep))
    if not (fwd_ok and dkv_ok):
        raise AssertionError(f"flash dropout masks: forward {fwd_ok}, "
                             f"dk/dv {dkv_ok}")
    return {"forward": fwd_ok, "dkv": dkv_ok}


def flash_dropout_kernel_phase(seed):
    """The flash kernels with attention dropout 0.1 against the plain
    versions with the same mask, at the training slice's encoder shape
    ([40, 750, 4, 64], lengths {750, 375, 1, 0, drawn}) and ragged causal
    [4, 200]; the masks read bitwise (``_identity_mask_check``).  The
    library times are ``scaled_dot_product_attention`` with
    ``dropout_p=0.1`` (its own generator), forward and backward."""
    import torch
    from torch.nn import functional as F

    from neurst_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(seed + 50)
    key = _site_key(rng, 1 << 16)
    masks = _identity_mask_check(fa, key)
    b, n, h = TRAIN["batch"], 4, 64
    t_main = TRAIN["frames"] // 4
    main_lengths = [t_main, t_main // 2, 1, 0] + list(
        rng.randint(1, t_main + 1, size=b - 4))
    cases = [("main", t_main, main_lengths, False),
             ("ragged_causal", 200, list(rng.randint(0, 201, size=4)), True)]
    results = {}
    for case, t, lengths, causal in cases:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            bb = len(lengths)
            qkv = torch.from_numpy(rng.randn(bb, t, 3, n, h).astype(
                np.float32)).to("cuda", dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            do = torch.from_numpy(rng.randn(bb, t, n, h).astype(
                np.float32)).to("cuda", dtype)
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            fwd_args = (q, k, v, lens, causal, DROPOUT_RATE, key)
            o, lse = fa.flash_attention_fwd(*fwd_args)
            o_ref, lse_ref = fa.flash_attention_reference(*fwd_args)
            delta = fa._delta(o, do)
            args = (q, k, v, do, lse, delta, lens, causal, DROPOUT_RATE, key)
            got = (fa.flash_attention_dq(*args),) + fa.flash_attention_dkv(
                *args)
            want = fa._bwd_plain(*args[:8], fa._drop_consts(DROPOUT_RATE,
                                                            key))
            torch.cuda.synchronize()
            tol, lse_tol = KERNEL_TOL[name]
            fwd_err = _abs_err(o, o_ref)
            lse_err = _abs_err(lse, lse_ref)
            rel = {g: _rel_err(x, y) for g, x, y in zip(
                ("dq", "dk", "dv"), got, want)}
            if fwd_err > tol or lse_err > lse_tol \
                    or max(rel.values()) > BWD_TOL[name]:
                raise AssertionError(
                    f"flash dropout {case} {name}: o err {fwd_err} (tol "
                    f"{tol}), lse {lse_err}, gradients {rel} (tol "
                    f"{BWD_TOL[name]})")
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            mask = _key_mask(lens, t, causal)

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, dropout_p=DROPOUT_RATE)

            library_fwd = time_ms(sdpa)
            library_bwd = time_ms(lambda: torch.autograd.grad(
                sdpa(), (qt, kt, vt), do.transpose(1, 2))) - library_fwd
            plain_bwd = time_ms(lambda: fa._bwd_plain(
                *args[:8], fa._drop_consts(DROPOUT_RATE, key)), iters=3)
            for kernel, fn, fargs, err, plain_ms, library_ms in (
                    ("fwd", fa.flash_attention_fwd, fwd_args, fwd_err,
                     time_ms(lambda: fa.flash_attention_reference(*fwd_args),
                             iters=3), library_fwd),
                    ("dq", fa.flash_attention_dq, args, rel["dq"], plain_bwd,
                     library_bwd),
                    ("dkv", fa.flash_attention_dkv, args,
                     max(rel["dk"], rel["dv"]), plain_bwd, library_bwd)):
                bound, bound_by = attention_bound_ms(q, lens, causal, kernel)
                row = {"phase": "kernel",
                       "kernel": f"flash_attention_{kernel}", "case": case,
                       "dtype": name, "shape": [bb, t, n, h],
                       "causal": causal, "dropout": DROPOUT_RATE,
                       "masks_equal": masks,
                       "max_abs_err": err,
                       "rel_err": rel if kernel != "fwd" else None,
                       "tol": tol if kernel == "fwd" else BWD_TOL[name],
                       "kernel_ms": time_ms(lambda: fn(*fargs)),
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": bound, "bound_by": bound_by}
                emit(row)
                results[(kernel, case, name)] = row
    return results


# a bucket of the recipe's TRAIN batcher with an odd encoder length: 183
# frames (T 46 after the two stride-2 convolutions), 656 utterances
# (round_up(120000 // 183, 8)), the last a length-0 padding row
BUCKET = dict(frames=183, time=46, batch=656)


def flash_bucket_kernel_phase(seed):
    """The flash forward and backward at ``BUCKET``'s shape, float32 and
    bf16, dropout 0 and 0.1, against the plain versions (the tolerances
    of the main shape); every output finite, and the length-0 row's o,
    dq, dk and dv exactly 0."""
    import torch

    from neurst_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(seed + 60)
    b, t, n, h = BUCKET["batch"], BUCKET["time"], 4, 64
    lengths = [t, 1] + list(rng.randint(1, t + 1, size=b - 3)) + [0]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    key = _site_key(rng, 1 << 16)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        qkv = torch.from_numpy(rng.randn(b, t, 3, n, h).astype(
            np.float32)).to("cuda", dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        do = torch.from_numpy(rng.randn(b, t, n, h).astype(
            np.float32)).to("cuda", dtype)
        for rate in (0.0, DROPOUT_RATE):
            drop = (rate, key) if rate else (0.0, None)
            fwd_args = (q, k, v, lens, False) + drop
            o, lse = fa.flash_attention_fwd(*fwd_args)
            o_ref, lse_ref = fa.flash_attention_reference(*fwd_args)
            delta = fa._delta(o, do)
            args = (q, k, v, do, lse, delta, lens, False) + drop
            got = (fa.flash_attention_dq(*args),) + fa.flash_attention_dkv(
                *args)
            want = fa._bwd_plain(*args[:8], fa._drop_consts(*drop))
            torch.cuda.synchronize()
            tol, lse_tol = KERNEL_TOL[name]
            valid = lens > 0
            fwd_err = _abs_err(o, o_ref)
            lse_err = _abs_err(lse[valid], lse_ref[valid])
            rel = {g: _rel_err(x, y) for g, x, y in zip(
                ("dq", "dk", "dv"), got, want)}
            finite = all(bool(torch.isfinite(x.float()).all())
                         for x in (o,) + got)
            zero_row = all(bool((x[-1] == 0).all()) for x in (o,) + got)
            row = {"phase": "kernel", "kernel": "flash_attention_bucket",
                   "case": "bucket_length0", "dtype": name,
                   "shape": [b, t, n, h], "dropout": rate,
                   "o_max_abs_err": fwd_err, "lse_max_abs_err": lse_err,
                   "tol": [tol, lse_tol, BWD_TOL[name]], "rel_err": rel,
                   "finite": finite, "length0_row_exactly_zero": zero_row,
                   "fwd_ms": time_ms(lambda: fa.flash_attention_fwd(
                       *fwd_args)),
                   "dq_ms": time_ms(lambda: fa.flash_attention_dq(*args)),
                   "dkv_ms": time_ms(lambda: fa.flash_attention_dkv(*args))}
            emit(row)
            if not (finite and zero_row and fwd_err <= tol
                    and lse_err <= lse_tol
                    and max(rel.values()) <= BWD_TOL[name]):
                raise AssertionError(f"flash at the bucket shape: {row}")
            results[(name, rate)] = row
    return results


# the wait-k recipe's largest training bucket (25,000 tokens at 128
# source positions: round_down(25000 / 128, 8) rows) and the streaming
# agent's re-encodes (a prefix padded to a multiple of 8, batch 1);
# transformer_base's 8 heads of 64
WAITK_BUCKET = dict(batch=192, time=128, heads=8, head_dim=64)
WAITK_PREFIXES = (8, 16, 32, 64, 128)


def flash_waitk_kernel_phase(seed):
    """The causal flash kernels on the wait-k paths: forward, dq and
    dk/dv at ``WAITK_BUCKET`` (per-row lengths, dropout 0.1, float32 and
    bf16) against the plain versions with the same masks, with the
    kernel, plain, library (``scaled_dot_product_attention`` with the
    causal key mask and ``dropout_p``) and bound times of the bf16 case;
    then the forward at each streaming prefix [1, T, 8, 64] (the last 3
    positions padding, no dropout) against the plain version, with its
    bf16 time.  Returns {(kernel, dtype): row} of the bucket case."""
    import torch
    from torch.nn import functional as F

    from neurst_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(seed + 70)
    key = _site_key(rng, 1 << 16)
    b, t = WAITK_BUCKET["batch"], WAITK_BUCKET["time"]
    n, h = WAITK_BUCKET["heads"], WAITK_BUCKET["head_dim"]
    lens = torch.tensor([t] + list(rng.randint(1, t + 1, size=b - 1)),
                        dtype=torch.int32, device="cuda")
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        qkv = torch.from_numpy(rng.randn(b, t, 3, n, h).astype(
            np.float32)).to("cuda", dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        do = torch.from_numpy(rng.randn(b, t, n, h).astype(
            np.float32)).to("cuda", dtype)
        fwd_args = (q, k, v, lens, True, DROPOUT_RATE, key)
        o, lse = fa.flash_attention_fwd(*fwd_args)
        o_ref, lse_ref = fa.flash_attention_reference(*fwd_args)
        delta = fa._delta(o, do)
        args = (q, k, v, do, lse, delta, lens, True, DROPOUT_RATE, key)
        got = (fa.flash_attention_dq(*args),) + fa.flash_attention_dkv(*args)
        want = fa._bwd_plain(*args[:8], fa._drop_consts(DROPOUT_RATE, key))
        torch.cuda.synchronize()
        tol, lse_tol = KERNEL_TOL[name]
        errs = {"fwd": _abs_err(o, o_ref), "lse": _abs_err(lse, lse_ref)}
        errs.update({g: _rel_err(x, y) for g, x, y in zip(
            ("dq", "dk", "dv"), got, want)})
        if errs["fwd"] > tol or errs["lse"] > lse_tol or max(
                errs[g] for g in ("dq", "dk", "dv")) > BWD_TOL[name]:
            raise AssertionError(f"flash at the wait-k bucket, {name}: "
                                 f"{errs} (tol {tol}, {lse_tol}, "
                                 f"{BWD_TOL[name]})")
        timed = name == "bfloat16"
        if timed:
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            mask = _key_mask(lens, t, True)

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, dropout_p=DROPOUT_RATE)

            library_fwd = time_ms(sdpa)
            library_bwd = time_ms(lambda: torch.autograd.grad(
                sdpa(), (qt, kt, vt), do.transpose(1, 2))) - library_fwd
            plain_fwd = time_ms(lambda: fa.flash_attention_reference(
                *fwd_args), iters=3)
            plain_bwd = time_ms(lambda: fa._bwd_plain(
                *args[:8], fa._drop_consts(DROPOUT_RATE, key)), iters=3)
        for kernel, fn, fargs, err in (
                ("fwd", fa.flash_attention_fwd, fwd_args, errs["fwd"]),
                ("dq", fa.flash_attention_dq, args, errs["dq"]),
                ("dkv", fa.flash_attention_dkv, args,
                 max(errs["dk"], errs["dv"]))):
            bound, bound_by = attention_bound_ms(q, lens, True, kernel)
            row = {"phase": "kernel", "kernel": f"flash_attention_{kernel}",
                   "case": "waitk_bucket", "dtype": name,
                   "shape": [b, t, n, h], "causal": True,
                   "dropout": DROPOUT_RATE, "max_abs_err": err,
                   "errors": errs, "kernel_ms": time_ms(lambda: fn(*fargs))
                   if timed else None,
                   "plain_ms": (plain_fwd if kernel == "fwd" else plain_bwd)
                   if timed else None,
                   "library_ms": (library_fwd if kernel == "fwd"
                                  else library_bwd) if timed else None,
                   "bound_ms": bound, "bound_by": bound_by}
            emit(row)
            results[(kernel, name)] = row
    prefixes = []
    for t in WAITK_PREFIXES:
        lens = torch.tensor([t - 3], dtype=torch.int32, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            q, k, v = (torch.from_numpy(rng.randn(1, t, n, h).astype(
                np.float32)).to("cuda", dtype) for _ in range(3))
            o, lse = fa.flash_attention_fwd(q, k, v, lens, True)
            o_ref, lse_ref = fa.flash_attention_reference(q, k, v, lens,
                                                          True)
            tol, lse_tol = KERNEL_TOL[name]
            err = _abs_err(o[:, :t - 3], o_ref[:, :t - 3])
            lse_err = _abs_err(lse[..., :t - 3], lse_ref[..., :t - 3])
            if err > tol or lse_err > lse_tol:
                raise AssertionError(f"flash at the prefix [1, {t}], "
                                     f"{name}: o {err}, lse {lse_err}")
            prefixes.append({"time": t, "dtype": name, "max_abs_err": err,
                             "kernel_ms": time_ms(
                                 lambda: fa.flash_attention_fwd(
                                     q, k, v, lens, True))
                             if name == "bfloat16" else None})
    emit({"phase": "kernel", "kernel": "flash_attention_fwd",
          "case": "waitk_prefixes", "shape": [1, "T", n, h], "causal": True,
          "valid": "T - 3", "prefixes": prefixes})
    return results


def _flat_drawers(flat, rng):
    """Functions that draw seeded arrays into ``flat``: kernels as
    fan-in-scaled normals, vectors as small normals, LayerNorm scale and
    bias around 1 and 0."""
    def kernel(name, shape, fan_in):
        flat[name] = (rng.randn(*shape) / math.sqrt(fan_in)).astype(
            np.float32)

    def vec(name, size, mean=0.0, std=0.02):
        flat[name] = (mean + std * rng.randn(size)).astype(np.float32)

    def norm(prefix, size):
        vec(f"{prefix}/scale", size, 1.0, 0.1)
        vec(f"{prefix}/bias", size, 0.0, 0.1)

    return kernel, vec, norm


def _stack_flat_params(flat, rng, p):
    """Seeded weights of the encoder and decoder stacks in the JAX
    package's flat layout (fused projections [D, n, N, H],
    output_transform [N, H, D], dense kernels [in, out])."""
    kernel, vec, norm = _flat_drawers(flat, rng)
    d = p["modality.dim"]

    def attention(prefix, n_heads, fused):
        h = d // n_heads
        projections = ([("qkv_transform", 3)] if fused
                       else [("q_transform", 1), ("kv_transform", 2)])
        for proj, n_proj in projections:
            kernel(f"{prefix}/{proj}/kernel", (d, n_proj, n_heads, h), d)
            flat[f"{prefix}/{proj}/bias"] = (0.02 * rng.randn(
                n_proj, n_heads, h)).astype(np.float32)
        kernel(f"{prefix}/output_transform/kernel", (n_heads, h, d), d)
        vec(f"{prefix}/output_transform/bias", d)

    def ffn(prefix, filter_size):
        kernel(f"{prefix}/dense1/kernel", (d, filter_size), d)
        vec(f"{prefix}/dense1/bias", filter_size)
        kernel(f"{prefix}/dense2/kernel", (filter_size, d), filter_size)
        vec(f"{prefix}/dense2/bias", d)

    for side in ("encoder", "decoder"):
        n_heads = p[f"{side}.num_attention_heads"]
        for i in range(p[f"{side}.num_layers"]):
            layer = f"{side}/layer_{i}"
            attention(f"{layer}/self_attention", n_heads, True)
            norm(f"{layer}/self_attention_ln", d)
            if side == "decoder":
                attention(f"{layer}/cross_attention", n_heads, False)
                norm(f"{layer}/cross_attention_ln", d)
            ffn(f"{layer}/ffn", p[f"{side}.filter_size"])
            norm(f"{layer}/ffn_ln", d)
        norm(f"{side}/output_ln", d)


def speech_transformer_flat_params(cfg, vocab, feature_dim, seed):
    """Seeded random weights for a SpeechTransformer in the JAX package's
    flat-name layout (flax shapes: dense kernels [in, out], fused
    projections [D, n, N, H], output_transform [N, H, D], conv kernels
    [kh, kw, in, out]).  Kernels are fan-in-scaled normals."""
    rng = np.random.RandomState(seed)
    p = cfg["model.params"]
    d, c = p["modality.dim"], p["modality.source.channels"]
    kh = p["modality.source.kernel_size"]
    stride = p["modality.source.strides"]
    flat = {}
    kernel, vec, norm = _flat_drawers(flat, rng)
    cin, freq = 1, feature_dim
    for i in (1, 2):
        kernel(f"input_audio_modality/conv{i}/kernel", (kh, kh, cin, c),
               kh * kh * cin)
        vec(f"input_audio_modality/conv{i}/bias", c)
        if p["modality.source.layer_norm"]:
            norm(f"input_audio_modality/ln{i}", c)
        cin, freq = c, (freq + 2 * (kh // 2) - kh) // stride + 1
    kernel("input_audio_modality/output_dense/kernel", (freq * c, d),
           freq * c)
    vec("input_audio_modality/output_dense/bias", d)
    _stack_flat_params(flat, rng, p)
    flat["target_symbol_modality/weights"] = (
        rng.randn(vocab, d) / math.sqrt(d)).astype(np.float32)
    vec("target_symbol_modality/bias", vocab)
    return flat


def transformer_flat_params(cfg, src_vocab, trg_vocab, seed):
    """Seeded random weights for a Transformer in the JAX package's
    flat-name layout: the stacks as for the speech model, the tied target
    table and its softmax bias, and the source table
    (``input_symbol_modality``; with a shared embedding one
    ``shared_symbol_modality`` serves both sides).  Tables are normals of
    variance 1 / D, as the JAX initializer draws them."""
    rng = np.random.RandomState(seed)
    p = cfg["model.params"]
    d = p["modality.dim"]
    flat = {}
    _stack_flat_params(flat, rng, p)
    target = ("shared_symbol_modality"
              if p.get("modality.share_source_target_embedding")
              else "target_symbol_modality")
    flat[f"{target}/weights"] = (
        rng.randn(trg_vocab, d) / math.sqrt(d)).astype(np.float32)
    flat[f"{target}/bias"] = (0.02 * rng.randn(trg_vocab)).astype(np.float32)
    if target == "target_symbol_modality":
        flat["input_symbol_modality/weights"] = (
            rng.randn(src_vocab, d) / math.sqrt(d)).astype(np.float32)
    return flat


def build_slice(seed, device="cuda", dtype="bfloat16"):
    """The slice's model (weights from ``seed`` in the JAX flat layout,
    loaded through ``param_bridge``; bf16 models store them in bf16;
    int8 where the caller turned int8 serving on), its
    beam search, and a function drawing one request of seeded random
    fbank frames."""
    import torch

    import neurst_tpu_torch
    from neurst_tpu_torch.models.speech_transformer import SpeechTransformer
    from neurst_tpu_torch.utils.param_policy import restore_inference_params

    cfg = SpeechTransformer.build_model_args_by_name(SLICE["model"])
    params = dict(cfg["model.params"], dtype=dtype)
    params["encoder.enable_flash_attention"] = True
    trg_meta = {"vocab_size": SLICE["vocab"], "eos_id": 1, "bos_id": 2,
                "unk_id": 3}
    src_meta = {"audio_feature_dim": SLICE["feature_dim"],
                "audio_feature_channels": 1}
    model = neurst_tpu_torch.build_model(
        dict(cfg, **{"model.params": params}), src_meta=src_meta,
        trg_meta=trg_meta, device=device)
    flat = speech_transformer_flat_params(cfg, SLICE["vocab"],
                                          SLICE["feature_dim"], seed)
    # under int8 serving (set by the caller) the float32 weights are
    # quantized on the way in, as every inference entry restores them
    restore_inference_params(model, flat)

    search = neurst_tpu_torch.build_search_layer({
        "search_method.class": "beam_search",
        "search_method.params": {
            "beam_size": SLICE["beam"],
            "maximum_decode_length": SLICE["max_decode"],
            "extra_decode_length": SLICE["max_decode"],
            "minimum_decode_length": SLICE["max_decode"] - 1}})
    search.set_model(model)

    rng = np.random.RandomState(seed + 1)
    b, frames = SLICE["batch"], SLICE["frames"]

    def request():
        return {"src": torch.from_numpy(rng.randn(
                    b, frames, SLICE["feature_dim"], 1).astype(np.float32)
                ).to(device),
                "src_length": torch.from_numpy(rng.randint(
                    SLICE["min_src"], frames + 1, size=b).astype(np.int32)
                ).to(device)}

    return model, search, request


def slice_phase(seed):
    import torch

    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts

    model, search, request = build_slice(seed)
    b, frames = SLICE["batch"], SLICE["frames"]
    num_layers = model.encoder.num_layers
    search(request())  # warm-up: cuBLAS/cuDNN handles and plans
    requests = [request() for _ in range(SLICE["requests"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    per_request, request_ms = [], []
    for inputs in requests:
        before = launch_counts()["flash_attention_fwd"]
        start = time.perf_counter()
        hyps, scores = search(inputs)
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - start) * 1e3)
        launches = launch_counts()["flash_attention_fwd"] - before
        per_request.append(launches)
        if tuple(hyps.shape) != (b, SLICE["max_decode"]):
            raise AssertionError(f"hypotheses {tuple(hyps.shape)}")
        if not bool(torch.isfinite(scores).all()):
            raise AssertionError("non-finite beam scores")
        if launches != num_layers:
            raise AssertionError(f"flash_attention_fwd ran {launches} "
                                 f"times in a request, expected "
                                 f"{num_layers}")
    # decode runs the flash forward only: no backward, no fused xent
    counts = {"flash_attention_fwd": launch_counts()["flash_attention_fwd"]}
    peak_bytes = torch.cuda.max_memory_allocated()
    if any(v == 0 for v in counts.values()):
        raise AssertionError(f"a kernel of the path never ran: {counts}")

    def encode_once():
        with torch.inference_mode():
            model.prepare_generation(requests[0], SLICE["max_decode"])
        torch.cuda.synchronize()

    encode_times = []
    for _ in range(5):
        start = time.perf_counter()
        encode_once()
        encode_times.append((time.perf_counter() - start) * 1e3)
    encode_ms = float(np.median(encode_times))
    total_ms = float(np.median(request_ms))
    emit({"phase": "slice", "model": SLICE["model"], "dtype": "bfloat16",
          "batch": b, "frames": frames, "beam": SLICE["beam"],
          "max_decode": SLICE["max_decode"], "requests": len(requests),
          "request_ms": request_ms, "utt_per_s": b / (total_ms / 1e3),
          "encode_ms": encode_ms, "step_loop_ms": total_ms - encode_ms,
          "launches": counts, "launches_per_request": per_request,
          "max_memory_allocated": peak_bytes,
          "hypotheses_head": hyps[0, :8].tolist()})
    return model, requests[0], counts


def _random_word(rng, low, high):
    return "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"),
                              int(rng.randint(low, high + 1))))


def write_vocab(rng, root):
    """A vocabulary of 8189 random subword units (8192 with the
    pipeline's three control tokens) and BPE codes over them, under
    ``root``; returns the text pipeline's params (BPE, no Moses)."""
    units = set()
    while len(units) < PREDICT["vocab"] - 3:
        unit = _random_word(rng, 1, 6)
        units.add(unit + "@@" if rng.rand() < 0.5 else unit)
    units = sorted(units)
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(units) + "\n")
    codes = os.path.join(root, "codes.bpe")
    with open(codes, "w") as f:
        f.write("#version: 0.2\n" + "\n".join(
            f"{u[0]} {u[1]}" for u in units if len(u) == 2) + "\n")
    return {"vocab_path": vocab, "language": "en", "subtokenizer": "bpe",
            "subtokenizer_codes": codes}


def write_predict_dir(seed, root):
    """Everything the predict CLI reads, from ``seed``, under ``root``: a
    model dir (``ckpt-1.npz`` of ``speech_transformer_flat_params`` in
    the JAX package's flat layout, written by the port's
    ``save_checkpoint``, and ``model_configs.yml`` as JSON text), a
    vocabulary of 8189 subword units (8192 with the pipeline's three
    control tokens) with BPE codes over them, ``audio_tfrecord`` files of
    fbank-like features with raw translations (the 32 utterances, and
    the 4 short ones of the card-vs-CPU check), and the recipe's
    prediction config as JSON.  The pipeline adds the Moses tokenizer
    where sacremoses imports."""
    from neurst_tpu_torch.data.recordio import RecordWriter, build_example
    from neurst_tpu_torch.data.text.moses import HAS_SACREMOSES
    from neurst_tpu_torch.models.speech_transformer import SpeechTransformer
    from neurst_tpu_torch.utils.checkpoints import save_checkpoint

    rng = np.random.RandomState(seed + 70)
    pipeline = write_vocab(rng, root)
    pipeline["tokenizer"] = "moses" if HAS_SACREMOSES else None

    cfg = SpeechTransformer.build_model_args_by_name(PREDICT["model"])
    params = dict(cfg["model.params"], dtype="bfloat16")
    params["encoder.enable_flash_attention"] = True
    model_dir = os.path.join(root, "model")
    save_checkpoint(model_dir, 1, speech_transformer_flat_params(
        cfg, PREDICT["vocab"], PREDICT["feature_dim"], seed))
    with open(os.path.join(model_dir, "model_configs.yml"), "w") as f:
        json.dump({"task.class": "SpeechToText", "task.params": {
                       "audio_feature_dim": PREDICT["feature_dim"],
                       "audio_feature_channels": 1,
                       "transcript_data_pipeline.class": "TextDataPipeline",
                       "transcript_data_pipeline.params": pipeline},
                   "model.class": "SpeechTransformer",
                   "model.params": params}, f, indent=1)

    out = {"model_dir": model_dir, "moses": HAS_SACREMOSES}
    for name, n, max_frames in (
            ("main", PREDICT["utterances"], PREDICT["max_frames"]),
            ("check", PREDICT["check_utterances"],
             PREDICT["check_max_frames"])):
        records = os.path.join(root, f"{name}.tfrecords")
        with RecordWriter(records) as w:
            for _ in range(n):
                frames = int(rng.randint(PREDICT["min_frames"],
                                         max_frames + 1))
                audio = rng.randn(frames, PREDICT["feature_dim"]).astype(
                    np.float32)
                words = [_random_word(rng, 2, 8) for _ in range(
                    rng.randint(PREDICT["min_words"],
                                PREDICT["max_words"] + 1))]
                w.write(build_example({"audio": audio.reshape(-1),
                                       "translation": " ".join(words)}))
        config = json.loads(json.dumps(PREDICT_ARGS))
        config["dataset.params"]["data_path"] = records
        config["entry.params"]["output_file"] = os.path.join(
            root, f"hypo.{name}.txt")
        out[name] = os.path.join(root, f"predict.{name}.json")
        with open(out[name], "w") as f:
            json.dump(config, f, indent=1)
    return out


def direct_hypotheses(argv, device):
    """The hypotheses of the CLI's batches from ``BeamSearch`` called
    directly on a model restored by hand, decoded by the task's pipeline
    (rows that ``sample_mask`` drops skipped)."""
    from neurst_tpu_torch.cli import run_exp
    from neurst_tpu_torch.data.datasets.dataset import build_dataset
    from neurst_tpu_torch.layers.search.beam_search import BeamSearch
    from neurst_tpu_torch.tasks.task import build_task
    from neurst_tpu_torch.utils.checkpoints import (latest_checkpoint,
                                                    restore_checkpoint_params)
    from neurst_tpu_torch.utils.compat import DataStatus, ModeKeys
    from neurst_tpu_torch.utils.param_policy import restore_inference_params

    args = run_exp.parse_and_merge(argv)
    task, ds = build_task(args), build_dataset(args)
    model = task.build_model({"model.class": args["model.class"],
                              "model.params": args["model.params"]},
                             device=device)
    restore_inference_params(model, restore_checkpoint_params(
        latest_checkpoint(args["model_dir"])))
    search = BeamSearch(PREDICT_ARGS["entry.params"]["search_method.params"])
    search.set_model(model)
    decode = task.get_data_postprocess_fn(DataStatus.PROJECTED)
    out = []
    for batch in task.create_batch_iterator(ds, ModeKeys.INFER,
                                            args["entry.params"])():
        hyps, _ = search(batch)
        for row, keep in zip(hyps.cpu().tolist(), batch["sample_mask"]):
            if keep:
                out.append(decode(row))
    return out


def predict_phase(seed):
    """The predict CLI (``neurst_tpu_torch.cli.run_exp``) in-process on
    the card, over a model dir and records written from ``seed``: 64
    samples and 64 output lines; flash forward launches = 12 a batch;
    the CLI's hypotheses equal, string for string, those of
    ``BeamSearch`` called directly on the same batches; BLEU computed
    (random weights: its value means nothing); samples/s, the wall
    split, the first batch's latency and peak memory.  Then the float32
    card-vs-CPU check: the CLI on 4 short utterances with ``--dtype
    float32`` gives the same hypotheses with ``--device cuda`` and
    ``--device cpu``.  Then spec_speech on the same dir.  Returns the
    launch counts of the CLI run and of spec_speech."""
    import torch

    from neurst_tpu_torch.cli import run_exp
    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "predict_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        start = time.perf_counter()
        paths = write_predict_dir(seed, root)
        write_s = time.perf_counter() - start
        argv = ["--config_paths", paths["main"], "--model_dir",
                paths["model_dir"]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        start = time.perf_counter()
        result = run_exp.cli_main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - start
        counts = launch_counts()
        peak_bytes = torch.cuda.max_memory_allocated()
        with open(os.path.join(root, "hypo.main.txt")) as f:
            lines = f.read().splitlines()
        batches = -(-PREDICT["utterances"] // PREDICT["batch"])
        direct = direct_hypotheses(argv, "cuda")
        check = {}
        for device in ("cuda", "cpu"):
            check[device] = run_exp.cli_main(
                ["--config_paths", paths["check"], "--model_dir",
                 paths["model_dir"], "--dtype", "float32", "--device",
                 device])["hypotheses"]
        spec_counts = spec_speech_phase(paths)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    flash = counts["flash_attention_fwd"]
    row = {"phase": "predict", "model": PREDICT["model"], "dtype": "bfloat16",
           "tokenizer": "moses + bpe" if paths["moses"]
           else "bpe (sacremoses missing: no Moses)",
           "samples": result["samples"], "output_lines": len(lines),
           "batches": batches, "batch_size": PREDICT["batch"],
           "flash_fwd_launches": flash,
           "flash_fwd_expected": 12 * batches,
           "BLEU": result["BLEU"], "UncasedBLEU": result["UncasedBLEU"],
           "samples_per_s": result["samples_per_sec"],
           "cli_wall_s": wall_s, "write_inputs_s": write_s,
           "timing_s": result["timing"],
           "max_memory_allocated": peak_bytes,
           "hypotheses_equal_direct_beam_search": result["hypotheses"]
           == direct,
           "f32_card_vs_cpu_hypotheses_equal": check["cuda"] == check["cpu"],
           "f32_check_samples": len(check["cpu"]),
           "hypothesis_head": result["hypotheses"][0][:80]}
    emit(row)
    if not (result["samples"] == len(lines) == PREDICT["utterances"]
            and flash == 12 * batches
            and row["hypotheses_equal_direct_beam_search"]
            and row["f32_card_vs_cpu_hypotheses_equal"]
            and len(check["cpu"]) == PREDICT["check_utterances"]
            and math.isfinite(result["BLEU"])):
        raise AssertionError(f"predict phase failed: {row}")
    return {"flash_attention_fwd": flash}, spec_counts


def encoder_cross_check_phase(model, inputs):
    import torch
    with torch.inference_mode():
        model.encoder.enable_flash_attention = True
        flash, padding = model.encode(inputs)
        model.encoder.enable_flash_attention = False
        plain, _ = model.encode(inputs)
        model.encoder.enable_flash_attention = True
    valid = (padding == 0)[..., None]
    diff = ((flash.float() - plain.float()).abs() * valid)
    max_err = float(diff.max())
    mean_err = float(diff.sum() / (valid.sum() * flash.shape[-1]))
    finite = bool(torch.isfinite(flash.float()).all())
    emit({"phase": "encoder_cross_check", "shape": list(flash.shape),
          "max_abs_err": max_err, "mean_abs_err": mean_err,
          "tol": list(ENCODER_TOL), "finite": finite})
    if not (finite and max_err <= ENCODER_TOL[0]
            and mean_err <= ENCODER_TOL[1]):
        raise AssertionError("flash and plain encoder outputs disagree")


def reference_check_phase(seed):
    """The whole path in float32 on the card (flash kernel included)
    against the same path on the CPU, where every kernel runs its plain
    version and which the CPU tests hold against the JAX package: a
    small request of 2 x 256 frames."""
    import torch
    outputs = {}
    for device in ("cuda", "cpu"):
        model, search, _ = build_slice(seed, device, "float32")
        rng = np.random.RandomState(seed + 2)
        inputs = {"src": torch.from_numpy(rng.randn(
                      2, 256, SLICE["feature_dim"], 1).astype(np.float32)
                  ).to(device),
                  "src_length": torch.tensor([256, 173], dtype=torch.int32,
                                             device=device)}
        with torch.inference_mode():
            enc, _ = model.encode(inputs)
        hyps, scores = search(inputs)
        outputs[device] = (enc.cpu(), hyps.cpu(), scores.cpu())
    enc_err = float((outputs["cuda"][0] - outputs["cpu"][0]).abs().max())
    same_hyps = bool(torch.equal(outputs["cuda"][1], outputs["cpu"][1]))
    score_err = float((outputs["cuda"][2] - outputs["cpu"][2]).abs().max())
    emit({"phase": "reference_check", "dtype": "float32",
          "encoder_max_abs_err": enc_err, "encoder_tol": REFERENCE_TOL[0],
          "hypotheses_equal": same_hyps, "score_max_abs_err": score_err,
          "score_tol": REFERENCE_TOL[1]})
    if not (enc_err <= REFERENCE_TOL[0] and same_hyps
            and score_err <= REFERENCE_TOL[1]):
        raise AssertionError("the card's float32 path disagrees with the "
                             "CPU path")


def build_train(seed, device="cuda", dtype="bfloat16", dropout=0.0,
                quant_params=None, remat=False, mesh=None):
    """The training slice through the entry points the JAX trainer uses:
    ``build_model`` with weights from ``seed`` in the JAX flat layout
    (through ``param_bridge``), the recipe's noam schedule and Adam,
    and, for a bf16 model, bf16 stored params with an f32 master (the
    trainer's default for a bf16 model); the label-smoothed criterion,
    ``TrainState.create`` and ``make_train_step`` (over ``mesh``, a
    data-parallel ``parallel.mesh.Mesh``, where given).  ``dropout`` is the
    rate of all six dropout sites (the recipe's is 0.1).  With
    ``quant_params`` (QAT, whose global config the caller has set) the
    clips start at the config's values and the step adds
    ``clip_l2_penalty``, as the trainer does.  ``remat`` is the
    trainer's ``gradient_remat``."""
    import neurst_tpu_torch
    from neurst_tpu_torch.layers.quantization.quant_layers import \
        clip_l2_penalty
    from neurst_tpu_torch.models.speech_transformer import SpeechTransformer
    from neurst_tpu_torch.optimizers.master_weights import (
        cast_params_bf16, with_bf16_params)
    from neurst_tpu_torch.optimizers.optimizers import create_optax_chain
    from neurst_tpu_torch.parallel import TrainState, make_train_step
    from neurst_tpu_torch.utils.param_bridge import load_flat_params

    cfg = SpeechTransformer.build_model_args_by_name(TRAIN["model"])
    params = dict(cfg["model.params"], dtype=dtype)
    params["encoder.enable_flash_attention"] = True
    for side in ("encoder", "decoder"):
        for rate in ("attention_dropout_rate", "ffn_dropout_rate",
                     "layer_postprocess_dropout_rate"):
            params[f"{side}.{rate}"] = dropout
    model = neurst_tpu_torch.build_model(
        dict(cfg, **{"model.params": params}),
        src_meta={"audio_feature_dim": TRAIN["feature_dim"],
                  "audio_feature_channels": 1},
        trg_meta={"vocab_size": TRAIN["vocab"], "eos_id": 1, "bos_id": 2,
                  "unk_id": 3}, device=device)
    flat = speech_transformer_flat_params(cfg, TRAIN["vocab"],
                                          TRAIN["feature_dim"], seed)
    if quant_params is not None:
        flat.update(_qat_clips(model, quant_params))
    load_flat_params(model, flat)
    if mesh is not None:
        from neurst_tpu_torch.parallel.sharding import apply_mesh
        apply_mesh(model, mesh)
    lr = neurst_tpu_torch.build_lr_schedule(cfg)
    tx = create_optax_chain(neurst_tpu_torch.build_optimizer(cfg), lr)
    if dtype == "bfloat16":
        cast_params_bf16(model)
        tx = with_bf16_params(tx)
    criterion = neurst_tpu_torch.build_criterion({
        "criterion.class": "label_smoothed_cross_entropy",
        "criterion.params": {"label_smoothing": TRAIN["label_smoothing"]}})
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(
        model, criterion, tx, lr_schedule=lr,
        extra_loss_fn=None if quant_params is None else clip_l2_penalty,
        remat=remat, mesh=mesh)
    return model, criterion, tx, state, step


def _qat_clips(model, quant_params):
    """The QAT clips of ``model`` (JAX flat names) at the config's initial
    values, as the JAX initializer sets them."""
    from neurst_tpu_torch.utils.param_bridge import to_jax_name
    clips = {}
    for name, _ in model.named_parameters():
        if name.endswith("kernel_clip_max"):
            value = quant_params.get("quant_weight_clip_max", 1.0)
        elif name.endswith("output_clip_max"):
            value = quant_params.get("quant_act_clip_max", 16.0)
        else:
            continue
        clips[to_jax_name(name)] = np.float32(value)
    return clips


def train_batch(rng, device, batch, frames, min_src, trg_len, min_trg):
    """A bucketed batch of seeded fbank frames and token ids: source
    lengths in [min_src, frames], target lengths in [min_trg, trg_len]
    with ``trg_padding`` marking the rest."""
    import torch
    trg_lengths = rng.randint(min_trg, trg_len + 1, size=batch)
    arrays = {
        "src": rng.randn(batch, frames, TRAIN["feature_dim"], 1).astype(
            np.float32),
        "src_length": rng.randint(min_src, frames + 1, size=batch).astype(
            np.int32),
        "trg_input": rng.randint(4, TRAIN["vocab"], size=(batch, trg_len)),
        "trg": rng.randint(4, TRAIN["vocab"], size=(batch, trg_len)),
        "trg_padding": (np.arange(trg_len)[None] >= trg_lengths[:, None]
                        ).astype(np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def _stack_ffns(stack):
    """The FFN sublayer of each layer of a transformer or LightConv
    stack, in order."""
    if hasattr(stack, "layer_0_conv"):
        return [getattr(stack, f"layer_{i}_ffn")
                for i in range(stack.num_layers)]
    return [getattr(stack, f"layer_{i}").ffn
            for i in range(stack.num_layers)]


def expected_launches(model, enc_rows, dec_rows, dropout):
    """Kernel launches of one training step, from the configuration and
    the wrappers' plans: the encoder's flash kernels once a layer; where
    the model fuses the projection into the xent, the fused xent
    forward's launches (its combine too where it splits the vocabulary)
    and its backward's; the fused FFN in each layer whose FFN the gate
    fuses (a dense FFN outside QAT and int8 serving: an MoE layer's
    experts and a QAT dense run no kernel of their own), with its
    forward's launches at the layer's row count and three backward
    launches; with dropout, the mask kernel at every
    site the kernels above do not cover (two postprocess sites an encoder
    layer, three a decoder layer, the decoder's two attention-weight
    sites, the FFN hidden where it is not fused: an MoE layer's expert
    hidden too), once forward and once
    backward.  The multi-task model's transcript decoder (``asr_decoder``)
    counts as a second decoder over ``dec_rows`` (both text sides of a
    batch are padded to one length).  A LightConv model has no flash
    attention; its convolution weights are a dropout site of every layer
    (a decoder layer's self-attention weight site)."""
    from neurst_tpu_torch.layers.common_layers import TransformerFFN
    from neurst_tpu_torch.ops.fused_ce import bwd_launches
    from neurst_tpu_torch.ops.fused_ce import \
        fwd_launches as xent_fwd_launches
    from neurst_tpu_torch.ops.fused_ffn import fwd_launches
    enc, dec = model.encoder, model.decoder
    lightconv = hasattr(enc, "layer_0_conv")
    rate = DROPOUT_RATE if dropout else 0.0
    dim = model.trg_modality.embedding_dim
    dtype = model.dtype  # the compute dtype of FFN and xent

    def fused(ffn, rows):
        return isinstance(ffn, TransformerFFN) and ffn.fuses(rows, True,
                                                             rate)

    flash = enc.num_layers if getattr(enc, "enable_flash_attention",
                                      False) else 0
    decoders = [dec]
    if getattr(model, "asr_decoder", None) is not None:
        decoders.append(model.asr_decoder)
    layers = [(ffn, enc_rows) for ffn in _stack_ffns(enc)] + [
        (ffn, dec_rows) for d in decoders for ffn in _stack_ffns(d)]
    ffn = sum(fused(f, rows) for f, rows in layers)
    ffn_fwd = sum(fwd_launches(rows, f.dense1.out_features,
                               f.dense1.in_features, dtype)
                  for f, rows in layers if fused(f, rows))
    sites = 0
    if dropout:
        # a LightConv encoder layer drops its convolution weights where a
        # transformer layer drops its attention weights (unless flash
        # does), and has no attention
        sites = enc.num_layers * (2 + (lightconv or not flash))
        sites += sum(d.num_layers for d in decoders) * 5
        sites += sum(not fused(f, rows) for f, rows in layers)
    # the train step fuses the projection into the xent only where the
    # model allows it (a vocabulary a multiple of 128, and neither QAT
    # nor int8 serving, among the JAX package's conditions); else the
    # logits path launches neither
    xent = model.supports_fused_softmax_ce()
    return {"flash_attention_fwd": flash, "flash_attention_dq": flash,
            "flash_attention_dkv": flash,
            "fused_linear_xent_fwd": xent * xent_fwd_launches(
                dec_rows, model.trg_meta["vocab_size"], dim, dtype),
            "fused_linear_xent_bwd": xent * bwd_launches(dtype),
            "fused_softmax_xent_fwd": 0, "fused_softmax_xent_bwd": 0,
            "fused_dropout": 2 * sites, "fused_ffn_fwd": ffn_fwd,
            "fused_ffn_bwd": 3 * ffn}


def _drive_train(model, criterion, tx, state, step, batches, warmup,
                 steps, key, expected, may_stay=None):
    """``warmup`` steps, then ``steps`` timed steps (launches per step of
    every kernel held to ``expected``), then the step's three parts
    timed apart on the remaining batches.  Checks finite losses and grad
    norms, that every stored parameter moved (the float32 master's, with
    bf16 params), and with ``key`` that the same (key, step) gives a
    bitwise equal loss and the next step another.  ``may_stay(name)``:
    stored parameters allowed not to move (QAT's clips, whose first
    updates at the recipe's warm-up learning rate fall below half a
    float32 rounding step of their values) if their gradient on the
    first timed batch is finite and nonzero (the row counts them).
    Returns the measurements and the launch totals."""
    import torch

    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
    from neurst_tpu_torch.optimizers.optimizers import apply_updates
    from neurst_tpu_torch.utils.rng import fold_in

    timed = batches[warmup:warmup + steps]
    has_master = isinstance(state.opt_state, dict) \
        and "master" in state.opt_state
    stored = state.opt_state["master"] if has_master else state.params
    stored0 = {n: m.detach().clone() for n, m in stored.items()}
    live0 = {n: p.detach().clone() for n, p in state.params.items()} \
        if has_master else stored0
    for batch in batches[:warmup]:
        state, _ = step(state, batch, key)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, per_step, metrics = [], [], []
    totals = dict.fromkeys(expected, 0)
    for batch in timed:
        reset_launch_counts()
        start = time.perf_counter()
        state, m = step(state, batch, key)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
        counts = launch_counts()
        per_step.append(counts)
        for name in totals:
            totals[name] += counts[name]
        metrics.append({k: float(v) for k, v in m.items()})
        if counts != expected:
            raise AssertionError(f"launches in a train step {counts}, "
                                 f"expected {expected}")
    peak_bytes = torch.cuda.max_memory_allocated()
    if not all(np.isfinite([m["loss"], m["grad_norm"]]).all()
               for m in metrics):
        raise AssertionError(f"non-finite loss or grad norm: {metrics}")
    stored = state.opt_state["master"] if has_master else state.params
    unmoved = [n for n in stored if torch.equal(stored[n], stored0[n])]
    stayed = [n for n in unmoved if may_stay is not None and may_stay(n)]
    if len(unmoved) > len(stayed):
        raise AssertionError(f"parameters that did not move: "
                             f"{sorted(set(unmoved) - set(stayed))}")
    if stayed:
        grads = step.compute_grads(state.params, timed[0], None if key is None
                                   else fold_in(key, state.step))[2]
        dead = [n for n in stayed
                if not (bool(torch.isfinite(grads[n]).all())
                        and bool((grads[n] != 0).any()))]
        if dead:
            raise AssertionError(f"parameters that did not move, with a "
                                 f"zero or non-finite gradient: {dead}")
    live_moved = sum(int((p.detach() != live0[n]).sum())
                     for n, p in state.params.items())
    determinism = None
    if key is not None:
        losses = [float(step.compute_grads(state.params, timed[0],
                                           fold_in(key, s))[0])
                  for s in (state.step, state.step, state.step + 1)]
        determinism = {"same_step": losses[:2], "next_step": losses[2]}
        if losses[0] != losses[1] or losses[0] == losses[2]:
            raise AssertionError(f"dropout losses of (step, step, step + 1): "
                                 f"{losses}")

    # the step's parts timed apart: forward (with the criterion),
    # backward, optimizer update
    params = state.params
    split = []
    for batch in batches[warmup + steps:]:
        marks = [time.perf_counter()]
        out, aux = model.call_train(
            batch, model.supports_fused_softmax_ce(),
            None if key is None else fold_in(key, state.step))
        loss = criterion.reduce_loss(batch, out) + aux
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        updates, state.opt_state = tx.update(dict(zip(params, grads)),
                                             state.opt_state, params)
        apply_updates(params, updates)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        split.append([(b_ - a) * 1e3 for a, b_ in zip(marks, marks[1:])])
    return {"steps": len(timed), "step_ms": step_ms,
            "step_ms_median": float(np.median(step_ms)),
            "split_ms": {k: float(np.median([s_[i] for s_ in split]))
                         for i, k in enumerate(("forward", "backward",
                                                "optimizer"))},
            "split_runs_ms": split, "max_memory_allocated": peak_bytes,
            "launches_per_step": per_step,
            "loss": [m["loss"] for m in metrics],
            "grad_norm": [m["grad_norm"] for m in metrics],
            "lr": [m["lr"] for m in metrics],
            "live_values_moved": live_moved,
            "stored_tensors_moved": len(stored) - len(stayed),
            "allowed_to_stay": len(stayed),
            "expected_launches_per_step": expected,
            "dropout_determinism": determinism}, totals


def train_phase(seed, dropout=False):
    """The speech training slice: warm-up steps, then timed steps on
    fresh batches (launches per step of every kernel checked against the
    configuration), then the step's three parts timed apart.  With
    ``dropout`` (the recipe's 0.1 at every site) the step takes a dropout
    key, and the same (key, step) must give a bitwise equal loss while
    the next step's masks give another."""
    from neurst_tpu_torch.utils.rng import make_key

    model, criterion, tx, state, step = build_train(
        seed, dropout=DROPOUT_RATE if dropout else 0.0)
    key = make_key(seed + 7) if dropout else None
    rng = np.random.RandomState(seed + 3)
    batches = [train_batch(rng, "cuda", TRAIN["batch"], TRAIN["frames"],
                           TRAIN["min_src"], TRAIN["trg_len"],
                           TRAIN["min_trg"])
               for _ in range(TRAIN["warmup"] + TRAIN["steps"]
                              + TRAIN["split"])]
    expected = expected_launches(
        model, TRAIN["batch"] * TRAIN["frames"] // 4,
        TRAIN["batch"] * TRAIN["trg_len"], dropout)
    out, totals = _drive_train(model, criterion, tx, state, step, batches,
                               TRAIN["warmup"], TRAIN["steps"], key,
                               expected)
    timed = batches[TRAIN["warmup"]:TRAIN["warmup"] + TRAIN["steps"]]
    median_s = out["step_ms_median"] / 1e3
    tokens = float(np.mean([float((1.0 - b["trg_padding"]).sum())
                            for b in timed]))
    frames = float(np.mean([float(b["src_length"].sum()) for b in timed]))
    row = dict({"phase": "train_dropout" if dropout else "train",
                "model": TRAIN["model"], "dtype": "bfloat16",
                "dropout": DROPOUT_RATE if dropout else 0.0,
                "bf16_params": True, "batch": TRAIN["batch"],
                "frames": TRAIN["frames"], "trg_len": TRAIN["trg_len"],
                "target_tokens_per_s": tokens / median_s,
                "frames_per_s": frames / median_s}, **out)
    emit(row)
    return totals, row


def build_nmt_train(seed, device="cuda", dtype="bfloat16", bf16_params=True,
                    dropout=DROPOUT_RATE, model_name=None, src_vocab=None,
                    trg_vocab=None, quant_params=None, mesh=None, flat=None):
    """The NMT training cell through the entry points the JAX trainer
    uses: ``build_model("transformer")`` with weights from ``seed`` in
    the JAX flat layout (through ``param_bridge``), the hparams set's
    Adam and noam schedule with bench.py's clip norm, with bf16 params
    and an f32 master where ``bf16_params`` (bench.py's
    ``with_bf16_params`` variant), the label-smoothed criterion,
    ``TrainState.create`` and ``make_train_step``.  ``dropout`` is the
    rate of all six dropout sites (the hparams set's is 0.1).
    ``quant_params``: QAT, as ``build_train`` takes it.  ``mesh`` (a
    ``parallel.mesh.Mesh``) puts the model on it and reduces the step
    over it, as the trainer does.  ``flat``: the seeded weights, drawn
    already (``transformer_flat_params`` of the same configuration)."""
    import neurst_tpu_torch
    from neurst_tpu_torch.layers.quantization.quant_layers import \
        clip_l2_penalty
    from neurst_tpu_torch.models.transformer import Transformer
    from neurst_tpu_torch.optimizers.master_weights import (
        cast_params_bf16, with_bf16_params)
    from neurst_tpu_torch.optimizers.optimizers import create_optax_chain
    from neurst_tpu_torch.parallel import TrainState, make_train_step
    from neurst_tpu_torch.utils.param_bridge import load_flat_params

    src_vocab = src_vocab or NMT_TRAIN["vocab"]
    trg_vocab = trg_vocab or NMT_TRAIN["vocab"]
    cfg = Transformer.build_model_args_by_name(
        model_name or NMT_TRAIN["model"])
    params = dict(cfg["model.params"], dtype=dtype)
    for side in ("encoder", "decoder"):
        for rate in ("attention_dropout_rate", "ffn_dropout_rate",
                     "layer_postprocess_dropout_rate"):
            params[f"{side}.{rate}"] = dropout
    cfg = dict(cfg, **{"model.params": params})

    def meta(vocab):
        return {"vocab_size": vocab, "eos_id": 1, "bos_id": 2, "unk_id": 3}

    model = neurst_tpu_torch.build_model(
        cfg, src_meta=meta(src_vocab), trg_meta=meta(trg_vocab),
        device=device)
    if flat is None:
        flat = transformer_flat_params(cfg, src_vocab, trg_vocab, seed)
    if quant_params is not None:
        flat.update(_qat_clips(model, quant_params))
    load_flat_params(model, flat)
    norm_fn = None
    if mesh is not None:
        from neurst_tpu_torch.parallel.sharding import (apply_mesh,
                                                        make_norm_fn)
        norm_fn = make_norm_fn(apply_mesh(model, mesh), mesh)
    lr = neurst_tpu_torch.build_lr_schedule(cfg)
    tx = create_optax_chain(neurst_tpu_torch.build_optimizer(cfg), lr,
                            clip_norm=NMT_TRAIN["clip_norm"],
                            norm_fn=norm_fn)
    if bf16_params:
        cast_params_bf16(model)
        tx = with_bf16_params(tx)
    criterion = neurst_tpu_torch.build_criterion({
        "criterion.class": "label_smoothed_cross_entropy",
        "criterion.params": {
            "label_smoothing": NMT_TRAIN["label_smoothing"]}})
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(
        model, criterion, tx, lr_schedule=lr,
        extra_loss_fn=None if quant_params is None else clip_l2_penalty,
        mesh=mesh, norm_fn=norm_fn)
    return model, criterion, tx, state, step


def nmt_batch(rng, device, batch, length, src_vocab, trg_vocab):
    """bench.py's train batch: seeded token ids [batch, length] on both
    sides, no padding."""
    import torch
    arrays = {
        "src": rng.randint(4, src_vocab, size=(batch, length)),
        "src_padding": np.zeros((batch, length), np.float32),
        "trg_input": rng.randint(4, trg_vocab, size=(batch, length)),
        "trg": rng.randint(4, trg_vocab, size=(batch, length)),
        "trg_padding": np.zeros((batch, length), np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def train_flops(n_src_tok, n_trg_tok, dmodel=512, layers=6, ffn=2048,
                vocab=32768, batch=256, length=128):
    """bench.py's analytic transformer_base train FLOPs
    (``bench.py:425-441`` ``_train_flops``: forward + 2x backward = 3x
    forward; the matmuls, the tied softmax and the attention scores and
    context at full length)."""
    enc_mat = layers * (4 * dmodel * dmodel + 2 * dmodel * ffn)
    dec_mat = layers * (8 * dmodel * dmodel + 2 * dmodel * ffn)
    softmax_mat = dmodel * vocab
    fwd_mat = 2 * (enc_mat * n_src_tok
                   + (dec_mat + softmax_mat) * n_trg_tok)
    att = 4 * dmodel * layers * batch * 3 * length * length
    return 3 * (fwd_mat + att)


def nmt_train_phase(seed, bf16_params):
    """The NMT train cell (``NMT_TRAIN``): transformer_base at
    [256, 128], dropout 0.1 with a dropout key, float32 stored params or
    bf16 params with an f32 master.  Target tokens/s, MFU (bench.py's
    FLOPs over the median step and the bf16 peak), the split and peak
    memory; launches per step held to the configuration (attention runs
    dense: flash is off)."""
    from neurst_tpu_torch.utils.rng import make_key

    t = NMT_TRAIN
    model, criterion, tx, state, step = build_nmt_train(
        seed, bf16_params=bf16_params)
    key = make_key(seed + 9)
    rng = np.random.RandomState(seed + 10)
    batches = [nmt_batch(rng, "cuda", t["batch"], t["length"], t["vocab"],
                         t["vocab"])
               for _ in range(t["warmup"] + t["steps"] + t["split"])]
    rows = t["batch"] * t["length"]
    expected = expected_launches(model, rows, rows, True)
    layers = model.encoder.num_layers + model.decoder.num_layers
    if expected["fused_ffn_bwd"] != 3 * layers:
        raise AssertionError(f"every FFN of the cell must run the fused "
                             f"FFN at D 512: {expected}")
    out, totals = _drive_train(model, criterion, tx, state, step, batches,
                               t["warmup"], t["steps"], key, expected)
    median_s = out["step_ms_median"] / 1e3
    flops = train_flops(rows, rows, batch=t["batch"], length=t["length"],
                        vocab=t["vocab"])
    emit(dict({"phase": "train_base_bf16" if bf16_params else "train_base",
               "model": t["model"], "dtype": "bfloat16",
               "dropout": DROPOUT_RATE, "bf16_params": bf16_params,
               "batch": t["batch"], "length": t["length"],
               "vocab": t["vocab"],
               "target_tokens_per_s": rows / median_s,
               "train_flops": flops,
               "mfu": flops / median_s / PEAK_FLOPS["bfloat16"]}, **out))
    return totals


def train_reference_check_phase(seed, dropout=False, nmt=False):
    """One float32 training step on a small batch, on the card (kernels)
    and on the CPU (plain versions, which the CPU tests hold against the
    JAX package's step): the full-width speech model on 2 x 256 frames,
    or with ``nmt`` the text model ``NMT_TRAIN["check_model"]`` on
    [2, 16] ids; with ``dropout`` at the recipe's 0.1, whose masks the
    kernels and the plain versions draw bit for bit alike."""
    import torch

    from neurst_tpu_torch.utils.rng import fold_in, make_key
    key = make_key(seed + 8) if dropout else None
    rate = DROPOUT_RATE if dropout else 0.0
    t = NMT_TRAIN
    outs = {}
    for device in ("cuda", "cpu"):
        if nmt:
            model, _, _, state, step = build_nmt_train(
                seed, device, "float32", False, rate, t["check_model"],
                t["check_src_vocab"], t["check_trg_vocab"])
            batch = nmt_batch(np.random.RandomState(seed + 4), device,
                              t["check_batch"], t["check_length"],
                              t["check_src_vocab"], t["check_trg_vocab"])
        else:
            model, _, _, state, step = build_train(seed, device, "float32",
                                                   rate)
            batch = train_batch(np.random.RandomState(seed + 4), device, 2,
                                256, 200, 16, 10)
        loss, _, grads = step.compute_grads(
            state.params, batch, None if key is None else fold_in(key, 0))
        state, metrics = step(state, batch, key)
        outs[device] = (float(loss), {n: g.cpu() for n, g in grads.items()},
                        {k: float(v) for k, v in metrics.items()},
                        {n: p.detach().cpu() for n, p in state.params.items()})
    (loss, grads, metrics, params), (ref_loss, ref_grads, ref_metrics,
                                     ref_params) = outs["cuda"], outs["cpu"]
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    norm_err = abs(metrics["grad_norm"] - ref_metrics["grad_norm"]) \
        / ref_metrics["grad_norm"]
    grad_err, worst = max(
        (float((grads[n] - ref_grads[n]).norm()
               / ref_grads[n].norm().clamp_min(1e-30)), n)
        for n in ref_grads)
    param_err = max(_abs_err(params[n], ref_params[n]) for n in ref_params)
    param_tol = 2 * ref_metrics["lr"] + 1e-6
    shape = ({"model": t["check_model"], "batch": t["check_batch"],
              "length": t["check_length"]} if nmt else
             {"model": TRAIN["model"], "batch": 2, "frames": 256,
              "trg_len": 16})
    emit({"phase": "train_reference_check", "dtype": "float32",
          "dropout": rate, **shape, "loss_rel_err": loss_err,
          "grad_norm_rel_err": norm_err, "max_grad_rel_l2_err": grad_err,
          "worst_grad": worst,
          "max_param_abs_err": param_err,
          "tol": [TRAIN_REF_TOL[0], TRAIN_REF_TOL[1], param_tol],
          "loss": loss, "grad_norm": metrics["grad_norm"]})
    if not (loss_err <= TRAIN_REF_TOL[0] and norm_err <= TRAIN_REF_TOL[0]
            and grad_err <= TRAIN_REF_TOL[1] and param_err <= param_tol):
        raise AssertionError("the card's float32 train step disagrees with "
                             "the CPU step")


# the MuST-C ST recipe (examples/speech_transformer/must-c/
# st_training_args.yml) through ``run_exp --entry train``: its task flags,
# speech_transformer_s with its dropout 0.1 and encoder flash attention,
# bf16 with bf16 stored params and an f32 master, label smoothing 0.1, the
# hparams set's Adam and noam.  Run A: 80 utterances of 2782-3000 frames
# (every batch the top bucket's 40 x <= 3000) with 100-150 target tokens,
# 12 steps (six epochs of 2 batches), a checkpoint every 6, a log every 2;
# run B resumes it to 18; run C: 96 utterances of 128-3000 frames, one
# epoch, one padded batch a non-empty bucket; run D: avg_checkpoint, the
# predict entry on the average (16 utterances), and a float32 card-vs-CPU
# trainer check (speech_transformer_toy, 2 steps, dropout 0)
TRAINER = dict(hparams_set="speech_transformer_s", utterances=80, min_frames=2782, max_frames=3000,
               min_tokens=106, max_tokens=150, steps=12, save_every=6,
               summary=2, resume_steps=18, shapes_utterances=96,
               shapes_min_frames=128, predict_utterances=16,
               check_utterances=8, check_max_frames=64, check_steps=2)
TRAINER_TASK = {"audio_feature_dim": 80, "batch_by_frames": True,
                "batch_size": 120000, "max_src_len": 3000,
                "max_trg_len": 150, "truncate_src": True,
                "min_src_bucket_boundary": 128,
                "experimental_frame_transcript_ratio": 12.0,
                "specaug": "LB"}
TRAIN_LINE = re.compile(
    r"step (\d+) \| loss (\S+) \| lr (\S+) \| grad_norm (\S+) \| \S+ "
    r"steps/s \| (\S+) secs/step \| (\S+) tokens/s")
VALIDATION_LINE = re.compile(r"validation @(\d+): (\S+)=(\S+) ")


def _words(rng, pipeline, n=3000):
    """Random words and the subword units each encodes to (EOS left
    out)."""
    words = [_random_word(rng, 2, 8) for _ in range(n)]
    return [(w, len(pipeline.encode(w)) - 1) for w in words]


def _sentence(rng, words, tokens):
    """Words whose units and EOS come to at most ``tokens`` (at least one
    word), as close as the draws allow."""
    out, total = [], 1
    for _ in range(4 * tokens):
        word, pieces = words[rng.randint(len(words))]
        if total + pieces <= tokens or not out:
            out.append(word)
            total += pieces
    return " ".join(out), total


def write_train_records(path, rng, words, frames, tokens):
    """An ``audio_tfrecord`` file of one utterance per (frames, tokens)
    pair: seeded fbank-like features and a raw translation of at most
    ``tokens`` target tokens.  Returns the token counts."""
    from neurst_tpu_torch.data.recordio import RecordWriter, build_example
    counts = []
    with RecordWriter(path) as w:
        for f, t in zip(frames, tokens):
            text, n = _sentence(rng, words, int(t))
            counts.append(n)
            audio = rng.randn(int(f), 80).astype(np.float32)
            w.write(build_example({"audio": audio.reshape(-1),
                                   "translation": text}))
    return counts


def trainer_config(path, records, pipeline, task=None, model=None,
                   **entry):
    cfg = {"task.class": "speech2text",
           "task.params": dict(TRAINER_TASK, **(task or {}),
                               **{"transcript_data_pipeline.class":
                                  "TextDataPipeline",
                                  "transcript_data_pipeline.params":
                                  pipeline}),
           "dataset.class": "audio_tfrecord",
           "dataset.params": {"data_path": records, "feature_key": "audio",
                              "transcript_key": "translation"},
           "hparams_set": TRAINER["hparams_set"],
           "model.params": dict({"encoder.enable_flash_attention": True},
                                **(model or {})),
           "entry.class": "trainer",
           "entry.params": dict({
               "criterion.class": "label_smoothed_cross_entropy",
               "criterion.params": {"label_smoothing":
                                    TRAIN["label_smoothing"]}}, **entry)}
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


def run_trainer(argv, task_cls=None, inspect=None, time_steps=False):
    """``run_exp.cli_main(argv)`` in-process with the launch counts set to
    0 before and read after, the task's (``SpeechToText`` by default)
    TRAIN iterator wrapped to time each ``next()`` and record each
    batch's shape, each train step's launches recorded with its batch's
    shape (and with ``time_steps`` its ms, the card synchronized before
    and after), ``Trainer._save`` and ``SeqGenerationValidator.validate``
    timed, each batch's text token counts (and a wait-k batch's lagging,
    and ``inspect(batch)`` where given), and the log lines kept.  Returns
    the trainer's final state and what it measured."""
    import logging

    import torch

    from neurst_tpu_torch.cli import run_exp
    from neurst_tpu_torch.exps import trainer as trainer_mod
    from neurst_tpu_torch.exps.trainer import Trainer
    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
    from neurst_tpu_torch.tasks.speech2text import SpeechToText
    from neurst_tpu_torch.training.seq_generation_validator import \
        SeqGenerationValidator
    from neurst_tpu_torch.utils.compat import ModeKeys

    def _sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    task_cls = task_cls or SpeechToText
    seen = {"wait_s": 0.0, "shapes": [], "rows": [], "save_s": [],
            "validate_s": [], "steps": [], "messages": [], "tokens": [],
            "laggings": [], "inspected": []}
    originals = {
        (task_cls, "create_batch_iterator"): task_cls.create_batch_iterator,
        (Trainer, "_save"): Trainer._save, (Trainer, "run"): Trainer.run,
        (SeqGenerationValidator, "validate"): SeqGenerationValidator.validate,
        (trainer_mod, "make_train_step"): trainer_mod.make_train_step}

    def timed_batches(self, ds, mode, *a, **kw):
        make_iter = originals[task_cls, "create_batch_iterator"](
            self, ds, mode, *a, **kw)
        if mode != ModeKeys.TRAIN:
            return make_iter

        def timed():
            it = make_iter()
            while True:
                start = time.perf_counter()
                batch = next(it, None)
                seen["wait_s"] += time.perf_counter() - start
                if batch is None:
                    return
                src = batch.get("src", batch["trg"])
                seen["shapes"].append([int(src.shape[0]),
                                       int(src.shape[1]),
                                       int(batch["trg"].shape[1])])
                seen["rows"].append(int(batch["sample_mask"].sum()))
                seen["tokens"].append({
                    k: int(batch[k].sum()) for k in ("trg_length",
                                                     "asr_trg_length")
                    if k in batch})
                if "waitk_lagging" in batch:
                    seen["laggings"].append(int(batch["waitk_lagging"]))
                if inspect is not None:
                    seen["inspected"].append(inspect(batch))
                yield batch
        return timed

    def timed(key, into):
        def call(self, *a, **kw):
            start = time.perf_counter()
            try:
                return originals[key](self, *a, **kw)
            finally:
                seen[into].append(time.perf_counter() - start)
        return call

    def timed_run(self):
        seen["model"] = self.model
        start = time.perf_counter()
        try:
            return originals[Trainer, "run"](self)
        finally:
            _sync()
            seen["run_s"] = time.perf_counter() - start

    def counted_train_step(*a, **kw):
        step = originals[trainer_mod, "make_train_step"](*a, **kw)

        def run_step(state, batch, rng=None):
            if time_steps:
                _sync()
            start = time.perf_counter()
            before = launch_counts()
            out = step(state, batch, rng)
            after = launch_counts()
            if time_steps:
                _sync()
            seen["steps"].append({
                "src": list(batch.get("src", batch["trg"]).shape),
                "trg": list(batch["trg"].shape),
                "launches": {k: after[k] - before[k] for k in after},
                "loss": out[1]["loss"],
                "ms": (time.perf_counter() - start) * 1e3})
            return out
        run_step.compute_grads = step.compute_grads
        return run_step

    class Lines(logging.Handler):
        def emit(self, record):
            seen["messages"].append(record.getMessage())

    handler = Lines(logging.INFO)
    logger = logging.getLogger()
    level = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    task_cls.create_batch_iterator = timed_batches
    Trainer._save = timed((Trainer, "_save"), "save_s")
    Trainer.run = timed_run
    SeqGenerationValidator.validate = timed(
        (SeqGenerationValidator, "validate"), "validate_s")
    trainer_mod.make_train_step = counted_train_step
    np.random.seed(0)
    reset_launch_counts()
    try:
        state = run_exp.cli_main(argv)
        _sync()
    finally:
        seen["launches"] = launch_counts()
        for (owner, name), value in originals.items():
            setattr(owner, name, value)
        logger.removeHandler(handler)
        logger.setLevel(level)
    for s in seen["steps"]:
        s["loss"] = float(s["loss"])
    seen["windows"] = [
        {"step": int(m.group(1)), "loss": float(m.group(2)),
         "lr": float(m.group(3)), "grad_norm": float(m.group(4)),
         "secs_per_step": float(m.group(5)),
         "tokens_per_s": float(m.group(6))}
        for m in (TRAIN_LINE.match(x) for x in seen["messages"]) if m]
    seen["validations"] = [
        {"step": int(m.group(1)), "metric": m.group(2),
         "value": float(m.group(3))}
        for m in (VALIDATION_LINE.match(x) for x in seen["messages"]) if m]
    return state, seen


def _train_path_checks(seen, steps, what):
    losses = [w["loss"] for w in seen["windows"]]
    norms = [w["grad_norm"] for w in seen["windows"]]
    if not (seen["windows"] and np.isfinite(losses).all()
            and np.isfinite(norms).all()):
        raise AssertionError(f"{what}: non-finite loss or grad norm "
                             f"{seen['windows']}")
    if not any(f"Training finished at step {steps}" in m
               for m in seen["messages"]):
        raise AssertionError(f"{what}: did not finish at step {steps}")


def trainer_phase(seed, train_dropout_row):
    """Runs A-D of the ``train`` entry (see ``TRAINER``) under
    ``build/train_smoke/``, removed after.  Returns the launch counts of
    run A, the recipe's training path."""
    import torch

    from neurst_tpu_torch.cli import avg_checkpoint, run_exp
    from neurst_tpu_torch.data.data_pipelines import build_data_pipeline
    from neurst_tpu_torch.optimizers.schedules.lr_schedules import \
        NoamSchedule
    from neurst_tpu_torch.tasks.speech2text import train_bucket_shapes
    from neurst_tpu_torch.utils.checkpoints import restore_checkpoint_params
    from neurst_tpu_torch.utils.param_bridge import state_dict_to_flat

    t = TRAINER
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "train_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        start = time.perf_counter()
        rng = np.random.RandomState(seed + 80)
        pipeline = write_vocab(rng, root)
        words = _words(rng, build_data_pipeline(
            {"data_pipeline.class": "TextDataPipeline",
             "data_pipeline.params": pipeline}))
        records_a = os.path.join(root, "a.tfrecords")
        tokens_a = write_train_records(
            records_a, rng, words,
            rng.randint(t["min_frames"], t["max_frames"] + 1,
                        size=t["utterances"]),
            rng.randint(t["min_tokens"], t["max_tokens"] + 1,
                        size=t["utterances"]))
        _, shapes = train_bucket_shapes(dict(TRAINER_TASK,
                                             batch_size_multiple=8))
        frames_c = rng.randint(t["shapes_min_frames"], t["max_frames"] + 1,
                               size=t["shapes_utterances"])
        bucket_c = [next(i for i, (_, b, _) in enumerate(shapes) if f <= b)
                    for f in frames_c]
        records_c = os.path.join(root, "c.tfrecords")
        write_train_records(records_c, rng, words, frames_c,
                            [rng.randint(2, shapes[i][2][0] + 1)
                             for i in bucket_c])
        steps_c = len(set(bucket_c))
        write_s = time.perf_counter() - start

        # run A: the recipe's top bucket, timed
        dir_a = os.path.join(root, "model_a")
        cfg_a = trainer_config(
            os.path.join(root, "a.json"), records_a, pipeline,
            train_steps=t["steps"], save_checkpoint_steps=t["save_every"],
            summary_steps=t["summary"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, seen_a = run_trainer(["--config_paths", cfg_a, "--model_dir",
                                 dir_a])
        peak_bytes = torch.cuda.max_memory_allocated()
        _train_path_checks(seen_a, t["steps"], "run A")
        top = shapes[-1]
        expected = expected_launches(seen_a["model"], top[0] * top[1] // 4,
                                     top[0] * top[2][-1], True)
        launches_a = {k: seen_a["launches"][k] for k in expected}
        if launches_a != {k: v * t["steps"] for k, v in expected.items()}:
            raise AssertionError(f"run A launches {launches_a}, expected "
                                 f"{t['steps']} x {expected}")
        if any(s != [top[0], top[1], top[2][-1]] for s in seen_a["shapes"]):
            raise AssertionError(f"run A batch shapes {seen_a['shapes']}")
        windows = seen_a["windows"][1:]
        step_s = float(np.median([w["secs_per_step"] for w in windows]))
        tokens_per_s = float(np.median([w["tokens_per_s"] for w in windows]))

        # run B: the optimizer state of step 12 comes back exactly, then
        # training goes on from step 13
        state, _ = run_trainer(["--config_paths", cfg_a, "--model_dir",
                                dir_a])
        saved = restore_checkpoint_params(
            os.path.join(dir_a, f"ckpt-{t['steps']}.npz"))
        master = state_dict_to_flat(seen_a["model"],
                                    state.opt_state["master"])
        restored_exact = sorted(master) == sorted(saved) and all(
            np.array_equal(master[k], saved[k]) for k in saved)
        adam_count = state.opt_state["inner"][0]["count"]
        _, seen_b = run_trainer(["--config_paths", cfg_a, "--model_dir",
                                 dir_a, "--train_steps",
                                 str(t["resume_steps"]), "--summary_steps",
                                 "1"])
        _train_path_checks(seen_b, t["resume_steps"], "run B")
        noam = NoamSchedule(dict(run_exp.get_hyper_parameters(
            t["hparams_set"])["lr_schedule.params"]), initial_step=0)
        first_lr = seen_b["windows"][0]["lr"]
        resume = {"restored_step": state.step, "adam_count": adam_count,
                  "master_equals_checkpoint": restored_exact,
                  "first_step": seen_b["windows"][0]["step"],
                  "first_lr": first_lr, "noam_13": noam(t["steps"]),
                  "losses": [w["loss"] for w in seen_b["windows"]]}
        if not (state.step == adam_count == t["steps"] and restored_exact
                and resume["first_step"] == t["steps"] + 1
                and abs(first_lr / noam(t["steps"]) - 1) < 2e-3):
            raise AssertionError(f"run B resume: {resume}")

        # run C: every bucket shape the records reach, once
        dir_c = os.path.join(root, "model_c")
        cfg_c = trainer_config(
            os.path.join(root, "c.json"), records_c, pipeline,
            train_steps=steps_c, save_checkpoint_steps=1000,
            summary_steps=1)
        _, seen_c = run_trainer(["--config_paths", cfg_c, "--model_dir",
                                 dir_c])
        _train_path_checks(seen_c, steps_c, "run C")
        first_step_s = {}
        for shape, w in zip(seen_c["shapes"], seen_c["windows"]):
            first_step_s.setdefault("x".join(map(str, shape)),
                                    w["secs_per_step"])
        padded = sum(1 for s, n in zip(seen_c["shapes"], seen_c["rows"])
                     if n < s[0])

        # run D: the average of ckpt-6 and ckpt-12, the predict entry on
        # it, and a float32 trainer step on the card against the CPU
        dir_avg = os.path.join(root, "model_avg")
        pair = [os.path.join(dir_a, f"ckpt-{s}.npz")
                for s in (t["save_every"], t["steps"])]
        avg_checkpoint.main(["--checkpoint_paths", *pair, "--model_dir",
                             dir_a, "--output_dir", dir_avg])
        avg = restore_checkpoint_params(
            os.path.join(dir_avg, f"ckpt-{t['steps']}.npz"))
        ends = [restore_checkpoint_params(p) for p in pair]
        avg_err = max(float(np.abs(avg[k] - (ends[0][k].astype(np.float64)
                                             + ends[1][k]) / 2).max())
                      for k in avg)
        records_p = os.path.join(root, "p.tfrecords")
        write_train_records(
            records_p, rng, words,
            rng.randint(PREDICT["min_frames"], PREDICT["max_frames"] + 1,
                        size=t["predict_utterances"]),
            rng.randint(10, 60, size=t["predict_utterances"]))
        predict_cfg = json.loads(json.dumps(PREDICT_ARGS))
        predict_cfg["dataset.params"]["data_path"] = records_p
        with open(os.path.join(root, "p.json"), "w") as f:
            json.dump(predict_cfg, f)
        predicted = run_exp.cli_main(["--config_paths",
                                      os.path.join(root, "p.json"),
                                      "--model_dir", dir_avg])
        check = trainer_reference_check(root, rng, words, pipeline)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row = {"phase": "trainer", "model": TRAIN["model"], "dtype": "bfloat16",
           "dropout": DROPOUT_RATE, "bf16_params": True,
           "write_inputs_s": write_s,
           "run_a": {"steps": t["steps"], "batch_shape": seen_a["shapes"][0],
                     "target_tokens_per_batch": "100-150 a row",
                     "tokens_drawn": [min(tokens_a), max(tokens_a)],
                     "step_s_median": step_s,
                     "target_tokens_per_s": tokens_per_s,
                     "windows": seen_a["windows"],
                     "run_s": seen_a["run_s"], "data_wait_s":
                     seen_a["wait_s"], "data_wait_share":
                     seen_a["wait_s"] / seen_a["run_s"],
                     "checkpoint_s": seen_a["save_s"],
                     "max_memory_allocated": peak_bytes,
                     "launches": launches_a,
                     "launches_per_step_expected": expected},
           "train_dropout_phase": {
               "step_s_median": train_dropout_row["step_ms_median"] / 1e3,
               "target_tokens_per_s":
                   train_dropout_row["target_tokens_per_s"]},
           "run_b_resume": resume,
           "run_c_shapes": {"steps": steps_c, "batches_padded": padded,
                            "first_step_s_by_shape": first_step_s,
                            "losses": [w["loss"]
                                       for w in seen_c["windows"]],
                            "grad_norms": [w["grad_norm"]
                                           for w in seen_c["windows"]],
                            "data_wait_share":
                                seen_c["wait_s"] / seen_c["run_s"]},
           "run_d": {"avg_max_abs_err": avg_err,
                     "predict_samples": predicted["samples"],
                     "predict_BLEU": predicted["BLEU"],
                     "predict_samples_per_s": predicted["samples_per_sec"],
                              "f32_card_vs_cpu": check}}
    emit(row)
    if not (avg_err <= 1e-7
            and predicted["samples"] == t["predict_utterances"]
            and math.isfinite(predicted["BLEU"])
            and len(seen_c["shapes"]) == steps_c):
        raise AssertionError(f"trainer phase failed: {row['run_d']}")
    return launches_a


def _key_bias(name, value):
    """The key part of an attention projection's bias, else None: its
    gradient is 0 up to rounding (the softmax drops a constant a query),
    so Adam moves it by up to lr a step along that noise."""
    if name.endswith("/qkv_transform/bias"):
        return value[1]
    if name.endswith("/kv_transform/bias"):
        return value[0]
    return None


def trainer_reference_check(root, rng, words, pipeline):
    """The train entry in float32 on the card and on the CPU (plain
    versions, which the CPU tests hold against the JAX trainer):
    ``speech_transformer_toy``, dropout 0, one bucket of 8 short
    utterances, noam with warmup 1 (lr 1e-3 at step 1), 2 steps; ckpt-2
    within 2 lr + 1e-6 (the key biases, which follow rounding noise,
    within 2 x the summed lr + 1e-6)."""
    t = TRAINER
    records = os.path.join(root, "check.tfrecords")
    write_train_records(records, rng, words,
                        rng.randint(20, t["check_max_frames"] + 1,
                                    size=t["check_utterances"]),
                        rng.randint(4, 9, size=t["check_utterances"]))
    rates = {f"{side}.{r}": 0.0 for side in ("encoder", "decoder")
             for r in ("attention_dropout_rate", "ffn_dropout_rate",
                       "layer_postprocess_dropout_rate")}
    cfg = trainer_config(
        os.path.join(root, "check.json"), records, pipeline,
        task={"max_src_len": t["check_max_frames"], "max_trg_len": 16,
              "min_src_bucket_boundary": t["check_max_frames"],
              "batch_size": 8 * t["check_max_frames"], "shuffle_buffer": 0},
        model=dict(rates, dtype="float32",
                   **{"encoder.enable_flash_attention": False}),
        train_steps=t["check_steps"], save_checkpoint_steps=1000,
        summary_steps=1, enable_tensorboard=False,
        **{"lr_schedule.params": {"warmup_steps": 1,
                                  "initial_factor": 0.004}})
    from neurst_tpu_torch.utils.checkpoints import restore_checkpoint_params
    out = {}
    for device in ("cuda", "cpu"):
        model_dir = os.path.join(root, f"check_{device}")
        _, seen = run_trainer(["--config_paths", cfg, "--hparams_set",
                               "speech_transformer_toy", "--model_dir",
                               model_dir, "--device", device])
        out[device] = (restore_checkpoint_params(os.path.join(
            model_dir, f"ckpt-{t['check_steps']}.npz")),
            [w["loss"] for w in seen["windows"]])
    lrs = [0.004 * 16 ** -0.5 / math.sqrt(s)
           for s in range(1, t["check_steps"] + 1)]
    tol, noise_tol = 2 * lrs[0] + 1e-6, 2 * sum(lrs) + 1e-6
    err = noise = 0.0
    for name, ref in out["cpu"][0].items():
        diff = np.abs(out["cuda"][0][name] - ref)
        key = _key_bias(name, diff)
        if key is not None:
            noise = max(noise, float(key.max()))
            diff = np.delete(diff, 1 if "qkv" in name else 0, axis=0)
        err = max(err, float(diff.max()))
    row = {"model": "speech_transformer_toy", "steps": t["check_steps"],
           "max_param_abs_err": err, "key_bias_max_abs_err": noise,
           "tol": [tol, noise_tol], "losses_card": out["cuda"][1],
           "losses_cpu": out["cpu"][1]}
    if not (err <= tol and noise <= noise_tol
            and np.allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4)):
        raise AssertionError(f"the card's float32 trainer disagrees with "
                             f"the CPU's: {row}")
    return row


# the MuST-C MT recipe (examples/speech_transformer/must-c/
# mt_training_args.yml) through ``run_exp --entry train``: the
# ``translation`` task's token buckets (32768 tokens a batch, lengths up
# to 128, pad multiple 8), transformer_base with its dropout 0.1, bf16
# with bf16 params and an f32 master, label smoothing 0.1, the hparams
# set's Adam and noam; a seeded corpus of 4000 pairs of 5-127 tokens (EOS
# included) over a 32768-word vocabulary a side, with no tokenizer (the
# card has no sacremoses).  Run A: 12 steps, a log every 2, a checkpoint
# every 6, the inline ``seq_generation_validator`` at step 12 on 64 dev
# lines with examples/translation/validation_args.yml's search; run B: 6
# steps of the same corpus from ``parallel_tfrecord`` records.  Then the
# predict entry in must-c/mt_prediction_args.yml's form (a
# MultipleDataset of dev and tst-COMMON, 128 lines each, batch 64) and
# the eval entry on the same sets; a float32 card-vs-CPU check of a
# 2-layer d 64 Transformer (2 steps, then predict); and mt_quality:
# examples/quality/mt_synth_base.yml cut to 300 steps and one validation
# on dev's first 128 lines.
NMT_TRAINER = dict(hparams_set="transformer_base", vocab=32768, pairs=4000,
                   min_tokens=5, max_tokens=127, steps=12, save_every=6,
                   summary=2, records_steps=6, dev_lines=64,
                   predict_lines=128, predict_batch=64, check_words=60,
                   check_pairs=24, check_max_tokens=12, check_steps=2,
                   check_dim=64, quality_steps=300,
                   base_quality_steps=100, quality_summary=10,
                   quality_dev_lines=128)
NMT_TASK = {"batch_by_tokens": True, "batch_size": 32768, "max_src_len": 128,
            "max_trg_len": 128, "pad_length_multiple": 8}
NMT_VALIDATION_SEARCH = {"beam_size": 4, "length_penalty": 0.6,
                         "maximum_decode_length": 160,
                         "extra_decode_length": 50}
NMT_PREDICT_SEARCH = {"beam_size": 4, "length_penalty": 0.6,
                      "maximum_decode_length": 180}
NMT_CHECK_TOL = 1e-5


def write_word_vocab(path, rng, size):
    """``size`` distinct random words, one a line (the pipeline adds its
    three control tokens); returns them."""
    words = set()
    while len(words) < size:
        words.add(_random_word(rng, 2, 9))
    words = sorted(words)
    with open(path, "w") as f:
        f.write("\n".join(words) + "\n")
    return words


def write_parallel(prefix, rng, src_words, trg_words, n, min_tokens,
                   max_tokens):
    """``prefix``.src / .trg: ``n`` pairs of random words; a source of
    ``min_tokens``-``max_tokens`` tokens with its EOS, a target within
    10% of its length.  Returns the paths."""
    src_len = rng.randint(min_tokens, max_tokens + 1, size=n)
    trg_len = np.clip(src_len + np.round(0.1 * src_len * (
        2 * rng.rand(n) - 1)).astype(int), min_tokens, max_tokens)
    paths = {}
    for side, words, lengths in (("src", src_words, src_len),
                                 ("trg", trg_words, trg_len)):
        paths[side] = f"{prefix}.{side}"
        with open(paths[side], "w") as f:
            for length in lengths:
                f.write(" ".join(words[i] for i in rng.randint(
                    len(words), size=int(length) - 1)) + "\n")
    return paths


def write_text_records(path, pipelines, paths):
    """``parallel_tfrecord`` records of the pairs' ids (EOS included)."""
    from neurst_tpu_torch.data.data_pipelines import build_data_pipeline
    from neurst_tpu_torch.data.recordio import RecordWriter, build_example
    encode = {side: build_data_pipeline({
        "data_pipeline.class": "TextDataPipeline",
        "data_pipeline.params": pipelines[side]}).encode
        for side in ("src", "trg")}
    with open(paths["src"]) as fs, open(paths["trg"]) as ft, \
            RecordWriter(path) as w:
        for src, trg in zip(fs, ft):
            w.write(build_example({
                "feature": np.asarray(encode["src"](src.strip()), np.int64),
                "label": np.asarray(encode["trg"](trg.strip()), np.int64)}))


def nmt_config(path, pipelines, dataset, **entry):
    cfg = {"task.class": "translation",
           "task.params": dict(NMT_TASK, **{
               f"{side}_data_pipeline.class": "TextDataPipeline"
               for side in ("src", "trg")}, **{
               f"{side}_data_pipeline.params": pipelines[side]
               for side in ("src", "trg")}),
           "dataset.class": dataset[0], "dataset.params": dataset[1],
           "hparams_set": NMT_TRAINER["hparams_set"], "dtype": "bfloat16",
           "entry.class": "trainer",
           "entry.params": dict({
               "criterion.class": "label_smoothed_cross_entropy",
               "criterion.params": {"label_smoothing":
                                    NMT_TRAIN["label_smoothing"]}},
               **entry)}
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


def _parallel(paths):
    return {"src_file": paths["src"], "trg_file": paths["trg"]}


def _step_launch_checks(seen, model):
    """Every step's launches of rows 1-5 and 8-10 against
    ``expected_launches`` at its batch's rows (the encoder's B x S for
    token ids, B x frames / 4 for audio; the decoder's B x T); nothing
    else launched in the run.  Returns the launches a step by batch
    shape."""
    by_shape, total = {}, {}
    for s in seen["steps"]:
        src, trg, cycle = s["src"], s["trg"], 1
        if len(trg) == 3:
            # update_cycle micro-batches [cycle, B / cycle, ...]
            cycle, src, trg = trg[0], src[1:], trg[1:]
        b, length = src[:2]
        enc_rows = b * length if len(src) == 2 else _speech_rows(src)
        expected = {k: cycle * v for k, v in expected_launches(
            model, enc_rows, b * trg[1], True).items()}
        got = {k: s["launches"][k] for k in expected}
        if got != expected:
            raise AssertionError(f"step of {s['src']} x {s['trg']}: "
                                 f"launches {got}, expected {expected}")
        by_shape["x".join(map(str, [b, length, trg[1]]))] = {
            k: v for k, v in got.items() if v}
        for k, v in s["launches"].items():
            total[k] = total.get(k, 0) + v
    if total != seen["launches"]:
        raise AssertionError(f"launches outside the train steps: "
                             f"{seen['launches']} against {total}")
    return by_shape


def _speech_rows(src_shape):
    """The encoder's rows of a [B, frames, ...] batch: B x frames after
    the two stride-2 convolutions."""
    b, frames = src_shape[0], src_shape[1]
    return b * (-(-(-(-frames // 2)) // 2))


def _trainer_numbers(seen, peak_bytes):
    windows = seen["windows"][1:] or seen["windows"]
    return {"steps": len(seen["steps"]),
            "target_tokens_per_s": float(np.median(
                [w["tokens_per_s"] for w in windows])),
            "step_s_median": float(np.median(
                [w["secs_per_step"] for w in windows])),
            "windows": seen["windows"], "run_s": seen["run_s"],
            "data_wait_s": seen["wait_s"],
            "data_wait_share": seen["wait_s"] / seen["run_s"],
            "checkpoint_s": seen["save_s"], "validate_s": seen["validate_s"],
            "validations": seen["validations"],
            "max_memory_allocated": peak_bytes,
            "batch_shapes": sorted({"x".join(map(str, x))
                                    for x in seen["shapes"]})}


def nmt_trainer_phase(seed, root, device="cuda"):
    """Runs A and B of the text train entry (``NMT_TRAINER``) under
    ``root``.  Returns (run A's launch counts, the model dir, the
    pipelines, the word lists)."""
    import torch

    from neurst_tpu_torch.tasks.translation import Translation

    t = NMT_TRAINER
    start = time.perf_counter()
    rng = np.random.RandomState(seed + 90)
    words, pipelines = {}, {}
    for side, language in (("src", "en"), ("trg", "de")):
        vocab = os.path.join(root, f"vocab.{side}")
        words[side] = write_word_vocab(vocab, rng, t["vocab"] - 3)
        pipelines[side] = {"vocab_path": vocab, "language": language}
    train = write_parallel(os.path.join(root, "train"), rng, words["src"],
                           words["trg"], t["pairs"], t["min_tokens"],
                           t["max_tokens"])
    dev = write_parallel(os.path.join(root, "dev"), rng, words["src"],
                         words["trg"], t["dev_lines"], t["min_tokens"],
                         t["max_tokens"])
    records = os.path.join(root, "train.tfrecords")
    write_text_records(records, pipelines, train)
    write_s = time.perf_counter() - start
    validator = {
        "validator.class": "SeqGenerationValidator",
        "validator.params": {
            "eval_dataset": "ParallelTextDataset",
            "eval_dataset.params": _parallel(dev), "eval_batch_size": 64,
            "eval_start_at": t["steps"], "eval_steps": t["steps"],
            "eval_search_method": "beam_search",
            "eval_search_method.params": NMT_VALIDATION_SEARCH,
            "eval_metric": "bleu", "eval_top_checkpoints_to_keep": 10,
            "eval_auto_average_checkpoints": True}}
    cfg_a = nmt_config(os.path.join(root, "a.json"), pipelines,
                       ("parallel_text", _parallel(train)),
                       train_steps=t["steps"], summary_steps=t["summary"],
                       save_checkpoint_steps=t["save_every"], **validator)
    dir_a = os.path.join(root, "model_a")
    rows = {}
    for run, cfg, model_dir in (
            ("run_a", cfg_a, dir_a),
            ("run_b_records", nmt_config(
                os.path.join(root, "b.json"), pipelines,
                ("parallel_tfrecord", {"data_path": records}),
                train_steps=t["records_steps"], summary_steps=t["summary"],
                save_checkpoint_steps=1000),
             os.path.join(root, "model_b"))):
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        _, seen = run_trainer(["--config_paths", cfg, "--model_dir",
                               model_dir, "--device", device], Translation)
        steps = t["steps"] if run == "run_a" else t["records_steps"]
        _train_path_checks(seen, steps, run)
        rows[run] = dict(_trainer_numbers(
            seen, torch.cuda.max_memory_allocated() if device == "cuda"
            else None), launches_per_step_by_shape=_step_launch_checks(
                seen, seen["model"]))
        if run == "run_a":
            launches = seen["launches"]
            if len(seen["validations"]) != 1 or not seen["validate_s"]:
                raise AssertionError(f"run A validated "
                                     f"{seen['validations']}")
    emit({"phase": "nmt_trainer", "model": t["hparams_set"],
          "dtype": "bfloat16", "bf16_params": True, "dropout": DROPOUT_RATE,
          "recipe": "examples/speech_transformer/must-c/mt_training_args.yml",
          "task": NMT_TASK, "pairs": t["pairs"],
          "tokens_a_pair": [t["min_tokens"], t["max_tokens"]],
          "write_inputs_s": write_s, **rows})
    return launches, dir_a, pipelines, words


def nmt_predict_phase(seed, root, model_dir, words, device="cuda"):
    """The predict entry on run A's dir in must-c/mt_prediction_args.yml's
    form (``NMT_PREDICT_SEARCH``, batch 64, BLEU) over a MultipleDataset
    of ``dev`` and ``tst-COMMON``, then the eval entry on the same sets.
    Returns the launch counts of the predict run (every kernel 0: the
    infer gates keep the fused FFN off and attention is dense)."""
    from neurst_tpu_torch.cli import run_exp
    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts

    t = NMT_TRAINER
    rng = np.random.RandomState(seed + 91)
    sets = {name: {"dataset.class": "ParallelTextDataset",
                   "dataset.params": _parallel(write_parallel(
                       os.path.join(root, name), rng, words["src"],
                       words["trg"], t["predict_lines"], t["min_tokens"],
                       t["max_tokens"]))}
            for name in ("dev", "tst-COMMON")}
    hypo = os.path.join(root, "hypo.txt")
    cfg = os.path.join(root, "predict.json")
    with open(cfg, "w") as f:
        json.dump({"entry.class": "predict", "entry.params": {
            "search_method.class": "beam_search",
            "search_method.params": NMT_PREDICT_SEARCH,
            "metric.class": "bleu", "output_file": hypo,
            "save_metric": hypo + ".json"},
            "batch_size": t["predict_batch"],
            "dataset.class": "MultipleDataset",
            "dataset.params": {"multiple_datasets": sets}}, f, indent=1)
    argv = ["--config_paths", cfg, "--model_dir", model_dir, "--device",
            device]
    reset_launch_counts()
    start = time.perf_counter()
    result = run_exp.cli_main(argv)
    wall_s = time.perf_counter() - start
    counts = launch_counts()
    start = time.perf_counter()
    evaluated = run_exp.cli_main(argv[:2] + ["--entry", "eval"] + argv[2:])
    eval_s = time.perf_counter() - start
    per_set = {}
    for name, res in result["datasets"].items():
        with open(f"{hypo}.{name}") as f:
            lines = f.read().splitlines()
        per_set[name] = {
            "samples": res["samples"], "output_lines": len(lines),
            "samples_per_s": res["samples_per_sec"], "timing_s":
            res["timing"], "BLEU": res["BLEU"],
            "eval": evaluated["datasets"][name]}
    row = {"phase": "nmt_predict", "model": t["hparams_set"],
           "dtype": "bfloat16",
           "recipe": "examples/speech_transformer/must-c/"
                     "mt_prediction_args.yml",
           "search": NMT_PREDICT_SEARCH, "batch_size": t["predict_batch"],
           "datasets": per_set, "weighted": result["weighted"],
           "eval_weighted": evaluated["weighted"], "predict_wall_s": wall_s,
           "eval_wall_s": eval_s, "launches": counts,
           "saved_metrics": os.path.exists(hypo + ".json")}
    emit(row)
    if not (all(r["samples"] == r["output_lines"] == t["predict_lines"]
                for r in per_set.values())
            and sorted(per_set) == ["dev", "tst-COMMON"]
            and math.isfinite(result["weighted"]["BLEU"])
            and math.isfinite(evaluated["weighted"]["NLL"])
            and row["saved_metrics"] and not any(counts.values())):
        raise AssertionError(f"nmt_predict phase failed: {row}")
    return counts


def nmt_reference_check(seed, root, devices=("cuda", "cpu")):
    """The text train and predict entries in float32 on the card and on
    the CPU (plain versions): a 2-layer d 64 Transformer, dropout 0, noam
    with warmup 1 (lr 1e-3 at step 1), 2 steps, then beam-2 predict.
    Losses within ``NMT_CHECK_TOL`` relative, ckpt-2 within 2 lr + 1e-6
    (the key biases within 2 x the summed lr + 1e-6), hypotheses equal
    (the decoded strings stop at the first EOS)."""
    from neurst_tpu_torch.cli import run_exp
    from neurst_tpu_torch.tasks.translation import Translation
    from neurst_tpu_torch.utils.checkpoints import restore_checkpoint_params

    t = NMT_TRAINER
    rng = np.random.RandomState(seed + 92)
    vocab = os.path.join(root, "check_vocab.txt")
    words = write_word_vocab(vocab, rng, t["check_words"])
    pair = write_parallel(os.path.join(root, "check"), rng, words, words,
                          t["check_pairs"], 3, t["check_max_tokens"])
    pipelines = {"src": {"vocab_path": vocab}, "trg": {"vocab_path": vocab}}
    d = t["check_dim"]
    model = {"modality.share_source_target_embedding": True,
             "modality.share_embedding_and_softmax_weights": True,
             "modality.dim": d, "modality.timing": "sinusoids"}
    for side in ("encoder", "decoder"):
        model.update({f"{side}.num_layers": 2, f"{side}.hidden_size": d,
                      f"{side}.num_attention_heads": 4,
                      f"{side}.filter_size": 4 * d})
    cfg = nmt_config(os.path.join(root, "check.json"), pipelines,
                     ("parallel_text", _parallel(pair)),
                     train_steps=t["check_steps"],
                     save_checkpoint_steps=1000, summary_steps=1,
                     enable_tensorboard=False, **{
                         "optimizer.class": "adam",
                         "optimizer.params": {"epsilon": 1e-9,
                                              "beta_1": 0.9,
                                              "beta_2": 0.98},
                         "lr_schedule.class": "noam",
                         "lr_schedule.params": {"dmodel": d,
                                                "warmup_steps": 1,
                                                "initial_factor": 0.008}})
    with open(cfg) as f:
        config = json.load(f)
    config.pop("hparams_set")
    config["task.params"].update(batch_size=256, max_src_len=16,
                                 max_trg_len=16, shuffle_buffer=0)
    config.update({"dtype": "float32", "model.class": "transformer",
                   "model.params": model})
    with open(cfg, "w") as f:
        json.dump(config, f)
    predict = os.path.join(root, "check_predict.json")
    with open(predict, "w") as f:
        json.dump({"entry.class": "predict", "batch_size": 8,
                   "entry.params": {"search_method.class": "beam_search",
                                    "search_method.params": {
                                        "beam_size": 2,
                                        "maximum_decode_length": 16}},
                   "dataset.class": "parallel_text",
                   "dataset.params": {"src_file": pair["src"]}}, f)
    out = []
    for i, device in enumerate(devices):
        model_dir = os.path.join(root, f"check_{i}_{device}")
        _, seen = run_trainer(["--config_paths", cfg, "--model_dir",
                               model_dir, "--device", device], Translation)
        hyps = run_exp.cli_main(["--config_paths", predict, "--model_dir",
                                 model_dir, "--device", device])
        out.append((restore_checkpoint_params(os.path.join(
            model_dir, f"ckpt-{t['check_steps']}.npz")),
            [s["loss"] for s in seen["steps"]], hyps["hypotheses"]))
    card, cpu = out
    lrs = [0.008 * d ** -0.5 / math.sqrt(s)
           for s in range(1, t["check_steps"] + 1)]
    tol, noise_tol = 2 * lrs[0] + 1e-6, 2 * sum(lrs) + 1e-6
    err = noise = 0.0
    for name, ref in cpu[0].items():
        diff = np.abs(card[0][name] - ref)
        key = _key_bias(name, diff)
        if key is not None:
            noise = max(noise, float(key.max()))
            diff = np.delete(diff, 1 if "qkv" in name else 0, axis=0)
        err = max(err, float(diff.max()))
    losses = (card[1], cpu[1])
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    row = {"phase": "nmt_reference_check", "dtype": "float32",
           "layers": 2, "dim": d, "steps": t["check_steps"],
           "max_param_abs_err": err, "key_bias_max_abs_err": noise,
           "param_tol": [tol, noise_tol], "loss_rel_err": loss_err,
           "loss_tol": NMT_CHECK_TOL, "losses_card": losses[0],
           "losses_cpu": losses[1],
           "hypotheses_equal": card[2] == cpu[2],
           "hypotheses": len(cpu[2]), "distinct_hypotheses": len(set(cpu[2]))}
    emit(row)
    if not (err <= tol and noise <= noise_tol
            and len(losses[0]) == len(losses[1]) == t["check_steps"]
            and loss_err <= NMT_CHECK_TOL and row["hypotheses_equal"]
            and row["hypotheses"] == t["check_pairs"]):
        raise AssertionError(f"the card's float32 text entries disagree "
                             f"with the CPU's: {row}")


def mt_quality_phase(root, device="cuda", recipe=None, hparams_set=None,
                     name="quality", overlay=None, steps=None):
    """examples/quality/mt_synth_base.yml (transformer_base, or
    ``hparams_set``, bf16 with an f32 master, update_cycle 2, on the
    committed reversal corpus) cut to ``quality_steps`` steps, a log every
    ``quality_summary`` and one validation at the end on dev's first
    ``quality_dev_lines`` lines, into ``<root>/<name>``: the mean loss
    must fall from quarter to quarter (QUALITY_r05's
    ``loss_monotone_by_quarter``); prints the BLEU.  Returns the row, with
    the model dir, the dev files and what ``run_trainer`` saw.
    ``overlay``: a recipe overlay whose top-level keys are merged in
    (``mt_synth_qat.yml``'s ``enable_quant`` and ``quant_params``);
    ``steps`` in place of ``quality_steps``."""
    import yaml

    from neurst_tpu_torch.tasks.translation import Translation

    t = NMT_TRAINER
    here = os.path.dirname(os.path.abspath(__file__))
    recipe = recipe or os.path.join(here, "examples", "quality",
                                    "mt_synth_base.yml")
    with open(recipe) as f:
        cfg = json.loads(json.dumps(yaml.safe_load(f)).replace(
            '"examples/quality/', f'"{here}/examples/quality/'))
    if overlay:
        with open(overlay) as f:
            cfg.update(yaml.safe_load(f))
    dev = {}
    for side in ("src", "trg"):
        dev[side] = os.path.join(root, f"quality_dev.{side}")
        with open(cfg["entry.params"]["validator.params"][
                "eval_dataset.params"][f"{side}_file"]) as f:
            lines = f.read().splitlines()[:t["quality_dev_lines"]]
        with open(dev[side], "w") as f:
            f.write("\n".join(lines) + "\n")
    steps = steps or t["quality_steps"]
    if hparams_set:
        cfg["hparams_set"] = hparams_set
    cfg["entry.class"] = "trainer"
    cfg["entry.params"].update(
        train_steps=steps, summary_steps=t["quality_summary"],
        save_checkpoint_steps=steps, enable_tensorboard=False)
    cfg["entry.params"]["validator.params"].update(
        {"eval_steps": steps, "eval_start_at": steps,
         "eval_dataset.params": _parallel(dev)})
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    model_dir = os.path.join(root, name)
    _, seen = run_trainer(["--config_paths", path, "--model_dir",
                           model_dir, "--device", device], Translation)
    _train_path_checks(seen, steps, "mt_quality")
    losses = [w["loss"] for w in seen["windows"]]
    q = len(losses) // 4
    quarters = [float(np.mean(losses[i * q:(i + 1) * q])) for i in range(4)]
    row = {"phase": "mt_quality" if overlay is None else name,
           "recipe": os.path.relpath(recipe, here),
           "overlay": overlay and os.path.relpath(overlay, here),
           "hparams_set": cfg.get("hparams_set"),
           "steps": steps,
           "dev_lines": t["quality_dev_lines"],
           "loss_trajectory": [[w["step"], w["loss"]]
                               for w in seen["windows"]],
           "loss_quarters": quarters,
           "loss_monotone_by_quarter": all(
               a > b for a, b in zip(quarters, quarters[1:])),
           "step_s_median": float(np.median(
               [w["secs_per_step"] for w in seen["windows"][1:]])),
           "validations": seen["validations"],
           "validate_s": seen["validate_s"], "run_s": seen["run_s"]}
    emit(row)
    if not (row["loss_monotone_by_quarter"] and len(seen["validations"]) == 1
            and math.isfinite(seen["validations"][0]["value"])):
        raise AssertionError(f"mt_quality phase failed: {row}")
    return dict(row, model_dir=model_dir, dev=dev, seen=seen)


def nmt_phases(seed, device="cuda"):
    """The text path's phases under ``build/nmt_smoke/``, removed after.
    Returns the launch counts of the trainer's run A, of predict and of
    spec_text."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "nmt_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        trainer_counts, model_dir, _, words = nmt_trainer_phase(seed, root,
                                                                device)
        predict_counts = nmt_predict_phase(seed, root, model_dir, words,
                                           device)
        if device == "cuda":
            nmt_reference_check(seed, root)
        quality = mt_quality_phase(
            root, device, steps=NMT_TRAINER["base_quality_steps"])
        spec_counts = spec_text_phase(seed, root, quality["model_dir"],
                                      quality["dev"], device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return trainer_counts, predict_counts, spec_counts


# Stages 02-03 of the MuST-C ST recipe
# (examples/speech_transformer/must-c/02-audio_feature_extraction.sh and
# 03-preprocess.sh) through the port's CLIs on a seeded MuST-C-shaped
# corpus: 16 talks of 60 s of 16 kHz int16 audio cut into segments of
# 1-10 s for train, 32 dev and 64 tst-COMMON segments, sentences of 5-40
# words from a lexicon of 2000 words a side; fbank with nfilt 80; train
# records from 1 and from 2 processors over 8 shards; joint BPE of 8000
# symbols; the triple records' text projected by TranscriptDataPipeline
# without Moses (the card has no sacremoses).  Then the ST recipe's train
# entry (st_training_args.yml's task flags) for 6 steps on the triple
# records and its predict entry (st_prediction_args.yml's form) on
# tst-COMMON.  Also a LibriSpeech-shaped tarball of 32 FLAC files of 1-4
# s through create_records, and device_logfbank on 64 train segments
# against their records' host features.
AUDIO_PREP = dict(rate=16000, train_talks=10, talk_s=60.0, min_seg_s=1.0,
                  max_seg_s=10.0, dev_segments=32, test_segments=64,
                  lexicon=2000, min_words=5, max_words=40, flac_files=32,
                  flac_min_s=1.0, flac_max_s=4.0, flac_block=4096, nfilt=80,
                  processors=2, shards=8, device_segments=64,
                  bpe_symbols=8000, train_steps=6, summary_steps=2,
                  hparams_set="speech_transformer_s", trg_lang="de")
# the bound the JAX package holds its device_logfbank to against the host
# features (tests/data/test_device_fbank.py)
FBANK_TOL = 2e-3


def _wav_bytes(pcm, rate):
    import io
    import wave
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.astype("<i2").tobytes())
    return buf.getvalue()


def _talk_pcm(rng, n, rate):
    """Speech-like int16 PCM: smoothed noise under a slow envelope."""
    noise = np.convolve(rng.randn(n + 7), np.ones(8) / 8.0, mode="valid")
    env = 0.2 + np.abs(np.sin(np.arange(n) * (2 * np.pi * 0.7 / rate)))
    return np.clip(noise * env * 12000.0, -32768, 32767).astype(np.int16)


def _pack_bits(values, widths):
    """The big-endian bit string of each value in its width, one after
    another, zero-padded to whole bytes."""
    values = np.asarray(values, np.int64)
    widths = np.asarray(widths, np.int64)
    total = int(widths.sum())
    starts = np.repeat(np.cumsum(widths) - widths, widths)
    shift = np.repeat(widths, widths) - 1 - (np.arange(total) - starts)
    bits = (np.repeat(values, widths) >> shift) & 1
    return np.packbits(bits.astype(np.uint8)).tobytes()


def flac_encode(pcm, rate=16000, block=4096):
    """Mono 16-bit FLAC of ``pcm`` (int16): STREAMINFO, then frames of
    ``block`` samples, VERBATIM and FIXED order 2 in turn (one Rice
    partition, its parameter from the mean residual; VERBATIM where the
    residuals would not fit); the CRC fields are 0 (the decoder does not
    read them)."""
    pcm = np.asarray(pcm, np.int64)
    info = _pack_bits([1, 0, 34, 16, block, 0, 0, rate, 0, 15, len(pcm), 0,
                       0], [1, 7, 24, 16, 16, 24, 24, 20, 3, 5, 36, 64, 64])
    out = [b"fLaC", info]
    for n, start in enumerate(range(0, len(pcm), block)):
        x = pcm[start:start + block]
        # sync, reserved, fixed blocking, 16-bit block size follows, rate
        # and channels from STREAMINFO, 16 bits, frame number, block size
        # - 1, CRC-8
        vals = [0x3FFE, 0, 0, 7, 0, 0, 4, 0, 0, len(x) - 1, 0]
        wids = [14, 1, 1, 4, 4, 4, 3, 1, 8, 16, 8]
        fixed = None
        if n % 2 and len(x) > 2:
            r = x[2:] - 2 * x[1:-1] + x[:-2]
            u = np.where(r >= 0, 2 * r, -2 * r - 1)
            k = int(min(max(np.log2(u.mean() + 1.0), 0), 14))
            q = u >> k
            if q.max() + 1 + k <= 62:
                fixed = (k, q, u & ((1 << k) - 1))
        if fixed is None:
            vals += [0, 1, 0] + list(x & 0xFFFF)
            wids += [1, 6, 1] + [16] * len(x)
        else:
            k, q, rem = fixed
            body_v = np.stack([np.ones_like(q), rem], 1).reshape(-1)
            body_w = np.stack([q + 1, np.full_like(q, k)], 1).reshape(-1)
            vals += [0, 0x08 | 2, 0, x[0] & 0xFFFF, x[1] & 0xFFFF, 0, 0, k]
            wids += [1, 6, 1, 16, 16, 2, 4, 4]
            vals, wids = np.concatenate([vals, body_v]), \
                np.concatenate([wids, body_w])
        out.append(_pack_bits(vals, wids) + b"\0\0")
    return b"".join(out)


def _tar_add(tar, name, data):
    import io
    import tarfile
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def _cut_talk(rng, seconds, lo, hi, limit):
    """(offset, duration) segments of 1/100 s resolution, in order, with
    gaps of up to 0.5 s, inside a talk of ``seconds``."""
    segs, t = [], 0.0
    while len(segs) < limit:
        offset = round(t + rng.uniform(0.0, 0.5), 2)
        duration = round(rng.uniform(lo, hi), 2)
        if offset + duration > seconds:
            break
        segs.append((offset, duration))
        t = offset + duration
    return segs


def write_mustc_corpus(root, rng, cfg=AUDIO_PREP):
    """``MUSTC_v1.0_en-<lang>.tar.gz`` under ``root`` in MuST-C's layout
    (``en-<lang>/data/<split>/wav/*.wav``, ``txt/<split>.yaml``,
    ``.en``, ``.<lang>``).  Returns its path and, by split, the segments:
    talk, offset, duration, samples (as the reader cuts them),
    transcript and translation."""
    import tarfile
    import yaml
    rate, lang = cfg["rate"], cfg["trg_lang"]
    lexicon = {side: sorted({_random_word(rng, 2, 9) for _ in range(
        2 * cfg["lexicon"])})[:cfg["lexicon"]] for side in ("en", lang)}

    def sentence(side):
        n = rng.randint(cfg["min_words"], cfg["max_words"] + 1)
        return " ".join(lexicon[side][i] for i in rng.randint(
            len(lexicon[side]), size=n))

    path = os.path.join(root, f"MUSTC_v1.0_en-{lang}.tar.gz")
    splits = {}
    with tarfile.open(path, "w:gz") as tar:
        for split, talks, target in (
                ("train", cfg["train_talks"], None),
                ("dev", None, cfg["dev_segments"]),
                ("tst-COMMON", None, cfg["test_segments"])):
            segs, t = [], 0
            while (t < talks) if talks else (len(segs) < target):
                name = f"ted_{split}_{t}.wav"
                n = int(cfg["talk_s"] * rate)
                _tar_add(tar, f"en-{lang}/data/{split}/wav/{name}",
                         _wav_bytes(_talk_pcm(rng, n, rate), rate))
                limit = target - len(segs) if target else 10 ** 9
                for offset, duration in _cut_talk(
                        rng, cfg["talk_s"], cfg["min_seg_s"],
                        cfg["max_seg_s"], limit):
                    segs.append({"wav": name, "offset": offset,
                                 "duration": duration,
                                 "samples": int(duration * rate),
                                 "transcript": sentence("en"),
                                 "translation": sentence(lang)})
                t += 1
            meta = [{"duration": s["duration"], "offset": s["offset"],
                     "speaker_id": "spk", "wav": s["wav"]} for s in segs]
            txt = f"en-{lang}/data/{split}/txt/{split}"
            _tar_add(tar, txt + ".yaml", yaml.safe_dump(meta).encode())
            _tar_add(tar, txt + ".en", "".join(
                s["transcript"] + "\n" for s in segs).encode())
            _tar_add(tar, f"{txt}.{lang}", "".join(
                s["translation"] + "\n" for s in segs).encode())
            splits[split] = segs
    return path, splits


def write_librispeech_flac(root, rng, cfg=AUDIO_PREP):
    """A LibriSpeech-shaped tarball of ``flac_files`` utterances
    (``<spk>-<chapter>-<utt>.flac`` and ``<spk>-<chapter>.trans.txt``)
    from ``flac_encode``.  Returns its path and {utterance id: (flac
    bytes, pcm)}."""
    import tarfile
    rate = cfg["rate"]
    path = os.path.join(root, "train-clean-100.tar.gz")
    utts = {}
    with tarfile.open(path, "w:gz") as tar:
        for chapter in range(-(-cfg["flac_files"] // 4)):
            spk, chap = 100 + chapter // 2, 2000 + chapter
            lines = []
            for u in range(min(4, cfg["flac_files"] - 4 * chapter)):
                utt = f"{spk}-{chap}-{u:04d}"
                pcm = _talk_pcm(rng, int(rng.uniform(
                    cfg["flac_min_s"], cfg["flac_max_s"]) * rate), rate)
                data = flac_encode(pcm, rate, cfg["flac_block"])
                _tar_add(tar, f"LibriSpeech/train-clean-100/{spk}/{chap}/"
                         f"{utt}.flac", data)
                utts[utt] = (data, pcm)
                lines.append(utt + " " + " ".join(
                    _random_word(rng, 2, 8).upper() for _ in range(6)))
            _tar_add(tar, f"LibriSpeech/train-clean-100/{spk}/{chap}/"
                     f"{spk}-{chap}.trans.txt",
                     ("\n".join(lines) + "\n").encode())
    return path, utts


def run_clis(calls):
    """Runs ``python -m neurst_tpu_torch.cli.<module> <args>`` for each
    (module, args) of ``calls`` at once, from the repository root, and
    waits for all; raises with the tail of its output where one exits
    non-zero.  Returns the wall seconds."""
    here = os.path.dirname(os.path.abspath(__file__))
    start = time.perf_counter()
    procs = [(module, subprocess.Popen(
        [sys.executable, "-m", f"neurst_tpu_torch.cli.{module}", *args],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)) for module, args in calls]
    failed = []
    for module, proc in procs:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{module} exited {proc.returncode}:\n"
                          f"{output[-3000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - start


def _shard_calls(args, template, processors, shards):
    """create_records calls of the recipe's form: ``processors``
    processes, each over its range of the ``shards`` shards."""
    per = shards // processors
    return [("create_records", [
        "--processor_id", str(p), "--num_processors", str(processors),
        "--num_output_shards", str(shards),
        "--output_range_begin", str(per * p),
        "--output_range_end", str(per * p + per), *args,
        "--output_template", template]) for p in range(processors)]


def _records(path):
    from neurst_tpu_torch.data.recordio import (glob_record_files,
                                                parse_example,
                                                record_iterator)
    files = glob_record_files(path)
    return [parse_example(r) for f in files for r in record_iterator(
        f, check_crc=True)], sum(os.path.getsize(f) for f in files)


def _raw_records(path):
    from neurst_tpu_torch.data.recordio import (glob_record_files,
                                                record_iterator)
    return sorted(r for f in glob_record_files(path)
                  for r in record_iterator(f))


def prep_records_phase(root, seed, cfg=AUDIO_PREP):
    """Stage 02: the corpus, transcripts of the three splits, fbank
    records of train (1 processor, then 2, over 8 shards; the same
    records either way), dev and tst-COMMON (one shard each) and the
    FLAC tarball.  Checks the record counts, each record's frames against
    ``num_frames`` of its samples, and each FLAC file's decoded PCM
    bitwise."""
    from neurst_tpu_torch.data.audio.flac_io import decode_flac
    from neurst_tpu_torch.ops.device_fbank import num_frames

    rng = np.random.RandomState(seed + 90)
    start = time.perf_counter()
    tarball, splits = write_mustc_corpus(root, rng, cfg)
    flac_tarball, utts = write_librispeech_flac(root, rng, cfg)
    write_s = time.perf_counter() - start
    lang, rate = cfg["trg_lang"], cfg["rate"]
    ts = os.path.join(root, "transcripts")
    os.makedirs(ts)
    common = ["--trg_lang", lang, "--input_tarball", tarball]
    fbank = ["--feature_extractor.class", "fbank",
             "--feature_extractor.params",
             json.dumps({"nfilt": cfg["nfilt"]})]
    extract_s = run_clis([("extract_audio_transcripts", [
        "--dataset", "MuSTC", "--extraction", split, *common,
        "--output_transcript_file", f"{ts}/{split}.en.txt",
        "--output_translation_file", f"{ts}/{split}.{lang}.txt"])
        for split in splits])
    train_args = ["--dataset", "MuSTC", "--extraction", "train", *common,
                  *fbank]
    template = "train.tfrecords-%5.5d-of-%5.5d"
    wall = {}
    for procs in (1, cfg["processors"]):
        out = os.path.join(root, f"train_p{procs}")
        wall[procs] = run_clis(_shard_calls(
            train_args, os.path.join(out, template), procs, cfg["shards"]))
    devtest_s = run_clis([
        ("create_records", ["--processor_id", "0", "--num_processors", "1",
                            "--num_output_shards", "1",
                            "--output_range_begin", "0",
                            "--output_range_end", "1", "--dataset", "MuSTC",
                            "--extraction", split, *common, *fbank,
                            "--output_template", os.path.join(
                                root, "devtest", f"{split}.en-{lang}."
                                "tfrecords-%5.5d-of-%5.5d")])
        for split in ("dev", "tst-COMMON")] + [
        ("create_records", ["--dataset", "LibriSpeech", "--input_tarball",
                            flac_tarball, *fbank, "--output_template",
                            os.path.join(root, "librispeech", template)])])

    train_dir = os.path.join(root, f"train_p{cfg['processors']}")
    same_records = _raw_records(train_dir) == _raw_records(
        os.path.join(root, "train_p1"))
    counts, frames_ok, megabytes = {}, True, {}
    for split, path in (("train", train_dir),
                        ("dev", os.path.join(root, "devtest",
                                             f"dev.en-{lang}.*")),
                        ("tst-COMMON", os.path.join(
                            root, "devtest", f"tst-COMMON.en-{lang}.*"))):
        examples, nbytes = _records(path)
        counts[split] = [len(examples), len(splits[split])]
        megabytes[split] = nbytes / 1e6
        by_text = {s["transcript"]: s for s in splits[split]}
        for ex in examples:
            seg = by_text[ex["transcript"][0].decode()]
            frames = num_frames(seg["samples"], rate)
            frames_ok &= (int(ex["audio_length"][0]) == frames
                          and len(ex["audio"]) == frames * cfg["nfilt"]
                          and ex["translation"][0].decode()
                          == seg["translation"])
    libri, nbytes = _records(os.path.join(root, "librispeech"))
    megabytes["librispeech"] = nbytes / 1e6
    counts["librispeech"] = [len(libri), len(utts)]
    libri_frames = sorted(int(ex["audio_length"][0]) for ex in libri)
    frames_ok &= libri_frames == sorted(num_frames(len(pcm), rate)
                                        for _, pcm in utts.values())
    decoded = [(decode_flac(data), pcm) for data, pcm in utts.values()]
    flac_bitwise = all(np.array_equal(wave, pcm.astype(np.float32))
                       and got_rate == rate
                       for (wave, got_rate), pcm in decoded)
    with open(os.path.join(ts, "train.en.txt")) as f:
        transcripts_ok = f.read().splitlines() == [
            s["transcript"] for s in splits["train"]]
    audio_s = sum(s["samples"] for s in splits["train"]) / rate
    row = {"phase": "prep_records", "write_corpus_s": write_s,
           "corpus_mb": os.path.getsize(tarball) / 1e6,
           "train_segments": len(splits["train"]), "train_audio_s": audio_s,
           "extract_transcripts_s": extract_s,
           "create_records_s": {f"{p}_processors": s
                                for p, s in wall.items()},
           "audio_s_per_wall_s": {f"{p}_processors": audio_s / s
                                  for p, s in wall.items()},
           "devtest_librispeech_s": devtest_s, "records": counts,
           "records_mb": megabytes, "frames_equal_num_frames": frames_ok,
           "same_records_1_and_2_processors": same_records,
           "transcripts_equal": transcripts_ok,
           "flac_files": len(utts), "flac_pcm_bitwise": flac_bitwise}
    emit(row)
    if not (frames_ok and same_records and transcripts_ok and flac_bitwise
            and all(a == b for a, b in counts.values())):
        raise AssertionError(f"prep_records phase failed: {row}")
    return tarball, splits, train_dir


def device_fbank_phase(root, tarball, train_dir, device="cuda",
                       cfg=AUDIO_PREP):
    """``device_logfbank`` on the first ``device_segments`` train segments
    read again from the tarball (waveforms, no extractor), batched with
    their lengths, against the records' host features: max abs error
    below ``FBANK_TOL`` on every channel with a filter, the empty ones 0
    (the host's constant over each utterance), frame lengths equal,
    padding exactly 0; its device ms against the host extractor's ms on
    the same segments."""
    import torch

    from neurst_tpu_torch.data.audio.log_mel_fbank import (LogMelFbank,
                                                           get_filterbanks)
    from neurst_tpu_torch.data.datasets.dataset import build_dataset
    from neurst_tpu_torch.ops.device_fbank import device_logfbank

    ds = build_dataset({"dataset.class": "MuSTC", "dataset.params": {
        "input_tarball": tarball, "extraction": "train",
        "trg_lang": cfg["trg_lang"]}})
    clips = []
    for ex in ds.build_iterator()():
        clips.append(ex)
        if len(clips) == cfg["device_segments"]:
            break
    host = {ex["transcript"][0].decode(): ex for ex in _records(train_dir)[0]}
    lens = [len(c["audio"]) for c in clips]
    batch = np.zeros([len(clips), max(lens)], np.float32)
    for i, c in enumerate(clips):
        batch[i, :lens[i]] = c["audio"]
    x = torch.as_tensor(batch, device=device)
    lengths = torch.as_tensor(lens, device=device)
    feat, fl = device_logfbank(x, lengths, cfg["rate"], nfilt=cfg["nfilt"])
    feat, fl = feat.cpu().numpy(), fl.cpu().numpy()
    # a mel band no FFT bin falls in (channel 2 at nfilt 80) is log(eps)
    # in every frame: the host's CMVN turns it into its float64 mean's
    # rounding error over the 1e-10 floor, one value an utterance, where
    # the device gives 0; the bound holds on the other channels
    empty = np.nonzero(get_filterbanks(cfg["nfilt"], 512, cfg["rate"]).sum(
        axis=1) == 0)[0]
    full = np.setdiff1d(np.arange(cfg["nfilt"]), empty)
    err, err_all, empty_host = 0.0, 0.0, 0.0
    lengths_equal, padding_zero, empty_ok = True, True, True
    for i, c in enumerate(clips):
        ref = host[c["transcript"]]
        frames = int(ref["audio_length"][0])
        ref = np.asarray(ref["audio"]).reshape(frames, cfg["nfilt"])
        got = feat[i, :frames]
        lengths_equal &= int(fl[i]) == frames
        err = max(err, float(np.abs(got[:, full] - ref[:, full]).max()))
        err_all = max(err_all, float(np.abs(got - ref).max()))
        empty_host = max(empty_host, float(np.abs(ref[:, empty]).max(
            initial=0.0)))
        empty_ok &= bool((got[:, empty] == 0).all()
                         and (ref[:, empty] == ref[:1, empty]).all())
        padding_zero &= bool((feat[i, frames:] == 0).all())
    fe = LogMelFbank({"nfilt": cfg["nfilt"]})
    start = time.perf_counter()
    for c in clips:
        fe(c["audio"], cfg["rate"])
    host_ms = (time.perf_counter() - start) * 1e3
    row = {"phase": "device_fbank", "device": device,
           "batch": list(batch.shape), "frames": list(feat.shape[1:]),
           "max_abs_err": err, "tolerance": FBANK_TOL,
           "max_abs_err_all_channels": err_all,
           "empty_channels": empty.tolist(),
           "empty_channels_host_max_abs": empty_host,
           "empty_channels_device_0_host_constant": empty_ok,
           "frame_lengths_equal": lengths_equal,
           "padding_exactly_zero": padding_zero,
           "host_logfbank_ms": host_ms,
           "device_ms": time_ms(lambda: device_logfbank(
               x, lengths, cfg["rate"], nfilt=cfg["nfilt"]), iters=10)
           if device == "cuda" else None}
    emit(row)
    if not (err < FBANK_TOL and lengths_equal and padding_zero
            and empty_ok):
        raise AssertionError(f"device_fbank phase failed: {row}")


def prep_project_phase(root, cfg=AUDIO_PREP):
    """Stage 03: joint BPE over the train transcripts, the BPE text, and
    the triple records whose two text sides ``MultiTaskSpeechTranslation``
    projects.  Returns the codes and vocabulary paths."""
    lang = cfg["trg_lang"]
    ts = os.path.join(root, "transcripts")
    codes = os.path.join(ts, "codes.bpe")
    vocab = {side: os.path.join(ts, f"vocab.{side}") for side in ("en", lang)}
    bpe_s = run_clis([("learn_bpe", [
        "--input", f"{ts}/train.en.txt", f"{ts}/train.{lang}.txt",
        "--symbols", str(cfg["bpe_symbols"]), "--output", codes,
        "--write_vocabulary", vocab["en"], vocab[lang]])])
    with open(codes) as f:
        merges = sum(1 for line in f if not line.startswith("#version"))
    text_s = run_clis([("process_text", [
        "--tokenizer", "bpe", "--subtokenizer_codes", codes, "--input",
        f"{ts}/train.{side}.txt", "--output", f"{ts}/train.{side}.bpe.txt"])
        for side in ("en", lang)])

    def pipeline(side, clean):
        return {"remove_punctuation": clean, "lowercase": clean,
                "language": side, "subtokenizer": "bpe",
                "subtokenizer_codes": codes, "vocab_path": vocab[side]}
    task = {"transcript_data_pipeline.class": "TranscriptDataPipeline",
            "transcript_data_pipeline.params": pipeline("en", True),
            "translation_data_pipeline.class": "TranscriptDataPipeline",
            "translation_data_pipeline.params": pipeline(lang, False)}
    out = os.path.join(root, "asr_st", "train")
    records_s = run_clis(_shard_calls(
        ["--dataset", "AudioTripleTFRecordDataset", "--feature_key", "audio",
         "--transcript_key", "transcript", "--translation_key",
         "translation", "--data_path", os.path.join(
             root, f"train_p{cfg['processors']}"),
         "--task", "MultiTaskSpeechTranslation", "--task.params",
         json.dumps(task)],
        os.path.join(out, "train.tfrecords-%5.5d-of-%5.5d"),
        cfg["processors"], cfg["shards"]))
    examples, nbytes = _records(out)
    projected = all(np.asarray(ex[k]).dtype.kind == "i" and len(ex[k]) > 1
                    for ex in examples for k in ("transcript", "translation"))
    vocab_size = {}
    for side, p in vocab.items():
        with open(p) as f:
            vocab_size[side] = sum(1 for _ in f)
    row = {"phase": "prep_project", "bpe_symbols": cfg["bpe_symbols"],
           "merges_learned": merges, "vocab_size": vocab_size,
           "learn_bpe_s": bpe_s, "process_text_s": text_s,
           "create_records_s": records_s, "records": len(examples),
           "records_mb": nbytes / 1e6, "ids_projected": projected}
    emit(row)
    if not (projected and examples and merges > 0
            and min(vocab_size.values()) > 0):
        raise AssertionError(f"prep_project phase failed: {row}")
    return codes, vocab[lang], out


def prep_train_phase(root, codes, vocab, records, device="cuda",
                     cfg=AUDIO_PREP):
    """The ST recipe's train entry on the triple records for
    ``train_steps`` steps, a checkpoint at the last; each step's launches
    against ``expected_launches`` at its batch.  Returns the model dir
    and the run's launch counts."""
    import torch

    pipeline = {"remove_punctuation": False, "lowercase": False,
                "language": cfg["trg_lang"], "subtokenizer": "bpe",
                "subtokenizer_codes": codes, "vocab_path": vocab}
    model_dir = os.path.join(root, "model")
    path = trainer_config(
        os.path.join(root, "st_train.json"), records, pipeline,
        train_steps=cfg["train_steps"],
        save_checkpoint_steps=cfg["train_steps"],
        summary_steps=cfg["summary_steps"])
    with open(path) as f:
        config = json.load(f)
    config["task.params"]["transcript_data_pipeline.class"] = \
        "TranscriptDataPipeline"
    config["hparams_set"] = cfg["hparams_set"]
    with open(path, "w") as f:
        json.dump(config, f, indent=1)
    argv = ["--config_paths", path, "--model_dir", model_dir]
    if device == "cpu":
        argv += ["--device", "cpu"]
    else:
        torch.cuda.reset_peak_memory_stats()
    _, seen = run_trainer(argv)
    _train_path_checks(seen, cfg["train_steps"], "prep_train")
    on_card = device == "cuda"
    row = dict({"phase": "prep_train", "model": cfg["hparams_set"],
                "dtype": "bfloat16", "launches_by_batch_shape":
                _step_launch_checks(seen, seen["model"]) if on_card else {},
                "launches": seen["launches"]},
               **_trainer_numbers(seen, torch.cuda.max_memory_allocated()
                                  if on_card else None))
    emit(row)
    if not os.path.exists(os.path.join(
            model_dir, f"ckpt-{cfg['train_steps']}.npz")):
        raise AssertionError(f"prep_train wrote no checkpoint: {row}")
    return model_dir, seen["launches"]


def prep_predict_phase(root, model_dir, device="cuda", cfg=AUDIO_PREP):
    """The predict entry in st_prediction_args.yml's form on the
    tst-COMMON records with the train phase's dir.  Returns the launch
    counts."""
    from neurst_tpu_torch.cli import run_exp
    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts

    config = json.loads(json.dumps(PREDICT_ARGS))
    config["dataset.params"]["data_path"] = os.path.join(
        root, "devtest", f"tst-COMMON.en-{cfg['trg_lang']}.*")
    config["entry.params"]["output_file"] = os.path.join(root, "hypo.txt")
    path = os.path.join(root, "st_predict.json")
    with open(path, "w") as f:
        json.dump(config, f, indent=1)
    argv = ["--config_paths", path, "--model_dir", model_dir]
    if device == "cpu":
        argv += ["--device", "cpu"]
    reset_launch_counts()
    start = time.perf_counter()
    result = run_exp.cli_main(argv)
    wall_s = time.perf_counter() - start
    counts = launch_counts()
    with open(os.path.join(root, "hypo.txt")) as f:
        lines = f.read().splitlines()
    batches = -(-cfg["test_segments"] // PREDICT_ARGS["batch_size"])
    expected = 12 * batches if device == "cuda" else 0
    row = {"phase": "prep_predict", "samples": result["samples"],
           "output_lines": len(lines), "BLEU": result["BLEU"],
           "samples_per_s": result["samples_per_sec"], "cli_wall_s": wall_s,
           "timing_s": result["timing"],
           "flash_fwd_launches": counts["flash_attention_fwd"],
           "flash_fwd_expected": expected}
    emit(row)
    if not (result["samples"] == len(lines) == cfg["test_segments"]
            and math.isfinite(result["BLEU"])
            and counts["flash_attention_fwd"] == expected):
        raise AssertionError(f"prep_predict phase failed: {row}")
    return counts


def audio_prep_phases(seed, device="cuda", cfg=AUDIO_PREP, after_cpu=None):
    """The speech recipes' data preparation and what it feeds, under
    ``build/audio_prep_smoke/`` (removed after): ``prep_records`` and
    ``prep_project`` (host work alone: the CLIs on the CPU), then
    ``after_cpu()`` if given (where ``main`` joins the QAT worker that ran
    beside them), then ``device_fbank``, ``prep_train`` and
    ``prep_predict``, with each stage's wall seconds.  Returns the launch
    counts of the train and the predict runs."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "audio_prep_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    stages = {}
    try:
        start = time.perf_counter()
        tarball, _, train_dir = prep_records_phase(root, seed, cfg)
        stages["prep_records"] = time.perf_counter() - start
        start = time.perf_counter()
        codes, vocab, records = prep_project_phase(root, cfg)
        stages["prep_project"] = time.perf_counter() - start
        if after_cpu is not None:
            start = time.perf_counter()
            after_cpu()
            stages["after_cpu"] = time.perf_counter() - start
        start = time.perf_counter()
        device_fbank_phase(root, tarball, train_dir, device, cfg)
        stages["device_fbank"] = time.perf_counter() - start
        start = time.perf_counter()
        model_dir, train_counts = prep_train_phase(root, codes, vocab,
                                                   records, device, cfg)
        stages["prep_train"] = time.perf_counter() - start
        start = time.perf_counter()
        predict_counts = prep_predict_phase(root, model_dir, device, cfg)
        stages["prep_predict"] = time.perf_counter() - start
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "audio_prep", "stage_wall_s": stages,
          "total_s": sum(stages.values())})
    return train_counts, predict_counts


# the joint ASR + ST recipe (examples/multi_task_st/example_configs/
# multitask_st.yml) through ``run_exp --entry train``: its task flags
# (120,000-frame budget, max_trg_len 120, frame/transcript ratio 13.0,
# SpecAugment LB) and joint criterion (ST 1.0, ASR 0.3, label smoothing
# 0.1); speech_transformer_s with encoder flash attention, dropout 0.1,
# bf16 with an f32 master, Adam and noam; 80 seeded triples of 2782-3000
# frames whose transcripts and translations have 90-120 units, over two
# seeded BPE vocabularies of 8192 (the ST recipe's size); 12 steps, a
# checkpoint every 6; the bare step at the top bucket beside the train
# phases'.  Then --entry predict on both heads (32 triples of 300-3000
# frames and 10-60 units, batch 16, beam 4, lp -1, max 150), the
# ensemble of ckpt-12 (A) and ckpt-6 (B) and of A with itself, the ASR ->
# MT cascade from 6 steps of must-c/asr_training_args.yml's and
# mt_training_args.yml's flags on the same audio and texts, and a
# float32 card-vs-CPU check at toy width (2 steps, then an ASR-head
# decode).
MULTITASK = dict(hparams_set="speech_transformer_s", triples=80,
                 min_frames=2782, max_frames=3000, min_tokens=90,
                 max_tokens=120, steps=12, save_every=6, summary=2,
                 bare_warmup=2, bare_steps=5, bare_split=2,
                 predict_triples=16, predict_min_frames=300,
                 predict_max_frames=3000, predict_min_tokens=10,
                 predict_max_tokens=60, cascade_steps=6, check_triples=8,
                 check_max_frames=64, check_steps=2, check_max_decode=16)
MULTITASK_TASK = {"audio_feature_dim": 80, "batch_size": 120000,
                  "max_src_len": 3000, "max_trg_len": 120,
                  "experimental_frame_transcript_ratio": 13.0,
                  "specaug": "LB"}
JOINT_CRITERION = {
    "criterion.class": "joint_criterion",
    "criterion.params": {"criterions": (
        "[{class: label_smoothed_cross_entropy, params: "
        "{label_smoothing: 0.1}, output_key: st, weight: 1.0}, "
        "{class: label_smoothed_cross_entropy, params: "
        "{label_smoothing: 0.1}, output_key: asr, input_prefix: asr, "
        "weight: 0.3}]")}}
TRIPLE_DATASET = {"feature_key": "audio", "transcript_key": "transcript",
                  "translation_key": "translation"}
ASR_HEAD = ["--task.params", json.dumps({"generation_output": "asr"}),
            "--metric.class", "wer"]
ST_HEAD = ["--metric.class", "bleu"]


def write_triple_records(path, rng, words, frames, low, high):
    """An ``audio_triple_tfrecord`` file of one utterance a frame count:
    seeded fbank-like features, a raw transcript over ``words["en"]`` and
    a raw translation over ``words["de"]``, each of ``low``-``high``
    subword units (EOS included) as the draws allow.  Returns the
    (transcript, translation) texts."""
    from neurst_tpu_torch.data.recordio import RecordWriter, build_example
    texts = []
    with RecordWriter(path) as w:
        for f in frames:
            pair = tuple(_sentence(rng, words[side], int(rng.randint(
                low, high + 1)))[0] for side in ("en", "de"))
            texts.append(pair)
            audio = rng.randn(int(f), 80).astype(np.float32)
            w.write(build_example({"audio": audio.reshape(-1),
                                   "transcript": pair[0],
                                   "translation": pair[1]}))
    return texts


def multitask_config(path, records, pipelines, task=None, model=None,
                     **entry):
    cfg = {"task.class": "multi_task_speech_translation",
           "task.params": dict(MULTITASK_TASK, **(task or {}), **{
               "transcript_data_pipeline.class": "TextDataPipeline",
               "transcript_data_pipeline.params": pipelines["en"],
               "translation_data_pipeline.class": "TextDataPipeline",
               "translation_data_pipeline.params": pipelines["de"]}),
           "dataset.class": "audio_triple_tfrecord",
           "dataset.params": dict(TRIPLE_DATASET, data_path=records),
           "model.class": "multi_task_speech_transformer",
           "hparams_set": MULTITASK["hparams_set"],
           "model.params": dict({"encoder.enable_flash_attention": True},
                                **(model or {})),
           "entry.class": "trainer",
           "entry.params": dict(JOINT_CRITERION, **entry)}
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


def multitask_batch(rng, device, batch, frames, trg_len):
    """A top-bucket batch of the joint model: seeded frames, and target
    ids and padding for both heads (90 to ``trg_len`` units a row)."""
    import torch
    arrays = {"src": rng.randn(batch, frames, TRAIN["feature_dim"], 1
                               ).astype(np.float32),
              "src_length": rng.randint(TRAIN["min_src"], frames + 1,
                                        size=batch).astype(np.int32)}
    for prefix in ("", "asr_"):
        lengths = rng.randint(MULTITASK["min_tokens"], trg_len + 1,
                              size=batch)
        for key in ("trg_input", "trg"):
            arrays[prefix + key] = rng.randint(4, TRAIN["vocab"],
                                               size=(batch, trg_len))
        arrays[prefix + "trg_padding"] = (
            np.arange(trg_len)[None] >= lengths[:, None]).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def build_multitask_train(seed, device="cuda"):
    """The joint model's training step as the recipe builds it:
    ``speech_transformer_s`` as ``multi_task_speech_transformer`` with
    encoder flash attention and its dropout 0.1, random weights from
    ``seed``, bf16 params with an f32 master, the hparams set's Adam and
    noam, the joint criterion, ``TrainState.create`` and
    ``make_train_step``."""
    import torch

    import neurst_tpu_torch
    from neurst_tpu_torch.models.speech_transformer import SpeechTransformer
    from neurst_tpu_torch.optimizers.master_weights import (
        cast_params_bf16, with_bf16_params)
    from neurst_tpu_torch.optimizers.optimizers import create_optax_chain
    from neurst_tpu_torch.parallel import TrainState, make_train_step

    cfg = SpeechTransformer.build_model_args_by_name(
        MULTITASK["hparams_set"])
    cfg = dict(cfg, **{"model.class": "multi_task_speech_transformer",
                       "model.params": dict(
                           cfg["model.params"],
                           **{"encoder.enable_flash_attention": True})})
    meta = {"vocab_size": TRAIN["vocab"], "eos_id": 1, "bos_id": 2,
            "unk_id": 3}
    model = neurst_tpu_torch.build_model(
        cfg, src_meta={"audio_feature_dim": TRAIN["feature_dim"],
                       "audio_feature_channels": 1},
        trg_meta=meta, asr_meta=meta, device=device)
    model.init_params(torch.Generator().manual_seed(seed))
    lr = neurst_tpu_torch.build_lr_schedule(cfg)
    tx = with_bf16_params(create_optax_chain(
        neurst_tpu_torch.build_optimizer(cfg), lr))
    cast_params_bf16(model)
    criterion = neurst_tpu_torch.build_criterion(JOINT_CRITERION)
    state = TrainState.create(dict(model.named_parameters()), tx)
    return model, criterion, tx, state, make_train_step(
        model, criterion, tx, lr_schedule=lr)


def multitask_bare_step(seed, enc_rows, dec_rows):
    """The joint model's train step alone at the top bucket
    (``build_multitask_train``), driven as the train phases drive theirs.
    Returns (row, launch totals)."""
    from neurst_tpu_torch.utils.rng import make_key

    t = MULTITASK
    model, criterion, tx, state, step = build_multitask_train(seed)
    rng = np.random.RandomState(seed + 5)
    batches = [multitask_batch(rng, "cuda", TRAIN["batch"], TRAIN["frames"],
                               MULTITASK_TASK["max_trg_len"])
               for _ in range(t["bare_warmup"] + t["bare_steps"]
                              + t["bare_split"])]
    expected = expected_launches(model, enc_rows, dec_rows, True)
    out, totals = _drive_train(model, criterion, tx, state, step, batches,
                               t["bare_warmup"], t["bare_steps"],
                               make_key(seed + 7), expected)
    timed = batches[t["bare_warmup"]:t["bare_warmup"] + t["bare_steps"]]
    tokens = {side: float(np.mean([float((1.0 - b[f"{side}trg_padding"]
                                          ).sum()) for b in timed]))
              for side in ("", "asr_")}
    median_s = out["step_ms_median"] / 1e3
    return dict(out, target_tokens_per_s=tokens[""] / median_s,
                transcript_tokens_per_s=tokens["asr_"] / median_s), totals


def _moved_by_prefix(before, after, prefixes):
    """{prefix: (tensors moved, tensors)} between two flat checkpoints;
    the attention key biases (gradient 0 up to rounding) are left out."""
    out = {}
    for prefix in prefixes:
        names = [k for k in after if k.startswith(prefix)
                 and _key_bias(k, after[k]) is None]
        out[prefix] = (sum(not np.array_equal(before[k], after[k])
                           for k in names), len(names))
    return out


def multitask_train_phase(seed, root, train_dropout_row, device="cuda"):
    """The joint recipe's train entry (``MULTITASK``), every step's
    launches against ``expected_launches`` (192 dropout, 0 fused xent at
    the top bucket), both decoders' weights moving between ckpt-6 and
    ckpt-12; then the bare step at the top bucket.  Returns what the
    later phases read: the model dir, pipelines, words, records and
    texts, and the launch counts by path."""
    import torch

    from neurst_tpu_torch.data.data_pipelines import build_data_pipeline
    from neurst_tpu_torch.tasks.speech2text import (
        MultiTaskSpeechTranslation, train_bucket_shapes)
    from neurst_tpu_torch.utils.checkpoints import restore_checkpoint_params

    t = MULTITASK
    start = time.perf_counter()
    rng = np.random.RandomState(seed + 100)
    pipelines, words = {}, {}
    for side in ("en", "de"):
        os.makedirs(os.path.join(root, side))
        pipelines[side] = dict(write_vocab(rng, os.path.join(root, side)),
                               language=side)
        words[side] = _words(rng, build_data_pipeline(
            {"data_pipeline.class": "TextDataPipeline",
             "data_pipeline.params": pipelines[side]}))
    records = {name: os.path.join(root, f"{name}.tfrecords")
               for name in ("train", "predict")}
    texts = {"train": write_triple_records(
        records["train"], rng, words, rng.randint(
            t["min_frames"], t["max_frames"] + 1, size=t["triples"]),
        t["min_tokens"], t["max_tokens"])}
    texts["predict"] = write_triple_records(
        records["predict"], rng, words, rng.randint(
            t["predict_min_frames"], t["predict_max_frames"] + 1,
            size=t["predict_triples"]),
        t["predict_min_tokens"], t["predict_max_tokens"])
    write_s = time.perf_counter() - start

    model_dir = os.path.join(root, "model_a")
    cfg = multitask_config(os.path.join(root, "train.json"),
                           records["train"], pipelines,
                           train_steps=t["steps"],
                           save_checkpoint_steps=t["save_every"],
                           summary_steps=t["summary"])
    argv = ["--config_paths", cfg, "--model_dir", model_dir]
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    else:
        argv += ["--device", device]
    _, seen = run_trainer(argv, MultiTaskSpeechTranslation)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    _train_path_checks(seen, t["steps"], "multitask_train")
    model = seen["model"]
    _, shapes = train_bucket_shapes(dict(MULTITASK_TASK,
                                         batch_size_multiple=8))
    top = [shapes[-1][0], shapes[-1][1], shapes[-1][2][-1]]
    enc_rows, dec_rows = _speech_rows(top), top[0] * top[2]
    expected = expected_launches(model, enc_rows, dec_rows, True)
    by_shape = _step_launch_checks(seen, model) if on_card else {}
    ckpts = [restore_checkpoint_params(os.path.join(
        model_dir, f"ckpt-{s}.npz")) for s in (t["save_every"], t["steps"])]
    moved = _moved_by_prefix(*ckpts, ("decoder/", "asr_decoder/",
                                      "asr_symbol_modality/"))
    windows = seen["windows"][1:] or seen["windows"]
    per_step = [sum(tok.get("asr_trg_length", 0) for tok in
                    seen["tokens"][w["step"] - t["summary"]:w["step"]])
                / (t["summary"] * w["secs_per_step"]) for w in windows]
    row = dict({"phase": "multitask_train", "model": t["hparams_set"],
                "recipe": "examples/multi_task_st/example_configs/"
                          "multitask_st.yml",
                "dtype": "bfloat16", "bf16_params": True,
                "dropout": DROPOUT_RATE, "triples": t["triples"],
                "write_inputs_s": write_s, "top_bucket": top,
                "launches_per_step_expected": expected,
                "launches_per_step_by_shape": by_shape,
                "decoder_tensors_moved_between_checkpoints": moved,
                "transcript_tokens_per_s": float(np.median(per_step)),
                "tokens_per_s_counts": "the translation's non-pad target "
                                       "tokens (the trainer's log line)"},
               **_trainer_numbers(seen, peak))
    if on_card:
        bare, bare_totals = multitask_bare_step(seed, enc_rows, dec_rows)
        row["bare_step"] = {
            k: bare[k] for k in ("step_ms_median", "step_ms", "split_ms",
                                 "target_tokens_per_s",
                                 "transcript_tokens_per_s",
                                 "max_memory_allocated",
                                 "dropout_determinism")}
        row["bare_step"]["st_train_s_recipe_step_ms_median"] = \
            train_dropout_row["step_ms_median"]
        row["bare_step"]["ratio_to_st_train_s_recipe"] = \
            bare["step_ms_median"] / train_dropout_row["step_ms_median"]
    emit(row)
    if on_card and not (
            expected["fused_dropout"] == 192
            and expected["fused_linear_xent_fwd"] == 0
            and expected["fused_linear_xent_bwd"] == 0
            and all(s == top for s in seen["shapes"])):
        raise AssertionError(f"multitask_train: expected {expected}, "
                             f"shapes {seen['shapes']}")
    if not all(n == total > 0 for n, total in moved.values()):
        raise AssertionError(f"multitask_train: decoder weights that did "
                             f"not move from ckpt-6 to ckpt-12: {moved}")
    launches = {"multitask_train": seen["launches"]}
    if on_card:
        launches["multitask_step"] = bare_totals
    return {"model_dir": model_dir, "pipelines": pipelines, "words": words,
            "records": records, "texts": texts}, launches


def _predict_config(root, name, records, dataset):
    """PREDICT_ARGS over ``records``, the metric left to the command
    line."""
    config = json.loads(json.dumps(PREDICT_ARGS))
    del config["entry.params"]["metric.class"]
    config["dataset.class"], config["dataset.params"] = dataset, dict(
        TRIPLE_DATASET, data_path=records)
    config["entry.params"]["output_file"] = os.path.join(root,
                                                         f"hypo.{name}.txt")
    path = os.path.join(root, f"predict.{name}.json")
    with open(path, "w") as f:
        json.dump(config, f, indent=1)
    return path


def _counted_predict(argv):
    """``run_exp.cli_main(argv)`` with the launch counts set to 0 before
    and read after: (result, counts, wall seconds)."""
    from neurst_tpu_torch.cli import run_exp
    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
    reset_launch_counts()
    start = time.perf_counter()
    result = run_exp.cli_main(argv)
    return result, launch_counts(), time.perf_counter() - start


def multitask_predict_phases(root, run, device="cuda"):
    """--entry predict on the translation head (BLEU) and the transcript
    head (WER), then the ensemble of ckpt-12 (A) and ckpt-6 (B) and of A
    with itself; 12 flash launches a batch a model.  Returns the launch
    counts by path."""
    t = MULTITASK
    batches = -(-t["predict_triples"] // PREDICT_ARGS["batch_size"])
    per_batch = 12 if device == "cuda" else 0
    extra = [] if device == "cuda" else ["--device", device]
    dir_a = run["model_dir"]
    dir_b = os.path.join(root, "model_b")
    os.makedirs(dir_b)
    for name in ("model_configs.yml", f"ckpt-{t['save_every']}.npz"):
        shutil.copy(os.path.join(dir_a, name), dir_b)
    refs = {"st": [p[1] for p in run["texts"]["predict"]],
            "asr": [p[0] for p in run["texts"]["predict"]]}
    rows, launches, hyps = {}, {}, {}
    for name, model_dir, head in (
            ("st", dir_a, ST_HEAD), ("asr", dir_a, ASR_HEAD),
            ("ensemble_ab", f"{dir_a},{dir_b}", ST_HEAD),
            ("ensemble_aa", f"{dir_a},{dir_a}", ST_HEAD)):
        config = _predict_config(root, name, run["records"]["predict"],
                                 "audio_triple_tfrecord")
        result, counts, wall_s = _counted_predict(
            ["--config_paths", config, "--model_dir", model_dir] + head
            + extra)
        members = len(model_dir.split(","))
        hyps[name] = result["hypotheses"]
        rows[name] = {
            "models": members, "samples": result["samples"],
            "samples_per_s": result["samples_per_sec"], "cli_wall_s": wall_s,
            "timing_s": result["timing"],
            "metric": {k: result[k] for k in ("BLEU", "WER") if k in result},
            "flash_fwd_launches": counts["flash_attention_fwd"],
            "flash_fwd_expected": per_batch * members * batches}
        launches[f"predict_{name}"] = counts
        if not (result["samples"] == t["predict_triples"]
                and counts["flash_attention_fwd"]
                == per_batch * members * batches
                and all(math.isfinite(v)
                        for v in rows[name]["metric"].values())):
            raise AssertionError(f"multitask predict {name}: {rows[name]}")
    rows["ensemble_aa"]["equals_single_model"] = \
        hyps["ensemble_aa"] == hyps["st"]
    rows["ensemble_ab"]["differs_from_a"] = hyps["ensemble_ab"] != hyps["st"]
    rows["asr"]["differs_from_st"] = hyps["asr"] != hyps["st"]
    emit({"phase": "multitask_predict", "search": PREDICT_ARGS[
        "entry.params"]["search_method.params"],
          "batch_size": PREDICT_ARGS["batch_size"],
          "reference_words": {k: sum(len(x.split()) for x in v)
                              for k, v in refs.items()},
          **rows})
    if not rows["ensemble_aa"]["equals_single_model"]:
        raise AssertionError("multitask predict: the ensemble of A with "
                             "itself did not give A's hypotheses")
    return launches


def cascade_phase(root, run, device="cuda"):
    """The ASR -> MT cascade: an ASR dir from 6 steps of
    must-c/asr_training_args.yml's task flags on the train triples'
    audio and transcripts, an MT dir from 6 steps of
    mt_training_args.yml's flags on their transcripts and translations,
    then ``cascade_st`` on the predict triples with BLEU against their
    translations.  Returns the launch counts by path."""
    import torch

    from neurst_tpu_torch.cli import cascade_st
    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
    from neurst_tpu_torch.tasks.speech2text import SpeechToText
    from neurst_tpu_torch.tasks.translation import Translation

    t = MULTITASK
    on_card = device == "cuda"
    extra = [] if on_card else ["--device", device]
    asr_pipeline = dict(run["pipelines"]["en"], remove_punctuation=True,
                        lowercase=True)
    asr_cfg = trainer_config(
        os.path.join(root, "asr_train.json"), run["records"]["train"],
        asr_pipeline, train_steps=t["cascade_steps"],
        save_checkpoint_steps=t["cascade_steps"], summary_steps=t["summary"])
    with open(asr_cfg) as f:
        config = json.load(f)
    config["task.params"]["transcript_data_pipeline.class"] = \
        "TranscriptDataPipeline"
    config["dataset.params"]["transcript_key"] = "transcript"
    with open(asr_cfg, "w") as f:
        json.dump(config, f, indent=1)
    texts = {}
    for side, i in (("src", 0), ("trg", 1)):
        texts[side] = os.path.join(root, f"mt_train.{side}")
        with open(texts[side], "w") as f:
            f.write("\n".join(p[i] for p in run["texts"]["train"]) + "\n")
    mt_cfg = nmt_config(
        os.path.join(root, "mt_train.json"),
        {"src": run["pipelines"]["en"], "trg": run["pipelines"]["de"]},
        ("parallel_text", _parallel(texts)),
        train_steps=t["cascade_steps"],
        save_checkpoint_steps=t["cascade_steps"], summary_steps=t["summary"])
    dirs, trained, launches = {}, {}, {}
    for side, cfg, task_cls in (("asr", asr_cfg, SpeechToText),
                                ("mt", mt_cfg, Translation)):
        dirs[side] = os.path.join(root, f"cascade_{side}")
        _, seen = run_trainer(["--config_paths", cfg, "--model_dir",
                               dirs[side]] + extra, task_cls)
        _train_path_checks(seen, t["cascade_steps"], f"cascade {side}")
        trained[side] = dict(_trainer_numbers(seen, None),
                             launches_per_step_by_shape=_step_launch_checks(
                                 seen, seen["model"]) if on_card else {})
        launches[f"cascade_{side}_train"] = seen["launches"]
    refs = os.path.join(root, "cascade.refs")
    with open(refs, "w") as f:
        f.write("\n".join(p[1] for p in run["texts"]["predict"]) + "\n")
    sides = []
    decode = cascade_st._decode_dataset

    def timed_decode(*a, **kw):
        start = time.perf_counter()
        task, hyps = decode(*a, **kw)
        if on_card:
            torch.cuda.synchronize()
        sides.append({"samples": len(hyps),
                      "wall_s": time.perf_counter() - start})
        return task, hyps

    out = os.path.join(root, "cascade.out")
    printed = io.StringIO()
    cascade_st._decode_dataset = timed_decode
    reset_launch_counts()
    try:
        with contextlib.redirect_stdout(printed):
            cascade_st.main([
                "--asr_model_dir", dirs["asr"], "--mt_model_dir", dirs["mt"],
                "--dataset", "audio_tfrecord", "--data_path",
                run["records"]["predict"], "--batch_size",
                str(PREDICT_ARGS["batch_size"]), "--output_file", out,
                "--ref_file", refs] + extra)
    finally:
        cascade_st._decode_dataset = decode
    counts = launch_counts()
    launches["cascade"] = counts
    metric = ast.literal_eval(printed.getvalue().strip().splitlines()[-1])
    with open(out) as f:
        lines = f.read().splitlines()
    batches = -(-t["predict_triples"] // PREDICT_ARGS["batch_size"])
    expected = 12 * batches if on_card else 0
    row = {"phase": "cascade",
           "asr_recipe": "examples/speech_transformer/must-c/"
                         "asr_training_args.yml",
           "mt_recipe": "examples/speech_transformer/must-c/"
                        "mt_training_args.yml",
           "trained": trained,
           "asr_side": dict(sides[0], samples_per_s=sides[0]["samples"]
                            / sides[0]["wall_s"]),
           "mt_side": dict(sides[1], samples_per_s=sides[1]["samples"]
                           / sides[1]["wall_s"]),
           "output_lines": len(lines), "metric": metric,
           "flash_fwd_launches": counts["flash_attention_fwd"],
           "flash_fwd_expected": expected}
    emit(row)
    if not (len(lines) == t["predict_triples"] and len(sides) == 2
            and math.isfinite(metric["BLEU"])
            and counts["flash_attention_fwd"] == expected):
        raise AssertionError(f"cascade phase failed: {row}")
    return launches


def multitask_reference_check(root, run, devices=("cuda", "cpu")):
    """The joint recipe in float32 on the card and on the CPU (plain
    versions, which the CPU tests hold against the JAX package):
    ``speech_transformer_toy``, dropout 0, one bucket of 8 short triples,
    noam with warmup 1 (lr 1e-3 at step 1), 2 steps, then an ASR-head
    decode of the same triples: losses within 1e-5 relative, ckpt-2
    within 2 lr + 1e-6 (the key biases within 2 x the summed lr + 1e-6),
    hypotheses equal."""
    from neurst_tpu_torch.utils.checkpoints import restore_checkpoint_params

    t = MULTITASK
    rng = np.random.RandomState(5)
    records = os.path.join(root, "check.tfrecords")
    write_triple_records(records, rng, run["words"], rng.randint(
        20, t["check_max_frames"] + 1, size=t["check_triples"]), 4, 8)
    rates = {f"{side}.{r}": 0.0 for side in ("encoder", "decoder")
             for r in ("attention_dropout_rate", "ffn_dropout_rate",
                       "layer_postprocess_dropout_rate")}
    cfg = multitask_config(
        os.path.join(root, "check.json"), records, run["pipelines"],
        task={"max_src_len": t["check_max_frames"], "max_trg_len": 16,
              "min_src_bucket_boundary": t["check_max_frames"],
              "batch_size": 8 * t["check_max_frames"], "shuffle_buffer": 0},
        model=dict(rates, dtype="float32",
                   **{"encoder.enable_flash_attention": False}),
        train_steps=t["check_steps"], save_checkpoint_steps=1000,
        summary_steps=1, enable_tensorboard=False,
        **{"lr_schedule.params": {"warmup_steps": 1,
                                  "initial_factor": 0.004}})
    predict = json.loads(json.dumps(PREDICT_ARGS))
    del predict["entry.params"]["metric.class"]
    predict["entry.params"]["search_method.params"][
        "maximum_decode_length"] = t["check_max_decode"]
    predict["dataset.class"] = "audio_triple_tfrecord"
    predict["dataset.params"] = dict(TRIPLE_DATASET, data_path=records)
    predict_cfg = os.path.join(root, "check_predict.json")
    with open(predict_cfg, "w") as f:
        json.dump(predict, f)
    from neurst_tpu_torch.cli import run_exp
    out = {}
    for i, device in enumerate(devices):
        model_dir = os.path.join(root, f"check_{i}_{device}")
        _, seen = run_trainer(["--config_paths", cfg, "--hparams_set",
                               "speech_transformer_toy", "--model_dir",
                               model_dir, "--device", device])
        hyps = run_exp.cli_main(["--config_paths", predict_cfg,
                                 "--model_dir", model_dir, "--device",
                                 device] + ASR_HEAD)["hypotheses"]
        out[i] = (restore_checkpoint_params(os.path.join(
            model_dir, f"ckpt-{t['check_steps']}.npz")),
            [w["loss"] for w in seen["windows"]], hyps)
    card, cpu = (out[i] for i in range(len(devices)))
    lrs = [0.004 * 16 ** -0.5 / math.sqrt(s)
           for s in range(1, t["check_steps"] + 1)]
    tol, noise_tol = 2 * lrs[0] + 1e-6, 2 * sum(lrs) + 1e-6
    err = noise = 0.0
    for name, ref in cpu[0].items():
        diff = np.abs(card[0][name] - ref)
        key = _key_bias(name, diff)
        if key is not None:
            noise = max(noise, float(key.max()))
            diff = np.delete(diff, 1 if "qkv" in name else 0, axis=0)
        err = max(err, float(diff.max()))
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card[1], cpu[1]))
    row = {"phase": "multitask_reference_check",
           "model": "speech_transformer_toy", "devices": list(devices),
           "steps": t["check_steps"], "max_param_abs_err": err,
           "key_bias_max_abs_err": noise, "tol": [tol, noise_tol],
           "losses": [out[i][1] for i in range(len(devices))],
           "loss_max_rel_err": loss_err,
           "asr_hypotheses_equal": card[2] == cpu[2],
           "asr_hypothesis_head": cpu[2][0][:60]}
    emit(row)
    if not (err <= tol and noise <= noise_tol and loss_err <= 1e-5
            and len(card[1]) == t["check_steps"] and card[2] == cpu[2]):
        raise AssertionError(f"the card's float32 joint trainer disagrees "
                             f"with the CPU's: {row}")
    return row


def multitask_phases(seed, train_dropout_row, device="cuda"):
    """The multi-task group under ``build/multitask_smoke/`` (removed
    after): multitask_train, multitask_predict (both heads and the
    ensembles), cascade and multitask_reference_check, with each phase's
    wall seconds.  Returns the launch counts by path."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "multitask_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    stages = {}
    try:
        start = time.perf_counter()
        run, launches = multitask_train_phase(seed, root, train_dropout_row,
                                              device)
        stages["multitask_train"] = time.perf_counter() - start
        start = time.perf_counter()
        launches.update(multitask_predict_phases(root, run, device))
        stages["multitask_predict"] = time.perf_counter() - start
        start = time.perf_counter()
        launches.update(cascade_phase(root, run, device))
        stages["cascade"] = time.perf_counter() - start
        start = time.perf_counter()
        multitask_reference_check(root, run, (device, "cpu"))
        stages["multitask_reference_check"] = time.perf_counter() - start
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "multitask", "stage_wall_s": stages,
          "total_s": sum(stages.values())})
    return launches


# Simultaneous translation: examples/simultaneous_translation/
# waitk_training_args.yml (``waitk_translation`` with wait_k [3, 5, 7, 9]
# drawn per batch, ``waitk_transformer`` at transformer_base's widths with
# a monotonic encoder, 25,000-token buckets, max 128 / 128) through the
# train entry with the encoder's flash attention on, dropout 0.1 at every
# site and bf16 with an f32 master, on a seeded corpus whose joint BPE
# (learn_bpe, as the recipes prepare their text) is written to
# vocabularies padded with unused entries to a multiple of 128; then the
# streaming simuleval_cli (offline, and online against a local mock
# SimulEval server), the full-sentence predict entry, and the LightConv
# recipe (``lightconv_base``, the same data and buckets, dropout 0.1 at
# every site including the convolution weights) trained and decoded with
# beam search and with top-k sampling.
WAITK = dict(recipe=os.path.join("examples", "simultaneous_translation",
                                 "waitk_training_args.yml"),
             words=2000, pairs=20000, bpe_pairs=4000, min_tokens=5,
             max_tokens=127, bpe_symbols=2000, vocab_multiple=128,
             steps=6, summary=2,
             simul_sentences=16, simul_min_words=20, simul_max_words=60,
             online_sentences=8, wait_k=3, max_decode_len=64,
             predict_sentences=64, predict_batch=32, beam=4,
             lightconv_set="lightconv_base", lightconv_steps=6,
             sampling_top_k=8, target_vocab=1536,
             lightconv_xent_rows=192 * 128, check_tokens=2048)
# float32 flash vs dense encoder, and card vs CPU: the loss relative
WAITK_CHECK_TOL = 1e-5


def _simple_server(sources):
    """A local SimulEval v1 server on 127.0.0.1 (``GET /``, ``GET /src``,
    ``PUT /hypo``, ``GET /result``) streaming each source a word at a
    time and keeping each instance's units.  Returns (server, units)."""
    import threading
    import urllib.parse
    from http.server import BaseHTTPRequestHandler, HTTPServer

    words = [s.split() for s in sources]
    read = [0] * len(sources)
    units = [[] for _ in sources]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _json(self, obj):
            body = json.dumps(obj).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            query = dict(urllib.parse.parse_qsl(url.query))
            if url.path in ("", "/"):
                self._json({"num_sentences": len(sources)})
            elif url.path == "/src":
                i = int(query["instance_id"])
                seg = words[i][read[i]] if read[i] < len(words[i]) \
                    else "</s>"
                read[i] += 1
                self._json({"instance_id": i, "segment_id": read[i] - 1,
                            "segment": seg})
            else:
                self._json({"instances": len(sources)})

        def do_PUT(self):
            query = dict(urllib.parse.parse_qsl(
                urllib.parse.urlparse(self.path).query))
            n = int(self.headers.get("Content-Length", 0))
            units[int(query["instance_id"])].append(
                self.rfile.read(n).decode("utf-8"))
            self._json({})

    server = HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, units


def write_bpe_corpus(root, rng, cfg=WAITK):
    """A seeded parallel corpus (``cfg["pairs"]`` pairs of
    ``min_tokens``-``max_tokens`` words from two lexicons of
    ``cfg["words"]`` words: enough that every training step of the
    phases takes a full 25,000-token bucket, not an end-of-epoch flush),
    joint BPE codes learned by the port's ``learn_bpe`` on its first
    ``bpe_pairs`` pairs and a vocabulary a side, padded with unused
    entries so that with the pipeline's three control tokens it is a
    multiple of ``vocab_multiple``.  Returns (train paths, pipelines,
    lexicons)."""
    from neurst_tpu_torch.cli import learn_bpe

    lexicon = {side: sorted({_random_word(rng, 2, 9)
                             for _ in range(cfg["words"])})
               for side in ("src", "trg")}
    train = write_parallel(os.path.join(root, "train"), rng, lexicon["src"],
                           lexicon["trg"], cfg["pairs"], cfg["min_tokens"],
                           cfg["max_tokens"])
    sample = {}
    for side in ("src", "trg"):
        sample[side] = os.path.join(root, f"bpe_sample.{side}")
        with open(train[side]) as f, open(sample[side], "w") as out:
            out.writelines(line for _, line in zip(range(cfg["bpe_pairs"]),
                                                   f))
    codes = os.path.join(root, "codes.bpe")
    vocabs = {side: os.path.join(root, f"vocab.{lang}")
              for side, lang in (("src", "en"), ("trg", "de"))}
    learn_bpe.main(["--input", sample["src"], sample["trg"], "--symbols",
                    str(cfg["bpe_symbols"]), "--output", codes,
                    "--write_vocabulary", vocabs["src"], vocabs["trg"]])
    pipelines = {}
    for side, lang in (("src", "en"), ("trg", "de")):
        with open(vocabs[side]) as f:
            size = sum(1 for _ in f) + 3
        with open(vocabs[side], "a") as f:
            for i in range(-size % cfg["vocab_multiple"]):
                f.write(f"<unused{i}> 0\n")
        pipelines[side] = {"language": lang, "subtokenizer": "bpe",
                           "subtokenizer_codes": codes,
                           "vocab_path": vocabs[side]}
    return train, pipelines, lexicon


def _recipe_config(path, recipe, train, pipelines, model=None, **entry):
    """The recipe's YAML with the corpus' paths, the given model params
    and entry flags, written to ``path`` (JSON)."""
    import yaml
    with open(recipe) as f:
        cfg = yaml.safe_load(f)
    for side in ("src", "trg"):
        cfg["task.params"][f"{side}_data_pipeline.params"] = pipelines[side]
    cfg["dataset.class"] = "parallel_text"
    cfg["dataset.params"] = _parallel(train)
    cfg["model.params"] = dict(cfg.get("model.params") or {},
                               **(model or {}))
    cfg["dtype"] = "bfloat16"
    cfg["entry.params"] = dict(cfg.get("entry.params") or {},
                               enable_tensorboard=False, **entry)
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


def _dropout_params(prefixes, names):
    return {f"{p}.{name}": DROPOUT_RATE for p in prefixes for name in names}


def waitk_train_phase(seed, root, train, pipelines, device="cuda"):
    """The wait-k recipe through the train entry (``WAITK``): window
    tokens/s, the lagging each batch drew, each step's launches against
    ``expected_launches`` at its bucket (no fused xent: the JAX package's
    gate), checkpoint seconds and peak memory; then one batch's float32
    loss with the encoder's flash kernels against the dense encoder on
    the trained weights.  Returns (launch counts, model dir)."""
    import torch

    from neurst_tpu_torch.tasks.waitk_translation import WaitkTranslation

    t = WAITK
    model_dir = os.path.join(root, "waitk")
    cfg = _recipe_config(
        os.path.join(root, "waitk.json"), t["recipe"], train, pipelines,
        model=dict({"encoder.enable_flash_attention": True}, **_dropout_params(
            ("encoder", "decoder"), ("attention_dropout_rate",
                                     "ffn_dropout_rate",
                                     "layer_postprocess_dropout_rate"))),
        train_steps=t["steps"], save_checkpoint_steps=t["steps"],
        summary_steps=t["summary"])
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _, seen = run_trainer(["--config_paths", cfg, "--model_dir", model_dir,
                           "--device", device], WaitkTranslation)
    _train_path_checks(seen, t["steps"], "waitk_train")
    tokens = _full_batches(seen, "waitk_train")
    model = seen["model"]
    laggings = seen["laggings"]
    with open(cfg) as f:
        choices = json.load(f)["task.params"]["wait_k"]
    row = dict({"phase": "waitk_train", "recipe": t["recipe"],
                "model": "waitk_transformer (transformer_base widths)",
                "dtype": "bfloat16", "bf16_params": True,
                "dropout": DROPOUT_RATE, "encoder_flash": True,
                "wait_k": choices, "decode_wait_k": model.wait_k,
                "laggings": laggings, "target_tokens_a_step": tokens,
                "target_vocab": model.trg_meta["vocab_size"],
                "fused_xent": model.supports_fused_softmax_ce(),
                "launches_per_step_by_shape": _step_launch_checks(seen, model)
                if device == "cuda" else {}},
               **_trainer_numbers(seen, torch.cuda.max_memory_allocated()
                                  if device == "cuda" else None))
    if not (len(laggings) >= t["steps"]
            and set(laggings) <= set(choices)
            and os.path.exists(os.path.join(model_dir,
                                            f"ckpt-{t['steps']}.npz"))):
        raise AssertionError(f"waitk_train failed: {row}")
    row["flash_check"] = waitk_flash_check(root, model_dir, train, device)
    emit(row)
    return seen["launches"], model_dir


def _check_batch(model_dir, train, tokens):
    """The dir's configs, task and latest checkpoint, with the first
    TRAIN batch of ``tokens`` tokens of the corpus (no shuffle)."""
    from neurst_tpu_torch.data.datasets.dataset import build_dataset
    from neurst_tpu_torch.tasks.task import build_task
    from neurst_tpu_torch.utils.checkpoints import (latest_checkpoint,
                                                    restore_checkpoint_params)
    from neurst_tpu_torch.utils.compat import ModeKeys
    from neurst_tpu_torch.utils.configurable import ModelConfigs

    cfg = ModelConfigs.load(model_dir)
    task = build_task(cfg)
    flat = restore_checkpoint_params(latest_checkpoint(model_dir))
    batch = next(task.create_batch_iterator(
        build_dataset({"dataset.class": "parallel_text",
                       "dataset.params": _parallel(train)}),
        ModeKeys.TRAIN, {"batch_by_tokens": True, "batch_size": tokens,
                         "max_src_len": 128, "max_trg_len": 128,
                         "shuffle_buffer": 0, "seed": 0})())
    return cfg, task, flat, batch


def _smoothed_xent():
    from neurst_tpu_torch.criterions import build_criterion
    return build_criterion({"criterion.class": "label_smoothed_cross_entropy",
                            "criterion.params": {"label_smoothing": 0.1}})


def _full_batches(seen, what):
    """Every step's batch a full bucket (no masked rows: not an
    end-of-epoch flush).  Returns the target tokens of each step."""
    steps = len(seen["steps"])
    rows, shapes = seen["rows"][:steps], seen["shapes"][:steps]
    if [r for r, shape in zip(rows, shapes) if r != shape[0]]:
        raise AssertionError(f"{what}: partial batches, rows {rows} of "
                             f"{[shape[0] for shape in shapes]}")
    return [t["trg_length"] for t in seen["tokens"][:steps]]


def waitk_flash_check(root, model_dir, train, device="cuda"):
    """One 4096-token training batch (lagging 5) through the trained
    weights in float32 with the encoder's flash kernels and with the
    dense encoder (no dropout): the label-smoothed losses within
    ``WAITK_CHECK_TOL`` relative."""
    import torch

    from neurst_tpu_torch.utils.param_bridge import load_flat_params

    cfg, task, flat, batch = _check_batch(model_dir, train, 4096)
    batch = dict(batch, waitk_lagging=np.asarray(5, np.int32))
    crit = _smoothed_xent()
    losses = {}
    for flash in (True, False):
        params = dict(cfg["model.params"], dtype="float32",
                      **{"encoder.enable_flash_attention": flash})
        model = task.build_model({"model.class": cfg["model.class"],
                                  "model.params": params}, device=device)
        load_flat_params(model, flat)
        with torch.no_grad():
            losses[flash] = float(crit.reduce_loss(batch, model(batch)))
        del model
    rel = abs(losses[True] - losses[False]) / abs(losses[False])
    out = {"shape": list(batch["src"].shape), "loss_flash": losses[True],
           "loss_dense": losses[False], "rel_diff": rel,
           "tol": WAITK_CHECK_TOL}
    if not rel <= WAITK_CHECK_TOL:
        raise AssertionError(f"waitk flash check: {out}")
    return out


def _single_unit_sentences(rng, pipeline, lexicon, n, low, high):
    """``n`` sentences of ``low``-``high`` words, each word one BPE unit
    (so the online mode's word-at-a-time reads are the offline mode's
    unit-at-a-time reads)."""
    words = [w for w in lexicon if len(pipeline.encode(w)) == 2]
    if len(words) < 50:
        raise AssertionError(f"only {len(words)} single-unit words")
    return [" ".join(words[i] for i in rng.randint(
        len(words), size=int(rng.randint(low, high + 1))))
        for _ in range(n)]


def waitk_simuleval_phase(seed, root, model_dir, pipelines, lexicon,
                          device="cuda"):
    """simuleval_cli on the wait-k dir: offline over ``simul_sentences``
    sentences (``--wait_k``, ``--max_decode_len``) with sentences/s, AL,
    CW, BLEU, the ms of a READ's re-encode and of a WRITE's step (host
    clock, synchronised) and the flash launches a READ; then online
    against a local mock server over the first ``online_sentences``,
    whose streams (output ids and delays) must be the offline ones.
    Returns the offline run's launch counts."""
    import torch

    from neurst_tpu_torch.cli import simuleval_cli
    from neurst_tpu_torch.data.data_pipelines import build_data_pipeline
    from neurst_tpu_torch.models.waitk_transformer import WaitkTransformer
    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
    from neurst_tpu_torch.utils.simuleval_agents.simul_trans_text_agent \
        import SimulTransTextAgent

    t = WAITK
    rng = np.random.RandomState(seed + 95)
    src_pipeline = build_data_pipeline({
        "data_pipeline.class": "TextDataPipeline",
        "data_pipeline.params": pipelines["src"]})
    sources = _single_unit_sentences(rng, src_pipeline, lexicon["src"],
                                     t["simul_sentences"],
                                     t["simul_min_words"],
                                     t["simul_max_words"])
    refs = [" ".join(lexicon["trg"][i] for i in rng.randint(
        len(lexicon["trg"]), size=len(s.split()))) for s in sources]
    paths = {}
    for name, lines in (("src", sources), ("ref", refs)):
        paths[name] = os.path.join(root, f"simul.{name}")
        with open(paths[name], "w") as f:
            f.write("\n".join(lines) + "\n")
    hypo = os.path.join(root, "simul.hyp")
    timings = {"read": [], "write": []}
    originals = {name: getattr(WaitkTransformer, name)
                 for name in ("incremental_encode", "incremental_decode")}

    def timed(name, into):
        def call(self, *a, **kw):
            if device == "cuda":
                torch.cuda.synchronize()
            start = time.perf_counter()
            out = originals[name](self, *a, **kw)
            if device == "cuda":
                torch.cuda.synchronize()
            timings[into].append((time.perf_counter() - start) * 1e3)
            return out
        return call

    streamed = []
    stream = SimulTransTextAgent.translate_stream

    def recorded(self, *a, **kw):
        out = stream(self, *a, **kw)
        streamed.append(out)
        return out

    argv = ["--model_dir", model_dir, "--wait_k", str(t["wait_k"]),
            "--max_decode_len", str(t["max_decode_len"]), "--device",
            device]
    WaitkTransformer.incremental_encode = timed("incremental_encode", "read")
    WaitkTransformer.incremental_decode = timed("incremental_decode",
                                                "write")
    SimulTransTextAgent.translate_stream = recorded
    try:
        reset_launch_counts()
        start = time.perf_counter()
        result = simuleval_cli.main(argv + [
            "--src_file", paths["src"], "--ref_file", paths["ref"],
            "--output_file", hypo])
        wall_s = time.perf_counter() - start
        counts = launch_counts()
        for name, fn in originals.items():
            setattr(WaitkTransformer, name, fn)
        offline = streamed[:]
        del streamed[:]
        server, units = _simple_server(sources[:t["online_sentences"]])
        try:
            start = time.perf_counter()
            simuleval_cli.main(argv + ["--hostname", "127.0.0.1", "--port",
                                       str(server.server_address[1])])
            online_s = time.perf_counter() - start
        finally:
            server.shutdown()
            server.server_close()
    finally:
        for name, fn in originals.items():
            setattr(WaitkTransformer, name, fn)
        SimulTransTextAgent.translate_stream = stream
    with open(hypo) as f:
        hypotheses = f.read().splitlines()
    reads = len(timings["read"])
    flash_per_read = counts["flash_attention_fwd"] / max(reads, 1)
    row = {"phase": "waitk_simuleval", "sentences": len(sources),
           "words_a_sentence": [t["simul_min_words"], t["simul_max_words"]],
           "wait_k": t["wait_k"], "max_decode_len": t["max_decode_len"],
           "AL": result["AL"], "CW": result["CW"], "BLEU": result["BLEU"],
           "wall_s": wall_s, "sentences_per_s": len(sources) / wall_s,
           "reads": reads, "writes": len(timings["write"]),
           "read_ms_median": float(np.median(timings["read"])),
           "write_ms_median": float(np.median(timings["write"])),
           "flash_fwd_launches": counts["flash_attention_fwd"],
           "flash_fwd_per_read": flash_per_read,
           "online_sentences": len(streamed), "online_wall_s": online_s,
           "online_equals_offline": streamed == offline[:len(streamed)],
           "launches": counts}
    emit(row)
    expected_flash = 6 if device == "cuda" else 0
    if not (result["samples"] == len(hypotheses) == len(sources)
            and row["online_equals_offline"]
            and len(streamed) == len(units) == t["online_sentences"]
            and all(u and u[-1] == "</s>" for u in units)
            and flash_per_read == expected_flash
            and math.isfinite(result["AL"])):
        raise AssertionError(f"waitk_simuleval failed: {row}")
    return counts


def _predict_sets(root, rng, lexicon, n, name):
    paths = write_parallel(os.path.join(root, name), rng, lexicon["src"],
                           lexicon["trg"], n, 20, 60)
    return {"dataset.class": "parallel_text", "dataset.params":
            _parallel(paths)}


def waitk_predict_phase(seed, root, model_dir, lexicon, device="cuda"):
    """Full-sentence wait-k decode of ``predict_sentences`` sentences
    through ``--entry predict`` (beam ``WAITK["beam"]``, the model's
    smallest k): samples/s and the encoder's flash launches a batch."""
    t = WAITK
    data = _predict_sets(root, np.random.RandomState(seed + 96), lexicon,
                         t["predict_sentences"], "waitk_dev")
    hypo = os.path.join(root, "waitk_predict.hyp")
    result, counts, wall_s = _counted_predict([
        "--entry", "predict", "--model_dir", model_dir,
        "--dataset.class", data["dataset.class"], "--dataset.params",
        json.dumps(data["dataset.params"]), "--batch_size",
        str(t["predict_batch"]), "--search_method.params",
        json.dumps({"beam_size": t["beam"], "maximum_decode_length": 180}),
        "--metric", "bleu", "--output_file", hypo, "--device", device])
    batches = -(-t["predict_sentences"] // t["predict_batch"])
    expected = 6 * batches if device == "cuda" else 0
    row = {"phase": "waitk_predict", "samples": result["samples"],
           "beam": t["beam"], "samples_per_s": result["samples_per_sec"],
           "timing_s": result["timing"], "cli_wall_s": wall_s,
           "BLEU": result["BLEU"],
           "flash_fwd_launches": counts["flash_attention_fwd"],
           "flash_fwd_expected": expected, "launches": counts}
    emit(row)
    if not (result["samples"] == t["predict_sentences"]
            and counts["flash_attention_fwd"] == expected
            and math.isfinite(result["BLEU"])):
        raise AssertionError(f"waitk_predict failed: {row}")
    return counts


def lightconv_phases(seed, root, train, pipelines, lexicon, device="cuda"):
    """``lightconv_base`` on the wait-k corpus through the train entry
    (the translation task with the recipe's buckets, dropout 0.1 at every
    site, bf16 + f32 master, ``lightconv_steps`` steps; every step's
    launches against ``expected_launches``), then the predict entry with
    beam search and with top-k sampling.  Returns the launch counts by
    path."""
    import torch

    from neurst_tpu_torch.tasks.translation import Translation

    t = WAITK
    cfg_path = _recipe_config(
        os.path.join(root, "lightconv.json"), t["recipe"], train, pipelines,
        train_steps=t["lightconv_steps"],
        save_checkpoint_steps=t["lightconv_steps"],
        summary_steps=t["summary"])
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["task.class"] = "translation"
    cfg["task.params"].pop("wait_k")
    cfg["model.class"] = "light_convolution_model"
    cfg["hparams_set"] = t["lightconv_set"]
    cfg["model.params"] = _dropout_params(
        ("encoder", "decoder"), ("weight_dropout_rate", "ffn_dropout_rate",
                                 "layer_postprocess_dropout_rate"))
    cfg["model.params"]["decoder.attention_dropout_rate"] = DROPOUT_RATE
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=1)
    model_dir = os.path.join(root, "lightconv")
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _, seen = run_trainer(["--config_paths", cfg_path, "--model_dir",
                           model_dir, "--device", device], Translation)
    _train_path_checks(seen, t["lightconv_steps"], "lightconv_train")
    model = seen["model"]
    vocab = model.trg_meta["vocab_size"]
    row = dict({"phase": "lightconv_train", "model": t["lightconv_set"],
                "dtype": "bfloat16", "bf16_params": True,
                "dropout": DROPOUT_RATE,
                "target_tokens_a_step": _full_batches(seen,
                                                      "lightconv_train"),
                "target_vocab": vocab,
                "fused_xent": model.supports_fused_softmax_ce(),
                "launches_per_step_by_shape":
                _step_launch_checks(seen, model) if device == "cuda"
                else {}},
               **_trainer_numbers(seen, torch.cuda.max_memory_allocated()
                                  if device == "cuda" else None))
    if not (row["fused_xent"] and vocab == t["target_vocab"]):
        raise AssertionError(f"lightconv_train: the fused xent at "
                             f"{t['target_vocab']} words expected: {row}")
    launches = {"lightconv_train": seen["launches"]}
    if device == "cuda":
        # rows 4-5 against their plain versions at every [B x T, 512] x V
        # this run gave them
        row["xent_checked_shapes"] = sorted({
            (s["trg"][0] * s["trg"][1], vocab) for s in seen["steps"]})
        xent_kernel_phase(seed + 1, [
            (f"lightconv_train_{rows}", rows, vocab, 512, (torch.bfloat16,))
            for rows, _ in row["xent_checked_shapes"]])
    row["reference_check"] = lightconv_reference_check(model_dir, train,
                                                       device)
    emit(row)
    data = _predict_sets(root, np.random.RandomState(seed + 97), lexicon,
                         t["predict_sentences"], "lightconv_dev")
    rows = {}
    for name, search in (
            ("beam", ["--search_method.params", json.dumps(
                {"beam_size": t["beam"], "maximum_decode_length": 180})]),
            ("top_sampling", ["--search_method", "top_sampling",
                              "--search_method.params", json.dumps(
                                  {"top_k": t["sampling_top_k"],
                                   "maximum_decode_length": 180,
                                   "seed": seed})])):
        result, counts, wall_s = _counted_predict([
            "--entry", "predict", "--model_dir", model_dir,
            "--dataset.class", data["dataset.class"], "--dataset.params",
            json.dumps(data["dataset.params"]), "--batch_size",
            str(t["predict_batch"]), "--metric", "bleu", "--output_file",
            os.path.join(root, f"lightconv.{name}"), "--device", device]
            + search)
        rows[name] = {"samples": result["samples"],
                      "samples_per_s": result["samples_per_sec"],
                      "timing_s": result["timing"], "cli_wall_s": wall_s,
                      "BLEU": result["BLEU"], "launches": counts}
        launches[f"lightconv_predict_{name}"] = counts
        if not (result["samples"] == t["predict_sentences"]
                and math.isfinite(result["BLEU"])):
            raise AssertionError(f"lightconv_predict {name}: {rows[name]}")
    emit({"phase": "lightconv_predict", "model": t["lightconv_set"],
          **rows})
    return launches


def lightconv_reference_check(model_dir, train, device="cuda"):
    """One ``check_tokens``-token training batch through the trained
    LightConv weights in float32 (no dropout) on the card and on the CPU
    (plain versions), on the fused route the trainer takes (prelogits
    into rows 4-5): the label-smoothed losses within ``WAITK_CHECK_TOL``
    relative, each gradient within ``TRAIN_REF_TOL[1]`` by its relative
    L2 error, and rows 4-5 launched on the card."""
    import torch

    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
    from neurst_tpu_torch.utils.param_bridge import load_flat_params

    cfg, task, flat, batch = _check_batch(model_dir, train,
                                          WAITK["check_tokens"])
    crit = _smoothed_xent()
    out = {}
    for where in (device, "cpu"):
        model = task.build_model({"model.class": cfg["model.class"],
                                  "model.params": dict(cfg["model.params"],
                                                       dtype="float32")},
                                 device=where)
        load_flat_params(model, flat)
        params = dict(model.named_parameters())
        reset_launch_counts()
        loss = crit.reduce_loss(batch, model(batch, return_prelogits=True))
        grads = torch.autograd.grad(loss, list(params.values()))
        out[where] = (float(loss.detach()),
                      {n: g.cpu() for n, g in zip(params, grads)},
                      launch_counts())
        del model, params, grads
    (loss, grads, counts), (ref_loss, ref_grads, _) = out[device], out["cpu"]
    rel = abs(loss - ref_loss) / abs(ref_loss)
    grad_err, worst = max(
        (float((grads[n] - ref_grads[n]).norm()
               / ref_grads[n].norm().clamp_min(1e-30)), n)
        for n in ref_grads)
    xent = [counts["fused_linear_xent_fwd"], counts["fused_linear_xent_bwd"]]
    result = {"shape": list(batch["trg"].shape), "dtype": "float32",
              "loss_card": loss, "loss_cpu": ref_loss, "loss_rel_err": rel,
              "max_grad_rel_l2_err": grad_err, "worst_grad": worst,
              "tol": [WAITK_CHECK_TOL, TRAIN_REF_TOL[1]],
              "card_xent_launches": xent}
    if not (rel <= WAITK_CHECK_TOL and grad_err <= TRAIN_REF_TOL[1]
            and (device == "cpu" or min(xent) > 0)):
        raise AssertionError(f"lightconv card vs CPU: {result}")
    return result


def waitk_phases(seed, device="cuda"):
    """The simultaneous-translation and LightConv group under
    ``build/waitk_smoke/`` (removed after), with each phase's wall
    seconds.  Returns the launch counts by path."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "waitk_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    stages, launches = {}, {}
    try:
        start = time.perf_counter()
        train, pipelines, lexicon = write_bpe_corpus(
            root, np.random.RandomState(seed + 94))
        stages["write_corpus_and_bpe"] = time.perf_counter() - start
        start = time.perf_counter()
        launches["waitk_train"], model_dir = waitk_train_phase(
            seed, root, train, pipelines, device)
        stages["waitk_train"] = time.perf_counter() - start
        start = time.perf_counter()
        launches["waitk_simuleval"] = waitk_simuleval_phase(
            seed, root, model_dir, pipelines, lexicon, device)
        stages["waitk_simuleval"] = time.perf_counter() - start
        start = time.perf_counter()
        launches["waitk_predict"] = waitk_predict_phase(
            seed, root, model_dir, lexicon, device)
        stages["waitk_predict"] = time.perf_counter() - start
        start = time.perf_counter()
        launches.update(lightconv_phases(seed, root, train, pipelines,
                                         lexicon, device))
        stages["lightconv"] = time.perf_counter() - start
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "waitk", "stage_wall_s": stages,
          "total_s": sum(stages.values())})
    return launches


# ------------------------ pretrained trunks (slice 10) ------------------ #

# the public layouts' published sizes
BERT_BASE = dict(layers=12, dim=768, heads=12, filter=3072, vocab=28996,
                 positions=512, token_types=2)
GPT2_117M = dict(layers=12, dim=768, heads=12, positions=1024, vocab=50257)
WAV2VEC2_BASE = dict(layers=12, dim=768, heads=12, filter=3072,
                     conv_channels=512, pos_kernel=128, pos_groups=16)
FAIRSEQ_WMT_EN_DE = dict(layers=6, dim=512, heads=8, filter=2048,
                         vocab=32768)


def _public_drawers(sd, rng):
    """Seeded float32 torch-layout tensors: linear weights [out, in] as
    fan-in-scaled normals, biases and tables as small normals, LayerNorm
    weights around 1."""
    def linear(name, out_dim, in_dim, bias=True):
        sd[f"{name}.weight"] = (rng.standard_normal((out_dim, in_dim),
                                                    dtype=np.float32)
                                / np.float32(math.sqrt(in_dim)))
        if bias:
            sd[f"{name}.bias"] = 0.02 * rng.standard_normal(
                out_dim, dtype=np.float32)

    def table(name, rows, dim):
        sd[name] = 0.02 * rng.standard_normal((rows, dim), dtype=np.float32)

    def layer_norm(name, dim):
        sd[f"{name}.weight"] = 1.0 + 0.1 * rng.standard_normal(
            dim, dtype=np.float32)
        sd[f"{name}.bias"] = 0.1 * rng.standard_normal(dim,
                                                       dtype=np.float32)

    return linear, table, layer_norm


def bert_state_dict(seed, cfg=BERT_BASE):
    """A seeded BERT in HuggingFace's ``BertModel`` key names and shapes
    (numpy arrays)."""
    sd = {}
    linear, table, layer_norm = _public_drawers(
        sd, np.random.default_rng(seed))
    d, f = cfg["dim"], cfg["filter"]
    table("embeddings.word_embeddings.weight", cfg["vocab"], d)
    table("embeddings.position_embeddings.weight", cfg["positions"], d)
    table("embeddings.token_type_embeddings.weight", cfg["token_types"], d)
    layer_norm("embeddings.LayerNorm", d)
    for i in range(cfg["layers"]):
        p = f"encoder.layer.{i}"
        for name in ("query", "key", "value"):
            linear(f"{p}.attention.self.{name}", d, d)
        linear(f"{p}.attention.output.dense", d, d)
        layer_norm(f"{p}.attention.output.LayerNorm", d)
        linear(f"{p}.intermediate.dense", f, d)
        linear(f"{p}.output.dense", d, f)
        layer_norm(f"{p}.output.LayerNorm", d)
    linear("pooler.dense", d, d)
    return sd


def gpt2_state_dict(seed, cfg=GPT2_117M):
    """A seeded GPT-2 in HuggingFace's ``GPT2LMHeadModel`` key names and
    shapes (``transformer.`` prefix; Conv1D weights [in, out])."""
    sd = {}
    rng = np.random.default_rng(seed)
    _, table, layer_norm = _public_drawers(sd, rng)
    d = cfg["dim"]

    def conv1d(name, in_dim, out_dim):
        sd[f"{name}.weight"] = (rng.standard_normal((in_dim, out_dim),
                                                    dtype=np.float32)
                                / np.float32(math.sqrt(in_dim)))
        sd[f"{name}.bias"] = 0.02 * rng.standard_normal(out_dim,
                                                        dtype=np.float32)

    table("transformer.wte.weight", cfg["vocab"], d)
    table("transformer.wpe.weight", cfg["positions"], d)
    for i in range(cfg["layers"]):
        p = f"transformer.h.{i}"
        layer_norm(f"{p}.ln_1", d)
        conv1d(f"{p}.attn.c_attn", d, 3 * d)
        conv1d(f"{p}.attn.c_proj", d, d)
        layer_norm(f"{p}.ln_2", d)
        conv1d(f"{p}.mlp.c_fc", d, 4 * d)
        conv1d(f"{p}.mlp.c_proj", 4 * d, d)
    layer_norm("transformer.ln_f", d)
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd


def wav2vec2_state_dict(seed, cfg=WAV2VEC2_BASE):
    """A seeded wav2vec 2.0 in HuggingFace's ``Wav2Vec2Model`` key names
    and shapes (``wav2vec2.`` prefix; the weight-normed positional
    convolution as ``weight_g`` [1, 1, k] and ``weight_v``)."""
    sd = {}
    rng = np.random.default_rng(seed)
    linear, _, layer_norm = _public_drawers(sd, rng)
    d, c, f = cfg["dim"], cfg["conv_channels"], cfg["filter"]
    in_ch = 1
    for i, k in enumerate((10, 3, 3, 3, 3, 2, 2)):
        sd[f"wav2vec2.feature_extractor.conv_layers.{i}.conv.weight"] = (
            rng.standard_normal((c, in_ch, k), dtype=np.float32)
            / np.float32(math.sqrt(in_ch * k)))
        in_ch = c
    layer_norm("wav2vec2.feature_extractor.conv_layers.0.layer_norm", c)
    layer_norm("wav2vec2.feature_projection.layer_norm", c)
    linear("wav2vec2.feature_projection.projection", d, c)
    k, groups = cfg["pos_kernel"], cfg["pos_groups"]
    pc = "wav2vec2.encoder.pos_conv_embed.conv"
    sd[f"{pc}.weight_v"] = rng.standard_normal((d, d // groups, k),
                                               dtype=np.float32)
    sd[f"{pc}.weight_g"] = (1.0 + 0.1 * rng.standard_normal(
        (1, 1, k), dtype=np.float32)) / np.float32(math.sqrt(d // groups))
    sd[f"{pc}.bias"] = 0.02 * rng.standard_normal(d, dtype=np.float32)
    layer_norm("wav2vec2.encoder.layer_norm", d)
    for i in range(cfg["layers"]):
        p = f"wav2vec2.encoder.layers.{i}"
        for name in ("q", "k", "v", "out"):
            linear(f"{p}.attention.{name}_proj", d, d)
        layer_norm(f"{p}.layer_norm", d)
        linear(f"{p}.feed_forward.intermediate_dense", f, d)
        linear(f"{p}.feed_forward.output_dense", d, f)
        layer_norm(f"{p}.final_layer_norm", d)
    return sd


def fairseq_transformer_state_dict(seed, cfg=FAIRSEQ_WMT_EN_DE,
                                   in_proj=False):
    """A seeded fairseq ``transformer_wmt_en_de`` (post-norm, no final
    LayerNorms) in fairseq's key names and shapes; ``in_proj`` writes the
    older fused ``in_proj_weight`` / ``in_proj_bias`` attention layout."""
    sd = {}
    linear, table, layer_norm = _public_drawers(
        sd, np.random.default_rng(seed))
    d, f = cfg["dim"], cfg["filter"]

    def attention(p):
        if in_proj:
            linear(p, 3 * d, d)
            sd[f"{p}.in_proj_weight"] = sd.pop(f"{p}.weight")
            sd[f"{p}.in_proj_bias"] = sd.pop(f"{p}.bias")
        else:
            for name in ("k", "v", "q"):
                linear(f"{p}.{name}_proj", d, d)
        linear(f"{p}.out_proj", d, d)

    for side in ("encoder", "decoder"):
        table(f"{side}.embed_tokens.weight", cfg["vocab"], d)
        for i in range(cfg["layers"]):
            p = f"{side}.layers.{i}"
            attention(f"{p}.self_attn")
            layer_norm(f"{p}.self_attn_layer_norm", d)
            if side == "decoder":
                attention(f"{p}.encoder_attn")
                layer_norm(f"{p}.encoder_attn_layer_norm", d)
            linear(f"{p}.fc1", f, d)
            linear(f"{p}.fc2", d, f)
            layer_norm(f"{p}.final_layer_norm", d)
    sd["decoder.output_projection.weight"] = sd["decoder.embed_tokens.weight"]
    return sd


def save_torch_checkpoint(path, state, fairseq=False):
    """``state`` (numpy arrays) as a torch checkpoint: the state dict
    itself, or fairseq's {"args", "model"} with its training args as an
    ``argparse.Namespace``."""
    import torch
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in state.items()}
    if fairseq:
        tensors = {"args": argparse.Namespace(
            arch="transformer_wmt_en_de", share_all_embeddings=False),
            "model": tensors}
    torch.save(tensors, path)
    return path


REFERENCE_GOLDENS = os.path.join("tests", "fixtures", "reference_goldens")
# fixture dir -> (golden, corpus dir or None for a speech golden)
GOLDEN_CORPORA = {
    "corpus_tf_ckpt": ("corpus_golden.json", "tests/examples"),
    "corpus_tf_ckpt_postnorm": ("corpus_golden_postnorm.json",
                                "tests/examples"),
    "corpus_tf_ckpt_wide": ("corpus_golden_wide.json",
                            "tests/examples/wide"),
    "speech_corpus_tf_ckpt": ("speech_corpus_golden.npz", None),
    "speech_corpus_tf_ckpt_wide": ("speech_corpus_golden_wide.npz", None),
    "tf_ckpt": ("transformer_toy_prenorm.npz", None),
}


def _until_eos(row, eos):
    out = []
    for t in row:
        out.append(int(t))
        if t == eos:
            break
    return out


def _golden_text(root, flat, golden, corpus, device):
    """The text golden: the converted model decodes the corpus's dev set
    in batches of 8 with the golden's search; hypotheses as strings."""
    from neurst_tpu_torch import build_model, build_search_layer
    from neurst_tpu_torch.data.data_pipelines import build_data_pipeline
    from neurst_tpu_torch.utils.param_bridge import load_flat_params
    pipeline = build_data_pipeline({
        "data_pipeline.class": "TextDataPipeline",
        "data_pipeline.params": {"vocab_path": os.path.join(
            root, corpus, "vocab.txt")}})
    model = build_model({"model.class": "transformer", "model.params": dict(
        golden["model_params"], dtype="float32")}, src_meta=pipeline.meta,
        trg_meta=pipeline.meta, device=device)
    load_flat_params(model, flat)
    search = build_search_layer({
        "search_method.class": "beam_search",
        "search_method.params": dict(golden["search_params"])})
    search.set_model(model)
    eos, bos = pipeline.meta["eos_id"], pipeline.meta["bos_id"]
    with open(os.path.join(root, corpus, "dev.src")) as f:
        lines = [line.rstrip("\n") for line in f]
    hypos = []
    for start in range(0, len(lines), 8):
        ids = [pipeline.encode(s, is_processed=True)
               for s in lines[start:start + 8]]
        width = max(len(x) for x in ids)
        src = np.full([len(ids), width], eos, np.int64)
        padding = np.ones([len(ids), width], np.float32)
        for i, x in enumerate(ids):
            src[i, :len(x)], padding[i, :len(x)] = x, 0.0
        out, _ = search({"src": src, "src_padding": padding,
                         "trg_input": np.full([len(ids)], bos, np.int64)})
        hypos += [pipeline.decode(row) for row in out.cpu().tolist()]
    return hypos, golden["hypotheses"]


def _golden_speech(flat, golden, device):
    """The speech golden: the converted model beam-decodes the golden's
    features; ids up to the first EOS."""
    import torch

    from neurst_tpu_torch import build_model
    from neurst_tpu_torch.layers.search.beam_search import \
        sequence_beam_search
    from neurst_tpu_torch.utils.param_bridge import load_flat_params
    feats, lengths, ref = golden["feats"], golden["lengths"], \
        golden["hypo_ids"]
    meta = json.loads(bytes(golden["__meta__"]).decode())
    model = build_model({"model.class": "speech_transformer",
                         "model.params": dict(meta["model_params"],
                                              dtype="float32")},
                        src_meta=meta["src_meta"], trg_meta=meta["trg_meta"],
                        device=device)
    load_flat_params(model, flat)
    sp = meta["search_params"]
    with torch.no_grad():
        s2l, init = model.prepare_generation(
            {"src": feats.astype(np.float32),
             "src_length": lengths.astype(np.int64)},
            sp["maximum_decode_length"])
        hypos, _ = sequence_beam_search(
            s2l, init, beam_size=sp["beam_size"], top_k=1,
            length_penalty=sp["length_penalty"],
            maximum_decode_length=sp["maximum_decode_length"],
            extra_decode_length=sp["extra_decode_length"],
            minimum_decode_length=sp["minimum_decode_length"])
    eos = meta["trg_meta"]["eos_id"]
    ours = hypos.cpu().numpy()
    return ([_until_eos(r, eos) for r in ours],
            [_until_eos(r[:ours.shape[1]], eos) for r in ref])


def _golden_toy(flat, blob, device):
    """``tf_ckpt``: the converted toy Transformer's teacher-forced logits
    (non-padded positions, within 5e-5) and its beam-4 ids against the
    golden's."""
    import torch

    from neurst_tpu_torch import build_model
    from neurst_tpu_torch.layers.search.beam_search import \
        sequence_beam_search
    from neurst_tpu_torch.models.transformer import Transformer
    from neurst_tpu_torch.utils.param_bridge import load_flat_params
    meta = json.loads(bytes(blob["__meta__"]).decode())
    params = dict(Transformer.build_model_args_by_name(
        "transformer_toy")["model.params"], dtype="float32")
    for side in ("encoder", "decoder"):
        params.update({f"{side}.attention_dropout_rate": 0.0,
                       f"{side}.ffn_dropout_rate": 0.0,
                       f"{side}.layer_postprocess_dropout_rate": 0.0,
                       f"{side}.post_normalize": bool(meta["post_norm"])})
    model = build_model({"model.class": "transformer",
                         "model.params": params}, src_meta=meta["src_meta"],
                        trg_meta=meta["trg_meta"], device=device)
    load_flat_params(model, flat)
    src = blob["__input__/src"].astype(np.int64)
    padding = blob["__input__/src_padding"]
    with torch.no_grad():
        logits = model({"src": src, "src_padding": padding,
                        "trg_input": blob["__input__/trg_input"].astype(
                            np.int64)}).cpu().numpy()
        s2l, init = model.prepare_generation(
            {"src": src, "src_padding": padding}, 10)
        hypos, _ = sequence_beam_search(
            s2l, init, beam_size=4, top_k=1, length_penalty=0.6,
            maximum_decode_length=10, extra_decode_length=5,
            minimum_decode_length=5)
    nonpad = (1.0 - blob["__input__/trg_padding"])[:, :, None]
    err = float(np.abs((logits - blob["__output__/logits"]) * nonpad).max())
    if err >= 5e-5:
        raise AssertionError(f"tf_ckpt logits off by {err}")
    ref = blob["__output__/beam_top1_ids"]
    eos = meta["trg_meta"]["eos_id"]
    ours = hypos.cpu().numpy()
    return ([_until_eos(r, eos) for r in ours[:, :ref.shape[1]]],
            [_until_eos(r, eos) for r in ref])


def reference_golden_decodes(device="cuda", root=None):
    """Every original-NeurST TF fixture under ``REFERENCE_GOLDENS``,
    converted by the port's TF-free reader and decoded by the port in
    float32 on ``device``: {fixture: {"matched", "total", "convert_s",
    "decode_s"}}.  Raises unless every hypothesis equals its golden."""
    from neurst_tpu_torch.utils.converters import build_converter
    root = root or os.path.dirname(os.path.abspath(__file__))
    out = {}
    for fixture, (name, corpus) in sorted(GOLDEN_CORPORA.items()):
        path = os.path.join(root, REFERENCE_GOLDENS, name)
        if corpus is not None:
            with open(path) as f:
                golden = json.load(f)
        else:
            with np.load(path) as d:
                golden = {k: d[k] for k in d.files}
        heads = golden["num_heads"] if corpus is not None else json.loads(
            bytes(golden["__meta__"]).decode())["num_heads"]
        start = time.perf_counter()
        flat = build_converter({"converter.class": "neurst_transformer",
                                "converter.params": {"num_heads": heads}}
                               ).convert_to_flat(os.path.join(
                                   root, REFERENCE_GOLDENS, fixture))
        convert_s = time.perf_counter() - start
        start = time.perf_counter()
        if corpus is not None:
            ours, want = _golden_text(root, flat, golden, corpus, device)
        elif fixture == "tf_ckpt":
            ours, want = _golden_toy(flat, golden, device)
        else:
            ours, want = _golden_speech(flat, golden, device)
        matched = sum(a == b for a, b in zip(ours, want))
        out[fixture] = {"matched": matched, "total": len(want),
                        "variables": len(flat), "convert_s": convert_s,
                        "decode_s": time.perf_counter() - start}
        if matched != len(want) or len(ours) != len(want):
            raise AssertionError(f"{fixture}: {matched} of {len(want)} "
                                 f"hypotheses equal the golden")
    return out


def convert_phase(seed, root):
    """Four seeded public-layout state dicts at their published sizes
    (``BERT_BASE``, ``GPT2_117M``, ``WAV2VEC2_BASE``,
    ``FAIRSEQ_WMT_EN_DE``), each written with ``torch.save`` and converted
    by ``python -m neurst_tpu_torch.cli.convert_checkpoint`` in a
    subprocess, the four side by side: seconds and bytes of each.  Returns
    {kind: (torch checkpoint, converted dir)}."""
    cases = [("bert", "google_bert", BERT_BASE["heads"],
              lambda: {f"bert.{k}": v for k, v in
                       bert_state_dict(seed + 100, BERT_BASE).items()},
              False),
             ("gpt2", "openai_gpt2", GPT2_117M["heads"],
              lambda: gpt2_state_dict(seed + 101, GPT2_117M), False),
             ("wav2vec2", "fairseq_wav2vec2", WAV2VEC2_BASE["heads"],
              lambda: wav2vec2_state_dict(seed + 102, WAV2VEC2_BASE), False),
             ("fairseq", "fairseq_transformer", FAIRSEQ_WMT_EN_DE["heads"],
              lambda: fairseq_transformer_state_dict(
                  seed + 103, FAIRSEQ_WMT_EN_DE), True)]
    rows, out, procs = {}, {}, {}
    for kind, converter, heads, draw, fairseq in cases:
        start = time.perf_counter()
        state = draw()
        pt = save_torch_checkpoint(os.path.join(root, f"{kind}.pt"), state,
                                   fairseq=fairseq)
        rows[kind] = {"converter": converter, "parameters": int(sum(
            v.size for k, v in state.items()
            if not k.endswith("lm_head.weight"))),
            "write_torch_s": time.perf_counter() - start,
            "torch_bytes": os.path.getsize(pt)}
        del state
        out[kind] = (pt, os.path.join(root, f"{kind}_ckpt"))
    for kind, converter, heads, _, _ in cases:
        procs[kind] = (time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "neurst_tpu_torch.cli.convert_checkpoint",
             "--converter", converter, "--from_path", out[kind][0],
             "--to_path", out[kind][1], "--num_heads", str(heads)],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    for kind, (start, proc) in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode:
            raise AssertionError(f"convert {kind}: {err[-2000:]}")
        npz = os.path.join(out[kind][1], "ckpt-0.npz")
        with np.load(npz) as data:
            rows[kind].update(convert_s=time.perf_counter() - start,
                              names=len(data.files),
                              npz_bytes=os.path.getsize(npz))
    emit({"phase": "convert", "concurrent": True, "sizes": {
        "bert": BERT_BASE, "gpt2": GPT2_117M, "wav2vec2": WAV2VEC2_BASE,
        "fairseq": FAIRSEQ_WMT_EN_DE}, **rows})
    return out


def reference_golden_phase(device="cuda"):
    """The original NeurST's TF-trained fixtures converted without
    TensorFlow and decoded by the port on the card in float32: every
    hypothesis equals its golden."""
    start = time.perf_counter()
    result = reference_golden_decodes(device)
    emit({"phase": "reference_golden", "dtype": "float32",
          "wall_s": time.perf_counter() - start,
          "matched": sum(r["matched"] for r in result.values()),
          "total": sum(r["total"] for r in result.values()),
          "fixtures": result})


TRUNK_KERNELS = ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv", "fused_linear_xent_fwd",
                 "fused_linear_xent_bwd", "fused_softmax_xent_fwd",
                 "fused_softmax_xent_bwd", "fused_dropout", "fused_ffn_fwd",
                 "fused_ffn_bwd")


def _stack_sites(stack):
    """Dropout sites of one step of a dense transformer stack (none of
    the trunks' stacks runs flash or the fused FFN): per layer the
    attention weights of each attention, a postprocess output per
    sublayer and the FFN hidden, each where its rate is > 0."""
    sites = 0
    for i in range(stack.num_layers):
        layer = getattr(stack, f"layer_{i}")
        attentions = [layer.self_attention]
        if getattr(layer, "with_cross_attention", False):
            attentions.append(layer.cross_attention)
        sites += sum(a.attention_dropout_rate > 0 for a in attentions)
        if layer.layer_postprocess_dropout_rate > 0:
            sites += len(attentions) + 1
        sites += layer.ffn.dropout_rate > 0
    return sites


def trunk_expected_launches(model):
    """Kernel launches of one training step of CTNMT or GPT-2: the mask
    kernel at each dropout site forward and backward (CTNMT's BERT trunk
    forward only in bert_distillation, whose teacher states are detached),
    and nothing else: no flash (the stacks are dense, as in the JAX
    models), no fused FFN (the JAX gate fuses relu at D 256 and 512;
    these run D 768), no fused xent (neither model takes prelogits, as
    the JAX gate decides)."""
    from neurst_tpu_torch.ops.fused_ffn import fused_ffn_available
    stacks = [s for s in (getattr(model, "encoder", None), model.decoder)
              if s is not None]
    for stack in stacks + ([model.bert.encoder]
                           if hasattr(model, "bert") else []):
        ffn = stack.layer_0.ffn
        if fused_ffn_available(ffn.dense1.in_features,
                               ffn.dense1.out_features, ffn.activation,
                               1 << 20, True, ffn.dropout_rate):
            raise AssertionError("a trunk stack would take the fused FFN")
    if model.supports_fused_softmax_ce():
        raise AssertionError("a trunk model would take the fused xent")
    forward = backward = sum(_stack_sites(s) for s in stacks)
    if hasattr(model, "bert"):
        bert = _stack_sites(model.bert.encoder)
        forward += bert
        backward += 0 if model.bert_mode == "bert_distillation" else bert
    expected = {k: 0 for k in TRUNK_KERNELS}
    expected["fused_dropout"] = forward + backward
    return expected


def _trunk_step_checks(seen, model):
    """Every step's launches equal ``trunk_expected_launches`` and
    nothing launched outside the steps.  Returns a step's launches."""
    expected = trunk_expected_launches(model)
    total = {}
    for s in seen["steps"]:
        got = {k: s["launches"][k] for k in expected}
        if got != expected:
            raise AssertionError(f"step of {s['trg']}: launches {got}, "
                                 f"expected {expected}")
        for k, v in s["launches"].items():
            total[k] = total.get(k, 0) + v
    if total != seen["launches"]:
        raise AssertionError(f"launches outside the train steps: "
                             f"{seen['launches']} against {total}")
    return expected


def _restored_count(seen):
    """(restored, total) of the trainer's pretrain restore log line."""
    for m in seen["messages"]:
        found = re.match(r"Restored (\d+)/(\d+) parameters", m)
        if found:
            return int(found.group(1)), int(found.group(2))
    raise AssertionError("the trainer restored no pretrain model")


# examples/ctnmt/example_configs/*.yml at their widths: BERT-base (12 x 768,
# 12 heads) beside a 12-layer encoder and a 6-layer decoder of 768, Adam
# (0.9, 0.98, 1e-9), noam (768, 4000), 8000-token buckets of 10-100
# tokens; TextDataPipeline word vocabularies (the recipes' BERT vocab and
# spm need files and sentencepiece the card lacks), no validator (the
# recipe's first validation is at step 1000)
CTNMT = dict(recipe_dir=os.path.join("examples", "ctnmt", "example_configs"),
             src_vocab=BERT_BASE["vocab"], trg_vocab=16384, pairs=3000,
             min_tokens=10, max_tokens=100, steps=30, summary=5,
             predict_lines=32, mode_steps=1, check_batch=2, check_length=16,
             model_params={})
CTNMT_PREDICT = {"beam_size": 8, "length_penalty": 0.6,
                 "extra_decode_length": 50, "maximum_decode_length": 200}
CTNMT_CHECK_TOL = 1e-4


def ctnmt_config(path, recipe, pipelines, train, bert_dir, steps,
                 summary):
    """The recipe as it is but its data (``TextDataPipeline`` a side, the
    seeded pairs), ``pretrain_model`` (the ``bert/``-prefixed BERT dir),
    the step counts and no validator."""
    import yaml
    with open(os.path.join(CTNMT["recipe_dir"], recipe)) as f:
        cfg = yaml.safe_load(f)
    task = dict(cfg["task.params"])
    for side in ("src", "trg"):
        task[f"{side}_data_pipeline.class"] = "TextDataPipeline"
        task[f"{side}_data_pipeline.params"] = pipelines[side]
    entry = {k: v for k, v in cfg["entry.params"].items()
             if not k.startswith("validator")}
    # one checkpoint, the trainer's final save (a save at the last step
    # would write the same ~4.4 GB of weights and optimizer state twice)
    entry.update(train_steps=steps, summary_steps=summary,
                 save_checkpoint_steps=steps + 1, pretrain_model=[bert_dir],
                 enable_tensorboard=False)
    with open(path, "w") as f:
        json.dump({"task.class": cfg["task.class"], "task.params": task,
                   "dataset.class": "parallel_text",
                   "dataset.params": _parallel(train),
                   "model.class": cfg["model.class"],
                   "model.params": dict(cfg["model.params"],
                                        **CTNMT["model_params"]),
                   "entry.class": "trainer", "entry.params": entry}, f,
                  indent=1)
    return path


def _peak_bytes(device):
    import torch
    return torch.cuda.max_memory_allocated() if device == "cuda" else None


def _reset_peak(device):
    import torch
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def ctnmt_phases(seed, root, bert_pt, device="cuda"):
    """The slice's main path: the dynamic-switch recipe trains with its
    BERT restored from the converted BERT-base and frozen, then predicts;
    one step each of the rate_schedule (bert_as_encoder) and
    asy_distillation (bert_distillation + the KD criterion) recipes; a
    float32 card-vs-CPU loss.  Returns the launch counts by path."""
    import torch

    from neurst_tpu_torch import build_criterion, build_model
    from neurst_tpu_torch.cli import run_exp
    from neurst_tpu_torch.layers.auto_pretrained_layer import \
        load_pretrained_flat
    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
    from neurst_tpu_torch.tasks.translation import Translation
    from neurst_tpu_torch.utils.checkpoints import (latest_checkpoint,
                                                    restore_checkpoint_params,
                                                    save_checkpoint)
    from neurst_tpu_torch.utils.configurable import ModelConfigs
    from neurst_tpu_torch.utils.param_bridge import (load_flat_params,
                                                     state_dict_to_flat)
    from neurst_tpu_torch.utils.rng import make_key

    c = CTNMT
    start = time.perf_counter()
    rng = np.random.RandomState(seed + 110)
    words, pipelines = {}, {}
    for side, size in (("src", c["src_vocab"]), ("trg", c["trg_vocab"])):
        vocab = os.path.join(root, f"ctnmt_vocab.{side}")
        words[side] = write_word_vocab(vocab, rng, size - 3)
        pipelines[side] = {"vocab_path": vocab}
    train = write_parallel(os.path.join(root, "ctnmt_train"), rng,
                           words["src"], words["trg"], c["pairs"],
                           c["min_tokens"], c["max_tokens"])
    dev = write_parallel(os.path.join(root, "ctnmt_dev"), rng, words["src"],
                         words["trg"], c["predict_lines"], c["min_tokens"],
                         c["max_tokens"])
    # the converted BERT-base under CTNMT's ``bert/`` (load_pretrained_flat
    # then the prefix, as load_pretrained_into(..., to_prefix="bert/"))
    bert = {"bert/" + k: v for k, v in load_pretrained_flat(
        bert_pt, "bert", BERT_BASE["heads"]).items()}
    bert_dir = os.path.join(root, "bert_prefixed")
    save_checkpoint(bert_dir, 0, bert, max_to_keep=None)
    write_s = time.perf_counter() - start

    launches = {}
    rows = {}
    main_dir = os.path.join(root, "ctnmt_trainer")
    for name, recipe, steps in (
            ("ctnmt_trainer", "dynamic_switch.yml", c["steps"]),
            ("ctnmt_bert_as_encoder", "rate_schedule.yml", c["mode_steps"]),
            ("ctnmt_distillation", "asy_distillation.yml",
             c["mode_steps"])):
        cfg = ctnmt_config(os.path.join(root, f"{name}.json"), recipe,
                           pipelines, train, bert_dir, steps, c["summary"]
                           if steps > c["summary"] else 1)
        # the one-step mode runs write no model dir (no checkpoint)
        argv = ["--config_paths", cfg, "--device", device] + (
            ["--model_dir", main_dir] if name == "ctnmt_trainer" else [])
        _reset_peak(device)
        state, seen = run_trainer(argv, Translation)
        _train_path_checks(seen, steps, name)
        model = seen["model"]
        n_bert = sum(1 for n, _ in model.named_parameters()
                     if n.startswith("bert."))
        restored = _restored_count(seen)
        if restored[0] != n_bert or n_bert != 7 + 12 * BERT_BASE["layers"]:
            raise AssertionError(f"{name}: restored {restored} of "
                                 f"{n_bert} BERT parameters")
        per_step = _trunk_step_checks(seen, model)
        launches[name] = seen["launches"]
        # bf16 stored params start from bf16(pretrain) and keep it: the
        # float32 master of every frozen BERT weight (what a checkpoint
        # saves) is that value after the steps
        master = state_dict_to_flat(model, state.opt_state["master"])
        moved = [k for k in bert if not np.array_equal(
            master[k], torch.from_numpy(bert[k]).bfloat16().float().numpy())]
        if moved:
            raise AssertionError(f"{name}: frozen BERT moved: {moved[:4]}")
        row = dict(_trainer_numbers(seen, _peak_bytes(device)),
                   recipe=os.path.join(c["recipe_dir"], recipe),
                   bert_mode=model.bert_mode,
                   bert_restored=restored[0], launches_per_step=per_step,
                   step_ms=[None] + [1e3 * w["secs_per_step"]
                                     for w in seen["windows"]],
                   losses=[s["loss"] for s in seen["steps"]])
        if name == "ctnmt_distillation":
            crit = build_criterion({
                "criterion.class": "label_smoothed_cross_entropy_with_kd",
                "criterion.params": {"label_smoothing": 0.1,
                                     "kd_weight": 0.5}})
            batch = nmt_batch(np.random.RandomState(seed + 111), device,
                              c["check_batch"], c["check_length"],
                              c["src_vocab"], c["trg_vocab"])
            with torch.no_grad():
                out, _ = model.call_train(batch, False, make_key(seed))
                row["kd_term"] = float(crit._kd_term(batch, out))
            if not (math.isfinite(row["kd_term"]) and row["kd_term"] > 0):
                raise AssertionError(f"KD term {row['kd_term']}")
        if not all(math.isfinite(x) for x in row["losses"]):
            raise AssertionError(f"{name}: losses {row['losses']}")
        rows[name] = row
        del model, seen, state

    # predict: the recipe validator's search over 64 dev sentences
    argv = ["--entry", "predict", "--model_dir", main_dir,
            "--dataset.class", "parallel_text", "--dataset.params",
            json.dumps(_parallel(dev)), "--search_method.params",
            json.dumps(CTNMT_PREDICT), "--metric", "bleu",
            "--device", device]
    reset_launch_counts()
    start = time.perf_counter()
    result = run_exp.cli_main(argv)
    predict_s = time.perf_counter() - start
    launches["ctnmt_predict"] = launch_counts()
    if result["samples"] != c["predict_lines"] or any(
            launches["ctnmt_predict"].values()):
        raise AssertionError(f"ctnmt predict: {result['samples']} samples, "
                             f"launches {launches['ctnmt_predict']}")

    # float32 loss of one fixed batch on the card and on the CPU
    cfg = ModelConfigs.load(main_dir)
    flat = restore_checkpoint_params(latest_checkpoint(main_dir))
    losses = {}
    for dev_name in (device, "cpu"):
        src_meta = {"vocab_size": c["src_vocab"], "eos_id": 1, "bos_id": 2}
        trg_meta = {"vocab_size": c["trg_vocab"], "eos_id": 1, "bos_id": 2}
        model = build_model({"model.class": cfg["model.class"],
                             "model.params": dict(cfg["model.params"],
                                                  dtype="float32")},
                            src_meta=src_meta, trg_meta=trg_meta,
                            device=dev_name)
        load_flat_params(model, flat)
        batch = nmt_batch(np.random.RandomState(seed + 112), dev_name,
                          c["check_batch"], c["check_length"],
                          c["src_vocab"], c["trg_vocab"])
        crit = build_criterion({"criterion.class":
                                "label_smoothed_cross_entropy",
                                "criterion.params": {"label_smoothing": 0.1}})
        with torch.no_grad():
            losses[dev_name] = float(crit.reduce_loss(batch, model(batch)))
        del model
    rel = abs(losses[device] - losses["cpu"]) / abs(losses["cpu"])
    emit({"phase": "ctnmt", "reduced": {
        "data": "seeded word-level pairs through TextDataPipeline (the "
                "recipes' BertDataPipeline vocab and spm need files and "
                "sentencepiece the card lacks)",
        "steps": {k: len(r["losses"]) for k, r in rows.items()},
        "validator": "none (the recipe's first is at step 1000)"},
        "pairs": c["pairs"], "tokens_a_sentence": [c["min_tokens"],
                                                   c["max_tokens"]],
        "vocab": [c["src_vocab"], c["trg_vocab"]],
        "write_inputs_s": write_s, **rows,
        "predict": {"search": CTNMT_PREDICT, "samples": result["samples"],
                    "samples_per_s": result["samples_per_sec"],
                    "wall_s": predict_s, "timing_s": result["timing"],
                    "BLEU": result.get("BLEU")},
        "float32_check": {"loss": losses[device], "cpu_loss": losses["cpu"],
                          "rel_err": rel, "tol": CTNMT_CHECK_TOL}})
    if rel > CTNMT_CHECK_TOL:
        raise AssertionError(f"ctnmt float32 loss on the card {losses}")
    return launches


# GPT-2 117M language modelling (``--hparams_set gpt2_117m``) from the
# converted GPT-2: TextDataPipeline over a seeded 50,257-entry vocabulary
# whose last entry is its eos (where GPT-2 has <|endoftext|>);
# 256-1024-token sequences in 8192-token buckets, the hparams set's
# dropout 0.1
GPT2_LM = dict(hparams_set="gpt2_117m", vocab=GPT2_117M["vocab"],
               train_lines=300, heldout_lines=32, min_tokens=256,
               max_tokens=1024, batch_tokens=8192, steps=20, summary=5,
               prompts=16, min_prompt=16, max_prompt=64, continuation=64,
               check_prompt=32)
GPT2_CHECK_TOL = 1e-3


def write_mono(path, rng, words, n, min_tokens, max_tokens):
    """``n`` lines of random words, each ``min_tokens``-``max_tokens``
    tokens with its EOS."""
    with open(path, "w") as f:
        for length in rng.randint(min_tokens, max_tokens + 1, size=n):
            f.write(" ".join(words[i] for i in rng.randint(
                len(words), size=int(length) - 1)) + "\n")
    return path


def gpt2_lm_phases(seed, root, gpt2_dir, device="cuda"):
    """GPT-2 117M through ``run_exp``: train from the converted
    checkpoint, eval (PPL on held-out text), predict (prompts continued
    by beam 4 and by top_sampling), spec_gpt2 on the trained dir, and
    float32 logits of one prompt on the card against the CPU.  Returns
    the launch counts by path."""
    import torch

    from neurst_tpu_torch import build_model
    from neurst_tpu_torch.cli import run_exp
    from neurst_tpu_torch.models.gpt2 import GPT2
    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
    from neurst_tpu_torch.tasks.language_model import LanguageModel
    from neurst_tpu_torch.utils.checkpoints import (latest_checkpoint,
                                                    restore_checkpoint_params)
    from neurst_tpu_torch.utils.param_bridge import load_flat_params

    g = GPT2_LM
    start = time.perf_counter()
    rng = np.random.RandomState(seed + 120)
    vocab = os.path.join(root, "gpt2_vocab.txt")
    # the pipeline appends <UNK>, <SEQ_BEG> and <SEQ_END>: the eos is the
    # last id, as GPT-2's <|endoftext|> (binding that string through
    # ``eos_id`` does not survive into model_configs.yml: ROADMAP R12)
    words = write_word_vocab(vocab, rng, g["vocab"] - 3)
    pipeline = {"vocab_path": vocab}
    train = write_mono(os.path.join(root, "lm_train.txt"), rng, words,
                       g["train_lines"], g["min_tokens"], g["max_tokens"])
    heldout = write_mono(os.path.join(root, "lm_heldout.txt"), rng, words,
                         g["heldout_lines"], g["min_tokens"],
                         g["max_tokens"])
    prompts = write_mono(os.path.join(root, "lm_prompts.txt"), rng, words,
                         g["prompts"], g["min_prompt"], g["max_prompt"])
    write_s = time.perf_counter() - start
    cfg = os.path.join(root, "lm.json")
    with open(cfg, "w") as f:
        json.dump({
            "task.class": "lm",
            "task.params": {"data_pipeline.class": "TextDataPipeline",
                            "data_pipeline.params": pipeline,
                            "batch_by_tokens": True,
                            "batch_size": g["batch_tokens"],
                            "max_trg_len": g["max_tokens"]},
            "dataset.class": "mono_text",
            "dataset.params": {"data_file": train},
            "hparams_set": g["hparams_set"], "entry.class": "trainer",
            "entry.params": {
                "criterion.class": "label_smoothed_cross_entropy",
                "optimizer.class": "adam",
                "optimizer.params": {"epsilon": 1e-8, "beta_1": 0.9,
                                     "beta_2": 0.999},
                "lr_schedule.class": "constant",
                "lr_schedule.params": {"learning_rate": 1e-4},
                "pretrain_model": [gpt2_dir], "train_steps": g["steps"],
                "summary_steps": g["summary"],
                "save_checkpoint_steps": g["steps"] + 1,
                "enable_tensorboard": False}}, f, indent=1)
    model_dir = os.path.join(root, "lm_model")
    _reset_peak(device)
    _, seen = run_trainer(["--config_paths", cfg, "--model_dir", model_dir,
                           "--device", device], LanguageModel)
    _train_path_checks(seen, g["steps"], "gpt2_trainer")
    model = seen["model"]
    restored = _restored_count(seen)
    n_params = sum(1 for _ in model.parameters())
    if restored[0] != n_params:
        raise AssertionError(f"gpt2: restored {restored} of {n_params}")
    per_step = _trunk_step_checks(seen, model)
    train_row = dict(_trainer_numbers(seen, _peak_bytes(device)),
                     restored=restored[0], launches_per_step=per_step)
    del model, seen
    launches = {"gpt2_trainer": launch_counts()}

    evaluated = run_exp.cli_main([
        "--entry", "eval", "--model_dir", model_dir, "--dataset.class",
        "mono_text", "--dataset.params", json.dumps({"data_file": heldout}),
        "--batch_size", "8", "--device", device])
    predict = {}
    reset_launch_counts()
    for name, method, params in (
            ("beam4", "beam_search", {"beam_size": 4}),
            ("top_sampling", "top_sampling", {"top_k": 8, "seed": seed})):
        start = time.perf_counter()
        result = run_exp.cli_main([
            "--entry", "predict", "--model_dir", model_dir,
            "--dataset.class", "mono_text", "--dataset.params",
            json.dumps({"data_file": prompts}), "--search_method", method,
            "--search_method.params", json.dumps(dict(
                params, maximum_decode_length=g["continuation"])),
            "--batch_size", str(g["prompts"]), "--device", device])
        predict[name] = {"samples": result["samples"],
                         "samples_per_s": result["samples_per_sec"],
                         "wall_s": time.perf_counter() - start,
                         "timing_s": result["timing"]}
        if result["samples"] != g["prompts"]:
            raise AssertionError(f"gpt2 {name}: {result['samples']}")
    launches["gpt2_predict"] = launch_counts()
    launches["spec_gpt2"] = spec_gpt2_phase(root, model_dir, prompts,
                                            device)

    # float32 logits of one prompt, card against CPU
    flat = restore_checkpoint_params(latest_checkpoint(model_dir))
    ids = np.random.RandomState(seed + 121).randint(
        4, g["vocab"], size=(1, g["check_prompt"]))
    logits = {}
    for dev_name in (device, "cpu"):
        model = build_model({"model.class": "gpt2", "model.params": dict(
            GPT2.build_model_args_by_name(g["hparams_set"])["model.params"],
            dtype="float32")}, trg_meta={"vocab_size": g["vocab"],
                                         "eos_id": g["vocab"] - 1},
            device=dev_name)
        load_flat_params(model, flat)
        with torch.no_grad():
            logits[dev_name] = model({"trg_input": ids}).cpu()
        del model
    rel = _rel_err(logits[device], logits["cpu"])
    emit({"phase": "gpt2_lm", "hparams_set": g["hparams_set"], "dtype":
          "bfloat16", "dropout": 0.1, "write_inputs_s": write_s,
          "lines": [g["train_lines"], g["heldout_lines"], g["prompts"]],
          "tokens_a_line": [g["min_tokens"], g["max_tokens"]],
          "train": train_row, "eval": {"PPL": evaluated["PPL"],
                                       "NLL": evaluated["NLL"]},
          "predict": predict, "predict_launches": launches["gpt2_predict"],
          "float32_check": {"rel_err": rel, "tol": GPT2_CHECK_TOL}})
    if any(launches["gpt2_predict"].values()) or rel > GPT2_CHECK_TOL \
            or not math.isfinite(evaluated["PPL"]):
        raise AssertionError("gpt2_lm phase failed")
    return launches


WAV2VEC2_INPUT = dict(batch=8, samples=160000, frames=499, iters=5)
WAV2VEC2_CHECK_TOL = 1e-3


def wav2vec2_phase(seed, w2v_dir, device="cuda"):
    """The converted wav2vec2-base forward over [8, 160000] samples
    (10 s at 16 kHz) in bf16 and float32: device ms, output frames; the
    float32 output of one utterance on the card against the CPU."""
    import torch

    from neurst_tpu_torch import build_model
    from neurst_tpu_torch.models.wav2vec2 import wav2vec2_output_length
    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
    from neurst_tpu_torch.utils.checkpoints import (latest_checkpoint,
                                                    restore_checkpoint_params)
    from neurst_tpu_torch.utils.param_bridge import load_flat_params

    w = WAV2VEC2_INPUT
    widths = {"num_layers": WAV2VEC2_BASE["layers"],
              "hidden_size": WAV2VEC2_BASE["dim"],
              "num_attention_heads": WAV2VEC2_BASE["heads"],
              "filter_size": WAV2VEC2_BASE["filter"]}
    flat = restore_checkpoint_params(latest_checkpoint(w2v_dir))
    wav = (0.1 * np.random.RandomState(seed + 130).randn(
        w["batch"], w["samples"])).astype(np.float32)
    row = {"phase": "wav2vec2", "input": [w["batch"], w["samples"]],
           "frames_expected": wav2vec2_output_length(w["samples"])}
    reset_launch_counts()
    outs = {}
    for dtype in ("bfloat16", "float32"):
        model = build_model({"model.class": "wav2vec2",
                             "model.params": dict(widths, dtype=dtype)},
                            device=device)
        load_flat_params(model, flat)
        inputs = {"src": torch.from_numpy(wav).to(device)}
        with torch.no_grad():
            out = model(inputs)
            row[f"{dtype}_ms"] = time_ms(lambda: model(inputs),
                                         iters=w["iters"], warmup=1)
        enc = out["encoder_outputs"]
        row[f"{dtype}_frames"] = int(enc.shape[1])
        if enc.shape[1] != w["frames"] or not torch.isfinite(
                enc.float()).all():
            raise AssertionError(f"wav2vec2 {dtype}: {tuple(enc.shape)}")
        if dtype == "float32":
            outs[device] = enc[:1].cpu()
            cpu = build_model({"model.class": "wav2vec2",
                               "model.params": dict(widths, dtype=dtype)},
                              device="cpu")
            load_flat_params(cpu, flat)
            with torch.no_grad():
                outs["cpu"] = cpu({"src": wav[:1]})["encoder_outputs"]
        del model
    row["launches"] = launch_counts()
    row["float32_check"] = {"rel_err": _rel_err(outs[device], outs["cpu"]),
                            "tol": WAV2VEC2_CHECK_TOL}
    emit(row)
    if row["float32_check"]["rel_err"] > WAV2VEC2_CHECK_TOL:
        raise AssertionError("wav2vec2: the card's float32 output disagrees "
                             "with the CPU's")
    return row["launches"]


def pretrained_convert(seed):
    """``convert_phase`` under a fresh ``build/pretrained_smoke/``: (root,
    its result, seconds)."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "pretrained_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    start = time.perf_counter()
    return root, convert_phase(seed, root), time.perf_counter() - start


def pretrained_phases(seed, device="cuda", prepared=None):
    """Slice 10 under ``build/pretrained_smoke/`` (removed after): convert
    (or ``prepared``, ``pretrained_convert``'s result where the conversion
    ran earlier: ``main`` runs it, host work alone, beside the QAT
    worker), reference_golden, ctnmt, gpt2_lm and wav2vec2, with each
    phase's wall seconds.  Returns the launch counts by path."""
    root, converted, convert_s = prepared or pretrained_convert(seed)
    stages, launches = {"convert": convert_s}, {}
    try:
        start = time.perf_counter()
        reference_golden_phase(device)
        stages["reference_golden"] = time.perf_counter() - start
        start = time.perf_counter()
        launches.update(ctnmt_phases(seed, root, converted["bert"][0],
                                     device))
        stages["ctnmt"] = time.perf_counter() - start
        start = time.perf_counter()
        launches.update(gpt2_lm_phases(seed, root, converted["gpt2"][1],
                                       device))
        stages["gpt2_lm"] = time.perf_counter() - start
        start = time.perf_counter()
        launches["wav2vec2"] = wav2vec2_phase(seed, converted["wav2vec2"][1],
                                              device)
        stages["wav2vec2"] = time.perf_counter() - start
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "pretrained", "stage_wall_s": stages,
          "total_s": sum(stages.values())})
    return launches


# bench.py's long-audio cells (bench.py:444-536): speech_transformer_s's
# encoder over 4 x 8192 frames (T = 2048 after the two stride-2
# convolutions), dense against flash, forward and forward + backward, bf16
LONG_AUDIO = dict(batch=4, frames=8192, lengths=(8192, 6000, 8192, 4100),
                  iters=3)


def flash_long_audio_kernel_phase(seed):
    """Flash forward, dq and dk/dv at the long-audio encoder's [4, 2048,
    4, 64] (lengths 2048, 1500, 2048, 1025; no dropout) against the plain
    versions (whose [4, 4, 2048, 2048] scores fit), f32 and bf16; the
    bf16 kernel, plain, library and bound times.  Returns {(kernel,
    dtype): row}."""
    import torch
    from torch.nn import functional as F

    from neurst_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(seed + 140)
    b, n, h = LONG_AUDIO["batch"], 4, 64
    t = LONG_AUDIO["frames"] // 4
    lens = torch.tensor([-(-(-(-x // 2)) // 2) for x in
                         LONG_AUDIO["lengths"]], dtype=torch.int32,
                        device="cuda")
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        qkv = torch.from_numpy(rng.randn(b, t, 3, n, h).astype(
            np.float32)).to("cuda", dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        do = torch.from_numpy(rng.randn(b, t, n, h).astype(
            np.float32)).to("cuda", dtype)
        o, lse = fa.flash_attention_fwd(q, k, v, lens, False)
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, lens, False)
        delta = fa._delta(o, do)
        args = (q, k, v, do, lse, delta, lens, False)
        got = (fa.flash_attention_dq(*args),) + fa.flash_attention_dkv(*args)
        want = fa._bwd_plain(*args)
        torch.cuda.synchronize()
        tol, lse_tol = KERNEL_TOL[name]
        errs = {"fwd": _abs_err(o, o_ref), "lse": _abs_err(lse, lse_ref)}
        errs.update({g: _rel_err(x, y) for g, x, y in zip(
            ("dq", "dk", "dv"), got, want)})
        if errs["fwd"] > tol or errs["lse"] > lse_tol or max(
                errs[g] for g in ("dq", "dk", "dv")) > BWD_TOL[name]:
            raise AssertionError(f"flash at the long-audio shape, {name}: "
                                 f"{errs}")
        timed = name == "bfloat16"
        if timed:
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            mask = _key_mask(lens, t, False)

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)

            library_fwd = time_ms(sdpa)
            library_bwd = time_ms(lambda: torch.autograd.grad(
                sdpa(), (qt, kt, vt), do.transpose(1, 2))) - library_fwd
            plain_fwd = time_ms(lambda: fa.flash_attention_reference(
                q, k, v, lens, False), iters=3)
            plain_bwd = time_ms(lambda: fa._bwd_plain(*args), iters=3)
        for kernel, fn, fargs, err in (
                ("fwd", fa.flash_attention_fwd, (q, k, v, lens, False),
                 errs["fwd"]),
                ("dq", fa.flash_attention_dq, args, errs["dq"]),
                ("dkv", fa.flash_attention_dkv, args,
                 max(errs["dk"], errs["dv"]))):
            bound, bound_by = attention_bound_ms(q, lens, False, kernel)
            row = {"phase": "kernel", "kernel": f"flash_attention_{kernel}",
                   "case": "long_audio", "dtype": name,
                   "shape": [b, t, n, h], "causal": False,
                   "lengths": lens.tolist(), "max_abs_err": err,
                   "errors": errs, "kernel_ms": time_ms(lambda: fn(*fargs))
                   if timed else None,
                   "plain_ms": (plain_fwd if kernel == "fwd" else plain_bwd)
                   if timed else None,
                   "library_ms": (library_fwd if kernel == "fwd"
                                  else library_bwd) if timed else None,
                   "bound_ms": bound, "bound_by": bound_by}
            emit(row)
            results[(kernel, name)] = row
    return results


def long_audio_phase(seed, device="cuda"):
    """bench.py's long-audio cells on the port: ``speech_transformer_s``
    (seeded weights, bf16 compute) encodes 4 x 8192 frames with the dense
    and the flash encoder, forward and forward + backward: device ms of
    each, flash against dense outputs within ``ENCODER_TOL``, the flash
    kernels' launches.  Returns the launch counts of the flash runs."""
    import torch

    import neurst_tpu_torch
    from neurst_tpu_torch.models.speech_transformer import SpeechTransformer
    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
    from neurst_tpu_torch.utils.param_bridge import load_flat_params

    a = LONG_AUDIO
    cfg = SpeechTransformer.build_model_args_by_name(SLICE["model"])
    params = dict(cfg["model.params"], dtype="bfloat16")
    params["encoder.enable_flash_attention"] = True
    model = neurst_tpu_torch.build_model(
        dict(cfg, **{"model.params": params}),
        src_meta={"audio_feature_dim": SLICE["feature_dim"],
                  "audio_feature_channels": 1},
        trg_meta={"vocab_size": SLICE["vocab"], "eos_id": 1, "bos_id": 2},
        device=device)
    load_flat_params(model, speech_transformer_flat_params(
        cfg, SLICE["vocab"], SLICE["feature_dim"], seed))
    rng = np.random.RandomState(seed + 141)
    inputs = {"src": torch.from_numpy(rng.randn(
        a["batch"], a["frames"], SLICE["feature_dim"], 1).astype(
        np.float32)).to(device),
        "src_length": torch.tensor(a["lengths"], dtype=torch.int32,
                                   device=device)}

    def forward():
        with torch.no_grad():
            return model.encode(inputs)

    def forward_backward():
        enc, padding = model.encode(inputs)
        (enc.float() * (1.0 - padding)[:, :, None]).sum().backward()

    row = {"phase": "long_audio", "model": SLICE["model"], "dtype":
           "bfloat16", "batch": a["batch"], "frames": a["frames"],
           "lengths": list(a["lengths"])}
    outs, counts = {}, {}
    for name, flash in (("dense", False), ("flash", True)):
        model.encoder.enable_flash_attention = flash
        outs[name], padding = forward()
        reset_launch_counts()
        forward()
        forward_backward()
        counts[name] = launch_counts()
        row[f"{name}_fwd_ms"] = time_ms(forward, iters=a["iters"], warmup=1)
        row[f"{name}_fwd_bwd_ms"] = time_ms(forward_backward,
                                            iters=a["iters"], warmup=1)
    layers = model.encoder.num_layers
    want_flash = {"flash_attention_fwd": 2 * layers,
                  "flash_attention_dq": layers, "flash_attention_dkv": layers}
    valid = (1.0 - padding)[:, :, None].bool()
    rel = float(((outs["flash"].float() - outs["dense"].float()).abs()
                 * valid).max() / outs["dense"].float().abs().max())
    row.update({"time_after_subsampling": int(outs["flash"].shape[1]),
                "flash_vs_dense_rel_err": rel, "tol": ENCODER_TOL[1],
                "launches": {k: counts["flash"][k] for k in want_flash},
                "dense_launches": {k: counts["dense"][k]
                                   for k in want_flash}})
    emit(row)
    if rel > ENCODER_TOL[1] or any(counts["dense"][k] for k in want_flash) \
            or any(counts["flash"][k] != v for k, v in want_flash.items()) \
            or row["time_after_subsampling"] != a["frames"] // 4:
        raise AssertionError(f"long_audio phase failed: {row}")
    del model
    return counts["flash"]


# ----------------------- speculative decoding (slice 11) ---------------- #

# speculative decoding through ``run_exp --entry predict`` against plain
# greedy (``top_sampling`` top_k 1) on three trained or converted dirs:
# the committed examples/speculative_decoding ymls layered over a predict
# config (spec_text), the n-gram draft on the speech dir (spec_speech,
# no source lookup: the source is audio) and prompt lookup on GPT-2
# (spec_gpt2); each in bfloat16 (the serving dtype) and float32
SPEC = dict(k=4, text_batch=64, max_len=160,
            draft_hparams="transformer_256_3e_1d", sampling_top_k=8,
            speech_max_len=150, gpt2_continuation=64)
SPEC_YMLS = os.path.join("examples", "speculative_decoding",
                         "example_configs")
# a speculative decode may differ from plain greedy only from a step where
# the plain decode's two best log-probs lie this close (a k-row and a
# 1-row product may round a near-tie apart)
SPEC_TIE_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@contextlib.contextmanager
def _decode_recorder():
    """Records, inside a predict run: each plain-greedy batch's ids and
    the masked log-probs of each of its steps (``top_sampling``'s loop),
    and each speculative batch's ids, target passes, tokens emitted and
    the host synchronisations inside its decode loop (torch's sync debug
    mode on the card)."""
    import warnings

    import torch

    from neurst_tpu_torch.layers.search import sampling, speculative

    rec = {"greedy": [], "spec": [], "syncs": 0, "steps": []}
    originals = {(sampling, "masked_step_log_probs"):
                 sampling.masked_step_log_probs,
                 (sampling.TopSampling, "__call__"):
                 sampling.TopSampling.__call__,
                 (speculative.SpeculativeDecode, "__call__"):
                 speculative.SpeculativeDecode.__call__,
                 (speculative, "speculative_greedy_decode"):
                 speculative.speculative_greedy_decode}

    def masked(*a, **kw):
        lp = originals[sampling, "masked_step_log_probs"](*a, **kw)
        rec["steps"].append(lp)
        return lp

    def greedy_call(self, inputs):
        rec["eos"] = getattr(self.model, "generation_meta",
                             self.model.trg_meta)["eos_id"]
        rec["steps"] = []
        ids, scores = originals[sampling.TopSampling, "__call__"](self,
                                                                  inputs)
        top2 = torch.stack([lp.topk(2, dim=-1).values
                            for lp in rec["steps"]])
        rec["greedy"].append({"ids": ids.cpu(),
                              "gaps": (top2[..., 0] - top2[..., 1]).cpu()})
        rec["steps"] = []
        return ids, scores

    def spec_call(self, inputs):
        ids, scores = originals[speculative.SpeculativeDecode, "__call__"](
            self, inputs)
        rec["spec"].append({
            "ids": ids.cpu(), "passes": self.last_stats["target_passes"],
            "tokens": self.last_stats["tokens_emitted"].cpu()})
        return ids, scores

    def counted_decode(*a, **kw):
        if not torch.cuda.is_available():
            return originals[speculative, "speculative_greedy_decode"](
                *a, **kw)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return originals[speculative, "speculative_greedy_decode"](
                    *a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                rec["syncs"] += sum("synchroniz" in str(w.message)
                                    for w in caught)

    sampling.masked_step_log_probs = masked
    sampling.TopSampling.__call__ = greedy_call
    speculative.SpeculativeDecode.__call__ = spec_call
    speculative.speculative_greedy_decode = counted_decode
    try:
        yield rec
    finally:
        for (owner, name), value in originals.items():
            setattr(owner, name, value)


def _tie_check(greedy, spec, eos, tol):
    """Each speculative row against the plain greedy row (to the first EOS
    within the plain loop's steps): returns (rows, the near-tie cases:
    rows that first differ at a step whose two best plain log-probs lie
    within ``tol``); raises on a row that differs anywhere else."""
    rows, cases = 0, []
    for b, (g, s) in enumerate(zip(greedy, spec)):
        steps = g["gaps"].shape[0]
        for r, (want, got) in enumerate(zip(g["ids"][:, :steps].tolist(),
                                            s["ids"][:, :steps].tolist())):
            rows += 1
            want = want[:want.index(eos) + 1] if eos in want else want
            got = got[:got.index(eos) + 1] if eos in got else got
            if want == got:
                continue
            j = next((i for i, (a, c) in enumerate(zip(want, got))
                      if a != c), min(len(want), len(got)))
            gap = float(g["gaps"][j, r])
            case = {"batch": b, "row": r, "step": j, "top2_gap": gap,
                    "plain": want[j:j + 4], "speculative": got[j:j + 4]}
            if gap > tol:
                raise AssertionError(f"speculative decode differs from "
                                     f"plain greedy off a near-tie: {case}")
            cases.append(case)
    return rows, cases


def _spec_stats(rec, result, wall_s):
    passes = sum(s["passes"] for s in rec["spec"])
    per_row = sum(float(s["tokens"].float().mean()) for s in rec["spec"])
    return {"samples": result["samples"],
            "samples_per_s": result["samples_per_sec"], "wall_s": wall_s,
            "decode_s": result["timing"]["decode_s"],
            "target_passes": passes,
            "tokens_committed_per_pass": per_row / max(passes, 1),
            "host_syncs_per_pass": rec["syncs"] / max(passes, 1),
            "batches": len(rec["spec"])}


def spec_predict_runs(argv, greedy, searches, device="cuda",
                      dtypes=("bfloat16", "float32")):
    """``run_exp --entry predict`` with ``argv`` (config, model dir,
    dataset) under plain greedy (``top_sampling`` top_k 1 with the length
    flags ``greedy``) and each speculative search of ``searches`` ({name:
    argv}), in each dtype: samples/s, wall and decode seconds, target
    passes (and plain greedy's steps over them), tokens committed a pass
    (the JAX package's mean tokens emitted over passes, a row that has
    finished counting 0), host syncs a pass, and the tie check of every
    speculative row against plain greedy.  Returns the rows and the launch
    counts of the whole set of runs."""
    import torch

    from neurst_tpu_torch.cli import run_exp
    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts

    greedy = ["--search_method", "top_sampling", "--search_method.params",
              json.dumps(dict(greedy, top_k=1))]
    rows = {}
    reset_launch_counts()
    for dtype in dtypes:
        for name, extra in [("greedy", greedy)] + list(searches.items()):
            with _decode_recorder() as rec:
                if device == "cuda":
                    torch.cuda.synchronize()
                start = time.perf_counter()
                result = run_exp.cli_main(argv + extra + [
                    "--dtype", dtype, "--device", device])
                wall_s = time.perf_counter() - start
            if name == "greedy":
                plain, eos = rec["greedy"], rec["eos"]
                rows[dtype, name] = {
                    "samples": result["samples"],
                    "samples_per_s": result["samples_per_sec"],
                    "wall_s": wall_s,
                    "decode_s": result["timing"]["decode_s"],
                    "target_passes": sum(g["gaps"].shape[0] for g in plain)}
                continue
            row = _spec_stats(rec, result, wall_s)
            row["greedy_steps_per_pass"] = rows[dtype, "greedy"][
                "target_passes"] / max(row["target_passes"], 1)
            if name != "sampling":
                row["rows"], row["near_tie_cases"] = _tie_check(
                    plain, rec["spec"], eos, SPEC_TIE_TOL[dtype])
                row["differing_rows"] = len(row["near_tie_cases"])
            rows[dtype, name] = row
            if result["samples"] != rows[dtype, "greedy"]["samples"]:
                raise AssertionError(f"{name} {dtype}: {result['samples']} "
                                     f"samples")
    return {f"{d}_{n}": r for (d, n), r in rows.items()}, launch_counts()


def _predict_json(path, dataset, batch_size, **extra):
    with open(path, "w") as f:
        json.dump(dict(dataset, **extra, **{"entry.class": "predict",
                                            "batch_size": batch_size}),
                  f, indent=1)
    return path


def spec_text_phase(seed, root, model_dir, dev, device="cuda"):
    """Speculative decoding on mt_quality's 300-step ``mt_synth_base.yml``
    dir over its 128 dev lines (batch 64): plain greedy; the committed
    n-gram yml layered over the predict config; the committed draft yml
    with a ``transformer_256_3e_1d`` draft trained 300 steps by the same
    recipe; speculative sampling (top_k 8) once.  Returns the launch
    counts."""
    here = os.path.dirname(os.path.abspath(__file__))
    start = time.perf_counter()
    draft = mt_quality_phase(root, device, hparams_set=SPEC[
        "draft_hparams"], name="spec_draft")["model_dir"]
    draft_s = time.perf_counter() - start
    config = _predict_json(os.path.join(root, "spec_predict.json"),
                           {"dataset.class": "parallel_text",
                            "dataset.params": _parallel(dev)},
                           SPEC["text_batch"], **{"metric.class": "bleu"})
    k, max_len = SPEC["k"], SPEC["max_len"]

    def layered(yml, params):
        return ["--config_paths", config + "," + os.path.join(
            here, SPEC_YMLS, yml), "--search_method.params",
            json.dumps(dict(params, speculative_k=k,
                            maximum_decode_length=max_len))]
    searches = {
        "ngram": layered("prediction_spec_ngram_args.yml", {
            "draft_method": "ngram", "draft_ngram": 3,
            "draft_lookup_source": True}),
        "draft": layered("prediction_spec_draft_args.yml",
                         {"draft_model_dir": draft}),
        "sampling": layered("prediction_spec_ngram_args.yml", {
            "draft_method": "ngram", "sampling": True,
            "top_k": SPEC["sampling_top_k"], "seed": seed})}
    argv = ["--config_paths", config, "--model_dir", model_dir]
    rows, counts = spec_predict_runs(
        argv, {"maximum_decode_length": max_len}, searches, device)
    emit({"phase": "spec_text", "recipe": "examples/quality/"
          "mt_synth_base.yml", "model": "transformer_base", "draft":
          SPEC["draft_hparams"], "draft_train_s": draft_s, "k": k,
          "lines": NMT_TRAINER["quality_dev_lines"],
          "batch": SPEC["text_batch"], "tie_tol": SPEC_TIE_TOL,
          "runs": rows, "launches": counts})
    return counts


def spec_speech_phase(paths, device="cuda"):
    """Speculative n-gram decoding (k 4, no source lookup) against plain
    greedy through ``--entry predict`` on the predict phase's
    ``speech_transformer_s`` dir (64 utterances, batch 16, max 150), in
    bfloat16 and float32: the flash forward must launch 12 times a batch
    of every run.  Returns the launch counts."""
    max_len = SPEC["speech_max_len"]
    searches = {"ngram": [
        "--search_method", "speculative_decode", "--search_method.params",
        json.dumps({"draft_method": "ngram", "draft_ngram": 3,
                    "speculative_k": SPEC["k"],
                    "maximum_decode_length": max_len})]}
    argv = ["--config_paths", paths["main"], "--model_dir",
            paths["model_dir"]]
    rows, counts = spec_predict_runs(
        argv, {"maximum_decode_length": max_len}, searches, device)
    batches = -(-PREDICT["utterances"] // PREDICT["batch"])
    expected = 12 * batches * 4  # (greedy + ngram) x two dtypes
    emit({"phase": "spec_speech", "model": PREDICT["model"], "k": SPEC["k"],
          "utterances": PREDICT["utterances"], "batch": PREDICT["batch"],
          "tie_tol": SPEC_TIE_TOL, "runs": rows, "launches": counts,
          "flash_fwd_expected": expected})
    if device == "cuda" and counts["flash_attention_fwd"] != expected:
        raise AssertionError(f"spec_speech: flash launches "
                             f"{counts['flash_attention_fwd']}, expected "
                             f"{expected}")
    return counts


def spec_gpt2_phase(root, model_dir, prompts, device="cuda"):
    """Prompt-lookup speculative decoding (the n-gram draft over each
    prompt, k 4) of gpt2_lm's GPT-2 117M dir against plain greedy: 16
    prompts of 16-64 tokens continued by 64 tokens (the minimum length:
    each prompt ends in the EOS the pipeline appends, after which the
    20-step model emits EOS), bfloat16 and float32.  Returns the launch
    counts."""
    cont = SPEC["gpt2_continuation"]
    lengths = {"maximum_decode_length": cont, "minimum_decode_length": cont}
    config = _predict_json(os.path.join(root, "spec_gpt2.json"), {
        "dataset.class": "mono_text",
        "dataset.params": {"data_file": prompts}}, GPT2_LM["prompts"])
    searches = {"ngram": [
        "--search_method", "speculative_decode", "--search_method.params",
        json.dumps(dict(lengths, draft_method="ngram", draft_ngram=3,
                        speculative_k=SPEC["k"]))]}
    rows, counts = spec_predict_runs(
        ["--config_paths", config, "--model_dir", model_dir], lengths,
        searches, device)
    emit({"phase": "spec_gpt2", "model": GPT2_LM["hparams_set"],
          "k": SPEC["k"], "prompts": GPT2_LM["prompts"],
          "continuation": cont, "tie_tol": SPEC_TIE_TOL, "runs": rows,
          "launches": counts})
    return counts


# -------------------- multilingual translation (slice 11) --------------- #

# must-c/mt_training_args.yml's trainer flags (32,768-token buckets, max
# 128 / 128, transformer_base with Adam and noam, label smoothing 0.1)
# on the multilingual task: four directions (en->de, de->en, en->fr,
# fr->en) mixed at 0.25 each by ``mixed_train`` over a seeded word corpus
# of three languages (disjoint lexicons of one joint 32,768-entry
# vocabulary, tags included), the source tag on, the target tag as BOS;
# transformer_base with a shared source/target embedding and tied softmax,
# dropout 0.1, bf16 with an f32 master
MULTILINGUAL = dict(hparams_set="transformer_base", vocab=32768,
                    languages=("en", "de", "fr"), pairs=8000, min_tokens=5,
                    max_tokens=127, steps=12, save_every=6, summary=2,
                    src_steps=5, predict_lines=64, predict_batch=64,
                    check_tokens=2048, share_tol=0.05)
MULTILINGUAL_TASK = {"batch_by_tokens": True, "batch_size": 32768,
                     "max_src_len": 128, "max_trg_len": 128,
                     "with_src_lang_tag": True,
                     "trg_lang_tag_position": "trg"}
DIRECTIONS = {"en2de": ("en", "de"), "de2en": ("de", "en"),
              "en2fr": ("en", "fr"), "fr2en": ("fr", "en")}
MULTILINGUAL_CHECK_TOL = 1e-5


def write_multilingual_corpus(root, rng, cfg=MULTILINGUAL):
    """A joint vocabulary of ``vocab`` - 6 words (the pipeline adds <UNK>,
    <SEQ_BEG>, <SEQ_END> and a tag a language) split into three disjoint
    lexicons; en-de and en-fr training pairs and, per direction, 64 dev
    pairs.  Returns (vocab path, {direction: (src, trg) train files},
    {direction: dev dataset params})."""
    vocab = os.path.join(root, "vocab.joint")
    words = write_word_vocab(vocab, rng, cfg["vocab"] - 3 - len(
        cfg["languages"]))
    order = rng.permutation(len(words))
    lexicon = {lang: [words[i] for i in order[j::len(cfg["languages"])]]
               for j, lang in enumerate(cfg["languages"])}
    train, dev = {}, {}
    for other in ("de", "fr"):
        pair = write_parallel(os.path.join(root, f"train.en{other}"), rng,
                              lexicon["en"], lexicon[other], cfg["pairs"],
                              cfg["min_tokens"], cfg["max_tokens"])
        train[f"en2{other}"] = (pair["src"], pair["trg"])
        train[f"{other}2en"] = (pair["trg"], pair["src"])
    for name, (src, trg) in DIRECTIONS.items():
        pair = write_parallel(os.path.join(root, f"dev.{name}"), rng,
                              lexicon[src], lexicon[trg],
                              cfg["predict_lines"], cfg["min_tokens"],
                              cfg["max_tokens"])
        dev[name] = {"src_file": pair["src"], "trg_file": pair["trg"],
                     "src_lang": src, "trg_lang": trg}
    return vocab, train, dev


def multilingual_config(path, vocab, train, steps, save_every, summary,
                        **task):
    cfg = MULTILINGUAL
    with open(path, "w") as f:
        json.dump({
            "task.class": "multilingual_translation",
            "task.params": dict(MULTILINGUAL_TASK, **{
                "multilingual_dp.params": {
                    "vocab_path": vocab, "languages": list(cfg["languages"]),
                    "tokenizer": None}}, **task),
            "dataset.class": "mixed_train",
            "dataset.params": {
                "data_files": {name: {
                    "dataset.class": "multilingual_translation_dataset",
                    "dataset.params": {
                        "src_file": train[name][0],
                        "trg_file": train[name][1],
                        "src_lang": src, "trg_lang": trg}}
                    for name, (src, trg) in DIRECTIONS.items()},
                "data_sampler.class": "data_sampler",
                "data_sampler.params": {"sample_ratios": {
                    name: 1.0 / len(DIRECTIONS) for name in DIRECTIONS}}},
            "hparams_set": cfg["hparams_set"],
            "model.params": {"modality.share_source_target_embedding": True},
            "dtype": "bfloat16", "entry.class": "trainer",
            "entry.params": {
                "criterion.class": "label_smoothed_cross_entropy",
                "criterion.params": {"label_smoothing": 0.1},
                "train_steps": steps, "summary_steps": summary,
                "save_checkpoint_steps": save_every,
                "enable_tensorboard": False}}, f, indent=1)
    return path


def _direction_tags(batch):
    """Each real row's (first source id, first target input id): the source
    tag and the target tag with the src tag on and the target tag as
    BOS."""
    real = batch["sample_mask"] > 0
    return list(zip(batch["src"][real, 0].tolist(),
                    batch["trg_input"][real, 0].tolist()))


def multilingual_train_phase(seed, root, vocab, train, device="cuda"):
    """12 steps of the recipe (``MULTILINGUAL``) through ``run_exp --entry
    train``: window tokens/s, the data-wait share, checkpoint seconds, peak
    memory, every step a full bucket with its launches against
    ``expected_launches``, each direction's share of the examples against
    its ratio; then 5 steps with ``trg_lang_tag_position: src`` (the
    target tag prepended to the source) and ``enable_profiler``, whose
    trace must hold the card's kernels.  Returns (launch counts, the model
    dir)."""
    from neurst_tpu_torch.tasks.multilingual_translation import \
        MultilingualTranslation
    from neurst_tpu_torch.tasks.task import build_task

    cfg = MULTILINGUAL
    path = multilingual_config(os.path.join(root, "train.json"), vocab,
                               train, cfg["steps"], cfg["save_every"],
                               cfg["summary"])
    with open(path) as f:
        lang2id = build_task(json.load(f)).pipeline.meta["lang2id"]
    model_dir = os.path.join(root, "model")
    _reset_peak(device)
    _, seen = run_trainer(["--config_paths", path, "--model_dir", model_dir,
                           "--device", device], MultilingualTranslation,
                          inspect=_direction_tags)
    _train_path_checks(seen, cfg["steps"], "multilingual_train")
    tokens = _full_batches(seen, "multilingual_train")
    row = dict(_trainer_numbers(seen, _peak_bytes(device)),
               target_tokens_per_step=tokens)
    if device == "cuda":
        row["launches_per_step_by_shape"] = _step_launch_checks(
            seen, seen["model"])
    pairs = [p for batch in seen["inspected"][:cfg["steps"]] for p in batch]
    share = {name: sum(p == (lang2id[s], lang2id[t]) for p in pairs)
             / len(pairs) for name, (s, t) in DIRECTIONS.items()}
    row["direction_share"] = share
    launches = seen["launches"]
    del seen

    src_path = multilingual_config(
        os.path.join(root, "train_src.json"), vocab, train,
        cfg["src_steps"], 1000, 1, trg_lang_tag_position="src")
    src_dir = os.path.join(root, "model_src")
    _, seen = run_trainer(["--config_paths", src_path, "--model_dir",
                           src_dir, "--device", device,
                           "--enable_profiler", "true"],
                          MultilingualTranslation,
                          inspect=lambda b: (b["src"][:, :2].tolist(),
                                             b["trg_input"][:, 0].tolist(),
                                             b["sample_mask"].tolist()))
    _train_path_checks(seen, cfg["src_steps"], "multilingual_src_tag")
    bos = int(seen["model"].trg_meta["bos_id"])
    tags = set(lang2id.values())
    prepend_ok = all(
        src[0] in tags and src[1] in tags and bos_id == bos
        for batch in seen["inspected"][:cfg["src_steps"]]
        for src, bos_id, keep in zip(*batch) if keep)
    traces = sorted(glob.glob(os.path.join(src_dir, "profile",
                                           "*.pt.trace.json")))
    kernels = {}
    if traces:
        with open(traces[-1]) as f:
            for event in json.load(f)["traceEvents"]:
                if event.get("cat") == "kernel":
                    kernels[event["name"]] = kernels.get(event["name"],
                                                         0) + 1
    row["src_position"] = {
        "steps": len(seen["steps"]), "prepend_ok": prepend_ok,
        "windows": seen["windows"], "profile_traces": len(traces),
        "profiled_kernel_events": sum(kernels.values()),
        "profiled_kernel_names": len(kernels),
        "profiled_port_kernels": sorted(
            name for name in kernels if any(
                key in name for key in ("xent", "ffn", "dropout")))[:12]}
    emit({"phase": "multilingual_train", "model": cfg["hparams_set"],
          "dtype": "bfloat16", "bf16_params": True,
          "dropout": DROPOUT_RATE, "recipe": "examples/speech_transformer/"
          "must-c/mt_training_args.yml", "task": MULTILINGUAL_TASK,
          "directions": DIRECTIONS, "pairs_a_language_pair": cfg["pairs"],
          **row})
    if not (prepend_ok and traces and all(
            abs(v - 1.0 / len(DIRECTIONS)) <= cfg["share_tol"]
            for v in share.values())
            and (device != "cuda" or row["src_position"][
                "profiled_kernel_events"] > 0)):
        raise AssertionError(f"multilingual_train failed: {row}")
    return launches, model_dir


def multilingual_predict_phase(model_dir, dev, device="cuda"):
    """``--entry predict`` on the trained dir, one direction at a time
    (beam 4, lp 0.6, max 180, 64 lines, BLEU): samples/s and BLEU per
    direction, no language tag in a hypothesis, and the start token of the
    decode (R13: <SEQ_BEG>, not the batch's target tag).  Returns the
    launch counts."""
    from neurst_tpu_torch.cli import run_exp
    from neurst_tpu_torch.models.encoder_decoder_model import \
        EncoderDecoderModel
    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts

    original = EncoderDecoderModel.prepare_generation
    starts = []

    def recorded(self, inputs, decode_padded_length):
        fn, init = original(self, inputs, decode_padded_length)
        starts.append((int(np.asarray(inputs["trg_input"])[0]),
                       int(init["decoder_input"][0])))
        return fn, init

    rows = {}
    reset_launch_counts()
    EncoderDecoderModel.prepare_generation = recorded
    try:
        for name, params in dev.items():
            start = time.perf_counter()
            result = run_exp.cli_main([
                "--entry", "predict", "--model_dir", model_dir,
                "--dataset.class", "multilingual_translation_dataset",
                "--dataset.params", json.dumps(params),
                "--search_method.params", json.dumps(NMT_PREDICT_SEARCH),
                "--batch_size", str(MULTILINGUAL["predict_batch"]),
                "--metric", "bleu", "--device", device])
            tagged = sum(f"<{lang}>" in h for h in result["hypotheses"]
                         for lang in MULTILINGUAL["languages"])
            rows[name] = {"samples": result["samples"],
                          "samples_per_s": result["samples_per_sec"],
                          "wall_s": time.perf_counter() - start,
                          "timing_s": result["timing"],
                          "BLEU": result["BLEU"],
                          "tagged_hypotheses": tagged,
                          "start": {"trg_input": starts[-1][0],
                                    "decoder_input": starts[-1][1]}}
    finally:
        EncoderDecoderModel.prepare_generation = original
    counts = launch_counts()
    emit({"phase": "multilingual_predict", "search": NMT_PREDICT_SEARCH,
          "directions": rows, "launches": counts,
          "r13_note": "trg_input holds the target tag; every decode starts "
                      "from decoder_input (<SEQ_BEG>), as in the JAX "
                      "package"})
    if not all(r["samples"] == MULTILINGUAL["predict_lines"]
               and r["tagged_hypotheses"] == 0
               and math.isfinite(r["BLEU"]) for r in rows.values()):
        raise AssertionError(f"multilingual_predict failed: {rows}")
    return counts


def multilingual_reference_check(model_dir, train, devices=("cuda",
                                                            "cpu")):
    """One ``check_tokens``-token en->de TRAIN batch through the trained
    weights in float32 (no dropout) on the card and on the CPU: the
    label-smoothed losses within ``MULTILINGUAL_CHECK_TOL`` relative."""
    import torch

    from neurst_tpu_torch.data.datasets.dataset import build_dataset
    from neurst_tpu_torch.tasks.task import build_task
    from neurst_tpu_torch.utils.checkpoints import (latest_checkpoint,
                                                    restore_checkpoint_params)
    from neurst_tpu_torch.utils.compat import ModeKeys
    from neurst_tpu_torch.utils.configurable import ModelConfigs
    from neurst_tpu_torch.utils.param_bridge import load_flat_params

    cfg = ModelConfigs.load(model_dir)
    task = build_task(cfg)
    flat = restore_checkpoint_params(latest_checkpoint(model_dir))
    batch = next(task.create_batch_iterator(
        build_dataset({"dataset.class": "multilingual_translation_dataset",
                       "dataset.params": {
                           "src_file": train["en2de"][0],
                           "trg_file": train["en2de"][1],
                           "src_lang": "en", "trg_lang": "de"}}),
        ModeKeys.TRAIN, {"batch_by_tokens": True,
                         "batch_size": MULTILINGUAL["check_tokens"],
                         "max_src_len": MULTILINGUAL_TASK["max_src_len"],
                         "max_trg_len": MULTILINGUAL_TASK["max_trg_len"],
                         "shuffle_buffer": 0})())
    crit = _smoothed_xent()
    losses = {}
    for device in devices:
        model = task.build_model({"model.class": cfg["model.class"],
                                  "model.params": dict(cfg["model.params"],
                                                       dtype="float32")},
                                 device=device)
        load_flat_params(model, flat)
        with torch.no_grad():
            losses[device] = float(crit.reduce_loss(batch, model(batch)))
        del model
    rel = abs(losses[devices[0]] - losses["cpu"]) / abs(losses["cpu"])
    row = {"phase": "multilingual_reference_check", "dtype": "float32",
           "shape": list(batch["trg"].shape), "losses": losses,
           "rel_err": rel, "tol": MULTILINGUAL_CHECK_TOL}
    emit(row)
    if not rel <= MULTILINGUAL_CHECK_TOL:
        raise AssertionError(f"multilingual: the card's float32 loss "
                             f"disagrees with the CPU's: {row}")


def multilingual_phases(seed, device="cuda"):
    """Slice 11's multilingual group under ``build/multilingual_smoke/``
    (removed after), with each phase's wall seconds.  Returns the launch
    counts by path."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "multilingual_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    stages, launches = {}, {}
    try:
        start = time.perf_counter()
        vocab, train, dev = write_multilingual_corpus(
            root, np.random.RandomState(seed + 140))
        stages["write_corpus"] = time.perf_counter() - start
        start = time.perf_counter()
        launches["multilingual_train"], model_dir = \
            multilingual_train_phase(seed, root, vocab, train, device)
        stages["multilingual_train"] = time.perf_counter() - start
        start = time.perf_counter()
        launches["multilingual_predict"] = multilingual_predict_phase(
            model_dir, dev, device)
        stages["multilingual_predict"] = time.perf_counter() - start
        start = time.perf_counter()
        multilingual_reference_check(model_dir, train, (device, "cpu")
                                     if device != "cpu" else ("cpu",))
        stages["multilingual_reference_check"] = \
            time.perf_counter() - start
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "multilingual", "stage_wall_s": stages,
          "total_s": sum(stages.values())})
    return launches



# Slice 12: quantization-aware training, int8 serving and mixture of
# experts.  QAT: examples/quality/mt_synth_base.yml (the mt_synth recipe
# at transformer_base width) with the mt_synth_qat.yml overlay, cut to
# 300 steps as mt_quality is (QAT's host-bound step costs ~3x
# mt_quality's: the single longest phase), then predict on dev's first
# 128 lines (beam 4, max 20) four ways, as examples/quality/run_quality.py's
# mt_synth_qat entry serves it; a few steps of speech_transformer_s under
# QAT at the recipe's dropout with flash on.  int8 serving: the slice's
# speech decode and bench.py's batch-1 greedy transformer_base decode
# (bench.py:340-420: source 32, max_decode 64) in bf16 and the three int8
# modes.  MoE: examples/moe's Switch overlay on transformer_base at
# bench.py's MoE cell (bench.py:765: [128, 128], vocabulary 32768) as a
# bare step beside the dense model, then through the train and predict
# entries on the mt_synth corpus, and the GShard top-2 overlay.
QAT = dict(recipe=os.path.join("examples", "quality", "mt_synth_base.yml"),
           overlay=os.path.join("examples", "quality", "mt_synth_qat.yml"),
           steps=300, beam=4, max_decode=20, batch=64, worker_timeout_s=600)
INT8_MODES = {"int8_weight_only": {}, "int8_dynamic": {"activations": True},
              "int8_static": {"activations": True,
                              "static_activation_scales": True}}
INT8_FLAGS = {"int8_weight_only": ["--int8_serving"],
              "int8_dynamic": ["--int8_serving", "--int8_activations"],
              "int8_static": ["--int8_serving", "--int8_activations",
                              "--int8_static_activations"]}
# timed requests a mode of the speech decode (after one warm-up)
INT8_SPEECH_REQUESTS = 2
INT8_TEXT = dict(model="transformer_base", vocab=32768, src_len=32,
                 max_decode=64, requests=2)
# Int8Dense on the card against the same module on the CPU (float32
# compute): int32 accumulators equal, outputs within this share of the
# largest (the weight-only product is a float matmul in another order)
INT8_DENSE_TOL = 1e-5
INT8_DENSE_ROWS = (1, 64, 4096)
# QuantDense on the card against the CPU on the same inputs and weights
# (float32): the fake-quantized weights and the fake quant of a given
# tensor bitwise equal (elementwise IEEE operations alike on both), the
# clips' gradients (sums in other orders) within QAT_GRAD_TOL relative;
# the dense's output may land on the next level of its grid where the
# product's rounding differs at a rounding boundary, in at most
# QAT_FLIP_SHARE of the elements and by one level, and its gradients
# (straight through the rounding) within QAT_GRAD_TOL by relative L2
QAT_GRAD_TOL = 1e-4
QAT_FLIP_SHARE = 1e-3
# (name, rows, in, out, activation): the QAT speech step's encoder FFN
# and attention output at its decoder rows (the encoder's 30,000 rows
# cost the CPU side too long), and transformer_base's FFN at
# mt_synth_base.yml's 4096-token micro-batch
QAT_DENSE_CASES = (("speech_dense1", 6000, 256, 2048, "relu"),
                   ("speech_dense2", 6000, 2048, 256, None),
                   ("speech_attention_output", 6000, 256, 256, None),
                   ("base_dense1", 4096, 512, 2048, "relu"),
                   ("base_dense2", 4096, 2048, 512, None))
# the whole QAT speech step in float32, card against CPU: the loss
# within this share (the fake quant's levels make the network
# discontinuous: a product that rounds the other way at a level boundary
# moves its output by a whole level, and each such flip moves the later
# layers, so the gradients of a deep QAT model are compared where the
# inputs are the same, in qat_dense_check, and printed here beside the
# CPU's own spread under a one-rounding perturbation of its weights)
QAT_REF_LOSS_TOL = 1e-3
MOE = dict(model="transformer_base", batch=128, length=128, vocab=32768,
           warmup=2, steps=5, split=2, trainer_steps=12,
           switch=os.path.join("examples", "moe", "example_configs",
                               "moe_switch_base_args.yml"),
           gshard=os.path.join("examples", "moe", "example_configs",
                               "moe_gshard_top2_args.yml"))


def _quantization_off():
    from neurst_tpu_torch.layers.quantization.quant_layers import (
        global_init, set_int8_serving)
    global_init(False)
    set_int8_serving(False)


def _qat_quant_params():
    import yaml
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, QAT["overlay"])) as f:
        overlay = yaml.safe_load(f)
    qp = overlay["quant_params"]
    return yaml.safe_load(qp) if isinstance(qp, str) else dict(qp)


def _no_fused_rows(counts, what):
    """Rows 4-5 and 9-10 off (the JAX gates under QAT and int8)."""
    on = {k: v for k, v in counts.items()
          if k.startswith(("fused_linear_xent", "fused_ffn")) and v}
    if on:
        raise AssertionError(f"{what}: fused kernels ran under "
                             f"quantization: {on}")


def qat_predict_phase(model_dir, dev, device="cuda"):
    """The QAT dir decoded four ways through ``--entry predict``: fake
    quant, int8 with dynamic activation scales, int8 with static scales
    (the learned FFN clips where QAT has them, self-calibration
    elsewhere), and int8 weight-only: BLEU, samples/s and the share of
    hypotheses equal to the fake-quant ones, and under static scales the
    denses whose ``act_scale`` came from a learned clip and the
    calibrated ones.  Returns the launch counts of the runs (the text
    decode launches no kernel)."""
    from neurst_tpu_torch.exps import sequence_generator
    from neurst_tpu_torch.layers.quantization.quant_layers import Int8Dense
    calibrated = []
    write_scales = sequence_generator.write_calibrated_act_scales

    def seen_scales(model, calibration, margin=1.0):
        calibrated.append({
            "from_clip": sum(isinstance(m, Int8Dense) and m.act_scale_from_clip
                             for m in model.modules()),
            "calibrated": sum(not model.get_submodule(p).act_scale_from_clip
                              for p in calibration)})
        return write_scales(model, calibration, margin)
    argv = ["--entry", "predict", "--model_dir", model_dir,
            "--metric", "bleu", "--dataset.class", "parallel_text",
            "--dataset.params", json.dumps(_parallel(dev)),
            "--search_method.params", json.dumps(
                {"beam_size": QAT["beam"],
                 "maximum_decode_length": QAT["max_decode"]}),
            "--batch_size", str(QAT["batch"]), "--device", device]
    runs, total = {}, {}
    sequence_generator.write_calibrated_act_scales = seen_scales
    try:
        for name, flags in [("fake_quant", [])] + list(INT8_FLAGS.items()):
            result, counts, wall = _counted_predict(argv + flags)
            runs[name] = {"BLEU": result["BLEU"],
                          "samples": result["samples"],
                          "samples_per_s": result["samples_per_sec"],
                          "wall_s": wall, "hypotheses": result["hypotheses"],
                          "launches": counts}
            if name == "int8_static":
                runs[name]["act_scales"] = calibrated[-1]
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    finally:
        sequence_generator.write_calibrated_act_scales = write_scales
        _quantization_off()
    ref = runs["fake_quant"]["hypotheses"]
    for run in runs.values():
        hyps = run.pop("hypotheses")
        run["equal_to_fake_quant"] = float(np.mean(
            [a == b for a, b in zip(hyps, ref)]))
        if len(hyps) != len(ref) or not math.isfinite(run["BLEU"]):
            raise AssertionError(f"qat_predict: {run}")
    if not (runs["int8_static"]["act_scales"]["from_clip"]
            and runs["int8_static"]["act_scales"]["calibrated"]):
        raise AssertionError(f"qat_predict: act_scales from learned QAT "
                             f"clips and calibrated: "
                             f"{runs['int8_static']['act_scales']}")
    emit({"phase": "qat_predict", "model_dir_recipe": QAT["overlay"],
          "dev_lines": len(ref), "beam": QAT["beam"],
          "max_decode": QAT["max_decode"], "runs": runs})
    return total


def qat_phases(seed, device="cuda"):
    """qat_train (the mt_synth QAT recipe through ``--entry train``,
    every step's launches against ``expected_launches``: the mask kernel
    only) and qat_predict, under ``build/qat_smoke/``.  Returns the
    launch counts of the train and the predict runs."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "qat_smoke")
    here = os.path.dirname(os.path.abspath(__file__))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        quality = mt_quality_phase(
            root, device, recipe=os.path.join(here, QAT["recipe"]),
            name="qat_train", overlay=os.path.join(here, QAT["overlay"]),
            steps=QAT["steps"])
        seen = quality["seen"]
        model = seen["model"]
        if device == "cuda":
            by_shape = _step_launch_checks(seen, model)
            _no_fused_rows(seen["launches"], "qat_train")
            if not seen["launches"]["fused_dropout"]:
                raise AssertionError("qat_train: the mask kernel never ran")
            emit({"phase": "qat_train_launches",
                  "launches_per_step_by_shape": by_shape,
                  "launches": seen["launches"],
                  "clips": sum(n.endswith("_clip_max")
                               for n, _ in model.named_parameters())})
        predict_counts = qat_predict_phase(quality["model_dir"],
                                           quality["dev"], device)
    finally:
        _quantization_off()
        shutil.rmtree(root, ignore_errors=True)
    return seen["launches"], predict_counts


def qat_speech_step_phase(seed, train_dropout_row, device="cuda"):
    """``speech_transformer_s`` under QAT (mt_synth_qat.yml's quant
    params) in bf16 with flash on and the recipe's dropout 0.1, on
    train_dropout's batches and key: launches per step against the
    configuration (flash and the mask kernel; no fused FFN or xent),
    step ms, and the losses next to train_dropout's without QAT."""
    from neurst_tpu_torch.layers.quantization.quant_layers import \
        global_init
    from neurst_tpu_torch.utils.rng import make_key
    qp = _qat_quant_params()
    global_init(True, **qp)
    try:
        model, criterion, tx, state, step = build_train(
            seed, device, dropout=DROPOUT_RATE, quant_params=qp)
        key = make_key(seed + 7)
        rng = np.random.RandomState(seed + 3)
        batches = [train_batch(rng, device, TRAIN["batch"], TRAIN["frames"],
                               TRAIN["min_src"], TRAIN["trg_len"],
                               TRAIN["min_trg"])
                   for _ in range(TRAIN["warmup"] + TRAIN["steps"]
                                  + TRAIN["split"])]
        expected = expected_launches(
            model, TRAIN["batch"] * TRAIN["frames"] // 4,
            TRAIN["batch"] * TRAIN["trg_len"], True)
        _no_fused_rows(expected, "qat_speech_step")
        if not (expected["flash_attention_fwd"]
                and expected["fused_dropout"]):
            raise AssertionError(f"qat_speech_step: {expected}")
        out, totals = _drive_train(
            model, criterion, tx, state, step, batches, TRAIN["warmup"],
            TRAIN["steps"], key, expected,
            may_stay=lambda n: n.endswith("_clip_max"))
    finally:
        global_init(False)
    emit(dict({"phase": "qat_speech_step", "model": TRAIN["model"],
               "dtype": "bfloat16", "dropout": DROPOUT_RATE,
               "quant_params": qp,
               "loss_without_qat": train_dropout_row["loss"],
               "step_ms_median_without_qat":
                   train_dropout_row["step_ms_median"]}, **out))
    return totals


def qat_dense_check(seed):
    """QAT's fake quant and ``QuantDense`` on the card against the CPU,
    float32, on the same inputs, weights and upstream gradient, at
    ``QAT_DENSE_CASES``, with the clips at the 99th percentile of |w| and
    of the activation's |output| (so that both clips take a gradient
    from the data): the fake-quantized weights, the fake quant of the
    CPU's pre-quant output and its dx bitwise equal; the clips'
    gradients within ``QAT_GRAD_TOL``, finite and nonzero; the dense's
    output off by one level in at most ``QAT_FLIP_SHARE`` of its
    elements; dx, dW, db and the clips' gradients within
    ``QAT_GRAD_TOL``.  Returns the rows."""
    import torch

    from neurst_tpu_torch.layers.common_layers import activation_by_name
    from neurst_tpu_torch.layers.quantization import quant_layers as ql
    rng = np.random.RandomState(seed + 47)
    rows_out = []
    ql.global_init(True)
    try:
        for name, rows, d_in, d_out, act in QAT_DENSE_CASES:
            dense = ql.QuantDense(d_in, d_out, activation=act)
            w = (rng.randn(d_out, d_in) * d_in ** -0.5).astype(np.float32)
            b = (0.1 * rng.randn(d_out)).astype(np.float32)
            x = rng.randn(rows, d_in).astype(np.float32)
            g = rng.randn(rows, d_out).astype(np.float32)
            pre = x @ w.T + b
            if act:
                pre = np.maximum(pre, 0.0)
            with torch.no_grad():
                dense.weight.copy_(torch.from_numpy(w))
                dense.bias.copy_(torch.from_numpy(b))
                dense.kernel_clip_max.fill_(float(np.quantile(np.abs(w),
                                                              0.99)))
                dense.output_clip_max.fill_(float(np.quantile(np.abs(pre),
                                                              0.99)))
            card = ql.QuantDense(d_in, d_out, activation=act).cuda()
            card.load_state_dict(dense.state_dict())
            with torch.no_grad():
                # the CPU's activated product: the output fake quant's
                # input on both devices
                pre_cpu = torch.nn.functional.linear(
                    torch.from_numpy(x), dense.quantized_kernel(),
                    dense.bias)
                if act:
                    pre_cpu = activation_by_name(act)(pre_cpu)
            out, fq = {}, {}
            for where, mod in (("cuda", card), ("cpu", dense)):
                xx = torch.from_numpy(x).to(where).requires_grad_()
                gg = torch.from_numpy(g).to(where)
                params = [xx, mod.weight, mod.bias, mod.kernel_clip_max,
                          mod.output_clip_max]
                y = mod.dense(xx, torch.float32)
                grads = torch.autograd.grad((y * gg).sum(), params)
                with torch.no_grad():
                    wq = mod.quantized_kernel()
                out[where] = {"y": y.detach().cpu(), "wq": wq.cpu(),
                              "grads": [t.cpu() for t in grads]}
                t = pre_cpu.to(where).requires_grad_()
                q = mod.quantize_output(t)
                fq[where] = [q.detach().cpu()] + [
                    v.cpu() for v in torch.autograd.grad(
                        (q * gg).sum(), [t, mod.output_clip_max])]
            card_out, ref = out["cuda"], out["cpu"]
            # a level: max / 255 on relu's [0, max], max / 127 on the
            # symmetric grid
            level = float(dense.output_clip_max.detach()) / (
                255.0 if act == "relu" else 127.0)
            diff = (card_out["y"] - ref["y"]).abs()
            flips = diff > 1e-5 * float(ref["y"].abs().max())
            row = {
                "case": name, "rows": rows, "in": d_in, "out": d_out,
                "activation": act,
                "weights_bitwise": bool(torch.equal(card_out["wq"],
                                                    ref["wq"])),
                "act_quant_bitwise": bool(torch.equal(fq["cuda"][0],
                                                      fq["cpu"][0])),
                "act_quant_dx_bitwise": bool(torch.equal(fq["cuda"][1],
                                                         fq["cpu"][1])),
                "act_quant_dclip_rel_err": abs(float(
                    fq["cuda"][2] - fq["cpu"][2])) / abs(float(
                        fq["cpu"][2])),
                "flip_share": float(flips.float().mean()),
                "max_flip_levels": float(diff.max()) / level,
                "grad_rel_l2_err": {
                    k: float((a - b_).norm() / b_.norm().clamp_min(1e-30))
                    for k, a, b_ in zip(("dx", "dw", "db", "dkernel_clip",
                                         "doutput_clip"),
                                        card_out["grads"], ref["grads"])},
                "clip_grads": [float(t) for t in card_out["grads"][3:]]}
            ok = (row["weights_bitwise"] and row["act_quant_bitwise"]
                  and row["act_quant_dx_bitwise"]
                  and row["act_quant_dclip_rel_err"] <= QAT_GRAD_TOL
                  and row["flip_share"] <= QAT_FLIP_SHARE
                  and row["max_flip_levels"] <= 1.01
                  and max(row["grad_rel_l2_err"].values()) <= QAT_GRAD_TOL
                  and all(math.isfinite(c) and c != 0.0
                          for c in row["clip_grads"]))
            rows_out.append(row)
            if not ok:
                raise AssertionError(f"QuantDense on the card: {row}")
    finally:
        ql.global_init(False)
    emit({"phase": "qat_dense_check", "tol": {
        "grad": QAT_GRAD_TOL, "flip_share": QAT_FLIP_SHARE}, "rows": rows_out})
    return rows_out


def qat_reference_check(seed):
    """One float32 QAT speech step (mt_synth_qat.yml's quant params, no
    dropout, 2 x 256 frames, full depth) on the card and on the CPU: the
    losses within ``QAT_REF_LOSS_TOL``, every clip's gradient finite and
    nonzero on the card, and, as readings, the largest relative L2
    error of a gradient next to the CPU's own under a one-rounding
    perturbation of every weight (the spread the levels' flips give)."""
    import torch

    from neurst_tpu_torch.layers.quantization.quant_layers import \
        global_init
    qp = _qat_quant_params()
    global_init(True, **qp)
    outs = {}
    try:
        for where in ("cuda", "cpu", "cpu_perturbed"):
            device = where[:4].rstrip("_")
            model, _, _, state, step = build_train(seed, device, "float32",
                                                   0.0, quant_params=qp)
            if where == "cpu_perturbed":
                gen = torch.Generator().manual_seed(seed)
                with torch.no_grad():
                    for n, p in state.params.items():
                        if not n.endswith("_clip_max") and p.ndim:
                            p.mul_(1.0 + 2.0 ** -24 * torch.randint(
                                -1, 2, p.shape, generator=gen))
            batch = train_batch(np.random.RandomState(seed + 4), device, 2,
                                256, 200, 16, 10)
            loss, _, grads = step.compute_grads(state.params, batch, None)
            outs[where] = (float(loss), {n: g.cpu()
                                         for n, g in grads.items()})
            del model, state, step
    finally:
        global_init(False)

    def spread(a, b_):
        return max((float((a[1][n] - b_[1][n]).norm()
                          / b_[1][n].norm().clamp_min(1e-30)), n)
                   for n in b_[1])
    ref = outs["cpu"]
    clips = {n: float(g) for n, g in outs["cuda"][1].items()
             if n.endswith("_clip_max")}
    row = {"phase": "qat_reference_check", "model": TRAIN["model"],
           "dtype": "float32", "quant_params": qp, "batch": 2,
           "frames": 256, "trg_len": 16, "loss_card": outs["cuda"][0],
           "loss_cpu": ref[0],
           "loss_rel_err": abs(outs["cuda"][0] - ref[0]) / abs(ref[0]),
           "loss_rel_err_cpu_perturbed": abs(
               outs["cpu_perturbed"][0] - ref[0]) / abs(ref[0]),
           "max_grad_rel_l2_err": spread(outs["cuda"], ref),
           "max_grad_rel_l2_err_cpu_perturbed": spread(
               outs["cpu_perturbed"], ref),
           "clips": len(clips), "tol": QAT_REF_LOSS_TOL}
    emit(row)
    if not (row["loss_rel_err"] <= QAT_REF_LOSS_TOL and clips and all(
            math.isfinite(v) and v != 0.0 for v in clips.values())):
        raise AssertionError(f"qat card vs CPU: {row}")
    return row


def _weight_bytes(model):
    return sum(p.numel() * p.element_size() for p in model.parameters())


def _set_int8(mode):
    from neurst_tpu_torch.layers.quantization.quant_layers import \
        set_int8_serving
    if mode == "bf16":
        set_int8_serving(False)
    else:
        set_int8_serving(True, **INT8_MODES[mode])


def _time_requests(run, requests):
    import torch
    run(requests[0])  # warm-up: handles and plans
    torch.cuda.synchronize()
    outs, ms = [], []
    for inputs in requests:
        start = time.perf_counter()
        out = run(inputs)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - start) * 1e3)
        outs.append(out)
    return outs, ms


def int8_dense_check(seed):
    """Each ``Int8Dense`` mode on the card against the same module on the
    CPU, on the same int8 weights and inputs, at the decode and training
    row counts (1 is padded to 17 rows for ``torch._int_mm``): the int32
    accumulators equal, the outputs within ``INT8_DENSE_TOL`` of their
    largest (float32 compute)."""
    import torch

    from neurst_tpu_torch.layers.quantization.quant_layers import (
        Int8Dense, int8_matmul, set_int8_serving)
    rng = np.random.RandomState(seed + 41)
    rows_out = []
    try:
        for mode, kwargs in INT8_MODES.items():
            set_int8_serving(True, **kwargs)
            dense = Int8Dense(512, 2048)
            with torch.no_grad():
                dense.kernel_q.copy_(torch.from_numpy(rng.randint(
                    -127, 128, (2048, 512)).astype(np.int8)))
                dense.kernel_scale.copy_(torch.from_numpy(rng.uniform(
                    1e-3, 2e-3, 2048).astype(np.float32)))
                dense.bias.copy_(torch.from_numpy(
                    rng.randn(2048).astype(np.float32)))
                if dense.act_scale is not None:
                    dense.act_scale.fill_(3.0 / 127.0)
            card = Int8Dense(512, 2048).cuda()
            card.load_state_dict(dense.state_dict())
            for rows in INT8_DENSE_ROWS:
                x = torch.from_numpy(rng.randn(rows, 512).astype(
                    np.float32))
                want = dense(x, torch.float32)
                got = card(x.cuda(), torch.float32).cpu()
                err = float((got - want).abs().max())
                ok = err <= INT8_DENSE_TOL * max(1.0, float(
                    want.abs().max()))
                acc_equal = None
                if kwargs:
                    x_q = torch.from_numpy(rng.randint(
                        -127, 128, (rows, 512)).astype(np.int8))
                    acc_equal = bool(torch.equal(
                        int8_matmul(x_q.cuda(), card.kernel_q).cpu(),
                        int8_matmul(x_q, dense.kernel_q)))
                rows_out.append({"mode": mode, "rows": rows,
                                 "max_abs_err": err, "ok": ok,
                                 "acc_equal": acc_equal})
                if not ok or acc_equal is False:
                    raise AssertionError(f"Int8Dense on the card: "
                                         f"{rows_out[-1]}")
    finally:
        set_int8_serving(False)
    emit({"phase": "int8_dense_check", "tol": INT8_DENSE_TOL,
          "rows": rows_out})


def int8_serve_phase(seed, device="cuda"):
    """int8 serving against bf16 on the card.  Speech: the slice's
    ``speech_transformer_s`` beam-4 decode of 16 x 1024 frames
    (``INT8_SPEECH_REQUESTS`` timed requests) in bf16, weight-only int8, dynamic int8 and static int8
    (calibrated on the first request, as bench.py does): request ms,
    flash launches a request, rows equal to bf16, weight bytes at rest.
    Text: bench.py's batch-1 greedy ``transformer_base`` decode (source
    32, 64 steps) in the same four modes.  Returns the launch counts of
    the speech and the text runs."""
    import torch

    import neurst_tpu_torch
    from neurst_tpu_torch.layers.quantization.quant_layers import \
        calibrate_int8_act_scales
    from neurst_tpu_torch.layers.search.sampling import sequence_sampling
    from neurst_tpu_torch.models.transformer import Transformer
    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
    from neurst_tpu_torch.utils.param_policy import restore_inference_params

    if device == "cuda":
        int8_dense_check(seed)
    speech, speech_counts, ref = {}, {}, None
    try:
        for mode in ["bf16", *INT8_MODES]:
            _set_int8(mode)
            model, search, request = build_slice(seed, device)
            requests = [request() for _ in range(INT8_SPEECH_REQUESTS)]
            calibrated = None
            if mode == "int8_static":
                # bench.py's calibration: one request teacher-forced from
                # BOS (the predict entry's self-calibration runs in
                # qat_predict)
                calibrate_int8_act_scales(model, [dict(
                    requests[0], trg_input=torch.full(
                        (SLICE["batch"], 8), model.bos_id, device=device))])
                calibrated = sum(m.act_scale is not None
                                 for m in model.modules()
                                 if hasattr(m, "act_scale"))
            reset_launch_counts()
            outs, ms = _time_requests(search, requests)
            counts = launch_counts()
            hyps = torch.cat([h for h, _ in outs]).cpu()
            if ref is None:
                ref = hyps
            flash = counts["flash_attention_fwd"]
            if device == "cuda" and flash != model.encoder.num_layers * (
                    len(requests) + 1):
                raise AssertionError(f"int8_serve {mode}: flash {flash}")
            _no_fused_rows(counts, f"int8_serve {mode}")
            if not all(bool(torch.isfinite(s).all()) for _, s in outs):
                raise AssertionError(f"int8_serve {mode}: scores")
            speech[mode] = {"request_ms": ms,
                            "request_ms_median": float(np.median(ms)),
                            "rows_equal_to_bf16": float(
                                (hyps == ref).all(dim=1).float().mean()),
                            "weight_bytes": _weight_bytes(model),
                            "calibrated_denses": calibrated,
                            "flash_per_request": flash // (len(requests)
                                                           + 1)}
            for k, v in counts.items():
                speech_counts[k] = speech_counts.get(k, 0) + v
            del model, search
        emit({"phase": "int8_serve_speech", "model": SLICE["model"],
              "batch": SLICE["batch"], "frames": SLICE["frames"],
              "beam": SLICE["beam"], "max_decode": SLICE["max_decode"],
              "modes": speech})

        t = INT8_TEXT
        cfg = Transformer.build_model_args_by_name(t["model"])
        cfg = dict(cfg, **{"model.params": dict(cfg["model.params"],
                                                 dtype="bfloat16")})
        meta = {"vocab_size": t["vocab"], "eos_id": 1, "bos_id": 2,
                "unk_id": 3}
        flat = transformer_flat_params(cfg, t["vocab"], t["vocab"], seed)
        rng = np.random.RandomState(seed + 43)
        sources = [{"src": torch.from_numpy(rng.randint(
                        4, t["vocab"], (1, t["src_len"]))).to(device),
                    "src_padding": torch.zeros((1, t["src_len"]),
                                               device=device)}
                   for _ in range(t["requests"])]
        md = t["max_decode"]
        text, text_counts, ref = {}, {}, None
        for mode in ["bf16", *INT8_MODES]:
            _set_int8(mode)
            model = neurst_tpu_torch.build_model(cfg, src_meta=meta,
                                                 trg_meta=meta,
                                                 device=device)
            restore_inference_params(model, flat)
            if mode == "int8_static":
                calibrate_int8_act_scales(model, [dict(
                    sources[0], trg_input=torch.full(
                        (1, 8), meta["bos_id"], device=device))])

            def greedy(inputs, m=model):
                with torch.inference_mode():
                    fn, init = m.prepare_generation(inputs, md)
                    return sequence_sampling(
                        fn, init, top_k=1, maximum_decode_length=md,
                        extra_decode_length=md,
                        minimum_decode_length=md - 1)[0]

            reset_launch_counts()
            outs, ms = _time_requests(greedy, sources)
            counts = launch_counts()
            hyps = torch.cat(outs).cpu()
            if ref is None:
                ref = hyps
            _no_fused_rows(counts, f"int8_serve text {mode}")
            text[mode] = {"request_ms": ms,
                          "request_ms_median": float(np.median(ms)),
                          "rows_equal_to_bf16": float(
                              (hyps == ref).all(dim=1).float().mean()),
                          "weight_bytes": _weight_bytes(model)}
            for k, v in counts.items():
                text_counts[k] = text_counts.get(k, 0) + v
            del model
        emit({"phase": "int8_serve_text", "model": t["model"], "batch": 1,
              "src_len": t["src_len"], "max_decode": md, "modes": text})
    finally:
        _quantization_off()
    return speech_counts, text_counts


def build_moe_train(seed, overlay=None, device="cuda", dtype="bfloat16",
                    mesh=None, dropout=None):
    """bench.py's MoE cell: ``transformer_base`` in bf16 with the hparams
    set's dropout 0.1, its Adam and noam with clip norm 1, bf16 params
    with an f32 master, and, with ``overlay`` (an examples/moe yml), the
    overlay's ``moe_*`` fields; weights from the port's initializers
    seeded with ``seed``.  ``dtype`` "float32": float32 compute and
    params (the card-vs-CPU check).  ``mesh``: the model put on a
    data-parallel mesh (the experts split over its ranks) and the step
    reduced over it; ``dropout``: every site's rate instead of the
    hparams set's."""
    import torch
    import yaml

    import neurst_tpu_torch
    from neurst_tpu_torch.models.transformer import Transformer
    from neurst_tpu_torch.optimizers.master_weights import (
        cast_params_bf16, with_bf16_params)
    from neurst_tpu_torch.optimizers.optimizers import create_optax_chain
    from neurst_tpu_torch.parallel import TrainState, make_train_step

    cfg = Transformer.build_model_args_by_name(MOE["model"])
    params = dict(cfg["model.params"], dtype=dtype)
    if dropout is not None:
        for side in ("encoder", "decoder"):
            for rate in ("attention_dropout_rate", "ffn_dropout_rate",
                         "layer_postprocess_dropout_rate"):
                params[f"{side}.{rate}"] = dropout
    if overlay:
        here = os.path.dirname(os.path.abspath(__file__))
        with open(os.path.join(here, overlay)) as f:
            params.update(yaml.safe_load(f)["model.params"])
    cfg = dict(cfg, **{"model.params": params})
    meta = {"vocab_size": MOE["vocab"], "eos_id": 1, "bos_id": 2,
            "unk_id": 3}
    model = neurst_tpu_torch.build_model(cfg, src_meta=meta, trg_meta=meta,
                                         device=device)
    model.init_params(torch.Generator().manual_seed(seed))
    norm_fn = None
    if mesh is not None:
        from neurst_tpu_torch.parallel.sharding import (apply_mesh,
                                                        make_norm_fn)
        model.placement = apply_mesh(model, mesh)
        norm_fn = make_norm_fn(model.placement, mesh)
    lr = neurst_tpu_torch.build_lr_schedule(cfg)
    tx = create_optax_chain(neurst_tpu_torch.build_optimizer(cfg), lr,
                            clip_norm=NMT_TRAIN["clip_norm"],
                            norm_fn=norm_fn)
    if dtype == "bfloat16":
        cast_params_bf16(model)
        tx = with_bf16_params(tx)
    criterion = neurst_tpu_torch.build_criterion({
        "criterion.class": "label_smoothed_cross_entropy",
        "criterion.params": {"label_smoothing":
                             NMT_TRAIN["label_smoothing"]}})
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, criterion, tx, lr_schedule=lr, mesh=mesh,
                           norm_fn=norm_fn)
    return model, criterion, tx, state, step


def moe_bare_phase(seed, device="cuda"):
    """The dense model, the Switch MoE (8 experts, top-1, every 2nd FFN:
    the same active FLOPs a token) and the GShard top-2 MoE at [128,
    128]: 2 warm-up and 5 timed steps each, launches per step against
    the configuration (the dense layers' fused FFN at D 512, the experts'
    hidden a mask-kernel site), target tokens/s, the routing's cost.
    Then the kernels of this path against their plain versions at the
    shapes it gave them: rows 4-5 at [16384, 512] x 32768, rows 9-10 at
    [16384, 512, 2048] (rate 0 and 0.1), the mask kernel at each MoE's
    expert hidden [B, E, C, F] and at the residual sites' [16384, 512],
    bf16.  Returns the launch totals by label ("dense", "moe8_top1",
    "moe8_top2") and the kernel rows by kernel."""
    import torch

    from neurst_tpu_torch.layers.moe import MoeFFN
    from neurst_tpu_torch.utils.rng import make_key
    m, rows = MOE, MOE["batch"] * MOE["length"]
    out, totals, hidden = {}, {}, {}
    for label, overlay in (("dense", None), ("moe8_top1", m["switch"]),
                           ("moe8_top2", m["gshard"])):
        model, criterion, tx, state, step = build_moe_train(seed, overlay,
                                                            device)
        experts = sum(isinstance(x, MoeFFN) for x in model.modules())
        rng = np.random.RandomState(seed + 45)
        batches = [nmt_batch(rng, device, m["batch"], m["length"],
                             m["vocab"], m["vocab"])
                   for _ in range(m["warmup"] + m["steps"] + m["split"])]
        expected = expected_launches(model, rows, rows, True)
        run, totals[label] = _drive_train(
            model, criterion, tx, state, step, batches, m["warmup"],
            m["steps"], make_key(seed + 46), expected)
        aux = 0.0
        if experts:
            moe = next(x for x in model.modules() if isinstance(x, MoeFFN))
            hidden[label] = (m["batch"], moe.num_experts,
                             moe.capacity(m["length"], True),
                             moe.expert_dense1_kernel.shape[-1])
            with torch.no_grad():
                aux = float(model.call_train(batches[0], False,
                                             make_key(1))[1])
        out[label] = dict(run, moe_layers=experts,
                          layers=model.encoder.num_layers
                          + model.decoder.num_layers,
                          target_tokens_per_s=rows / (
                              run["step_ms_median"] / 1e3),
                          aux_loss=aux,
                          parameters=sum(p.numel()
                                         for p in model.parameters()))
        del model, state, step, tx
    out["routing_cost_share"] = 1.0 - (
        out["moe8_top1"]["target_tokens_per_s"]
        / out["dense"]["target_tokens_per_s"])
    emit({"phase": "moe_train", "model": m["model"],
          "batch": [m["batch"], m["length"]], "vocab": m["vocab"],
          "overlays": {"moe8_top1": m["switch"], "moe8_top2": m["gshard"]},
          **out})
    for label in ("moe8_top1", "moe8_top2"):
        if not out[label]["aux_loss"] > 0 or not out[label][
                "moe_layers"] == out["dense"]["layers"] // 2:
            raise AssertionError(f"moe_train {label}: {out[label]}")
    bf16 = (torch.bfloat16,)
    xent = xent_kernel_phase(seed + 2, [("moe_train", rows, m["vocab"], 512,
                                         bf16)])
    ffn = ffn_kernel_phase(seed + 2, [("moe_train", rows, 512)], bf16)
    drop = dropout_kernel_phase(seed + 2, [
        ("moe_expert_hidden", hidden["moe8_top1"]),
        ("moe_top2_expert_hidden", hidden["moe8_top2"]),
        ("moe_residual", (rows, 512))], bf16)
    checked = {
        "fused_linear_xent_fwd": xent[("fwd", "moe_train", "bfloat16")],
        "fused_linear_xent_bwd": xent[("bwd", "moe_train", "bfloat16")],
        "fused_ffn_fwd": ffn[("fwd", "moe_train", DROPOUT_RATE,
                              "bfloat16")],
        "fused_ffn_bwd": ffn[("bwd", "moe_train", DROPOUT_RATE,
                              "bfloat16")],
        "fused_dropout": drop[("moe_expert_hidden", "bfloat16")]}
    return totals, checked


def moe_reference_check(seed):
    """One float32 Switch MoE step (``MOE["switch"]`` over
    ``transformer_base``, the hparams set's dropout 0.1 and the router's
    jitter from the same key, [4, 16] ids, V 32768: every MoE layer drops
    tokens at capacity 3) on the card and on the CPU: the loss and the
    aux loss within ``TRAIN_REF_TOL[0]`` relative, each gradient (the
    routers' and the experts' included) within ``TRAIN_REF_TOL[1]`` by
    its relative L2 error, and rows 4-5 launched on the card."""
    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
    from neurst_tpu_torch.utils.rng import fold_in, make_key
    key = fold_in(make_key(seed + 48), 0)
    outs = {}
    for device in ("cuda", "cpu"):
        model, _, _, state, step = build_moe_train(seed, MOE["switch"],
                                                   device, "float32")
        batch = nmt_batch(np.random.RandomState(seed + 49), device, 4, 16,
                          MOE["vocab"], MOE["vocab"])
        reset_launch_counts()
        loss, aux, grads = step.compute_grads(state.params, batch, key)
        outs[device] = (float(loss), float(aux),
                        {n: g.cpu() for n, g in grads.items()},
                        launch_counts())
        del model, state, step
    (loss, aux, grads, counts), (ref_loss, ref_aux, ref_grads, _) = \
        outs["cuda"], outs["cpu"]
    grad_err, worst = max(
        (float((grads[n] - ref_grads[n]).norm()
               / ref_grads[n].norm().clamp_min(1e-30)), n)
        for n in ref_grads)
    row = {"phase": "moe_reference_check", "overlay": MOE["switch"],
           "dtype": "float32", "batch": [4, 16], "loss_card": loss,
           "loss_cpu": ref_loss, "aux_card": aux, "aux_cpu": ref_aux,
           "loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
           "aux_rel_err": abs(aux - ref_aux) / abs(ref_aux),
           "max_grad_rel_l2_err": grad_err, "worst_grad": worst,
           "expert_grads": sum("expert_" in n or "router_" in n
                               for n in ref_grads),
           "card_xent_launches": [counts["fused_linear_xent_fwd"],
                                  counts["fused_linear_xent_bwd"]],
           "tol": list(TRAIN_REF_TOL)}
    emit(row)
    if not (row["loss_rel_err"] <= TRAIN_REF_TOL[0] and ref_aux > 0
            and row["aux_rel_err"] <= TRAIN_REF_TOL[0]
            and grad_err <= TRAIN_REF_TOL[1] and row["expert_grads"]
            and min(row["card_xent_launches"]) > 0):
        raise AssertionError(f"MoE card vs CPU: {row}")
    return row


def _moe_trainer_config(root, overlay, steps, name):
    """mt_synth_base.yml (transformer_base on the committed reversal
    corpus) with an examples/moe overlay, ``steps`` steps, a log every
    step and one checkpoint, no validator."""
    import yaml
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, QAT["recipe"])) as f:
        cfg = json.loads(json.dumps(yaml.safe_load(f)).replace(
            '"examples/quality/', f'"{here}/examples/quality/'))
    with open(os.path.join(here, overlay)) as f:
        cfg["model.params"] = yaml.safe_load(f)["model.params"]
    cfg["entry.class"] = "trainer"
    for key in ("validator.class", "validator.params"):
        cfg["entry.params"].pop(key, None)
    cfg["entry.params"].update(train_steps=steps, summary_steps=1,
                               save_checkpoint_steps=steps,
                               enable_tensorboard=False)
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def moe_trainer_phases(seed, device="cuda"):
    """moe_trainer: the Switch overlay through ``--entry train
    --checkpoint_format orbax`` (12 steps on the mt_synth corpus, every
    step's launches against ``expected_launches``), moe_predict:
    ``--entry predict`` from its dir on dev's first 128 lines (beam 4,
    max 20, BLEU), then ``orbax_phase`` on the dir.  Under
    ``build/moe_smoke/``.  Returns the launch counts of the three
    runs."""
    from neurst_tpu_torch.tasks.translation import Translation
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "moe_smoke")
    here = os.path.dirname(os.path.abspath(__file__))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    counts = {}
    try:
        name, overlay, steps = "moe_trainer", MOE["switch"], \
            MOE["trainer_steps"]
        model_dir = os.path.join(root, name)
        _, seen = run_trainer(["--config_paths", _moe_trainer_config(
            root, overlay, steps, name), "--model_dir", model_dir,
            "--checkpoint_format", "orbax", "--device", device],
            Translation)
        _train_path_checks(seen, steps, name)
        by_shape = _step_launch_checks(seen, seen["model"]) \
            if device == "cuda" else None
        counts[name] = seen["launches"]
        emit(dict({"phase": name, "overlay": overlay,
                   "launches_per_step_by_shape": by_shape,
                   "launches": seen["launches"]},
                  **_trainer_numbers(seen, _peak_bytes(device))))
        dev = {}
        for side in ("src", "trg"):
            dev[side] = os.path.join(root, f"dev.{side}")
            with open(os.path.join(here, "examples", "quality",
                                   f"dev.{side}")) as f:
                lines = f.read().splitlines()[:128]
            with open(dev[side], "w") as f:
                f.write("\n".join(lines) + "\n")
        result, counts["moe_predict"], wall = _counted_predict([
            "--entry", "predict", "--model_dir", model_dir,
            "--metric", "bleu", "--dataset.class", "parallel_text",
            "--dataset.params", json.dumps(_parallel(dev)),
            "--search_method.params", json.dumps(
                {"beam_size": QAT["beam"],
                 "maximum_decode_length": QAT["max_decode"]}),
            "--batch_size", str(QAT["batch"]), "--device", device])
        if result["samples"] != 128 or not math.isfinite(result["BLEU"]):
            raise AssertionError(f"moe_predict: {result['samples']} "
                                 f"samples, BLEU {result['BLEU']}")
        emit({"phase": "moe_predict", "samples": result["samples"],
              "BLEU": result["BLEU"],
              "samples_per_s": result["samples_per_sec"],
              "wall_s": wall, "launches": counts["moe_predict"]})
        counts["orbax_resume"] = orbax_phase(root, model_dir, steps, device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts


ORBAX = dict(resume_steps=2,
             fixture=os.path.join("tests", "fixtures", "orbax_jax"))


def orbax_phase(root, model_dir, steps, device="cuda"):
    """``--checkpoint_format orbax`` on the card: the moe trainer's dir
    (``ckpt-<steps>.orbax``, each rank's OCDBT store and the root
    manifest, the port's optimizer sidecar beside it) resumed for 2 more
    steps through ``--entry train``, the new checkpoint read back bitwise
    equal to the trainer's float32 master.  Then the JAX package's
    checkpoint committed in ``tests/fixtures/orbax_jax`` (zstd-compressed
    chunks) read bitwise against its ``flat.npz``, and the C++ zstd
    decoder's seconds on its frames repeated to the float32 bytes of a
    ``transformer_base`` checkpoint.  The resumed run's steps and launches
    are checked as the trainer's (``_train_path_checks``,
    ``_step_launch_checks``).  Returns its launch counts."""
    import neurst_tpu_torch
    from neurst_tpu_torch.models.transformer import Transformer
    from neurst_tpu_torch.tasks.translation import Translation
    from neurst_tpu_torch.utils import checkpoints as ckpt_lib
    from neurst_tpu_torch.utils import ocdbt, zstd
    from neurst_tpu_torch.utils.param_bridge import state_dict_to_flat

    here = os.path.dirname(os.path.abspath(__file__))
    end = steps + ORBAX["resume_steps"]
    state, seen = run_trainer([
        "--config_paths", _moe_trainer_config(root, MOE["switch"], end,
                                              "orbax"),
        "--model_dir", model_dir, "--checkpoint_format", "orbax",
        "--save_checkpoint_steps", "1000", "--device", device], Translation)
    _train_path_checks(seen, end, "orbax_resume")
    by_shape = _step_launch_checks(seen, seen["model"]) \
        if device == "cuda" else None
    resumed = any(f"Restored optimizer state (step {steps})" in m
                  for m in seen["messages"])
    master = state.opt_state["master"] \
        if "master" in state.opt_state else state.params
    want = state_dict_to_flat(seen["model"], master)
    path = os.path.join(model_dir, f"ckpt-{end}.orbax")
    start = time.perf_counter()
    got = ckpt_lib.restore_checkpoint_params(path)
    read_s = time.perf_counter() - start
    bitwise = sorted(got) == sorted(want) and all(
        np.array_equal(got[k], want[k]) for k in want)
    files = sorted(os.listdir(model_dir))
    # the JAX package's checkpoint, and the zstd decoder on its frames
    fixture = os.path.join(here, ORBAX["fixture"])
    ours = ckpt_lib.restore_checkpoint_params(
        os.path.join(fixture, "ckpt-7.orbax"))
    with np.load(os.path.join(fixture, "flat.npz")) as data:
        fixture_bitwise = sorted(ours) == sorted(data.files) and all(
            np.array_equal(ours[k], data[k]) for k in data.files)
    store = ocdbt.OcdbtReader(os.path.join(fixture, "ckpt-7.orbax"))
    frames = [store.get(k) for k in store.keys()]
    frames = b"".join(f for f in frames if f[:4] == b"\x28\xb5\x2f\xfd")
    plain = len(zstd.decompress(frames))
    cfg = Transformer.build_model_args_by_name("transformer_base")
    meta = {"vocab_size": NMT_TRAIN["vocab"], "eos_id": 1}
    base = neurst_tpu_torch.build_model(cfg, src_meta=meta, trg_meta=meta,
                                        device="meta")
    base_bytes = 4 * sum(p.numel() for p in base.parameters())
    reps = -(-base_bytes // plain)
    buffer = frames * reps
    start = time.perf_counter()
    decoded = len(zstd.decompress(buffer))
    zstd_s = time.perf_counter() - start
    row = {"phase": "orbax", "overlay": MOE["switch"],
           "resumed_from_step": steps if resumed else None, "steps": end,
           "save_s": seen["save_s"],
           "checkpoint_bytes": sum(os.path.getsize(os.path.join(d, f))
                                   for d, _, fs in os.walk(path)
                                   for f in fs),
           "read_s": read_s, "read_bitwise": bitwise, "files": files,
           "jax_fixture_bitwise": fixture_bitwise,
           "zstd": {"frames_bytes": len(buffer), "decoded_bytes": decoded,
                    "transformer_base_bytes": base_bytes,
                    "seconds": zstd_s,
                    "decoded_mb_per_s": decoded / zstd_s / 1e6},
           "launches_per_step_by_shape": by_shape,
           "launches": seen["launches"]}
    emit(row)
    if not (bitwise and resumed and fixture_bitwise
            and f"ckpt-{end}.torch_optstate.npz" in files
            and f"ckpt-{steps}.orbax" in files and decoded == plain * reps):
        raise AssertionError(f"orbax phase: {row}")
    return seen["launches"]


class QatWorker(object):
    """qat_phases in a process of its own (``chip_smoke.py --qat_worker``),
    started once the kernels are built and joined after the audio prep's
    host stages, slice 10's conversions and the float32 card-vs-CPU
    checks: QAT's 300 host-bound steps run beside work that times
    nothing on the card but the parallel phase's ranks, whose times are
    no scaling figure (qat_train's step time is read beside that load).
    ``join`` prints the worker's lines as it printed them (their ``t_s``
    on this script's clock), fails if the worker failed, and returns its
    launch counts (qat_train's, qat_predict's); the worker is stopped if
    it is still running."""

    def __init__(self, seed):
        here = os.path.dirname(os.path.abspath(__file__))
        self.log_path = os.path.join(here, "build", "qat_worker.log")
        os.makedirs(os.path.dirname(self.log_path), exist_ok=True)
        self.started = time.perf_counter()
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--seed",
                 str(seed), "--qat_worker", "--t0", repr(_START)],
                stdout=log, stderr=subprocess.STDOUT, cwd=here)
        self.counts = None

    def join(self):
        waited = time.perf_counter()
        try:
            rc = self.proc.wait(timeout=QAT["worker_timeout_s"])
        finally:
            self.stop()
        with open(self.log_path) as f:
            lines = f.read().splitlines()
        for line in lines:
            print(line, flush=True)
        counts = [json.loads(line)["qat_worker_launches"] for line in lines
                  if line.startswith('{"qat_worker_launches"')]
        if rc != 0 or not counts:
            raise AssertionError(f"the QAT worker failed (exit {rc})")
        self.counts = counts[-1]
        emit({"phase": "qat_worker", "run_s": time.perf_counter()
              - self.started, "waited_s": time.perf_counter() - waited,
              "beside": ["prep_records", "prep_project", "convert",
                         "reference_check", "train_reference_check",
                         "qat_dense_check", "qat_reference_check",
                         "moe_reference_check"]})
        return self.counts

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

# Slice 13.  pruning_trainer: examples/weight_pruning/training_args.yml as
# it is (polynomial decay to 0.8, every variable but LayerNorms, biases
# and the modalities) on the text train entry's corpus and model
# (``NMT_TRAINER``: transformer_base, V 32768 a side, 32768-token
# buckets, bf16 + f32 master, dropout 0.1), its begin / end / frequency
# (10000 / 80000 / 100) cut to 2 / 10 / 4 so that 12 steps refresh the
# masks three times and end at the final sparsity; prune_tune, 6 steps of
# the PruneTune plug-in (``--include``) from that dir with float32 stored
# params (a bf16 copy would round the dense slots), then ``mask_predict``
# against the general dir's ``predict``.
PRUNING = dict(recipe=os.path.join("examples", "weight_pruning",
                                   "training_args.yml"),
               steps=12, begin=2, end=10, frequency=4, tune_steps=6,
               dev_lines=32, predict_batch=32,
               search={"beam_size": 4, "length_penalty": 0.6,
                       "maximum_decode_length": 40})
PLUGINS = os.path.join("neurst_tpu_torch", "contrib", "prune_tune")


def _zero_shares(flat):
    return {name: float((np.asarray(w) == 0).mean())
            for name, w in flat.items()}


def pruning_phases(seed, device="cuda"):
    """pruning_trainer and prune_tune (``PRUNING``) under
    ``build/prune_smoke/``, removed after.  Returns their launch counts by
    path."""
    import yaml

    from neurst_tpu_torch.cli import run_exp
    from neurst_tpu_torch.sparsity import (build_pruning_schedule,
                                           make_variable_filter)
    from neurst_tpu_torch.tasks.translation import Translation
    from neurst_tpu_torch.utils.checkpoints import (latest_checkpoint,
                                                    restore_checkpoint_params)

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "build", "prune_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t, p = NMT_TRAINER, PRUNING
    try:
        rng = np.random.RandomState(seed + 130)
        words, pipelines = {}, {}
        for side, language in (("src", "en"), ("trg", "de")):
            vocab = os.path.join(root, f"vocab.{side}")
            words[side] = write_word_vocab(vocab, rng, t["vocab"] - 3)
            pipelines[side] = {"vocab_path": vocab, "language": language}
        train = write_parallel(os.path.join(root, "train"), rng,
                               words["src"], words["trg"], t["pairs"],
                               t["min_tokens"], t["max_tokens"])
        dev = write_parallel(os.path.join(root, "dev"), rng, words["src"],
                             words["trg"], p["dev_lines"], t["min_tokens"],
                             t["max_tokens"])
        with open(os.path.join(here, p["recipe"])) as f:
            entry = yaml.safe_load(f)["entry.params"]
        entry["pruning_schedule.params"] = dict(
            entry["pruning_schedule.params"], begin_pruning_step=p["begin"],
            end_pruning_step=p["end"], pruning_frequency=p["frequency"])
        general = os.path.join(root, "general")
        cfg = nmt_config(os.path.join(root, "prune.json"), pipelines,
                         ("parallel_text", _parallel(train)),
                         train_steps=p["steps"], summary_steps=2,
                         save_checkpoint_steps=p["steps"], **entry)
        _reset_peak(device)
        _, seen = run_trainer(["--config_paths", cfg, "--model_dir", general,
                               "--device", device], Translation,
                              time_steps=True)
        _train_path_checks(seen, p["steps"], "pruning_trainer")
        by_shape = _step_launch_checks(seen, seen["model"])
        schedule = build_pruning_schedule(entry)
        refresh = [i for i in range(p["steps"]) if schedule.should_prune(i)]
        target = float(schedule.target_sparsity(refresh[-1]))
        pruned = make_variable_filter(entry.get("pruning_variable_pattern"),
                                      entry.get("nopruning_variable_pattern"))
        flat = restore_checkpoint_params(latest_checkpoint(general))
        shares = _zero_shares(flat)
        # the quantile's index rounds (2 / n); weights tied at the
        # threshold are pruned with it, as in JAX (``|w| > threshold``
        # keeps), which may add a few more zeros
        off = {n: z for n, z in shares.items() if pruned(n)
               and not target - 2.0 / flat[n].size <= z <= target + 1e-4}
        dense = {n: z for n, z in shares.items() if not pruned(n)
                 and z >= 0.5}
        plain = [s["ms"] for i, s in enumerate(seen["steps"])
                 if i and i not in refresh]
        row = dict(_trainer_numbers(seen, _peak_bytes(device)),
                   phase="pruning_trainer", model=t["hparams_set"],
                   dtype="bfloat16", recipe=p["recipe"],
                   schedule=entry["pruning_schedule.params"],
                   refresh_steps=[i + 1 for i in refresh],
                   target_sparsity=target,
                   pruned_variables=sum(map(pruned, flat)),
                   dense_variables=sum(not pruned(n) for n in flat),
                   zero_share_pruned=[min(shares[n] for n in flat
                                          if pruned(n)),
                                      max(shares[n] for n in flat
                                          if pruned(n))],
                   zero_share_dense_max=max(shares[n] for n in flat
                                            if not pruned(n)),
                   refresh_step_ms=[seen["steps"][i]["ms"] for i in refresh],
                   plain_step_ms_median=float(np.median(plain)),
                   step_ms=[s["ms"] for s in seen["steps"]],
                   step_shapes=[[s["src"], s["trg"]] for s in seen["steps"]],
                   launches_per_step_by_shape=by_shape)
        emit(row)
        if off or dense or len(refresh) != 3:
            raise AssertionError(f"pruning_trainer: sparsity off target "
                                 f"{off}, excluded variables sparse {dense}, "
                                 f"refreshes {refresh}")
        counts = {"pruning_trainer": seen["launches"]}

        tuned = os.path.join(root, "tuned")
        cfg = nmt_config(os.path.join(root, "tune.json"), pipelines,
                         ("parallel_text", _parallel(train)),
                         train_steps=p["tune_steps"], summary_steps=2,
                         save_checkpoint_steps=p["tune_steps"],
                         bf16_params=False, mask_dir=general)
        _reset_peak(device)
        _, seen = run_trainer(
            ["--entry", "partial_tune", "--include",
             os.path.join(here, PLUGINS, "partial_trainer.py"),
             "--config_paths", cfg, "--model_dir", tuned, "--pretrain_model",
             general, "--device", device], Translation)
        _train_path_checks(seen, p["tune_steps"], "prune_tune")
        by_shape = _step_launch_checks(seen, seen["model"])
        counts["prune_tune"] = seen["launches"]
        after = restore_checkpoint_params(latest_checkpoint(tuned))
        changed, moved, slots = [], 0, 0
        for name, w in flat.items():
            keep = w != 0
            if not np.array_equal(after[name][keep], w[keep]):
                changed.append(name)
            moved += int((after[name][~keep] != 0).sum())
            slots += int((~keep).sum())
        predict = os.path.join(root, "predict.json")
        with open(predict, "w") as f:
            json.dump({"dataset.class": "ParallelTextDataset",
                       "dataset.params": _parallel(dev),
                       "batch_size": p["predict_batch"],
                       "search_method.class": "beam_search",
                       "search_method.params": p["search"]}, f)
        start = time.perf_counter()
        general_hyps = run_exp.cli_main(
            ["--entry", "predict", "--config_paths", predict, "--model_dir",
             general, "--device", device])["hypotheses"]
        predict_s = time.perf_counter() - start
        start = time.perf_counter()
        masked_hyps = run_exp.cli_main(
            ["--entry", "mask_predict", "--include",
             "neurst_tpu_torch.contrib.prune_tune.mask_sequence_generator",
             "--mask_from_ckpt", general, "--config_paths", predict,
             "--model_dir", tuned, "--device", device])["hypotheses"]
        mask_predict_s = time.perf_counter() - start
        row = dict(_trainer_numbers(seen, _peak_bytes(device)),
                   phase="prune_tune", model=t["hparams_set"],
                   dtype="bfloat16", bf16_params=False,
                   tunable_slots=slots, tunable_slots_moved=moved / slots,
                   dense_slots_changed=changed,
                   launches_per_step_by_shape=by_shape,
                   mask_predict_equals_general_predict=masked_hyps
                   == general_hyps, predict_lines=len(general_hyps),
                   predict_s=predict_s, mask_predict_s=mask_predict_s)
        emit(row)
        if changed or not row["mask_predict_equals_general_predict"] \
                or len(general_hyps) != p["dev_lines"] or not moved:
            raise AssertionError(f"prune_tune phase failed: {row}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts


# export_speech: the export entry on st_decode_s_flash's model and
# requests (speech_transformer_s, bf16 at rest, encoder flash, 16 x 1024
# frames, beam 4, 64 steps), the programs reloaded in a process of their
# own that imports ``neurst_tpu_torch.exps.export`` alone
EXPORT = dict(requests=3)
EXPORT_SERVE = r"""
import json, sys, time
import numpy as np
import torch
from neurst_tpu_torch.exps.export import load_exported
from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
path, inputs, out = sys.argv[1:4]
start = time.perf_counter()
gen = load_exported(path, "cuda")
load_s = time.perf_counter() - start
with np.load(inputs) as data:
    requests = [{"src": data[f"src_{i}"], "src_length": data[f"len_{i}"]}
                for i in range(int(data["n"]))]
gen(requests[0])
torch.cuda.synchronize()
reset_launch_counts()
hyps, scores, ms, per_request = [], [], [], []
for r in requests:
    before = launch_counts()["flash_attention_fwd"]
    start = time.perf_counter()
    h, s = gen(r)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - start) * 1e3)
    per_request.append(launch_counts()["flash_attention_fwd"] - before)
    hyps.append(h.cpu().numpy())
    scores.append(s.float().cpu().numpy())
np.savez(out, hyps=np.stack(hyps), scores=np.stack(scores))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "neurst_tpu"))
print(json.dumps({"request_ms": ms, "load_s": load_s,
                  "launches": launch_counts(),
                  "flash_per_request": per_request, "leaked": leaked}))
"""


def export_speech_phase(seed):
    """The export entry through ``run_exp`` on the predict phase's model
    dir (written again under ``build/export_smoke/``, removed after):
    export seconds, the artifact's bytes, 12 flash custom-op nodes in the
    encode program; the reloaded programs' hypotheses and scores on the
    slice's requests equal the eager ``BeamSearch``'s on the card, and
    the request ms of both.  Returns the launch counts of the reloaded
    programs' requests."""
    import torch

    from neurst_tpu_torch.cli import run_exp
    from neurst_tpu_torch.exps.base_experiment import BaseExperiment
    from neurst_tpu_torch.exps.export import ENCODE_FILE
    from neurst_tpu_torch.layers.search.sequence_search import \
        build_search_layer
    from neurst_tpu_torch.tasks.task import build_task
    from neurst_tpu_torch.utils.configurable import ModelConfigs

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "build", "export_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    search = {"beam_size": SLICE["beam"],
              "maximum_decode_length": SLICE["max_decode"],
              "extra_decode_length": SLICE["max_decode"],
              "minimum_decode_length": SLICE["max_decode"] - 1}
    b, frames = SLICE["batch"], SLICE["frames"]
    try:
        model_dir = write_predict_dir(seed, root)["model_dir"]
        path = os.path.join(root, "export")
        start = time.perf_counter()
        run_exp.cli_main(["--entry", "export", "--model_dir", model_dir,
                          "--export_path", path, "--export_batch_size",
                          str(b), "--export_src_length", str(frames),
                          "--search_method.params", json.dumps(search),
                          "--device", "cuda"])
        export_s = time.perf_counter() - start
        files = {f: os.path.getsize(os.path.join(path, f))
                 for f in sorted(os.listdir(path))}
        program = torch.export.load(os.path.join(path, ENCODE_FILE))
        flash_nodes = sum(
            1 for n in program.graph.nodes if n.op == "call_function"
            and "neurst_tpu_torch.flash_attention_fwd" in str(n.target))
        del program
        rng = np.random.RandomState(seed + 131)
        requests = [{"src": rng.randn(b, frames, SLICE["feature_dim"],
                                      1).astype(np.float32),
                     "src_length": rng.randint(SLICE["min_src"], frames + 1,
                                               size=b).astype(np.int32)}
                    for _ in range(EXPORT["requests"])]
        inputs = os.path.join(root, "requests.npz")
        np.savez(inputs, n=len(requests), **{
            f"{k}_{i}": r[key] for i, r in enumerate(requests)
            for k, key in (("src", "src"), ("len", "src_length"))})
        out = os.path.join(root, "served.npz")
        proc = subprocess.run([sys.executable, "-c", EXPORT_SERVE, path,
                               inputs, out], cwd=here, capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"export_speech: the reloaded programs "
                                 f"failed: {proc.stderr[-4000:]}")
        served = json.loads(proc.stdout.strip().splitlines()[-1])
        with np.load(out) as data:
            hyps, scores = data["hyps"], data["scores"]

        cfg = ModelConfigs.load(model_dir)
        model = build_task(cfg).build_model(cfg, device="cuda")
        BaseExperiment(model=model, model_dir=model_dir).restore_params()
        beam = build_search_layer({"search_method.class": "beam_search",
                                   "search_method.params": search})
        beam.set_model(model)
        torch_inputs = [{k: torch.from_numpy(v).cuda() for k, v in r.items()}
                        for r in requests]
        beam(torch_inputs[0])
        eager_ms, equal_hyps, equal_scores, score_diff = [], [], [], []
        for i, r in enumerate(torch_inputs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            h, s = beam(r)
            torch.cuda.synchronize()
            eager_ms.append((time.perf_counter() - start) * 1e3)
            equal_hyps.append(bool(np.array_equal(h.cpu().numpy(),
                                                  hyps[i])))
            s = s.float().cpu().numpy()
            equal_scores.append(bool(np.array_equal(s, scores[i])))
            score_diff.append(float(np.abs(s - scores[i]).max()))
        row = {"phase": "export_speech", "model": PREDICT["model"],
               "dtype": "bfloat16", "batch": b, "frames": frames,
               "search": search, "export_s": export_s,
               "artifact_bytes": sum(files.values()), "files": files,
               "flash_custom_op_nodes": flash_nodes,
               "expected_flash_nodes": model.encoder.num_layers,
               "served_request_ms": served["request_ms"],
               "eager_request_ms": eager_ms,
               "served_load_s": served["load_s"],
               "served_flash_per_request": served["flash_per_request"],
               "served_leaked_modules": served["leaked"],
               "hypotheses_equal_eager": equal_hyps,
               "scores_equal_eager": equal_scores,
               "score_max_abs_diff": score_diff}
        emit(row)
        if not (flash_nodes == model.encoder.num_layers and all(equal_hyps)
                and served["flash_per_request"] == [flash_nodes]
                * len(requests) and not served["leaked"]):
            raise AssertionError(f"export_speech phase failed: {row}")
        counts = {"export_speech": dict(served["launches"])}
        counts.update(export_search_phases(model, model_dir, root,
                                           requests, torch_inputs))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts


EXPORT_SEARCHES = {
    "export_sampling": ("top_sampling", {"top_k": 8, "top_p": 0.9,
                                         "temperature": 1.2, "seed": 5}),
    "export_speculative": ("speculative_decode", {
        "draft_method": "ngram", "speculative_k": 4})}


def export_search_phases(model, model_dir, root, requests, torch_inputs):
    """``top_sampling`` and ``speculative_decode`` (the n-gram draft)
    exported from the speech model dir and loaded on the card: each
    request's tokens equal the eager search's on the card (sampling under
    its seed), and the speculative rows equal plain greedy decoding's up
    to the first EOS.  Returns the loaded programs' launch counts by
    path."""
    import torch

    from neurst_tpu_torch.cli import run_exp
    from neurst_tpu_torch.exps.export import load_exported
    from neurst_tpu_torch.layers.search.sequence_search import \
        build_search_layer
    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts

    b, frames = SLICE["batch"], SLICE["frames"]
    length = {"maximum_decode_length": SLICE["max_decode"],
              "extra_decode_length": SLICE["max_decode"]}
    greedy = build_search_layer({
        "search_method.class": "beam_search",
        "search_method.params": dict(length, beam_size=1)})
    greedy.set_model(model)
    eos = model.generation_meta["eos_id"]

    def until_eos(rows):
        return [r[:r.index(eos) + 1] if eos in r else r for r in rows]

    counts = {}
    for name, (method, params) in EXPORT_SEARCHES.items():
        params = dict(params, **length)
        path = os.path.join(root, name)
        start = time.perf_counter()
        run_exp.cli_main(["--entry", "export", "--model_dir", model_dir,
                          "--export_path", path, "--export_batch_size",
                          str(b), "--export_src_length", str(frames),
                          "--search_method", method,
                          "--search_method.params", json.dumps(params),
                          "--device", "cuda"])
        export_s = time.perf_counter() - start
        gen = load_exported(path, "cuda")
        eager = build_search_layer({"search_method.class": method,
                                    "search_method.params": params})
        eager.set_model(model)
        eager.prepare()
        gen(requests[0])
        torch.cuda.synchronize()
        reset_launch_counts()
        served_ms, eager_ms, equal, greedy_equal = [], [], [], []
        for r, tr in zip(requests[:1], torch_inputs[:1]):
            start = time.perf_counter()
            hyp, _ = gen(r)
            torch.cuda.synchronize()
            served_ms.append((time.perf_counter() - start) * 1e3)
            if len(served_ms) == 1:
                counts[name] = launch_counts()
            start = time.perf_counter()
            want, _ = eager(tr)
            torch.cuda.synchronize()
            eager_ms.append((time.perf_counter() - start) * 1e3)
            equal.append(bool(torch.equal(hyp.cpu(), want.cpu())))
            if method == "speculative_decode":
                plain, _ = greedy(tr)
                greedy_equal.append(until_eos(hyp.cpu().tolist())
                                    == until_eos(plain.cpu().tolist()))
        row = {"phase": name, "search": method, "params": params,
               "export_s": export_s, "served_request_ms": served_ms,
               "eager_request_ms": eager_ms, "tokens_equal_eager": equal,
               "rows_equal_plain_greedy": greedy_equal,
               "launches": counts[name]}
        emit(row)
        if not all(equal) or not all(greedy_equal) \
                or not counts[name]["flash_attention_fwd"]:
            raise AssertionError(f"{name}: {row}")
    return counts


def remat_step_phase(seed, train_dropout_row):
    """train_dropout's step (``speech_transformer_s``, 40 x 3000 frames,
    bf16 + f32 master, dropout 0.1, its batches and key) with and without
    ``gradient_remat``: the first batch's loss bitwise equal and its
    gradients within the bf16 backward tolerance (relative L2); launches
    a step with the forward kernels counted twice (and the mask kernel's
    forward sites); step ms and peak memory of both.  Returns the remat
    steps' launch counts."""
    import torch

    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
    from neurst_tpu_torch.utils.rng import fold_in, make_key

    key = make_key(seed + 7)
    rng = np.random.RandomState(seed + 3)
    batches = [train_batch(rng, "cuda", TRAIN["batch"], TRAIN["frames"],
                           TRAIN["min_src"], TRAIN["trg_len"],
                           TRAIN["min_trg"])
               for _ in range(TRAIN["warmup"] + TRAIN["steps"])]
    runs, first = {}, {}
    for remat in (False, True):
        model, _, _, state, step = build_train(seed, dropout=DROPOUT_RATE,
                                               remat=remat)
        expected = expected_launches(
            model, TRAIN["batch"] * TRAIN["frames"] // 4,
            TRAIN["batch"] * TRAIN["trg_len"], True)
        if remat:
            for name in ("flash_attention_fwd", "fused_ffn_fwd",
                         "fused_linear_xent_fwd"):
                expected[name] *= 2
            expected["fused_dropout"] = expected["fused_dropout"] * 3 // 2
        loss, _, grads = step.compute_grads(state.params, batches[0],
                                            fold_in(key, 0))
        first[remat] = (loss, {n: g.float() for n, g in grads.items()})
        del grads
        for batch in batches[:TRAIN["warmup"]]:
            state, _ = step(state, batch, key)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms, totals = [], {}
        for batch in batches[TRAIN["warmup"]:]:
            reset_launch_counts()
            start = time.perf_counter()
            state, _ = step(state, batch, key)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - start) * 1e3)
            counts = launch_counts()
            if counts != expected:
                raise AssertionError(f"remat={remat}: launches in a step "
                                     f"{counts}, expected {expected}")
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
        runs[remat] = {"step_ms": step_ms,
                       "step_ms_median": float(np.median(step_ms)),
                       "max_memory_allocated":
                       torch.cuda.max_memory_allocated(),
                       "launches_per_step": expected, "totals": totals}
        del model, state, step
        torch.cuda.empty_cache()
    errs = {n: float(torch.linalg.vector_norm(g - first[False][1][n])
                     / torch.linalg.vector_norm(first[False][1][n])
                     .clamp_min(1e-30))
            for n, g in first[True][1].items()}
    worst = max(errs, key=errs.get)
    row = {"phase": "remat_step", "model": TRAIN["model"],
           "dtype": "bfloat16", "dropout": DROPOUT_RATE,
           "batch": TRAIN["batch"], "frames": TRAIN["frames"],
           "loss": [float(first[False][0]), float(first[True][0])],
           "loss_equal": bool(torch.equal(first[False][0], first[True][0])),
           "grad_rel_l2_max": errs[worst], "grad_rel_l2_worst": worst,
           "grads_bitwise_equal": sum(v == 0.0 for v in errs.values()),
           "grads": len(errs), "plain": runs[False], "remat": runs[True],
           "train_dropout_step_ms_median":
           train_dropout_row["step_ms_median"]}
    emit(row)
    if not row["loss_equal"] or errs[worst] > BWD_TOL["bfloat16"]:
        raise AssertionError(f"remat_step phase failed: {row}")
    return runs[True]["totals"]


def dispatch_phase(seed):
    """The host cost of a call of the flash forward's and the fused FFN
    forward's wrappers (through their custom ops): wall time a call of
    200 calls back to back at shapes whose device work is a few us
    (decode [16, 256, 4, 64], FFN [64, 256] x 1024), beside the device
    time of one call (``time_ms``)."""
    import torch

    from neurst_tpu_torch.ops.flash_attention import flash_attention_fwd
    from neurst_tpu_torch.ops.fused_ffn import fused_ffn_fwd

    g = torch.Generator(device="cuda").manual_seed(seed + 132)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    q, k, v = (randn(16, 256, 4, 64) for _ in range(3))
    lengths = torch.full((16,), 256, dtype=torch.int32, device="cuda")
    x, w1, w2 = randn(64, 256), randn(1024, 256), randn(256, 1024)
    b1 = randn(1024, dtype=torch.float32)
    b2 = randn(256, dtype=torch.float32)
    calls = {"flash_attention_fwd": lambda: flash_attention_fwd(q, k, v,
                                                                lengths),
             "fused_ffn_fwd": lambda: fused_ffn_fwd(x, w1, b1, w2, b2)}
    row = {"phase": "dispatch", "calls": 200}
    for name, fn in calls.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        row[name] = {"wall_us_a_call": (time.perf_counter() - start)
                     / 200 * 1e6, "device_us_a_call": time_ms(fn) * 1e3}
    emit(row)
    return row


# The parallel stack (slice 14): one launch of PARALLEL["world"] ranks on
# the one card, gloo between them (NCCL takes one rank a card), each rank
# a process of this script (``--parallel_rank``); then a one-rank NCCL
# group in this process over the collectives.  The ranks share the card,
# so their step times are no scaling figure.
PARALLEL = dict(world=2, nmt_steps=2, trainer_steps=4, trainer_pairs=1000,
                ring_batch=4, pp_batch=8, pp_frames=1024, pp_trg_len=60,
                microbatches=4, decode_requests=1)
# float32 across ranks against one rank: sums in other orders (loss and
# grad norm relative; each gradient by its relative L2 error); bf16 by the
# loss; the ring encoder's output max abs and its gradients' relative L2
# (a LayerNorm scale's gradient sums 32768 positions' products in another
# order: 8.4e-4 measured on the H100)
PARALLEL_TOL = {"loss": 1e-4, "grad": 5e-3, "bf16_loss": 2e-2,
                "ring_out": 1e-3, "ring_grad": 2e-3}


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30))


def _grad_errs(grads, ref):
    """The worst relative L2 error of ``grads`` (whole tensors, by name)
    against ``ref``."""
    return max((_rel_l2(grads[n].cpu(), ref[n]), n) for n in ref)


def _whole_grads(model, grads, mesh):
    from neurst_tpu_torch.parallel.mesh import params_shardings
    from neurst_tpu_torch.parallel.sharding import gather_tensors
    return {n: g.cpu() for n, g in gather_tensors(
        grads, params_shardings(model, mesh) if mesh.shape["model"] > 1
        else {}, mesh).items()}


def _rows_of(batch, mesh):
    from neurst_tpu_torch.parallel.utils import data_slice
    rows = next(iter(batch.values())).shape[0]
    sl = data_slice(rows, mesh)
    return {k: v[sl] for k, v in batch.items()}


def parallel_nmt_steps(seed, rank):
    """transformer_base bare steps at bench.py's train cell ([256, 128],
    V 32768 a side) over dp 2 (dropout 0.1) and tp 2 (dropout 0):
    float32 against the one-rank float32 step (rank 0 computes it), bf16
    by the loss against the same step's, and each bf16 step's launches of
    rows 4/5/8/9/10 against ``expected_launches`` at the rank's rows and
    against the one-rank counts."""
    import torch

    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
    from neurst_tpu_torch.parallel.mesh import make_mesh
    from neurst_tpu_torch.utils.rng import fold_in, make_key

    from neurst_tpu_torch.models.transformer import Transformer

    t = NMT_TRAIN
    key = make_key(seed + 9)
    batch = nmt_batch(np.random.RandomState(seed + 10), "cuda", t["batch"],
                      t["length"], t["vocab"], t["vocab"])
    # one draw of the seeded weights for the five builds
    flat = transformer_flat_params(
        Transformer.build_model_args_by_name(t["model"]), t["vocab"],
        t["vocab"], seed)
    out = {}
    for mode, dropout in (("dp", DROPOUT_RATE), ("tp", 0.0)):
        drop_key = fold_in(key, 0) if dropout else None
        refs = {}
        if rank == 0:
            # one float32 step: the bf16 runs are held to its loss
            model, _, _, state, step = build_nmt_train(
                seed, "cuda", "float32", False, dropout, flat=flat)
            loss, _, grads = step.compute_grads(state.params, batch,
                                                drop_key)
            refs["float32"] = (float(loss), {n: g.cpu() for n, g in
                                             grads.items()})
            refs["bfloat16"] = (float(loss), None)
            rows = t["batch"] * t["length"]
            # which kernels one rank's step launches (in either dtype)
            refs["launches"] = expected_launches(model, rows, rows,
                                                 bool(dropout))
            del model, state, step, grads
            torch.cuda.empty_cache()
        torch.distributed.barrier()
        mesh = make_mesh(model_parallel=2 if mode == "tp" else 1)
        local = _rows_of(batch, mesh)
        row = {}
        for dtype in ("float32", "bfloat16"):
            model, _, _, state, step = build_nmt_train(
                seed, "cuda", dtype, dtype == "bfloat16", dropout,
                mesh=mesh, flat=flat)
            rows = local["trg"].shape[0] * t["length"]
            expected = expected_launches(model, rows, rows, bool(dropout))
            loss, _, grads = step.compute_grads(state.params, local,
                                                drop_key)
            whole = _whole_grads(model, grads, mesh)
            del grads
            torch.cuda.synchronize()
            reset_launch_counts()
            step_ms = []
            # the float32 model is the check; bf16 is timed and counted
            steps = PARALLEL["nmt_steps"] if dtype == "bfloat16" else 0
            metrics = {"grad_norm": float("nan")}
            for _ in range(steps):
                start = time.perf_counter()
                state, metrics = step(state, local, key)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - start) * 1e3)
            counts = launch_counts()
            per_step = {k: v // max(steps, 1) for k, v in counts.items()}
            row[dtype] = {"loss": float(loss), "step_ms": step_ms,
                          "grad_norm": float(metrics["grad_norm"]),
                          "launches_per_step": per_step,
                          "expected_launches_per_step": expected,
                          "counts": counts}
            if rank == 0:
                ref_loss, ref_grads = refs[dtype]
                row[dtype]["ref_loss"] = ref_loss
                loss_err = abs(float(loss) - ref_loss) / abs(ref_loss)
                tol = PARALLEL_TOL["loss" if dtype == "float32"
                                   else "bf16_loss"]
                if not loss_err <= tol:
                    raise AssertionError(f"{mode} {dtype} loss {loss} vs one "
                                         f"rank {ref_loss}")
                if ref_grads is not None:
                    err, worst = _grad_errs(whole, ref_grads)
                    row[dtype]["grad_rel_l2"] = [err, worst]
                    if not err <= PARALLEL_TOL["grad"]:
                        raise AssertionError(f"{mode} gradient {worst}: "
                                             f"{err}")
                single = refs["launches"]
                row[dtype]["one_rank_launches_per_step"] = single
                rows_4_5_8_9_10 = ("fused_linear_xent_fwd",
                                   "fused_linear_xent_bwd", "fused_dropout",
                                   "fused_ffn_fwd", "fused_ffn_bwd")
                for name in rows_4_5_8_9_10 if steps else ():
                    if bool(single[name]) != bool(per_step[name]):
                        raise AssertionError(
                            f"{mode} {name}: {per_step[name]} a step, one "
                            f"rank {single[name]}")
            if steps and per_step != expected:
                raise AssertionError(f"{mode} {dtype} launches {per_step}, "
                                     f"expected {expected}")
            del model, state, step, whole
            torch.cuda.empty_cache()
        out[mode] = row
    return out


def parallel_speech_dp(seed, rank):
    """dp 2 of the MuST-C recipe's step (speech_transformer_s with flash
    attention and dropout 0.1 at every site) at the train phase's batch,
    float32: each rank draws its rows' masks of the one-rank step, rows
    1-3 and 8-10 at a nonzero element offset on rank 1, so the loss and
    every gradient are held to the one-rank step's (rank 0 computes it),
    and each rank's launches to ``expected_launches`` at its rows."""
    import torch

    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
    from neurst_tpu_torch.parallel.mesh import make_mesh
    from neurst_tpu_torch.utils.rng import fold_in, make_key

    key = fold_in(make_key(seed + 7), 0)
    batch = train_batch(np.random.RandomState(seed + 3), "cuda",
                        TRAIN["batch"], TRAIN["frames"], TRAIN["min_src"],
                        TRAIN["trg_len"], TRAIN["min_trg"])
    ref = None
    if rank == 0:
        model, _, _, state, step = build_train(seed, dtype="float32",
                                               dropout=DROPOUT_RATE)
        loss, _, grads = step.compute_grads(state.params, batch, key)
        ref = (float(loss), {n: g.cpu() for n, g in grads.items()})
        del model, state, step, grads
        torch.cuda.empty_cache()
    torch.distributed.barrier()
    mesh = make_mesh()
    model, _, _, state, step = build_train(seed, dtype="float32",
                                           dropout=DROPOUT_RATE, mesh=mesh)
    local = _rows_of(batch, mesh)
    rows = local["src"].shape[0]
    expected = expected_launches(model, rows * TRAIN["frames"] // 4,
                                 rows * TRAIN["trg_len"], True)
    step.compute_grads(state.params, local, key)
    torch.cuda.synchronize()
    reset_launch_counts()
    start = time.perf_counter()
    loss, _, grads = step.compute_grads(state.params, local, key)
    torch.cuda.synchronize()
    row = {"step_ms": (time.perf_counter() - start) * 1e3, "rows": rows,
           "loss": float(loss), "launches": launch_counts(),
           "expected_launches": expected}
    whole = _whole_grads(model, grads, mesh)
    del grads
    if row["launches"] != expected:
        raise AssertionError(f"speech dp2 launches {row['launches']}, "
                             f"expected {expected}")
    if rank == 0:
        loss_err = abs(row["loss"] - ref[0]) / abs(ref[0])
        err, worst = _grad_errs(whole, ref[1])
        row.update(ref_loss=ref[0], loss_rel_err=loss_err,
                   grad_rel_l2=[err, worst])
        if not (loss_err <= PARALLEL_TOL["loss"]
                and err <= PARALLEL_TOL["grad"]):
            raise AssertionError(f"speech dp2: loss {row['loss']} vs "
                                 f"{ref[0]}, gradient {worst} {err}")
    del model, state, step, whole
    torch.cuda.empty_cache()
    return row


def parallel_trainer(root, rank):
    """``--entry train`` over dp 2 on nmt_trainer's corpus shape
    (transformer_base, V 32768, token buckets of NMT_TASK) for
    ``PARALLEL["trainer_steps"]`` steps: finite losses, rank 0's
    checkpoint, launches of the step kernels."""
    from neurst_tpu_torch.tasks.translation import Translation
    cfg = os.path.join(root, "trainer.json")
    model_dir = os.path.join(root, "model_dp2")
    start = time.perf_counter()
    _, seen = run_trainer(["--config_paths", cfg, "--model_dir", model_dir,
                           "--device", "cuda:0"], Translation)
    wall = time.perf_counter() - start
    losses = [float(m) for m in re.findall(r"\| loss ([0-9.eE+-]+)",
                                           "\n".join(seen["messages"]))]
    if len(seen["steps"]) != PARALLEL["trainer_steps"] or not losses \
            or not np.all(np.isfinite(losses)):
        raise AssertionError(f"dp2 trainer: {len(seen['steps'])} steps, "
                             f"losses {losses}")
    if rank == 0 and not os.path.exists(os.path.join(
            model_dir, f"ckpt-{PARALLEL['trainer_steps']}.npz")):
        raise AssertionError("dp2 trainer: rank 0 wrote no checkpoint")
    return {"wall_s": wall, "losses": losses, "rows": seen["rows"],
            "launches": seen["launches"]}


def _speech_model(seed, dtype, **overrides):
    import neurst_tpu_torch
    from neurst_tpu_torch.models.speech_transformer import SpeechTransformer
    from neurst_tpu_torch.utils.param_bridge import load_flat_params
    cfg = SpeechTransformer.build_model_args_by_name(TRAIN["model"])
    params = dict(cfg["model.params"], dtype=dtype, **overrides)
    for side in ("encoder", "decoder"):
        for rate in ("attention_dropout_rate", "ffn_dropout_rate",
                     "layer_postprocess_dropout_rate"):
            params[f"{side}.{rate}"] = 0.0
    model = neurst_tpu_torch.build_model(
        dict(cfg, **{"model.params": params}),
        src_meta={"audio_feature_dim": TRAIN["feature_dim"],
                  "audio_feature_channels": 1},
        trg_meta={"vocab_size": TRAIN["vocab"], "eos_id": 1, "bos_id": 2,
                  "unk_id": 3}, device="cuda")
    load_flat_params(model, speech_transformer_flat_params(
        cfg, TRAIN["vocab"], TRAIN["feature_dim"], seed))
    return model, cfg


def parallel_ring(seed, rank):
    """ring 2 over speech_transformer_s's encoder at st_long_audio's 4 x
    8192 frames (T 2048, 1024 a rank; each rank feeds 2 utterances),
    float32: the output and, forward + backward, the encoder's gradients
    (summed over the ranks) against the dense one-rank encoder."""
    import torch

    from neurst_tpu_torch.parallel import collectives
    from neurst_tpu_torch.parallel.mesh import make_mesh
    from neurst_tpu_torch.parallel.sharding import apply_mesh

    rng = np.random.RandomState(seed + 60)
    b, frames = LONG_AUDIO["batch"], LONG_AUDIO["frames"]
    inputs = {"src": torch.from_numpy(rng.randn(
        b, frames, TRAIN["feature_dim"], 1).astype(np.float32)).cuda(),
        "src_length": torch.tensor(LONG_AUDIO["lengths"],
                                   dtype=torch.int32).cuda()}
    cot = torch.from_numpy(rng.randn(b, frames // 4, 256).astype(
        np.float32)).cuda()

    def run(model, inp, cotan):
        enc, padding = model.encode(inp)
        loss = (enc * cotan * (1.0 - padding)[..., None]).sum()
        grads = torch.autograd.grad(loss, [p for _, p in
                                           model.named_parameters()],
                                    allow_unused=True)
        return enc.detach(), padding, {
            n: (torch.zeros_like(p) if g is None else g)
            for (n, p), g in zip(model.named_parameters(), grads)}

    ref = None
    if rank == 0:
        model, _ = _speech_model(seed, "float32")
        enc, padding, grads = run(model, inputs, cot)
        ref = (enc.cpu(), padding.cpu(), {n: g.cpu() for n, g in
                                          grads.items() if "encoder" in n})
        del model, grads
        torch.cuda.empty_cache()
    torch.distributed.barrier()
    model, _ = _speech_model(seed, "float32",
                             **{"encoder.enable_ring_attention": True})
    mesh = make_mesh()
    apply_mesh(model, mesh)
    local = _rows_of(inputs, mesh)
    local_cot = _rows_of({"c": cot}, mesh)["c"]
    with torch.no_grad():
        model.encode(local)
    torch.cuda.synchronize()
    fwd_ms, step_ms = [], []
    for _ in range(2):
        start = time.perf_counter()
        with torch.no_grad():
            model.encode(local)
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - start) * 1e3)
    start = time.perf_counter()
    enc, padding, grads = run(model, local, local_cot)
    torch.cuda.synchronize()
    step_ms.append((time.perf_counter() - start) * 1e3)
    group = mesh.group("data")
    enc_all = collectives.all_gather(enc, 0, group).cpu()
    enc_grads = {n: collectives.all_reduce(g.contiguous(), group).cpu()
                 for n, g in grads.items() if "encoder" in n}
    row = {"fwd_ms": fwd_ms, "fwd_bwd_ms": step_ms,
           "t_local": frames // 4 // PARALLEL["world"]}
    if rank == 0:
        ref_enc, ref_pad, ref_grads = ref
        valid = (1.0 - ref_pad)[..., None]
        out_err = float(((enc_all - ref_enc) * valid).abs().max())
        err, worst = _grad_errs(enc_grads, ref_grads)
        row.update(out_max_abs=out_err, grad_rel_l2=[err, worst])
        if not (out_err <= PARALLEL_TOL["ring_out"]
                and err <= PARALLEL_TOL["ring_grad"]):
            raise AssertionError(f"ring encoder: output {out_err}, "
                                 f"gradient {worst} {err}")
    del model, grads
    torch.cuda.empty_cache()
    return row


def parallel_pipeline(seed, rank):
    """pp 2 (M 4) of speech_transformer_s with dense attention, float32,
    against the sequential step on one rank (rank 0): the loss and every
    gradient; each rank's launches and step ms."""
    import torch

    import neurst_tpu_torch
    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
    from neurst_tpu_torch.parallel import make_train_step
    from neurst_tpu_torch.parallel.mesh import make_mesh
    from neurst_tpu_torch.parallel.sharding import apply_mesh, gather_tensors

    t = PARALLEL
    batch = train_batch(np.random.RandomState(seed + 61), "cuda",
                        t["pp_batch"], t["pp_frames"], t["pp_frames"] // 2,
                        t["pp_trg_len"], t["pp_trg_len"] // 2)
    criterion = neurst_tpu_torch.build_criterion({
        "criterion.class": "label_smoothed_cross_entropy",
        "criterion.params": {"label_smoothing": TRAIN["label_smoothing"]}})

    def grads_of(model, mesh, placement=None):
        step = make_train_step(
            model, criterion, None, mesh=mesh,
            stage_local=frozenset(getattr(placement, "owners", ())))
        loss, _, grads = step.compute_grads(dict(model.named_parameters()),
                                            batch)
        return float(loss), grads

    ref = None
    if rank == 0:
        model, _ = _speech_model(seed, "float32")
        loss, grads = grads_of(model, None)
        ref = (loss, {n: g.cpu() for n, g in grads.items()})
        del model, grads
        torch.cuda.empty_cache()
    torch.distributed.barrier()
    pipe = {f"{side}.{k}": v for side in ("encoder", "decoder")
            for k, v in (("pipeline_stages", 2),
                         ("pipeline_microbatches", t["microbatches"]))}
    model, _ = _speech_model(seed, "float32", **pipe)
    total = sum(p.numel() for p in model.parameters())
    mesh = make_mesh(pipeline_parallel=2)
    placement = apply_mesh(model, mesh)
    grads_of(model, mesh, placement)
    torch.cuda.synchronize()
    reset_launch_counts()
    start = time.perf_counter()
    loss, grads = grads_of(model, mesh, placement)
    torch.cuda.synchronize()
    row = {"step_ms": (time.perf_counter() - start) * 1e3,
           "launches": launch_counts(), "loss": loss,
           "held_params": [sum(p.numel() for p in model.parameters()),
                           total]}
    grads = {n: g.cpu() for n, g in
             gather_tensors(grads, placement, mesh).items()}
    if rank == 0:
        loss_err = abs(loss - ref[0]) / abs(ref[0])
        err, worst = _grad_errs(grads, ref[1])
        row.update(ref_loss=ref[0], grad_rel_l2=[err, worst])
        if not (loss_err <= PARALLEL_TOL["loss"]
                and err <= PARALLEL_TOL["grad"]):
            raise AssertionError(f"pipeline: loss {loss} vs {ref[0]}, "
                                 f"gradient {worst} {err}")
    # the last stage alone runs the fused projection + xent, and each
    # stage holds its own layers only
    if bool(row["launches"]["fused_linear_xent_fwd"]) != (rank == 1):
        raise AssertionError(f"pipeline: rank {rank} launched the fused "
                             f"xent {row['launches']} times")
    if not row["held_params"][0] < row["held_params"][1]:
        raise AssertionError(f"pipeline: rank {rank} holds "
                             f"{row['held_params']} parameters")
    del model, grads
    torch.cuda.empty_cache()
    return row


def parallel_decode(seed, rank):
    """dp 2 and tp 2 beam-4 decode of st_decode_s_flash's requests (16 x
    1024 frames), float32, hypotheses equal to the one-rank decode."""
    import torch

    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
    from neurst_tpu_torch.parallel import collectives
    from neurst_tpu_torch.parallel.mesh import make_mesh
    from neurst_tpu_torch.parallel.sharding import apply_mesh

    model, search, request = build_slice(seed, dtype="float32")
    requests = [request() for _ in range(PARALLEL["decode_requests"])]
    with torch.no_grad():
        refs = [search(r)[0].cpu() for r in requests]
    del model, search
    out = {}
    for mode in ("dp", "tp"):
        model, search, _ = build_slice(seed, dtype="float32")
        mesh = make_mesh(model_parallel=2 if mode == "tp" else 1)
        apply_mesh(model, mesh)
        reset_launch_counts()
        ms, same = [], []
        for req, ref in zip(requests, refs):
            local = _rows_of(req, mesh)
            torch.cuda.synchronize()
            start = time.perf_counter()
            with torch.no_grad():
                hyp = search(local)[0].cpu()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - start) * 1e3)
            parts = collectives.all_gather_object(hyp.tolist(),
                                                  mesh.group("data"))
            rows = [r for part in parts for r in part]
            same.append(rows == ref.tolist())
        out[mode] = {"ms": ms, "hypotheses_equal": same,
                     "launches": launch_counts()}
        if not all(same):
            raise AssertionError(f"{mode} decode hypotheses differ from one "
                                 f"rank's")
        del model, search
        torch.cuda.empty_cache()
    return out


# expert parallelism in the ranks: the Switch overlay (8 experts, top-1,
# every 2nd FFN) over dp 2, 4 experts a rank; float32 held against one
# rank (loss and aux: relative error; gradients: relative L2)
EP = dict(check_batch=32, check_length=64, batch=256, length=128, warmup=1,
          steps=2)
EP_TOL = {"loss": 1e-5, "grad": 1e-4}
EP_KERNELS = ("fused_linear_xent_fwd", "fused_linear_xent_bwd",
              "fused_dropout", "fused_ffn_fwd", "fused_ffn_bwd")


def parallel_ep(seed, rank):
    """Expert parallelism of ``MOE["switch"]`` over ``transformer_base``
    on the 2 ranks (gloo on one card: the dispatch and combine
    all-to-alls are all-gathers): a float32 step without dropout (the
    router's jitter on: each rank draws its rows' noise of the one-rank
    batch) held to the one-rank step on the global [32, 64] batch (rank 0
    computes it;
    loss and aux loss ``EP_TOL["loss"]`` relative, every gradient, the
    experts' gathered whole, ``EP_TOL["grad"]`` relative L2), then bf16
    steps with the hparams set's dropout 0.1 at [256, 128] (128 rows a
    rank: the fused FFN's gate takes its 16,384 rows): their times and
    each rank's launches of rows 4 / 5 / 8 / 9 / 10 a step, every one of
    them launched."""
    import torch

    from neurst_tpu_torch.layers.moe import MoeFFN
    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
    from neurst_tpu_torch.parallel.mesh import make_mesh
    from neurst_tpu_torch.parallel.sharding import gather_tensors
    from neurst_tpu_torch.utils.rng import fold_in, make_key

    e = EP
    jitter_key = fold_in(make_key(seed + 144), 0)
    batch = nmt_batch(np.random.RandomState(seed + 141), "cuda",
                      e["check_batch"], e["check_length"], MOE["vocab"],
                      MOE["vocab"])
    out = {}
    ref = None
    if rank == 0:
        model, _, _, state, step = build_moe_train(
            seed, MOE["switch"], "cuda", "float32", dropout=0.0)
        loss, aux, grads = step.compute_grads(state.params, batch,
                                              jitter_key)
        ref = (float(loss), float(aux), {n: g.cpu() for n, g in
                                         grads.items()})
        del model, state, step, grads
        torch.cuda.empty_cache()
    torch.distributed.barrier()
    mesh = make_mesh()
    local = _rows_of(batch, mesh)
    model, _, _, state, step = build_moe_train(
        seed, MOE["switch"], "cuda", "float32", mesh=mesh, dropout=0.0)
    experts = [m for m in model.modules() if isinstance(m, MoeFFN)]
    held = experts[0].expert_dense1_kernel.shape[0]
    loss, aux, grads = step.compute_grads(state.params, local, jitter_key)
    whole = {n: g.cpu() for n, g in gather_tensors(
        grads, model.placement, mesh).items()}
    out["float32"] = {"loss": float(loss), "aux_loss": float(aux),
                      "experts_held": held,
                      "experts": experts[0].num_experts,
                      "moe_layers": len(experts)}
    if rank == 0:
        ref_loss, ref_aux, ref_grads = ref
        err, worst = _grad_errs(whole, ref_grads)
        row = out["float32"]
        row.update(ref_loss=ref_loss, ref_aux=ref_aux,
                   loss_rel_err=abs(float(loss) - ref_loss) / abs(ref_loss),
                   aux_rel_err=abs(float(aux) - ref_aux) / abs(ref_aux),
                   grad_rel_l2=[err, worst], tol=EP_TOL)
        print(json.dumps({"ep_float32": row}), flush=True)
        if not (row["loss_rel_err"] <= EP_TOL["loss"]
                and row["aux_rel_err"] <= EP_TOL["loss"]
                and err <= EP_TOL["grad"] and held * 2 == row["experts"]):
            raise AssertionError(f"expert parallelism float32: {row}")
    del model, state, step, grads, whole
    torch.cuda.empty_cache()
    model, _, _, state, step = build_moe_train(seed, MOE["switch"], "cuda",
                                               "bfloat16", mesh=mesh)
    rng = np.random.RandomState(seed + 142)
    batches = [_rows_of(nmt_batch(rng, "cuda", e["batch"], e["length"],
                                  MOE["vocab"], MOE["vocab"]), mesh)
               for _ in range(e["warmup"] + e["steps"])]
    key = make_key(seed + 143)
    step_ms, losses = [], []
    for i, b in enumerate(batches):
        if i == e["warmup"]:
            torch.cuda.synchronize()
            reset_launch_counts()
        start = time.perf_counter()
        state, metrics = step(state, b, key)
        torch.cuda.synchronize()
        if i >= e["warmup"]:
            step_ms.append((time.perf_counter() - start) * 1e3)
            losses.append(float(metrics["loss"]))
    counts = launch_counts()
    per_step = {k: counts[k] // e["steps"] for k in EP_KERNELS}
    out["bfloat16"] = {"batch": [e["batch"], e["length"]],
                       "rows_a_rank": e["batch"] // mesh.shape["data"],
                       "step_ms": step_ms, "losses": losses,
                       "launches_per_step": per_step}
    out["launches"] = counts
    if not (all(per_step.values()) and all(map(math.isfinite, losses))):
        raise AssertionError(f"expert parallelism bf16: {out['bfloat16']}")
    del model, state, step
    torch.cuda.empty_cache()
    return out


# slice 16 in the ranks: QAT (transformer_base under mt_synth_qat.yml's
# quant params), int8 serving (the slice's speech_transformer_s requests
# in the three modes) and an ensemble of two speech_transformer_s members
# under tensor parallelism 2, float32 held to one rank on the same card;
# QAT's bf16 steps with dropout 0.1 timed
QTP = dict(check_batch=32, check_length=64, batch=64, length=128, warmup=1,
           steps=2, requests=1, site_rows=4096, site_dim=512,
           site_filter=2048)
# float32 tp 2 against one rank: the QAT loss and each clip's gradient
# (relative), the QuantDense sites' outputs and gradients (relative L2;
# an output may round to the next level of its grid where the two
# products round apart, in at most QAT_FLIP_SHARE of its elements); a
# rank's share of the bytes of the parameters tp 2 splits
QTP_TOL = {"loss": 1e-5, "clip_grad": 1e-4, "site": 1e-5,
           "split_bytes": 0.55}
# the kernels whose launches each tp 2 path holds to one rank's (rows 1,
# 4, 5, 8) and the ones it must not launch (rows 9-10: the fused FFN's
# gate is off under QAT and int8 serving, as in the JAX package)
QTP_ROWS = ("flash_attention_fwd", "fused_linear_xent_fwd",
            "fused_linear_xent_bwd", "fused_dropout")
QTP_OFF = ("fused_ffn_fwd", "fused_ffn_bwd")


def _tp_launch_check(counts, one_rank, what):
    """Rows 1, 4, 5 and 8 launched as on one rank, rows 9-10 not at
    all."""
    differ = {k: (counts.get(k, 0), one_rank.get(k, 0)) for k in QTP_ROWS
              if counts.get(k, 0) != one_rank.get(k, 0)}
    on = {k: counts[k] for k in QTP_OFF if counts.get(k)}
    if differ or on:
        raise AssertionError(f"{what} launches (tp 2, one rank) {differ}, "
                             f"fused FFN {on}")


def qat_tp_site_check(seed, rank, mesh, device="cuda"):
    """A column-parallel (dense1, relu) and a row-parallel (dense2)
    ``QuantDense`` of transformer_base's FFN at ``QTP["site_rows"]`` rows,
    cut to the rank's shard and told their form as ``apply_mesh`` does,
    against the whole dense on the same card (float32; the clips at the
    99th percentile of |w| and of |output|, so that both take a gradient
    from the data): the output (gathered for the column form) off by one
    level in at most ``QAT_FLIP_SHARE`` of its elements, dx, dW and db
    within ``QTP_TOL["site"]`` relative L2, and both clips' gradients
    within ``QTP_TOL["clip_grad"]`` (a clip's gradient sums the
    gradients of every clipped element, here in two halves and a sum:
    7.4e-5 apart at 64 x 128 on the CPU)."""
    import torch

    from neurst_tpu_torch.layers.quantization import quant_layers as ql
    from neurst_tpu_torch.parallel import collectives
    from neurst_tpu_torch.parallel.mesh import ShardSpec
    from neurst_tpu_torch.parallel.sharding import _set_dense, take_shard
    q = QTP
    group, coord, n = (mesh.group("model"), mesh.coords["model"],
                       mesh.shape["model"])
    rng = np.random.RandomState(seed + 151)
    rows_out = []
    for name, d_in, d_out, act, row in (
            ("dense1", q["site_dim"], q["site_filter"], "relu", False),
            ("dense2", q["site_filter"], q["site_dim"], None, True)):
        w = (rng.randn(d_out, d_in) * d_in ** -0.5).astype(np.float32)
        b = (0.1 * rng.randn(d_out)).astype(np.float32)
        x = rng.randn(q["site_rows"], d_in).astype(np.float32)
        g = rng.randn(q["site_rows"], d_out).astype(np.float32)
        pre = x @ w.T + b
        if act:
            pre = np.maximum(pre, 0.0)
        clips = (float(np.quantile(np.abs(w), 0.99)),
                 float(np.quantile(np.abs(pre), 0.99)))
        out = {}
        for where in ("whole", "tp"):
            dense = ql.QuantDense(d_in, d_out, activation=act).to(device)
            with torch.no_grad():
                dense.weight.copy_(torch.from_numpy(w))
                dense.bias.copy_(torch.from_numpy(b))
                dense.kernel_clip_max.fill_(clips[0])
                dense.output_clip_max.fill_(clips[1])
            xx = torch.from_numpy(x).to(device).requires_grad_()
            gg = torch.from_numpy(g).to(device)
            inp = xx
            if where == "tp":
                spec = ShardSpec(1 if row else 0, "model", 1)
                with torch.no_grad():
                    dense.weight.data = take_shard(dense.weight.data, spec,
                                                   coord, n)
                    if not row:
                        dense.bias.data = take_shard(dense.bias.data, spec,
                                                     coord, n)
                _set_dense(dense, group, row)
                if row:
                    inp = take_shard(xx, ShardSpec(1, "model", 1), coord,
                                     n)
                else:
                    inp = collectives.copy_to(xx, group)
                    gg = take_shard(gg, ShardSpec(1, "model", 1), coord, n)
            params = [xx, dense.weight, dense.bias, dense.kernel_clip_max,
                      dense.output_clip_max]
            y = dense.dense(inp, torch.float32)
            grads = torch.autograd.grad((y * gg).sum(), params)
            if where == "tp":
                # the whole output, dx, dW and db of the rank's parts
                y = collectives.all_gather(y.detach(), 1, None if row
                                           else group)
                grads = list(grads)
                if row:
                    grads[0] = collectives.all_reduce(grads[0].clone(),
                                                      group)
                for i in (1, 2):
                    if i == 1 or not row:
                        grads[i] = collectives.all_gather(
                            grads[i], 1 if (row and i == 1) else 0, group)
            out[where] = (y.detach(), [t.detach() for t in grads])
            del dense
        y_tp, g_tp = out["tp"]
        y_one, g_one = out["whole"]
        level = clips[1] / (255.0 if act == "relu" else 127.0)
        diff = (y_tp - y_one).abs()
        flips = diff > 1e-5 * float(y_one.abs().max())
        errs = {k: _rel_l2(a, b_) for k, a, b_ in zip(
            ("dx", "dw", "db", "dkernel_clip", "doutput_clip"), g_tp, g_one)}
        rows_out.append({
            "site": name, "form": "row" if row else "column",
            "rows": q["site_rows"], "in": d_in, "out": d_out,
            "flip_share": float(flips.float().mean()),
            "max_flip_levels": float(diff.max()) / level,
            "grad_rel_l2_err": errs,
            "clip_grads": [float(t) for t in g_tp[3:]]})
        r = rows_out[-1]
        tol = {k: QTP_TOL["clip_grad" if "clip" in k else "site"]
               for k in errs}
        if not (r["flip_share"] <= QAT_FLIP_SHARE
                and r["max_flip_levels"] <= 1.01
                and all(errs[k] <= tol[k] for k in errs)
                and all(math.isfinite(c) and c != 0.0
                        for c in r["clip_grads"])):
            raise AssertionError(f"QuantDense tp 2 on rank {rank}: {r}")
    return rows_out


def parallel_qat_tp(seed, rank, device="cuda"):
    """QAT under tensor parallelism 2: transformer_base under
    mt_synth_qat.yml's quant params, a float32 step at [32, 64] without
    dropout against one rank's (rank 0 computes it): the loss within
    ``QTP_TOL["loss"]`` and every clip's gradient within
    ``QTP_TOL["clip_grad"]`` relative (the other gradients' worst relative
    L2 printed: a deep QAT model is discontinuous); the two FFN sites
    (``qat_tp_site_check``); then bf16 steps with dropout 0.1 at
    [64, 128]: ms a step and each rank's launches a step against one
    rank's step."""
    import torch

    from neurst_tpu_torch.layers.quantization.quant_layers import \
        global_init
    from neurst_tpu_torch.models.transformer import Transformer
    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
    from neurst_tpu_torch.parallel.mesh import make_mesh
    from neurst_tpu_torch.utils.rng import make_key

    q, vocab = QTP, NMT_TRAIN["vocab"]
    qp = _qat_quant_params()
    flat = transformer_flat_params(
        Transformer.build_model_args_by_name(NMT_TRAIN["model"]), vocab,
        vocab, seed)
    batch = nmt_batch(np.random.RandomState(seed + 150), device,
                      q["check_batch"], q["check_length"], vocab, vocab)
    rng = np.random.RandomState(seed + 152)
    timed = [nmt_batch(rng, device, q["batch"], q["length"], vocab, vocab)
             for _ in range(q["warmup"] + q["steps"])]
    key = make_key(seed + 153)
    out = {"quant_params": qp}
    global_init(True, **qp)
    try:
        ref = None
        if rank == 0:
            model, _, _, state, step = build_nmt_train(
                seed, device, "float32", False, 0.0, quant_params=qp,
                flat=dict(flat))
            loss, _, grads = step.compute_grads(state.params, batch)
            ref = (float(loss), {n: g.cpu() for n, g in grads.items()})
            del model, state, step, grads
            # one rank's bf16 step: the launches a step the ranks match
            model, _, _, state, step = build_nmt_train(
                seed, device, "bfloat16", True, DROPOUT_RATE,
                quant_params=qp, flat=dict(flat))
            torch.cuda.synchronize()
            reset_launch_counts()
            state, _ = step(state, timed[0], key)
            torch.cuda.synchronize()
            ref_launches = launch_counts()
            del model, state, step
            torch.cuda.empty_cache()
        torch.distributed.barrier()
        mesh = make_mesh(model_parallel=2)
        model, _, _, state, step = build_nmt_train(
            seed, device, "float32", False, 0.0, quant_params=qp, mesh=mesh,
            flat=dict(flat))
        loss, _, grads = step.compute_grads(state.params, batch)
        whole = _whole_grads(model, grads, mesh)
        del model, state, step, grads
        torch.cuda.empty_cache()
        row = {"batch": [q["check_batch"], q["check_length"]],
               "loss": float(loss)}
        if rank == 0:
            ref_loss, ref_grads = ref
            clips = sorted(n for n in ref_grads if n.endswith("_clip_max"))
            clip_errs = {n: abs(float(whole[n]) - float(ref_grads[n]))
                         / max(abs(float(ref_grads[n])), 1e-30)
                         for n in clips}
            worst_clip = max(clip_errs, key=clip_errs.get)
            others = {n: g for n, g in ref_grads.items() if n not in clips}
            row.update(ref_loss=ref_loss,
                       loss_rel_err=abs(float(loss) - ref_loss)
                       / abs(ref_loss), clips=len(clips),
                       clip_grad_max_rel_err=[clip_errs[worst_clip],
                                              worst_clip],
                       grad_rel_l2=list(_grad_errs(whole, others)),
                       tol=QTP_TOL)
            print(json.dumps({"qat_tp_float32": row}), flush=True)
            if not (row["loss_rel_err"] <= QTP_TOL["loss"] and clips
                    and clip_errs[worst_clip] <= QTP_TOL["clip_grad"]):
                raise AssertionError(f"QAT tp 2 float32: {row}")
        out["float32"] = row
        del whole
        out["sites"] = qat_tp_site_check(seed, rank, mesh, device)
        model, _, _, state, step = build_nmt_train(
            seed, device, "bfloat16", True, DROPOUT_RATE, quant_params=qp,
            mesh=mesh, flat=dict(flat))
        step_ms, losses = [], []
        for i, b in enumerate(timed):
            if i == q["warmup"]:
                torch.cuda.synchronize()
                reset_launch_counts()
            start = time.perf_counter()
            state, metrics = step(state, b, key)
            torch.cuda.synchronize()
            if i >= q["warmup"]:
                step_ms.append((time.perf_counter() - start) * 1e3)
                losses.append(float(metrics["loss"]))
        counts = launch_counts()
        per_step = {k: v // q["steps"] for k, v in counts.items()}
        out["bfloat16"] = {"batch": [q["batch"], q["length"]],
                           "dropout": DROPOUT_RATE, "step_ms": step_ms,
                           "losses": losses, "launches_per_step": per_step}
        out["launches"] = counts
        # (no kernel launches on the CPU rehearsal)
        if not ((per_step["fused_dropout"] or device != "cuda")
                and all(map(math.isfinite, losses))):
            raise AssertionError(f"QAT tp 2 bf16: {out['bfloat16']}")
        if rank == 0:
            out["bfloat16"]["one_rank_launches_per_step"] = ref_launches
            _tp_launch_check(per_step, ref_launches, "QAT tp 2 bf16 step")
        del model, state, step
        torch.cuda.empty_cache()
    finally:
        global_init(False)
    return out


def _place_tp(model):
    """``model`` placed by the predict entry's tensor-parallel decode
    (``SequenceGenerator._decode_mesh`` with ``--decode_tensor_parallel
    2``); returns the rows of a request this rank decodes
    (``_shard_rows``: two ranks at tp 2 hold one data rank, so both decode
    every row)."""
    from neurst_tpu_torch.exps.sequence_generator import SequenceGenerator
    gen = SequenceGenerator({"decode_tensor_parallel": 2})
    mesh = gen._decode_mesh(model)
    if mesh.shape["model"] != 2:
        raise AssertionError(f"tp 2 decode mesh {mesh}")
    return lambda request: gen._shard_rows(mesh, request)[0]


def _decode_counted(search, requests):
    """(hypotheses, ms a request, launch counts) of one decode of each of
    ``requests``, with no warm-up (the ranks' processes decoded the
    slice's requests before, in ``parallel_decode``)."""
    import torch

    from neurst_tpu_torch.ops import launch_counts, reset_launch_counts
    reset_launch_counts()
    outs, ms = [], []
    for request in requests:
        torch.cuda.synchronize()
        start = time.perf_counter()
        outs.append(search(request)[0])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - start) * 1e3)
    return torch.cat(outs).cpu(), ms, launch_counts()


def parallel_int8_tp(seed, rank, device="cuda"):
    """int8 serving under tensor parallelism 2: the slice's
    speech_transformer_s requests (float32 compute) in each int8 mode
    against one rank on the card (rank 0 decodes them): every hypothesis
    equal; the static mode calibrated on the first request teacher-forced
    from BOS, on the ranks as on one rank; ms a request; each rank's
    weight bytes (``torch.cuda.memory_allocated`` after the load and the
    placement) against one rank's, the parameters tp 2 splits at most
    ``QTP_TOL["split_bytes"]`` of their one-rank bytes; flash launches as
    one rank's, rows 9-10 none."""
    import torch

    from neurst_tpu_torch.layers.quantization.quant_layers import \
        calibrate_int8_act_scales
    from neurst_tpu_torch.parallel.mesh import Mesh, params_shardings

    out = {}
    # the parameters a 2-way "model" axis splits (names and shapes only)
    split_mesh = Mesh({"data": 1, "stage": 1, "model": 2},
                      {"data": 0, "stage": 0, "model": 0},
                      {"data": None, "stage": None, "model": None})
    try:
        for mode in INT8_MODES:
            _set_int8(mode)
            ref = None
            for where in ("one_rank", "tp") if rank == 0 else ("tp",):
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                model, search, request = build_slice(seed, device, "float32")
                whole = {n: p.numel() * p.element_size()
                         for n, p in model.named_parameters()}
                split = {n for n, spec in params_shardings(
                    model, split_mesh).items() if spec is not None}
                rows = (lambda r: r) if where == "one_rank" \
                    else _place_tp(model)
                torch.cuda.synchronize()
                loaded = torch.cuda.memory_allocated() - before
                local = {n: p.numel() * p.element_size()
                         for n, p in model.named_parameters()}
                requests = [rows(request()) for _ in range(QTP["requests"])]
                if mode == "int8_static":
                    calibrate_int8_act_scales(model, [dict(
                        requests[0], trg_input=torch.full(
                            (requests[0]["src"].shape[0], 8), model.bos_id,
                            device=device))])
                hyps, ms, counts = _decode_counted(search, requests)
                row = {"request_ms": ms, "launches": counts,
                       "weight_bytes": loaded,
                       "param_bytes": sum(local.values())}
                if where == "one_rank":
                    ref = dict(row, hyps=hyps)
                else:
                    share = sum(local[n] for n in split) / sum(
                        whole[n] for n in split)
                    row.update(split_params=len(split),
                               split_bytes_share=share)
                    _no_fused_rows(counts, f"int8 tp 2 {mode}")
                    if not (split and share <= QTP_TOL["split_bytes"]
                            and {n for n in split if local[n] < whole[n]}
                            == split):
                        raise AssertionError(f"int8 tp 2 {mode}: {row}")
                    if rank == 0:
                        row.update(one_rank={k: v for k, v in ref.items()
                                             if k != "hyps"},
                                   hypotheses_equal=bool(torch.equal(
                                       hyps, ref["hyps"])))
                        _tp_launch_check(counts, ref["launches"],
                                         f"int8 tp 2 {mode}")
                        if not row["hypotheses_equal"]:
                            raise AssertionError(
                                f"int8 tp 2 {mode}: hypotheses differ from "
                                f"one rank's")
                    out[mode] = row
                del model, search
                torch.cuda.empty_cache()
            torch.distributed.barrier()
    finally:
        _quantization_off()
    return out


def parallel_ensemble_tp(seed, rank, device="cuda"):
    """An ensemble of two speech_transformer_s members (seeds ``seed`` and
    ``seed + 1``, float32) decoded by the predict entry's tensor-parallel
    placement (``--decode_tensor_parallel 2``: the members whole on every
    rank, the rows over a data axis of one): every hypothesis equal to the
    one-rank ensemble's (rank 0 decodes it), ms a request, flash launches
    as one rank's."""
    import torch

    import neurst_tpu_torch
    from neurst_tpu_torch.models.ensemble_model import \
        EncoderDecoderEnsembleModel

    members, request = [], None
    for s in (seed, seed + 1):
        model, search, req = build_slice(s, device, "float32")
        members.append(model)
        request = request or req
        params = search.args
    requests = [request() for _ in range(QTP["requests"])]
    ensemble = EncoderDecoderEnsembleModel(members)
    search = neurst_tpu_torch.build_search_layer({
        "search_method.class": "beam_search",
        "search_method.params": params})
    search.set_model(ensemble)
    ref = None
    if rank == 0:
        hyps, ms, counts = _decode_counted(search, requests)
        ref = {"hyps": hyps, "ms": ms, "launches": counts}
    torch.distributed.barrier()
    rows = _place_tp(ensemble)
    hyps, ms, counts = _decode_counted(search, [rows(r) for r in requests])
    row = {"members": len(members), "request_ms": ms, "launches": counts}
    _no_fused_rows(counts, "ensemble tp 2")
    if rank == 0:
        row.update(one_rank_request_ms=ref["ms"],
                   hypotheses_equal=bool(torch.equal(hyps, ref["hyps"])))
        _tp_launch_check(counts, ref["launches"], "ensemble tp 2")
        if not row["hypotheses_equal"]:
            raise AssertionError("ensemble tp 2: hypotheses differ from one "
                                 "rank's")
    del ensemble, members, search
    torch.cuda.empty_cache()
    return row


def gloo_cuda_probe():
    """Which gloo collectives take CUDA tensors here: each of
    ``collectives.GLOO_CUDA_OPS`` must (the others go through host
    memory)."""
    import torch
    import torch.distributed as dist

    from neurst_tpu_torch.parallel import collectives
    x = torch.ones(4, device="cuda")
    dist.all_reduce(x)
    dist.broadcast(x, 0)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    torch.cuda.synchronize()
    return {"native_on_cuda": sorted(collectives.GLOO_CUDA_OPS),
            "all_reduce": float(x[0])}


def parallel_rank_main(rank, port, root, seed):
    """One rank of the parallel phase (a process of this script)."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = PARALLEL["world"]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    from neurst_tpu_torch.parallel.cluster import distributed_initialize
    distributed_initialize(device="cuda:0")
    if dist.get_backend() != "gloo":
        raise AssertionError("two ranks on one card must take gloo")
    out = {"rank": rank, "gloo": gloo_cuda_probe()}
    for name, fn in (("nmt", lambda: parallel_nmt_steps(seed, rank)),
                     ("speech_dp", lambda: parallel_speech_dp(seed, rank)),
                     ("ring", lambda: parallel_ring(seed, rank)),
                     ("pipeline", lambda: parallel_pipeline(seed, rank)),
                     ("decode", lambda: parallel_decode(seed, rank)),
                     ("ep", lambda: parallel_ep(seed, rank)),
                     ("qat_tp", lambda: parallel_qat_tp(seed, rank)),
                     ("int8_tp", lambda: parallel_int8_tp(seed, rank)),
                     ("ensemble_tp", lambda: parallel_ensemble_tp(seed,
                                                                  rank)),
                     ("trainer", lambda: parallel_trainer(root, rank))):
        start = time.perf_counter()
        out[name] = fn()
        out[name + "_s"] = time.perf_counter() - start
        print(json.dumps({name: out[name], "s": out[name + "_s"]}),
              flush=True)
        dist.barrier()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def nccl_one_rank_phase():
    """A one-rank NCCL group in this process: every op of
    ``parallel/collectives.py`` through NCCL on the card, against its
    one-rank value."""
    import torch
    import torch.distributed as dist

    from neurst_tpu_torch.parallel import collectives as c
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        x = torch.randn(3, 8, device="cuda", requires_grad=True)
        checks = {
            "all_reduce": c.all_reduce(x.detach().clone(), group),
            "all_gather": c.all_gather(x.detach(), 0, group),
            "broadcast": c.broadcast(x.detach().clone(), 0, group),
            "all_reduce_tensors": c.all_reduce_tensors(
                [x.detach().clone()], group)[0]}
        for name, fn in (("reduce_from", c.reduce_from),
                         ("copy_to", c.copy_to), ("sum_over", c.sum_over)):
            y = fn(x, group)
            (g,) = torch.autograd.grad(y.sum(), [x])
            checks[name] = y.detach()
            checks[name + "_grad"] = g - 1.0 + x.detach()
        for name, fn in (("gather_from", c.gather_from),
                         ("gather_sum_from", c.gather_sum_from),
                         ("scatter_to", c.scatter_to)):
            y = fn(x, 0, group)
            (g,) = torch.autograd.grad(y.sum(), [x])
            checks[name] = y.detach()
            checks[name + "_grad"] = g - 1.0 + x.detach()
        y = c.broadcast_from(x, 0, group)
        (g,) = torch.autograd.grad(y.sum(), [x])
        checks["broadcast_from"] = y.detach()
        checks["broadcast_from_grad"] = g - 1.0 + x.detach()
        # the MoE dispatch's all_to_all_single, forward and the reverse
        # all-to-all of its backward, in both of its dtypes
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.detach()[None].to(dtype).requires_grad_()
            y = c.all_to_all(xd, 0, 1, group)
            (g,) = torch.autograd.grad(y.float().sum(), [xd])
            key = f"all_to_all_{str(dtype)[6:]}"
            checks[key] = (y.detach() - xd.detach()).float()[0] + x.detach()
            checks[key + "_grad"] = g.float()[0] - 1.0 + x.detach()
        torch.cuda.synchronize()
        errs = {k: float((v - x.detach()).abs().max())
                for k, v in checks.items()}
        objects = c.all_gather_object({"rank": 0}, group)
        if max(errs.values()) != 0.0 or objects != [{"rank": 0}]:
            raise AssertionError(f"one-rank NCCL collectives: {errs}")
        emit({"phase": "parallel_nccl", "backend": dist.get_backend(),
              "ops": sorted(errs), "max_abs_err": max(errs.values())})
    finally:
        dist.destroy_process_group()


class ParallelRanks(object):
    """The parallel phase's ``PARALLEL["world"]`` ranks (processes of this
    script, ``--parallel_rank``), started beside the audio prep's host
    stages and the QAT worker, as the QAT worker is: their times hold that
    load (and each other's work), so they are no scaling figure.  ``join``
    waits for them, fails if a rank failed (with the tail of its log),
    emits the ``parallel`` row, runs
    the one-rank NCCL group in this process and returns {path: rank 0's
    launch counts} for the kernels' rows; ``stop`` kills ranks still
    running."""

    def __init__(self, seed):
        t = PARALLEL
        here = os.path.dirname(os.path.abspath(__file__))
        self.started = time.perf_counter()
        self.root = os.path.join(here, "build", "parallel_smoke")
        shutil.rmtree(self.root, ignore_errors=True)
        os.makedirs(self.root)
        rng = np.random.RandomState(seed + 95)
        pipelines, words = {}, {}
        for side, language in (("src", "en"), ("trg", "de")):
            vocab = os.path.join(self.root, f"vocab.{side}")
            words[side] = write_word_vocab(vocab, rng,
                                           NMT_TRAINER["vocab"] - 3)
            pipelines[side] = {"vocab_path": vocab, "language": language}
        train = write_parallel(os.path.join(self.root, "train"), rng,
                               words["src"], words["trg"], t["trainer_pairs"],
                               NMT_TRAINER["min_tokens"],
                               NMT_TRAINER["max_tokens"])
        nmt_config(os.path.join(self.root, "trainer.json"), pipelines,
                   ("parallel_text", _parallel(train)),
                   train_steps=t["trainer_steps"], summary_steps=1,
                   save_checkpoint_steps=t["trainer_steps"],
                   enable_tensorboard=False)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        self.procs = []
        for rank in range(t["world"]):
            with open(os.path.join(self.root, f"rank{rank}.log"), "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--seed",
                     str(seed), "--parallel_rank", str(rank),
                     "--parallel_port", str(port), "--parallel_root",
                     self.root], stdout=log, stderr=subprocess.STDOUT,
                    cwd=here))

    def stop(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def join(self):
        import torch

        waited = time.perf_counter()
        failed = []
        try:
            for rank, proc in enumerate(self.procs):
                if proc.wait(timeout=900) != 0:
                    failed.append(rank)
                    break
        finally:
            self.stop()
        if failed:
            log = os.path.join(self.root, f"rank{failed[0]}.log")
            with open(log) as f:
                raise AssertionError(f"parallel rank {failed[0]} failed:\n"
                                     f"{f.read()[-6000:]}")
        ranks = []
        for rank in range(len(self.procs)):
            with open(os.path.join(self.root, f"rank{rank}.json")) as f:
                ranks.append(json.load(f))
        emit({"phase": "parallel", "world": len(self.procs),
              "backend": "gloo",
              "note": "the ranks share one card, beside the audio prep and "
                      "the QAT worker: their times are no scaling figure",
              "wall_s": time.perf_counter() - self.started,
              "waited_s": time.perf_counter() - waited, "ranks": ranks})
        shutil.rmtree(self.root, ignore_errors=True)
        nccl_one_rank_phase()
        torch.cuda.synchronize()
        r0 = ranks[0]
        # the pipeline's stages launch different kernels (the last alone
        # runs the fused xent): both ranks' counts
        pp2 = {k: sum(r["pipeline"]["launches"][k] for r in ranks)
               for k in r0["pipeline"]["launches"]}
        return {"parallel_dp2_base": r0["nmt"]["dp"]["bfloat16"]["counts"],
                "parallel_tp2_base": r0["nmt"]["tp"]["bfloat16"]["counts"],
                "parallel_dp2_speech": r0["speech_dp"]["launches"],
                "parallel_trainer": r0["trainer"]["launches"],
                "parallel_pp2": pp2,
                "parallel_decode_tp2": r0["decode"]["tp"]["launches"],
                "parallel_ep2_moe": r0["ep"]["launches"],
                "parallel_qat_tp2": r0["qat_tp"]["launches"],
                "parallel_int8_tp2": _sum_counts(
                    r0["int8_tp"][m]["launches"] for m in INT8_MODES),
                "parallel_ensemble_tp2": r0["ensemble_tp"]["launches"]}


def _sum_counts(counts):
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def parallel_phase(seed):
    """The parallel stack's paths alone: ``ParallelRanks`` started and
    joined."""
    ranks = ParallelRanks(seed)
    try:
        return ranks.join()
    finally:
        ranks.stop()


def qat_worker_main(seed, t0):
    """The worker's side: the card's checks, then ``qat_phases``, then
    one line of its launch counts."""
    global _START
    _START = t0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke --qat_worker: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train, predict = qat_phases(seed)
    print(json.dumps({"qat_worker_launches": {"qat_train": train,
                                              "qat_predict": predict}}),
          flush=True)


def _summary_row(name, row, launches, by_path, extra):
    """The kernel's summary entry from its phase row at the main shape;
    ``extra`` maps a label ("with_dropout", "nmt_train") to the row of
    another case whose numbers ride along under that label."""
    def numbers(r):
        return {"max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
    out = dict({"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches,
                "launches_by_path": by_path}, **numbers(row))
    for label, other in extra.items():
        out[label] = dict(numbers(other), shape=other["shape"])
    return out


SOURCES = {
    "flash_attention_fwd": "neurst_tpu_torch/csrc/flash_attention_fwd.cu",
    "flash_attention_dq": "neurst_tpu_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_dkv": "neurst_tpu_torch/csrc/flash_attention_bwd.cu",
    "fused_linear_xent_fwd": "neurst_tpu_torch/csrc/fused_linear_xent.cu",
    "fused_linear_xent_bwd": "neurst_tpu_torch/csrc/fused_linear_xent.cu",
    "fused_softmax_xent_fwd": "neurst_tpu_torch/csrc/fused_softmax_xent.cu",
    "fused_softmax_xent_bwd": "neurst_tpu_torch/csrc/fused_softmax_xent.cu",
    "fused_dropout": "neurst_tpu_torch/csrc/fused_dropout.cu",
    "fused_ffn_fwd": "neurst_tpu_torch/csrc/fused_ffn.cu",
    "fused_ffn_bwd": "neurst_tpu_torch/csrc/fused_ffn.cu"}
REPLACES = {
    "flash_attention_fwd": "neurst_tpu/ops/flash_attention.py:96",
    "flash_attention_dq": "neurst_tpu/ops/flash_attention.py:176",
    "flash_attention_dkv": "neurst_tpu/ops/flash_attention.py:244",
    "fused_linear_xent_fwd": "neurst_tpu/ops/fused_ce.py:252",
    "fused_linear_xent_bwd": "neurst_tpu/ops/fused_ce.py:299",
    "fused_softmax_xent_fwd": "neurst_tpu/ops/fused_ce.py:59",
    "fused_softmax_xent_bwd": "neurst_tpu/ops/fused_ce.py:105",
    "fused_dropout": "neurst_tpu/ops/fused_dropout.py:67",
    "fused_ffn_fwd": "neurst_tpu/ops/fused_ffn.py:121",
    "fused_ffn_bwd": "neurst_tpu/ops/fused_ffn.py:149"}


# kernels no path of either package runs: the JAX package calls
# fused_softmax_xent only from its tests (its criterion's logits path is
# plain jnp, its train step takes the projection-fused rows 4-5), so the
# port does not wire it into a path either; their launches stay 0
OFF_PATH = {"fused_softmax_xent_fwd", "fused_softmax_xent_bwd"}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--qat_worker", action="store_true",
                        help="run only the QAT phases (the whole script "
                             "starts this itself, beside the audio prep)")
    parser.add_argument("--t0", type=float, default=None,
                        help="the starting script's clock (--qat_worker)")
    parser.add_argument("--parallel_rank", type=int, default=None,
                        help="run one rank of the parallel phase (the "
                             "whole script starts its ranks itself)")
    parser.add_argument("--parallel_port", type=int, default=None)
    parser.add_argument("--parallel_root", default=None)
    args = parser.parse_args(argv)
    if args.qat_worker:
        return qat_worker_main(args.seed, args.t0)
    if args.parallel_rank is not None:
        return parallel_rank_main(args.parallel_rank, args.parallel_port,
                                  args.parallel_root, args.seed)
    device_phase()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_phase()
    fwd_rows = flash_fwd_kernel_phase(args.seed)
    bwd_rows = flash_bwd_kernel_phase(args.seed)
    flash_drop_rows = flash_dropout_kernel_phase(args.seed)
    flash_bucket_kernel_phase(args.seed)
    waitk_flash_rows = flash_waitk_kernel_phase(args.seed)
    long_flash_rows = flash_long_audio_kernel_phase(args.seed)
    xent_rows = xent_kernel_phase(args.seed)
    softmax_rows = softmax_xent_kernel_phase(args.seed)
    dropout_rows = dropout_kernel_phase(args.seed)
    ffn_rows = ffn_kernel_phase(args.seed)
    dispatch_phase(args.seed)
    model, inputs, decode_counts = slice_phase(args.seed)
    encoder_cross_check_phase(model, inputs)
    del model
    predict_counts, spec_speech_counts = predict_phase(args.seed)
    export_counts = export_speech_phase(args.seed)
    train_counts, _ = train_phase(args.seed)
    train_dropout_counts, train_dropout_row = train_phase(args.seed,
                                                          dropout=True)
    by_path = {"train": train_counts, "train_dropout": train_dropout_counts,
               "remat_step": remat_step_phase(args.seed, train_dropout_row),
               **export_counts,
               "trainer": trainer_phase(args.seed, train_dropout_row),
               "train_base": nmt_train_phase(args.seed, bf16_params=False),
               "train_base_bf16": nmt_train_phase(args.seed,
                                                  bf16_params=True),
               "decode": decode_counts, "predict": predict_counts,
               "spec_speech": spec_speech_counts}
    (by_path["nmt_trainer"], by_path["nmt_predict"],
     by_path["spec_text"]) = nmt_phases(args.seed)
    by_path.update(pruning_phases(args.seed))
    # QAT's host-bound steps in a worker beside stages that time nothing
    # on the card: the audio prep's CLIs, slice 10's checkpoint
    # conversions and the float32 card-vs-CPU checks
    worker, prepared = QatWorker(args.seed), {}
    # the parallel phase's ranks beside the same host stages
    torch.cuda.empty_cache()
    parallel = ParallelRanks(args.seed)

    def beside_worker():
        prepared["pretrained"] = pretrained_convert(args.seed)
        reference_check_phase(args.seed)
        for nmt in (False, True):
            train_reference_check_phase(args.seed, nmt=nmt)
            train_reference_check_phase(args.seed, dropout=True, nmt=nmt)
        qat_dense_check(args.seed)
        qat_reference_check(args.seed)
        moe_reference_check(args.seed)
        worker.join()
        # before the audio prep's card stages time anything
        by_path.update(parallel.join())
    try:
        by_path["prep_train"], by_path["prep_predict"] = audio_prep_phases(
            args.seed, after_cpu=beside_worker)
    finally:
        worker.stop()
        parallel.stop()
    by_path.update(multitask_phases(args.seed, train_dropout_row))
    by_path.update(waitk_phases(args.seed))
    by_path.update(pretrained_phases(args.seed,
                                     prepared=prepared["pretrained"]))
    by_path["long_audio"] = long_audio_phase(args.seed)
    by_path.update(multilingual_phases(args.seed))
    by_path["qat_speech_step"] = qat_speech_step_phase(args.seed,
                                                       train_dropout_row)
    by_path.update(worker.counts)
    (by_path["int8_serve_speech"],
     by_path["int8_serve_text"]) = int8_serve_phase(args.seed)
    moe_totals, moe_rows = moe_bare_phase(args.seed)
    by_path.update({"moe_train": moe_totals["moe8_top1"],
                    "moe_dense": moe_totals["dense"],
                    "moe_gshard": moe_totals["moe8_top2"]})
    by_path.update(moe_trainer_phases(args.seed))
    main_bf16 = ("main", "bfloat16")
    rows = {  # name -> (main row, {label: row of another case})
        "flash_attention_fwd": (fwd_rows[main_bf16], {
            "with_dropout": flash_drop_rows[("fwd",) + main_bf16],
            "waitk_train": waitk_flash_rows[("fwd", "bfloat16")],
            "long_audio": long_flash_rows[("fwd", "bfloat16")]}),
        "flash_attention_dq": (bwd_rows[("dq",) + main_bf16], {
            "with_dropout": flash_drop_rows[("dq",) + main_bf16],
            "waitk_train": waitk_flash_rows[("dq", "bfloat16")],
            "long_audio": long_flash_rows[("dq", "bfloat16")]}),
        "flash_attention_dkv": (bwd_rows[("dkv",) + main_bf16], {
            "with_dropout": flash_drop_rows[("dkv",) + main_bf16],
            "waitk_train": waitk_flash_rows[("dkv", "bfloat16")],
            "long_audio": long_flash_rows[("dkv", "bfloat16")]}),
        "fused_softmax_xent_fwd": (softmax_rows[("fwd",) + main_bf16], {}),
        "fused_softmax_xent_bwd": (softmax_rows[("bwd",) + main_bf16], {}),
        "fused_dropout": (dropout_rows[main_bf16], {
            "nmt_train": dropout_rows[("nmt", "bfloat16")],
            "moe_train": moe_rows["fused_dropout"]})}
    for kernel in ("fwd", "bwd"):
        rows[f"fused_linear_xent_{kernel}"] = (
            xent_rows[(kernel,) + main_bf16],
            {"nmt_train": xent_rows[(kernel, "nmt_train", "bfloat16")],
             "lightconv_train": xent_rows[(kernel, "lightconv_train",
                                           "bfloat16")],
             "moe_train": moe_rows[f"fused_linear_xent_{kernel}"]})
        rows[f"fused_ffn_{kernel}"] = (
            ffn_rows[(kernel, "main", DROPOUT_RATE, "bfloat16")],
            {"nmt_train": ffn_rows[(kernel, "d512", DROPOUT_RATE,
                                    "bfloat16")],
             "moe_train": moe_rows[f"fused_ffn_{kernel}"]})
    summary = []
    for name, (row, extra) in rows.items():
        counts = {path: c[name] for path, c in by_path.items() if name in c}
        if name not in OFF_PATH and not any(counts.values()):
            raise AssertionError(f"{name} never ran on the main paths")
        summary.append(_summary_row(name, row, sum(counts.values()), counts,
                                    extra))
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
