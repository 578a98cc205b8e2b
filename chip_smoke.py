#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training (f32 and bf16, and
data-parallel), featurization, fold (training, checkpoints, the suppression
sweep, the host fold loop, mid-fold resume), command-line and artifact
(load_predictor, serve / predict / export / import, every model type)
paths on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, in order; any failure raises and exits non-zero with no result line.
Every main path runs with the kernels' launch counts set to 0 just before
and read just after; each kernel the path must use has to have launched
(and block 1's backward kernels must not launch where they are not needed).

1. build       compile every CUDA kernel from sept_tpu_torch/csrc (one nvcc
               per source, all at once) and the WAV decoder from
               csrc/septio.cpp (c++, into build/torch_septio).
2. serve       a full-width Conv2dBiRNN (hidden 64, 128 mels, win 200, shift
               50, n_fft 800, emotion head) from seeded random weights, served
               through a CloakedPredictor (seeded noise, 40-percentile mask)
               by a PredictionServer on 127.0.0.1: 8 float utterances of
               2.5-6 s, a pcm16 batch, a /stream session, then 6 concurrent
               pcm16 requests under micro-batching.  Probabilities finite,
               summing to 1, /metrics counters matching the requests.
3. cpu         the same requests answered on the CPU: probabilities within 1e-4.
4. train-ingest device_ingest of 64 seeded utterances of 2.5-6 s, 4 speakers
               (mel kernel, per-speaker z-norm, windows).
5. train       one epoch of 4 batches of 32 of each workload at full width,
               dropout 0.2: baseline (make_epoch_runner, K1-K4, no K5), plain
               cloak on a frozen backbone (make_cloak_epoch_runner, K1-K3 and
               K5, no K4), cloak + GRL with the antithetic pair (K1-K5).
               Losses finite; frozen backbones bit-unchanged; the GRU's
               bias_hh r/z rows still 0.
6. train-cpu   3 steps of each step function on the card and on the CPU
               (plain versions), dropout 0, one injected epsilon, lr 1e-2, 4
               windows a batch: losses within 1e-4 relative, parameters and
               running statistics within 1e-4 * max(|p|, 1).
7. featurize   featurize_corpus (include_gemaps=False) of a seeded int16
               corpus the size of CREMA-D (7,442 utterances of 1.3-5 s) for
               mel_spec (f32 mel kernel at n_fft 800 and 1600) and mfcc (f32
               mel kernel at n_fft 400 over the wave and its two gradients,
               then the floor + DCT kernel); the bf16 mel kernel must not
               launch.  Every store entry at 1 + n // hop frames, finite;
               utterances per second; one run of 1,024 of the utterances
               under torch.profiler; 8 utterances again on the CPU path:
               mel within 1e-3 dB on cells within 60 dB of the peak (5e-2
               below, the f32 rounding floor), MFCC within 1e-2.  Then
               fused_mfcc (pallas_mfcc's counterpart) on 8 utterances in
               each mel mode (f32 mel or bf16 mel, then floor + DCT) against
               the CPU path: f32 within 1e-2, bf16 within the bf16 mel's
               bounds times the DCT's gain.
8. ingest-bf16 bench.py's ingest (1024 int16 utterances of 2.5 s, 16
               speakers) through device_ingest with frontend "xla" (f32 mel
               kernel only) and "pallas_bf16" (bf16 mel kernel only): windows
               within 0.07 at the 99th percentile (the JAX package's own
               bf16 mode is 0.063 off there), and within 0.05 on the white
               noise of the JAX package's hardware check; both timed with
               CUDA events and profiled once; then one baseline epoch of 4
               batches of 32 on the bf16 windows (K1-K4, finite losses).
9. train-bf16  on those bf16 windows, one epoch of 4 batches of 32 of each
               workload with compute_dtype "bfloat16" (the presets with
               ExperimentConfig.compute_dtype), full width, dropout 0.2:
               baseline (K1-K4 in their bf16 mode, no K5), plain cloak
               (K1-K3 and K5, no K4), cloak + GRL with the antithetic pair
               and saliency_align 0.5 (all five); no block-1 launch in the
               f32 mode.  Losses finite, parameters and statistics still
               f32, frozen backbones bit-unchanged.  Then 3 steps of each on
               the card and on the CPU: losses within 3e-3 relative,
               parameters within 1e-3 and running statistics within 5e-3 of
               max(|p|, 1) (the bounds the CPU tests hold the port to the
               JAX package with).
9b. dp         data parallelism: 2 ranks spawned on card 0 over gloo (NCCL
               refuses two ranks on one card; gloo stages CUDA tensors
               through the host), T_BATCH / 2 rows a rank, one epoch each of
               the f32 baseline (K1-K4, no K5), the f32 cloak + GRL with the
               antithetic pair (all five, K5 carrying dx through the GRL) and
               the bf16 baseline (K1-K4 in their bf16 mode), full width,
               dropout 0, lr 1e-2, on the train phase's windows; each rank
               counts its own launches (set to 0 just before its epoch).  Each
               held to the same epoch in one process on the card (TRAIN_F32_TOL
               / TRAIN_BF16_TOL: losses relative, parameters and running
               statistics of max(|p|, 1)) and the ranks to each other bit for
               bit; a rank's failure or timeout fails the script.  With two
               cards or more the f32 baseline also runs on two cards over
               NCCL; else the line says it was not run.
10. fold       one fold of the utility-privacy protocol at full width on a
               seeded FoldData (training and adversary splits of 512
               windows, validation of 128, 48 test utterances of 250-800
               frames, 12 speakers of two corpora, dataset "combine"),
               through the port's run_folds, f32, 3 epochs each, into a
               CheckpointManager under build/: the baseline and the
               adversary (K1-K4, no K5), the GRL cloak at suppression 0, then
               20, 40, 60 and 80 from it (train_mask, rhos frozen; all five),
               the plain cloak at 0 (K1-K3 and K5, no K4); no bf16 mode, no
               mel or floor + DCT kernel.  The GRL cloaks' emotion backbone
               is the baseline's bit for bit, the suppressed cloaks' rhos the
               suppression-0 cloak's.  Then the GRL sweep over the five
               ratios from the checkpoints (eval_mask, evaluate_cloaked_test,
               sweep_to_rows, rows_to_csv; K1 and K2 only, no backward
               kernel): 15 rows, every value in [0, 1]; one sweep call
               profiled; the sweep on the CPU from the same checkpoints with
               the same epsilon and masks on the first 16 test utterances at
               ratios 0 and 80: probabilities within 1e-4, predictions equal
               where the CPU's top two are more than 2e-4 apart.  Last a
               2-epoch bf16 baseline run_fold (baseline_emotion_bf16; K1-K4
               in their bf16 mode only).
10b. host_loop the host fold loop (train.loop.fit) on another seeded
               FoldData of the fold phase's shape, its training split cut
               to 500 windows (the last batch of 32 padded), dropout 0,
               combine mode: the baseline, 3 epochs, its first epoch under
               fit's profile_dir (the trace must name K1-K4's CUDA symbols)
               and a StepTimer around its steps (n = steps - 1) (K1-K4, no
               K5); the GRL cloak at suppression 20 with its training mask,
               lr 1e-2, 2 epochs (all five); the attention multitask model
               (att="self_att", pred="multitask"), 2 epochs (K1-K4, no K5);
               no bf16 mode, no mel or floor + DCT kernel in any.  The host
               loop's and fit_device's walls per epoch on the same windows
               (losses within 1e-4 of each other).  Each run again on the
               card and on the CPU on a cut fold (14 training windows in
               batches of 4, 8 validation windows, 8 test utterances; the
               GRL's card draws injected on the CPU): per-epoch train and
               validation loss and test accuracy within 1e-4, validation
               accuracy and best epoch equal, the best state within 1e-4 *
               max(|p|, 1).  Then fit_device on the 500 windows (Adam,
               dropout 0.2) interrupted after epoch 1's mid-fold checkpoint
               and resumed: history, best epoch, best and final state and
               step equal to the uninterrupted fold's bit for bit.
11. cli        the protocol through the port's command lines, in process on
               the card under build/cli_smoke: run_all on a synthetic corpus
               of 40 speakers x 16 utterances (640 of 1.2-3.5 s) at the CLI
               defaults (128 mels, windows 200 x 128, hidden 64), fold 1, 3
               epochs a stage, the GRL cloak at scale lambda 0.1 and
               suppression 0 and 20 (featurize with its default gemaps /
               emobase functionals): the f32 mel kernel in featurize, K1-K4
               in the baseline and the adversary (no K5), all five in the
               cloaks, K1 and K2 only in evaluate, no bf16 mode anywhere; each
               artifact's state_dict and manifest, the baselines' run.json,
               the CSV (one row a ratio in sweep_to_rows' layout, values in
               [0, 1]); the sweep again on the CPU from the card's
               checkpoints with the card's epsilon and masks on the first 16
               test utterances: probabilities within 1e-4.  Then a
               CREMA-D-shaped WAV tree (actors 1001-1091, 2 files each, every
               fourth 44.1 kHz stereo, 1076_MTI_SAD_XX skipped) through
               featurize --functionals 0 for mel_spec and mfcc (floor + DCT
               launched), each store checked as in 7 and 8 of its utterances
               (resampled ones among them) held to the CPU path with 7's
               rules; preprocess --folds 1, fold 1's speakers equal to
               plan_folds("crema-d"); and a 1-epoch train_baseline with
               --compute_dtype bfloat16 (K1-K4 in their bf16 mode only).
12. artifacts  on the cli phase's artifacts, before they are removed, 8
               pcm16 utterances of 4 s: load_predictor of baseline_emotion on
               the card and the CPU (probabilities within 1e-4; mel, K1 and K2,
               no backward kernel); the GRL cloak at suppression 20 (its mask
               eval_mask of the restored scales, card vs CPU within 1e-4 at one
               noise seed); cli.serve's make_server (the manifest, --warmup 4,
               --batch_window_ms 5) on the card: /healthz, one /predict, then 8
               concurrent ones, each within 1e-5 of a direct predict (first
               and median latency); cli.predict over the CREMA-D tree on the
               card, and with --device cpu over 32 of its files (the card's
               rows for them, probabilities within 1e-4); export_torch -> import_torch of the baseline and
               the GRL cloak (live tensors bit-equal, the synthesized keys
               present, the imported artifacts served within 1e-6); a 1-epoch
               train_baseline --model_type deep-2d-cnn-lstm (K1-K4, no K5),
               served on the card and the CPU within 1e-4; and 3 baseline
               steps each of the deep LSTM in f32 (K1-K4) and bf16 (K1-K4 in
               their bf16 mode), OneDConvNet and PlainConv2d (no kernel of
               the port) on the card and the CPU at 6's and 9's tolerances.
12b. global    the global feature: the gemaps / emobase functionals of
               7's corpus (all 7,442 utterances) alone
               (combined_functionals_batch: torch ops, no kernel of the port)
               and with mel_spec (featurize_corpus with include_gemaps: the
               f32 mel kernel, never the bf16 one), each vector (88,) /
               (988,) and finite, utterances per second, 1,024 of them under
               torch.profiler, 16 held to the CPU path within rtol = atol =
               2e-3; then run_all --global_feature 1 at 11's size and
               kernels a stage (under build/global_smoke): every artifact's
               manifest says global_feature, the baselines' dense1 takes 2 x
               64 + 88, the CSV, fold 1's global vectors, the sweep held to
               the CPU on 16 test utterances (probabilities within 1e-4); and
               3 steps with the vector of the baseline and of the GRL game
               (antithetic, saliency 0.5) from its artifacts on the card and
               the CPU at 6's tolerances.
13. kernels    each kernel against its plain version on the tensors the main
               path gives it (mel 1e-3 dB cell by cell, and where the FFT
               kernel and the dense plain version part by more, the kernel
               no farther than the plain version from a float64 chain, plus
               1e-3 dB (check_mel); conv
               output 1e-4 and moments rel
               1e-5; pooled 1e-4; K3 dy equal, its sums within 1e-5 of the
               sums of |terms|; K4 and K5 in train and eval BN mode, dW 1e-4
               and dx 1e-5 of max |plain|, db 1e-4 in eval mode and, in train
               mode where it is 0 in exact arithmetic, within B*H*W*2^-24 *
               max |dconv| of 0), then
               timed with CUDA events over back-to-back calls (ms) and
               over calls queued behind a sleep kernel (device_ms: the
               device time, the host's enqueue hidden)
               beside its plain version, one PyTorch call and its roofline
               bound (K4 also beside the library chain of its whole
               function); the f32 mel at featurize_corpus's shapes (one
               64-utterance chunk at n_fft 800 and 1600, the mfcc's 192
               streams at n_fft 400 / hop 200); block 1's forward + backward
               beside autograd through the cuDNN chain; then again at edge
               shapes (ragged tiles, odd sizes, a width that is a multiple
               of 16, a width of three column tiles (K1, K3-K5), one frame,
               n_fft 400 and 1600, each mel against
               float64 too; n_fft 802, 1022, 799, 2042, 2048, 858 and 1001
               at hop 160 on 64 rows of 401 frames, each launching, timed
               beside its plain version; n_mels 320 and 512 at n_fft 1024
               and 2048, F32_WIDE_MEL_EDGES); the bf16 mel
               (max 10 log10(1 + 2^-7) + 1e-4 dB, p99 1e-3 dB) on the bf16 ingest's
               waves, beside the f32 kernel on them and with a second bound
               (bound_mma_ms: its dense DFT products and its bank's
               nonzeros at the bf16 tensor-core rate), and floor + DCT (1e-5 of max |plain|) on one mfcc chunk
               of 64 utterances at bucket 64000, then the bf16 mel at n_fft
               400 / 1600, one frame, n_fft 799 and 2048, hop 320 (frame
               tile built from device memory), n_mels 256, 80, 320 and 512
               (BF16_MEL_EDGES), floor + DCT at FLOOR_DCT_EDGES (n_mfcc 13,
               64, 65, 128; n_mels 40, 512, 1000, 42; 1, 63, 65, 1001 and
               70,000 rows; a misaligned mel; each timed beside its plain
               version); the bf16 modes of K1-K5 on a bf16 baseline
               step's tensors (conv output within one bf16 unit and
               bit-equal in 99.9% of the elements, moments 1e-5 of the sums
               of |terms|, pooled and dy equal, K4 and K5 as in f32), timed
               beside their plain versions, one bf16 PyTorch call and the
               bound, then at the edge shapes; K2 in both modes bit-equal
               to its plain version at K2_EDGES (odd H and W, widths off
               16, three column tiles, a misaligned conv output).
14. latency    /predict round trips at 1 and 8 utterances (pcm16), beside the
               server's device-call time.
15. profile    device time by kernel over predict calls of 1 and of 8
               utterances and over 3 baseline and 3 cloak + GRL steps in each
               dtype, the device's busy share of the wall time
               (torch.profiler), the f32 rate of the blocks 2-3 convolutions
               when serving, and the bf16 GRU's step loop beside cuDNN's bf16
               GRU (a yardstick: it keeps a bf16 hidden state).

Output: ``{"block1_eval": ...}``, ``{"latency_ms": ...}``, ``{"profile":
...}``, ``{"train": ...}``, ``{"block1_train": ...}``, ``{"train_profile":
...}``, ``{"featurize": ...}``, ``{"ingest_bf16": ...}``,
``{"train_bf16": ...}``, ``{"dp": ...}``, ``{"fold": ...}``, ``{"cli":
...}``, ``{"artifacts": ...}``, ``{"global": ...}`` and ``{"host_loop":
...}`` lines, the card's ``name, power.limit`` from nvidia-smi, a
``{"kernels": [...]}`` line (every kernel, block 1's in each mode), and
last ``{"ok": true, "device": {...}}``.  Progress goes to stderr.
The result lines (with the card's) are also written whole to
``chiprun_out/chip_smoke.jsonl`` beside the script (git-ignored).
"""

import base64
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

SEED = 0
DEV = "cuda"  # the card every phase runs on
WIN, SHIFT, N_FFT, HOP, N_MELS, HIDDEN = 200, 50, 800, 160, 128, 64
PEAK_F32_FLOPS = 67e12   # H100 SXM, f32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM, bf16 dense tensor cores (bf16 operands)
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
TOL = {"mel_db": 1e-3, "block1_conv_stats": 1e-4, "block1_norm_pool": 1e-4}
MOMENTS_RTOL = 1e-5
PROBS_ATOL = 1e-4
# training slice: 64 utterances of 4 speakers, epochs of 4 batches of 32
N_TRAIN, N_SPK, T_BATCH, T_BATCHES, CPU_BATCH = 64, 4, 32, 4, 4
# K3 dy equal to its plain version; dW, db and dx of max |plain|
TRAIN_TOL = {"block1_route": 0.0, "block1_weight_grads": 1e-4, "block1_input_grad": 1e-5}
SUMS_RTOL = 1e-5   # K3's per-channel sums, of the sum of |terms|
# the backward's edge shapes: ragged tiles and bands, odd widths (K4's
# one-column-a-load path), and a width that is a multiple of 16 with a
# ragged band (K4's bf16 tensor-core path)
K4_EDGES = ((1, 37, 29), (3, 64, 33), (2, 37, 48))
# and a width of three column tiles, the last ragged (K1 and K5 across tile
# borders, K5's halo columns from both neighbours); a multiple of 8, so K1's
# bf16 tensor-core path crosses the tiles too, and not of 16, so K4 and K5
# bf16 keep their FMA paths there
WIDE_EDGE = (1, 27, 264)
BACKWARD = ("block1_route", "block1_weight_grads", "block1_input_grad")
BLOCK1 = ("block1_conv_stats", "block1_norm_pool") + BACKWARD
BLOCK1_BF16 = tuple(f"{k}_bf16" for k in BLOCK1)  # the kernels' bf16 mode, counted apart
# bf16 training: the saliency-alignment weight of its GRL game, and GPU vs
# CPU over 3 steps held to the bounds tests/test_torch_train_bf16.py holds
# the port to the JAX package with (losses relative; trained parameters and
# running statistics of max(|p|, 1))
SALIENCY_ALIGN = 0.5
TRAIN_BF16_TOL = {"loss": 3e-3, "param": 1e-3, "stats": 5e-3}
TRAIN_F32_TOL = {"loss": 1e-4, "param": 1e-4, "stats": 1e-4}
# bf16 conv output, kernel vs plain: the same rounded operands summed in
# another f32 order round to neighbouring bf16 values at most (one bf16
# unit, 2^-7 of |y|, plus 1e-6 where y cancels to near 0), in at most 0.1%
# of the elements; pooled values and dy equal on the same inputs
BF16_CONV_EQUAL_SHARE = 0.999
# featurization slice: a CREMA-D-sized corpus (7,442 utterances of 1.3-5 s)
N_CORPUS, CORPUS_S, MFCC_HOP, N_FEAT_CPU = 7442, (1.3, 5.0), 200, 8
N_FEAT_PROFILE = 1024  # utterances of the corpus featurized under torch.profiler
# GPU vs CPU store: mel dB on cells within 60 dB of the utterance's peak
# (FEAT_LOW_TOL below that, as tests/test_torch_frontend.py holds the golden
# cells), MFCC coefficients
FEAT_TOL, FEAT_LOW_TOL = {"mel_spec": 1e-3, "mfcc": 1e-2}, 5e-2
# bench.py's ingest: 1024 int16 utterances of 2.5 s.  bf16 vs f32 windows at
# the 99th percentile: < 0.05 on the white noise of the JAX package's own
# hardware check (tests_tpu/test_tpu_smoke.py); on bench.py's tones over weak
# noise the JAX package's bf16 mode is itself 0.063 off its f32 mode
# (tests/test_torch_ingest_bf16.py holds the port's deviation to JAX's)
N_INGEST, INGEST_P99, INGEST_BENCH_P99 = 1024, 0.05, 0.07
# bf16 mel kernel vs its plain version: the same operands rounded alike; an
# f32 sum in another order can flip a bf16 rounding of the power, one bf16
# unit, <= 2^-7 of its term, so a band moves <= 10 log10(1 + 2^-7) dB, which
# a band of one frequency bin reaches; 1e-4 dB more for the f32 sums and log
BF16_MAX, BF16_P99 = 10 * np.log10(1 + 2.0 ** -7) + 1e-4, 1e-3
FLOOR_DCT_RTOL = 1e-5  # of max |plain|: two f32 sums of 128 terms
# the bf16 mel kernel's edges (rows, n_fft, hop, frames, n_mels): ragged
# frame tiles at n_fft 400 / hop 200 and 1600, one frame, an odd n_fft, the
# largest n_fft (frame tile built slab by slab), hop 320 (a tile's samples
# past its staging room: the whole frame tile built from device memory), two
# mel passes (256), a bank narrower than one (80), and three and four passes
# (320 at n_fft 800, 512 at n_fft 2048: bands with no frequency bin, -100 dB)
BF16_MEL_EDGES = ((3, 400, 200, 70, 128), (2, 1600, 160, 37, 128), (1, 800, 160, 1, 128),
                  (2, 799, 160, 90, 128), (2, 2048, 160, 50, 128), (2, 800, 320, 40, 128),
                  (2, 800, 160, 100, 256), (2, 800, 160, 100, 80), (2, 800, 160, 100, 320),
                  (2, 2048, 160, 50, 512))
# the f32 mel kernel's wide banks (rows, n_fft, hop, frames, n_mels): three
# and four bf16 passes' widths, with empty bands at n_fft 1024
F32_WIDE_MEL_EDGES = ((2, 1024, 160, 60, 320), (2, 2048, 160, 60, 512))
# floor + DCT off the featurize chunk (rows, n_mels, n_mfcc, misaligned):
# coefficients 13, 64, 65 (a ragged coefficient tile) and 128 (four tiles);
# 40 and 512 mels, 1000 (two launches, the second continuing the first's
# sums) and 42 (rows the tensor copy cannot take: loaded by the producer's
# lanes); a mel tensor one float off 16-byte alignment; 1, 63, 65 and 1001
# rows, and 70,000 (274 row tiles: more than the persistent grid's blocks,
# two an SM)
FLOOR_DCT_EDGES = ((4000, 128, 13, False), (4000, 128, 64, False), (4000, 128, 65, False),
                   (4000, 128, 128, False), (4000, 40, 40, False), (4000, 512, 40, False),
                   (4000, 1000, 40, False), (4000, 42, 13, False), (4000, 128, 40, True),
                   (1, 128, 40, False), (63, 128, 40, False), (65, 128, 40, False),
                   (1001, 128, 40, False), (70000, 128, 40, False))
# one fold of the protocol at full width: training and adversary splits of
# FOLD_TRAIN windows, validation of FOLD_VAL, FOLD_TEST whole test
# utterances of FOLD_FRAMES frames (padded to the longest) from FOLD_SPK
# speakers of two corpora (dataset "combine"); FOLD_EPOCHS f32 epochs a
# stage (min_select_epoch caps at 1), the GRL sweep over FOLD_RATIOS, 2 bf16
# baseline epochs; the card's sweep against the CPU's on FOLD_CPU_UTTS test
# utterances at FOLD_CPU_RATIOS
FOLD_TRAIN, FOLD_VAL, FOLD_TEST, FOLD_FRAMES, FOLD_SPK = 512, 128, 48, (250, 800), 12
FOLD_EPOCHS, FOLD_RATIOS, FOLD_CPU_UTTS, FOLD_CPU_RATIOS = 3, (0, 20, 40, 60, 80), 16, (0, 80)
# the GRL cloaks' learning rate: at the preset's 1e-3 a step moves rho by
# ~1e-8 (its gradient is 4e-6 to 1e-5 at full width), under f32's spacing at
# rho = -2 (2.4e-7), so the scales would stay uniform and every percentile
# mask would keep every cell
FOLD_GRL_LR = 1e-2
# the host fold loop (the host_loop phase): train.loop.fit on the fold
# phase's data with the training split cut to HOST_TRAIN windows (so the last
# batch of 32 is padded), HOST_EPOCHS epochs of the baseline and
# HOST_SHORT_EPOCHS of the GRL cloak (at suppression HOST_SUPP, lr
# FOLD_GRL_LR) and of the attention multitask model, dropout 0; each run held
# to the same run on the CPU on a cut fold (HOST_CPU_TRAIN training windows
# in batches of CPU_BATCH, the last padded, HOST_CPU_VAL validation windows,
# HOST_CPU_TEST test utterances) within HOST_TOL (tests/test_torch_fold.py's
# bounds); then fit_device on the HOST_TRAIN windows interrupted after
# epoch HOST_STOP and resumed, dropout HOST_RESUME_DROPOUT, bit-equal to the
# uninterrupted run
HOST_TRAIN, HOST_EPOCHS, HOST_SHORT_EPOCHS, HOST_SUPP = 500, 3, 2, 20
HOST_CPU_TRAIN, HOST_CPU_VAL, HOST_CPU_TEST, HOST_TOL = 3 * CPU_BATCH + 2, 8, 8, 1e-4
HOST_STOP, HOST_RESUME_DROPOUT = 1, 0.2
# the CUDA symbols of block 1's f32 kernels K1-K4, as a profiler trace names them
BLOCK1_SYMBOLS = ("conv_stats", "norm_pool", "route", "weight_grads")
# the protocol through its command lines (the cli phase): run_all on a
# synthetic corpus of CLI_SPEAKERS x CLI_UTTS utterances of 1.2-3.5 s at the
# CLI defaults (128 mels, windows 200 x 128 at shift 50, hidden 64), fold 1,
# CLI_EPOCHS epochs a stage, the GRL cloak at scale lambda CLI_SCALE and
# suppression CLI_RATIOS, under build/cli_smoke; then a CREMA-D-shaped tree
# (actors 1001-1091, one utterance a sentence of CREMA_SENTENCES, every
# fourth file 44.1 kHz stereo) featurized from WAV files
CLI_SPEAKERS, CLI_UTTS, CLI_EPOCHS, CLI_SCALE, CLI_RATIOS = 40, 16, 3, 0.1, (0, 20)
# the artifacts phase, on the cli phase's artifacts: ART_UTTS pcm16
# utterances of ART_SECONDS, the GRL cloak at suppression ART_SUPP (one of
# CLI_RATIOS) with noise seed ART_SEED
ART_UTTS, ART_SECONDS, ART_SUPP, ART_SEED = 8, 4.0, 20, 3
# cli.predict with --device cpu reads this many of the CREMA-D tree's files
ART_PREDICT_CPU = 32
CREMA_SENTENCES, CREMA_STEREO_SR = ("DFA", "IEO"), 44100
# the global feature (the global phase): the gemaps / emobase functionals of
# the featurize phase's corpus, GLOBAL_CPU of its utterances held to the CPU
# path within GLOBAL_TOL (rtol and atol: the bound tests/test_torch_egemaps.py
# and tests/test_torch_emobase.py hold the port to the JAX package with),
# then run_all --global_feature 1 at the cli phase's size under
# build/global_smoke
GLOBAL_CPU, GLOBAL_TOL = 16, 2e-3
# data parallelism (the dp phase): DP_RANKS ranks share card 0 over gloo,
# one epoch a case of the training phase's T_BATCHES batches of T_BATCH
# (T_BATCH / DP_RANKS rows a rank), dropout 0, at DP_LR so that the weights
# move; each case's (dtype, kernels that must launch, kernels that must not)
DP_RANKS, DP_DEADLINE_S, DP_LR = 2, 600, 1e-2
DP_CASES = {
    "baseline": ("float32", BLOCK1[:-1], ("block1_input_grad",) + BLOCK1_BF16),
    "cloak_grl": ("float32", BLOCK1, BLOCK1_BF16),
    "baseline_bf16": ("bfloat16", BLOCK1_BF16[:-1], ("block1_input_grad_bf16",) + BLOCK1),
}
CORPORA = ("iemocap", "crema-d")
NO_FRONTEND = ("mel_db", "mel_db_bf16", "floor_dct")  # featurization's kernels
# K2 (norm_pool) off the main path, both modes, (B, H, W, misaligned): odd H
# and W, widths that are not a multiple of 16 (33, 29, 264: the per-cell path
# in bf16, 264 the runs in f32), three column tiles, 48 (runs in both), a
# conv output one element off 16-byte alignment (the per-cell path)
K2_EDGES = ((1, 37, 29, False), (3, 64, 33, False), (2, 37, 48, False), (1, 27, 264, False),
            (2, 201, 129, False), (2, 200, 128, True))


def log(msg):
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def speechlike(rng, n):
    """Two tones over a broadband noise floor: every mel band stays far above
    f32 rounding, so two summation orders agree to well under 1e-3 dB."""
    t = np.arange(n) / 16000.0
    w = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * t)
         + 0.1 * np.sin(2 * np.pi * rng.uniform(800, 3000) * t)
         + 0.05 * rng.standard_normal(n))
    return w.astype(np.float32)


def build_weights(seed=SEED):
    """Seeded random state_dicts of the backbone and the cloak, and the mask."""
    from sept_tpu_torch.models import CloakNoise, Conv2dBiRNN

    torch.manual_seed(seed)
    model = Conv2dBiRNN(hidden_size=HIDDEN, feature_len=N_MELS, pred="emotion")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for i in (1, 6, 11):
            bn = model.conv[i]
            bn.weight.copy_(1 + 0.1 * torch.randn(bn.weight.shape, generator=g))
            bn.bias.copy_(0.1 * torch.randn(bn.bias.shape, generator=g))
            bn.running_mean.copy_(0.1 * torch.randn(bn.running_mean.shape, generator=g))
            bn.running_var.copy_(1 + 0.5 * torch.rand(bn.running_var.shape, generator=g))
    noise = CloakNoise(win_len=WIN, n_feats=N_MELS, max_scale=5.0)
    with torch.no_grad():
        noise.locs.copy_(0.1 * torch.randn(noise.locs.shape, generator=g))
        noise.rhos.copy_(-3 + 4 * torch.rand(noise.rhos.shape, generator=g))
        scales = noise.scales()[0].numpy()
    # evaluation-direction suppression: zero the cells above the 40th percentile
    mask = np.where(scales > np.percentile(scales, 40), 0.0, 1.0).astype(np.float32)
    return model.state_dict(), noise.state_dict(), mask


def make_predictor(weights, device):
    from sept_tpu_torch.serve import CloakedPredictor

    sd, noise_sd, mask = weights
    return CloakedPredictor(sd, noise_state_dict=noise_sd, mask=mask, max_scale=5.0,
                            hidden_size=HIDDEN, feature_len=N_MELS, win_len=WIN,
                            shift_len=SHIFT, n_fft=N_FFT, device=device)


def make_requests(rng):
    """The main path's traffic: (name, waveforms, seed)."""
    floats = [speechlike(rng, int(rng.uniform(2.5, 6.0) * 16000)) for _ in range(8)]
    pcm = [(speechlike(rng, int(rng.uniform(2.5, 4.0) * 16000)) * 20000).astype(np.int16)
           for _ in range(4)]
    stream = (speechlike(rng, 3 * 16000) * 20000).astype(np.int16)
    concurrent = [((speechlike(rng, int(rng.uniform(2.5, 4.0) * 16000)) * 20000).astype(np.int16),
                   seed) for seed in (0, 0, 0, 0, 5, 5)]
    return floats, pcm, stream, concurrent


def post(url, body, method=None):
    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 method=method)
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.load(r)


def check_probs(probs, n, what):
    p = np.asarray(probs, np.float64)
    require(p.shape == (n, 4), f"{what}: probs shape {p.shape}")
    require(np.isfinite(p).all(), f"{what}: non-finite probabilities")
    require(np.abs(p.sum(-1) - 1).max() < 1e-5, f"{what}: probabilities do not sum to 1")
    return p


class Serving:
    """A PredictionServer on 127.0.0.1 with its thread; stop() joins it."""

    def __init__(self, predictor, **kw):
        from sept_tpu_torch.serve import PredictionServer

        self.server = PredictionServer(predictor, host="127.0.0.1", port=0, **kw)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.server.port}"

    def stop(self):
        self.server.shutdown()
        self.thread.join(30)
        require(not self.thread.is_alive(), "server thread did not stop")


def serve_phase(predictor, reqs):
    """Drive the main path over HTTP; returns {request name: probs}."""
    floats, pcm, stream, concurrent = reqs
    answers = {}
    a = Serving(predictor)
    try:
        require(post(f"{a.base}/healthz", None)["cloaked"] is True, "healthz")
        out = post(f"{a.base}/predict", {"waveforms": [w.tolist() for w in floats], "seed": 1})
        answers["float8"] = check_probs(out["probs"], len(floats), "float8")
        out = post(f"{a.base}/predict", {"waveforms_pcm16": [
            base64.b64encode(w.astype("<i2").tobytes()).decode() for w in pcm], "seed": 2})
        answers["pcm16"] = check_probs(out["probs"], len(pcm), "pcm16")
        sid = post(f"{a.base}/stream", {"seed": 3})["session"]
        for lo in range(0, len(stream), 16000):
            out = post(f"{a.base}/stream/{sid}", {
                "pcm16": base64.b64encode(stream[lo:lo + 16000].tobytes()).decode()})
        require(out["samples"] == len(stream), "stream sample count")
        answers["stream"] = check_probs([out["probs"]], 1, "stream")
        require(post(f"{a.base}/stream/{sid}", None, method="DELETE") == {"closed": sid},
                "stream delete")
        m = post(f"{a.base}/metrics", None)
        n_pushes = -(-len(stream) // 16000)
        want = {"requests_total": 3 + n_pushes, "errors_total": 0,
                "device_calls_total": 2 + n_pushes,
                "waveforms_total": len(floats) + len(pcm) + n_pushes}
        require({k: m[k] for k in want} == want, f"/metrics {m} != {want}")
    finally:
        a.stop()

    b = Serving(predictor, batch_window_ms=300)
    results = {}
    bodies = [{"waveforms_pcm16": [base64.b64encode(w.astype("<i2").tobytes()).decode()],
               "seed": seed} for w, seed in concurrent]
    start = threading.Barrier(len(bodies))
    try:
        def fire(i):
            start.wait(60)  # all requests leave together, inside one batch window
            results[i] = post(f"{b.base}/predict", bodies[i])

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        require(all(not t.is_alive() for t in threads) and len(results) == len(concurrent),
                "concurrent requests did not all finish")
        m = post(f"{b.base}/metrics", None)
        require(m["requests_total"] == len(concurrent) and m["errors_total"] == 0
                and m["waveforms_total"] == len(concurrent), f"/metrics {m}")
        require(m["device_calls_total"] < len(concurrent) and m["batched_requests_total"] >= 2,
                f"micro-batching did not coalesce: {m}")
    finally:
        b.stop()
    answers["concurrent"] = np.concatenate(
        [check_probs(results[i]["probs"], 1, f"concurrent {i}") for i in range(len(concurrent))])
    return answers


def reference_answers(predictor, reqs):
    """The same requests answered in-process (no HTTP)."""
    floats, pcm, stream, concurrent = reqs
    return {
        "float8": predictor.predict(floats, seed=1),
        "pcm16": predictor.predict(pcm, seed=2),
        "stream": predictor.predict([stream], seed=3),
        "concurrent": np.concatenate([predictor.predict([w], seed=s) for w, s in concurrent]),
    }


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3):
    """Device time of one call of ``fn``: CUDA events around ``iters`` calls
    enqueued behind a sleep kernel, so the device starts on them only after
    the host has queued them all and the host's time between launches (a
    heavy wrapper's, a busy host's), which cuda_ms includes, drops out.  If
    the device reached the first event before the host was done, the sleep
    doubles and the run repeats; "not measured" if it never got ahead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 1 << 25
    for _ in range(5):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        cycles *= 2
    return "not measured"


def mel_truth(x, t, n_fft, hop, n_mels=N_MELS):
    """The mel function in float64 on the card: the f32 samples and window
    widened, an rFFT (cuFFT, float64), the power, the f32 bank widened, the
    log.  A yardstick of accuracy only."""
    from sept_tpu_torch.ops import mel as M

    window, _, _, fb = M._tables(n_fft, n_mels, x.device)
    frames = x.double().unfold(1, n_fft, hop)[:, :t] * window.double()
    power = torch.fft.rfft(frames).abs() ** 2
    return 10.0 * torch.log10(torch.clamp(power @ fb.double(), min=M.AMIN))


def check_mel(k, p, x, t, n_fft, hop, what, n_mels=N_MELS):
    """The f32 mel kernel against its plain version, cell by cell: within
    TOL["mel_db"] dB, or, where the two part by more, the kernel no farther
    than the plain version from the float64 truth, plus TOL["mel_db"]: on
    cells far under their frame's peak the plain version's dense f32 DFT is
    off the truth by more than the tolerance (PERF.md).  Returns the
    readings."""
    tol = TOL["mel_db"]
    truth = mel_truth(x, t, n_fft, hop, n_mels)
    dk, dp = (k.double() - truth).abs(), (p.double() - truth).abs()
    depth = truth.amax(-1, keepdim=True) - truth  # dB under the frame's peak band
    d = (k - p).abs()
    part = d > tol
    out = {"max_abs_vs_plain": float(d.max()), "cells": k.numel(),
           "cells_parted": int(part.sum()), "kernel_vs_f64": float(dk.max()),
           "plain_vs_f64": float(dp.max())}
    if out["cells_parted"]:
        out.update(parted_kernel_vs_f64_max=float(dk[part].max()),
                   parted_plain_vs_f64_max=float(dp[part].max()),
                   parted_kernel_closer=int((dk[part] < dp[part]).sum()),
                   parted_kernel_farther_past_tol=int((dk[part] > dp[part] + tol).sum()),
                   parted_min_db_under_frame_peak=float(depth[part].min()))
    require(bool((dk[part] <= dp[part] + tol).all()),
            f"{what}: mel_db parts from its plain version by more than its tolerance and from "
            f"the float64 truth by more than the plain version does, plus {tol}: {out}")
    return out


def bound(flops, nbytes, peak=PEAK_F32_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes")


def kernel_phase(predictor, floats, launches):
    """Each kernel vs its plain version on the main path's tensors, timed."""
    import torch.nn.functional as tf

    from sept_tpu_torch.ops import conv_block1 as K
    from sept_tpu_torch.ops import mel as M

    dev = predictor.device
    buf, nf, max_t = predictor.bucket(floats)
    with torch.inference_mode():
        padded = torch.from_numpy(buf).to(dev)  # the float8 request: f32 rows
        flat, _ = predictor.windows(buf, nf, max_t, seed=1)
        conv, bn = predictor.model.conv[0], predictor.model.conv[1]
        w, b = conv.weight.detach(), conv.bias.detach()
        scale, shift = K.fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
        mel_k = M.mel_db(padded, max_t, N_FFT, HOP, N_MELS)
        mel_p = M.mel_db_plain(padded, max_t, N_FFT, HOP, N_MELS)
        y_k, s_k = K.block1_conv_stats(flat, w, b)
        y_p, s_p = K.block1_conv_stats_plain(flat, w, b)
        pool_k = K.block1_norm_pool(y_p, scale, shift)
        pool_p = K.block1_norm_pool_plain(y_p, scale, shift)
        torch.cuda.synchronize()

        err = {
            "mel_db": float((mel_k - mel_p).abs().max()),
            "block1_conv_stats": float((y_k - y_p).abs().max()),
            "block1_norm_pool": float((pool_k - pool_p).abs().max()),
        }
        moments_rel = float(((s_k - s_p).abs() / s_p.abs().clamp(min=1e-6)).max())
        mel_check = check_mel(mel_k, mel_p, padded, max_t, N_FFT, HOP, "serving")
        log(f"mel_db at the serving shape: {mel_check}")
        for name, e in err.items():
            log(f"{name}: max |kernel - plain| = {e:.3g} (tolerance {TOL[name]:g})")
            if name != "mel_db":  # held cell by cell by check_mel
                require(e <= TOL[name], f"{name} disagrees with its plain version: {e}")
        log(f"block1_conv_stats moments: max rel diff {moments_rel:.3g}")
        require(moments_rel <= MOMENTS_RTOL, f"moments disagree: {moments_rel}")

        def cudnn_block(x):
            z = tf.conv2d(x, w, b, padding=2)
            z = tf.batch_norm(z, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                              training=False, eps=bn.eps)
            return tf.max_pool2d(torch.relu(z), 2)

        stft_err = float((stft_chain(padded, N_FFT, HOP) - mel_k).abs().max())
        cudnn_err = float((cudnn_block(flat) - pool_k).abs().max())

        bsz, length = padded.shape
        n, _, h, wd = flat.shape
        c = w.shape[0]
        outs = n * c * h * wd
        k1_bound = bound(outs * (2 * 25 + 1 + 3),
                         4.0 * (n * h * wd + c * 26 + outs + 2 * c))
        k2_bound = bound(3.0 * outs, 4.0 * (outs + 2 * c + outs // 4))

        rows = [
            ("mel_db", "sept_tpu_torch/csrc/mel.cu",
             "sept_tpu/ops/pallas_frontend.py:54",
             lambda: M.mel_db(padded, max_t, N_FFT, HOP, N_MELS),
             lambda: M.mel_db_plain(padded, max_t, N_FFT, HOP, N_MELS),
             lambda: stft_chain(padded, N_FFT, HOP), mel_bound(bsz, length, bsz * max_t, N_FFT)),
            ("block1_conv_stats", "sept_tpu_torch/csrc/conv_block1.cu",
             "sept_tpu/ops/pallas_conv.py:120",
             lambda: K.block1_conv_stats(flat, w, b),
             lambda: K.block1_conv_stats_plain(flat, w, b),
             lambda: tf.conv2d(flat, w, b, padding=2), k1_bound),
            ("block1_norm_pool", "sept_tpu_torch/csrc/conv_block1.cu",
             "sept_tpu/ops/pallas_conv.py:155",
             lambda: K.block1_norm_pool(y_p, scale, shift),
             lambda: K.block1_norm_pool_plain(y_p, scale, shift),
             None, k2_bound),
        ]
        kernels = []
        for name, src, replaces, kern, plain, lib, (bound_ms, bound_by) in rows:
            kernels.append({
                "name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": sum(p[name] for p in launches.values()),
                "launches_by_path": {k: p[name] for k, p in launches.items()},
                "max_abs_err": err[name],
                "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain), "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None if lib is None else cuda_ms(lib),
                "device_ms": device_ms(kern),
                "library_device_ms": None if lib is None else device_ms(lib),
            })
        kernels[0]["check_vs_f64"] = mel_check
        kernels[1]["moments_max_rel_err"] = moments_rel
        block1 = {
            "shape": list(flat.shape),
            "kernels_ms": cuda_ms(lambda: K.block1_eval(
                flat, w, b, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)),
            "cudnn_chain_ms": cuda_ms(lambda: cudnn_block(flat)),
            "cudnn_chain_max_abs_diff": cudnn_err,
        }
        kernels[0]["bound_counts"] = "rFFT 2.5 n log2 n + sparse mel bank"
        kernels[0]["library"] = "torch.stft + matmul + log10"
        kernels[0]["library_max_abs_diff_db"] = stft_err
        kernels[1]["library"] = "F.conv2d (cuDNN, no moments)"
        shapes = {"mel_db": [list(padded.shape), max_t], "block1": list(flat.shape)}
    return kernels, block1, shapes


def edge_phase(device):
    """Each kernel against its plain version at shapes off the main path:
    ragged frame and pixel tiles, odd sizes, n_fft 1600, one row, and
    n_fft off the 2-3-5 rule (prime halves, an odd n_fft, 2048)."""
    from sept_tpu_torch.ops import conv_block1 as K
    from sept_tpu_torch.ops import mel as M

    g = torch.Generator(device=device).manual_seed(SEED + 3)
    g_mel = torch.Generator(device=device).manual_seed(SEED + 4)
    worst = {}
    with torch.inference_mode():
        # ragged frame tiles (T not a multiple of the block's frames), one
        # row, one frame, and each n_fft of the repo (the mfcc's 400 at hop
        # 200, serving's 800, mel2's 1600); each also against float64.  The
        # first two draw from g, as the block-1 shapes after them do.
        for i, (b, n_fft, hop, t) in enumerate(((1, 800, HOP, 37), (3, 1600, HOP, 70),
                                                (3, 400, 200, 70), (2, 1600, HOP, 33),
                                                (1, 800, HOP, 1))):
            x = 0.3 * torch.randn(b, (t - 1) * hop + n_fft + 77, device=device,
                                  generator=g if i < 2 else g_mel)
            k = M.mel_db(x, t, n_fft, hop, N_MELS)
            p = M.mel_db_plain(x, t, n_fft, hop, N_MELS)
            c = check_mel(k, p, x, t, n_fft, hop, f"edge ({b}, {n_fft}, {hop}, {t})")
            worst["mel_db"] = max(worst.get("mel_db", 0.0), c["max_abs_vs_plain"])
            for key in ("kernel_vs_f64", "plain_vs_f64"):
                worst[f"mel_db_{key}"] = max(worst.get(f"mel_db_{key}", 0.0), c[key])
        # n_fft off the 2-3-5 rule at hop 160, at a featurize chunk's size
        # (64 rows, 401 frames): Bluestein (prime halves 802 and 2042, 1022 =
        # 2 * 7 * 73, 858 = 2 * 3 * 11 * 13, odd 799 = 17 * 47 and 1001 = 7 *
        # 11 * 13) and 2048 (radix 4, 4 warps a block); each launches and
        # holds check_mel's rule, timed beside its plain version
        worst["mel_db_any_n_fft"] = []
        for n_fft in (802, 1022, 799, 2042, 2048, 858, 1001):
            b, t = 64, 401
            x = 0.3 * torch.randn(b, (t - 1) * HOP + n_fft + 77, device=device, generator=g_mel)
            before = M.mel_db.launches
            k = M.mel_db(x, t, n_fft, HOP, N_MELS)
            require(M.mel_db.launches == before + 1, f"mel_db did not launch at n_fft {n_fft}")
            p = M.mel_db_plain(x, t, n_fft, HOP, N_MELS)
            c = check_mel(k, p, x, t, n_fft, HOP, f"edge n_fft {n_fft}")
            worst["mel_db_any_n_fft"].append({
                "n_fft": n_fft, "hop": HOP, "shape": [b, x.shape[1], t],
                "radices": list(M.fft_radices(n_fft)),
                "bluestein_length": M.bluestein_length(n_fft),
                "max_abs_vs_plain": c["max_abs_vs_plain"], "check_vs_f64": c,
                "device_ms": device_ms(lambda: M.mel_db(x, t, n_fft, HOP, N_MELS)),
                "plain_device_ms": device_ms(lambda: M.mel_db_plain(x, t, n_fft, HOP, N_MELS))})
            log(f"mel_db at n_fft {n_fft}: {worst['mel_db_any_n_fft'][-1]}")
            for key in ("kernel_vs_f64", "plain_vs_f64"):
                worst[f"mel_db_{key}"] = max(worst[f"mel_db_{key}"], c[key])
        # wide banks (n_mels past 256: the fault closed in this slice), each
        # launching and held to check_mel's rule
        worst["mel_db_wide"] = []
        g_wide = torch.Generator(device=device).manual_seed(SEED + 21)
        for b, n_fft, hop, t, n_mels in F32_WIDE_MEL_EDGES:
            x = 0.3 * torch.randn(b, (t - 1) * hop + n_fft + 77, device=device, generator=g_wide)
            before = M.mel_db.launches
            k = M.mel_db(x, t, n_fft, hop, n_mels)
            require(M.mel_db.launches == before + 1, f"mel_db did not launch at n_mels {n_mels}")
            p = M.mel_db_plain(x, t, n_fft, hop, n_mels)
            c = check_mel(k, p, x, t, n_fft, hop, f"edge n_mels {n_mels}", n_mels)
            worst["mel_db_wide"].append({"n_fft": n_fft, "n_mels": n_mels, "shape": [b, t],
                                         "empty_bands": int((k == -100.0).all(1).all(0).sum()),
                                         "check_vs_f64": c})
            worst["mel_db"] = max(worst["mel_db"], c["max_abs_vs_plain"])
        for b, h, w in K4_EDGES + (WIDE_EDGE,):
            x = torch.randn(b, 1, h, w, device=device, generator=g)
            wt = 0.2 * torch.randn(32, 1, 5, 5, device=device, generator=g)
            bias = 0.1 * torch.randn(32, device=device, generator=g)
            y_k, s_k = K.block1_conv_stats(x, wt, bias)
            y_p, s_p = K.block1_conv_stats_plain(x, wt, bias)
            if (b, h, w) in ((1, 37, 29), (3, 64, 33)):
                rel = float(((s_k - s_p).abs() / s_p.abs().clamp(min=1e-6)).max())
                require(rel <= MOMENTS_RTOL, f"edge moments disagree at {(b, h, w)}: {rel}")
            else:  # sum y may cancel far below its terms: held as K3's sums are
                terms = torch.stack([y_p.abs().sum((0, 2, 3)), (y_p * y_p).sum((0, 2, 3))])
                rel = float(((s_k - s_p).abs() / terms.clamp(min=1e-30)).max())
                require(rel <= SUMS_RTOL, f"edge moments disagree at {(b, h, w)}: {rel}")
            worst["block1_conv_stats_moments"] = max(worst.get("block1_conv_stats_moments", 0.0),
                                                     rel)
            worst["block1_conv_stats"] = max(worst.get("block1_conv_stats", 0.0),
                                             float((y_k - y_p).abs().max()))
            scale = 1 + 0.1 * torch.randn(32, device=device, generator=g)
            shift = 0.1 * torch.randn(32, device=device, generator=g)
            worst["block1_norm_pool"] = max(worst.get("block1_norm_pool", 0.0), float(
                (K.block1_norm_pool(y_p, scale, shift)
                 - K.block1_norm_pool_plain(y_p, scale, shift)).abs().max()))
    for name in TOL:
        require(worst[name] <= TOL[name],
                f"{name} disagrees with its plain version at edge shapes: {worst[name]}")
    return worst


def latency_phase(predictor, rng):
    """/predict round trips (pcm16 wire format) at 1 and 8 utterances of 4 s,
    beside the server's own device-call time from /metrics."""
    out = {}
    for n in (1, 8):
        body = {"waveforms_pcm16": [
            base64.b64encode((speechlike(rng, 4 * 16000) * 20000).astype("<i2").tobytes()).decode()
            for _ in range(n)]}
        a = Serving(predictor)
        try:
            post(f"{a.base}/predict", body)  # warm
            ms = []
            for _ in range(7):
                t0 = time.perf_counter()
                check_probs(post(f"{a.base}/predict", body)["probs"], n, "latency")
                ms.append((time.perf_counter() - t0) * 1e3)
            device_call = post(f"{a.base}/metrics", None)["device_call_ms"]
        finally:
            a.stop()
        out[str(n)] = {"http_median": float(np.median(ms)), "http_min": float(min(ms)),
                       "http_max": float(max(ms)), "runs": len(ms), "utterance_s": 4.0,
                       "device_call_p50": device_call["p50"]}
    return out


def conv23_gflop(predictor, waves):
    """f32 operations of the blocks 2-3 convolutions (cuDNN) in one predict
    call: 2 * C_out * C_in * 5 * 5 per output pixel, SAME padding."""
    buf, nf, max_t = predictor.bucket(waves)
    with torch.inference_mode():
        n_win = predictor.windows(buf, nf, max_t)[0].shape[0]
    h, w, total = WIN // 2, N_MELS // 2, 0
    for i in (5, 10):
        co, ci, kh, kw = predictor.model.conv[i].weight.shape
        total += 2 * co * ci * kh * kw * h * w * n_win
        h, w = h // 2, w // 2
    return total / 1e9


def profile_rows(prof, reps):
    """(device rows, host rows) of a trace as (name, ms per rep, count per
    rep), largest first: device activities (kernels, copies) only, since an
    operator's own device time repeats its kernels', and no annotations."""
    rows, host = [], []
    for evt in prof.key_averages():
        # ranges such as "Optimizer.step#SGD.step" are annotations over the
        # device timeline, not activities: their time repeats the kernels'
        if getattr(evt, "is_user_annotation", False) or "#" in evt.key:
            continue
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", 0)
            if us > 0:
                rows.append((evt.key, us / 1e3 / reps, evt.count // reps))
        elif evt.self_cpu_time_total > 0:
            host.append((evt.key, evt.self_cpu_time_total / 1e3 / reps, evt.count // reps))
    rows.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])
    return rows, host


def profile_phase(predictor, rng, n=8, reps=3):
    """Device time by kernel over ``reps`` predict calls of ``n`` 4 s pcm16
    utterances, the device's busy share of the wall time, and the rate of
    the blocks 2-3 convolutions."""
    from torch.profiler import ProfilerActivity, profile

    waves = [(speechlike(rng, 4 * 16000) * 20000).astype(np.int16) for _ in range(n)]
    predictor.predict(waves)  # warm
    gflop = conv23_gflop(predictor, waves)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            predictor.predict(waves, seed=1)
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows, host = profile_rows(prof, reps)
    busy = sum(r[1] for r in rows)
    # cuDNN's forward convolution kernels (xmma_fprop / implicit_convolve)
    conv_ms = sum(r[1] for r in rows if re.search(r"fprop|convolve", r[0]))
    conv23 = {"gflop_per_call": gflop, "device_ms_per_call": conv_ms or "not measured"}
    if conv_ms:
        conv23["tflop_per_s"] = gflop / conv_ms
        conv23["share_of_f32_peak"] = gflop * 1e9 / (conv_ms * 1e-3) / PEAK_F32_FLOPS
    return {"utterances": n, "utterance_s": 4.0, "wall_ms_per_call": wall_ms,
            "device_busy_ms_per_call": busy if rows else "not measured",
            "device_idle_share": 1 - busy / wall_ms if rows else "not measured",
            "blocks23_conv": conv23,
            "top": [{"kernel": k[:90], "ms": ms, "launches": c} for k, ms, c in rows[:12]],
            "host_top": [{"op": k[:60], "self_cpu_ms": ms, "calls": c}
                         for k, ms, c in host[:10]]}


# ---------------------------------------------------------------------------
# the training slice


def kernel_counters():
    """Every kernel launch counter of the port, by kernel name: (wrapper,
    attribute).  Block 1's wrappers count each mode apart: its bf16 mode is
    the row <kernel>_bf16."""
    from sept_tpu_torch.ops import conv_block1 as K
    from sept_tpu_torch.ops import mel as M
    from sept_tpu_torch.ops import mfcc as MF

    counters = {"mel_db": (M.mel_db, "launches"), "mel_db_bf16": (M.mel_db_bf16, "launches"),
                "floor_dct": (MF.floor_dct, "launches")}
    for name in BLOCK1:
        counters[name] = (getattr(K, name), "launches")
        counters[f"{name}_bf16"] = (getattr(K, name), "launches_bf16")
    return counters


def drive(fn, must, must_not=()):
    """Run one main path with every launch count set to 0 just before and
    read just after: (result, launches, wall ms).  Each kernel in ``must``
    has to have launched, none in ``must_not``."""
    counters = kernel_counters()
    for f, attr in counters.values():
        setattr(f, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {name: getattr(f, attr) for name, (f, attr) in counters.items()}
    for name in must:
        require(launches[name] > 0, f"kernel {name} never launched on this path: {launches}")
    for name in must_not:
        require(launches[name] == 0, f"kernel {name} launched on this path: {launches}")
    return out, launches, ms


def train_ingest_phase(rng):
    """device_ingest of N_TRAIN seeded utterances of 2.5-6 s, N_SPK speakers."""
    from sept_tpu_torch.data.device_pipeline import device_ingest

    waves = [speechlike(rng, int(rng.uniform(2.5, 6.0) * 16000)) for _ in range(N_TRAIN)]
    spk = np.arange(N_TRAIN) % N_SPK
    le, lg = rng.integers(0, 4, N_TRAIN), spk % 2
    ds, launches, ms = drive(lambda: device_ingest(
        waves, spk, le, lg, n_fft=N_FFT, n_mels=N_MELS, win_len=WIN, shift_len=SHIFT,
        device=DEV), must=("mel_db",), must_not=("mel_db_bf16", "floor_dct") + BLOCK1_BF16)
    require(ds.windows.shape[1:] == (WIN, N_MELS) and ds.windows.device.type == DEV,
            "ingest shape or device")
    require(bool(torch.isfinite(ds.windows).all()), "non-finite training windows")
    n_real = int((ds.weight > 0).sum())
    require(n_real >= T_BATCH * T_BATCHES, f"only {n_real} real windows")
    return ds, launches, {"utterances": N_TRAIN, "speakers": N_SPK,
                          "windows": list(ds.windows.shape), "real_windows": n_real,
                          "wall_ms": ms}


def train_weights():
    """Seeded state_dicts of the emotion backbone (the serving weights) and a
    gender backbone."""
    from sept_tpu_torch.models import Conv2dBiRNN

    torch.manual_seed(SEED + 2)
    gender = Conv2dBiRNN(hidden_size=HIDDEN, feature_len=N_MELS, pred="gender")
    return build_weights()[0], gender.state_dict()


def backbone(sd, pred="emotion", dropout=0.2, cd=torch.float32, global_dim=0, group=None,
             att=None):
    from sept_tpu_torch.models import Conv2dBiRNN

    m = Conv2dBiRNN(hidden_size=HIDDEN, feature_len=N_MELS, pred=pred, dropout_rate=dropout,
                    compute_dtype=cd, global_dim=global_dim, bn_group=group, att=att)
    m.load_state_dict(sd)
    return m


def snapshot(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def unchanged(module, before):
    return all(torch.equal(v, before[k]) for k, v in module.state_dict().items())


def rz_rows_zero(module):
    return all(bool((p[:2 * HIDDEN] == 0).all()) for n, p in module.rnn.named_parameters()
               if n.startswith("bias_hh"))


def train_states(sds, device, dropout=0.2, lr=None, antithetic=True, dtype="float32",
                 saliency=0.0):
    """(name, state, step factory args) of the three workloads, presets
    baseline / cloak / cloak_grl with ``compute_dtype=dtype`` (and the GRL
    game's ``saliency_align``), on ``device``."""
    from sept_tpu_torch.models import CloakedModel, CloakedModelGRL, compute_dtype
    from sept_tpu_torch.train.config import preset
    from sept_tpu_torch.train.optim import make_cloak_optimizer, make_optimizer
    from sept_tpu_torch.train.steps import init_state

    emo_sd, gen_sd = sds
    over = {"compute_dtype": dtype, **({} if lr is None else {"learning_rate": lr})}
    cfg = preset("baseline", **over)
    cd = compute_dtype(cfg.compute_dtype)
    m = backbone(emo_sd, dropout=dropout, cd=cd)
    base = init_state(m, make_optimizer(cfg, T_BATCHES, m), SEED, device)
    cfg = preset("cloak", **over)
    m = CloakedModel(backbone(emo_sd, dropout=dropout, cd=cd), WIN, N_MELS,
                     cfg.noise_min_scale, cfg.noise_max_scale)
    cloak = init_state(m, make_cloak_optimizer(cfg, T_BATCHES, m, ("noise",)), SEED + 1, device)
    cloak_kw = {"scale_lambda": cfg.scale_lambda}
    cfg = preset("cloak_grl", antithetic_noise=antithetic, saliency_align=saliency, **over)
    m = CloakedModelGRL(backbone(emo_sd, dropout=dropout, cd=cd),
                        backbone(gen_sd, "gender", dropout=dropout, cd=cd), cfg.grl_lambda,
                        WIN, N_MELS, cfg.noise_min_scale, cfg.noise_max_scale)
    grl = init_state(m, make_cloak_optimizer(cfg, T_BATCHES, m, ("noise", "gender_backbone")),
                     SEED + 2, device)
    grl_kw = {"scale_lambda": cfg.scale_lambda, "gender_lambda": cfg.gender_lambda,
              "antithetic": cfg.antithetic_noise, "saliency_align": cfg.saliency_align}
    return base, (cloak, cloak_kw), (grl, grl_kw)


def train_phase(ds, sds):
    """One epoch of T_BATCHES batches of each workload through its epoch
    runner, full width; returns (per-path info, per-path launches, order)."""
    from sept_tpu_torch.train.steps import make_cloak_epoch_runner, make_epoch_runner

    valid = torch.nonzero(ds.weight > 0)[:, 0]
    g = torch.Generator(device=valid.device).manual_seed(SEED)
    order = valid[torch.randperm(len(valid), generator=g, device=valid.device)]
    order = order[:T_BATCH * T_BATCHES]
    base, (cloak, cloak_kw), (grl, grl_kw) = train_states(sds, DEV)
    kw = {"n_batches": T_BATCHES, "batch_size": T_BATCH}
    info, launches = {}, {}

    def summary(name, out, ms):
        _, losses, correct, counts = out
        losses = losses.cpu().numpy()
        require(np.isfinite(losses).all(), f"{name}: non-finite losses {losses}")
        require(int(counts.sum()) == T_BATCH * T_BATCHES, f"{name}: counts {counts}")
        info[name] = {"losses": losses.tolist(), "correct": int(correct.sum()),
                      "epoch_wall_ms": ms}

    out, launches["train_baseline"], ms = drive(
        lambda: make_epoch_runner()(base, ds.windows, ds.labels_emo, ds.weight, order, **kw),
        must=("block1_conv_stats", "block1_norm_pool", "block1_route",
              "block1_weight_grads"), must_not=("block1_input_grad",) + BLOCK1_BF16)
    summary("baseline", out, ms)
    require(rz_rows_zero(base.model), "baseline: bias_hh r/z rows moved")

    frozen = snapshot(cloak.model.backbone)
    locs = cloak.model.noise.locs.detach().clone()
    out, launches["train_cloak"], ms = drive(
        lambda: make_cloak_epoch_runner(**cloak_kw)(
            cloak, ds.windows, ds.labels_emo, ds.labels_gen, ds.weight, order, None, **kw),
        must=("block1_conv_stats", "block1_norm_pool", "block1_route", "block1_input_grad"),
        must_not=("block1_weight_grads",) + BLOCK1_BF16)
    summary("cloak", out, ms)
    require(unchanged(cloak.model.backbone, frozen), "cloak: the frozen backbone moved")
    require(not torch.equal(cloak.model.noise.locs, locs), "cloak: the noise did not train")

    frozen = snapshot(grl.model.emotion_backbone)
    gen_before = snapshot(grl.model.gender_backbone)
    out, launches["train_cloak_grl"], ms = drive(
        lambda: make_cloak_epoch_runner(grl=True, **grl_kw)(
            grl, ds.windows, ds.labels_emo, ds.labels_gen, ds.weight, order, None, **kw),
        must=BLOCK1, must_not=BLOCK1_BF16)
    summary("cloak_grl", out, ms)
    require(unchanged(grl.model.emotion_backbone, frozen), "grl: the emotion backbone moved")
    require(not unchanged(grl.model.gender_backbone, gen_before), "grl: the adversary is still")
    require(rz_rows_zero(grl.model.gender_backbone), "grl: bias_hh r/z rows moved")
    info["batch"], info["batches"] = T_BATCH, T_BATCHES
    return info, launches, order


def train_cpu_phase(ds, order, sds, dtype="float32", saliency=0.0, tol=TRAIN_F32_TOL):
    """Three steps of each step function on the card and on the CPU (plain
    versions) from the same weights on the same CPU_BATCH windows, dropout 0,
    one injected epsilon, ``compute_dtype=dtype``: losses within tol["loss"]
    relative, every parameter within tol["param"] and every running
    statistic within tol["stats"] of max(|p|, 1).  cuDNN's algorithm choice
    is pinned (deterministic, no autotuning) for this phase, so the GPU side
    gives the same numbers from run to run."""
    from sept_tpu_torch.train.steps import (make_baseline_step, make_cloak_grl_step,
                                            make_cloak_step)

    data = {k: v.cpu() for k, v in ds.batch(order[:3 * CPU_BATCH]).items()}
    eps = torch.from_numpy((0.1 * np.random.default_rng(SEED + 5).standard_normal(
        (1, WIN, N_MELS))).astype(np.float32))
    runs = {}
    cudnn = torch.backends.cudnn
    pinned = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        for dev in (DEV, "cpu"):
            base, (cloak, cloak_kw), (grl, grl_kw) = train_states(
                sds, dev, dropout=0.0, lr=1e-2, dtype=dtype, saliency=saliency)
            steps = {"baseline": (base, make_baseline_step(), False),
                     "cloak": (cloak, make_cloak_step(**cloak_kw), True),
                     "cloak_grl": (grl, make_cloak_grl_step(**grl_kw), True)}
            for name, (state, step, cloaked) in steps.items():
                losses = []
                for i in range(3):
                    batch = {k: v[i * CPU_BATCH:(i + 1) * CPU_BATCH].to(dev)
                             for k, v in data.items()}
                    args = {"eps": eps.to(dev)} if cloaked else {}
                    losses.append(float(step(state, batch, **args)[1]["loss"]))
                runs.setdefault(name, {})[dev] = (np.asarray(losses), snapshot(state.model))
    finally:
        cudnn.deterministic, cudnn.benchmark = pinned
    out = {name: hold_steps(f"train-cpu {dtype} {name}", r, tol) for name, r in runs.items()}
    out.update(batch=CPU_BATCH, steps=3, learning_rate=1e-2, tolerance=tol)
    return out


def state_diffs(got, want):
    """{"param", "stats"}: the largest |got - want| of max(|want|, 1) over
    the parameters and over the running statistics of two state_dicts."""
    return {part: max([float((got[k].cpu() - v.cpu()).abs().max())
                       / max(float(v.abs().max()), 1.0)
                       for k, v in want.items()
                       if v.is_floating_point() and ("running" in k) == (part == "stats")],
                      default=0.0)
            for part in ("param", "stats")}


def hold_steps(what, run, tol):
    """Hold the card's steps to the CPU's: ``run[device] = (losses,
    state_dict after the steps)``; losses within tol["loss"] relative, every
    parameter within tol["param"] and every running statistic within
    tol["stats"] of max(|p|, 1)."""
    (lg, sg), (lc, sc) = run[DEV], run["cpu"]
    loss_rel = float(np.max(np.abs(lg - lc) / np.abs(lc)))
    diffs = state_diffs(sg, sc)
    log(f"{what}: losses {lc.tolist()}, max rel loss diff {loss_rel:.3g}, max diff of "
        f"max(|p|, 1): {diffs}")
    require(loss_rel <= tol["loss"] and all(d <= tol[k] for k, d in diffs.items()),
            f"{what}: the card and the CPU disagree ({loss_rel}, {diffs})")
    return {"losses_cpu": lc.tolist(), "max_rel_loss_diff": loss_rel,
            "max_param_diff_of_max_abs": diffs["param"],
            "max_running_stat_diff_of_max_abs": diffs["stats"]}


def capture_block1(ds, order, sds, dtype="float32"):
    """Block 1's inputs, parameters, moments and pooled cotangent in one
    baseline step on the first T_BATCH windows of ``order``, and its mode."""
    import sept_tpu_torch.models.backbone as BB
    from sept_tpu_torch.train.steps import make_baseline_step

    base, _, _ = train_states(sds, DEV, dtype=dtype)
    cap, orig = {}, BB.block1_train_forward

    def spy(x, w, b, gamma, beta, eps, cd=torch.float32, group=None):
        pooled, mean, var = orig(x, w, b, gamma, beta, eps, cd, group)
        cap.update({k: t.detach().clone() for k, t in
                    dict(x=x, w=w, b=b, gamma=gamma, beta=beta, mean=mean, var=var).items()})
        cap["eps"], cap["cd"] = eps, cd
        pooled.register_hook(lambda g: cap.update(d_pooled=g.detach().contiguous()))
        return pooled, mean, var

    BB.block1_train_forward = spy
    try:
        make_baseline_step()(base, ds.batch(order[:T_BATCH]))
    finally:
        BB.block1_train_forward = orig
    torch.cuda.synchronize()
    return cap


def backward_inputs(cap):
    """conv_out (K1) and the per-channel vectors the backward derives."""
    from sept_tpu_torch.ops import conv_block1 as K

    conv_out, _ = K.block1_conv_stats(cap["x"], cap["w"], cap["b"], cap["cd"])
    ga, shift = K.fold_bn(cap["gamma"], cap["beta"], cap["mean"], cap["var"], cap["eps"])
    inv = torch.rsqrt(cap["var"] + cap["eps"])
    return conv_out, ga, shift, inv


def check_backward(x, w, conv_out, dp, ga, shift, mean, inv, cd=torch.float32):
    """K3-K5 on these tensors against their plain versions: (relative
    errors, absolute errors, the plain train-mode (dy, m1, m2)).  dy must be
    equal and the K3 sums within SUMS_RTOL of the sums of |terms|.  K4 and
    K5 run in both modes: train (m1 = mean dy, m2 = mean dy * xhat) and eval
    (m1 = m2 = 0, the frozen backbone's).  dW, and dx, within TRAIN_TOL of
    max |plain| in both; db within TRAIN_TOL of max |plain| in eval mode.  In
    train mode db is 0 in exact arithmetic (the bias sits ahead of
    batch-stat BN), so there both sides are held to that zero within
    B * H * W * 2^-24 * max |dconv|, one f32 rounding unit a term.  ``cd``
    is the kernels' mode (conv_out, dp and dy in it): the same bounds hold in
    bf16, whose kernels compute dconv in the plain version's order and round
    it alike."""
    from sept_tpu_torch.ops import conv_block1 as K

    dy_k, s_k = K.block1_route(conv_out, dp, ga, shift, mean, inv, cd)
    dy_p, s_p = K.block1_route_plain(conv_out, dp, ga, shift, mean, inv, cd)
    xhat = (conv_out.float() - mean[None, :, None, None]) * inv[None, :, None, None]
    dy_f = dy_p.float()
    scale = torch.stack([dy_f.abs().sum((0, 2, 3)), (dy_f * xhat).abs().sum((0, 2, 3))])
    n = conv_out.shape[0] * conv_out.shape[2] * conv_out.shape[3]
    m1, m2 = s_p[0] / n, s_p[1] / n
    rel = lambda a, b: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)  # noqa: E731
    err = {"block1_route": float((dy_k.float() - dy_f).abs().max()),
           "block1_route_sums_rel": float(((s_k - s_p).abs() / scale.clamp(min=1e-30)).max()),
           "block1_weight_grads": 0.0, "block1_input_grad": 0.0}
    abs_err = {"block1_route": err["block1_route"], "block1_weight_grads": 0.0,
               "block1_input_grad": 0.0}
    zero = torch.zeros_like(m1)
    for mode, a1, a2 in (("train", m1, m2), ("eval", zero, zero)):
        dw_k, db_k = K.block1_weight_grads(x, conv_out, dy_p, ga, mean, inv, a1, a2, cd)
        dw_p, db_p = K.block1_weight_grads_plain(x, conv_out, dy_p, ga, mean, inv, a1, a2, cd)
        dx_k = K.block1_input_grad(conv_out, dy_p, w, ga, mean, inv, a1, a2, cd)
        dx_p = K.block1_input_grad_plain(conv_out, dy_p, w, ga, mean, inv, a1, a2, cd)
        err["block1_weight_grads"] = max(err["block1_weight_grads"], rel(dw_k, dw_p))
        err["block1_input_grad"] = max(err["block1_input_grad"], rel(dx_k, dx_p))
        abs_err["block1_weight_grads"] = max(abs_err["block1_weight_grads"],
                                             float((dw_k - dw_p).abs().max()))
        abs_err["block1_input_grad"] = max(abs_err["block1_input_grad"],
                                           float((dx_k - dx_p).abs().max()))
        if mode == "eval":
            err["block1_weight_grads"] = max(err["block1_weight_grads"], rel(db_k, db_p))
            abs_err["block1_weight_grads"] = max(abs_err["block1_weight_grads"],
                                                 float((db_k - db_p).abs().max()))
        else:
            dconv = K._dconv(conv_out, dy_p, ga, mean, inv, a1, a2)
            zero_bound = n * 2.0 ** -24 * float(dconv.abs().max())
            err["train_db_of_zero_bound"] = max(float(db_k.abs().max()),
                                                float(db_p.abs().max())) / zero_bound
    torch.cuda.synchronize()
    require(err["block1_route_sums_rel"] <= SUMS_RTOL, f"K3 sums disagree: {err}")
    require(err["train_db_of_zero_bound"] <= 1.0, f"train-mode db is not 0: {err}")
    for name, tol in TRAIN_TOL.items():
        require(err[name] <= tol, f"{name} disagrees with its plain version: {err}")
    return err, abs_err, (dy_p, m1, m2)


def k4_chain(x, conv_out, dy, ga, mean, inv, m1, m2, w_shape, cd=torch.float32):
    """K4's like-for-like library yardstick: the library calls that compute
    its whole function from the same inputs, dconv (``_dconv``), cuDNN's
    wgrad on x and dconv rounded to ``cd``, and db = dconv.sum."""
    from sept_tpu_torch.ops import conv_block1 as K

    def chain():
        dconv = K._dconv(conv_out, dy, ga, mean, inv, m1, m2)
        return (torch.nn.grad.conv2d_weight(x.to(cd), w_shape, dconv.to(cd), padding=2),
                dconv.sum((0, 2, 3)))

    return {"library_chain": "_dconv + torch.nn.grad.conv2d_weight + dconv.sum",
            "library_chain_ms": cuda_ms(chain), "library_chain_device_ms": device_ms(chain)}


def train_kernel_phase(cap, launches):
    """K3-K5 against their plain versions on the baseline step's own block-1
    tensors, then timed beside the plain version, one PyTorch call and the
    bound; and block 1's forward + backward against autograd through the
    cuDNN chain."""
    import torch.nn.functional as tf

    from sept_tpu_torch.ops import conv_block1 as K

    x, w = cap["x"], cap["w"]
    mean, dp = cap["mean"], cap["d_pooled"]
    conv_out, ga, shift, inv = backward_inputs(cap)
    err, abs_err, (dy, m1, m2) = check_backward(x, w, conv_out, dp, ga, shift, mean, inv)
    log(f"K3-K5 on the baseline step's tensors: {err}")
    dconv = K._dconv(conv_out, dy, ga, mean, inv, m1, m2)
    z = torch.relu(conv_out * ga[None, :, None, None] + shift[None, :, None, None])
    _, idx = tf.max_pool2d(z, 2, 2, return_indices=True)
    b, c, h, wd = conv_out.shape
    outs, pix = b * c * h * wd, b * h * wd
    # least work: K3 reads y and the pooled cotangent, writes dy (affine,
    # max, mask, xhat and two sums an element); K4 reads x, y, dy (dconv and
    # 25 taps + bias an element); K5 reads y, dy, writes dx
    rows = [
        ("block1_route", "sept_tpu/ops/pallas_conv.py:166",
         lambda: K.block1_route(conv_out, dp, ga, shift, mean, inv),
         lambda: K.block1_route_plain(conv_out, dp, ga, shift, mean, inv),
         lambda: torch.ops.aten.max_pool2d_with_indices_backward(
             dp, z, [2, 2], [2, 2], [0, 0], [1, 1], False, idx),
         bound(9.0 * outs, 4.0 * (2 * outs + outs // 4 + 4 * c + 2 * c))),
        ("block1_weight_grads", "sept_tpu/ops/pallas_conv.py:231",
         lambda: K.block1_weight_grads(x, conv_out, dy, ga, mean, inv, m1, m2),
         lambda: K.block1_weight_grads_plain(x, conv_out, dy, ga, mean, inv, m1, m2),
         lambda: torch.nn.grad.conv2d_weight(x, tuple(w.shape), dconv, padding=2),
         bound(outs * (5 + 2 * 25 + 1), 4.0 * (pix + 2 * outs + 5 * c + 26 * c))),
        ("block1_input_grad", "sept_tpu/ops/pallas_conv.py:269",
         lambda: K.block1_input_grad(conv_out, dy, w, ga, mean, inv, m1, m2),
         lambda: K.block1_input_grad_plain(conv_out, dy, w, ga, mean, inv, m1, m2),
         lambda: torch.nn.grad.conv2d_input(tuple(x.shape), w, dconv, padding=2),
         bound(outs * (5 + 2 * 25), 4.0 * (2 * outs + 25 * c + 5 * c + pix))),
    ]
    kernels = []
    for name, replaces, kern, plain, lib, (bound_ms, bound_by) in rows:
        kernels.append({
            "name": name, "route": "cuda", "source": "sept_tpu_torch/csrc/conv_block1.cu",
            "replaces": replaces, "launches": sum(p[name] for p in launches.values()),
            "launches_by_path": {k: p[name] for k, p in launches.items()},
            "max_abs_err": abs_err[name], "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": cuda_ms(lib),
            "device_ms": device_ms(kern), "library_device_ms": device_ms(lib)})
    kernels[0]["library"] = "max_pool2d_with_indices_backward (no ReLU mask, no sums)"
    kernels[0]["sums_max_rel_err_of_abs_sum"] = err["block1_route_sums_rel"]
    kernels[1]["library"] = "torch.nn.grad.conv2d_weight (cuDNN wgrad, dconv given)"
    kernels[1]["max_rel_err_of_max_abs"] = err["block1_weight_grads"]
    kernels[1].update(k4_chain(x, conv_out, dy, ga, mean, inv, m1, m2, tuple(w.shape)))
    kernels[2]["library"] = "torch.nn.grad.conv2d_input (cuDNN dgrad, dconv given)"
    kernels[2]["max_rel_err_of_max_abs"] = err["block1_input_grad"]

    leaves = [cap[k].clone().requires_grad_() for k in ("x", "w", "b", "gamma", "beta")]
    eps = cap["eps"]

    def kernels_fb():
        pooled = K.Block1Train.apply(*leaves, eps)[0]
        return torch.autograd.grad(pooled, leaves, dp)

    def cudnn_fb():
        y = tf.conv2d(leaves[0], leaves[1], leaves[2], padding=2)
        y = tf.batch_norm(y, None, None, leaves[3], leaves[4], training=True, eps=eps)
        return torch.autograd.grad(tf.max_pool2d(torch.relu(y), 2), leaves, dp)

    diffs = {n: float((a - r).abs().max()) for n, a, r in
             zip(("dx", "dW", "db", "dgamma", "dbeta"), kernels_fb(), cudnn_fb())}
    block1_train = {"shape": list(x.shape), "kernels_fwd_bwd_ms": cuda_ms(kernels_fb),
                    "cudnn_chain_fwd_bwd_ms": cuda_ms(cudnn_fb),
                    "cudnn_chain_max_abs_diff": diffs,
                    "note": "db is 0 in exact arithmetic (bias ahead of batch-stat BN)"}
    return kernels, block1_train


def train_edge_phase(device):
    """K3-K5 against their plain versions at odd and ragged shapes."""
    from sept_tpu_torch.ops import conv_block1 as K

    g = torch.Generator(device=device).manual_seed(SEED + 9)
    worst = {}
    for b, h, w in K4_EDGES + (WIDE_EDGE,):
        x = torch.randn(b, 1, h, w, device=device, generator=g)
        wt = 0.2 * torch.randn(32, 1, 5, 5, device=device, generator=g)
        y, sums = K.block1_conv_stats_plain(x, wt, 0.1 * torch.randn(32, device=device,
                                                                      generator=g))
        n = b * h * w
        mean = sums[0] / n
        var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
        gamma = 1 + 0.1 * torch.randn(32, device=device, generator=g)
        beta = 0.1 * torch.randn(32, device=device, generator=g)
        ga, shift = K.fold_bn(gamma, beta, mean, var)
        dp = torch.randn(b, 32, h // 2, w // 2, device=device, generator=g)
        inv = torch.rsqrt(var + K.EPS)
        err, _, (dy, m1, m2) = check_backward(x, wt, y, dp, ga, shift, mean, inv)
        # dW of the kernel and of cuDNN's f32 wgrad (the library yardstick)
        # against the plain version in float64
        f64 = [t.double() for t in (x, y, dy, ga, mean, inv, m1, m2)]
        ref = K.block1_weight_grads_plain(*f64)[0]
        dconv = K._dconv(y, dy, ga, mean, inv, m1, m2)
        for key, got in (
                ("kernel_wgrad_rel_err_f64",
                 K.block1_weight_grads(x, y, dy, ga, mean, inv, m1, m2)[0]),
                ("library_wgrad_rel_err_f64",
                 torch.nn.grad.conv2d_weight(x, tuple(wt.shape), dconv, padding=2))):
            err[key] = float((got.double() - ref).abs().max() / ref.abs().max())
        for k, v in err.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def train_profile_phase(ds, order, sds, reps=3, dtype="float32", saliency=0.0):
    """torch.profiler over ``reps`` baseline steps and ``reps`` cloak + GRL
    steps (antithetic, ``saliency_align=saliency``) after a warm step of
    each, batch T_BATCH, ``compute_dtype=dtype``."""
    from torch.profiler import ProfilerActivity, profile

    from sept_tpu_torch.train.steps import make_baseline_step, make_cloak_grl_step

    base, _, (grl, grl_kw) = train_states(sds, DEV, dtype=dtype, saliency=saliency)
    batches = [ds.batch(order[i * T_BATCH:(i + 1) * T_BATCH]) for i in range(reps + 1)]
    out = {}
    for name, state, step in (("baseline", base, make_baseline_step()),
                              ("cloak_grl", grl, make_cloak_grl_step(**grl_kw))):
        step(state, batches[0])  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches[1:]:
                step(state, b)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        rows, host = profile_rows(prof, reps)
        busy = sum(r[1] for r in rows)
        out[name] = {
            "batch": T_BATCH, "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy if rows else "not measured",
            "device_idle_share": 1 - busy / wall_ms if rows else "not measured",
            "device_launches_per_step": sum(c for _, _, c in rows) if rows else "not measured",
            "top": [{"kernel": k[:90], "ms": ms, "launches": c} for k, ms, c in rows[:14]],
            "host_top": [{"op": k[:60], "self_cpu_ms": ms, "calls": c}
                         for k, ms, c in host[:10]]}
    return out


# ---------------------------------------------------------------------------
# the bf16 training slice


def bf16_order(ds):
    """The T_BATCH * T_BATCHES real windows of the bf16 ingest in the order
    its f32 baseline epoch (ingest_bf16_phase) took them."""
    valid = torch.nonzero(ds.weight > 0)[:, 0]
    g = torch.Generator(device=valid.device).manual_seed(SEED + 12)
    order = valid[torch.randperm(len(valid), generator=g, device=valid.device)]
    return order[:T_BATCH * T_BATCHES]


def train_bf16_phase(ds, order, sds):
    """One epoch of T_BATCHES batches of T_BATCH of each workload with
    ``compute_dtype="bfloat16"`` on the bf16 ingest's windows, full width:
    baseline (K1-K4 in bf16, no K5), plain cloak (K1-K3 and K5, no K4), cloak
    + GRL with the antithetic pair and the saliency term (all five); no
    block-1 launch in the f32 mode.  Returns (per-path info, launches)."""
    from sept_tpu_torch.train.steps import make_cloak_epoch_runner, make_epoch_runner

    base, (cloak, cloak_kw), (grl, grl_kw) = train_states(sds, DEV, dtype="bfloat16",
                                                          saliency=SALIENCY_ALIGN)
    kw = {"n_batches": T_BATCHES, "batch_size": T_BATCH}
    data = (ds.windows, ds.labels_emo, ds.labels_gen, ds.weight, order, None)
    runs = {
        "baseline": (base, lambda: make_epoch_runner()(
            base, ds.windows, ds.labels_emo, ds.weight, order, **kw),
            ("block1_input_grad_bf16",)),
        "cloak": (cloak, lambda: make_cloak_epoch_runner(**cloak_kw)(cloak, *data, **kw),
                  ("block1_weight_grads_bf16",)),
        "cloak_grl": (grl, lambda: make_cloak_epoch_runner(grl=True, **grl_kw)(grl, *data, **kw),
                      ()),
    }
    frozen = {"cloak": cloak.model.backbone, "cloak_grl": grl.model.emotion_backbone}
    info, launches = {}, {}
    for name, (state, run, absent) in runs.items():
        before = snapshot(state.model)
        key = f"train_bf16_{name}"
        out, launches[key], ms = drive(
            run, must=tuple(k for k in BLOCK1_BF16 if k not in absent), must_not=absent + BLOCK1)
        _, losses, correct, counts = out
        losses = losses.cpu().numpy()
        require(np.isfinite(losses).all(), f"bf16 {name}: non-finite losses {losses}")
        require(int(counts.sum()) == T_BATCH * T_BATCHES, f"bf16 {name}: counts {counts}")
        after = state.model.state_dict()
        require(all(v.dtype == torch.float32 for k, v in after.items()
                    if not k.endswith("num_batches_tracked")),
                f"bf16 {name}: a parameter or statistic left float32")
        moved = [k for k, v in after.items() if not torch.equal(v, before[k])]
        require(moved, f"bf16 {name}: nothing trained")
        if name in frozen:
            require(unchanged(frozen[name], {k.split(".", 1)[1]: v for k, v in before.items()
                                             if k.startswith(("backbone.", "emotion_backbone."))}),
                    f"bf16 {name}: the frozen backbone moved")
            require(any(k.startswith("noise.") for k in moved), f"bf16 {name}: noise still")
        if name == "cloak_grl":
            require(any(k.startswith("gender_backbone.") for k in moved),
                    "bf16 GRL: the adversary is still")
        info[name] = {"losses": losses.tolist(), "correct": int(correct.sum()),
                      "epoch_wall_ms": ms, "wall_ms_per_step": ms / T_BATCHES,
                      "block1_launches_per_step": {k: v / T_BATCHES
                                                   for k, v in launches[key].items() if v}}
    require(rz_rows_zero(base.model) and rz_rows_zero(grl.model.gender_backbone),
            "bf16: bias_hh r/z rows moved")
    info.update(batch=T_BATCH, batches=T_BATCHES, saliency_align=SALIENCY_ALIGN,
                windows=list(ds.windows.shape))
    return info, launches


def bf16_conv_errors(y_k, y_p):
    """(max |kernel - plain|, max over elements of |kernel - plain| / (one
    bf16 unit of the larger + 1e-6), bit-equal share) of two bf16 tensors."""
    a, b = y_k.float(), y_p.float()
    d = (a - b).abs()
    units = d / (2.0 ** -7 * torch.maximum(a.abs(), b.abs()) + 1e-6)
    return float(d.max()), float(units.max()), float((d == 0).float().mean())


def check_bf16_forward(x, w, b, gamma, beta, eps):
    """K1 and K2 in bf16 against their plain versions: the conv output
    within one bf16 unit and bit-equal in BF16_CONV_EQUAL_SHARE of the
    elements, the moments within SUMS_RTOL of the sums of |terms|, pooled
    equal (on the plain conv output).  Returns (errors, conv output, the
    batch's BN pair, mean, inv)."""
    from sept_tpu_torch.ops import conv_block1 as K

    bf = torch.bfloat16
    y_k, s_k = K.block1_conv_stats(x, w, b, bf)
    y_p, s_p = K.block1_conv_stats_plain(x, w, b, bf)
    conv_abs, conv_units, share = bf16_conv_errors(y_k, y_p)
    yp = y_p.float()
    terms = torch.stack([yp.abs().sum((0, 2, 3)), (yp * yp).sum((0, 2, 3))])
    n = y_p.shape[0] * y_p.shape[2] * y_p.shape[3]
    mean = s_p[0] / n
    var = torch.clamp(s_p[1] / n - mean * mean, min=0.0)
    ga, shift = K.fold_bn(gamma, beta, mean, var, eps)
    pool = float((K.block1_norm_pool(y_p, ga, shift, bf).float()
                  - K.block1_norm_pool_plain(y_p, ga, shift, bf).float()).abs().max())
    err = {"block1_conv_stats_bf16": conv_abs, "conv_bf16_units": conv_units,
           "conv_bf16_equal_share": share,
           "moments_bf16_rel_of_abs_sum": float(((s_k - s_p).abs() / terms.clamp(min=1e-30)).max()),
           "block1_norm_pool_bf16": pool}
    torch.cuda.synchronize()
    require(conv_units <= 1.0 and share >= BF16_CONV_EQUAL_SHARE,
            f"block1_conv_stats bf16 disagrees with its plain version: {err}")
    require(err["moments_bf16_rel_of_abs_sum"] <= SUMS_RTOL, f"bf16 moments disagree: {err}")
    require(pool == 0.0, f"block1_norm_pool bf16 disagrees with its plain version: {err}")
    return err, y_p, (ga, shift), mean, torch.rsqrt(var + eps)


def train_bf16_kernel_phase(cap, launches):
    """Each bf16 kernel mode against its plain version on a bf16 baseline
    step's own block-1 tensors (batch T_BATCH, the moments recomputed from
    the plain conv output), then timed beside the plain version, one bf16
    PyTorch call and the bound (bf16 operands: the bf16 peak; stored tensors
    2 bytes an element); and block 1's bf16 forward + backward beside
    autograd through the cuDNN bf16 chain."""
    import torch.nn.functional as tf

    from sept_tpu_torch.ops import conv_block1 as K

    bf = torch.bfloat16
    x, w, b, gamma, beta, eps = (cap[k] for k in ("x", "w", "b", "gamma", "beta", "eps"))
    dp = cap["d_pooled"]
    require(cap["cd"] == bf and dp.dtype == bf, "the bf16 step did not run block 1 in bf16")
    fwd_err, y, (ga, shift), mean, inv = check_bf16_forward(x, w, b, gamma, beta, eps)
    err, abs_err, (dy, m1, m2) = check_backward(x, w, y, dp, ga, shift, mean, inv, bf)
    log(f"bf16 K1-K5 on the bf16 baseline step's tensors: {fwd_err} {err}")
    dconv = K._dconv(y, dy, ga, mean, inv, m1, m2).to(bf)
    z = torch.relu(y.float() * ga[None, :, None, None] + shift[None, :, None, None]).to(bf)
    _, idx = tf.max_pool2d(z, 2, 2, return_indices=True)
    xb, wb = x.to(bf), w.to(bf)
    n, c, h, wd = y.shape
    outs, pix = n * c * h * wd, n * h * wd
    rows = [
        ("block1_conv_stats_bf16", "sept_tpu/ops/pallas_conv.py:120",
         lambda: K.block1_conv_stats(x, w, b, bf),
         lambda: K.block1_conv_stats_plain(x, w, b, bf),
         lambda: tf.conv2d(xb, wb, b.to(bf), padding=2), "F.conv2d bf16 (cuDNN, no moments)",
         bound(outs * (2 * 25 + 1 + 3), 4.0 * (pix + 28 * c) + 2.0 * outs, PEAK_BF16_FLOPS),
         fwd_err["block1_conv_stats_bf16"]),
        ("block1_norm_pool_bf16", "sept_tpu/ops/pallas_conv.py:155",
         lambda: K.block1_norm_pool(y, ga, shift, bf),
         lambda: K.block1_norm_pool_plain(y, ga, shift, bf), None, None,
         bound(3.0 * outs, 2.0 * (outs + outs // 4) + 8.0 * c, PEAK_BF16_FLOPS),
         fwd_err["block1_norm_pool_bf16"]),
        ("block1_route_bf16", "sept_tpu/ops/pallas_conv.py:166",
         lambda: K.block1_route(y, dp, ga, shift, mean, inv, bf),
         lambda: K.block1_route_plain(y, dp, ga, shift, mean, inv, bf),
         lambda: torch.ops.aten.max_pool2d_with_indices_backward(
             dp, z, [2, 2], [2, 2], [0, 0], [1, 1], False, idx),
         "max_pool2d_with_indices_backward bf16 (no ReLU mask, no sums)",
         bound(9.0 * outs, 2.0 * (2 * outs + outs // 4) + 24.0 * c, PEAK_BF16_FLOPS),
         abs_err["block1_route"]),
        ("block1_weight_grads_bf16", "sept_tpu/ops/pallas_conv.py:231",
         lambda: K.block1_weight_grads(x, y, dy, ga, mean, inv, m1, m2, bf),
         lambda: K.block1_weight_grads_plain(x, y, dy, ga, mean, inv, m1, m2, bf),
         lambda: torch.nn.grad.conv2d_weight(xb, tuple(w.shape), dconv, padding=2),
         "torch.nn.grad.conv2d_weight bf16 (cuDNN wgrad, dconv given)",
         bound(outs * (5 + 2 * 25 + 1), 4.0 * (pix + 31 * c) + 4.0 * outs, PEAK_BF16_FLOPS),
         abs_err["block1_weight_grads"]),
        ("block1_input_grad_bf16", "sept_tpu/ops/pallas_conv.py:269",
         lambda: K.block1_input_grad(y, dy, w, ga, mean, inv, m1, m2, bf),
         lambda: K.block1_input_grad_plain(y, dy, w, ga, mean, inv, m1, m2, bf),
         lambda: torch.nn.grad.conv2d_input(tuple(x.shape), wb, dconv, padding=2),
         "torch.nn.grad.conv2d_input bf16 (cuDNN dgrad, dconv given)",
         bound(outs * (5 + 2 * 25), 4.0 * (30 * c + pix) + 4.0 * outs, PEAK_BF16_FLOPS),
         abs_err["block1_input_grad"]),
    ]
    # the f32 mode on the same values, widened: the modes compared in one call
    yf, dpf, dyf = y.float(), dp.float(), dy.float()
    f32_mode = [lambda: K.block1_conv_stats(x, w, b),
                lambda: K.block1_norm_pool(yf, ga, shift),
                lambda: K.block1_route(yf, dpf, ga, shift, mean, inv),
                lambda: K.block1_weight_grads(x, yf, dyf, ga, mean, inv, m1, m2),
                lambda: K.block1_input_grad(yf, dyf, w, ga, mean, inv, m1, m2)]
    kernels = []
    for (name, replaces, kern, plain, lib, lib_name, (bound_ms, bound_by), e), f32 in zip(
            rows, f32_mode):
        kernels.append({
            "name": name, "route": "cuda", "source": "sept_tpu_torch/csrc/conv_block1.cu",
            "replaces": f"{replaces} (cdtype bfloat16)", "f32_mode_ms_same_shape": cuda_ms(f32),
            "launches": sum(p[name] for p in launches.values()),
            "launches_by_path": {k: p[name] for k, p in launches.items() if p[name]},
            "max_abs_err": e, "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None if lib is None else cuda_ms(lib), "shape": list(y.shape),
            "device_ms": device_ms(kern), "f32_mode_device_ms_same_shape": device_ms(f32),
            "library_device_ms": None if lib is None else device_ms(lib)})
        if lib_name:
            kernels[-1]["library"] = lib_name
    kernels[0].update(max_bf16_units=fwd_err["conv_bf16_units"],
                      equal_share=fwd_err["conv_bf16_equal_share"],
                      moments_max_rel_err_of_abs_sum=fwd_err["moments_bf16_rel_of_abs_sum"])
    kernels[1]["library_note"] = ("null: no single PyTorch call computes BN affine + ReLU + "
                                  "first-max 2x2 pool")
    kernels[2]["sums_max_rel_err_of_abs_sum"] = err["block1_route_sums_rel"]
    kernels[3]["max_rel_err_of_max_abs"] = err["block1_weight_grads"]
    kernels[3].update(k4_chain(x, y, dy, ga, mean, inv, m1, m2, tuple(w.shape), bf))
    kernels[4]["max_rel_err_of_max_abs"] = err["block1_input_grad"]

    leaves = [t.clone().requires_grad_() for t in (x, w, b, gamma, beta)]

    def kernels_fb():
        pooled = K.Block1Train.apply(*leaves, eps, bf)[0]
        return torch.autograd.grad(pooled, leaves, dp)

    def cudnn_fb():
        y = tf.conv2d(leaves[0].to(bf), leaves[1].to(bf), leaves[2].to(bf), padding=2)
        y = tf.batch_norm(y.float(), None, None, leaves[3], leaves[4], training=True, eps=eps)
        return torch.autograd.grad(tf.max_pool2d(torch.relu(y).to(bf), 2), leaves, dp)

    diffs = {k: float((a - r).abs().max()) for k, a, r in
             zip(("dx", "dW", "db", "dgamma", "dbeta"), kernels_fb(), cudnn_fb())}
    block1 = {"shape": list(x.shape), "kernels_fwd_bwd_ms": cuda_ms(kernels_fb),
              "cudnn_bf16_chain_fwd_bwd_ms": cuda_ms(cudnn_fb),
              "cudnn_bf16_chain_max_abs_diff": diffs,
              "note": "the cuDNN chain rounds the conv output but not z before the pool"}
    return kernels, block1


def train_bf16_edge_phase(device):
    """The bf16 modes of K1-K5 against their plain versions at odd and
    ragged shapes."""
    g = torch.Generator(device=device).manual_seed(SEED + 18)
    worst = {}
    for b, h, w in K4_EDGES + (WIDE_EDGE,):
        x = torch.randn(b, 1, h, w, device=device, generator=g)
        wt = 0.2 * torch.randn(32, 1, 5, 5, device=device, generator=g)
        bias = 0.1 * torch.randn(32, device=device, generator=g)
        gamma = 1 + 0.1 * torch.randn(32, device=device, generator=g)
        beta = 0.1 * torch.randn(32, device=device, generator=g)
        fwd, y, (ga, shift), mean, inv = check_bf16_forward(x, wt, bias, gamma, beta, 1e-5)
        dp = torch.randn(b, 32, h // 2, w // 2, device=device, generator=g).to(torch.bfloat16)
        err, _, _ = check_backward(x, wt, y, dp, ga, shift, mean, inv, torch.bfloat16)
        for k, v in {**fwd, **{f"{k}_bf16": v for k, v in err.items()}}.items():
            worst[k] = min(worst.get(k, 1.0), v) if k.endswith("share") else max(
                worst.get(k, 0.0), v)
    return worst


def device_launches(fn):
    """Device activities (kernels, copies) of one run of ``fn``, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows, _ = profile_rows(prof, 1)
    return sum(c for _, _, c in rows) if rows else "not measured"


def gru_phase(sd):
    """Layer 0 of the bf16 BiGRU as the port runs it (bigru_layer_lowp: one
    matmul for the input projections, then a loop over the WIN // 8 steps)
    beside cuDNN's bf16 GRU on the same bf16 weights and input, a yardstick
    that keeps a bf16 hidden state where flax keeps an f32 one: max
    |difference| of the outputs, forward and forward + backward ms (batch
    T_BATCH), and device launches of one forward + backward."""
    from sept_tpu_torch.models.backbone import bigru_layer_lowp

    bf = torch.bfloat16
    rnn = backbone(sd).to(DEV).rnn
    ws = [getattr(rnn, f"{k}_l0{sfx}").detach() for sfx in ("", "_reverse")
          for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    # cuDNN's bf16 GRU on the same weights, held in one flat buffer as
    # nn.GRU keeps them (else cuDNN compacts them at every call)
    gru = torch.nn.GRU(rnn.input_size, rnn.hidden_size, batch_first=True,
                       bidirectional=True).to(DEV)
    gru.load_state_dict({f"{k}_l0{sfx}": getattr(rnn, f"{k}_l0{sfx}") for sfx in ("", "_reverse")
                         for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")})
    gru = gru.to(bf)
    gru.flatten_parameters()
    g = torch.Generator(device=DEV).manual_seed(SEED + 17)
    x = torch.randn(T_BATCH, WIN // 8, rnn.input_size, device=DEV, generator=g)
    xr = x.clone().requires_grad_()
    xb = x.to(bf).requires_grad_()

    def lowp_fb():
        return torch.autograd.grad(bigru_layer_lowp(xr, ws, bf).sum(), xr)

    def cudnn_fb():
        return torch.autograd.grad(gru(xb)[0].float().sum(), xb)

    with torch.no_grad():
        lowp = bigru_layer_lowp(x, ws, bf)
        out = {"shape": list(x.shape), "hidden": rnn.hidden_size,
               "cudnn_bf16_max_abs_diff": float((gru(x.to(bf))[0].float() - lowp).abs().max()),
               "lowp_fwd_ms": cuda_ms(lambda: bigru_layer_lowp(x, ws, bf)),
               "cudnn_bf16_fwd_ms": cuda_ms(lambda: gru(x.to(bf)))}
    out.update(lowp_fwd_bwd_ms=cuda_ms(lowp_fb), cudnn_bf16_fwd_bwd_ms=cuda_ms(cudnn_fb),
               lowp_fwd_bwd_device_launches=device_launches(lowp_fb),
               cudnn_bf16_fwd_bwd_device_launches=device_launches(cudnn_fb))
    return out


def path_profile(fn, top=10):
    """torch.profiler over one warm run of ``fn``: wall ms, device busy ms and
    idle share, the device's largest rows and the host's."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, host = profile_rows(prof, 1)
    busy = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy if rows else "not measured",
            "device_idle_share": 1 - busy / wall_ms if rows else "not measured",
            "top": [{"kernel": k[:90], "ms": ms, "launches": c} for k, ms, c in rows[:top]],
            "host_top": [{"op": k[:60], "self_cpu_ms": ms, "calls": c}
                         for k, ms, c in host[:top]]}


# ---------------------------------------------------------------------------
# one fold of the utility-privacy protocol


def fold_data(rng):
    """A seeded full-width FoldData: windows of noise with an emotion band
    and a gender band (so the models have something to learn), speakers of
    uneven size (so combine mode's speaker weights differ from 1), half of
    them in each corpus."""
    from sept_tpu_torch.data.pipeline import FoldData, SplitArrays

    p_spk = 0.7 ** np.arange(FOLD_SPK)
    p_spk /= p_spk.sum()

    def split(n, test=False):
        spk = rng.choice(FOLD_SPK, n, p=p_spk)
        le, lg = rng.integers(0, 4, n), spk % 2
        lengths = (rng.integers(FOLD_FRAMES[0], FOLD_FRAMES[1] + 1, n) if test
                   else np.full(n, WIN))
        t = int(lengths.max())
        w = rng.standard_normal((n, t, N_MELS)).astype(np.float32)
        for i in range(n):
            w[i, :, 8 * le[i]:8 * le[i] + 8] += 0.5
            w[i, :, 64 + 8 * lg[i]:72 + 8 * lg[i]] += 0.5
            w[i, lengths[i]:] = 0.0
        return SplitArrays(
            windows=w, labels_emo=le.astype(np.int32), labels_gen=lg.astype(np.int32),
            lengths=lengths.astype(np.int32), global_data=np.zeros((n, 88), np.float32),
            speaker_ids=np.array([f"spk{k}" for k in spk], object),
            datasets=np.array([CORPORA[k % 2] for k in spk], object),
            utt_ids=np.array([f"utt{i}" for i in range(n)], object))

    return FoldData(1, split(FOLD_TRAIN), split(FOLD_VAL), split(FOLD_TRAIN), split(FOLD_VAL),
                    split(FOLD_TEST, test=True))


def sweep_model(device, global_dim=0):
    from sept_tpu_torch.eval.sweep import SweepModel
    from sept_tpu_torch.models import Conv2dBiRNN

    return SweepModel(Conv2dBiRNN(HIDDEN, N_MELS, "emotion", global_dim=global_dim),
                      Conv2dBiRNN(HIDDEN, N_MELS, "gender", global_dim=global_dim),
                      WIN, N_MELS).to(device)


def sweep_cell(model, ckpt, cfg, ratio, device):
    """Load one ratio's artifacts into ``model``; returns its eval mask."""
    from sept_tpu_torch.cli.train_baseline import artifact_name
    from sept_tpu_torch.cli.train_cloak import cloak_artifact
    from sept_tpu_torch.eval.sweep import eval_mask

    model.load_cell(
        ckpt.restore(cloak_artifact(dataclasses.replace(cfg, suppression_ratio=ratio)), 1, device),
        ckpt.restore(artifact_name(dataclasses.replace(cfg, adv=False, pred="emotion")), 1, device),
        ckpt.restore(artifact_name(dataclasses.replace(cfg, adv=True, pred="gender")), 1, device))
    return eval_mask(model.noise.scales().detach()[0].cpu().numpy(), ratio)


def stage_info(result, launches, ms):
    hist = result.history
    losses = [h["train"]["loss"] for h in hist] + [h["validate"]["loss"] for h in hist]
    require(np.isfinite(losses).all(), f"non-finite fold losses {losses}")
    return {"epochs": len(hist), "wall_ms": ms, "wall_ms_per_epoch": ms / len(hist),
            "best_epoch": result.best_epoch, "best_val_acc": result.best_val_acc,
            "test_acc": result.final_test_acc, "test_uar": result.final_test_uar,
            "train_loss": [h["train"]["loss"] for h in hist],
            "val_loss": [h["validate"]["loss"] for h in hist],
            "launches": {k: v for k, v in launches.items() if v}}


def fold_phase(rng):
    """One fold at full width through the port's run_folds (f32, FOLD_EPOCHS
    epochs each): the baseline, the adversary, the GRL cloak at suppression
    0 then 20-80 from it, the plain cloak at 0; the GRL sweep over
    FOLD_RATIOS from the checkpoints, one sweep call profiled; the sweep on
    the CPU from the same checkpoints with the same epsilon and masks; a
    2-epoch bf16 baseline.  Returns (info, launches by path, CSV rows)."""
    from sept_tpu_torch.cli import train_baseline as TB
    from sept_tpu_torch.cli import train_cloak as TC
    from sept_tpu_torch.eval.sweep import (evaluate_cloaked_test, rows_to_csv, sweep_to_rows,
                                           train_mask)
    from sept_tpu_torch.models import CloakNoise
    from sept_tpu_torch.train.checkpoint import CheckpointManager
    from sept_tpu_torch.train.config import preset

    fold = fold_data(rng)
    out = Path(__file__).resolve().parent / "build" / "fold_smoke"
    shutil.rmtree(out, ignore_errors=True)
    kw = dict(win_len=WIN, feature_len=N_MELS, hidden_size=HIDDEN, num_epochs=FOLD_EPOCHS,
              dataset="combine", output_dir=str(out), seed=SEED)
    grl_cfg = preset("cloak_grl", learning_rate=FOLD_GRL_LR, **kw)
    ckpt = CheckpointManager(grl_cfg.output_dir)
    k1k4 = ("block1_conv_stats", "block1_norm_pool", "block1_route", "block1_weight_grads")
    f32_only = BLOCK1_BF16 + NO_FRONTEND
    stages = [("baseline", TB, preset("baseline", **kw), k1k4, ("block1_input_grad",)),
              ("adversary", TB, preset("adversary", **kw), k1k4, ("block1_input_grad",))]
    stages += [(f"cloak_grl_{r}", TC, dataclasses.replace(grl_cfg, suppression_ratio=r), BLOCK1,
                ()) for r in FOLD_RATIOS]
    stages += [("cloak_0", TC, preset("cloak", **kw), k1k4[:3] + ("block1_input_grad",),
                ("block1_weight_grads",))]
    info, launches = {"stages": {}}, {}
    try:
        for name, mod, cfg, must, absent in stages:
            result, launches[f"fold_{name}"], ms = drive(
                lambda: mod.run_fold(cfg, fold, ckpt, verbose=False, device=DEV),
                must=must, must_not=absent + f32_only)
            info["stages"][name] = stage_info(result, launches[f"fold_{name}"], ms)
            log(f"fold {name}: {info['stages'][name]}")

        base = ckpt.restore(TB.artifact_name(preset("baseline", **kw)), 1, DEV)
        supp0 = ckpt.restore(TC.cloak_artifact(grl_cfg), 1, DEV)
        require(all(torch.equal(supp0[f"emotion_backbone.{k}"], v) for k, v in base.items()),
                "fold: the GRL cloak's emotion backbone is not the baseline's")
        # the masks the suppressed runs trained under, from the suppression-0
        # cloak's scales at the training noise's bounds
        noise = CloakNoise(WIN, N_MELS, grl_cfg.noise_min_scale, grl_cfg.noise_max_scale)
        noise.load_state_dict({k: supp0[f"noise.{k}"].cpu() for k in ("locs", "rhos")})
        scales = noise.scales().detach()[0].numpy()
        info["supp0_scales"] = {"min": float(scales.min()), "max": float(scales.max()),
                                "distinct": int(np.unique(scales).size)}
        info["train_mask_zero_share"] = {}
        for r in FOLD_RATIOS[1:]:
            cell = ckpt.restore(TC.cloak_artifact(dataclasses.replace(grl_cfg,
                                                                      suppression_ratio=r)), 1, DEV)
            require(torch.equal(cell["noise.rhos"], supp0["noise.rhos"]),
                    f"fold: the supp{r} cloak's rhos moved")
            info["train_mask_zero_share"][str(r)] = float(1 - train_mask(scales, r).mean())
        require(all(v > 0 for v in info["train_mask_zero_share"].values()),
                f"fold: a training mask keeps every cell {info['train_mask_zero_share']}")

        model = sweep_model(DEV)
        eps = model.noise.draw_eps(torch.Generator(device=DEV).manual_seed(grl_cfg.seed))

        def sweep():
            """Per ratio: restore the three checkpoints (restore_ms), then
            the sweep forward over the test split (eval_ms)."""
            per_ratio, probs, masks, restore_ms, eval_ms = {}, {}, {}, {}, {}
            for r in FOLD_RATIOS:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                masks[r] = sweep_cell(model, ckpt, grl_cfg, r, DEV)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                b, a = evaluate_cloaked_test(model, fold.test, masks[r], WIN, SHIFT, eps=eps)
                torch.cuda.synchronize()
                restore_ms[r] = (t1 - t0) * 1e3
                eval_ms[r] = (time.perf_counter() - t1) * 1e3
                per_ratio[r] = [(b, a)]
                probs[r] = np.concatenate([b["probs"], a["probs"]], -1)
            return per_ratio, probs, masks, (restore_ms, eval_ms)

        (per_ratio, probs, masks, (restore_ms, eval_ms)), launches["fold_sweep"], ms = drive(
            sweep, must=("block1_conv_stats", "block1_norm_pool"),
            must_not=BACKWARD + f32_only)
        rows = sweep_to_rows(per_ratio, grl_cfg.dataset)
        rows_to_csv(rows, str(out / "grl-sweep.csv"))
        csv_rows = (out / "grl-sweep.csv").read_text().splitlines()
        require(len(rows) == len(FOLD_RATIOS) * (1 + len(CORPORA)) == len(csv_rows) - 1,
                f"fold: {len(rows)} sweep rows")
        values = [v for r in rows for v in (r.baseline_acc, r.baseline_rec, r.adv_acc, r.adv_rec)]
        require(all(0.0 <= v <= 1.0 for v in values), f"fold: sweep values {values}")
        prof = path_profile(lambda: evaluate_cloaked_test(model, fold.test, masks[0], WIN, SHIFT,
                                                          eps=eps))
        info["sweep"] = {"wall_ms": ms,
                         "restore_ms_per_ratio": {str(r): v for r, v in restore_ms.items()},
                         "eval_ms_per_ratio": {str(r): v for r, v in eval_ms.items()},
                         "eval_mask_zero_share": {str(r): float(1 - m.mean())
                                                  for r, m in masks.items() if m is not None},
                         "profile_ratio_0": {k: prof[k] for k in (
                             "wall_ms", "device_busy_ms", "device_idle_share", "top")},
                         "launches": {k: v for k, v in launches["fold_sweep"].items() if v}}
        info["sweep_cpu"] = fold_sweep_cpu(fold, ckpt, grl_cfg, eps, masks, probs)

        cfg = preset("baseline", **{**kw, "num_epochs": 2, "compute_dtype": "bfloat16"})
        require(TB.artifact_name(cfg) == "baseline_emotion_bf16", TB.artifact_name(cfg))
        result, launches["fold_baseline_bf16"], ms = drive(
            lambda: TB.run_fold(cfg, fold, ckpt, verbose=False, device=DEV),
            must=tuple(f"{k}_bf16" for k in k1k4),
            must_not=BLOCK1 + ("block1_input_grad_bf16",) + NO_FRONTEND)
        require(ckpt.exists("baseline_emotion_bf16", 1), "fold: no bf16 baseline artifact")
        info["stages"]["baseline_bf16"] = stage_info(result, launches["fold_baseline_bf16"], ms)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    info.update(train_windows=FOLD_TRAIN, val_windows=FOLD_VAL, test_utterances=FOLD_TEST,
                test_frames=list(FOLD_FRAMES), speakers=FOLD_SPK, corpora=list(CORPORA),
                dataset="combine", epochs=FOLD_EPOCHS, ratios=list(FOLD_RATIOS))
    return info, launches, csv_rows


def fold_sweep_cpu(fold, ckpt, cfg, eps, masks, probs, ratios=FOLD_CPU_RATIOS, what="fold"):
    """The sweep on the CPU (plain versions) from the same checkpoints, with
    the card's epsilon and masks, on the first FOLD_CPU_UTTS test utterances
    (the card's first batch) at ``ratios`` (with ``cfg.global_feature``,
    each utterance's 88-dim vector to both models): probabilities within
    PROBS_ATOL, predictions equal wherever the CPU's top two are more than
    2 * PROBS_ATOL apart."""
    from sept_tpu_torch.data.pipeline import SplitArrays
    from sept_tpu_torch.eval.sweep import evaluate_cloaked_test
    from sept_tpu_torch.models import N_GLOBAL

    test = SplitArrays(**{f.name: getattr(fold.test, f.name)[:FOLD_CPU_UTTS]
                          for f in dataclasses.fields(SplitArrays)})
    model = sweep_model("cpu", N_GLOBAL if cfg.global_feature else 0)
    out = {"utterances": FOLD_CPU_UTTS, "ratios": list(ratios)}
    for r in ratios:
        sweep_cell(model, ckpt, cfg, r, "cpu")
        b, a = evaluate_cloaked_test(model, test, masks[r], WIN, SHIFT, eps=eps.cpu(),
                                     use_global=cfg.global_feature)
        want = np.concatenate([b["probs"], a["probs"]], -1)
        got = probs[r][:FOLD_CPU_UTTS]
        diff = float(np.abs(got - want).max())
        decided = []
        for lo, hi in ((0, 4), (4, 6)):
            top2 = np.sort(want[:, lo:hi], -1)[:, -2:]
            sure = top2[:, 1] - top2[:, 0] > 2 * PROBS_ATOL
            decided.append(np.array_equal(got[sure, lo:hi].argmax(-1),
                                          want[sure, lo:hi].argmax(-1)))
        log(f"{what} sweep ratio {r}: max |gpu - cpu| probs {diff:.3g}")
        require(diff <= PROBS_ATOL and all(decided),
                f"{what} sweep ratio {r}: the card and the CPU disagree ({diff}, {decided})")
        out[f"max_abs_probs_diff_ratio_{r}"] = diff
    return out


# ---------------------------------------------------------------------------
# the host fold loop


def cut_split(split, n):
    """The first ``n`` rows of a SplitArrays."""
    from sept_tpu_torch.data.pipeline import SplitArrays

    return SplitArrays(**{f.name: getattr(split, f.name)[:n]
                          for f in dataclasses.fields(SplitArrays)})


def host_weights():
    """Seeded CPU weights of the host_loop runs: the emotion backbone, the
    attention multitask backbone, the GRL cloak's gender backbone, its noise
    (rhos spread, so the suppression mask keeps a share of the cells) and
    the cloak's fixed evaluation draw."""
    from sept_tpu_torch.models import Conv2dBiRNN

    torch.manual_seed(SEED + 31)
    sds = {"baseline": Conv2dBiRNN(HIDDEN, N_MELS, "emotion").state_dict(),
           "att_multitask": Conv2dBiRNN(HIDDEN, N_MELS, "multitask",
                                        att="self_att").state_dict(),
           "gender": Conv2dBiRNN(HIDDEN, N_MELS, "gender").state_dict()}
    rng = np.random.default_rng(SEED + 32)
    sds["noise"] = {"locs": torch.from_numpy((0.1 * rng.standard_normal((1, WIN, N_MELS)))
                                             .astype(np.float32)),
                    "rhos": torch.from_numpy((-2 + 0.5 * rng.standard_normal((1, WIN, N_MELS)))
                                             .astype(np.float32))}
    sds["eval_eps"] = torch.from_numpy(rng.standard_normal((1, WIN, N_MELS)).astype(np.float32))
    return sds


def host_run(name, sds, data, device, epochs, batch=32, eps=None, timer=None,
             profile_dir=None):
    """``train.loop.fit`` of one host_loop run ("baseline", "grl",
    "att_multitask") on ``data`` = (train, val, test) on ``device``, combine
    mode's speaker weights: (FitResult, state).  GRL: ``eps`` a list records
    the card's draws, an iterator injects them.  ``timer``: a StepTimer
    around every step."""
    from sept_tpu_torch.eval.sweep import train_mask
    from sept_tpu_torch.models import CloakedModelGRL
    from sept_tpu_torch.train import (fit, init_state, make_baseline_step,
                                      make_cloak_grl_step, make_cloak_optimizer,
                                      make_eval_logits_fn, make_optimizer, preset,
                                      speaker_weights)
    from sept_tpu_torch.train.steps import cloak_scales

    train, val, test = data
    kw = dict(win_len=WIN, feature_len=N_MELS, hidden_size=HIDDEN, num_epochs=epochs,
              batch_size=batch, dataset="combine", seed=SEED)
    steps = -(-len(train) // batch)
    mask, callback = None, None
    if name == "grl":
        cfg = preset("cloak_grl", learning_rate=FOLD_GRL_LR, suppression_ratio=HOST_SUPP, **kw)
        model = CloakedModelGRL(backbone(sds["baseline"], dropout=0.0),
                                backbone(sds["gender"], "gender", dropout=0.0), cfg.grl_lambda,
                                WIN, N_MELS, cfg.noise_min_scale, cfg.noise_max_scale)
        model.noise.load_state_dict(sds["noise"])
        mask = train_mask(cloak_scales(model).detach()[0].numpy(), HOST_SUPP)
        state = init_state(model, make_cloak_optimizer(cfg, steps, model,
                                                       ("noise", "gender_backbone"),
                                                       freeze_rhos=True), SEED + 2, device)
        logits = make_eval_logits_fn(model, eps=sds["eval_eps"].to(device),
                                     mask=torch.as_tensor(mask, device=device))
        grl = make_cloak_grl_step(cfg.scale_lambda, cfg.gender_lambda,
                                  apply_scale_reg=False, antithetic=cfg.antithetic_noise)
        if isinstance(eps, list):
            def step(st, b, mask=None):
                e = st.model.noise.draw_eps(st.generator)
                eps.append(e)
                return grl(st, b, mask=mask, eps=e)
        elif eps is not None:
            def step(st, b, mask=None):
                return grl(st, b, mask=mask, eps=next(eps).to(device))
        else:
            step = grl

        def callback(st):
            return {"sigma_mean": float(cloak_scales(st.model).mean())}
    else:
        pred, att = ("multitask", "self_att") if name == "att_multitask" else ("emotion", None)
        cfg = preset("baseline", pred=pred, att=att, **kw)
        model = backbone(sds[name], pred, dropout=0.0, att=att)
        state = init_state(model, make_optimizer(cfg, steps, model), SEED, device)
        step, logits = make_baseline_step(), make_eval_logits_fn(model)
    if timer is not None:
        inner = step

        def step(st, b, **step_kw):
            with timer:
                return inner(st, b, **step_kw)
    result = fit(state, step, logits, train, val, test, cfg, spk_weights=speaker_weights(train),
                 mask=mask, verbose=False, profile_dir=profile_dir, epoch_callback=callback)
    return result, state


def hold_fit(what, got, want):
    """The card's fit held to the CPU's: per-epoch train loss, validation
    loss and test accuracy within HOST_TOL, validation accuracy, the epoch
    count and the best epoch equal, the best state's parameters and running
    statistics within HOST_TOL * max(|p|, 1).  Returns each deviation and
    its share of its bound."""
    hg, hc = got.history, want.history
    require(len(hg) == len(hc) and got.best_epoch == want.best_epoch
            and [h["validate"]["acc"] for h in hg] == [h["validate"]["acc"] for h in hc],
            f"{what}: epochs, best epoch or validation accuracy differ "
            f"({len(hg)}/{len(hc)}, {got.best_epoch}/{want.best_epoch})")
    dev = {f"{part}_{key}": max(abs(g[part][key] - c[part][key]) for g, c in zip(hg, hc))
           for part, key in (("train", "loss"), ("validate", "loss"), ("test", "acc"))}
    diffs = state_diffs(got.best_state["model"], want.best_state["model"])
    dev.update(best_param=diffs["param"], best_stats=diffs["stats"])
    log(f"{what}: card vs CPU {dev}")
    require(all(v <= HOST_TOL for v in dev.values()),
            f"{what}: the card and the CPU disagree {dev}")
    return {"epochs": len(hg), "best_epoch": got.best_epoch,
            "val_acc": [h["validate"]["acc"] for h in hg], "max_abs_diff": dev,
            "share_of_bound": {k: v / HOST_TOL for k, v in dev.items()}}


class Interrupted(Exception):
    pass


def resume_check(sds, data):
    """fit_device on the host_loop data (dropout HOST_RESUME_DROPOUT, so the
    card's generator carries the dropout stream across the restart, Adam,
    selection from epoch 1): uninterrupted, then interrupted after epoch
    HOST_STOP's mid-fold checkpoint and resumed; the resumed fold must equal
    the uninterrupted one bit for bit: history, best epoch, best state,
    final state and step."""
    import sept_tpu_torch.train.device_loop as DL
    from sept_tpu_torch.train import init_state, make_eval_logits_fn, make_optimizer, preset
    from sept_tpu_torch.train.midfold import MidFoldCheckpoint

    train, val, test = data
    cfg = preset("baseline", win_len=WIN, feature_len=N_MELS, hidden_size=HIDDEN,
                 num_epochs=HOST_EPOCHS, dataset="combine", seed=SEED, optimizer="adam",
                 learning_rate=1e-3, min_select_epoch=0)
    mid = Path(__file__).resolve().parent / "build" / "host_loop_midfold"
    shutil.rmtree(mid, ignore_errors=True)

    def run(resume=False):
        model = backbone(sds["baseline"], dropout=HOST_RESUME_DROPOUT)
        state = init_state(model, make_optimizer(cfg, -(-len(train) // cfg.batch_size), model),
                           SEED, DEV)
        res = DL.fit_device(state, train, val, test, cfg, make_eval_logits_fn(model),
                            verbose=False, resume_path=str(mid) if resume else None)
        return res, state

    class StopAfter(MidFoldCheckpoint):
        def save(self, state, best_state, loop):
            super().save(state, best_state, loop)
            if loop["epoch"] == HOST_STOP:
                raise Interrupted

    ref, ref_state = run()
    DL.MidFoldCheckpoint = StopAfter
    try:
        run(resume=True)
        require(False, "resume: the interrupted fold ran to its end")
    except Interrupted:
        pass
    finally:
        DL.MidFoldCheckpoint = MidFoldCheckpoint
    require(MidFoldCheckpoint(str(mid)).exists(), "resume: no mid-fold checkpoint left")
    res, state = run(resume=True)
    require(not mid.exists(), "resume: the mid-fold checkpoint outlived the fold")
    same_hist = [(h["train"]["loss"], h["validate"]["loss"], h["test"]["acc"])
                 for h in res.history] == [(h["train"]["loss"], h["validate"]["loss"],
                                            h["test"]["acc"]) for h in ref.history]
    same_best = all(torch.equal(res.best_state["model"][k], v)
                    for k, v in ref.best_state["model"].items())
    final, want = state.model.state_dict(), ref_state.model.state_dict()
    same_final = all(torch.equal(final[k], v) for k, v in want.items())
    out = {"epochs": len(res.history), "stopped_after_epoch": HOST_STOP,
           "dropout": HOST_RESUME_DROPOUT, "history_equal": same_hist,
           "best_epoch": [res.best_epoch, ref.best_epoch], "best_state_equal": same_best,
           "final_state_equal": same_final, "step": [state.step, ref_state.step]}
    log(f"resume: {out}")
    require(same_hist and same_best and same_final and res.best_epoch == ref.best_epoch
            and state.step == ref_state.step, f"resume: not bit-equal to the uninterrupted fold "
            f"{out}")
    return out


def trace_kernels(trace_dir):
    """(file bytes, names of the device kernels) of the one trace in
    ``trace_dir``."""
    files = list(Path(trace_dir).glob("*.pt.trace.json"))
    require(len(files) == 1 and files[0].stat().st_size > 0, f"host_loop: traces {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    return files[0].stat().st_size, {e.get("name", "") for e in events
                                     if e.get("cat") == "kernel"}


def host_loop_phase(rng):
    """``train.loop.fit`` on the card (see HOST_TRAIN): the baseline with a
    profiled first epoch and a StepTimer around its steps, the GRL cloak
    (mask=), the attention multitask model; fit_device on the same windows
    (the device loop's wall per epoch); each run held to the CPU on a cut
    fold; the mid-fold resume.  Returns (info, launches by path)."""
    from sept_tpu_torch.train import (init_state, make_eval_logits_fn, make_optimizer, preset,
                                      speaker_weights)
    from sept_tpu_torch.train.device_loop import fit_device
    from sept_tpu_torch.utils import StepTimer

    fold = fold_data(rng)
    data = (cut_split(fold.training, HOST_TRAIN), fold.validation, fold.test)
    sds = host_weights()
    trace_dir = Path(__file__).resolve().parent / "build" / "host_loop_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    k1k4 = BLOCK1[:4]
    never = BLOCK1_BF16 + NO_FRONTEND
    runs = {"baseline": (HOST_EPOCHS, k1k4, never + ("block1_input_grad",)),
            "grl": (HOST_SHORT_EPOCHS, BLOCK1, never),
            "att_multitask": (HOST_SHORT_EPOCHS, k1k4, never + ("block1_input_grad",))}
    info, launches = {"runs": {}}, {}
    timer = StepTimer(DEV)
    try:
        for name, (epochs, must, absent) in runs.items():
            extra = {"timer": timer, "profile_dir": str(trace_dir)} if name == "baseline" else {}
            (result, state), launches[f"host_loop_{name}"], ms = drive(
                lambda: host_run(name, sds, data, DEV, epochs, **extra), must, absent)
            info["runs"][name] = stage_info(result, launches[f"host_loop_{name}"], ms)
            info["runs"][name]["steps"] = state.step
            log(f"host_loop {name}: {info['runs'][name]}")
        steps = info["runs"]["baseline"]["steps"]
        info["step_timer"] = timer.summary()
        require(info["step_timer"]["n"] == steps - 1,
                f"host_loop: StepTimer n {info['step_timer']['n']}, {steps} steps")
        size, names = trace_kernels(trace_dir)
        found = {sym: sorted(n for n in names if sym in n)[:2] for sym in BLOCK1_SYMBOLS}
        info["trace"] = {"bytes": size, "device_kernels": len(names), "block1": found}
        require(all(found.values()), f"host_loop: the trace names no block-1 kernel {found}")
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)

    # the two loops' walls on the same windows, weights and config, neither
    # profiled nor timed by steps
    def device_loop():
        model = backbone(sds["baseline"], dropout=0.0)
        cfg = preset("baseline", win_len=WIN, feature_len=N_MELS, hidden_size=HIDDEN,
                     num_epochs=HOST_EPOCHS, dataset="combine", seed=SEED)
        state = init_state(model, make_optimizer(cfg, -(-HOST_TRAIN // cfg.batch_size), model),
                           SEED, DEV)
        return fit_device(state, *data, cfg, make_eval_logits_fn(model),
                          spk_weights=speaker_weights(data[0]), verbose=False)

    (host, _), _, host_ms = drive(lambda: host_run("baseline", sds, data, DEV, HOST_EPOCHS),
                                  k1k4, never)
    dev_res, launches["host_loop_fit_device"], dev_ms = drive(device_loop, k1k4, never)
    info["walls"] = {"host_loop_ms_per_epoch": host_ms / len(host.history),
                     "fit_device_ms_per_epoch": dev_ms / len(dev_res.history),
                     "host_over_device": (host_ms / len(host.history))
                     / (dev_ms / len(dev_res.history)),
                     # the same shuffle and pad rows: the two loops train alike
                     "max_abs_loss_diff": max(
                         abs(a[p]["loss"] - b[p]["loss"]) for a, b in zip(
                             host.history, dev_res.history) for p in ("train", "validate"))}
    log(f"host_loop walls: {info['walls']}")
    require(len(host.history) == len(dev_res.history)
            and info["walls"]["max_abs_loss_diff"] <= HOST_TOL,
            f"host_loop: the host loop and the device loop train apart {info['walls']}")

    cut = (cut_split(data[0], HOST_CPU_TRAIN), cut_split(data[1], HOST_CPU_VAL),
           cut_split(data[2], HOST_CPU_TEST))
    cudnn = torch.backends.cudnn
    pinned = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    info["cpu"] = {"train_windows": HOST_CPU_TRAIN, "batch": CPU_BATCH,
                   "val_windows": HOST_CPU_VAL, "test_utterances": HOST_CPU_TEST}
    try:
        for name, (epochs, _, _) in runs.items():
            draws = [] if name == "grl" else None
            card, _ = host_run(name, sds, cut, DEV, epochs, CPU_BATCH, eps=draws)
            inject = None if draws is None else iter([e.cpu() for e in draws])
            cpu, _ = host_run(name, sds, cut, "cpu", epochs, CPU_BATCH, eps=inject)
            info["cpu"][name] = hold_fit(f"host_loop {name}", card, cpu)
        info["resume"] = resume_check(sds, data)
    finally:
        cudnn.deterministic, cudnn.benchmark = pinned
    info.update(train_windows=HOST_TRAIN, val_windows=FOLD_VAL, test_utterances=FOLD_TEST,
                batch=32, dropout=0.0, tolerance=HOST_TOL,
                launches_per_run={k: {n: v for n, v in p.items() if v}
                                  for k, p in launches.items()})
    return info, launches


# ---------------------------------------------------------------------------
# the protocol through its command lines


def argval(argv, flag):
    """The value ``flag`` takes last in ``argv`` (argparse's rule), or None."""
    vals = [argv[i + 1] for i, a in enumerate(argv[:-1]) if a == flag]
    return vals[-1] if vals else None


class StageMeter:
    """Wraps the port's CLI entry points (``<module>.main``, as run_all
    calls them) for a ``with`` block: each call's kernel launches (the
    counts read before and after it), wall and return value, in call
    order."""

    def __init__(self, modules):
        self.modules, self.stages, self.saved = modules, [], {}

    def __enter__(self):
        self.saved = {m: m.main for m in self.modules}
        for m in self.modules:
            m.main = self._metered(m.__name__.rsplit(".", 1)[1], m.main)
        return self

    def __exit__(self, *exc):
        for m, main in self.saved.items():
            m.main = main

    def _metered(self, module, main):
        def call(argv):
            counters = kernel_counters()
            before = {k: getattr(f, a) for k, (f, a) in counters.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = main(argv)
            torch.cuda.synchronize()
            name = module
            if module == "train_baseline":
                name = "adversary" if argval(argv, "--adv") == "1" else "baseline"
            elif module == "train_cloak":
                name = f"cloak_{argval(argv, '--suppression_ratio')}"
            self.stages.append({
                "stage": name, "wall_ms": (time.perf_counter() - t0) * 1e3, "out": out,
                "launches": {k: getattr(f, a) - before[k] for k, (f, a) in counters.items()}})
            return out
        return call


def cli_stage_kernels(stage):
    """(must launch, must not launch) of one run_all stage: the f32 mel
    kernel in featurize, K1-K4 in the baselines, all five in the GRL
    cloaks, K1 and K2 in the sweep; never a bf16 mode."""
    if stage == "featurize":
        return ("mel_db",), BLOCK1 + BLOCK1_BF16 + ("mel_db_bf16", "floor_dct")
    absent = BLOCK1_BF16 + NO_FRONTEND
    if stage in ("baseline", "adversary"):
        return BLOCK1[:4], absent + ("block1_input_grad",)
    if stage.startswith("cloak_"):
        return BLOCK1, absent
    if stage == "evaluate":
        return BLOCK1[:2], absent + BACKWARD
    return (), absent + BLOCK1  # preprocess: host numpy


def split_sizes(fold):
    """Utterances, rows (windows, or whole test utterances) and speakers of
    each split of ``fold``."""
    from sept_tpu_torch.data.pipeline import SplitArrays

    return {name: {"utterances": len(set(s.utt_ids.tolist())), "rows": len(s),
                   "speakers": len(set(s.speaker_ids.tolist()))}
            for name, s in vars(fold).items() if isinstance(s, SplitArrays)}


def crema_tree(root, rng):
    """CREMA-D's layout: ``<actor>_<sentence>_<EMO>_XX.wav`` for actors
    1001-1091 and CREMA_SENTENCES, the emotions in turn; every fourth file
    44.1 kHz stereo PCM16 (the decoder resamples and mixes it down), the
    rest 16 kHz mono through the port's write_wav; VideoDemographics.csv;
    and 1076_MTI_SAD_XX.wav, which the walker skips."""
    import wave

    from sept_tpu_torch.runtime.wavio import write_wav

    root.mkdir(parents=True)
    rows, i = ["ActorID,Age,Sex,Race,Ethnicity"], 0
    for actor in range(1001, 1092):
        rows.append(f"{actor},30,{'Male' if actor % 2 else 'Female'},Caucasian,Not Hispanic")
        for sentence in CREMA_SENTENCES:
            path = root / f"{actor}_{sentence}_{('ANG', 'NEU', 'SAD', 'HAP')[i % 4]}_XX.wav"
            seconds = rng.uniform(*CORPUS_S)
            if i % 4 == 3:
                n = int(seconds * CREMA_STEREO_SR)
                pcm = np.stack([speechlike(rng, n), speechlike(rng, n)], 1) * 20000
                with wave.open(str(path), "wb") as w:
                    w.setnchannels(2)
                    w.setsampwidth(2)
                    w.setframerate(CREMA_STEREO_SR)
                    w.writeframes(np.clip(np.rint(pcm), -32768, 32767).astype("<i2").tobytes())
            else:
                write_wav(str(path), 0.6 * speechlike(rng, int(seconds * 16000)))
            i += 1
    write_wav(str(root / "1076_MTI_SAD_XX.wav"), 0.6 * speechlike(rng, 16000))
    (root / "VideoDemographics.csv").write_text("\n".join(rows) + "\n")
    return i


def run_all_phase(root, extra=(), what="cli"):
    """run_all on the synthetic corpus (CLI_SPEAKERS x CLI_UTTS) at the CLI
    defaults under ``root`` with ``extra`` flags: launches per stage (each
    stage's kernels, cli_stage_kernels), the artifacts, the baselines'
    run.json, the CSV; then the sweep's first FOLD_CPU_UTTS test utterances
    again on the CPU from the card's checkpoints.  Returns (info, launches
    of the run, fold 1, the results directory, the GRL config)."""
    import csv

    from sept_tpu_torch.cli import evaluate, featurize, preprocess, run_all
    from sept_tpu_torch.cli import train_baseline as TB
    from sept_tpu_torch.cli import train_cloak as TC
    from sept_tpu_torch.data.store import load_fold
    from sept_tpu_torch.models import N_GLOBAL
    from sept_tpu_torch.train.checkpoint import CheckpointManager
    from sept_tpu_torch.train.config import preset

    work, results = root / "work", root / "results"
    argv = ["--dataset", "synthetic", "--n_speakers", str(CLI_SPEAKERS), "--utts_per_speaker",
            str(CLI_UTTS), "--num_epochs", str(CLI_EPOCHS), "--grl", "1", "--scale_lamda",
            str(CLI_SCALE), "--ratios", *map(str, CLI_RATIOS), *extra,
            "--work_dir", str(work), "--output_dir", str(results), "--folds", "1",
            "--device", DEV]
    info = {"run_all_argv": argv[:-8]}
    with StageMeter((featurize, preprocess, TB, TC, evaluate)) as meter:
        _, launches, ms = drive(
            lambda: run_all.main(argv), must=("mel_db",) + BLOCK1,
            must_not=BLOCK1_BF16 + ("mel_db_bf16", "floor_dct"))
    info["run_all_wall_ms"] = ms
    info["stages"] = {}
    for st in meter.stages:
        must, absent = cli_stage_kernels(st["stage"])
        for k in must:
            require(st["launches"][k] > 0, f"{what} {st['stage']}: {k} never launched")
        for k in absent:
            require(st["launches"][k] == 0, f"{what} {st['stage']}: {k} launched")
        info["stages"][st["stage"]] = {"wall_ms": st["wall_ms"], "launches": {
            k: v for k, v in st["launches"].items() if v}}
    names = [st["stage"] for st in meter.stages]
    require(names == ["featurize", "preprocess", "baseline", "adversary"]
            + [f"cloak_{r}" for r in CLI_RATIOS] + ["evaluate"], f"{what} stages {names}")
    log(f"{what} run_all: {info['stages']}")

    use_global = "--global_feature" in extra
    cfg = preset("cloak_grl", scale_lambda=CLI_SCALE, dataset="synthetic",
                 global_feature=use_global)
    ckpt = CheckpointManager(str(results))
    baselines = [TB.artifact_name(dataclasses.replace(cfg, adv=a, pred=p))
                 for a, p in ((False, "emotion"), (True, "gender"))]
    for art in baselines + [TC.cloak_artifact(dataclasses.replace(cfg, suppression_ratio=r))
                            for r in CLI_RATIOS]:
        require((results / art / "fold1" / "state_dict.pt").is_file()
                and (results / art / "manifest_fold1.json").is_file(),
                f"{what}: artifact {art} incomplete")
        manifest = json.loads((results / art / "manifest_fold1.json").read_text())
        require(manifest["config"]["global_feature"] == use_global,
                f"{what}: {art} manifest global_feature {manifest['config']['global_feature']}")
    for art in baselines:
        run = json.loads((results / art / "run.json").read_text())
        require(set(run["results"]) == {"mean_test_acc", "mean_test_uar", "folds"},
                f"{what}: {art}/run.json results {sorted(run['results'])}")
        width = ckpt.restore(art, 1, "cpu")["dense1.weight"].shape[1]
        require(width == 2 * HIDDEN + (N_GLOBAL if use_global else 0),
                f"{what}: {art} dense1 takes {width}")
    with open(results / f"grl-{CLI_SCALE}.csv", newline="") as f:
        table = list(csv.reader(f))
    require(table[0] == ["", "baseline_acc", "baseline_rec", "adv_acc", "adv_rec"]
            and [r[0] for r in table[1:]] == [f"suppression_ratio_{r}_synthetic"
                                              for r in CLI_RATIOS],
            f"{what}: CSV layout {table}")
    values = [float(v) for r in table[1:] for v in r[1:]]
    require(all(0.0 <= v <= 1.0 for v in values), f"{what}: CSV values {values}")
    info["csv"] = table
    fold = load_fold(str(work / "folds" / "synthetic" / "fold1.npz"))
    info["splits"] = split_sizes(fold)

    per_ratio = meter.stages[-1]["out"]
    probs = {r: np.concatenate([per_ratio[r][0][0]["probs"], per_ratio[r][0][1]["probs"]],
                               -1) for r in CLI_RATIOS}
    model = sweep_model(DEV, N_GLOBAL if use_global else 0)
    # the CLI's epsilon (evaluate_cloaked_test draws it from noise_seed = the
    # config's seed on the model's device) and its masks
    eps = model.noise.draw_eps(torch.Generator(device=DEV).manual_seed(cfg.seed))
    masks = {r: sweep_cell(model, ckpt, cfg, r, DEV) for r in CLI_RATIOS}
    info["sweep_cpu"] = fold_sweep_cpu(fold, ckpt, cfg, eps, masks, probs, CLI_RATIOS, what)
    return info, launches, fold, results, cfg


def cli_phase(rng):
    """The protocol through the port's CLIs on the card, under
    build/cli_smoke: run_all on the synthetic corpus (run_all_phase);
    featurize of a CREMA-D-shaped WAV tree for mel_spec and mfcc, 8
    utterances of each store held to the CPU path, preprocess's fold 1 held
    to plan_folds; a bf16 baseline through --compute_dtype; then, before the
    tree is removed, the artifacts phase on its artifacts.  Returns (info,
    launches by path, the artifacts phase's info and launches by path)."""
    from sept_tpu_torch.cli import featurize, preprocess
    from sept_tpu_torch.cli import train_baseline as TB
    from sept_tpu_torch.data.splits import plan_folds
    from sept_tpu_torch.data.store import load_feature_store, load_fold, load_manifest
    from sept_tpu_torch.runtime.wavio import decode_batch, narrow_pcm16

    root = Path(__file__).resolve().parent / "build" / "cli_smoke"
    shutil.rmtree(root, ignore_errors=True)
    common = ["--work_dir", str(root / "work"), "--output_dir", str(root / "results"),
              "--folds", "1", "--device", DEV]
    launches = {}
    try:
        info, launches["cli_run_all"], fold, results, cfg = run_all_phase(root)

        tree, cwork = root / "crema-d", root / "crema_work"
        n_files = crema_tree(tree, rng)
        info["crema_d"] = {"files": n_files + 1, "stereo_44k_files": n_files // 4}
        for ft in ("mel_spec", "mfcc"):
            must = ("mel_db", "floor_dct") if ft == "mfcc" else ("mel_db",)
            absent = BLOCK1 + BLOCK1_BF16 + ("mel_db_bf16",) + (() if ft == "mfcc"
                                                                 else ("floor_dct",))
            _, launches[f"cli_crema_{ft}"], ms = drive(
                lambda: featurize.main(["--dataset", "crema-d", "--corpus_root", str(tree),
                                        "--functionals", "0", "--feature_type", ft,
                                        "--work_dir", str(cwork), "--device", DEV]),
                must=must, must_not=absent)
            fdir = cwork / "feature" / ft / "crema-d"
            store = load_feature_store(str(fdir / f"data_{N_MELS}.npz"))
            manifest = load_manifest(str(fdir / "manifest.json"))
            require(len(manifest) == n_files, f"cli crema-d: {len(manifest)} utterances")
            mat, lens = decode_batch([u.path for u in manifest])
            waves = {u.utt_id: narrow_pcm16(mat[i, :lens[i]]) for i, u in enumerate(manifest)}
            del mat
            check_store(store, waves, ft)
            sub = dict(list(waves.items())[:N_FEAT_CPU])
            mixed = sum(w.dtype != np.int16 for w in sub.values())
            require(0 < mixed < len(sub), f"cli crema-d: {mixed} resampled of {len(sub)}")
            gpu = {u: store[u] for u in sub}
            held = (hold_mel_store(gpu, sub, "cli crema-d") if ft == "mel_spec"
                    else hold_store(gpu, sub, ft, "cli crema-d"))
            info["crema_d"][ft] = {"wall_ms": ms, "cpu_check_resampled": mixed, **held}
        _, launches["cli_crema_preprocess"], ms = drive(
            lambda: preprocess.main(["--dataset", "crema-d", "--work_dir", str(cwork),
                                     "--folds", "1"]),
            must=(), must_not=BLOCK1 + BLOCK1_BF16 + NO_FRONTEND)
        crema_fold = load_fold(str(cwork / "folds" / "crema-d" / "fold1.npz"))
        plan = plan_folds("crema-d")[0]
        for split, attr in (("training", "train"), ("validation", "validation"),
                            ("adv_training", "adv_train"),
                            ("adv_validation", "adv_validation"), ("test", "test")):
            got = set(getattr(crema_fold, split).speaker_ids.tolist())
            require(got == {str(s) for s in getattr(plan, attr)},
                    f"cli crema-d: fold 1 {split} speakers {sorted(got)}")
        info["crema_d"].update(preprocess_wall_ms=ms, splits=split_sizes(crema_fold))

        k1k4 = BLOCK1[:4]
        _, launches["cli_baseline_bf16"], ms = drive(
            lambda: TB.main(["--dataset", "synthetic", "--compute_dtype", "bfloat16",
                             "--num_epochs", "1", *common]),
            must=tuple(f"{k}_bf16" for k in k1k4),
            must_not=BLOCK1 + ("block1_input_grad_bf16",) + NO_FRONTEND)
        require((results / "baseline_emotion_bf16" / "fold1" / "state_dict.pt").is_file(),
                "cli: no bf16 baseline artifact")
        info["baseline_bf16_wall_ms"] = ms
        t0 = time.perf_counter()
        artifacts, art_launches = artifacts_phase(rng, root, results, tree, common, cfg, fold)
        artifacts["wall_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        shutil.rmtree(root, ignore_errors=True)
    info["launches_by_path"] = {p: {k: v for k, v in c.items() if v} for p, c in launches.items()}
    return info, launches, artifacts, art_launches


# ---------------------------------------------------------------------------
# the global feature: the functionals and --global_feature 1


def check_functionals(vecs, corpus, what):
    """{name: {utt: vector}}: every utterance of ``corpus`` holds a finite
    (88,) gemaps and (988,) emobase vector."""
    for name, width in (("gemaps", 88), ("emobase", 988)):
        got = vecs[name]
        require(set(got) == set(corpus), f"{what} {name}: utterances missing")
        require(all(v.shape == (width,) and bool(np.isfinite(v).all()) for v in got.values()),
                f"{what} {name}: a vector not finite or not ({width},)")


def hold_functionals(gpu, waves, what):
    """The card's functionals of ``waves`` against featurize_corpus on the
    CPU (torch ops there too): each vector within GLOBAL_TOL, relative and
    absolute.  Returns the largest |gpu - cpu| / (GLOBAL_TOL + GLOBAL_TOL
    |cpu|) of each set (the check passes at <= 1)."""
    from sept_tpu_torch.data.featurize import featurize_corpus

    cpu = featurize_corpus(waves, "mel_spec", include_gemaps=True, device="cpu")
    out = {}
    for name in ("gemaps", "emobase"):
        shares = {u: np.abs(gpu[name][u] - cpu[u][name])
                  / (GLOBAL_TOL + GLOBAL_TOL * np.abs(cpu[u][name])) for u in waves}
        worst = max(shares, key=lambda u: shares[u].max())
        dim = int(shares[worst].argmax())
        ratio = float(shares[worst][dim])
        diff = max(float(np.abs(gpu[name][u] - cpu[u][name]).max()) for u in waves)
        log(f"{what} {name}: max |gpu - cpu| {diff:.3g}, {ratio:.3g} of the bound at "
            f"{worst}[{dim}]")
        require(ratio <= 1.0, f"{what} {name}: the card and the CPU differ ({ratio} of "
                f"rtol = atol = {GLOBAL_TOL})")
        # emobase's dimension lld * 19 + functional
        out[name] = {"max_abs_diff_vs_cpu": diff, "max_share_of_bound": ratio,
                     "worst": {"utterance": worst, "dim": dim, "card": float(gpu[name][worst][dim]),
                               "cpu": float(cpu[worst][name][dim])}}
    return out


def global_steps_phase(fold, results, cfg):
    """Three steps with the global vector of the baseline and of the GRL game
    (antithetic, saliency_align SALIENCY_ALIGN) on the card and on the CPU
    from run_all's artifacts, on the first 3 * CPU_BATCH training windows,
    dropout 0, one injected epsilon, lr 1e-2: held as the train-cpu phase
    holds its steps (TRAIN_F32_TOL)."""
    from sept_tpu_torch.cli.train_baseline import artifact_name
    from sept_tpu_torch.cli.train_cloak import cloak_artifact
    from sept_tpu_torch.models import N_GLOBAL, CloakedModelGRL
    from sept_tpu_torch.train.checkpoint import CheckpointManager
    from sept_tpu_torch.train.config import preset
    from sept_tpu_torch.train.optim import make_cloak_optimizer, make_optimizer
    from sept_tpu_torch.train.steps import init_state, make_baseline_step, make_cloak_grl_step

    n = 3 * CPU_BATCH
    split = fold.training
    data = {"spec": torch.from_numpy(split.windows[:n])[:, None],
            "labels_emo": torch.from_numpy(split.labels_emo[:n]).long(),
            "labels_gen": torch.from_numpy(split.labels_gen[:n]).long(),
            "weight": torch.ones(n), "global": torch.from_numpy(split.global_data[:n])}
    eps = torch.from_numpy((0.1 * np.random.default_rng(SEED + 29).standard_normal(
        (1, WIN, N_MELS))).astype(np.float32))
    ckpt = CheckpointManager(str(results))
    emo = ckpt.restore(artifact_name(dataclasses.replace(cfg, adv=False, pred="emotion")), 1,
                       "cpu")
    cloak = ckpt.restore(cloak_artifact(dataclasses.replace(cfg, suppression_ratio=0)), 1, "cpu")
    gender = {k[len("gender_backbone."):]: v for k, v in cloak.items()
              if k.startswith("gender_backbone.")}
    runs = {}
    cudnn = torch.backends.cudnn
    pinned = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        for dev in (DEV, "cpu"):
            bcfg = preset("baseline", learning_rate=1e-2, global_feature=True)
            m = backbone(emo, dropout=0.0, global_dim=N_GLOBAL)
            base = init_state(m, make_optimizer(bcfg, T_BATCHES, m), SEED, dev)
            gcfg = dataclasses.replace(cfg, learning_rate=1e-2, antithetic_noise=True,
                                       saliency_align=SALIENCY_ALIGN)
            m = CloakedModelGRL(backbone(emo, dropout=0.0, global_dim=N_GLOBAL),
                                backbone(gender, "gender", dropout=0.0, global_dim=N_GLOBAL),
                                gcfg.grl_lambda, WIN, N_MELS, gcfg.noise_min_scale,
                                gcfg.noise_max_scale)
            m.noise.load_state_dict({k: cloak[f"noise.{k}"] for k in ("locs", "rhos")})
            grl = init_state(m, make_cloak_optimizer(gcfg, T_BATCHES, m,
                                                     ("noise", "gender_backbone")),
                             SEED + 2, dev)
            steps = {"baseline": (base, make_baseline_step(use_global=True), False),
                     "cloak_grl": (grl, make_cloak_grl_step(
                         gcfg.scale_lambda, gcfg.gender_lambda, antithetic=True,
                         saliency_align=SALIENCY_ALIGN, use_global=True), True)}
            for name, (state, step, cloaked) in steps.items():
                losses = []
                for i in range(3):
                    batch = {k: v[i * CPU_BATCH:(i + 1) * CPU_BATCH].to(dev)
                             for k, v in data.items()}
                    losses.append(float(step(state, batch, **(
                        {"eps": eps.to(dev)} if cloaked else {}))[1]["loss"]))
                runs.setdefault(name, {})[dev] = (np.asarray(losses), snapshot(state.model))
    finally:
        cudnn.deterministic, cudnn.benchmark = pinned
    out = {name: hold_steps(f"global {name}", r, TRAIN_F32_TOL) for name, r in runs.items()}
    out.update(batch=CPU_BATCH, steps=3, learning_rate=1e-2, tolerance=TRAIN_F32_TOL)
    return out


def global_phase(corpus):
    """The global feature on the card: the gemaps / emobase functionals of
    the featurize phase's corpus alone (combined_functionals_batch) and with
    mel_spec (featurize_corpus with include_gemaps, the f32 mel kernel, never
    the bf16 one), N_FEAT_PROFILE of its utterances under torch.profiler,
    GLOBAL_CPU held to the CPU path; then run_all --global_feature 1 at the
    cli phase's size under build/global_smoke (run_all_phase: K1-K4 in the
    baselines, all five in the GRL cloaks, K1 and K2 in the sweep, the sweep
    held to the CPU) and three steps with the vector on the card and the
    CPU (global_steps_phase).  Returns (info, launches by path)."""
    from sept_tpu_torch.data.featurize import featurize_corpus
    from sept_tpu_torch.ops.emobase import combined_functionals_batch

    samples = sum(len(w) for w in corpus.values())
    info = {"utterances": len(corpus), "audio_hours": samples / 16000 / 3600}
    launches = {}
    absent = BLOCK1 + BLOCK1_BF16 + ("mel_db_bf16", "floor_dct")
    (gem, emo), launches["global_functionals"], ms = drive(
        lambda: combined_functionals_batch(corpus, device=DEV), must=(),
        must_not=absent + ("mel_db",))
    check_functionals({"gemaps": gem, "emobase": emo}, corpus, "global functionals")
    info["functionals"] = {"wall_s": ms / 1e3, "utterances_per_s": len(corpus) / (ms / 1e3)}
    store, launches["global_featurize"], ms = drive(
        lambda: featurize_corpus(corpus, "mel_spec", include_gemaps=True, device=DEV),
        must=("mel_db",), must_not=absent)
    check_store({u: {k: v[k] for k in ("mel1", "mel2")} for u, v in store.items()}, corpus,
                "mel_spec")
    check_functionals({k: {u: v[k] for u, v in store.items()} for k in ("gemaps", "emobase")},
                      corpus, "global featurize")
    info["with_mel_spec"] = {"wall_s": ms / 1e3, "utterances_per_s": len(corpus) / (ms / 1e3)}
    info["featurize_vs_functionals_max_abs"] = max(
        float(np.abs(store[u][k] - ref[u]).max()) for k, ref in (("gemaps", gem), ("emobase", emo))
        for u in corpus)
    log(f"global featurize: {info}")
    del store
    sub = dict(list(corpus.items())[:N_FEAT_PROFILE])
    info["profile"] = {"utterances": N_FEAT_PROFILE, **path_profile(
        lambda: featurize_corpus(sub, "mel_spec", include_gemaps=True, device=DEV))}
    small = dict(list(corpus.items())[:GLOBAL_CPU])
    info["cpu_check"] = {"utterances": GLOBAL_CPU, **hold_functionals(
        {"gemaps": gem, "emobase": emo}, small, "global")}
    del gem, emo

    root = Path(__file__).resolve().parent / "build" / "global_smoke"
    shutil.rmtree(root, ignore_errors=True)
    try:
        info["run_all"], launches["global_run_all"], fold, results, cfg = run_all_phase(
            root, ("--global_feature", "1"), "global")
        g = fold.training.global_data
        require(g.shape[1] == 88 and bool(np.isfinite(g).all()) and bool(np.abs(g).max() > 0),
                "global: fold 1's global vectors are missing")
        info["steps_cpu"] = global_steps_phase(fold, results, cfg)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    info["launches_by_path"] = {p: {k: v for k, v in c.items() if v} for p, c in launches.items()}
    return info, launches


# ---------------------------------------------------------------------------
# artifacts in and out: load_predictor, the serve / predict / export / import
# command lines, and the model zoo


def latency_post(url, body):
    t0 = time.perf_counter()
    out = post(url, body)
    return out, (time.perf_counter() - t0) * 1e3


def pcm16_body(w):
    return {"waveforms_pcm16": [base64.b64encode(w.astype("<i2").tobytes()).decode()]}


def card_vs_cpu(load, waves, what, seed=0, atol=PROBS_ATOL):
    """``load(device)`` -> a predictor; its probabilities on ``waves`` on
    the card (a main path: mel, K1 and K2, no backward kernel) and on the
    CPU.  Returns (card predictor, card probs, launches, max |diff|, wall ms
    of the card's restore and build)."""
    t0 = time.perf_counter()
    gpu = load(DEV)
    build_ms = (time.perf_counter() - t0) * 1e3
    probs, launches, _ = drive(lambda: gpu.predict(waves, seed=seed),
                               must=("mel_db", "block1_conv_stats", "block1_norm_pool"),
                               must_not=BACKWARD + BLOCK1_BF16 + ("mel_db_bf16", "floor_dct"))
    diff = float(np.abs(probs - load("cpu").predict(waves, seed=seed)).max())
    log(f"artifacts {what}: max |card - cpu| probs {diff:.3g}")
    require(diff <= atol, f"artifacts {what}: the card and the CPU differ by {diff}")
    return gpu, check_probs(probs, len(waves), what), launches, diff, build_ms


def serve_cli_phase(results, waves, direct):
    """cli.serve's own code path (make_server: the manifest, --warmup 4,
    --batch_window_ms 5) on the card: /healthz, one /predict, then one
    concurrent /predict per utterance; each within 1e-5 of ``direct``."""
    from sept_tpu_torch.cli import serve

    t0 = time.perf_counter()
    server = serve.make_server(["--output_dir", str(results), "--port", "0", "--device", DEV,
                                "--warmup", "4", "--batch_window_ms", "5"])
    start_ms = (time.perf_counter() - t0) * 1e3
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.port}"
    results_, ms = {}, {}
    try:
        require(post(f"{base}/healthz", None) == {"status": "ok", "pred": "emotion",
                                                 "cloaked": False}, "serve cli: healthz")
        first, first_ms = latency_post(f"{base}/predict", pcm16_body(waves[0]))
        gate = threading.Barrier(len(waves))

        def fire(i):
            gate.wait(60)
            results_[i], ms[i] = latency_post(f"{base}/predict", pcm16_body(waves[i]))

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(len(waves))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        require(len(results_) == len(waves), "serve cli: concurrent requests did not finish")
        metrics = post(f"{base}/metrics", None)
    finally:
        server.shutdown()
        thread.join(30)
    require(not thread.is_alive(), "serve cli: server thread did not stop")
    got = np.concatenate([check_probs(results_[i]["probs"], 1, f"serve cli {i}")
                          for i in range(len(waves))])
    want = np.concatenate([direct.predict([w]) for w in waves])
    diff = max(float(np.abs(got - want).max()),
               float(np.abs(np.asarray(first["probs"]) - want[:1]).max()))
    require(diff <= 1e-5, f"serve cli: probs differ from a direct predict by {diff}")
    return {"startup_with_warmup_ms": start_ms, "first_request_ms": first_ms,
            "concurrent_median_ms": float(np.median(list(ms.values()))),
            "concurrent_max_ms": float(max(ms.values())),
            "device_calls": metrics["device_calls_total"],
            "max_abs_probs_diff_vs_direct": diff}


def predict_cli_phase(results, tree, root):
    """cli.predict over the CREMA-D tree on the card (launches, ms an
    utterance), then with --device cpu over the first ART_PREDICT_CPU of
    its files (a tree of links beside it, the demographics too): the CPU's
    rows are the card's for those files, probabilities within PROBS_ATOL."""
    import csv

    from sept_tpu_torch.cli import predict

    sub = root / "crema_sub"
    sub.mkdir()
    (sub / "VideoDemographics.csv").symlink_to(tree / "VideoDemographics.csv")
    for f in sorted(tree.glob("*.wav"))[:ART_PREDICT_CPU]:
        (sub / f.name).symlink_to(f)
    rows, walls = {}, {}
    for dev, corpus in ((DEV, tree), ("cpu", sub)):
        out = root / f"predict_{dev}.csv"
        argv = ["--output_dir", str(results), "--dataset", "crema-d", "--corpus_root",
                str(corpus), "--out", str(out), "--device", dev]
        if dev == DEV:
            _, launches, walls[dev] = drive(lambda: predict.main(argv),
                                            must=("mel_db", "block1_conv_stats",
                                                  "block1_norm_pool"),
                                            must_not=BACKWARD + BLOCK1_BF16 + ("mel_db_bf16",
                                                                               "floor_dct"))
        else:
            t0 = time.perf_counter()
            predict.main(argv)
            walls[dev] = (time.perf_counter() - t0) * 1e3
        with open(out, newline="") as f:
            rows[dev] = {r["utt_id"]: r for r in csv.DictReader(f)}
    require(rows["cpu"] and set(rows["cpu"]) <= set(rows[DEV]), "predict cli: rows differ")
    cols = [c for c in next(iter(rows["cpu"].values())) if c.startswith("p_")]
    diff = max(abs(float(rows[DEV][u][c]) - float(rows["cpu"][u][c]))
               for u in rows["cpu"] for c in cols)
    require(diff <= PROBS_ATOL, f"predict cli: the card and the CPU differ by {diff}")
    return {"utterances": len(rows[DEV]), "utterances_cpu": len(rows["cpu"]),
            "card_ms_per_utterance": walls[DEV] / len(rows[DEV]),
            "cpu_ms_per_utterance": walls["cpu"] / len(rows["cpu"]),
            "max_abs_probs_diff": diff}, launches


def exchange_phase(results, root, cloak, waves, originals):
    """export_torch -> import_torch of the baseline and the GRL cloak: live
    tensors bit-equal, the synthesized keys present, the imported artifacts
    served within 1e-6 of ``originals`` ({artifact: (load_predictor
    keywords, noise seed, probs)})."""
    from sept_tpu_torch.cli import export_torch, import_torch
    from sept_tpu_torch.serve import load_predictor
    from sept_tpu_torch.train.checkpoint import CheckpointManager

    back = root / "imported"
    out, walls = {}, {"export_ms": 0.0, "import_ms": 0.0}
    for art in ("baseline_emotion", cloak):
        pt = root / f"{art}.pt"
        t0 = time.perf_counter()
        export_torch.main(["--output_dir", str(results), "--artifact", art, "--out", str(pt)])
        t1 = time.perf_counter()
        import_torch.main(["--checkpoint", str(pt), "--output_dir", str(back), "--artifact",
                           art])
        walls["export_ms"] += (t1 - t0) * 1e3
        walls["import_ms"] += (time.perf_counter() - t1) * 1e3
        exported = torch.load(str(pt), weights_only=True)
        prefix = "original_model." if art == cloak else ""
        dead = {f"{prefix}{k}" for k in ("dense2.weight", "dense2.bias", "att_mat1",
                                         "att_mat2", "att_linear1.weight",
                                         "att_linear2.weight", "pred_gender_layer.weight")}
        require(dead <= set(exported), f"exchange {art}: synthesized keys missing")
        a = CheckpointManager(str(results)).restore(art, 1, "cpu")
        b = CheckpointManager(str(back)).restore(art, 1, "cpu")
        live = [k for k in a if not k.endswith("num_batches_tracked")]
        require(set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in live),
                f"exchange {art}: live tensors differ after export -> import")
        out[art] = {"tensors_exported": len(exported), "live_tensors": len(live)}
    for art, (kw, seed, want) in originals.items():
        got = load_predictor(str(back), device=DEV, **kw).predict(waves, seed=seed)
        diff = float(np.abs(got - want).max())
        require(diff <= 1e-6, f"exchange {art}: the imported artifact serves {diff} away")
        out[art]["max_abs_probs_diff_served"] = diff
    return {**out, **walls}


def zoo_phase(fold):
    """Three baseline steps each of the deep LSTM (f32 and bf16),
    OneDConvNet and PlainConv2d at full width on the card and on the CPU,
    dropout 0, lr 1e-2, CPU_BATCH windows of the fold's training split;
    held with hold_steps at the fold tolerances.  The deep model runs K1-K4
    (its bf16 mode in bf16), the others no kernel of the port."""
    from sept_tpu_torch.models import build_backbone, compute_dtype, pooling_for
    from sept_tpu_torch.train.config import ExperimentConfig
    from sept_tpu_torch.train.optim import make_optimizer
    from sept_tpu_torch.train.steps import init_state, make_baseline_step

    split = fold.training
    n = 3 * CPU_BATCH
    data = {"spec": torch.from_numpy(split.windows[:n])[:, None],
            "labels_emo": torch.from_numpy(split.labels_emo[:n]).long(),
            "labels_gen": torch.from_numpy(split.labels_gen[:n]).long(),
            "weight": torch.ones(n)}
    cases = {"deep_lstm": ("deep-2d-cnn-lstm", "float32", TRAIN_F32_TOL),
             "deep_lstm_bf16": ("deep-2d-cnn-lstm", "bfloat16", TRAIN_BF16_TOL),
             "one_d": ("1d-cnn-lstm-att", "float32", TRAIN_F32_TOL),
             "plain": ("2d-cnn", "float32", TRAIN_F32_TOL)}
    info, launches = {}, {}
    cudnn = torch.backends.cudnn
    pinned = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        for name, (mt, dtype, tol) in cases.items():
            def make():
                return build_backbone(mt, hidden_size=HIDDEN, feature_len=N_MELS, win_len=WIN,
                                      rnn_cell="lstm", dropout_rate=0.0,
                                      compute_dtype=compute_dtype(dtype))

            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(SEED + 31)
                sd = make().state_dict()
            k1k4 = BLOCK1[:4] if dtype == "float32" else BLOCK1_BF16[:4]
            must = k1k4 if "deep" in name else ()
            run = {}
            for dev in (DEV, "cpu"):
                model = make()
                model.load_state_dict(sd)
                cfg = ExperimentConfig(optimizer="sgd", learning_rate=1e-2)
                state = init_state(model, make_optimizer(cfg, 100, model), SEED, dev)
                step = make_baseline_step(pooling_for(mt))

                def steps():
                    return [float(step(state, {k: v[i * CPU_BATCH:(i + 1) * CPU_BATCH].to(dev)
                                               for k, v in data.items()})[1]["loss"])
                            for i in range(3)]

                if dev == DEV:
                    losses, launches[f"artifacts_zoo_{name}"], ms = drive(
                        steps, must=must,
                        must_not=tuple(k for k in BLOCK1 + BLOCK1_BF16 if k not in must)
                        + NO_FRONTEND)
                else:
                    losses = steps()
                run[dev] = (np.asarray(losses), snapshot(state.model))
            info[name] = {"model_type": mt, "compute_dtype": dtype, "card_wall_ms_3_steps": ms,
                          **hold_steps(f"artifacts zoo {name}", run, tol)}
    finally:
        cudnn.deterministic, cudnn.benchmark = pinned
    return info, launches


def artifacts_phase(rng, root, results, tree, common, cfg, fold):
    """The artifacts the cli phase's run_all left under ``results``: served
    through load_predictor on the card and the CPU (the baseline, the GRL
    cloak at ART_SUPP), through cli.serve and cli.predict, exchanged through
    export_torch -> import_torch; a deep baseline trained by
    train_baseline and served; the model zoo's steps.  Returns (info,
    launches by path)."""
    from sept_tpu_torch.cli import train_baseline as TB
    from sept_tpu_torch.cli import train_cloak as TC
    from sept_tpu_torch.eval.sweep import EVAL_MAX_SCALE, eval_mask
    from sept_tpu_torch.models import CloakNoise
    from sept_tpu_torch.serve import load_predictor
    from sept_tpu_torch.train.checkpoint import CheckpointManager

    waves = [(speechlike(rng, int(ART_SECONDS * 16000)) * 20000).astype(np.int16)
             for _ in range(ART_UTTS)]
    info, launches = {"utterances": ART_UTTS, "seconds": ART_SECONDS}, {}

    gpu, probs, launches["artifacts_load_predictor"], diff, ms = card_vs_cpu(
        lambda d: load_predictor(str(results), "baseline_emotion", 1, device=d), waves,
        "baseline")
    info["baseline"] = {"restore_and_build_ms": ms, "max_abs_probs_diff_card_cpu": diff}

    cloak = TC.cloak_artifact(dataclasses.replace(cfg, suppression_ratio=ART_SUPP))
    ckw = {"cloak_artifact": cloak, "suppression_ratio": ART_SUPP}
    gc, cprobs, launches["artifacts_cloak"], diff, ms = card_vs_cpu(
        lambda d: load_predictor(str(results), device=d, **ckw), waves, "grl cloak",
        seed=ART_SEED)
    state = CheckpointManager(str(results)).restore(cloak, 1, "cpu")
    probe = CloakNoise(WIN, N_MELS, max_scale=EVAL_MAX_SCALE)
    probe.load_state_dict({k: state[f"noise.{k}"] for k in ("locs", "rhos")})
    mask = eval_mask(probe.scales().detach()[0].numpy(), ART_SUPP)
    require(mask is not None and np.array_equal(gc.mask.cpu().numpy(), mask),
            "artifacts: the cloak's mask is not eval_mask of its scales")
    info["grl_cloak"] = {"artifact": cloak, "restore_and_build_ms": ms,
                         "max_abs_probs_diff_card_cpu": diff,
                         "mask_kept_share": float(mask.mean())}

    info["serve_cli"], launches["artifacts_serve_cli"], _ = drive(
        lambda: serve_cli_phase(results, waves, gpu),
        must=("mel_db", "block1_conv_stats", "block1_norm_pool"),
        must_not=BACKWARD + BLOCK1_BF16 + ("mel_db_bf16", "floor_dct"))
    info["predict_cli"], launches["artifacts_predict_cli"] = predict_cli_phase(results, tree,
                                                                                root)
    info["exchange"] = exchange_phase(results, root, cloak, waves, {
        "baseline_emotion": ({}, 0, probs), cloak: (ckw, ART_SEED, cprobs)})

    deep_dir = root / "deep_results"
    _, launches["artifacts_deep_train"], ms = drive(
        lambda: TB.main(["--dataset", "synthetic", "--model_type", "deep-2d-cnn-lstm",
                         "--num_epochs", "1", *common, "--output_dir", str(deep_dir)]),
        must=BLOCK1[:4], must_not=("block1_input_grad",) + BLOCK1_BF16 + NO_FRONTEND)
    _, _, launches["artifacts_deep_serve"], diff, build_ms = card_vs_cpu(
        lambda d: load_predictor(str(deep_dir), device=d), waves, "deep baseline")
    info["deep"] = {"epoch_wall_ms": ms, "restore_and_build_ms": build_ms,
                    "max_abs_probs_diff_card_cpu": diff}
    info["zoo_steps"], zoo_launches = zoo_phase(fold)
    launches.update(zoo_launches)
    info["launches_by_path"] = {p: {k: v for k, v in c.items() if v}
                                for p, c in launches.items()}
    return info, launches


# ---------------------------------------------------------------------------
# the featurization slice


def make_corpus(rng, n):
    """``n`` seeded int16 utterances of CORPUS_S seconds (uniform): two tones
    over a broadband noise floor, as PCM16 corpora decode."""
    lengths = rng.integers(int(CORPUS_S[0] * 16000), int(CORPUS_S[1] * 16000) + 1, n)
    corpus = {}
    for i, length in enumerate(lengths):
        t = np.arange(length, dtype=np.float32) / np.float32(16000.0)
        f1, f2 = rng.uniform(100, 400), rng.uniform(800, 3000)
        w = (np.float32(0.3) * np.sin(np.float32(2 * np.pi * f1) * t)
             + np.float32(0.1) * np.sin(np.float32(2 * np.pi * f2) * t)
             + np.float32(0.05) * rng.standard_normal(length, dtype=np.float32))
        corpus[f"c{i:05d}"] = np.clip(np.rint(w * 20000), -32768, 32767).astype(np.int16)
    return corpus


def check_store(store, corpus, feature_type):
    """Every utterance holds its features at 1 + n // hop frames, finite."""
    shapes = ({"mel1": N_MELS, "mel2": N_MELS} if feature_type == "mel_spec"
              else {"mfcc": 120})
    hop = HOP if feature_type == "mel_spec" else MFCC_HOP
    require(set(store) == set(corpus), f"{feature_type}: utterances missing from the store")
    for u, w in corpus.items():
        require(set(store[u]) == set(shapes), f"{feature_type} {u}: keys {sorted(store[u])}")
        for k, d in shapes.items():
            a = store[u][k]
            require(a.shape == (d, 1 + len(w) // hop), f"{feature_type} {u} {k}: {a.shape}")
            require(bool(np.isfinite(a).all()), f"{feature_type} {u} {k}: non-finite")


def hold_store(gpu, waves, feature_type, what):
    """The card's store entries of ``waves`` against featurize_corpus on the
    CPU (plain versions): mel within FEAT_TOL dB on cells within 60 dB of
    the peak and FEAT_LOW_TOL below, MFCC within FEAT_TOL."""
    from sept_tpu_torch.data.featurize import featurize_corpus

    keys = ("mel1", "mel2") if feature_type == "mel_spec" else ("mfcc",)
    cpu = featurize_corpus(waves, feature_type, include_gemaps=False, device="cpu")
    out = {}
    if feature_type == "mel_spec":
        # cells more than 60 dB under the utterance's peak sit at the f32
        # rounding floor of the DFT (ROADMAP §3, "Mel cells at the f32
        # rounding floor"): held on their own
        live = {(u, k): cpu[u][k] > cpu[u][k].max() - 60.0 for u in waves for k in keys}
        diff = max(float(np.abs(gpu[u][k] - cpu[u][k])[live[u, k]].max())
                   for u in waves for k in keys)
        low = max(float(np.abs(gpu[u][k] - cpu[u][k])[~live[u, k]].max(initial=0.0))
                  for u in waves for k in keys)
        log(f"{what} mel_spec: max |gpu - cpu| {low:.3g} dB on cells > 60 dB under "
            f"the peak (tolerance {FEAT_LOW_TOL:g})")
        require(low <= FEAT_LOW_TOL, f"{what} mel_spec: low cells differ by {low}")
        out["max_abs_diff_vs_cpu_below_60db"] = low
    else:
        diff = max(float(np.abs(gpu[u][k] - cpu[u][k]).max()) for u in waves for k in keys)
    log(f"{what} {feature_type}: max |gpu - cpu| = {diff:.3g} (tolerance "
        f"{FEAT_TOL[feature_type]:g})")
    require(diff <= FEAT_TOL[feature_type],
            f"{what} {feature_type}: GPU and CPU stores differ by {diff}")
    out["max_abs_diff_vs_cpu"] = diff
    return out


def hold_mel_store(gpu, waves, what):
    """The card's mel_spec store entries of ``waves`` against featurize_corpus
    on the CPU with the f32 mel kernel's own rule (check_mel): within 1e-3
    dB cell by cell, or, where the two part by more, the card no farther
    from the float64 chain than the CPU, plus 1e-3 (the CPU's dense f32 DFT
    is off by up to ~0.07 dB on cells ~100 dB under an utterance's peak)."""
    from sept_tpu_torch.data.featurize import featurize_corpus

    cpu = featurize_corpus(waves, "mel_spec", include_gemaps=False, device="cpu")
    readings = []
    for u, w in waves.items():
        x = w.astype(np.float32) / np.float32(32768.0 if w.dtype == np.int16 else 1.0)
        for key, n_fft in (("mel1", 800), ("mel2", 1600)):
            padded = torch.from_numpy(np.pad(x, n_fft // 2, mode="reflect")).to(DEV)[None]
            k, p = (torch.from_numpy(np.ascontiguousarray(a[key].T)).to(DEV)[None]
                    for a in (gpu[u], cpu[u]))
            readings.append(check_mel(k, p, padded, k.shape[1], n_fft, HOP, f"{what} {u} {key}"))
    out = {"max_abs_diff_vs_cpu": max(r["max_abs_vs_plain"] for r in readings),
           "cells_parted": sum(r["cells_parted"] for r in readings),
           "card_vs_f64": max(r["kernel_vs_f64"] for r in readings),
           "cpu_vs_f64": max(r["plain_vs_f64"] for r in readings)}
    log(f"{what} mel_spec: {out}")
    return out


def featurize_phase(rng):
    """featurize_corpus of a CREMA-D-sized int16 corpus for mel_spec and for
    mfcc through the kernels (f32 mel; floor + DCT on mfcc; never the bf16
    mel), then 8 utterances again on the CPU path.  Returns (info, launches
    by path, the first 64-utterance mfcc chunk of bucket 64000, the
    corpus)."""
    from sept_tpu_torch.data.featurize import featurize_corpus
    from sept_tpu_torch.ops import functionals as FN

    t0 = time.perf_counter()
    corpus = make_corpus(rng, N_CORPUS)
    samples = sum(len(w) for w in corpus.values())
    info = {"utterances": N_CORPUS, "seconds_range": list(CORPUS_S),
            "audio_hours": samples / 16000 / 3600,
            "corpus_build_s": time.perf_counter() - t0}
    launches = {}
    for ft in ("mel_spec", "mfcc"):
        must = ("mel_db", "floor_dct") if ft == "mfcc" else ("mel_db",)
        must_not = ("mel_db_bf16",) if ft == "mfcc" else ("mel_db_bf16", "floor_dct")
        store, launches[f"featurize_{ft}"], ms = drive(
            lambda: featurize_corpus(corpus, ft, include_gemaps=False, device=DEV),
            must=must, must_not=must_not + BACKWARD + BLOCK1_BF16)
        check_store(store, corpus, ft)
        info[ft] = {"wall_s": ms / 1e3, "utterances_per_s": N_CORPUS / (ms / 1e3),
                    "audio_s_per_s": samples / 16000 / (ms / 1e3)}
        log(f"featurize {ft}: {N_CORPUS} utterances in {ms / 1e3:.2f} s")
        del store
        sub = dict(list(corpus.items())[:N_FEAT_PROFILE])
        info[ft]["profile"] = {"utterances": N_FEAT_PROFILE, **path_profile(
            lambda: featurize_corpus(sub, ft, include_gemaps=False, device=DEV))}

    small = {f"s{i}": (speechlike(rng, int(rng.uniform(*CORPUS_S) * 16000)) * 20000
                       ).astype(np.int16) for i in range(N_FEAT_CPU)}
    for ft in ("mel_spec", "mfcc"):
        gpu = featurize_corpus(small, ft, include_gemaps=False, device=DEV)
        info[ft].update(hold_store(gpu, small, ft, "featurize"))
    info["cpu_check_utterances"] = N_FEAT_CPU

    chunk = next((W, ns) for ids, W, _, ns in
                 FN.chunked_wave_batches(corpus, 8000, 64, FN.n_frames)
                 if W.shape == (64, 64000))
    return info, launches, chunk, corpus


def fused_mfcc_phase(rng):
    """fused_mfcc, the counterpart of pallas_mfcc, on N_FEAT_CPU seeded
    utterances in each mel mode: f32 through the f32 mel and floor + DCT
    kernels, bf16 through the bf16 mel and floor + DCT kernels; each against
    the CPU path (f32 as the featurized MFCC, bf16 as the bf16 mel's bounds
    through the DCT's gain)."""
    from sept_tpu_torch.ops.frontend import create_dct
    from sept_tpu_torch.ops.mfcc import fused_mfcc

    n_fft, hop = 400, MFCC_HOP
    lengths = rng.integers(int(CORPUS_S[0] * 16000), int(CORPUS_S[1] * 16000) + 1, N_FEAT_CPU)
    rows = [np.pad(speechlike(rng, int(n)), n_fft // 2, mode="reflect") for n in lengths]
    padded = np.zeros((N_FEAT_CPU, max(len(r) for r in rows)), np.float32)
    for i, r in enumerate(rows):
        padded[i, : len(r)] = r
    t = (padded.shape[1] - n_fft) // hop + 1
    gain = float(np.abs(create_dct(40, N_MELS)).sum(0).max())
    info, launches = {"utterances": N_FEAT_CPU, "frames": t}, {}
    for bf16, mel_kernel, other in ((False, "mel_db", "mel_db_bf16"),
                                    (True, "mel_db_bf16", "mel_db")):
        mode = "bf16" if bf16 else "f32"
        gpu, launches[f"fused_mfcc_{mode}"], _ = drive(
            lambda: fused_mfcc(padded, t, bf16=bf16, device=DEV),
            must=(mel_kernel, "floor_dct"), must_not=(other,) + BACKWARD + BLOCK1_BF16)
        require(gpu.shape == (N_FEAT_CPU, t, 40), f"fused_mfcc {mode}: shape {gpu.shape}")
        d = (gpu.cpu() - fused_mfcc(padded, t, bf16=bf16, device="cpu")).abs().flatten()
        mx, p99 = float(d.max()), float(np.percentile(d.numpy(), 99))
        log(f"fused_mfcc {mode}: max |gpu - cpu| {mx:.3g}, p99 {p99:.3g}")
        if bf16:
            require(mx <= gain * BF16_MAX and p99 <= gain * BF16_P99,
                    f"fused_mfcc bf16: GPU and CPU differ by {mx} (p99 {p99})")
        else:
            require(mx <= FEAT_TOL["mfcc"], f"fused_mfcc f32: GPU and CPU differ by {mx}")
        info[mode] = {"max_abs_diff_vs_cpu": mx, "p99_abs_diff_vs_cpu": p99}
    return info, launches


def bench_ingest_waves():
    """bench.py's ingest workload: N_INGEST int16 utterances of 2.5 s
    (a tone at 120-430 Hz over noise, seed 8), 16 speakers, 4 labels."""
    rng = np.random.default_rng(8)
    t = np.arange(int(2.5 * 16000)) / 16000
    waves = [np.clip(np.rint((0.3 * np.sin(2 * np.pi * (120 + 10 * (i % 32)) * t)
                              + 0.05 * rng.standard_normal(t.shape)) * 32768.0),
                     -32768, 32767).astype(np.int16) for i in range(N_INGEST)]
    spk = (np.arange(N_INGEST) % 16).astype(np.int32)
    labels = (np.arange(N_INGEST) % 4).astype(np.int32)
    return waves, spk, labels


def ingest_bf16_phase(sds):
    """bench.py's ingest through device_ingest with frontend "xla" (the f32
    mel kernel) and "pallas_bf16" (the bf16 one), each mode alone; windows
    within the JAX package's hardware bound; both timed with CUDA events and
    profiled; then one baseline epoch on the bf16 windows."""
    from sept_tpu_torch.data.device_pipeline import device_ingest
    from sept_tpu_torch.data.prep import prepare_waves
    from sept_tpu_torch.train.config import preset
    from sept_tpu_torch.train.optim import make_optimizer
    from sept_tpu_torch.train.steps import init_state, make_epoch_runner

    waves, spk, labels = bench_ingest_waves()
    ingest = {f: (lambda f=f: device_ingest(waves, spk, labels, labels % 2, n_fft=N_FFT,
                                            n_mels=N_MELS, win_len=WIN, shift_len=SHIFT,
                                            frontend=f, device=DEV))
              for f in ("xla", "pallas_bf16")}
    launches = {}
    ds_x, launches["ingest_xla"], _ = drive(
        ingest["xla"], must=("mel_db",),
        must_not=("mel_db_bf16", "floor_dct") + BACKWARD + BLOCK1_BF16)
    ds_b, launches["ingest_bf16"], _ = drive(
        ingest["pallas_bf16"], must=("mel_db_bf16",),
        must_not=("mel_db", "floor_dct") + BACKWARD + BLOCK1_BF16)
    require(ds_b.windows.shape == ds_x.windows.shape, "bf16 ingest shape")
    require(bool(torch.isfinite(ds_b.windows).all()), "non-finite bf16 windows")
    d = (ds_b.windows - ds_x.windows).abs().flatten().cpu().numpy()
    p99 = float(np.percentile(d, 99))
    log(f"ingest bf16 vs xla windows: p99 |diff| {p99:.3g}, max {float(d.max()):.3g}")
    require(p99 < INGEST_BENCH_P99, f"bf16 ingest windows off the f32 ones: p99 {p99}")
    # the JAX package's own hardware check of the mode, on its inputs
    rng = np.random.default_rng(3)
    white = [rng.standard_normal(24000).astype(np.float32) for _ in range(8)]
    w_spk = np.arange(8) % 4
    w_a, w_b = (device_ingest(white, w_spk, w_spk, w_spk % 2, n_mels=N_MELS, win_len=100,
                              shift_len=25, frontend=f, device=DEV).windows
                for f in ("xla", "pallas_bf16"))
    white_p99 = float(np.percentile((w_b - w_a).abs().flatten().cpu().numpy(), 99))
    log(f"ingest bf16 vs xla on the JAX hardware test's white noise: p99 {white_p99:.3g}")
    require(white_p99 < INGEST_P99, f"bf16 ingest off the f32 one on white noise: {white_p99}")
    info = {"utterances": N_INGEST, "utterance_s": 2.5, "speakers": 16,
            "windows": list(ds_b.windows.shape), "p99_abs_diff_vs_xla": p99,
            "max_abs_diff_vs_xla": float(d.max()), "white_noise_p99_abs_diff": white_p99,
            "xla_ms": cuda_ms(ingest["xla"], iters=3, warmup=1),
            "pallas_bf16_ms": cuda_ms(ingest["pallas_bf16"], iters=3, warmup=1),
            "profile": {f: path_profile(fn) for f, fn in ingest.items()}}

    cfg = preset("baseline")
    m = backbone(sds[0])
    state = init_state(m, make_optimizer(cfg, T_BATCHES, m), SEED, DEV)
    valid = torch.nonzero(ds_b.weight > 0)[:, 0]
    g = torch.Generator(device=valid.device).manual_seed(SEED + 12)
    order = valid[torch.randperm(len(valid), generator=g, device=valid.device)]
    out, launches["train_bf16_windows"], ms = drive(
        lambda: make_epoch_runner()(state, ds_b.windows, ds_b.labels_emo, ds_b.weight,
                                    order[:T_BATCH * T_BATCHES], n_batches=T_BATCHES,
                                    batch_size=T_BATCH),
        must=("block1_conv_stats", "block1_norm_pool", "block1_route", "block1_weight_grads"),
        must_not=("block1_input_grad", "mel_db", "mel_db_bf16", "floor_dct") + BLOCK1_BF16)
    losses = out[1].cpu().numpy()
    require(np.isfinite(losses).all(), f"baseline on bf16 windows: losses {losses}")
    info["baseline_epoch"] = {"losses": losses.tolist(), "epoch_wall_ms": ms,
                              "batch": T_BATCH, "batches": T_BATCHES}
    padded = torch.from_numpy(prepare_waves(waves, N_FFT)[0]).to(DEV)
    return info, launches, padded, ds_b


def bf16_mel_errors(k, p):
    d = (k - p).abs().flatten()
    return float(d.max()), float(np.percentile(d.cpu().numpy(), 99))


def featurize_kernel_phase(padded, chunk, launches):
    """The bf16 mel kernel on the bf16 ingest's waves and the floor + DCT
    kernel on one mfcc chunk's rows, against their plain versions, then
    timed beside the plain version, one PyTorch yardstick and the bound."""
    from sept_tpu_torch.data.featurize import mfcc_mel_and_floor
    from sept_tpu_torch.ops import frontend as F
    from sept_tpu_torch.ops import mel as M
    from sept_tpu_torch.ops import mfcc as MF

    with torch.inference_mode():
        x = F.pcm_to_float(padded)
        bsz, length = x.shape
        t = (length - N_FFT) // HOP + 1
        mel_k = M.mel_db_bf16(x, t, N_FFT, HOP, N_MELS)
        mel_p = M.mel_db_plain(x, t, N_FFT, HOP, N_MELS, bf16=True)
        W, ns = chunk
        rows_mel, floor, _ = mfcc_mel_and_floor(torch.from_numpy(W).to(DEV),
                                                torch.from_numpy(ns).to(DEV))
        dct = MF.dct_basis(40, 128, rows_mel.device)
        fd_k = MF.floor_dct(rows_mel, floor, dct)
        fd_p = MF.floor_dct_plain(rows_mel, floor, dct)
        torch.cuda.synchronize()
        mel_max, mel_p99 = bf16_mel_errors(mel_k, mel_p)
        fd_abs = float((fd_k - fd_p).abs().max())
        fd_rel = fd_abs / float(fd_p.abs().max())
        log(f"mel_db_bf16: max {mel_max:.3g} dB, p99 {mel_p99:.3g}; floor_dct: "
            f"{fd_abs:.3g} ({fd_rel:.3g} of max |plain|)")
        require(mel_max <= BF16_MAX and mel_p99 <= BF16_P99,
                f"mel_db_bf16 disagrees with its plain version: {mel_max}, {mel_p99}")
        require(fd_rel <= FLOOR_DCT_RTOL, f"floor_dct disagrees with its plain version: {fd_rel}")

        rows, n_mels = rows_mel.shape
        fd_bound = bound(rows * (n_mels + 2 * n_mels * 40),
                         4.0 * (rows * n_mels + rows + n_mels * 40 + rows * 40))
        specs = [
            ("mel_db_bf16", "sept_tpu_torch/csrc/mel.cu", "sept_tpu/ops/pallas_frontend.py:54",
             lambda: M.mel_db_bf16(x, t, N_FFT, HOP, N_MELS),
             lambda: M.mel_db_plain(x, t, N_FFT, HOP, N_MELS, bf16=True),
             lambda: stft_chain(x, N_FFT, HOP), mel_bound(bsz, length, bsz * t, N_FFT), mel_max),
            ("floor_dct", "sept_tpu_torch/csrc/mfcc.cu", "sept_tpu/ops/pallas_frontend.py:164",
             lambda: MF.floor_dct(rows_mel, floor, dct),
             lambda: MF.floor_dct_plain(rows_mel, floor, dct),
             lambda: torch.matmul(torch.maximum(rows_mel, floor[:, None]), dct),
             fd_bound, fd_abs),
        ]
        kernels = []
        for name, src, replaces, kern, plain, lib, (bound_ms, bound_by), err in specs:
            kernels.append({
                "name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": sum(p[name] for p in launches.values()),
                "launches_by_path": {k: p[name] for k, p in launches.items()},
                "max_abs_err": err, "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain),
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": cuda_ms(lib),
                "device_ms": device_ms(kern), "library_device_ms": device_ms(lib)})
        f32_kernel = lambda: M.mel_db(x, t, N_FFT, HOP, N_MELS)  # noqa: E731
        kernels[0].update({"p99_abs_err": mel_p99,
                           "f32_kernel_ms_same_input": cuda_ms(f32_kernel, iters=5),
                           "f32_kernel_device_ms_same_input": device_ms(f32_kernel, iters=5),
                           "bound_mma_ms": mel_bound_mma(bsz * t, N_FFT),
                           "bound_counts": "rFFT 2.5 n log2 n + sparse mel bank; "
                                           "bound_mma_ms: the dense DFT products its bf16 "
                                           "tables fix + the bank's nonzeros, at the "
                                           "bf16 tensor-core peak",
                           "library": "torch.stft + matmul + log10 (f32)",
                           "shape": [bsz, length, t]})
        kernels[1].update({"max_rel_err_of_max_abs": fd_rel, "shape": [rows, n_mels, 40],
                           "library": "torch.maximum + torch.matmul"})
    return kernels


def stft_chain(x, n_fft, hop, n_mels=N_MELS):
    """The library yardstick of the f32 mel kernel: torch.stft (cuFFT) +
    power + matmul with the bank + log10, the same function."""
    from sept_tpu_torch.ops import mel as M

    window, _, _, fb = M._tables(n_fft, n_mels, x.device)
    spec = torch.stft(x, n_fft, hop, window=window, center=False, return_complex=True)
    power = spec.real * spec.real + spec.imag * spec.imag
    return 10.0 * torch.log10(torch.clamp(power.transpose(1, 2) @ fb, min=M.AMIN))


def bank_nnz(n_fft, n_mels):
    """The nonzeros of the frontend's mel filterbank."""
    from sept_tpu_torch.ops import frontend as F

    return int((F.melscale_fbanks(n_fft // 2 + 1, 0.0, 8000.0, n_mels, 16000) != 0).sum())


def mel_bound(bsz, length, frames, n_fft, n_mels=N_MELS):
    """The least work of the mel function: a real FFT (2.5 n log2 n, the
    usual count), window, power, the sparse bank and the log; bytes: waves
    in, window and bank, dB out."""
    fb_nnz = bank_nnz(n_fft, n_mels)
    return bound(frames * (2.5 * n_fft * np.log2(n_fft) + n_fft + 3 * (n_fft // 2 + 1)
                           + 2 * fb_nnz + n_mels),
                 4.0 * (bsz * length + n_fft + fb_nnz + frames * n_mels))


def mel_bound_mma(frames, n_fft, n_mels=N_MELS):
    """The least time of the bf16 mel kernel's own work: the dense DFT
    products its bf16 tables fix and the bank's nonzero products (2 n_freq
    n_fft + the bank's nonzeros multiply-adds a frame), at the card's dense
    bf16 tensor-core rate, ms."""
    n_freq = n_fft // 2 + 1
    return frames * 2.0 * (2 * n_freq * n_fft + bank_nnz(n_fft, n_mels)) / PEAK_BF16_FLOPS * 1e3


def mel_featurize_phase(chunk):
    """The f32 mel kernel at featurize_corpus's shapes, on one chunk of 64
    utterances at its bucket length: mel_spec's mel1 (n_fft 800) and mel2
    (n_fft 1600) at hop 160, and the mfcc's three streams (wave and its two
    gradients, 192 rows) at n_fft 400, hop 200; each against its plain
    version (cell by cell, check_mel), timed beside the plain version, the
    torch.stft chain and the bound."""
    from sept_tpu_torch.data.featurize import _padded_gradient, device_reflect_pad
    from sept_tpu_torch.ops import frontend as F
    from sept_tpu_torch.ops import mel as M

    W, ns = chunk
    rows = []
    with torch.inference_mode():
        w = F.pcm_to_float(torch.from_numpy(W).to(DEV))
        n = torch.from_numpy(ns).to(DEV)
        streams = torch.cat([device_reflect_pad(s, n, 200) for s in (
            w, _padded_gradient(w, n, 1.0), _padded_gradient(w, n, 2.0))])
        for what, x, n_fft, hop in (
                ("featurize mel1", device_reflect_pad(w, n, 400), 800, HOP),
                ("featurize mel2", device_reflect_pad(w, n, 800), 1600, HOP),
                ("featurize mfcc streams", streams, 400, MFCC_HOP)):
            t = 1 + w.shape[1] // hop
            k = M.mel_db(x, t, n_fft, hop, N_MELS)
            p = M.mel_db_plain(x, t, n_fft, hop, N_MELS)
            c = check_mel(k, p, x, t, n_fft, hop, what)
            bound_ms, bound_by = mel_bound(x.shape[0], x.shape[1], x.shape[0] * t, n_fft)
            rows.append({
                "what": what, "shape": [x.shape[0], x.shape[1], t], "n_fft": n_fft, "hop": hop,
                "max_abs_err": c["max_abs_vs_plain"], "check_vs_f64": c,
                "ms": cuda_ms(lambda: M.mel_db(x, t, n_fft, hop, N_MELS)),
                "device_ms": device_ms(lambda: M.mel_db(x, t, n_fft, hop, N_MELS)),
                "plain_ms": cuda_ms(lambda: M.mel_db_plain(x, t, n_fft, hop, N_MELS)),
                "library_ms": cuda_ms(lambda: stft_chain(x, n_fft, hop)),
                "library_device_ms": device_ms(lambda: stft_chain(x, n_fft, hop)),
                "bound_ms": bound_ms, "bound_by": bound_by})
            log(f"mel_db, {what}: {rows[-1]}")
    return rows


def featurize_edge_phase(device):
    """Both kernels at shapes off the main path: the bf16 mel at
    BF16_MEL_EDGES, floor + DCT at FLOOR_DCT_EDGES, each launching, held to
    1e-5 of max |plain| and timed beside its plain version."""
    from sept_tpu_torch.ops import mel as M
    from sept_tpu_torch.ops import mfcc as MF

    g = torch.Generator(device=device).manual_seed(SEED + 13)
    worst = {"mel_db_bf16": 0.0, "mel_db_bf16_p99": 0.0, "floor_dct_rel": 0.0}
    with torch.inference_mode():
        for b, n_fft, hop, t, n_mels in BF16_MEL_EDGES:
            x = 0.3 * torch.randn(b, (t - 1) * hop + n_fft + 33, device=device, generator=g)
            mx, p99 = bf16_mel_errors(M.mel_db_bf16(x, t, n_fft, hop, n_mels),
                                      M.mel_db_plain(x, t, n_fft, hop, n_mels, bf16=True))
            worst["mel_db_bf16"] = max(worst["mel_db_bf16"], mx)
            worst["mel_db_bf16_p99"] = max(worst["mel_db_bf16_p99"], p99)
        worst["floor_dct_edges"] = []
        for rows, n_mels, n_mfcc, misaligned in FLOOR_DCT_EDGES:
            flat = 20 * torch.randn(rows * n_mels + 1, device=device, generator=g) - 40
            mel = (flat[1:] if misaligned else flat[:-1]).view(rows, n_mels)
            floor = 10 * torch.randn(rows, device=device, generator=g) - 60
            dct = MF.dct_basis(n_mfcc, n_mels, torch.device(device))
            before = MF.floor_dct.launches
            k = MF.floor_dct(mel, floor, dct)
            require(MF.floor_dct.launches == before + 1,
                    f"floor_dct did not launch at {(rows, n_mels, n_mfcc, misaligned)}")
            p = MF.floor_dct_plain(mel, floor, dct)
            rel = float((k - p).abs().max() / p.abs().max())
            worst["floor_dct_edges"].append({
                "rows": rows, "n_mels": n_mels, "n_mfcc": n_mfcc, "misaligned": misaligned,
                "max_rel_err_of_max_abs": rel,
                "device_ms": device_ms(lambda: MF.floor_dct(mel, floor, dct)),
                "plain_device_ms": device_ms(lambda: MF.floor_dct_plain(mel, floor, dct))})
            worst["floor_dct_rel"] = max(worst["floor_dct_rel"], rel)
    require(worst["mel_db_bf16"] <= BF16_MAX and worst["mel_db_bf16_p99"] <= BF16_P99,
            f"mel_db_bf16 disagrees with its plain version at edge shapes: {worst}")
    require(worst["floor_dct_rel"] <= FLOOR_DCT_RTOL,
            f"floor_dct disagrees with its plain version at edge shapes: {worst}")
    return worst


def norm_pool_edge_phase(device):
    """K2 in both modes against its plain version at K2_EDGES, bit for bit,
    each call launching (runs of 16-byte vectors or the per-cell path, as
    the width and the alignment allow)."""
    from sept_tpu_torch.ops import conv_block1 as K

    g = torch.Generator(device=device).manual_seed(SEED + 22)
    rows = []
    with torch.inference_mode():
        for cd in (torch.float32, torch.bfloat16):
            attr, run = ("launches_bf16", 8) if cd == torch.bfloat16 else ("launches", 4)
            for b, h, w, misaligned in K2_EDGES:
                n = b * 32 * h * w
                flat = torch.randn(n + 1, device=device, generator=g).to(cd)
                y = (flat[1:] if misaligned else flat[:n]).view(b, 32, h, w)
                scale = 1 + 0.1 * torch.randn(32, device=device, generator=g)
                shift = 0.1 * torch.randn(32, device=device, generator=g)
                before = getattr(K.block1_norm_pool, attr)
                k = K.block1_norm_pool(y, scale, shift, cd)
                launched = getattr(K.block1_norm_pool, attr) - before
                p = K.block1_norm_pool_plain(y, scale, shift, cd)
                rows.append({"mode": str(cd).split(".")[-1], "shape": [b, 32, h, w],
                             "misaligned": misaligned,
                             "runs": not misaligned and w % (2 * run) == 0,
                             "max_abs_err": float((k.float() - p.float()).abs().max())})
                require(launched == 1 and k.dtype == cd and rows[-1]["max_abs_err"] == 0.0,
                        f"block1_norm_pool is not bit-equal to its plain version: {rows[-1]}")
    return {"block1_norm_pool_edges": rows}


# ---------------------------------------------------------------------------
# data parallelism


def dp_state(case, sds, device, group=None):
    """The seeded state of a dp phase epoch (dropout 0, lr DP_LR): the
    baseline (``compute_dtype`` bf16 for "baseline_bf16") or the cloak + GRL
    game (antithetic pair), the trained backbone with sync-BN over
    ``group``; and its epoch runner's options."""
    from sept_tpu_torch.models import CloakedModelGRL, compute_dtype
    from sept_tpu_torch.train.config import preset
    from sept_tpu_torch.train.optim import make_cloak_optimizer, make_optimizer
    from sept_tpu_torch.train.steps import init_state

    emo_sd, gen_sd = sds
    if case != "cloak_grl":
        cfg = preset("baseline", learning_rate=DP_LR,
                     compute_dtype="bfloat16" if case.endswith("bf16") else "float32")
        m = backbone(emo_sd, dropout=0.0, cd=compute_dtype(cfg.compute_dtype), group=group)
        return init_state(m, make_optimizer(cfg, T_BATCHES, m), SEED, device), {}
    cfg = preset("cloak_grl", learning_rate=DP_LR, antithetic_noise=True)
    m = CloakedModelGRL(backbone(emo_sd, dropout=0.0),
                        backbone(gen_sd, "gender", dropout=0.0, group=group), cfg.grl_lambda,
                        WIN, N_MELS, cfg.noise_min_scale, cfg.noise_max_scale)
    opt = make_cloak_optimizer(cfg, T_BATCHES, m, ("noise", "gender_backbone"))
    return init_state(m, opt, SEED + 2, device), {
        "grl": True, "scale_lambda": cfg.scale_lambda, "gender_lambda": cfg.gender_lambda,
        "antithetic": True}


def dp_epoch(case, data, sds, device, batches, group=None):
    """One epoch of ``batches`` (batch size, count) of ``case`` on ``data``
    (windows, labels_emo, labels_gen, weights, in order), data-parallel over
    ``group`` or in one process: (losses, state after, wall ms)."""
    from sept_tpu_torch.parallel import make_cloak_epoch_runner_dp, make_epoch_runner_dp
    from sept_tpu_torch.train.steps import make_cloak_epoch_runner, make_epoch_runner

    state, opts = dp_state(case, sds, device, group)
    windows, le, lg, w = (t.to(device) for t in data)
    order = torch.arange(len(w), device=device)
    kw = {"batch_size": batches[0], "n_batches": batches[1]}
    if opts:
        run = (make_cloak_epoch_runner(**opts) if group is None
               else make_cloak_epoch_runner_dp(group, **opts))
        call = lambda: run(state, windows, le, lg, w, order, None, **kw)  # noqa: E731
    else:
        run = make_epoch_runner() if group is None else make_epoch_runner_dp(group)
        call = lambda: run(state, windows, le, w, order, **kw)  # noqa: E731
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = call()[1]
    if cuda:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return losses.cpu().numpy(), {k: v.cpu() for k, v in state.model.state_dict().items()}, ms


def dp_rank(group, data, sds, cases, batches):
    """A spawned rank of the dp phase: each case's epoch with every launch
    count set to 0 just before and read just after; its losses, state,
    wall, launches and all-reduces."""
    counters = kernel_counters()
    out = {}
    for case in cases:
        for f, attr in counters.values():
            setattr(f, attr, 0)
        calls, seconds = group.calls, group.seconds
        losses, state, ms = dp_epoch(case, data, sds, group.device, batches, group)
        out[case] = {"losses": losses, "state": state, "ms": ms,
                     "launches": {name: getattr(f, attr) for name, (f, attr) in counters.items()},
                     "all_reduces": group.calls - calls,
                     "all_reduce_ms": (group.seconds - seconds) * 1e3}
    return out


def check_launches(launches, must, must_not, what):
    for name in must:
        require(launches[name] > 0, f"{what}: kernel {name} never launched: {launches}")
    for name in must_not:
        require(launches[name] == 0, f"{what}: kernel {name} launched: {launches}")


def dp_hold(what, ranks, one, tol):
    """Hold the ranks' epoch to the one-process epoch: losses within
    tol["loss"] relative, parameters and running statistics within
    tol["param"] / tol["stats"] of max(|p|, 1); and the ranks to each other,
    bit for bit."""
    losses, state = one
    loss_rel = float(np.max(np.abs(ranks[0]["losses"] - losses) / np.abs(losses)))
    diffs = state_diffs(ranks[0]["state"], state)
    log(f"dp {what}: losses {losses.tolist()}, max rel loss diff {loss_rel:.3g}, max diff "
        f"of max(|p|, 1): {diffs}")
    require(loss_rel <= tol["loss"] and all(d <= tol[k] for k, d in diffs.items()),
            f"dp {what}: the ranks and one process disagree ({loss_rel}, {diffs})")
    for r in ranks[1:]:
        require(all(torch.equal(v, ranks[0]["state"][k]) for k, v in r["state"].items())
                and np.array_equal(r["losses"], ranks[0]["losses"]),
                f"dp {what}: the ranks' states differ")
    return {"losses_one_process": losses.tolist(), "max_rel_loss_diff": loss_rel,
            "max_param_diff_of_max_abs": diffs["param"],
            "max_running_stat_diff_of_max_abs": diffs["stats"], "tolerance": tol}


def dp_phase(ds, order, sds):
    """DP_RANKS ranks on card 0 over gloo (NCCL refuses two ranks on one
    card), one epoch each of DP_CASES at full width on the training phase's
    first T_BATCH * T_BATCHES windows, held to the same epoch in one
    process; on a machine of two cards or more, the baseline also on two
    cards over NCCL.  Returns (info, launches by path: both ranks')."""
    from sept_tpu_torch.parallel import spawn

    data = tuple(t[order].cpu() for t in (ds.windows, ds.labels_emo, ds.labels_gen,
                                          ds.weight))
    sds = tuple({k: v.cpu() for k, v in sd.items()} for sd in sds)
    t0 = time.perf_counter()
    batches = (T_BATCH, T_BATCHES)
    ranks = spawn(dp_rank, (torch.device(DEV, 0) if DEV == "cuda" else "cpu",) * DP_RANKS,
                  data, sds, tuple(DP_CASES), batches, backend="gloo",
                  deadline_s=DP_DEADLINE_S)
    info = {"backend": "gloo", "ranks_on_one_card": DP_RANKS,
            "spawn_and_epochs_wall_s": time.perf_counter() - t0,
            "batch": T_BATCH, "per_rank_batch": T_BATCH // DP_RANKS, "batches": T_BATCHES,
            "learning_rate": DP_LR, "dropout": 0.0}
    launches = {}
    for case, (dtype, must, must_not) in DP_CASES.items():
        tol = TRAIN_BF16_TOL if dtype == "bfloat16" else TRAIN_F32_TOL
        (losses, state, ms), one_launches, _ = drive(
            lambda: dp_epoch(case, data, sds, DEV, batches), must, must_not)
        for r, rank in enumerate(ranks):
            check_launches(rank[case]["launches"], must, must_not, f"dp {case} rank {r}")
        launches[f"dp_{case}"] = {k: sum(rank[case]["launches"][k] for rank in ranks)
                                  for k in one_launches}
        r0 = ranks[0][case]
        info[case] = {**dp_hold(case, [rank[case] for rank in ranks], (losses, state), tol),
                      "losses": r0["losses"].tolist(), "epoch_wall_ms_one_process": ms,
                      "epoch_wall_ms_ranks": [rank[case]["ms"] for rank in ranks],
                      "all_reduces_per_step": r0["all_reduces"] / T_BATCHES,
                      "all_reduce_wall_ms_per_step": r0["all_reduce_ms"] / T_BATCHES,
                      "block1_launches_per_step_per_rank": {
                          k: v / T_BATCHES for k, v in r0["launches"].items() if v}}
    if DEV == "cuda" and torch.cuda.device_count() >= 2:
        dtype, must, must_not = DP_CASES["baseline"]
        nccl = spawn(dp_rank, (torch.device("cuda", 0), torch.device("cuda", 1)), data, sds,
                     ("baseline",), batches, backend="nccl", deadline_s=DP_DEADLINE_S)
        for r, rank in enumerate(nccl):
            check_launches(rank["baseline"]["launches"], must, must_not, f"dp nccl rank {r}")
        info["nccl"] = dp_hold("nccl baseline", [rank["baseline"] for rank in nccl],
                               dp_epoch("baseline", data, sds, DEV, batches)[:2],
                               TRAIN_F32_TOL)
        info["nccl"]["epoch_wall_ms_ranks"] = [rank["baseline"]["ms"] for rank in nccl]
    else:
        info["nccl"] = "not run: 1 card"
    return info, launches


def ptxas_summary(reports):
    lines = []
    for name, text in reports.items():
        fn = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                lines.append(f"{name}.cu {fn}: {line.split('ptxas info    :')[-1].strip()}")
    return lines


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a "
              "CUDA GPU", file=sys.stderr)
        return 1
    from sept_tpu_torch.ops import cuda_lib
    from sept_tpu_torch.runtime import wavio

    t0 = time.perf_counter()
    log(f"device {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    reports = cuda_lib.build()
    for line in ptxas_summary(reports):
        log(f"ptxas {line}")
    log(f"kernels built in {time.perf_counter() - t0:.1f} s; WAV decoder {wavio.build()}")
    log(f"build done in {time.perf_counter() - t0:.1f} s")

    weights = build_weights()
    gpu = make_predictor(weights, "cuda")
    reqs = make_requests(np.random.default_rng(SEED))
    answers, serve_launches, _ = drive(
        lambda: serve_phase(gpu, reqs), must=("mel_db", "block1_conv_stats", "block1_norm_pool"),
        must_not=BACKWARD + BLOCK1_BF16 + ("mel_db_bf16", "floor_dct"))
    paths = {"serve": serve_launches}
    log(f"served; kernel launches on the serving path: {serve_launches}")

    cpu = make_predictor(weights, "cpu")
    ref = reference_answers(cpu, reqs)
    for key, want in ref.items():
        diff = float(np.abs(answers[key] - want).max())
        log(f"{key}: max |gpu - cpu| probs = {diff:.3g}")
        require(diff <= PROBS_ATOL, f"{key}: GPU answers differ from the CPU port by {diff}")
    log(f"cpu reference done at {time.perf_counter() - t0:.1f} s")

    ds, paths["train_ingest"], ingest = train_ingest_phase(np.random.default_rng(SEED + 11))
    sds = train_weights()
    epochs, train_launches, order = train_phase(ds, sds)
    paths.update(train_launches)
    log(f"training epochs done at {time.perf_counter() - t0:.1f} s: {epochs}; "
        f"launches {train_launches}")
    train_cpu = train_cpu_phase(ds, order, sds)
    log(f"train-cpu done at {time.perf_counter() - t0:.1f} s")
    feat, feat_launches, mfcc_chunk, corpus = featurize_phase(np.random.default_rng(SEED + 14))
    paths.update(feat_launches)
    feat["fused_mfcc"], mfcc_launches = fused_mfcc_phase(np.random.default_rng(SEED + 15))
    paths.update(mfcc_launches)
    log(f"featurize done at {time.perf_counter() - t0:.1f} s: {feat}")
    ingest_b, ingest_launches, ingest_padded, ds_bf16 = ingest_bf16_phase(sds)
    paths.update(ingest_launches)
    log(f"ingest-bf16 done at {time.perf_counter() - t0:.1f} s: {ingest_b}")
    order_bf16 = bf16_order(ds_bf16)
    epochs_bf16, bf16_launches = train_bf16_phase(ds_bf16, order_bf16, sds)
    paths.update(bf16_launches)
    log(f"bf16 training epochs done at {time.perf_counter() - t0:.1f} s: {epochs_bf16}")
    train_cpu_bf16 = train_cpu_phase(ds_bf16, order_bf16, sds, "bfloat16", SALIENCY_ALIGN,
                                     TRAIN_BF16_TOL)
    log(f"train-cpu bf16 done at {time.perf_counter() - t0:.1f} s")
    dp, dp_launches = dp_phase(ds, order, sds)
    paths.update(dp_launches)
    log(f"dp done at {time.perf_counter() - t0:.1f} s: {dp}")
    fold, fold_launches, fold_csv = fold_phase(np.random.default_rng(SEED + 19))
    paths.update(fold_launches)
    log(f"fold done at {time.perf_counter() - t0:.1f} s")
    t_host = time.perf_counter()
    host, host_launches = host_loop_phase(np.random.default_rng(SEED + 29))
    host["phase_s"] = time.perf_counter() - t_host
    paths.update(host_launches)
    log(f"host_loop done at {time.perf_counter() - t0:.1f} s")
    cli, cli_launches, artifacts, art_launches = cli_phase(np.random.default_rng(SEED + 23))
    paths.update(cli_launches)
    paths.update(art_launches)
    log(f"cli and artifacts done at {time.perf_counter() - t0:.1f} s: {artifacts}")
    glob, glob_launches = global_phase(corpus)
    del corpus
    paths.update(glob_launches)
    log(f"global done at {time.perf_counter() - t0:.1f} s")

    kernels, block1, shapes = kernel_phase(gpu, reqs[0], paths)
    kernels[0]["featurize_shapes"] = mel_featurize_phase(mfcc_chunk)
    train_kernels, block1_train = train_kernel_phase(capture_block1(ds, order, sds), paths)
    kernels += train_kernels
    kernels += featurize_kernel_phase(ingest_padded, mfcc_chunk, paths)
    bf16_kernels, block1_bf16 = train_bf16_kernel_phase(
        capture_block1(ds_bf16, order_bf16, sds, "bfloat16"), paths)
    kernels += bf16_kernels
    for k in kernels:
        if isinstance(k["device_ms"], float):
            k["bound_share_of_device_ms"] = k["bound_ms"] / k["device_ms"]
            if "bound_mma_ms" in k:
                k["bound_mma_share_of_device_ms"] = k["bound_mma_ms"] / k["device_ms"]
    log(f"kernel checks done at {time.perf_counter() - t0:.1f} s; shapes {shapes}")
    edges = edge_phase(gpu.device)
    kernels[0]["any_n_fft"] = edges.pop("mel_db_any_n_fft")
    edges.update(train_edge_phase(gpu.device))
    edges.update(featurize_edge_phase(gpu.device))
    edges.update(train_bf16_edge_phase(gpu.device))
    edges.update(norm_pool_edge_phase(gpu.device))
    kernels[0]["wide_banks"] = edges.pop("mel_db_wide")
    next(k for k in kernels if k["name"] == "floor_dct")["edges"] = edges.pop("floor_dct_edges")
    log(f"edge-shape checks: {edges}")
    latency = latency_phase(gpu, np.random.default_rng(SEED + 7))
    log(f"latency done at {time.perf_counter() - t0:.1f} s")
    prof = {str(n): profile_phase(gpu, np.random.default_rng(SEED + 8), n=n) for n in (1, 8)}
    train_prof = train_profile_phase(ds, order, sds)
    bf16_prof = train_profile_phase(ds_bf16, order_bf16, sds, dtype="bfloat16",
                                    saliency=SALIENCY_ALIGN)
    gru = gru_phase(sds[0])
    log(f"profile done at {time.perf_counter() - t0:.1f} s")

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    lines = [{"block1_eval": block1}, {"latency_ms": latency}, {"profile": prof},
             {"train": {"ingest": ingest, "epochs": epochs, "train_cpu": train_cpu,
                        "edge_errors": edges, "launches_by_path": paths}},
             {"block1_train": block1_train}, {"train_profile": train_prof},
             {"featurize": feat}, {"ingest_bf16": ingest_b}, {"train_bf16": {
        "epochs": epochs_bf16, "f32_baseline_epoch_same_windows": ingest_b["baseline_epoch"],
        "f32_epochs": epochs, "train_cpu": train_cpu_bf16, "profile": bf16_prof,
        "f32_profile": {k: {m: v[m] for m in ("wall_ms_per_step", "device_busy_ms_per_step",
                                              "device_idle_share", "device_launches_per_step")}
                        for k, v in train_prof.items()},
        "block1_fwd_bwd": block1_bf16, "gru": gru,
        "launches_by_path": {k: v for k, v in paths.items() if k.startswith("train_bf16")}}},
             {"dp": {**dp, "launches_by_path": dp_launches, "card": smi}},
             {"fold": {**fold, "csv": fold_csv, "launches_by_path": fold_launches}},
             {"cli": {**cli, "card": smi}}, {"artifacts": {**artifacts, "card": smi}},
             {"global": {**glob, "card": smi}},
             {"host_loop": {**host, "launches_by_path": host_launches, "card": smi}},
             {"card": smi}, {"kernels": kernels}]
    # every result line also goes to a file, whole, where a caller that
    # keeps only the end of the output still finds them
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.jsonl").write_text("".join(json.dumps(v) + "\n" for v in lines))
    for v in lines[:-2]:
        print(json.dumps(v))
    print(smi)
    # last but one, so the end of the output always holds it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    log(f"done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
