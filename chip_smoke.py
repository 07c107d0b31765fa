#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path, train step and entry points
on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (none catches an exception; any failure exits non-zero):
  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
     the whole run is under the port's float32 policy (TF32 off);
  2. build the CUDA kernels from ``mdctgan_tpu_torch/csrc`` (one ``nvcc`` per
     source, all started together);
  3. K1 (MDCT + arcsinh + affine) against its plain PyTorch version on the
     card, normalized and raw, in float64 and in float32: the FFT form at
     n_fft 512 (T in {32512, 32000}, batch 1 and each main path's batch:
     8 serving, 16 generate, 20 train, and phase 12's 10 a rank and 4 a
     replica) and at n_fft 64, 128 and 2048
     (batch 2), and the dense form at n_fft 480, 960 and 200 (N/2 not a
     multiple of 8; T 24000, 60960, 24000) and at the ends of its range:
     4096 (T 16384, 9 frames a row), the largest N it takes on the card
     (``dense_max_n``, 5568 on an H100; 9 frames) and 32, at batches 2, 8,
     16 and 20; above the range, the ops refuse the next even N before any
     launch, and ``SpectralTransform`` at n_fft 8192 runs the matmul form
     (counted, no K1/K2 launch; its round trip within 1e-4).  The
     normalized f32 check runs on noise near full scale: on unit-variance
     noise the f32 plain version is itself ~5e-4 off float64.  For the
     dense form each normalized check also records its error against
     float64 beside the f32 plain version's and the 1xTF32 control's (the
     same kernel with hi x hi only, launched from here alone) on the same
     inputs, and holds it to ``DENSE_FACTOR`` (2) times the plain one's;
  4. K2 (denormalize + IMDCT + overlap-add) the same way (the dense form's
     record on the [-1, 1] spectrum), and a K1 -> K2 round trip at each
     n_fft;
  5. the flagship-width LocalEnhancer on the card against the same seeded
     weights on the CPU (batch 2, TF32 off), on its logits before the tanh,
     and a control reading of the same check with TF32 allowed;
  6. serving: three requests through ``api.upsample`` on the card, with the
     launch counts of every kernel read around them (the FFT forms must
     launch, the dense forms must not), and one request compared with the
     port on the CPU;
     6b. the bf16 policy (``fp16``): the flagship LocalEnhancer's bf16 logits
     on the card and on the CPU against the float64 generator (the card's
     error within ``BF16_FACTOR`` times the CPU's, by max and RMS), and the
     three requests again through a bf16 model, counted the same way;
  7. timings at each main path's batch (4, 8, 10, 16, 20) of each kernel (FFT
     and dense forms at n_fft 512; the dense forms at n_fft 960 at batches
     8, 16 and 20 and at 4096 at batch 8), its plain version and a library
     matmul yardstick, with
     the dense product's own bound in 3xTF32 (``dense_bound_ms``): as
     CUDA-graph replays timed by CUDA events (``ms``), as eager calls
     (``eager_ms``, which add the host's launch cost) and, for the
     kernels, as device time from ``torch.profiler`` (``device_ms``),
     beside the bound; a one-element add, the least time of a kernel node
     in a graph; the generator forward and end-to-end ``upsample``, in
     float32 and in bf16;
  8. training, through ``create_train_state`` and ``build_train_step`` at the
     flagship config: one SGD(lr=1) step (its update is the gradient) at
     batch 2 on the card against the same step on the CPU, from the same
     seeded weights, on white noise (the input form the JAX package's
     flagship bounds were measured on) with the CPU fed the card's spectra:
     losses 1e-3 relative, every gradient tensor within the JAX package's
     flagship bounds G 2.5e-2 / D 5e-3 normwise (floor 1e-3); control
     readings with each side on its own spectra and with TF32 allowed;
     the same step in bf16 on the card and on the CPU against the float64
     step, per top-level block and over the losses (the card within
     ``BF16_FACTOR`` times the CPU's error); 5 float32 and 10 bf16 steps of
     the flagship Adam at batch 20 on synthetic speech (finite losses, G
     and D move, K1 launched twice a step, every other kernel never), each
     followed by the step's median time over 20 steps, samples per second,
     peak memory, one step split into its parts by CUDA events, and the
     card's busy time, kernel records and top kernels per step from
     ``torch.profiler`` (with the share of cuDNN's FFT-tiled
     convolutions); a batch-20 step whose ``sample_mask`` keeps 13 rows
     against a batch-13 step;
  9. the generate entry point, ``generate_cli.main`` with
     ``generate_audio.sh``'s flags (``--fp16`` included): a reference-layout
     ``latest_net_G.pth`` of seeded flagship weights (the output head damped
     100x, so the SR stays within the WAVs' full scale as a trained model's
     does) and three synthetic-speech WAVs at 48 kHz (1.0, 2.2, 3.7 s) plus
     one file that cannot be decoded, in batch mode on the card: a strict
     load, 3 rows and ``MEAN`` in ``metrics.csv``, all finite but
     ``snr_seg``, the bad file skipped, K1 and K2 once per batch, the dense
     forms never; the 1.0 s file in float32 on the card and on the CPU
     (batch 2): its SR WAV within 2e-3 of its largest value, LSD 1e-3
     relative, each SNR 0.01 dB, MSE 1e-2 relative; the same file in bf16
     on the CPU against the card (read); the JAX package's default
     generator (``netG global``, transconv up) at batch 2 on the card
     against the CPU, within 5e-4 with a TF32 control reading; the
     batch-mode run in bf16 and in float32, each timed after a warm-up
     file, split into its set-up and each file by ``main`` itself; a second
     run at batch 8 (read); a 60 s file (6 batches) with ``api.IN_FLIGHT``
     1 (a synchronous loop) and 2, alternated, whose SR must be identical;
 10. the train entry point, ``train_cli.main`` with ``train.sh``'s flags
     (``--fp16`` included) on a corpus that ``tools/make_corpus.py`` writes
     (40 files of 2 s synthetic speech at 48 kHz, 36 to train, 4 to eval):
     first the input pipeline's degrade on the card against the CPU's on
     the same segments (TF32 off; TF32 allowed read as a control); then 3
     epochs of 2 steps (``TRAIN_CLI_FLAGS``): finite losses, its files,
     ``eval.csv``'s header and finite metrics, each epoch's learning rate
     the schedule's, K1 launched 2 times a step, once an eval batch and 3
     times a display, K2 once an eval batch and once a display, the dense
     forms never; ``generate_cli.main`` from that run's checkpoint (a
     strict load, K1 and K2 once); ``export_torch_cli.main`` on the
     checkpoint and ``generate_cli.main`` from the exported ``.pth``, whose
     SR is the checkpoint's within 2e-3 of its largest value; a
     ``--continue_train`` run that resumes at epoch 4 with the first run's
     last state, bit for bit (``checkpoint.state_digest``); 2 steps, a
     save, a restore into a fresh state and 2 steps on fixed batches
     against 4 steps (losses within 1e-3 relative; two uninterrupted runs'
     spread read); and the run's own split: set-up, each step's wall and
     ``next(pipeline)`` ms, the profiled step's device idle share, eval,
     checkpoint bytes, save ms blocking and in the background, peak
     memory, beside phase 8's bf16 step;
 11. the spectral modes and generator layouts beside the flagship's, each
     path driven with the kernels' and the matmul form's counts set to 0
     just before it: (a) ``train.sh``'s flags with ``--mask
     --n_blocks_attn_l 1``: a 3.7 s request through ``api.upsample`` in
     float32 and bf16 (K1 and K2 launch, the matmul form does not), card
     against CPU on the waveform (2e-3 of its largest value) and the
     logits (5e-4), one float32 SGD(1) step at batch 2 (losses 1e-3
     relative, the CPU fed the card's spectra), 10 bf16 steps at batch 20
     timed beside phase 8's flagship step; (b) ``generate_audio.sh``'s
     flags with ``--n_local_enhancers 2`` in float32, the same request
     and bounds, card against CPU on its first second; (c) ``generate_audio.sh``'s flags without
     ``--arcsinh_transform --abs_spectro --abs_norm --center`` (dB,
     per-sample min/max, no centring; ``--input_nc 1 --segment_length
     33024``): ``generate_cli.main`` on a 1.0 s file (the matmul form
     counted, K1/K2 never), card against CPU at one batch size so that
     both draw the same pseudo-phase signs, the request timed, and the
     matmul form's spectrum against float64 within 1e-5 (relative) under
     the policy, which TF32 must fail; (d) the explicit and raw modes at a
     small depth, one batch each, card against CPU stage by stage, each
     card stage fed the CPU's input (the spectrum, its normalization and
     the denormalization 1e-5 relative, the logits 5e-4, the IMDCT 1e-4
     relative; the end-to-end SR read);
 12. data parallelism on the one card, each path with the counts set to 0
     just before it: (a) ``train_cli.main`` with ``train.sh``'s flags, in
     bf16 and float32, 2 steps on phase 10's corpus (the second a masked
     tail of 16) and a save, as one ``--multihost`` rank over NCCL
     (torchrun's variables, world size 1) against the single-card run on
     the same batches: the first step's losses bit for bit, the second's
     within 10d's bounds (1e-3 float32, 2^-7 bf16; the card's backward
     does not repeat bit for bit), a second single-card run's distance
     read as the control; K1 twice a step;
     the bf16 step at batch 20 with and without the world-1 group in
     turns (the collectives' cost) and the host's agreement on a signal;
     (b) two ranks on the card over gloo (``parallel.mesh.spawn``), 10 + 10
     rows of a batch of 20 whose tail mask keeps 16, against one rank on
     the 20: the same state on both ranks, the losses within 1e-6 + 5e-5
     relative, the SGD(1) update within phase 8a's bound (the JAX bounds
     plus 2x the movement of the float64 step on the card between K1's
     spectra and the plain version's, at this batch); TF32 allowed read as
     the control; then 4 bf16 Adam steps a rank, timed; (c)
     ``api.upsample`` over two replicas on the card against one (2e-3 of
     the largest value; each replica launching K1 and K2 once a batch);
     (d) ``--gpu_ids 0,1`` refused by both CLIs on a host of one card;
 13. the flagship at n_fft 960 / hop 480 / win 960 / segment 60960 (a 20 ms
     window and 10 ms hop at 48 kHz; the dense forms' path), each path with
     the counts set to 0 just before it: (a) three ``api.upsample`` requests
     (1.0, 2.2, 3.7 s at 16 kHz, batch 8) in float32 and in bf16, each
     batch launching ``mdct_spectro_dense`` and ``imdct_audio_dense`` once
     and the FFT forms never, the float32 SR of the first against the port
     on the CPU (2e-3 of its largest value, phase 6's bound), the 3.7 s
     request timed in each precision (median of 5); (b) 3 bf16
     Adam steps at batch 20: finite losses, G and D move,
     ``mdct_spectro_dense`` twice a step and nothing else;
 14. the serving export (``export_cli``, K1 and K2 as the registered
     operators ``mdctgan::mdct_spectro``/``imdct_audio`` in the program),
     each path with the counts set to 0 just before it: (a) the flagship
     at full width and depth from a reference-layout ``.pth`` of seeded
     weights, exported on the card at batch 8 in float32 and with
     ``--fp16`` (seconds and bytes); a fresh process that imports torch
     and the op module and nothing else of the port (no model code, no
     JAX) serves the segments of three requests (1.0, 2.2, 3.7 s) through
     each program, one FFT-form K1 and K2 a call and the dense forms
     never, its SR held to ``model.inference`` on the card at phase 6's
     bound (the difference read: bit for bit expected); the float32
     program against the port on the CPU at phase 6's bound; the same
     program called with TF32 allowed and without ``serve_export``'s
     scope must move (its distance from the CPU read beside that bound);
     each program's operator nodes (read); each program's call
     against ``model.inference`` at batch 8, alternated, by CUDA events
     (median of 20 after 3 warm-ups); (b) the n_fft-480 program (hop
     240, segment 30480) at a reduced depth: ``mdct_spectro_dense`` and
     ``imdct_audio_dense`` once each a call, through the operators, the
     SR held to ``model.inference``; (c) the batch-8 program called at
     batch 4 and 16 raises; (d) the TF32 control that can fail: the f32
     program exported from the same weights with the head damped 100x
     (phase 9.1's), served scoped, within 8e-6 of the largest value of
     the port's SR on the CPU, and called with TF32 allowed and unscoped,
     past it; (e) one program for the card and the CPU: the f32 flagship
     exported on the card with ``--export_platforms tpu,cpu`` (its state
     saved on the CPU, no node naming the card, its bytes within 1% of
     the single-platform program's), served (i) by a fresh process on the
     card through ``load(path)``, one K1 and K2 a call, against
     ``model.inference`` on the card at phase 6's bound (bit for bit
     expected), and (ii) by a fresh process that sees no card
     (``CUDA_VISIBLE_DEVICES=""``) through ``load(path, device="cpu")``,
     no launch, against the port's ``model.inference`` on the CPU at the
     same bound, where (iii) ``load(path)`` raises; each load timed;
 15. the port's counterparts of the JAX tools beside its package, each
     path with the counts set to 0 just before it: (a)
     ``verify_import_cli`` on a reference-layout ``.pth`` of seeded
     flagship weights (head damped): with ``--forward`` on the card a
     strict OK, its imported generator's logits against
     ``api.create_model``'s at phase 5's bound (bit for bit expected);
     ``python -m mdctgan_tpu_torch.verify_import_cli`` with
     ``--n_blocks_global 3`` exits 1 naming the missing keys; (b)
     ``dryrun.entry()``'s fn against ``model.inference`` of the same seeded
     flagship, bit for bit, on the zero segment and on noise (K1 and K2
     once a call); (c) ``dryrun.dryrun_multichip(2)``, two gloo ranks
     sharing the card, held to one process as the JAX dry run holds its
     mesh (losses 1e-4, SGD(1) updates 2e-4 of the tree's movement).
Every result is one JSON line; a ``kernels`` line sums the kernels up
(``launches`` on the serving path, ``<path>_launches`` on each other path:
``serving_fp16``, ``train`` (float32), ``train_fp16``, ``generate`` and
``train_cli`` (both ``--fp16``), phase 11's ``local_attn_serving``,
``local_attn_train_fp16`` and ``two_enhancers_serving``, phase 12's
``dp_multihost_train_cli``, ``dp_two_ranks_train`` (both ranks) and
``dp_replicas_serving`` (both replicas), phase 13's ``n960_serving``,
``n960_serving_fp16`` and ``n960_train_fp16``, phase 14's
``export_serving`` and ``export_serving_fp16`` (the fresh process's),
``export_n480`` and ``export_serving_multi`` (14e (i)), phase 15's
``verify_import_forward``, ``entry`` and ``dryrun_ranks`` (both ranks of the dry run), phase 4's
``n8192_transform`` (no launch), and under
``paths`` each
path's n_fft, batch, launches and the kernel's numbers there; ``launches``
adds phase 6's serving to phase 13's, and the numbers are at batch 8 and
n_fft 512 for the FFT forms, 960 for the dense forms; ``checked_n`` the
worst error of phases 3-4 at each N, and for the dense forms ``n4096``
phase 7's numbers at N 4096) and the last line is
``{"ok": true, "device": {...}}``.  Without
CUDA, or run outside a checkout of the repository, it prints no result and
exits 2.
"""

from __future__ import annotations

import collections
import csv
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
MAIN_BATCH = 8  # api.upsample's batch of segments
TRAIN_BATCH = 20  # train.sh's batch
TRAIN_STEPS = {"f32": 5, "bf16": 10}  # phase 8's Adam steps in each precision
GAIN = 1000.0
# generate_audio.sh's flags, --fp16 (the bf16 policy) included
GENERATE_FLAGS = [
    "--fp16",
    "--lr_sampling_rate", "16000", "--sr_sampling_rate", "48000",
    "--batchSize", "16", "--nThreads", "1",
    "--arcsinh_transform", "--abs_spectro", "--arcsinh_gain", "1000", "--center",
    "--norm_range", "-1", "1", "--smooth", "0.0", "--abs_norm", "--src_range", "-5", "5",
    "--netG", "local", "--ngf", "56", "--niter", "40",
    "--n_downsample_global", "3", "--n_blocks_global", "4",
    "--n_blocks_attn_g", "3", "--dim_head_g", "128", "--heads_g", "6", "--proj_factor_g", "4",
    "--n_blocks_attn_l", "0", "--n_blocks_local", "3", "--gen_overlap", "0",
    "--fit_residual", "--upsample_type", "interpolate", "--downsample_type", "resconv",
    "--phase", "test",
]
GENERATE_BATCH = int(GENERATE_FLAGS[GENERATE_FLAGS.index("--batchSize") + 1])
# train.sh's flags, --fp16 included, then phase 10's depth and frequencies (in
# samples, 20 a step; 36 training files make 2 steps an epoch, the second a
# masked tail of 16): print every step, the step after the first profiled,
# eval and display at step 4, the latest saved at step 5, the end of epoch 3
# (step 6) saved with its epoch label, so a resume starts at epoch 4
TRAIN_CLI_FLAGS = [
    "--fp16", "--lr_sampling_rate", "16000", "--sr_sampling_rate", "48000",
    "--batchSize", "20", "--nThreads", "16", "--lr", "1.5e-4",
    "--arcsinh_transform", "--abs_spectro", "--arcsinh_gain", "1000", "--center",
    "--norm_range", "-1", "1", "--smooth", "0.0", "--abs_norm", "--src_range", "-5", "5",
    "--netG", "local", "--ngf", "56", "--n_downsample_global", "3", "--n_blocks_global", "4",
    "--n_blocks_attn_g", "3", "--dim_head_g", "128", "--heads_g", "6", "--proj_factor_g", "4",
    "--n_blocks_attn_l", "0", "--n_blocks_local", "3",
    "--fit_residual", "--upsample_type", "interpolate", "--downsample_type", "resconv",
    "--niter", "60", "--niter_decay", "60", "--num_D", "3",
    "--eval_freq", "32000", "--save_latest_freq", "16000", "--save_epoch_freq", "10",
    "--display_freq", "16000", "--tf_log",
] + [
    "--niter", "1", "--niter_decay", "2", "--save_epoch_freq", "3",
    "--print_freq", "20", "--display_freq", "80", "--eval_freq", "80",
    "--save_latest_freq", "100", "--profile_step", "1", "--profile_nsteps", "1",
]
CORPUS = ["--style", "speech", "--n_files", "40", "--seconds", "2.0", "--seed", "7"]
GENERATE_SECONDS = (1.0, 2.2, 3.7)
LONG_SECONDS = 60.0  # the in-flight reading's file: 6 batches of 16
# Phase 11: the local-attention flags it adds to train.sh's (the heads,
# dim_head and proj_factor of the local stack are the flags' defaults), its
# request, its bf16 steps, and the segment at which the CLI's default
# (uncentred) framing gives the generator's 128 frames
LOCAL_ATTN = dict(mask=True, n_blocks_attn_l=1, heads_l=4, dim_head_l=128, proj_factor_l=4)
MODES_REQUEST_S = 3.7
MODES_STEPS = 10
DB_SEGMENT = 33024
# Phase 12: 12b's global batch (train.sh's 20, as 10 + 10 on two ranks) with
# a tail mask keeping 16 rows, so rank 0 keeps 10 and rank 1 keeps 6, the
# bf16 Adam steps each rank times after its checks, and the seed of its
# weights and batch (each rank draws them itself, from this seed); 12a's
# flags: train.sh's, then 1 epoch of 2 steps on phase 10's corpus (36 train
# files: the second step a tail of 16) and its save, nothing else firing, on
# one decode thread (a single card's prefetcher reads its threads' streams in
# no fixed order; on one thread it reads the batches a rank reads);
# 12c's replicas; the bounds on 12a's second step against the single-card
# run, 10d's on a step after a restore (the card does not repeat a backward
# bit for bit)
DP_BATCH = 20
DP_REAL_ROWS = 16
DP_TIMED_STEPS = 4
DP_SEED = 12
DP_REPLICAS = 2
DP_CLI_FLAGS = TRAIN_CLI_FLAGS + [
    "--niter", "1", "--niter_decay", "0", "--save_epoch_freq", "1", "--print_freq", "20",
    "--display_freq", "1000000", "--eval_freq", "1000000", "--save_latest_freq", "1000000",
    "--nThreads", "1"]
DP_STEP2_BOUNDS = {"f32": 1e-3, "bf16": 2.0 ** -7}
# Phase 13: the flagship at a 20 ms window and 10 ms hop at 48 kHz (n_fft 960,
# not a power of two, so K1 and K2 run their dense forms), 127 hops a segment
# (the generator's 128 frames, a 128 x 480 spectrum); its bf16 Adam steps.
DENSE_GEOMETRY = dict(n_fft=960, hop_length=480, win_length=960, segment_length=127 * 480)
DENSE_STEPS = 3
DENSE_TIMED_REQUESTS = 5
# Phase 14: the program's batch (--export_batch), its timed calls (after 3
# warm-ups), and the n_fft-480 program (hop 240, 127 hops a segment: the
# dense forms' path) at a reduced depth
EXPORT_BATCH = MAIN_BATCH
EXPORT_TIMED = 20
# 14d: the output head that phase 9.1 damps 100x, and the damped program's
# bound, of the CPU SR's largest value.  Phase 6's 2e-3 cannot see TF32
# there: the damped generator adds ~1% to the LR band of the SR.  The
# scoped program read 2.37e-6 of it and TF32 allowed 2.57e-5 (NVIDIA H100
# 80GB HBM3, 700 W), so 8e-6 leaves each side a margin of ~3x.
HEAD = "local_head.conv.weight"
TF32_CONTROL_REL = 8e-6
EXPORT_N480 = ["--n_fft", "480", "--hop_length", "240", "--win_length", "480",
               "--segment_length", str(127 * 240),
               "--n_blocks_global", "1", "--n_blocks_attn_g", "1", "--n_blocks_local", "1"]
# The fresh process of 14a and 14e: it imports torch and the op module
# (through serve_export) and nothing else of the port, loads each program
# (on ``device``; null is the program's default, the card) twice and times
# each load, serves it on its batches, and reports the launches; where it
# sees no card, it also asks each program for its default device, which
# must raise.  argv[1] is a JSON list of [label, program, batches .npy,
# output .npy, device].
SERVE_CHILD = """
import json, sys, time
import numpy as np, torch
from mdctgan_tpu_torch.serve_export import load
from mdctgan_tpu_torch.ops import mdct_kernels as K
report = {"cuda_available": torch.cuda.is_available()}
if torch.cuda.is_available():
    torch.cuda.init()  # the context, so that each load's time is the load's
for label, program, src, dst, device in json.loads(sys.argv[1]):
    load_ms = []
    for _ in range(2):  # the first load in a process also imports the deserializer
        t0 = time.perf_counter()
        serve = load(program, device=device)
        load_ms.append((time.perf_counter() - t0) * 1e3)
    batches = np.load(src)
    K.reset_launch_counts()
    np.save(dst, np.stack([serve(torch.from_numpy(b).to(device or "cuda")).cpu().numpy()
                           for b in batches]))
    report[label] = {"calls": len(batches), "launches": dict(K.LAUNCHES), "load_ms": load_ms,
                     "device": device}
    if not torch.cuda.is_available():
        try:
            load(program)
        except RuntimeError as e:
            report[label]["default_device_raised"] = str(e)
        else:
            report[label]["default_device_raised"] = None
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "optax", "orbax", "mdctgan_tpu"))
models = sorted(m for m in sys.modules if m.startswith("mdctgan_tpu_torch.models"))
if banned or models:
    raise SystemExit(f"the serving process imported {banned + models}")
report["port_modules"] = sorted(m for m in sys.modules if m.startswith("mdctgan_tpu_torch"))
print(json.dumps(report))
"""
# Phases 3-4: the dense form at each N (not a power of two: 480 and 960, and
# 200, whose N/2 is not a multiple of 8; and the ends of its range: 4096, a
# power of two above the FFT form's 2048, and 32, below its 64) and batch,
# with its frames a row; then at the largest N it takes on the card
# (``dense_max_n``, 5568 on an H100), 9 frames a row
DENSE_CHECKS = ((480, 24000, 100), (960, 60960, 128), (200, 24000, 100),
                (4096, 16384, 8), (32, 24000, 100))
DENSE_BATCHES = (2, 8, 16, 20)
# Phase 4's end: an n_fft above the dense form's range, which the matmul
# form serves
ABOVE_N = 8192
# Phase 7: the batches at which it times the dense form at n_fft 960, and
# the batch at which it times N 4096
DENSE_TIMED_BATCHES = (8, 16, 20)
DENSE_RANGE_TIMED = (4096, (MAIN_BATCH,))
# The dense form's error against the float64 plain version may be this many
# times the float32 plain version's own on the same inputs.
DENSE_FACTOR = 2.0
# Each main path's batch: phases 3, 4 and 7 check and time every kernel at each.
PATH_BATCHES = {"serving": MAIN_BATCH, "serving_fp16": MAIN_BATCH, "train": TRAIN_BATCH,
                "train_fp16": TRAIN_BATCH, "generate": GENERATE_BATCH,
                "train_cli": TRAIN_BATCH, "local_attn_serving": MAIN_BATCH,
                "local_attn_train_fp16": TRAIN_BATCH, "two_enhancers_serving": MAIN_BATCH,
                "dp_multihost_train_cli": TRAIN_BATCH,
                "dp_two_ranks_train": DP_BATCH // 2,
                "dp_replicas_serving": MAIN_BATCH // DP_REPLICAS}
BATCHES = tuple(sorted({1, *PATH_BATCHES.values()}))
TIMED_BATCHES = tuple(sorted(set(PATH_BATCHES.values())))
# Published peaks: float32 FMA rate outside the tensor cores, memory rate,
# dense TF32 tensor-core rate.
PEAKS = {"sxm": (67e12, 3.35e12, 495e12), "pcie": (51e12, 2.0e12, 378e12)}
# K1's epilogue and K2's prologue per spectrum value: the gain, asinh or
# sinh, the ln10 scale and the affine FMA, one operation each.
AFFINE_OPS = 4
# How many times the port's bf16 error on the CPU (against a float64 truth)
# the card's bf16 error may be: the CPU tests hold the port's bf16 to 2x the
# JAX package's (tests/test_torch_bf16.py), and the card's bf16 rounds at
# the same points.
BF16_FACTOR = 2.0
# One bf16 step (2^-8 relative): the floor of the bf16 losses' bound.
BF16_STEP = 2.0 ** -8


def mdct_frame_ops(n: int) -> float:
    """Operations of one N-point MDCT or IMDCT frame the fast way, through an
    N/4-point complex FFT: the window (N), the fold (N/2), two twiddle passes
    of N/4 complex products (6 each) and the FFT (5 (N/4) log2(N/4))."""
    m = n // 4
    return n + n / 2 + 2 * 6 * m + 5 * m * math.log2(m)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(name: str, err: float, bound: float, **info) -> float:
    emit({"check": name, "max_abs_err": err, "bound": bound, **info})
    if not err <= bound:
        raise AssertionError(f"{name}: max |err| {err} exceeds {bound}")
    return err


def errors(got: torch.Tensor, truth: torch.Tensor):
    """(max, RMS) of ``got - truth`` in float64."""
    d = got.detach().double().cpu() - truth.detach().double().cpu()
    return float(d.abs().max()), float(d.pow(2).mean().sqrt())


def block(name: str) -> str:
    """The top-level block of a parameter: a global stage, an enhancer stage
    or a discriminator layer."""
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "global" or parts[0].startswith("scale") \
        else parts[0]


def bf16_against_truth(label: str, card: dict, cpu: dict, truth: dict) -> dict:
    """Each entry's (max, RMS) error against ``truth``, the card's and the
    CPU's in bf16, and the card's as a share of ``BF16_FACTOR`` times the
    CPU's; fails past 1."""
    rows, worst = {}, 0.0
    for k, t in truth.items():
        c, p = errors(card[k], t), errors(cpu[k], t)
        share = max(c[0] / p[0], c[1] / p[1]) / BF16_FACTOR
        rows[k] = {"card_max": c[0], "card_rms": c[1], "cpu_max": p[0], "cpu_rms": p[1],
                   "share_of_bound": share}
        worst = max(worst, share)
    emit({"check": label, "factor": BF16_FACTOR, "max_share_of_bound": worst, "rows": rows})
    if not worst <= 1.0:
        raise AssertionError(f"{label}: the card's bf16 error is {worst * BF16_FACTOR:.3f}x "
                             f"the CPU's (bound {BF16_FACTOR})")
    return rows


def pooled(grads: dict) -> dict:
    """Per block, every tensor of ``grads`` flattened into one."""
    out = {}
    for name, g in grads.items():
        out.setdefault(block(name), []).append(g.ravel())
    return {b: torch.cat(v) for b, v in out.items()}


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    torch.cuda.synchronize()
    return float((a.double() - b.double()).abs().max())


def eager_ms(fn, runs: int = 25, inner: int = 10) -> float:
    """Median over ``runs`` of the mean time of ``inner`` back-to-back eager
    calls, by CUDA events, after a warm-up.  For a kernel of a few us this
    reads the host's launch rate as much as the card."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def time_ms(fn, runs: int = 25, inner: int = 10) -> float:
    """The card's time for one call: ``inner`` calls captured in one CUDA
    graph (the wrappers launch on the current stream, which is the capture
    stream), replayed ``runs`` times between CUDA events; the median of the
    mean per call.  A launch counter moves once per captured call, never per
    replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, calls: int = 20):
    """The card's busy time for one call of ``fn``, which launches one
    kernel: the mean device time of the kernel records ``torch.profiler``
    keeps over ``calls`` calls, without the gaps between them.  None where
    it keeps none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    count = sum(e.count for e in kernels)
    return sum(e.self_device_time_total for e in kernels) / count / 1e3 if count else None


def train_phase(rng, smi: str, dev: torch.device):
    """Phase 8; returns each kernel's launches in the float32 and the bf16
    Adam runs, and each one's step timing."""
    from mdctgan_tpu_torch.configs import flagship_opt
    from mdctgan_tpu_torch.data.synthetic import speech_like
    from mdctgan_tpu_torch.models.discriminator import build_discriminator
    from mdctgan_tpu_torch.models.generator import build_generator
    from mdctgan_tpu_torch.ops import mdct_kernels as K
    from mdctgan_tpu_torch.ops.features import SpectralTransform
    from mdctgan_tpu_torch.ops.resample import degrade_lr
    from mdctgan_tpu_torch.options import spectral_config_from_opt, train_options
    from mdctgan_tpu_torch.train import grad_truth as GT
    from mdctgan_tpu_torch.train.schedule import make_optimizers
    from mdctgan_tpu_torch.train.state import create_train_state
    from mdctgan_tpu_torch.train.step import build_train_step
    from mdctgan_tpu_torch.utils import profiling
    from mdctgan_tpu_torch.weights import random_jax_trees, state_dict_from_jax

    opt = flagship_opt()
    tro = train_options(opt)
    cfg = spectral_config_from_opt(opt)
    seg = cfg.segment_length
    step_kw = dict(use_lsgan=not tro["no_lsgan"], lambda_feat=tro["lambda_feat"],
                   n_layers_d=tro["n_layers_D"], num_d=tro["num_D"],
                   use_ganfeat=not tro["no_ganFeat_loss"])
    g_sd = state_dict_from_jax(*random_jax_trees(build_generator(opt), rng))
    d_sd = state_dict_from_jax(*random_jax_trees(build_discriminator(opt), rng))
    cpu = torch.device("cpu")

    # 8a. one SGD(1) step at full width: card against CPU --------------------
    # On the input form of the JAX package's flagship gradient certificate
    # (white noise), with the CPU's step fed the card's spectra (K1 is held
    # to its plain version in phase 3).  At these seeded weights the step's
    # gradients jump wherever an activation rounds to the other side of a
    # ReLU, leaky-ReLU or |x| kink: the float64 step itself moves by about
    # the JAX bounds (G 2.5e-2, D 5e-3) when only its input spectra are
    # rounded to float32, once by K1 and once by its plain version, and
    # smoothing every kink cuts that 6-9x (probes/flagship_grad_truth.py).
    # So each tensor k is held within rel*||cpu_k|| + 1e-3 +
    # C*||T_card - T_cpu||_k, T being that float64 step fed the card's and
    # the CPU's spectra, C = ``grad_truth.CONDITIONING_FACTOR``.  The float64
    # term does not grow with any float32 error of the port.  The card with
    # TF32 allowed must fail the same bound.  Read, not asserted: the share
    # of the JAX bounds alone, and each side on its own spectra.
    batch = GT.inputs("noise", rng, 2, seg)
    card_t, cpu_t = SpectralTransform(cfg, dev), SpectralTransform(cfg, cpu)
    f64_t = SpectralTransform(cfg, cpu, torch.float64)
    runs, secs = {}, {}
    for name, device, dtype, transform, tf32 in (
            ("cpu", cpu, torch.float32, GT.SharedSpectra(cpu_t, card_t), False),
            ("cpu_own_spectra", cpu, torch.float32, cpu_t, False),
            ("f64_card_spectra", cpu, torch.float64, GT.SharedSpectra(f64_t, card_t), False),
            ("f64_cpu_spectra", cpu, torch.float64, GT.SharedSpectra(f64_t, cpu_t), False),
            ("card", dev, torch.float32, card_t, False),
            ("card_tf32", dev, torch.float32, card_t, True)):
        t0 = time.perf_counter()
        runs[name] = GT.sgd_step(opt, GT.load_nets(opt, g_sd, d_sd, dtype), transform, batch,
                                 device, allow_tf32=tf32)
        secs[name] = time.perf_counter() - t0
    emit({"train_step_s": secs, "batch": 2, "cpu_threads": torch.get_num_threads()})
    moved = {net: {k: float((t - runs["f64_cpu_spectra"][1][net][k]).norm())
                   for k, t in runs["f64_card_spectra"][1][net].items()} for net in GT.BOUNDS}
    emit({"reading": "float64 step, card's spectra against the CPU's",
          **{net: {k: v for k, v in GT.normwise(runs["f64_cpu_spectra"][1][net],
                                                runs["f64_card_spectra"][1][net], rel).items()
                   if k != "shares"} for net, rel in GT.BOUNDS.items()}})
    held = {}
    for label, name, ref in (
            ("control: card vs CPU, each on its own spectra", "card", "cpu_own_spectra"),
            ("control: card with TF32 allowed vs CPU", "card_tf32", "cpu"),
            ("check: card vs CPU on the same spectra", "card", "cpu")):
        (losses, grads), (ref_losses, ref_grads) = runs[name], runs[ref]
        loss_rel = max(abs(losses[k] - v) / max(abs(v), 1e-30) for k, v in ref_losses.items())
        result = {"batch": 2, "data": "noise", "loss_max_rel_err": loss_rel,
                  "losses_card": losses, "losses_cpu": ref_losses}
        for net, rel in GT.BOUNDS.items():
            slack = {k: GT.CONDITIONING_FACTOR * v for k, v in moved[net].items()}
            r = GT.normwise(ref_grads[net], grads[net], rel, slack=slack)
            plain = GT.normwise(ref_grads[net], grads[net], rel)
            result[net] = {"bound_rel": rel, "floor": GT.FLOOR,
                           "conditioning_factor": GT.CONDITIONING_FACTOR,
                           "max_share_of_bound": r["max_share"], "worst": r["worst"],
                           "max_share_of_jax_bound": plain["max_share"],
                           "worst_on_jax_bound": plain["worst"]}
        kind, what = label.split(": ")
        emit({kind: f"train step {what}", **result})
        held[name, ref] = (loss_rel, max(result[net]["max_share_of_bound"] for net in GT.BOUNDS))
    loss_rel, share = held["card", "cpu"]
    if not (loss_rel <= 1e-3 and share <= 1.0):
        raise AssertionError(f"train step card vs CPU: losses {loss_rel} (1e-3), "
                             f"gradients {share} of their bound")
    if not held["card_tf32", "cpu"][1] > 1.0:
        raise AssertionError("TF32 passes the train gradient bound: it is too loose")

    # 8b. the bf16 policy (--fp16): one SGD(1) step of bf16 G and D ----------
    # on the card and on the CPU, both fed the card's spectra, each against
    # the float64 step on those spectra (8a's truth).  The card's gradient
    # error is held per top-level block, pooled over the block's tensors,
    # by max and by RMS, to BF16_FACTOR times the CPU's.  A loss is one
    # scalar, and its bf16 error one draw of a distribution: over 20 seeded
    # flagship draws at batch 2 (probes/bf16_loss_draws.py; NVIDIA H100
    # 80GB HBM3, 700 W) no loss's card error kept one sign on more than 13,
    # the card's median |error| was 0.88-1.35x the CPU's for every loss
    # (D_fake 4.4e-3 against 3.5e-3, G_GAN 4.0e-3 against 3.3e-3), and
    # the ratio of the largest errors ran from 0.15 to 5.02 (median 1.04).
    # The card is not biased; the ratio of two draws is noisy.  So each
    # loss is held to BF16_FACTOR times the CPU's largest relative loss
    # error or to one bf16 step, whichever is larger, on this script's draw
    # (which 3 of those 20 draws would not meet: PERF.md §6, PR 12).
    opt16 = dict(opt, fp16=True)
    for name, device, transform in (("cpu_bf16", cpu, GT.SharedSpectra(cpu_t, card_t)),
                                    ("card_bf16", dev, card_t)):
        t0 = time.perf_counter()
        runs[name] = GT.sgd_step(opt16, GT.load_nets(opt16, g_sd, d_sd), transform, batch,
                                 device)
        secs[name] = time.perf_counter() - t0
    emit({"train_step_s": {k: secs[k] for k in ("cpu_bf16", "card_bf16")}, "batch": 2})
    truth_losses, truth_grads = runs["f64_card_spectra"]

    def loss_rel(run):
        return {k: abs(run[0][k] - v) / abs(v) for k, v in truth_losses.items()}

    card_rel, cpu_rel = loss_rel(runs["card_bf16"]), loss_rel(runs["cpu_bf16"])
    check("train step bf16 losses, card vs float64 (max rel)", max(card_rel.values()),
          max(BF16_FACTOR * max(cpu_rel.values()), BF16_STEP), card_rel=card_rel,
          cpu_rel=cpu_rel, truth=truth_losses)
    for net in GT.BOUNDS:
        bf16_against_truth(f"train step bf16 {net} gradients by block, card and CPU vs float64",
                           pooled(runs["card_bf16"][1][net]), pooled(runs["cpu_bf16"][1][net]),
                           pooled(truth_grads[net]))
        r = GT.normwise(runs["cpu_bf16"][1][net], runs["card_bf16"][1][net], GT.BOUNDS[net])
        emit({"reading": f"train step bf16 {net}: card vs CPU, both bf16",
              "max_share_of_jax_bound": r["max_share"], "max_rel_err": r["max_rel_err"],
              "worst": r["worst"]})

    # synthetic speech at 48 kHz, cut into segments; LR by the port's degrade
    n_seg = TRAIN_BATCH * 2
    hr = speech_like(rng, n_seg * seg / 48000, 48000)[: n_seg * seg].reshape(n_seg, seg)
    with torch.no_grad():
        lr = degrade_lr(torch.from_numpy(hr), 48000, cfg.lr_sampling_rate,
                        cfg.hr_sampling_rate)[:, :seg].contiguous().numpy()

    def batch_on(device, rows):
        return {"lr_audio": torch.from_numpy(lr[rows]).to(device),
                "hr_audio": torch.from_numpy(hr[rows]).to(device)}

    batches = [batch_on(dev, slice(i, i + TRAIN_BATCH)) for i in (0, TRAIN_BATCH)]

    # 8c. the trainer: flagship Adam at batch 20, float32 then bf16 ------------
    def trainer(precision: str, run_opt: dict):
        """``TRAIN_STEPS[precision]`` Adam steps (checked), then the step's
        timings; returns the steps' kernel launches and the timing."""
        steps = TRAIN_STEPS[precision]
        spe = 1000  # the schedule is flat through the first 60 epochs at any size
        g_tx, d_tx = make_optimizers(tro["lr"], tro["beta1"], tro["niter"], tro["niter_decay"],
                                     spe)
        state = create_train_state(build_generator(run_opt), build_discriminator(run_opt),
                                   g_tx, d_tx, device=dev,
                                   rng=torch.Generator().manual_seed(SEED))
        step = build_train_step(SpectralTransform(cfg, dev), g_tx, d_tx, **step_kw)
        first = {n: torch.cat([p.detach().ravel() for p in m.parameters()])
                 for n, m in (("G", state.generator), ("D", state.discriminator))}
        K.reset_launch_counts()
        history = []
        for i in range(steps):
            state, metrics = step(state, batches[i % 2])
            history.append({k: float(v) for k, v in metrics.items()})
        launches = dict(K.LAUNCHES)
        moved = {n: float((torch.cat([p.detach().ravel() for p in m.parameters()]) - first[n])
                          .abs().max())
                 for n, m in (("G", state.generator), ("D", state.discriminator))}
        emit({"train_run": {"precision": precision, "batch": TRAIN_BATCH, "steps": steps,
                            "losses": history, "max_abs_param_move": moved,
                            "launches": launches, "lr": state.g_opt.param_groups[0]["lr"]}})
        if not all(math.isfinite(v) for h in history for v in h.values()):
            raise AssertionError(f"a {precision} train loss is not finite")
        if not (moved["G"] > 0 and moved["D"] > 0):
            raise AssertionError(f"a network did not move in {precision}: {moved}")
        expected = {name: 0 for name in K.LAUNCHES}
        expected["mdct_spectro"] = 2 * steps
        if launches != expected:
            raise AssertionError(f"{precision} train launches {launches}, expected {expected}")

        marks = ("k1", "g_forward", "d_forward", "backward", "optimizer")
        host = []

        def timed_step(i, mark=None):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            step(state, batches[i % 2], mark=mark)
            host.append((time.perf_counter() - t0) * 1e3)  # the host's time to enqueue
            end.record()
            end.synchronize()
            return start.elapsed_time(end)

        torch.cuda.reset_peak_memory_stats()
        for i in range(3):
            timed_step(i)
        host.clear()
        times = [timed_step(i) for i in range(20)]
        host_ms = statistics.median(host)
        step_ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated()
        parts = {name: [] for name in marks}
        for i in range(5):
            events = {}

            def mark(name, events=events):
                events[name] = torch.cuda.Event(enable_timing=True)
                events[name].record()

            start = torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, batches[i % 2], mark=mark)
            events["optimizer"].synchronize()
            prev = start
            for name in marks:
                parts[name].append(prev.elapsed_time(events[name]))
                prev = events[name]

        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(3):
                step(state, batches[i % 2])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 3
        # busy time: the union of the device records' intervals (annotations
        # left out), so overlapping records are not counted twice
        records = profiling.device_intervals(prof)
        busy_ms = profiling.busy_time_ms(prof, 3)
        kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        total_us = sum(e.self_device_time_total for e in kernels)
        # cuDNN's FFT-tiled convolutions (ROADMAP item A) by their kernels'
        # names: the FFTs and the complex float32 GEMMs between them
        fft_us = sum(e.self_device_time_total for e in kernels
                     if "fft" in e.key.lower() or "cf32" in e.key.lower())
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        timing = {"name": "train_step", "precision": precision, "card": smi,
                  "batch": TRAIN_BATCH, "ms": step_ms, "ms_min": min(times),
                  "ms_max": max(times), "samples_per_s": TRAIN_BATCH / step_ms * 1e3,
                  "host_enqueue_ms": host_ms, "max_memory_allocated_bytes": peak,
                  "parts_ms": {k: statistics.median(v) for k, v in parts.items()},
                  "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
                  "device_idle_share": 1.0 - busy_ms / wall_ms,
                  "device_records_per_step": len(records) / 3,
                  "fft_tiled_share_of_device_time": fft_us / total_us,
                  "top_kernels": [{"name": e.key[:100], "count": e.count / 3,
                                   "ms": e.self_device_time_total / 1e3 / 3} for e in top]}
        emit({"timing": timing})
        return launches, timing

    train_launches, timing = trainer("f32", opt)

    # 8d. the tail batch: 13 real rows of 20 against a batch of 13 ---------------
    mask = (torch.arange(TRAIN_BATCH, device=dev) < 13).float()
    full = {"lr_audio": lr[:TRAIN_BATCH], "hr_audio": hr[:TRAIN_BATCH]}
    m_losses, m_grads = GT.sgd_grads(opt, g_sd, d_sd, full, dev, sample_mask=mask)
    s_losses, s_grads = GT.sgd_grads(opt, g_sd, d_sd, {k: v[:13] for k, v in full.items()}, dev)
    tail_rel = max(abs(m_losses[k] - v) / max(abs(v), 1e-30) for k, v in s_losses.items())
    tail = {"batch": TRAIN_BATCH, "real_rows": 13, "loss_max_rel_err": tail_rel}
    for net, rel in GT.BOUNDS.items():
        r = GT.normwise(s_grads[net], m_grads[net], rel)
        tail[net] = {"gradient_max_share_of_bound": r["max_share"], "worst": r["worst"]}
    check("masked tail batch vs smaller batch (losses, max rel)", tail_rel, 1e-3, **tail)
    del m_grads, s_grads

    bf16_launches, bf16_timing = trainer("bf16", opt16)
    emit({"reading": "train step bf16 against float32, same run",
          "ms": {"f32": timing["ms"], "bf16": bf16_timing["ms"]},
          "speedup": timing["ms"] / bf16_timing["ms"],
          "peak_bytes": {"f32": timing["max_memory_allocated_bytes"],
                         "bf16": bf16_timing["max_memory_allocated_bytes"]}})
    return train_launches, timing, bf16_launches, bf16_timing


def generate_phase(rng, smi: str, dev: torch.device) -> dict:
    """Phase 9; returns each kernel's launches in the checked batch-mode
    run on the card."""
    from mdctgan_tpu_torch import api, generate_cli
    from mdctgan_tpu_torch.data import native
    from mdctgan_tpu_torch.data.synthetic import speech_like
    from mdctgan_tpu_torch.device import float32_policy
    from mdctgan_tpu_torch.models.generator import build_generator
    from mdctgan_tpu_torch.ops import mdct_kernels as K
    from mdctgan_tpu_torch.options import TrainOptions, defaults
    from mdctgan_tpu_torch.train.import_torch import export_to_torch_keys, generator_entries_for
    from mdctgan_tpu_torch.weights import random_jax_trees, state_dict_from_jax

    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="generate_", dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        cuda_id = ["--gpu_ids", str(dev.index or 0)]

        f32_flags = [a for a in GENERATE_FLAGS if a != "--fp16"]

        def run(name, dataroot, *extra, flags=GENERATE_FLAGS):
            return generate_cli.main(flags + [
                "--name", name, "--dataroot", str(dataroot), "--checkpoints_dir",
                str(tmp / "out"), "--load_pretrain", str(tmp / "pretrained"), *extra])

        # 9.1 a reference-layout .pth of seeded flagship weights
        opt = TrainOptions().parse(GENERATE_FLAGS + ["--checkpoints_dir", str(tmp / "out")],
                                   save=False)
        gen = build_generator(opt)
        state = state_dict_from_jax(*random_jax_trees(gen, rng))
        state[HEAD] *= 0.01
        (tmp / "pretrained").mkdir()
        torch.save(export_to_torch_keys(state, generator_entries_for(gen)),
                   tmp / "pretrained" / "latest_net_G.pth")

        # 9.2 three WAVs of synthetic speech at 48 kHz and one bad file
        wavs = tmp / "wavs"
        wavs.mkdir()
        names = [f"speech_{round(s * 1000)}ms" for s in GENERATE_SECONDS]
        for name, s in zip(names, GENERATE_SECONDS):
            native.write_wav16(str(wavs / f"{name}.wav"), speech_like(rng, s, 48000), 48000)
        (wavs / "broken.wav").write_bytes(b"RIFF\x00\x00not audio" * 8)
        (tmp / "first.csv").write_text(f"wavs/{names[0]}.wav\n")

        # 9.3 batch mode on the card, bf16 (--fp16)
        K.reset_launch_counts()
        card = run("card", wavs, *cuda_id)
        launches = dict(K.LAUNCHES)
        seg, bs = opt.segment_length, opt.batchSize
        batches = 0
        for s in GENERATE_SECONDS:  # 48 kHz -> 16 kHz -> 48 kHz, then segments
            lr_len = 3 * math.ceil(round(s * 48000) / 3)
            batches += math.ceil(max(1, math.ceil(lr_len / seg)) / bs)
        with open(tmp / "out" / "card" / "metrics.csv") as f:
            rows = list(csv.DictReader(f))
        emit({"generate_run": {"rows": rows, "rungs": card["rungs"], "launches": launches,
                               "batches": batches}})
        if card["rungs"]:
            raise AssertionError(f"the .pth loaded through fallback rungs {card['rungs']}")
        if [r["file"] for r in rows] != [str(wavs / f"{n}.wav") for n in names] + ["MEAN"]:
            raise AssertionError(f"metrics.csv rows {[r['file'] for r in rows]}")
        for r in rows:
            for k in ("mse", "snr_sr", "snr_lr", "lsd"):
                if not math.isfinite(float(r[k])):
                    raise AssertionError(f"{r['file']}: {k} = {r[k]}")
        expected = {name: 0 for name in K.LAUNCHES}
        expected["mdct_spectro"] = expected["imdct_audio"] = batches
        if launches != expected:
            raise AssertionError(f"generate launches {launches}, expected {expected}")

        # 9.4 the 1.0 s file in float32 on the card and on the CPU (held), and
        # in bf16 on the CPU against 9.3's card row (read)
        card32 = run("card_f32", tmp / "first.csv", *cuda_id, flags=f32_flags)
        cpu = run("cpu", tmp / "first.csv", "--gpu_ids", "-1", "--batchSize", "2",
                  flags=f32_flags)
        got, ref = card32["rows"][0], cpu["rows"][0]
        sr = native.read(str(tmp / "out" / "card_f32" / got["output"]))[0]
        sr_ref = native.read(str(tmp / "out" / "cpu" / ref["output"]))[0]
        scale = float(np.abs(sr_ref).max())
        check("generate SR WAV card vs CPU (float32)", float(np.abs(sr - sr_ref).max()),
              2e-3 * scale, file=names[0], max_abs_ref=scale, samples=len(sr_ref))
        check("generate LSD card vs CPU (relative)",
              abs(got["lsd"] - ref["lsd"]) / ref["lsd"], 1e-3, card=got["lsd"], cpu=ref["lsd"])
        check("generate MSE card vs CPU (relative)",
              abs(got["mse"] - ref["mse"]) / ref["mse"], 1e-2, card=got["mse"], cpu=ref["mse"])
        for k in ("snr_sr", "snr_lr", "snr_seg"):
            check(f"generate {k} card vs CPU (dB)", abs(got[k] - ref[k]), 0.01,
                  card=got[k], cpu=ref[k])
        cpu16 = run("cpu_bf16", tmp / "first.csv", "--gpu_ids", "-1", "--batchSize", "2")
        sr16 = native.read(str(tmp / "out" / "card" / card["rows"][0]["output"]))[0]
        sr16_cpu = native.read(str(tmp / "out" / "cpu_bf16" / cpu16["rows"][0]["output"]))[0]
        emit({"reading": "generate bf16 SR WAV card vs CPU, and bf16 vs float32 on the card",
              "card_vs_cpu_max_abs": float(np.abs(sr16 - sr16_cpu).max()),
              "bf16_vs_f32_max_abs": float(np.abs(sr16 - sr).max()), "max_abs_f32": scale,
              "lsd": {"card_bf16": card["rows"][0]["lsd"], "cpu_bf16": cpu16["rows"][0]["lsd"],
                      "card_f32": got["lsd"]}})

        # 9.5 the JAX package's default generator: netG global, transconv up
        g_opt = defaults()
        g_state = state_dict_from_jax(*random_jax_trees(build_generator(g_opt), rng))
        card_net, cpu_net = (build_generator(g_opt) for _ in range(2))
        for net, where in ((card_net, dev), (cpu_net, torch.device("cpu"))):
            net.load_state_dict(g_state, strict=True)
            net.to(where).eval()
        x = torch.from_numpy(rng.standard_normal((2, 2, 128, 256)).astype(np.float32))
        with torch.inference_mode():
            cpu_logits = cpu_net.logits(x)
            card_logits = {}
            for tf32 in (False, True):
                with float32_policy(allow_tf32=tf32):
                    card_logits[tf32] = card_net.logits(x.to(dev)).cpu()
        ref_scale = float(cpu_logits.abs().max())
        bound = 5e-4 * max(1.0, ref_scale)
        check("netG global (transconv) logits card vs CPU", max_err(card_logits[False], cpu_logits),
              bound, batch=2, max_abs_ref=ref_scale,
              parameters=sum(p.numel() for p in cpu_net.parameters()))
        check("netG global (transconv) output card vs CPU",
              max_err(torch.tanh(card_logits[False]), torch.tanh(cpu_logits)), 5e-4, batch=2)
        emit({"control": "netG global card vs CPU with TF32 allowed",
              "logits_max_abs_err": max_err(card_logits[True], cpu_logits), "bound": bound,
              "output_max_abs_err": max_err(torch.tanh(card_logits[True]), torch.tanh(cpu_logits))})
        del card_net, cpu_net, card_logits

        # 9.6 the batch-mode run, bf16 then float32, each timed after a
        # warm-up file; its set-up and each file are this run's own, as
        # ``main`` returns them
        audio_s = sum(GENERATE_SECONDS)
        for precision, flags in (("bf16", GENERATE_FLAGS), ("f32", f32_flags)):
            run(f"warmup_{precision}", tmp / "first.csv", *cuda_id, flags=flags)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            timed = run(f"timed_{precision}", wavs, *cuda_id, flags=flags)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated()
            per_file = {Path(p).stem: ms for p, ms in timed["file_ms"].items()}
            # read, not asserted: a second run at api.upsample's batch, where
            # each file pads to 8 segments, not 16
            per_file_8 = {Path(p).stem: ms for p, ms in run(
                f"batch8_{precision}", wavs, *cuda_id, "--batchSize", str(MAIN_BATCH),
                flags=flags)["file_ms"].items()}
            emit({"timing": {"name": "generate_batch_mode", "precision": precision,
                             "card": smi, "files": len(names), "audio_s": audio_s,
                             "batch": bs, "wall_ms": wall_ms,
                             "ms_per_audio_s": wall_ms / audio_s,
                             "files_per_s": len(names) / wall_ms * 1e3,
                             "max_memory_allocated_bytes": peak,
                             "setup_ms": timed["setup_ms"], "file_ms": per_file,
                             "setup_share": timed["setup_ms"] / wall_ms,
                             "files_ms_per_audio_s": sum(per_file.values()) / audio_s,
                             f"second_run_file_ms_batch{MAIN_BATCH}": per_file_8}})

        # 9.7 the in-flight window of api.serve_segments: one 60 s file (6
        # batches of 16, bf16) with 1 batch in flight (a synchronous loop)
        # and 2, alternated; its time is read, its SR must not change
        long_dir = tmp / "long"
        long_dir.mkdir()
        native.write_wav16(str(long_dir / "speech_60s.wav"),
                           speech_like(rng, LONG_SECONDS, 48000), 48000)
        window, outputs = {1: [], 2: []}, {}
        default = api.IN_FLIGHT
        for n in (1, 2, 2, 1):
            api.IN_FLIGHT = n
            r = run(f"in_flight_{n}", long_dir, *cuda_id)
            window[n].append(next(iter(r["file_ms"].values())))
            outputs[n] = (native.read(str(Path(r["out_dir"]) / r["rows"][0]["output"]))[0],
                          {k: r["rows"][0][k] for k in ("mse", "snr_sr", "snr_seg", "lsd")})
        api.IN_FLIGHT = default
        check("in-flight window 2 vs 1: SR WAV", float(np.abs(outputs[2][0] - outputs[1][0]).max()),
              0.0, metrics_equal=outputs[2][1] == outputs[1][1])
        if outputs[2][1] != outputs[1][1]:
            raise AssertionError(f"in-flight metrics {outputs[2][1]} != {outputs[1][1]}")
        med = {n: statistics.median(v) for n, v in window.items()}
        emit({"timing": {"name": "generate_in_flight", "card": smi, "audio_s": LONG_SECONDS,
                         "batch": bs, "file_ms": window, "median_ms": med,
                         "gain_ms": med[1] - med[2], "gain_share": 1.0 - med[2] / med[1],
                         "phase_s": time.perf_counter() - t_phase}})
    return launches


def train_cli_phase(smi: str, dev: torch.device, bare_step: dict,
                    flags=TRAIN_CLI_FLAGS) -> dict:
    """Phase 10; returns each kernel's launches in the checked run, and its
    median print-only step."""
    import contextlib
    import io

    from mdctgan_tpu_torch import export_torch_cli, generate_cli, train_cli
    from mdctgan_tpu_torch.data import native
    from mdctgan_tpu_torch.data.dataset import AudioDataset
    from mdctgan_tpu_torch.data.pipeline import InputPipeline, make_degrade_fn
    from mdctgan_tpu_torch.device import float32_policy
    from mdctgan_tpu_torch.models.discriminator import build_discriminator
    from mdctgan_tpu_torch.models.generator import build_generator
    from mdctgan_tpu_torch.ops import mdct_kernels as K
    from mdctgan_tpu_torch.ops.features import SpectralTransform
    from mdctgan_tpu_torch.options import TrainOptions, as_dict, spectral_config_from_opt
    from mdctgan_tpu_torch.train.checkpoint import CheckpointManager, state_digest
    from mdctgan_tpu_torch.train.schedule import make_optimizers, pix2pixhd_lr_schedule
    from mdctgan_tpu_torch.train.state import create_train_state
    from mdctgan_tpu_torch.train.step import build_train_step

    t_phase = time.perf_counter()
    cuda_id = ["--gpu_ids", str(dev.index or 0) if dev.type == "cuda" else "-1"]
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="train_cli_", dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        # 10a. the corpus: 36 train and 4 eval files of synthetic speech
        subprocess.run([sys.executable, str(ROOT / "tools" / "make_corpus.py"),
                        str(tmp / "corpus"), *CORPUS], check=True, timeout=300)
        argv = flags + cuda_id + [
            "--dataroot", str(tmp / "corpus" / "train.csv"),
            "--evalroot", str(tmp / "corpus" / "eval.csv"),
            "--checkpoints_dir", str(tmp / "out"), "--name", "run",
            "--profile_dir", str(tmp / "profile")]
        opt = TrainOptions().parse(argv, save=False)
        cfg = spectral_config_from_opt(opt)
        bs = opt.batchSize

        # the pipeline's degrade on the card, under the CLI's policy (TF32
        # off), against the CPU's on the same segments; TF32 read as control
        def serial():
            return AudioDataset(str(tmp / "corpus" / "train.csv"), cfg.segment_length,
                                seed=opt.seed, serial=True)

        segs, rates = serial().sample_batch_rates(2 * bs)
        degrade = make_degrade_fn(cfg, int(rates[0]), False, opt.snr)
        refs = [degrade(torch.from_numpy(segs[i * bs:(i + 1) * bs]), torch.Generator())
                for i in range(2)]
        pipe = InputPipeline(serial(), cfg, bs, device=dev)
        try:
            got = {}
            for tf32 in (False, True):  # the first batch TF32 off, the second on
                with float32_policy(allow_tf32=tf32):
                    got[tf32] = next(pipe)
        finally:
            pipe.close()
        scale = float(refs[0]["lr_audio"].abs().max())
        for k in ("hr_audio", "lr_audio"):
            check(f"train pipeline {k} card vs CPU degrade (TF32 off)",
                  max_err(got[False][k].cpu(), refs[0][k]), 1e-5 * scale, batch=bs,
                  max_abs_ref=scale)
        emit({"control": "train pipeline lr_audio card vs CPU degrade with TF32 allowed",
              "max_abs_err": max_err(got[True]["lr_audio"].cpu(), refs[1]["lr_audio"]),
              "bound": 1e-5 * float(refs[1]["lr_audio"].abs().max())})

        # 10b. the run: 3 epochs, 6 steps
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        run = train_cli.main(argv)
        launches = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
        out = tmp / "out" / "run"
        steps, evals = run["steps"], run["evals"]
        displays = sum("display" in s["fired"] for s in steps)
        eval_batches = sum(e["batches"] for e in evals)
        losses = [{k: v for k, v in row.items() if k not in ("step", "epoch")}
                  for row in run["losses"]]
        with open(out / "eval.csv") as f:
            eval_rows = list(csv.DictReader(f))
        sched = pix2pixhd_lr_schedule(opt.lr, 1, 2, 2)
        want_lrs = {e: sched(2 * e - 1) for e in (1, 2, 3)}
        emit({"train_cli_run": {"steps": len(steps), "losses": losses, "lrs": run["lrs"],
                                "expected_lrs": want_lrs, "eval": eval_rows,
                                "fired": [s["fired"] for s in steps], "launches": launches,
                                "eval_batches": eval_batches, "displays": displays}})
        if not (len(steps) == 6 and len(losses) == 6
                and all(math.isfinite(v) for row in losses for v in row.values())):
            raise AssertionError(f"train CLI: {len(steps)} steps, losses {losses}")
        for name in ("loss_log.txt", "opt.txt", "web", "ckpt", "eval.csv"):
            if not (out / name).exists():
                raise AssertionError(f"train CLI wrote no {name}")
        with open(out / "eval.csv") as f:
            header = f.readline().strip()
        if header != "step,epoch,mse,snr_sr,snr_lr,snr_seg,lsd" or not eval_rows or not all(
                math.isfinite(float(r[k])) for r in eval_rows for k in ("lsd", "snr_sr", "snr_lr")):
            raise AssertionError(f"eval.csv: {header} {eval_rows}")
        if run["lrs"] != want_lrs:
            raise AssertionError(f"learning rates {run['lrs']}, schedule {want_lrs}")
        expected = {name: 0 for name in K.LAUNCHES}
        expected["mdct_spectro"] = 2 * len(steps) + eval_batches + 3 * displays
        expected["imdct_audio"] = eval_batches + displays
        if not (displays >= 1 and eval_batches >= 1 and launches == expected == run["launches"]):
            raise AssertionError(f"train CLI launches {launches}, expected {expected}")
        final = state_digest(run["state"])
        del run["state"]

        # 10e. train -> generate: the port's checkpoint served on one eval file
        K.reset_launch_counts()
        gen_run = generate_cli.main(flags + cuda_id + [
            "--load_pretrain", str(out), "--checkpoints_dir", str(tmp / "gen"), "--name", "gen",
            "--dataroot", str(next((tmp / "corpus" / "wav").glob("00000.wav")))])
        gen_launches = dict(K.LAUNCHES)
        emit({"train_to_generate": {"rungs": gen_run["rungs"], "launches": gen_launches}})
        if gen_run["rungs"] != [] or gen_launches != dict(
                expected, mdct_spectro=1, imdct_audio=1):
            raise AssertionError(f"generate from the port's checkpoint: {gen_run['rungs']}, "
                                 f"{gen_launches}")

        # 10g. train -> export -> generate: the run's ckpt/ exported to
        # reference .pth files (no device work), served strictly, the same SR
        # as serving the ckpt/ (10e) within phase 9's waveform bound
        t0 = time.perf_counter()
        paths = export_torch_cli.main(flags + cuda_id + [
            "--load_pretrain", str(out), "--export_dir", str(tmp / "exported"),
            "--checkpoints_dir", str(tmp / "gen")])
        export_ms = (time.perf_counter() - t0) * 1e3
        pth_run = generate_cli.main(flags + cuda_id + [
            "--load_pretrain", str(tmp / "exported"), "--checkpoints_dir", str(tmp / "gen"),
            "--name", "gen_pth",
            "--dataroot", str(next((tmp / "corpus" / "wav").glob("00000.wav")))])
        if pth_run["rungs"] != []:
            raise AssertionError(f"the exported .pth loaded through rungs {pth_run['rungs']}")
        sr_ckpt = native.read(str(tmp / "gen" / "gen" / "sr_audio.wav"))[0]
        sr_pth = native.read(str(tmp / "gen" / "gen_pth" / "sr_audio.wav"))[0]
        scale = float(np.abs(sr_ckpt).max())
        check("generate from the exported .pth vs from the ckpt/ (SR WAV)",
              float(np.abs(sr_pth - sr_ckpt).max()), 2e-3 * scale, max_abs_ref=scale,
              files=[Path(p).name for p in paths], export_ms=export_ms,
              pth_bytes=sum(Path(p).stat().st_size for p in paths))

        # 10c. resume: the restored state is the one the first run ended with
        out_text = io.StringIO()
        with contextlib.redirect_stdout(out_text):
            resumed = train_cli.main(argv + ["--continue_train", "--niter", "1",
                                             "--niter_decay", "3"])
        printed = out_text.getvalue()
        print(printed, end="", flush=True)
        same = resumed["restored_digest"] == final
        emit({"train_cli_resume": {"start": resumed["start"], "bit_for_bit": same,
                                   "steps": len(resumed["steps"]), "lrs": resumed["lrs"],
                                   "tensors": len(final)}})
        if "Resuming from epoch 4 at iteration 0" not in printed or not same:
            raise AssertionError(f"resume: {resumed['start']}, bit for bit {same}")
        del resumed

        # 10d. the resume trajectory on the card, on fixed batches: 2 steps,
        # save, restore into a fresh state, 2 steps, against 4 steps; in
        # float32 and under the run's bf16
        fixed = AudioDataset(str(tmp / "corpus" / "train.csv"), cfg.segment_length,
                             seed=opt.seed, serial=True)
        batches = []
        for _ in range(2):
            seg, r = fixed.sample_batch_rates(bs)
            batches.append(make_degrade_fn(cfg, int(r[0]), False, opt.snr)(
                torch.from_numpy(seg).to(dev), torch.Generator()))
        g_tx, d_tx = make_optimizers(opt.lr, opt.beta1, opt.niter, opt.niter_decay, 2)
        step = build_train_step(SpectralTransform(cfg, dev), g_tx, d_tx,
                                n_layers_d=opt.n_layers_D, num_d=opt.num_D)

        def losses_of(state, todo):
            return [{k: float(v) for k, v in step(state, b)[1].items()} for b in todo]

        def rel(a, b):
            return max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
                       for x, y in zip(a, b) for k in y)

        # The uninterrupted run saves after its step 2 and goes on (a save
        # changes nothing); the resumed run restores that save into a
        # fresh state and takes steps 3 and 4 again.  Both start step 3
        # from the same bits, so step 3's losses are equal exactly.  The
        # card need not repeat step 3's backward bit for bit (the tensors
        # that differ after step 4 are counted), so step 4 may differ by
        # that alone: float32 is held to 1e-3; under bf16 the losses of one
        # step repeated from the same bits read up to 2.8e-3 apart
        # (spread_after_2_steps), under one bf16 step (2^-8), and step 4 is
        # held to two (2^-7).
        for fp16, step4_bound in ((False, 1e-3), (True, 2.0 ** -7)):
            net_opt = {**as_dict(opt), "fp16": fp16}

            def fresh(seed):
                return create_train_state(
                    build_generator(net_opt), build_discriminator(net_opt), g_tx, d_tx,
                    device=dev, rng=torch.Generator().manual_seed(seed))

            mgr = CheckpointManager(str(tmp / f"trajectory_fp16_{fp16}"))
            whole = fresh(SEED)
            head = losses_of(whole, batches)
            mgr.save(whole, epoch=2)
            tail = losses_of(whole, batches)
            again = fresh(SEED + 1)
            mgr.restore(again)
            resumed = losses_of(again, batches)
            mgr.close()
            ends = state_digest(whole), state_digest(again)
            differ = sum(ends[0][k] != ends[1].get(k) for k in ends[0])
            del whole, again
            other = losses_of(fresh(SEED), batches * 2)
            spread = {"spread_of_two_uninterrupted_runs_4_steps": rel(other, head + tail),
                      "spread_after_2_steps": rel(other[:2], head),
                      "tensors_differing_after_step_4": differ}
            name = "bf16" if fp16 else "f32"
            check(f"resume trajectory on the card ({name}): step 3 after save + restore vs "
                  "uninterrupted (losses, rel)", rel(resumed[:1], tail[:1]), 0.0, batch=bs,
                  **spread)
            check(f"resume trajectory on the card ({name}): step 4 after save + restore vs "
                  "uninterrupted (losses, rel)", rel(resumed[1:], tail[1:]), step4_bound,
                  batch=bs, **spread)
            torch.cuda.empty_cache()

        # 10f. numbers
        profiled = set(range(opt.profile_step + 1, opt.profile_step + opt.profile_nsteps + 1))
        clean = [s["ms"] for s in steps[1:] if s["fired"] == ["print"]
                 and s["step"] not in profiled]
        writes = run["writes"]
        prof = run["profile"]
        emit({"timing": {
            "name": "train_cli", "card": smi, "batch": bs, "steps": len(steps),
            "setup_ms": run["setup_ms"],
            "step_ms": [s["ms"] for s in steps], "fired": [s["fired"] for s in steps],
            "median_step_ms_after_first": statistics.median(clean) if clean else None,
            "clean_steps": len(clean), "bare_step_ms_phase8": bare_step["ms"],
            "bare_step_profiled_wall_ms_phase8": bare_step["profiled_wall_ms"],
            "bare_step_idle_share_phase8": bare_step["device_idle_share"],
            "next_ms": [s["next_ms"] for s in steps],
            "median_next_ms_after_first": statistics.median(s["next_ms"] for s in steps[1:]),
            "profiled_steps": sorted(profiled), "profile": prof,
            "eval_ms": [e["ms"] for e in evals],
            "eval_ms_per_batch": sum(e["ms"] for e in evals) / eval_batches,
            "checkpoint_bytes": writes[-1]["bytes"] if writes else None,
            "save_blocking_ms": [sv["blocking_ms"] for sv in run["saves"]],
            "save_snapshot_ms": [w["snapshot_ms"] for w in writes],
            "save_background_ms": [w["write_ms"] for w in writes],
            "max_memory_allocated_bytes": peak,
            "phase_s": time.perf_counter() - t_phase}})
    return launches, {"median_step_ms_after_first": statistics.median(clean) if clean else None}


def modes_phase(rng, smi: str, dev: torch.device, bf16_step: dict) -> dict:
    """Phase 11; returns each kernel's launches on the paths that run K1/K2
    (11a serving and its bf16 step, 11b serving)."""
    from mdctgan_tpu_torch import api, generate_cli
    from mdctgan_tpu_torch.configs import flagship_opt
    from mdctgan_tpu_torch.data import native
    from mdctgan_tpu_torch.data.synthetic import speech_like
    from mdctgan_tpu_torch.device import float32_policy
    from mdctgan_tpu_torch.models.discriminator import build_discriminator
    from mdctgan_tpu_torch.models.generator import build_generator
    from mdctgan_tpu_torch.ops import mdct as M
    from mdctgan_tpu_torch.ops import mdct_kernels as K
    from mdctgan_tpu_torch.ops.features import SpectralTransform
    from mdctgan_tpu_torch.options import TrainOptions, spectral_config_from_opt, train_options
    from mdctgan_tpu_torch.train import grad_truth as GT
    from mdctgan_tpu_torch.train.import_torch import export_to_torch_keys, generator_entries_for
    from mdctgan_tpu_torch.train.schedule import make_optimizers
    from mdctgan_tpu_torch.train.state import create_train_state
    from mdctgan_tpu_torch.train.step import build_inference_fn, build_train_step
    from mdctgan_tpu_torch.weights import random_jax_trees, state_dict_from_jax

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    request = speech_like(rng, MODES_REQUEST_S)  # at 16 kHz, the LR input
    audio_s = MODES_REQUEST_S
    paths = {}

    def counted(fn):
        """``fn()`` with both counters set to 0 just before it; (its result,
        the kernels' launches, the matmul form's calls)."""
        K.reset_launch_counts()
        M.reset_matmul_counts()
        result = fn()
        return result, dict(K.LAUNCHES), dict(M.MATMULS)

    def serve(label: str, opt: dict, state: dict, fused: bool, precisions=("f32",),
              compare_s: float = MODES_REQUEST_S) -> dict:
        """``api.upsample`` of the request on the card in each precision
        (counted, timed), card against CPU in float32 on the waveform of
        its first ``compare_s`` seconds and on the logits of 2 segments;
        returns the launches summed over the precisions."""
        total = {name: 0 for name in K.LAUNCHES}
        for precision in precisions:
            o = dict(opt, fp16=precision == "bf16")
            model = api.create_model(o, "cuda", state_dict=state)
            if model.transform.fused != fused:
                raise AssertionError(f"{label}: fused {model.transform.fused}, expected {fused}")
            out, launches, matmuls = counted(lambda: api.upsample(
                request, 16000, model, is_lr_input=True, gen_overlap=512,
                batch_size=MAIN_BATCH))
            for k, v in launches.items():
                total[k] += v
            if out.shape != (round(len(request) * 3),) or not np.isfinite(out).all():
                raise AssertionError(f"{label} {precision}: bad output {out.shape}")
            kernels_ran = all(launches[k] > 0 for k in ("mdct_spectro", "imdct_audio"))
            dense = launches["mdct_spectro_dense"] + launches["imdct_audio_dense"]
            if fused != kernels_ran or dense or (fused == (matmuls["mdct_matmul"] > 0)):
                raise AssertionError(f"{label} {precision}: launches {launches}, matmul form "
                                     f"{matmuls}, fused {fused}")
            walls = []  # as phase 7 times the flagship: a warm-up, then 20
            for _ in range(21):
                t0 = time.perf_counter()
                api.upsample(request, 16000, model, is_lr_input=True, gen_overlap=512,
                             batch_size=MAIN_BATCH)
                walls.append((time.perf_counter() - t0) * 1e3)
            seg = model.transform.cfg.segment_length
            x = torch.from_numpy(speech_like(rng, MAIN_BATCH * seg / 16000)[
                : MAIN_BATCH * seg].reshape(MAIN_BATCH, seg)).to(dev)
            with torch.inference_mode():
                g_in = model.transform.g_input(model.transform.lr_forward(x)[0])
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                gen_ms = time_ms(lambda: model.generator(g_in), runs=20, inner=1)
            wall = statistics.median(walls[1:])
            emit({"timing": {"name": f"{label}_serving", "precision": precision, "card": smi,
                             "request_s": audio_s, "ms": wall,
                             "ms_per_audio_s": wall / audio_s, "launches": launches,
                             "matmul_form_calls": matmuls,
                             "generator_forward_ms": gen_ms, "batch": MAIN_BATCH,
                             "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}})
            if precision != "f32":
                continue
            cpu_model = api.create_model(o, "cpu", state_dict=state)
            part = request[: round(compare_s * 16000)]
            if len(part) < len(request):
                out = api.upsample(part, 16000, model, is_lr_input=True, gen_overlap=512,
                                   batch_size=MAIN_BATCH)
            ref = api.upsample(part, 16000, cpu_model, is_lr_input=True, gen_overlap=512,
                               batch_size=2)
            scale = float(np.abs(ref).max())
            check(f"{label} upsample card vs CPU", float(np.abs(out - ref).max()),
                  2e-3 * scale, request_s=compare_s, max_abs_ref=scale)
            with torch.inference_mode():
                card_logits = model.generator.logits(g_in[:2]).cpu()
                cpu_logits = cpu_model.generator.logits(g_in[:2].cpu())
            ref_scale = float(cpu_logits.abs().max())
            check(f"{label} logits card vs CPU", max_err(card_logits, cpu_logits),
                  5e-4 * max(1.0, ref_scale), batch=2, max_abs_ref=ref_scale)
            del cpu_model
        return total

    def mark(part: str) -> None:
        emit({"phase": 11, "part": part, "t_s": time.perf_counter() - t_phase})

    # 11a. train.sh's flags + --mask --n_blocks_attn_l 1 ----------------------
    opt_a = dict(flagship_opt(), **LOCAL_ATTN)
    state_a = state_dict_from_jax(*random_jax_trees(build_generator(opt_a), rng))
    d_state_a = state_dict_from_jax(*random_jax_trees(build_discriminator(opt_a), rng))
    paths["local_attn_serving"] = serve("11a local attention + mask", opt_a, state_a, True,
                                        ("f32", "bf16"))
    mark("11a serving")
    cfg_a = spectral_config_from_opt(opt_a)
    seg = cfg_a.segment_length
    # one float32 SGD(1) step at batch 2, the CPU fed the card's spectra
    batch2 = GT.inputs("noise", rng, 2, seg)
    card_t, cpu_t = SpectralTransform(cfg_a, dev), SpectralTransform(cfg_a, cpu)
    card_losses, _ = GT.sgd_step(opt_a, GT.load_nets(opt_a, state_a, d_state_a), card_t,
                                 batch2, dev)
    cpu_losses, _ = GT.sgd_step(opt_a, GT.load_nets(opt_a, state_a, d_state_a),
                                GT.SharedSpectra(cpu_t, card_t), batch2, cpu)
    check("11a SGD step losses card vs CPU (max rel)",
          max(abs(card_losses[k] - v) / abs(v) for k, v in cpu_losses.items()), 1e-3,
          batch=2, card=card_losses, cpu=cpu_losses)
    mark("11a SGD step")
    # the bf16 step at batch 20: median of 10 after 3 warm-ups, by CUDA events
    opt_a16 = dict(opt_a, fp16=True)
    tro = train_options(opt_a16)
    g_tx, d_tx = make_optimizers(tro["lr"], tro["beta1"], tro["niter"], tro["niter_decay"], 1000)
    state = create_train_state(build_generator(opt_a16), build_discriminator(opt_a16), g_tx,
                               d_tx, device=dev, rng=torch.Generator().manual_seed(SEED))
    step = build_train_step(card_t, g_tx, d_tx, use_lsgan=not tro["no_lsgan"],
                            lambda_feat=tro["lambda_feat"], n_layers_d=tro["n_layers_D"],
                            num_d=tro["num_D"], use_ganfeat=not tro["no_ganFeat_loss"],
                            noise=torch.Generator().manual_seed(SEED))
    data = GT.inputs("speech", rng, TRAIN_BATCH, seg)
    batch20 = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}

    def steps():
        times, history = [], []
        torch.cuda.reset_peak_memory_stats()
        for i in range(3 + MODES_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, metrics = step(state, batch20)
            end.record()
            end.synchronize()
            history.append({k: float(v) for k, v in metrics.items()})
            if i >= 3:
                times.append(start.elapsed_time(end))
        return times, history

    (times, history), launches, matmuls = counted(steps)
    if not all(math.isfinite(v) for h in history for v in h.values()):
        raise AssertionError("11a: a bf16 train loss is not finite")
    expected = {name: 0 for name in K.LAUNCHES}
    expected["mdct_spectro"] = 2 * (3 + MODES_STEPS)
    if launches != expected or any(matmuls.values()):
        raise AssertionError(f"11a step launches {launches}, matmul form {matmuls}")
    paths["local_attn_train_fp16"] = launches
    step_ms = statistics.median(times)
    emit({"timing": {"name": "11a_train_step", "precision": "bf16", "card": smi,
                     "batch": TRAIN_BATCH, "ms": step_ms, "ms_min": min(times),
                     "ms_max": max(times), "samples_per_s": TRAIN_BATCH / step_ms * 1e3,
                     "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                     "phase8_flagship_bf16_ms": bf16_step["ms"],
                     "over_flagship": step_ms / bf16_step["ms"] - 1.0,
                     "losses_last": history[-1]}})
    del state, step, batch20
    mark("11a bf16 steps")

    # 11b. generate_audio.sh's flags + --n_local_enhancers 2, float32 ----------
    f32_flags = [a for a in GENERATE_FLAGS if a != "--fp16"]
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="modes_", dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        ckpt = ["--checkpoints_dir", str(tmp / "out")]
        opt_b = vars(TrainOptions().parse(f32_flags + ["--n_local_enhancers", "2"] + ckpt,
                                          save=False))
        state_b = state_dict_from_jax(*random_jax_trees(build_generator(opt_b), rng))
        paths["two_enhancers_serving"] = serve("11b two enhancers", opt_b, state_b, True,
                                               compare_s=1.0)
        mark("11b serving")

        # 11c. the CLI's default spectral flags: dB, per-sample, no centring --
        bare = {"--arcsinh_transform", "--abs_spectro", "--abs_norm", "--center"}
        flags_c = [a for a in f32_flags if a not in bare] + [
            "--input_nc", "1", "--segment_length", str(DB_SEGMENT)]
        opt_c = TrainOptions().parse(flags_c + ckpt, save=False)
        cfg_c = spectral_config_from_opt(opt_c)
        if cfg_c.n_bins != opt_c.bins:
            raise AssertionError(f"11c: {cfg_c.n_bins} frames, the generator takes {opt_c.bins}")
        gen_c = build_generator(opt_c)
        state_c = state_dict_from_jax(*random_jax_trees(gen_c, rng))
        state_c[HEAD] *= 0.01
        (tmp / "pretrained").mkdir()
        torch.save(export_to_torch_keys(state_c, generator_entries_for(gen_c)),
                   tmp / "pretrained" / "latest_net_G.pth")
        wav = tmp / "speech_1000ms.wav"
        native.write_wav16(str(wav), speech_like(rng, 1.0, 48000), 48000)

        def run(name, *extra):
            return generate_cli.main(flags_c + ckpt + [
                "--name", name, "--dataroot", str(wav), "--load_pretrain",
                str(tmp / "pretrained"), *extra])

        cuda_id = ["--gpu_ids", str(dev.index or 0)]
        card_c, launches, matmuls = counted(lambda: run("c_card", *cuda_id))
        emit({"generate_run": {"phase": "11c", "launches": launches, "matmul_form": matmuls,
                               "setup_ms": card_c["setup_ms"], "file_ms": card_c["file_ms"]}})
        if any(launches.values()) or not (matmuls["mdct_matmul"] > 0
                                          and matmuls["imdct_matmul"] > 0):
            raise AssertionError(f"11c launches {launches}, matmul form {matmuls}")
        # card against CPU at the same batch, so that each batch draws the
        # same pseudo-phase signs (one generator per batch, drawn on the CPU)
        pair = {}
        for name, ids in (("c_card2", cuda_id), ("c_cpu2", ["--gpu_ids", "-1"])):
            run(name, *ids, "--batchSize", "2")
            pair[name] = native.read(str(tmp / "out" / name / "sr_audio.wav"))[0]
        scale = float(np.abs(pair["c_cpu2"]).max())
        check("11c generate SR WAV card vs CPU (dB, float32)",
              float(np.abs(pair["c_card2"] - pair["c_cpu2"]).max()), 2e-3 * scale,
              max_abs_ref=scale, samples=len(pair["c_cpu2"]))
        mark("11c generate CLI")
        serve_c = serve("11c dB per-sample uncentred", vars(opt_c), state_c, False,
                        compare_s=1.0)
        if any(serve_c.values()):
            raise AssertionError(f"11c serving launched {serve_c}")
        # TF32 control: the matmul form's spectrum against float64
        x = torch.from_numpy(GT.inputs("speech", rng, GENERATE_BATCH, DB_SEGMENT)["lr_audio"])
        truth = SpectralTransform(cfg_c, cpu, torch.float64).mdct(x.double())
        card_c_t = SpectralTransform(cfg_c, dev)
        rel = {}
        for tf32 in (False, True):
            with torch.inference_mode(), float32_policy(allow_tf32=tf32):
                got = card_c_t.mdct(x.to(dev))
            rel[tf32] = max_err(got, truth.to(dev)) / float(truth.abs().max())
        # 1e-5: the policy read 1.22e-6 and TF32 7.55e-5 on this input
        # (NVIDIA H100 80GB HBM3, 700 W), so each side has a margin of ~8x
        check("11c matmul form vs float64 (max rel), TF32 off", rel[False], 1e-5,
              batch=GENERATE_BATCH, tf32_allowed=rel[True])
        if not rel[True] > 1e-5:
            raise AssertionError(f"TF32 passes the matmul form's bound: {rel[True]}")

    mark("11c serving and TF32 control")
    # 11d. explicit and raw at a small depth, one batch each ------------------
    # The card's run is held end to end against the CPU's run fed the card's
    # LR spectrum, and the MDCT on its own.  The CPU's run from its own
    # spectrum is read beside it, with the CPU's two runs' distance: the
    # explicit mode takes the dB of each sign's part of the spectrum, so
    # where a coefficient is near zero the MDCT's rounding moves the
    # generator's input, and the SR with it, far more than its own size.
    small = dict(flagship_opt(), n_blocks_global=1, n_blocks_attn_g=1, n_blocks_local=1)
    for label, extra in (("explicit", dict(arcsinh_transform=False, explicit_encoding=True,
                                           abs_norm=False, input_nc=2, output_nc=2)),
                         ("raw", dict(arcsinh_transform=False, raw_mdct=True, input_nc=1))):
        opt_d = dict(small, **extra)
        state_d = state_dict_from_jax(*random_jax_trees(build_generator(opt_d), rng))
        seg = opt_d["segment_length"]
        x = torch.from_numpy(speech_like(rng, 2 * seg / 16000)[: 2 * seg].reshape(2, seg))
        card_d = api.create_model(opt_d, "cuda", state_dict=state_d)
        cpu_d = api.create_model(opt_d, "cpu", state_dict=state_d)
        (_, sr_card), launches, matmuls = counted(lambda: card_d.inference(x.to(dev)))
        if any(launches.values()) or not all(matmuls.values()):
            raise AssertionError(f"11d {label}: launches {launches}, matmul form {matmuls}")
        sr_card = sr_card.cpu()
        tc, tp = card_d.transform, cpu_d.transform
        with torch.inference_mode():
            spec_card, spec_cpu = tc.mdct(x.to(dev)).cpu(), tp.mdct(x)
        scale = float(spec_cpu.abs().max())
        check(f"11d {label} spectrum card vs CPU", max_err(spec_card, spec_cpu), 1e-5 * scale,
              batch=2, max_abs_ref=scale)
        fed = build_inference_fn(cpu_d.generator, GT.SharedSpectra(tp, tc), out_length=seg)
        _, sr_fed = fed(x)
        _, sr_cpu = cpu_d.inference(x)
        scale = float(sr_fed.abs().max())
        check(f"11d {label} SR card vs CPU fed the card's LR spectrum",
              max_err(sr_card, sr_fed), 2e-3 * scale, batch=2, max_abs_ref=scale)
        emit({"reading": f"11d {label} SR card vs the CPU's run from its own spectrum",
              "batch": 2, "max_abs_err": max_err(sr_card, sr_cpu),
              "cpu_own_vs_cpu_fed": max_err(sr_cpu, sr_fed),
              "max_abs_ref": float(sr_cpu.abs().max()), "matmul_form": matmuls})
    emit({"phase": 11, "phase_s": time.perf_counter() - t_phase})
    return paths


def dp_rank(ranks, seed: int, updates_path: str) -> dict:
    """Phase 12b in one rank (``parallel.mesh.spawn``; the two ranks share
    the card over gloo): the flagship's SGD(1) step on this rank's rows of
    the global batch, in float32 and with TF32 allowed (the control), then
    ``DP_TIMED_STEPS`` bf16 Adam steps timed after one warm-up.  The
    weights and the batch come from ``seed``, as in the parent.  Rank 0
    saves both steps' updates to ``updates_path``; every rank returns its
    losses, the digest of its nets after each step, its launches, its times
    and TF32's setting as the fresh process found it."""
    import hashlib

    from mdctgan_tpu_torch.configs import flagship_opt
    from mdctgan_tpu_torch.device import float32_policy
    from mdctgan_tpu_torch.models.discriminator import build_discriminator
    from mdctgan_tpu_torch.models.generator import build_generator
    from mdctgan_tpu_torch.ops import mdct_kernels as K
    from mdctgan_tpu_torch.ops.features import SpectralTransform
    from mdctgan_tpu_torch.options import spectral_config_from_opt, train_options
    from mdctgan_tpu_torch.train import grad_truth as GT
    from mdctgan_tpu_torch.train.schedule import make_optimizers
    from mdctgan_tpu_torch.train.state import create_train_state
    from mdctgan_tpu_torch.train.step import build_train_step
    from mdctgan_tpu_torch.weights import random_jax_trees, state_dict_from_jax

    out = {"rank": ranks.rank, "cudnn_allow_tf32_at_start": torch.backends.cudnn.allow_tf32}
    K.reset_launch_counts()
    dev = ranks.device
    opt = flagship_opt()
    cfg = spectral_config_from_opt(opt)
    rng = np.random.default_rng(seed)
    g_sd = state_dict_from_jax(*random_jax_trees(build_generator(opt), rng))
    d_sd = state_dict_from_jax(*random_jax_trees(build_discriminator(opt), rng))
    batch = GT.inputs("noise", rng, DP_BATCH, cfg.segment_length)
    rows = ranks.host_rows(DP_BATCH)
    local = {k: v[rows] for k, v in batch.items()}
    mask = (torch.arange(DP_BATCH, device=dev) < DP_REAL_ROWS).float()[rows]
    transform = SpectralTransform(cfg, dev)
    updates, out["losses"], out["digest"], out["step_s"] = {}, {}, {}, {}
    with float32_policy():
        for name, tf32 in (("f32", False), ("tf32", True)):
            nets = GT.load_nets(opt, g_sd, d_sd)
            t0 = time.perf_counter()
            out["losses"][name], updates[name] = GT.sgd_step(
                opt, nets, transform, local, dev, allow_tf32=tf32, sample_mask=mask,
                ranks=ranks)
            out["step_s"][name] = time.perf_counter() - t0
            h = hashlib.sha256()
            for net in nets.values():
                for t in net.state_dict().values():
                    h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                             .numpy().tobytes())
            out["digest"][name] = h.hexdigest()
            del nets
        if ranks.is_main:
            torch.save({name: {net: {k: v.float() for k, v in u.items()}
                               for net, u in per.items()} for name, per in updates.items()},
                       updates_path)
        del updates
        torch.cuda.empty_cache()

        opt16 = dict(opt, fp16=True)
        tro = train_options(opt16)
        g_tx, d_tx = make_optimizers(tro["lr"], tro["beta1"], tro["niter"], tro["niter_decay"],
                                     1000)
        state = create_train_state(build_generator(opt16), build_discriminator(opt16), g_tx,
                                   d_tx, device=dev, rng=torch.Generator().manual_seed(SEED),
                                   ranks=ranks)
        step = build_train_step(transform, g_tx, d_tx, n_layers_d=tro["n_layers_D"],
                                num_d=tro["num_D"], ranks=ranks)
        on_card = {k: torch.from_numpy(v).to(dev) for k, v in local.items()}
        times, losses = [], []
        for _ in range(DP_TIMED_STEPS + 1):
            t0 = time.perf_counter()
            state, metrics = step(state, on_card)
            # float() waits for the step; the next step's collectives wait
            # for the other rank
            losses.append({k: float(v) for k, v in metrics.items()})
            times.append((time.perf_counter() - t0) * 1e3)
        out.update(bf16_step_ms=times[1:], bf16_losses=losses, launches=dict(K.LAUNCHES),
                   max_memory_allocated_bytes=torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else None)
    return out


def parallel_phase(smi: str, dev: torch.device, bare_step: dict, cli_step: dict) -> dict:
    """Phase 12, data parallelism on the one card: (a) the train CLI as one
    ``--multihost`` rank over NCCL against the single-card run, and the
    world-1 step's collective cost; (b) two ranks sharing the card over
    gloo against one rank; (c) ``api.upsample`` over two replicas on the
    card against one; (d) ``--gpu_ids 0,1`` refused.  Returns each kernel's
    launches on the three paths."""
    import os

    from mdctgan_tpu_torch import api, generate_cli, train_cli
    from mdctgan_tpu_torch.configs import flagship_opt
    from mdctgan_tpu_torch.data.synthetic import speech_like
    from mdctgan_tpu_torch.models.discriminator import build_discriminator
    from mdctgan_tpu_torch.models.generator import build_generator
    from mdctgan_tpu_torch.ops import mdct_kernels as K
    from mdctgan_tpu_torch.ops.features import SpectralTransform
    from mdctgan_tpu_torch.options import spectral_config_from_opt, train_options
    from mdctgan_tpu_torch.parallel import mesh
    from mdctgan_tpu_torch.train import grad_truth as GT
    from mdctgan_tpu_torch.train.schedule import make_optimizers
    from mdctgan_tpu_torch.train.state import create_train_state
    from mdctgan_tpu_torch.train.step import build_train_step
    from mdctgan_tpu_torch.weights import random_jax_trees, state_dict_from_jax

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    opt = flagship_opt()
    cfg = spectral_config_from_opt(opt)
    seg = cfg.segment_length
    paths = {}
    torchrun = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
                "MASTER_ADDR": "127.0.0.1"}
    saved_env = {k: os.environ.get(k) for k in (*torchrun, "MASTER_PORT")}

    def one_rank_env():
        os.environ.update(torchrun, MASTER_PORT=str(mesh.free_port()))

    def part_done(part):
        emit({"phase": 12, "part": part, "t_s": time.perf_counter() - t_phase})

    (ROOT / "build").mkdir(exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(prefix="parallel_", dir=ROOT / "build") as tmp:
            tmp = Path(tmp)
            # 12a. the train CLI as one --multihost rank (NCCL, world size 1)
            # against the single-card run on the same batches, bf16 and f32
            subprocess.run([sys.executable, str(ROOT / "tools" / "make_corpus.py"),
                            str(tmp / "corpus"), *CORPUS], check=True, timeout=300)
            data = ["--dataroot", str(tmp / "corpus" / "train.csv"),
                    "--evalroot", str(tmp / "corpus" / "eval.csv")]
            cli_launches = {name: 0 for name in K.LAUNCHES}
            cli_runs = {}
            card = ["--gpu_ids", "0" if dev.type == "cuda" else "-1"]
            # Step 1 reads the same bits in both runs (the same batch and
            # state; at world 1 the shares and the summed statistics are the
            # single card's numbers), so it is held bit for bit, as 10d holds
            # its first step after a restore.  Step 2 follows one backward,
            # which the card does not repeat bit for bit: held at 10d's
            # bounds, with a second single-card run's distance read as the
            # control.  (On a tail of 2 rows two single-card runs' second
            # steps read 1.58e-3 apart in float32 and 2.52e-2 in bf16, past
            # these bounds, by ``probes/dp_probe.py --parts tail``; so the
            # tail here is 16 rows.)
            for precision in ("bf16", "f32"):
                flags = DP_CLI_FLAGS + data
                if precision == "f32":
                    flags = [f for f in flags if f != "--fp16"]
                kinds = [("single", card), ("multihost", card + ["--multihost"]),
                         ("single_again", card)]
                runs = {}
                for kind, extra in kinds:
                    one_rank_env()
                    K.reset_launch_counts()
                    run = train_cli.main(flags + extra + [
                        "--checkpoints_dir", str(tmp / f"{precision}_{kind}"), "--name", "run"])
                    launches = dict(K.LAUNCHES)
                    run.pop("state")
                    runs[kind] = run
                    if kind == "multihost":
                        for k, v in launches.items():
                            cli_launches[k] += v
                        expected = {name: 0 for name in K.LAUNCHES}
                        expected["mdct_spectro"] = 2 * len(run["steps"])
                        if launches != expected or launches != run["launches"]:
                            raise AssertionError(f"12a {precision} launches {launches}, "
                                                 f"expected {expected}")
                        ckpt = tmp / f"{precision}_{kind}" / "run" / "ckpt"
                        if not ((ckpt / "epoch_index.json").is_file()
                                and list(ckpt.glob("step_*.pt"))):
                            raise AssertionError(f"12a {precision}: no save under {ckpt}")
                losses = {kind: [{k: v for k, v in row.items() if k not in ("step", "epoch")}
                                 for row in r["losses"]] for kind, r in runs.items()}
                if not (len(losses["single"]) == len(losses["multihost"]) == 2 and all(
                        math.isfinite(v) for row in losses["multihost"] for v in row.values())):
                    raise AssertionError(f"12a {precision}: losses {losses}")

                def rel(a, b, i):
                    return max(abs(a[i][k] - v) / max(abs(v), 1e-30) for k, v in b[i].items())

                check(f"12a: train CLI --multihost world 1 (NCCL) vs one card, {precision}, "
                      "step 1 (losses, bit for bit)", rel(losses["multihost"], losses["single"], 0),
                      0.0, losses=losses)
                check(f"12a: train CLI --multihost world 1 vs one card, {precision}, step 2 "
                      "(losses, rel)", rel(losses["multihost"], losses["single"], 1),
                      DP_STEP2_BOUNDS[precision], control_two_single_card_runs=rel(
                          losses["single_again"], losses["single"], 1))
                cli_runs[precision] = {kind: {
                    "step_ms": [st["ms"] for st in r["steps"]],
                    "agree_ms": [st["agree_ms"] for st in r["steps"]],
                    "setup_ms": r["setup_ms"],
                    "save_blocking_ms": [sv["blocking_ms"] for sv in r["saves"]]}
                    for kind, r in runs.items()}
            paths["dp_multihost_train_cli"] = cli_launches
            emit({"dp_train_cli_runs": cli_runs, "card": smi})
            part_done("12a_cli")

            # the world-1 step's collectives: the bf16 step with and without
            # the group, in turns on the same card; and one host agreement
            opt16 = dict(opt, fp16=True)
            tro = train_options(opt16)
            g_tx, d_tx = make_optimizers(tro["lr"], tro["beta1"], tro["niter"],
                                         tro["niter_decay"], 1000)
            noise = GT.inputs("noise", np.random.default_rng(SEED), TRAIN_BATCH, seg)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in noise.items()}
            one_rank_env()
            ranks = mesh.init_multihost(dev.type)
            try:
                runs = {}
                for kind, r in (("plain", None), ("world1", ranks)):
                    state = create_train_state(
                        build_generator(opt16), build_discriminator(opt16), g_tx, d_tx,
                        device=dev, rng=torch.Generator().manual_seed(SEED), ranks=r)
                    step = build_train_step(SpectralTransform(cfg, dev), g_tx, d_tx,
                                            n_layers_d=tro["n_layers_D"], num_d=tro["num_D"],
                                            ranks=r)
                    runs[kind] = (state, step, [])

                def timed(kind):
                    state, step, times = runs[kind]
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    step(state, batch)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))

                for i in range(12):  # in turns; the first two of each warm up
                    for kind in (("plain", "world1") if i % 2 else ("world1", "plain")):
                        timed(kind)
                agree = []
                for _ in range(50):
                    t0 = time.perf_counter()
                    mesh.any_rank(False, ranks)
                    agree.append((time.perf_counter() - t0) * 1e3)
                ms = {kind: statistics.median(runs[kind][2][2:]) for kind in runs}
                emit({"timing": {
                    "name": "dp_world1_step_overhead", "card": smi, "precision": "bf16",
                    "batch": TRAIN_BATCH, "plain_ms": ms["plain"], "world1_ms": ms["world1"],
                    "collective_overhead_ms": ms["world1"] - ms["plain"],
                    "plain_ms_all": runs["plain"][2], "world1_ms_all": runs["world1"][2],
                    "phase8_bare_step_ms": bare_step["ms"],
                    "phase10_cli_step_ms": cli_step.get("median_step_ms_after_first"),
                    "agree_ms_median": statistics.median(agree),
                    "agree_ms_max": max(agree)}})
                del runs
            finally:
                torch.distributed.destroy_process_group()
            torch.cuda.empty_cache()
            part_done("12a_overhead")

            # 12b. two ranks on the card over gloo (NCCL refuses two ranks on
            # one device) against one rank, at batch 20 = 10 + 10 with a tail
            # mask keeping 16.  The updates are held as phase 8a holds card
            # against CPU: each tensor k within rel*||ref_k|| + 1e-3 +
            # C*||T_K1 - T_plain||_k, T the float64 step on the card fed K1's
            # spectra and the plain version's, at this batch and draw.
            rng = np.random.default_rng(DP_SEED)
            g_sd = state_dict_from_jax(*random_jax_trees(build_generator(opt), rng))
            d_sd = state_dict_from_jax(*random_jax_trees(build_discriminator(opt), rng))
            global_batch = GT.inputs("noise", rng, DP_BATCH, seg)
            mask = (torch.arange(DP_BATCH, device=dev) < DP_REAL_ROWS).float()
            card_t = SpectralTransform(cfg, dev)
            t0 = time.perf_counter()
            ref_losses, ref = GT.sgd_step(opt, GT.load_nets(opt, g_sd, d_sd), card_t,
                                          global_batch, dev, sample_mask=mask)
            one_rank_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            f64_t = SpectralTransform(cfg, dev, torch.float64)
            truths = [GT.sgd_step(opt, GT.load_nets(opt, g_sd, d_sd, torch.float64),
                                  GT.SharedSpectra(f64_t, source), global_batch, dev,
                                  sample_mask=mask)[1]
                      for source in (card_t, SpectralTransform(cfg, cpu))]
            moved = {net: {k: float((t - truths[1][net][k]).norm())
                           for k, t in truths[0][net].items()} for net in GT.BOUNDS}
            f64_s = time.perf_counter() - t0
            del truths, g_sd, d_sd
            torch.cuda.empty_cache()
            part_done("12b_reference")
            ranks_out = mesh.spawn(dp_rank, [dev, dev],
                                   args=(DP_SEED, str(tmp / "updates.pt")),
                                   backend="gloo", deadline_s=600)
            updates = torch.load(tmp / "updates.pt", weights_only=True)
            part_done("12b_ranks")
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    first = ranks_out[0]
    if not all(r["digest"] == first["digest"] for r in ranks_out):
        raise AssertionError("12b: the two ranks' states differ after the step")
    loss_share = max(abs(first["losses"]["f32"][k] - v) / (1e-6 + 5e-5 * abs(v))
                     for k, v in ref_losses.items())
    result = {"batch": DP_BATCH, "real_rows": DP_REAL_ROWS, "ranks": 2, "backend": "gloo",
              "losses_one_rank": ref_losses, "losses_two_ranks": first["losses"]["f32"],
              "one_rank_step_s": one_rank_s, "f64_truths_s": f64_s}
    shares = {}
    for name in ("f32", "tf32"):
        for net, rel in GT.BOUNDS.items():
            got = {k: v.double() for k, v in updates[name][net].items()}
            slack = {k: GT.CONDITIONING_FACTOR * v for k, v in moved[net].items()}
            r = GT.normwise(ref[net], got, rel, slack=slack)
            plain = GT.normwise(ref[net], got, rel)
            result[f"{name}_{net}"] = {"max_share_of_bound": r["max_share"],
                                       "worst": r["worst"],
                                       "max_share_of_jax_bound": plain["max_share"]}
            shares[name, net] = r["max_share"]
    emit({"control": "12b: two ranks with TF32 allowed vs one rank (updates)",
          **{net: result[f"tf32_{net}"] for net in GT.BOUNDS}})
    check("12b: two ranks (gloo, one card) vs one rank, losses (share of 1e-6 + 5e-5 rel)",
          loss_share, 1.0, **{k: v for k, v in result.items() if not k.startswith("tf32")})
    check("12b: two ranks vs one rank, updates (share of phase 8a's bound)",
          max(shares["f32", net] for net in GT.BOUNDS), 1.0)
    launches = {name: sum(r["launches"][name] for r in ranks_out) for name in K.LAUNCHES}
    expected = {name: 0 for name in K.LAUNCHES}
    expected["mdct_spectro"] = 2 * 2 * (2 + DP_TIMED_STEPS + 1)  # two ranks, K1 twice a step
    if launches != expected:
        raise AssertionError(f"12b launches {launches}, expected {expected}")
    if not all(math.isfinite(v) for r in ranks_out for row in r["bf16_losses"]
               for v in row.values()):
        raise AssertionError("12b: a bf16 loss is not finite")
    paths["dp_two_ranks_train"] = launches
    emit({"timing": {
        "name": "dp_two_ranks_step", "card": smi, "backend": "gloo, two ranks on one card",
        "batch_per_rank": DP_BATCH // 2, "precision": "bf16",
        "step_ms": {r["rank"]: r["bf16_step_ms"] for r in ranks_out},
        "median_step_ms": {r["rank"]: statistics.median(r["bf16_step_ms"]) for r in ranks_out},
        "sgd_step_s": {r["rank"]: r["step_s"] for r in ranks_out},
        "cudnn_allow_tf32_at_rank_start": [r["cudnn_allow_tf32_at_start"] for r in ranks_out],
        "max_memory_allocated_bytes": {r["rank"]: r["max_memory_allocated_bytes"]
                                       for r in ranks_out}}})

    # 12c. api.upsample over two replicas on the card against one, at the
    # serving chain's bound
    rng = np.random.default_rng(SEED)
    model = api.create_model(opt, dev, state_dict=state_dict_from_jax(
        *random_jax_trees(build_generator(opt), rng)))
    request = speech_like(rng, MODES_REQUEST_S)
    two = mesh.make_mesh([dev] * DP_REPLICAS)
    kw = dict(is_lr_input=True, gen_overlap=512, batch_size=MAIN_BATCH)
    K.reset_launch_counts()
    single = api.upsample(request, 16000, model, **kw)
    # one replica's launches a batch, each replica launching once
    expected = {name: DP_REPLICAS * n for name, n in K.LAUNCHES.items()}
    K.reset_launch_counts()
    over = api.upsample(request, 16000, model, mesh=two, **kw)
    launches = dict(K.LAUNCHES)
    if launches != expected or launches["mdct_spectro"] == 0:
        raise AssertionError(f"12c launches {launches}, expected {expected}")
    paths["dp_replicas_serving"] = launches
    scale = float(np.abs(single).max())
    check("12c: upsample over two replicas on the card vs one (waveform)",
          float(np.abs(over - single).max()), 2e-3 * scale, request_s=MODES_REQUEST_S,
          replicas=DP_REPLICAS, max_abs_ref=scale)
    walls = {"one": [], "replicas": []}
    for _ in range(5):
        for kind, extra in (("one", {}), ("replicas", {"mesh": two})):
            t0 = time.perf_counter()
            api.upsample(request, 16000, model, **kw, **extra)
            walls[kind].append((time.perf_counter() - t0) * 1e3)
    emit({"timing": {"name": "dp_replicas_upsample", "card": smi,
                     "request_s": MODES_REQUEST_S, "replicas": DP_REPLICAS,
                     **{f"{k}_ms": statistics.median(v) for k, v in walls.items()},
                     "note": "upsample(mesh=) copies the generator to each replica per call"}})
    del model

    # 12d. two ids on a host of one card: both CLIs refuse before any work
    if torch.cuda.device_count() == 1:
        for cli in (train_cli, generate_cli):
            try:
                with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
                    cli.main(DP_CLI_FLAGS + ["--gpu_ids", "0,1", "--checkpoints_dir", tmp,
                                             "--name", "x"])
            except ValueError as e:
                emit({"check": f"12d: {cli.__name__} --gpu_ids 0,1 on one card raises",
                      "error": str(e)})
            else:
                raise AssertionError(f"{cli.__name__} --gpu_ids 0,1 ran on one card")
    emit({"phase": 12, "phase_s": time.perf_counter() - t_phase})
    return paths


def dense_phase(rng, smi: str, dev: torch.device) -> dict:
    """Phase 13: the flagship (full width and depth) at n_fft 960, hop 480,
    win 960, segment 127 * 480, where K1 and K2 run their dense forms.  (a)
    three ``api.upsample`` requests in float32 and in bf16, each batch
    launching ``mdct_spectro_dense`` and ``imdct_audio_dense`` once and the
    FFT forms never, one request held against the port on the CPU at phase
    6's bound; (b) ``DENSE_STEPS`` bf16 Adam steps at batch 20, finite
    losses, G and D moving, ``mdct_spectro_dense`` twice a step and nothing
    else.  Returns each path's launches."""
    from mdctgan_tpu_torch import api
    from mdctgan_tpu_torch.configs import flagship_opt
    from mdctgan_tpu_torch.data.dataset import AudioAppDataset
    from mdctgan_tpu_torch.data.synthetic import speech_like
    from mdctgan_tpu_torch.models.discriminator import build_discriminator
    from mdctgan_tpu_torch.models.generator import build_generator
    from mdctgan_tpu_torch.ops import mdct_kernels as K
    from mdctgan_tpu_torch.ops.features import SpectralTransform
    from mdctgan_tpu_torch.ops.resample import degrade_lr
    from mdctgan_tpu_torch.options import spectral_config_from_opt, train_options
    from mdctgan_tpu_torch.train.schedule import make_optimizers
    from mdctgan_tpu_torch.train.state import create_train_state
    from mdctgan_tpu_torch.train.step import build_train_step
    from mdctgan_tpu_torch.weights import random_jax_trees, state_dict_from_jax

    t_phase = time.perf_counter()
    opt = dict(flagship_opt(), **DENSE_GEOMETRY)
    seg = opt["segment_length"]
    state = state_dict_from_jax(*random_jax_trees(build_generator(opt), rng))
    requests = [speech_like(rng, s) for s in GENERATE_SECONDS]
    # the batches of MAIN_BATCH segments each request is served in
    batches = sum(-(-len(AudioAppDataset(a, 16000, seg, 512).segments_of(np.zeros(3 * len(a))))
                    // MAIN_BATCH) for a in requests)
    out, served = {}, {}

    # 13a. serving, float32 and bf16 -----------------------------------------
    for path, run_opt in (("n960_serving", opt), ("n960_serving_fp16", dict(opt, fp16=True))):
        model = api.create_model(run_opt, device=dev, state_dict=state)
        K.reset_launch_counts()
        served[path] = [api.upsample(a, 16000, model, is_lr_input=True, gen_overlap=512,
                                     batch_size=MAIN_BATCH) for a in requests]
        out[path] = dict(K.LAUNCHES)
        # the longest request's wall time, as phase 7 times serving: a
        # warm-up, then the median of DENSE_TIMED_REQUESTS
        walls = []
        for _ in range(DENSE_TIMED_REQUESTS + 1):
            t0 = time.perf_counter()
            api.upsample(requests[-1], 16000, model, is_lr_input=True, gen_overlap=512,
                         batch_size=MAIN_BATCH)
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(walls[1:])
        emit({"timing": {"name": "upsample_end_to_end", "path": path, "card": smi,
                         "n_fft": opt["n_fft"], "request_s": len(requests[-1]) / 16000,
                         "ms": wall, "ms_per_audio_s": wall / (len(requests[-1]) / 16000)}})
        del model
        expected = {name: 0 for name in K.LAUNCHES}
        expected["mdct_spectro_dense"] = expected["imdct_audio_dense"] = batches
        emit({"phase": 13, "path": path, "launches": out[path], "expected": expected,
              "requests_s": [len(a) / 16000 for a in requests], "n_fft": opt["n_fft"]})
        if out[path] != expected:
            raise AssertionError(f"{path} launches {out[path]}, expected {expected}")
        for a, sr in zip(requests, served[path]):
            if sr.shape != (round(len(a) * 3),) or not np.isfinite(sr).all():
                raise AssertionError(f"{path}: bad output {sr.shape} for {len(a)} samples")
    cpu_model = api.create_model(opt, device="cpu", state_dict=state)
    ref = api.upsample(requests[0], 16000, cpu_model, is_lr_input=True, gen_overlap=512,
                       batch_size=2)
    del cpu_model
    scale = float(np.abs(ref).max())
    check("13a: upsample at n_fft 960 card vs CPU",
          float(np.abs(served["n960_serving"][0] - ref).max()), 2e-3 * scale,
          request_s=len(requests[0]) / 16000, max_abs_ref=scale)
    emit({"reading": "13a: upsample at n_fft 960, bf16 vs float32 on the card",
          "max_abs_diff": [float(np.abs(p - q).max()) for p, q in
                           zip(served["n960_serving_fp16"], served["n960_serving"])]})

    # 13b. DENSE_STEPS bf16 Adam steps at batch 20 ----------------------------
    run_opt = dict(opt, fp16=True)
    tro = train_options(run_opt)
    cfg = spectral_config_from_opt(run_opt)
    hr = speech_like(rng, TRAIN_BATCH * seg / 48000, 48000)[: TRAIN_BATCH * seg]
    hr = hr.reshape(TRAIN_BATCH, seg)
    with torch.no_grad():
        lr = degrade_lr(torch.from_numpy(hr), 48000, cfg.lr_sampling_rate,
                        cfg.hr_sampling_rate)[:, :seg].contiguous()
    batch = {"lr_audio": lr.to(dev), "hr_audio": torch.from_numpy(hr).to(dev)}
    g_tx, d_tx = make_optimizers(tro["lr"], tro["beta1"], tro["niter"], tro["niter_decay"], 1000)
    train_state = create_train_state(build_generator(run_opt), build_discriminator(run_opt),
                                     g_tx, d_tx, device=dev,
                                     rng=torch.Generator().manual_seed(SEED))
    step = build_train_step(SpectralTransform(cfg, dev), g_tx, d_tx,
                            use_lsgan=not tro["no_lsgan"], lambda_feat=tro["lambda_feat"],
                            n_layers_d=tro["n_layers_D"], num_d=tro["num_D"],
                            use_ganfeat=not tro["no_ganFeat_loss"])
    first = {n: torch.cat([p.detach().ravel() for p in m.parameters()])
             for n, m in (("G", train_state.generator), ("D", train_state.discriminator))}
    K.reset_launch_counts()
    losses = []
    for _ in range(DENSE_STEPS):
        train_state, metrics = step(train_state, batch)
        losses.append({k: float(v) for k, v in metrics.items()})
    out["n960_train_fp16"] = dict(K.LAUNCHES)
    moved = {n: float((torch.cat([p.detach().ravel() for p in m.parameters()]) - first[n])
                      .abs().max())
             for n, m in (("G", train_state.generator), ("D", train_state.discriminator))}
    expected = {name: 0 for name in K.LAUNCHES}
    expected["mdct_spectro_dense"] = 2 * DENSE_STEPS
    emit({"phase": 13, "path": "n960_train_fp16", "batch": TRAIN_BATCH, "steps": DENSE_STEPS,
          "losses": losses, "max_abs_param_move": moved, "launches": out["n960_train_fp16"],
          "expected": expected})
    if not all(math.isfinite(v) for h in losses for v in h.values()):
        raise AssertionError("13b: a bf16 loss at n_fft 960 is not finite")
    if not (moved["G"] > 0 and moved["D"] > 0):
        raise AssertionError(f"13b: a network did not move: {moved}")
    if out["n960_train_fp16"] != expected:
        raise AssertionError(f"13b launches {out['n960_train_fp16']}, expected {expected}")
    emit({"phase": 13, "phase_s": time.perf_counter() - t_phase, "card": smi})
    return out


def export_phase(rng, smi: str, dev: torch.device) -> dict:
    """Phase 14: the serving export (``export_cli``) of the flagship at full
    width and depth.  (a) a reference-layout ``.pth`` of seeded weights,
    exported on the card at batch 8 in float32 and ``--fp16`` (seconds,
    bytes); a fresh process importing only torch and the op module
    (``SERVE_CHILD``) serves phase 6's three requests' segments through
    each program, one FFT-form K1 and K2 a call, the dense forms never; its
    SR against ``model.inference`` on the card (phase 6's bound; the
    difference read); the float32 program against the port on the CPU at
    phase 6's bound, and called with TF32 allowed and unscoped (it must
    move; its distance from the CPU read); the program's call against ``model.inference``, alternated, by CUDA
    events; (b) the n_fft-480 program at a reduced depth: the dense K1 and
    K2 once each a call, through the operators; (c) a batch-8 program
    called at batch 4 raises; (d) the f32 program with the head damped
    100x, scoped, within ``TF32_CONTROL_REL`` of the CPU, which TF32
    allowed and unscoped must exceed.  Returns each path's launches."""
    from mdctgan_tpu_torch import api, export_cli, serve_export
    from mdctgan_tpu_torch.data.dataset import AudioAppDataset
    from mdctgan_tpu_torch.data.synthetic import speech_like
    from mdctgan_tpu_torch.device import float32_policy
    from mdctgan_tpu_torch.models.generator import build_generator
    from mdctgan_tpu_torch.ops import mdct_kernels as K
    from mdctgan_tpu_torch.ops.resample import resample
    from mdctgan_tpu_torch.options import TrainOptions
    from mdctgan_tpu_torch.train.import_torch import export_to_torch_keys, generator_entries_for
    from mdctgan_tpu_torch.weights import random_jax_trees, state_dict_from_jax

    t_phase = time.perf_counter()
    out = {}
    f32_flags = [a for a in GENERATE_FLAGS if a != "--fp16"]
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="export_", dir=ROOT / "build") as tmp:
        tmp = Path(tmp)

        def write_pth(flags, name):
            """Seeded weights for ``flags``' generator as a reference-layout
            ``.pth`` in ``tmp/name``; returns the options, flags to export
            from it, and the port's state dict."""
            common = ["--checkpoints_dir", str(tmp / "out"), "--load_pretrain", str(tmp / name),
                      "--export_batch", str(EXPORT_BATCH), "--gpu_ids", str(dev.index or 0)]
            opt = TrainOptions().parse(flags + common, save=False)
            gen = build_generator(opt)
            state = state_dict_from_jax(*random_jax_trees(gen, rng))
            (tmp / name).mkdir()
            torch.save(export_to_torch_keys(state, generator_entries_for(gen)),
                       tmp / name / "latest_net_G.pth")
            return opt, common, state

        def export(flags, label):
            written = export_cli.main(flags + ["--export_path", str(tmp / f"{label}.pt2")])
            emit({"phase": 14, "export": label, "export_s": written["export_s"],
                  "bytes": written["bytes"], "device": written["device"], "card": smi})
            return written["path"]

        # 14a. the flagship in float32 and bf16 ----------------------------------
        opt, common, state = write_pth(f32_flags, "pretrained")
        programs = {"f32": export(f32_flags + common, "flagship_f32"),
                    "bf16": export(GENERATE_FLAGS + common, "flagship_bf16")}
        seg = opt.segment_length
        batches, real = [], []
        with torch.inference_mode(), float32_policy():
            for seconds in GENERATE_SECONDS:  # phase 6's requests, as upsample cuts them
                ds = AudioAppDataset(speech_like(rng, seconds), 16000, seg, 512)
                lr = resample(torch.from_numpy(ds.raw_audio)[None].to(dev), 16000,
                              opt.hr_sampling_rate)
                segs = ds.segments_of(lr[0].cpu().numpy())
                real.append(len(segs))
                segs = np.concatenate([segs, np.zeros((-len(segs) % EXPORT_BATCH, seg))])
                batches += list(segs.astype(np.float32).reshape(-1, EXPORT_BATCH, seg))
        batches = np.stack(batches)
        np.save(tmp / "lr.npy", batches)

        def serving_process(part, jobs, env=None):
            """``SERVE_CHILD`` on ``jobs`` ([label, program, batches, device]);
            its report."""
            jobs = [[label, path, src, str(tmp / f"sr_{label}.npy"), device]
                    for label, path, src, device in jobs]
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", SERVE_CHILD, json.dumps(jobs)],
                                  cwd=ROOT, capture_output=True, text=True, timeout=600,
                                  env=env)
            if proc.returncode != 0:
                raise AssertionError(f"{part}: the serving process failed:\n"
                                     f"{proc.stderr[-4000:]}")
            child = json.loads(proc.stdout.strip().splitlines()[-1])
            emit({"phase": 14, "part": part, "serving_process": child, "card": smi,
                  "process_s": time.perf_counter() - t0})
            return child

        child = serving_process("14a", [[label, path, str(tmp / "lr.npy"), None]
                                        for label, path in programs.items()])
        expected = {name: 0 for name in K.LAUNCHES}
        expected["mdct_spectro"] = expected["imdct_audio"] = len(batches)
        for label, path_name in (("f32", "export_serving"), ("bf16", "export_serving_fp16")):
            out[path_name] = child[label]["launches"]
            if out[path_name] != expected:
                raise AssertionError(f"14a {label}: launches {out[path_name]}, "
                                     f"expected {expected}")

        x = torch.from_numpy(batches[0]).to(dev)  # the 1.0 s request's batch
        cpu_model = api.create_model(opt, "cpu", state_dict=state)
        ref_cpu = cpu_model.inference(x[:real[0]].cpu())[1].numpy()
        del cpu_model
        scale_cpu = float(np.abs(ref_cpu).max())
        refs = {}
        for label, run_opt in (("f32", opt), ("bf16", dict(vars(opt), fp16=True))):
            model = api.create_model(run_opt, dev, state_dict=state)
            ref = refs[label] = np.stack([model.inference(torch.from_numpy(b).to(dev))[1]
                                          .cpu().numpy() for b in batches])
            got = np.load(tmp / f"sr_{label}.npy")
            diff = float(np.abs(got - ref).max())
            check(f"14a: the {label} program in a fresh process vs model.inference on the card",
                  diff, 2e-3 * float(np.abs(ref).max()), bit_for_bit=diff == 0.0,
                  batches=len(batches))
            serve = serve_export.load(programs[label])
            program = torch.export.load(programs[label])
            # the graph's operator nodes: what the host dispatches a call
            nodes = collections.Counter(str(n.target) for n in program.graph.nodes
                                        if n.op == "call_function")
            emit({"phase": 14, "program": label, "operator_nodes": sum(nodes.values()),
                  "top": nodes.most_common(6)})
            if label == "f32":
                check("14a: the f32 program on the card vs the port on the CPU",
                      float(np.abs(serve(x)[:real[0]].cpu().numpy() - ref_cpu).max()),
                      2e-3 * scale_cpu, rows=real[0], max_abs_ref=scale_cpu)
                # The program carries no precision switch: its convolutions
                # take the process's, and serve_export.load scopes TF32 off.
                # Called with TF32 allowed and no scope it must move; its
                # distance from the CPU is read beside phase 6's bound, which
                # it stays inside at these weights: the undamped head drives
                # the SR to ~1000 (PERF.md §6).  14d holds TF32 to fail.
                with torch.inference_mode(), float32_policy(allow_tf32=True):
                    tf32 = program.module()(x)
                moved = max_err(tf32, serve(x))
                tf32_err = float(np.abs(tf32[:real[0]].cpu().numpy() - ref_cpu).max())
                emit({"control": "14a: the f32 program with TF32 allowed, unscoped",
                      "max_abs_diff_from_scoped": moved, "max_abs_err_vs_cpu": tf32_err,
                      "bound": 2e-3 * scale_cpu, "share_of_bound": tf32_err / (2e-3 * scale_cpu)})
                if not moved > 0.0:
                    raise AssertionError("14a: TF32 allowed in the process did not reach the "
                                         "program's convolutions")
                # 14d. the TF32 control that can fail: the f32 program of the
                # same weights with the head damped 100x (phase 9.1's), whose
                # SR stays within full scale as a trained model's does; the
                # scoped program and the program with TF32 allowed, unscoped,
                # against the port on the CPU
                damped = dict(state, **{HEAD: state[HEAD] * 0.01})
                (tmp / "pretrained_damped").mkdir()
                torch.save(export_to_torch_keys(damped, generator_entries_for(
                    build_generator(opt))), tmp / "pretrained_damped" / "latest_net_G.pth")
                path_d = export([a if a != str(tmp / "pretrained") else
                                 str(tmp / "pretrained_damped") for a in f32_flags + common],
                                "flagship_f32_damped")
                ref_d = api.create_model(opt, "cpu", state_dict=damped).inference(
                    x[:real[0]].cpu())[1].numpy()
                policy_d = float(np.abs(serve_export.load(path_d)(x)[:real[0]].cpu().numpy()
                                        - ref_d).max())
                with torch.inference_mode(), float32_policy(allow_tf32=True):
                    tf32_d = float(np.abs(torch.export.load(path_d).module()(x)[:real[0]]
                                          .cpu().numpy() - ref_d).max())
                bound_d = TF32_CONTROL_REL * float(np.abs(ref_d).max())
                check("14d: the damped f32 program (scoped) vs the port on the CPU", policy_d,
                      bound_d, max_abs_ref=float(np.abs(ref_d).max()), tf32_allowed=tf32_d,
                      tf32_share_of_bound=tf32_d / bound_d, rows=real[0])
                if not tf32_d > bound_d:
                    raise AssertionError(f"14d: TF32 allowed keeps the damped program within "
                                         f"the bound: {tf32_d} <= {bound_d}")
                # 14c. another batch raises
                for bad in (x[: EXPORT_BATCH // 2], torch.cat([x, x])):
                    try:
                        serve(bad)
                    except (AssertionError, RuntimeError) as e:
                        emit({"phase": 14, "batch_guard": bad.shape[0], "raised": type(e).__name__})
                    else:
                        raise AssertionError(f"14c: a batch-{EXPORT_BATCH} program served "
                                             f"batch {bad.shape[0]}")
            times = {"program": [], "model": []}
            calls = {"program": lambda: serve(x), "model": lambda: model.inference(x)}
            for i in range(3 + EXPORT_TIMED):
                for name in (("program", "model") if i % 2 else ("model", "program")):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    calls[name]()
                    end.record()
                    end.synchronize()
                    if i >= 3:
                        times[name].append(start.elapsed_time(end))
            emit({"timing": {"name": "exported_program_call", "precision": label, "card": smi,
                             "batch": EXPORT_BATCH, "ms": statistics.median(times["program"]),
                             "model_inference_ms": statistics.median(times["model"])}})
            del model, serve, program

        # 14b. n_fft 480 (the dense forms) at a reduced depth -------------------------
        flags480 = f32_flags + EXPORT_N480
        opt480, common480, state480 = write_pth(flags480, "pretrained_n480")
        serve = serve_export.load(export(flags480 + common480, "n480_f32"))
        x = torch.from_numpy((0.05 * rng.standard_normal(
            (EXPORT_BATCH, opt480.segment_length))).astype(np.float32)).to(dev)
        K.reset_launch_counts()
        got = serve(x)
        out["export_n480"] = dict(K.LAUNCHES)
        expected = {name: 0 for name in K.LAUNCHES}
        expected["mdct_spectro_dense"] = expected["imdct_audio_dense"] = 1
        emit({"phase": 14, "path": "export_n480", "launches": out["export_n480"],
              "expected": expected})
        if out["export_n480"] != expected:
            raise AssertionError(f"14b launches {out['export_n480']}, expected {expected}")
        ref = api.create_model(opt480, dev, state_dict=state480).inference(x)[1]
        check("14b: the n_fft-480 program vs model.inference on the card", max_err(got, ref),
              2e-3 * float(ref.abs().max()))

        # 14e. one program for the card and the CPU (--export_platforms tpu,cpu)
        out["export_serving_multi"] = multi_platform_export(
            smi, tmp, export(f32_flags + common + ["--export_platforms", "tpu,cpu"],
                             "flagship_f32_multi"),
            programs["f32"], batches, refs["f32"],
            api.create_model(opt, "cpu", state_dict=state), serving_process)
    emit({"phase": 14, "phase_s": time.perf_counter() - t_phase, "card": smi})
    return out


def multi_platform_export(smi: str, tmp: Path, path: str, single: str, batches: np.ndarray,
                          card_ref: np.ndarray, cpu_model, serving_process) -> dict:
    """Phase 14e: the flagship f32 program exported on the card for
    ``tpu,cpu`` (``path``; ``single`` is the same weights for ``tpu``).
    (i) a fresh process on the card serves ``batches`` through
    ``load(path)``: one FFT-form K1 and K2 a call, held to
    ``model.inference`` on the card (``card_ref``) at phase 6's bound, bit
    for bit expected; (ii) a fresh process that sees no card
    (``CUDA_VISIBLE_DEVICES=""``) serves the first batch through
    ``load(path, device="cpu")``, no launch, held to ``cpu_model``'s
    ``inference`` at the same bound; (iii) there, ``load(path)`` raises;
    (iv) the file's bytes beside the single-platform program's (the
    weights held once: within 1%); (v) the file's state on the CPU and no
    graph node naming the card.  Returns (i)'s launches."""
    from mdctgan_tpu_torch.ops import mdct_kernels as K

    program = torch.export.load(path)
    held = sorted({str(t.device) for t in program.state_dict.values()})
    named = [n.name for n in program.graph.nodes
             if "cuda" in str((n.args, n.kwargs, getattr(n.meta.get("val"), "device", "")))]
    sizes = {"multi": Path(path).stat().st_size, "single": Path(single).stat().st_size}
    emit({"phase": "14e", "bytes": sizes, "state_devices": held, "nodes": len(program.graph.nodes),
          "nodes_naming_cuda": named[:10], "card": smi})
    if held != ["cpu"] or named:
        raise AssertionError(f"14e (v): the tpu,cpu program holds its state on {held} and "
                             f"{len(named)} nodes name the card")
    if abs(sizes["multi"] - sizes["single"]) > 0.01 * sizes["single"]:
        raise AssertionError(f"14e (iv): {sizes['multi']} bytes against the single-platform "
                             f"program's {sizes['single']}")
    del program

    # (i) the card, the program's default device
    child = serving_process("14e (i)", [["multi", path, str(tmp / "lr.npy"), None]])
    launches = child["multi"]["launches"]
    expected = {name: 0 for name in K.LAUNCHES}
    expected["mdct_spectro"] = expected["imdct_audio"] = len(batches)
    if launches != expected:
        raise AssertionError(f"14e (i): launches {launches}, expected {expected}")
    diff = float(np.abs(np.load(tmp / "sr_multi.npy") - card_ref).max())
    check("14e (i): the tpu,cpu program in a fresh process on the card vs model.inference",
          diff, 2e-3 * float(np.abs(card_ref).max()), bit_for_bit=diff == 0.0,
          batches=len(batches), load_ms=child["multi"]["load_ms"])

    # (ii)-(iii) a process that sees no card
    np.save(tmp / "lr_cpu.npy", batches[:1])
    child = serving_process("14e (ii)", [["multi_cpu", path, str(tmp / "lr_cpu.npy"), "cpu"]],
                            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    if child["cuda_available"] or any(child["multi_cpu"]["launches"].values()):
        raise AssertionError(f"14e (ii): the process saw a card or launched: {child}")
    with torch.inference_mode():
        ref = cpu_model.inference(torch.from_numpy(batches[0]))[1].numpy()
    diff = float(np.abs(np.load(tmp / "sr_multi_cpu.npy")[0] - ref).max())
    check("14e (ii): the tpu,cpu program on the CPU, in a process without a card, vs the "
          "port's model.inference on the CPU", diff, 2e-3 * float(np.abs(ref).max()),
          bit_for_bit=diff == 0.0, load_ms=child["multi_cpu"]["load_ms"])
    raised = child["multi_cpu"]["default_device_raised"]
    emit({"phase": "14e", "part": "(iii)", "default_device_raised": raised})
    if not raised:
        raise AssertionError("14e (iii): load() of the tpu,cpu program without a card and "
                             "without device= did not raise")
    return launches


def tools_phase(rng, smi: str, dev: torch.device) -> dict:
    """Phase 15: the port's counterparts of the JAX tools beside its package.
    (a) ``verify_import_cli`` on a reference-layout ``.pth`` of seeded
    flagship weights (the head damped 100x, as phase 9.1's): with
    ``--forward`` on the card a strict OK, and its imported generator's
    logits against ``api.create_model``'s on the same input at phase 5's
    bound; with ``--n_blocks_global 3``, as ``python -m``, exit 1 naming the
    missing keys.  (b) ``dryrun.entry()``'s fn on the card against
    ``model.inference`` of the same seeded flagship, bit for bit.  (c)
    ``dryrun.dryrun_multichip(2)`` over two gloo ranks sharing the card.
    Returns each path's launches."""
    import contextlib
    import io

    from mdctgan_tpu_torch import api, dryrun, verify_import_cli
    from mdctgan_tpu_torch.configs import flagship_opt
    from mdctgan_tpu_torch.device import float32_policy
    from mdctgan_tpu_torch.models.generator import build_generator
    from mdctgan_tpu_torch.ops import mdct_kernels as K
    from mdctgan_tpu_torch.options import TrainOptions
    from mdctgan_tpu_torch.train.import_torch import export_to_torch_keys, generator_entries_for
    from mdctgan_tpu_torch.weights import random_jax_trees, state_dict_from_jax

    t_phase = time.perf_counter()
    out = {}
    flags = [a for a in GENERATE_FLAGS if a != "--fp16"]
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="tools_", dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        # 15a. the checkpoint verifier ------------------------------------------
        opt = TrainOptions().parse(flags + ["--checkpoints_dir", str(tmp / "out")], save=False)
        gen = build_generator(opt)
        state = state_dict_from_jax(*random_jax_trees(gen, rng))
        state[HEAD] *= 0.01
        pth = tmp / "latest_net_G.pth"
        torch.save(export_to_torch_keys(state, generator_entries_for(gen)), pth)
        t0 = time.perf_counter()
        printed = io.StringIO()
        K.reset_launch_counts()
        with contextlib.redirect_stdout(printed):
            found = verify_import_cli.verify(
                [str(pth), "--forward", "--gpu_ids", str(dev.index or 0)] + flags)
        out["verify_import_forward"] = dict(K.LAUNCHES)
        report = printed.getvalue().split("-------------- End ----------------\n")[-1]
        emit({"phase": 15, "verify_import": report.splitlines(), "ok": found.ok,
              "verify_s": time.perf_counter() - t0})
        if not found.ok or "strict load: OK" not in report or "forward OK" not in report:
            raise AssertionError(f"15a: the verifier did not report a strict OK:\n{report}")
        model = api.create_model(opt, dev, state_dict=state)
        with torch.inference_mode(), float32_policy():
            got = found.module.logits(found.input)
            ref = model.generator.logits(found.input)
            served = model.generator(found.input).permute(0, 2, 3, 1).cpu().numpy()
        scale = float(ref.abs().max())
        diff = max_err(got, ref)
        check("15a: the verifier's generator vs api.create_model's, logits on the card", diff,
              5e-4 * max(1.0, scale), max_abs_ref=scale, bit_for_bit=diff == 0.0,
              output_max_abs_diff=float(np.abs(found.output - served).max()),
              shape=list(found.output.shape))
        bad = list(flags)
        bad[bad.index("--n_blocks_global") + 1] = "3"
        proc = subprocess.run([sys.executable, "-m", "mdctgan_tpu_torch.verify_import_cli",
                               str(pth)] + bad, cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
        missing = [ln.strip() for ln in proc.stdout.splitlines()
                   if "MISSING" in ln or "(expected" in ln]
        emit({"phase": 15, "verify_import_wrong_flag": {"returncode": proc.returncode,
                                                        "missing": missing[:6]}})
        if proc.returncode != 1 or not missing or "WOULD FALL BACK" not in proc.stdout:
            raise AssertionError(f"15a: --n_blocks_global 3 gave exit {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        del model, found

    # 15b. entry(): the flagship serving chain at seeded weights -------------
    fn, (zero,) = dryrun.entry(dev)
    model = api.create_model(flagship_opt(), dev)
    noise = torch.from_numpy(
        (0.1 * rng.standard_normal(zero.shape)).astype(np.float32)).to(dev)
    K.reset_launch_counts()
    sr = [fn(zero), fn(noise)]
    out["entry"] = dict(K.LAUNCHES)
    expected = {name: 0 for name in K.LAUNCHES}
    expected["mdct_spectro"] = expected["imdct_audio"] = 2
    if out["entry"] != expected:
        raise AssertionError(f"15b: entry launched {out['entry']}, expected {expected}")
    for x, y in zip((zero, noise), sr):
        diff = max_err(y, model.inference(x)[1])
        check("15b: entry()'s fn vs model.inference on the card (bit for bit)", diff, 0.0,
              shape=list(y.shape), finite=bool(torch.isfinite(y).all()))
    del model, fn

    # 15c. the data-parallel dry run: two gloo ranks sharing the card ---------
    t0 = time.perf_counter()
    K.reset_launch_counts()
    metrics, rank_launches = dryrun.dryrun_multichip(2, device=dev, backend="gloo")
    reference = dict(K.LAUNCHES)  # the one-process steps the ranks are held to
    out["dryrun_ranks"] = {name: sum(r[name] for r in rank_launches) for name in K.LAUNCHES}
    emit({"phase": 15, "dryrun_multichip": metrics, "ranks": 2, "backend": "gloo",
          "dryrun_s": time.perf_counter() - t0, "rank_launches": rank_launches,
          "reference_launches": reference})
    # K1 twice a step, an Adam and an SGD(1) step: in each of the two ranks,
    # and in the one process that holds them
    for label, got, steps in (("the ranks", out["dryrun_ranks"], 2 * 2),
                              ("the one-process reference", reference, 2)):
        expected = {name: 0 for name in K.LAUNCHES}
        expected["mdct_spectro"] = 2 * steps
        if got != expected:
            raise AssertionError(f"15c: {label} launched {got}, expected {expected}")
    emit({"phase": 15, "phase_s": time.perf_counter() - t_phase, "card": smi})
    return out


def above_dense_range(top: int, dev: torch.device) -> dict:
    """Phase 4's end: n_fft ``ABOVE_N``, above the dense form's ``top``.  The
    ops refuse ``top`` + 2 before any launch; ``SpectralTransform`` takes the
    matmul form from the configuration (one product each way, counted in
    ``MATMULS``, no K1 or K2 launch), and its round trip gives the waveform
    back within 1e-4.  Its own seed, so that later phases draw as before.
    Returns the launches."""
    from mdctgan_tpu_torch.ops import mdct as M
    from mdctgan_tpu_torch.ops import mdct_kernels as K
    from mdctgan_tpu_torch.ops.features import SpectralConfig, SpectralTransform

    k = top // 2 + 1
    K.reset_launch_counts()
    for fn, args in ((K.mdct_spectro, ((2, 8 * k), (2 * k, k))),
                     (K.imdct_audio, ((2, 9, k), (k, 2 * k)))):
        try:
            fn(*(torch.zeros(a, device=dev) for a in args))
        except NotImplementedError as e:
            emit({"above_dense_range": fn.__name__, "n_fft": 2 * k, "raised": str(e)})
        else:
            raise AssertionError(f"{fn.__name__} took n_fft {2 * k} above {top}")
    n = ABOVE_N
    t = 127 * (n // 2)
    transform = SpectralTransform(SpectralConfig(n_fft=n, hop_length=n // 2, win_length=n,
                                                 segment_length=t), dev)
    x = torch.from_numpy((0.1 * np.random.default_rng(SEED + 1).standard_normal((2, t)))
                         .astype(np.float32)).to(dev)
    K.reset_launch_counts()
    M.reset_matmul_counts()
    with torch.inference_mode():
        spec, pha, params = transform.to_spectro(x)
        back = transform.to_audio(spec, params, pha, out_length=t)
    launches, matmuls = dict(K.LAUNCHES), dict(M.MATMULS)
    emit({"above_dense_range": "SpectralTransform", "n_fft": n, "fused": transform.fused,
          "launches": launches, "matmuls": matmuls})
    if transform.fused or any(launches.values()) or matmuls != {"mdct_matmul": 1,
                                                                   "imdct_matmul": 1}:
        raise AssertionError(f"n_fft {n}: fused {transform.fused}, launches {launches}, "
                             f"matmuls {matmuls}")
    check("n_fft above the dense range: the matmul form's round trip", max_err(back, x), 1e-4,
          n_fft=n, batch=2, T=t)
    return launches


def transform_checks(rng, dev: torch.device, errs: dict):
    """Phases 3 and 4: ``check_transforms(n_fft, batches, ts, frames)``, which
    checks K1 and K2 at one n_fft on ``dev`` and keeps each kernel's worst
    error in ``errs`` (by name, and by (name, n_fft))."""
    from mdctgan_tpu_torch.ops import _build
    from mdctgan_tpu_torch.ops import mdct_kernels as K

    def keep(name: str, n_fft: int, err: float) -> None:
        errs[name] = max(errs[name], err)
        errs[(name, n_fft)] = max(errs.get((name, n_fft), 0.0), err)

    def tf32x1(kernel: str, src, out, *args) -> torch.Tensor:
        """The dense form's 1xTF32 instantiation (hi x hi only) on ``src``:
        the accuracy control, launched from here alone (no wrapper reaches
        it, no count moves), reading the same operand as the dense form."""
        fn = getattr(_build.load_library(kernel), f"{kernel}_dense_tf32x1_launch")
        fn.argtypes = K._ARGTYPES[kernel]
        fn.restype = ctypes.c_int
        operand = K._dense_operand(kernel, args[2], dev)  # args: batch, T or F, n_fft, ...
        err = fn(src.data_ptr(), operand.data_ptr(), out.data_ptr(), *args,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{kernel} 1xTF32 control: CUDA error {err}")
        return out

    def dense_record(name: str, got, plain, control, truth, bound: float, held: bool,
                     **info) -> None:
        """The dense form's error against float64 beside the float32 plain
        version's and the 1xTF32 control's on the same inputs; held to the
        bound and, where ``held``, to DENSE_FACTOR times the plain
        version's error (else the ratio is read)."""
        err, plain_err = max_err(got, truth), max_err(plain, truth)
        emit({"dense_accuracy": name, "max_abs_err": err, "plain_f32_err": plain_err,
              "tf32x1_err": max_err(control, truth), "bound": bound, "factor": DENSE_FACTOR,
              "ratio": err / plain_err, "ratio_held": held, **info})
        if not err <= bound or (held and not err <= DENSE_FACTOR * plain_err):
            raise AssertionError(f"{name}: error {err} against float64; bound {bound}, "
                                 f"{DENSE_FACTOR}x the float32 plain version's {plain_err}")

    def check_transforms(n_fft: int, batches, ts, frames: int) -> None:
        """Phases 3 and 4 at one n_fft, through the wrappers (which pick the
        FFT or the dense form by n_fft), against the plain versions in
        float32 and in float64.  The noise is scaled by sqrt(512/N), so a
        frame carries the same energy at every N: the arcsinh's slope of
        ~87 near 0 reads the spectrum's absolute rounding, which grows with
        the frame's norm."""
        k = n_fft // 2
        k1, k2 = K.kernel_for("mdct_spectro", n_fft), K.kernel_for("imdct_audio", n_fft)
        mats = {"f32": (K.spectro_matrix(n_fft, dev), K.synth_matrix(n_fft, dev)),
                "f64": (K.spectro_matrix(n_fft, dev, torch.float64),
                        K.synth_matrix(n_fft, dev, torch.float64))}
        mat, syn = mats["f32"]
        amp = math.sqrt(512 / n_fft)
        for b in batches:
            for t in ts:
                x = torch.from_numpy((amp * rng.standard_normal((b, t))).astype(np.float32)).to(dev)
                got = K.mdct_spectro(x, mat, GAIN, 0.2, 0.0)
                raw = K.mdct_spectro(x, mat)
                assert got.shape == (b, K.n_frames(t, 2 * k, k), k)
                ref64 = K.mdct_spectro_plain(x.double(), mats["f64"][0], GAIN, 0.2, 0.0)
                keep(k1, n_fft, check(
                    "K1 normalized vs f64 plain", max_err(got, ref64), 5e-4,
                    kernel=k1, n_fft=n_fft, batch=b, T=t))
                # On unit-variance noise the f32 plain version is itself up
                # to ~5.6e-4 from float64 (read here, not asserted), so no
                # f32 kernel that rounds in another order can be held to
                # 5e-4 of it there.  The kernel is held to it on the same
                # noise at sigma 0.25, a signal near full scale [-1, 1] as
                # the normalized mode's audio input is.
                emit({"control": "K1 normalized: f32 plain vs f64 plain",
                      "max_abs_err": max_err(
                          K.mdct_spectro_plain(x, mat, GAIN, 0.2, 0.0), ref64),
                      "n_fft": n_fft, "batch": b, "T": t})
                if k1.endswith("_dense"):
                    # The normalized maximum is one output at the arcsinh's
                    # slope of ~87 near 0, where two float32 summation orders
                    # part by up to ~2x either way from draw to draw
                    # (probes/tf32_accumulation_model.py: even a 5-product
                    # split read 2.09x the CPU's float32 on one of 8 draws at
                    # N 200): the ratio is read there and held on the raw
                    # product, which measures the same arithmetic.
                    dense_record("K1 dense normalized vs f64 plain", got,
                                 K.mdct_spectro_plain(x, mat, GAIN, 0.2, 0.0),
                                 tf32x1("mdct_spectro", x, torch.empty_like(got), b, t, n_fft,
                                        got.shape[1], GAIN, 0.2, 0.0),
                                 ref64, 5e-4, False, n_fft=n_fft, batch=b, T=t)
                    dense_record("K1 dense raw vs f64 plain", raw, K.mdct_spectro_plain(x, mat),
                                 tf32x1("mdct_spectro", x, torch.empty_like(raw), b, t, n_fft,
                                        raw.shape[1], 0.0, 1.0, 0.0),
                                 K.mdct_spectro_plain(x.double(), mats["f64"][0]), 2e-3, True,
                                 n_fft=n_fft, batch=b, T=t)
                quiet = 0.25 * x
                keep(k1, n_fft, check(
                    "K1 normalized vs f32 plain", max_err(
                        K.mdct_spectro(quiet, mat, GAIN, 0.2, 0.0),
                        K.mdct_spectro_plain(quiet, mat, GAIN, 0.2, 0.0)),
                    5e-4, kernel=k1, n_fft=n_fft, batch=b, T=t, sigma=0.25 * amp))
                for prec, (m, _) in mats.items():
                    check(f"K1 raw vs {prec} plain",
                          max_err(raw, K.mdct_spectro_plain(x.to(m.dtype), m)), 2e-3,
                          kernel=k1, n_fft=n_fft, batch=b, T=t)
            y = torch.from_numpy(rng.uniform(-1, 1, (b, frames, k)).astype(np.float32)).to(dev)
            sp = torch.from_numpy(rng.standard_normal((b, frames, k)).astype(np.float32)).to(dev)
            got = K.imdct_audio(y, syn, GAIN, 5.0, 0.0)
            raw = K.imdct_audio(sp, syn)
            assert got.shape == (b, (frames - 1) * k)
            if k2.endswith("_dense"):
                dense_record("K2 dense from [-1,1] vs f64 plain", got,
                             K.imdct_audio_plain(y, syn, GAIN, 5.0, 0.0),
                             tf32x1("imdct_audio", y, torch.empty_like(got), b, frames, n_fft,
                                    GAIN, 5.0, 0.0),
                             K.imdct_audio_plain(y.double(), mats["f64"][1], GAIN, 5.0, 0.0),
                             1e-3, True, n_fft=n_fft, batch=b)
                dense_record("K2 dense raw vs f64 plain", raw, K.imdct_audio_plain(sp, syn),
                             tf32x1("imdct_audio", sp, torch.empty_like(raw), b, frames, n_fft,
                                    0.0, 1.0, 0.0),
                             K.imdct_audio_plain(sp.double(), mats["f64"][1]), 1e-4, True,
                             n_fft=n_fft, batch=b)
            for prec, (_, sy) in mats.items():
                keep(k2, n_fft, check(
                    f"K2 from [-1,1] vs {prec} plain", max_err(
                        got, K.imdct_audio_plain(y.to(sy.dtype), sy, GAIN, 5.0, 0.0)),
                    1e-3, kernel=k2, n_fft=n_fft, batch=b))
                check(f"K2 raw vs {prec} plain",
                      max_err(raw, K.imdct_audio_plain(sp.to(sy.dtype), sy)), 1e-4,
                      kernel=k2, n_fft=n_fft, batch=b)
        t = ts[0]
        x = torch.from_numpy((0.1 * rng.standard_normal((2, t))).astype(np.float32)).to(dev)
        back = K.imdct_audio(K.mdct_spectro(x, mat, GAIN, 0.1, 0.0), syn, GAIN, 10.0, 0.0)
        check("K1->K2 round trip", max_err(back[:, :t], x), 1e-4,
              kernels=[k1, k2], n_fft=n_fft, batch=2, T=t)

    return check_transforms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if not (ROOT / "mdctgan_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no mdctgan_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mdctgan_tpu_torch.device import float32_policy

    with float32_policy():
        return drive()


def drive() -> int:
    from mdctgan_tpu_torch import api
    from mdctgan_tpu_torch.configs import flagship_opt
    from mdctgan_tpu_torch.data.synthetic import speech_like as clip
    from mdctgan_tpu_torch.device import float32_policy
    from mdctgan_tpu_torch.models.generator import build_generator
    from mdctgan_tpu_torch.ops import _build
    from mdctgan_tpu_torch.ops import mdct_kernels as K
    from mdctgan_tpu_torch.weights import random_jax_trees, state_dict_from_jax

    # 1. the card ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"torch": torch.__version__, "cuda": torch.version.cuda, "device": kind,
          "count": torch.cuda.device_count()})
    flops_peak, bytes_peak, tf32_peak = PEAKS["pcie" if "pcie" in kind.lower() else "sxm"]
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build()
    emit({"build_s": time.perf_counter() - t0})
    for name, log in reports.items():
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)

    errs = {name: 0.0 for name in K.LAUNCHES}
    check_transforms = transform_checks(rng, dev, errs)

    # 3-4. K1 and K2 against their plain versions ---------------------------
    check_transforms(512, BATCHES, (32512, 32000), 128)
    for n in (64, 128, 2048):
        check_transforms(n, (2,), (32512,), 128)
    top = K.dense_max_n(dev)  # the dense form's largest N on this card
    emit({"dense_max_n": top, "smem_bytes": K.dense_smem_bytes(K.DENSE_MIN_BM, top // 2),
          "smem_optin": torch.cuda.get_device_properties(dev).shared_memory_per_block_optin})
    for n, t, frames in DENSE_CHECKS + ((top, 8 * (top // 2), 8),):  # the dense form
        check_transforms(n, DENSE_BATCHES, (t,), frames)
    above_launches = above_dense_range(top, dev)
    n_fft, k_bins = 512, 256
    mat = K.spectro_matrix(n_fft, dev)
    syn = K.synth_matrix(n_fft, dev)

    # 5. flagship generator: card against CPU ------------------------------
    # On the logits before the tanh: with these weights most of them lie
    # where the tanh is flat, which would damp an error on the card.
    opt = flagship_opt()
    params, stats = random_jax_trees(build_generator(opt), rng)
    state = state_dict_from_jax(params, stats)
    model = api.create_model(opt, device="cuda", state_dict=state)
    cpu_gen = build_generator(opt)
    cpu_gen.load_state_dict(state, strict=True)
    lr_clip = clip(rng, 2 * 32512 / 48000, 48000)[: 2 * 32512].reshape(2, 32512)
    with torch.inference_mode():
        lr_spec, _, _ = model.transform.to_spectro(torch.from_numpy(lr_clip).to(dev))
        g_in = model.transform.g_input(lr_spec)
        cpu_logits = cpu_gen.eval().logits(g_in.cpu())
        card = {}
        for tf32 in (False, True):
            with float32_policy(allow_tf32=tf32):
                card[tf32] = model.generator.logits(g_in).cpu()
    ref_scale = float(cpu_logits.abs().max())
    logit_bound = 5e-4 * max(1.0, ref_scale)
    check("flagship LocalEnhancer logits card vs CPU", max_err(card[False], cpu_logits),
          logit_bound, batch=2, shape=list(cpu_logits.shape), max_abs_ref=ref_scale,
          share_beyond_1=float((cpu_logits.abs() > 1).double().mean()))
    check("flagship LocalEnhancer output card vs CPU",
          max_err(torch.tanh(card[False]), torch.tanh(cpu_logits)), 5e-4, batch=2)
    # the same check with TF32 allowed, read and not asserted: how far TF32
    # would move the generator against this bound
    emit({"control": "flagship LocalEnhancer card vs CPU with TF32 allowed",
          "logits_max_abs_err": max_err(card[True], cpu_logits), "bound": logit_bound,
          "output_max_abs_err": max_err(torch.tanh(card[True]), torch.tanh(cpu_logits))})

    # 6. serving -------------------------------------------------------------
    requests = [clip(rng, s) for s in (1.0, 2.2, 3.7)]
    K.reset_launch_counts()
    outs = [api.upsample(a, 16000, model, is_lr_input=True, gen_overlap=512,
                         batch_size=MAIN_BATCH) for a in requests]
    launches = dict(K.LAUNCHES)
    emit({"serving_launches": launches, "requests_s": [len(a) / 16000 for a in requests]})
    for name, n in launches.items():
        if name.endswith("_dense") and n != 0:
            raise AssertionError(f"flagship serving launched {name} {n} times")
        if not name.endswith("_dense") and n <= 0:
            raise AssertionError(f"the serving path never launched {name}")
    for a, out in zip(requests, outs):
        if out.shape != (round(len(a) * 3),) or not np.isfinite(out).all():
            raise AssertionError(f"bad output {out.shape} for a {len(a)}-sample request")
    cpu_model = api.create_model(opt, device="cpu", state_dict=state)
    ref = api.upsample(requests[0], 16000, cpu_model, is_lr_input=True,
                       gen_overlap=512, batch_size=2)
    scale = float(np.abs(ref).max())
    check("upsample card vs CPU", float(np.abs(outs[0] - ref).max()), 2e-3 * scale,
          request_s=len(requests[0]) / 16000, max_abs_ref=scale)
    del cpu_model

    # 6b. the bf16 policy (--fp16): the flagship LocalEnhancer on the card and
    # on the CPU against the float64 generator, on phase 5's input --------------
    # The card's bf16 logits are held to BF16_FACTOR times the CPU's bf16
    # error against float64, by max and by RMS; their distance from the
    # card's float32 logits is read.
    opt16 = dict(opt, fp16=True)
    model16 = api.create_model(opt16, device="cuda", state_dict=state)
    cpu16 = build_generator(opt16)
    cpu16.load_state_dict(state, strict=True)
    truth_gen = build_generator(opt)
    truth_gen.load_state_dict(state, strict=True)
    with torch.inference_mode():
        card16 = model16.generator.logits(g_in).cpu()
        cpu16_logits = cpu16.eval().logits(g_in.cpu())
        truth = truth_gen.double().eval().logits(g_in.cpu().double())
    del cpu16, truth_gen
    if not (card16.dtype == cpu16_logits.dtype == torch.float32):
        raise AssertionError(f"bf16 logits come back as {card16.dtype}")
    bf16_against_truth("flagship LocalEnhancer bf16 logits, card and CPU vs float64",
                       {"logits": card16}, {"logits": cpu16_logits}, {"logits": truth})
    emit({"reading": "flagship LocalEnhancer bf16 vs float32 on the card (the JAX package "
                     "allows 0.1 on the output at a tiny width)",
          "output_max_abs_diff": max_err(torch.tanh(card16), torch.tanh(card[False])),
          "logits_max_abs_diff": max_err(card16, card[False]), "batch": 2})

    K.reset_launch_counts()
    outs16 = [api.upsample(a, 16000, model16, is_lr_input=True, gen_overlap=512,
                           batch_size=MAIN_BATCH) for a in requests]
    launches16 = dict(K.LAUNCHES)
    emit({"serving_fp16_launches": launches16})
    for name, n in launches16.items():
        if name.endswith("_dense") and n != 0:
            raise AssertionError(f"bf16 serving launched {name} {n} times")
        if not name.endswith("_dense") and n <= 0:
            raise AssertionError(f"the bf16 serving path never launched {name}")
    for a, out, out32 in zip(requests, outs16, outs):
        if out.shape != out32.shape or not np.isfinite(out).all():
            raise AssertionError(f"bad bf16 output {out.shape} for a {len(a)}-sample request")
    emit({"reading": "upsample bf16 vs float32 on the card (random weights, undamped head)",
          "max_abs_diff": [float(np.abs(o - r).max()) for o, r in zip(outs16, outs)],
          "max_abs_f32": [float(np.abs(r).max()) for r in outs]})

    # 7. timings -------------------------------------------------------------
    def bound_ms(flops: float, nbytes: float):
        t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / bytes_peak * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

    rows = {}

    def time_forms(n: int, batches, forms) -> None:
        """Each form in ``forms`` of K1 and K2 at n_fft ``n`` and each batch
        of segments of 127 hops, beside the plain version, the library
        product and the bound; into ``rows[(name, n, batch)]``."""
        k, t = n // 2, 127 * (n // 2)
        mat_n, syn_n = K.spectro_matrix(n, dev), K.synth_matrix(n, dev)
        for b in batches:
            x = torch.from_numpy(rng.standard_normal((b, t)).astype(np.float32)).to(dev)
            f = K.n_frames(t, n, k)
            frames = x.new_empty((b * f, n)).normal_()
            y = torch.from_numpy(rng.uniform(-1, 1, (b, f, k)).astype(np.float32)).to(dev)
            spec2d = y.reshape(b * f, k)
            # the least work of the function, whatever computes it: each frame
            # by the FFT, each input read once and each output written once
            # (the window of N floats is the only table the function needs)
            k1 = bound_ms(b * f * (mdct_frame_ops(n) + AFFINE_OPS * k),
                          4.0 * (b * t + n + b * f * k))
            k2 = bound_ms(b * f * (AFFINE_OPS * k + mdct_frame_ops(n)) + b * (f - 1) * k,
                          4.0 * (b * f * k + n + b * (f - 1) * k))
            # the dense form's own product, 3xTF32: three TF32 products of
            # 2 * rows * N * N/2 operations at the dense TF32 rate
            dense = {"mdct_spectro": 3 * 2.0 * b * f * n * k,
                     "imdct_audio": 3 * 2.0 * b * (f - 1) * n * k}
            for name, fns, plain, lib, bound in (
                ("mdct_spectro", {"fft": lambda: K.mdct_spectro(x, mat_n, GAIN, 0.2, 0.0),
                                  "dense": lambda: K.mdct_spectro_dense(x, mat_n, GAIN, 0.2, 0.0)},
                 lambda: K.mdct_spectro_plain(x, mat_n, GAIN, 0.2, 0.0),
                 lambda: torch.matmul(frames, mat_n), k1),
                ("imdct_audio", {"fft": lambda: K.imdct_audio(y, syn_n, GAIN, 5.0, 0.0),
                                 "dense": lambda: K.imdct_audio_dense(y, syn_n, GAIN, 5.0, 0.0)},
                 lambda: K.imdct_audio_plain(y, syn_n, GAIN, 5.0, 0.0),
                 lambda: torch.matmul(spec2d, syn_n), k2),
            ):
                shared = {"plain_ms": time_ms(plain), "plain_eager_ms": eager_ms(plain),
                          "library_ms": time_ms(lib), "library_eager_ms": eager_ms(lib),
                          "bound_ms": bound[0], "bound_by": bound[1],
                          "dense_bound_ms": dense[name] / tf32_peak * 1e3}
                for form in forms:
                    kname, fn = name if form == "fft" else f"{name}_dense", fns[form]
                    ms = time_ms(fn)
                    row = {"name": kname, "batch": b, "n_fft": n, "ms": ms,
                           "eager_ms": eager_ms(fn), "device_ms": device_ms(fn), **shared,
                           "share_of_bound": bound[0] / ms, "card": smi}
                    emit({"timing": row})
                    rows[(kname, n, b)] = row

    time_forms(512, TIMED_BATCHES, ("fft", "dense"))
    time_forms(DENSE_GEOMETRY["n_fft"], DENSE_TIMED_BATCHES, ("dense",))
    time_forms(*DENSE_RANGE_TIMED, ("dense",))

    # the least time of one kernel node in a graph: a one-element add
    tiny = torch.zeros(1, device=dev)
    emit({"timing": {"name": "graph_launch_floor", "ms": time_ms(lambda: tiny.add_(1.0)),
                     "eager_ms": eager_ms(lambda: tiny.add_(1.0))}})

    x = torch.from_numpy(np.tile(lr_clip, (4, 1))).to(dev)
    audio = requests[2]
    for precision, m in (("f32", model), ("bf16", model16)):
        with torch.inference_mode():
            lr_spec, _, _ = m.transform.to_spectro(x)
            g_in = m.transform.g_input(lr_spec)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            gen_ms = time_ms(lambda: m.generator(g_in), runs=20, inner=1)
        emit({"timing": {"name": "generator_forward", "precision": precision, "card": smi,
                         "batch": MAIN_BATCH, "ms": gen_ms, "ms_per_segment": gen_ms / MAIN_BATCH,
                         "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}})
        api.upsample(audio, 16000, m, is_lr_input=True, gen_overlap=512)
        walls = []
        for _ in range(20):
            t0 = time.perf_counter()
            api.upsample(audio, 16000, m, is_lr_input=True, gen_overlap=512,
                         batch_size=MAIN_BATCH)
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(walls)
        emit({"timing": {"name": "upsample_end_to_end", "precision": precision, "card": smi,
                         "request_s": len(audio) / 16000, "ms": wall,
                         "ms_per_audio_s": wall / (len(audio) / 16000)}})
    del model16

    # 8. training ------------------------------------------------------------
    train_launches, step_timing, train16_launches, step16_timing = train_phase(rng, smi, dev)

    # 9. the generate entry point ----------------------------------------------
    generate_launches = generate_phase(rng, smi, dev)

    # 10. the train entry point --------------------------------------------------
    train_cli_launches, cli_step = train_cli_phase(smi, dev, step16_timing)

    # 11. the spectral modes and generator layouts beside the flagship's ---------
    modes_launches = modes_phase(rng, smi, dev, step16_timing)

    # 12. data parallelism on the one card --------------------------------------
    del model, state, cpu_gen
    torch.cuda.empty_cache()
    parallel_launches = parallel_phase(smi, dev, step16_timing, cli_step)

    # 13. the flagship at n_fft 960: the dense forms' path ------------------------
    dense_launches = dense_phase(rng, smi, dev)

    # 14. the serving export ----------------------------------------------------
    export_launches = export_phase(rng, smi, dev)

    # 15. the checkpoint verifier and the dry-run entry points --------------------
    tools_launches = tools_phase(rng, smi, dev)

    replaces = {
        "mdct_spectro": "mdctgan_tpu/ops/pallas_mdct.py:80",
        "imdct_audio": "mdctgan_tpu/ops/pallas_mdct.py:185",
    }
    numbers = ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    path_launches = {"serving": launches, "serving_fp16": launches16,
                     "train": train_launches, "train_fp16": train16_launches,
                     "generate": generate_launches, "train_cli": train_cli_launches,
                     **modes_launches, **parallel_launches, **dense_launches,
                     **export_launches, **tools_launches, "n8192_transform": above_launches}
    # each path's n_fft and batch: phase 13's at n_fft 960, the others' at 512
    path_shapes = {**{path: (512, b) for path, b in PATH_BATCHES.items()},
                   "n960_serving": (DENSE_GEOMETRY["n_fft"], MAIN_BATCH),
                   "n960_serving_fp16": (DENSE_GEOMETRY["n_fft"], MAIN_BATCH),
                   "n960_train_fp16": (DENSE_GEOMETRY["n_fft"], TRAIN_BATCH),
                   "export_serving": (512, EXPORT_BATCH),
                   "export_serving_fp16": (512, EXPORT_BATCH),
                   "export_serving_multi": (512, EXPORT_BATCH),
                   "export_n480": (480, EXPORT_BATCH),
                   "verify_import_forward": (512, 1), "entry": (512, 1),
                   "dryrun_ranks": (64, 1), "n8192_transform": (ABOVE_N, 2)}
    # the numbers at the kernel's own main path: serving at batch 8, at n_fft
    # 512 for the FFT forms, 960 for the dense forms
    main_n = {"mdct_spectro": 512, "imdct_audio": 512,
              "mdct_spectro_dense": DENSE_GEOMETRY["n_fft"],
              "imdct_audio_dense": DENSE_GEOMETRY["n_fft"]}
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"mdctgan_tpu_torch/csrc/{name.removesuffix('_dense')}.cu",
         "replaces": replaces[name.removesuffix("_dense")],
         "launches": launches[name] + dense_launches["n960_serving"][name],
         **{f"{path}_launches": path_launches[path][name] for path in path_launches
            if path != "serving"},
         "max_abs_err": errs[name], "n_fft": main_n[name],
         **{k: rows[(name, main_n[name], MAIN_BATCH)][k] for k in numbers},
         # phases 3-4: the worst error at each N checked; phase 7 at N 4096
         "checked_n": {str(n): e for (kn, n), e in
                       ((k, v) for k, v in errs.items() if isinstance(k, tuple)) if kn == name},
         **({"n4096": {k: rows[(name, 4096, MAIN_BATCH)][k] for k in numbers}}
            if (name, 4096, MAIN_BATCH) in rows else {}),
         "paths": {path: {"n_fft": n, "batch": b, "launches": path_launches[path][name],
                          **{k: rows[(name, n, b)][k] for k in numbers
                             if (name, n, b) in rows}}
                   for path, (n, b) in path_shapes.items()}}
        for name in ("mdct_spectro", "imdct_audio", "mdct_spectro_dense",
                     "imdct_audio_dense")
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
