#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dvdgan_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # from the repository root; one GPU
    python3 chip_smoke.py --cards 4  # the NCCL phase alone; four GPUs

The NCCL phase needs `--cards 4`: NCCL takes one rank a device, so it
cannot run on the one card of the default run, whose parallel phase puts
two gloo ranks on that card instead. With `--cards 4` the script prints
every card's name and power limit, builds the kernels, then runs the
train CLI as four `--multihost` ranks with
`--device cuda` (rank i on cuda:i; `start_ranks`, `finish_ranks`,
`drive_trains`, three runs at a time; `drive_cards`): dp4 (the flagship,
global batch 8 over 4 data ranks, 4 steps, checkpoints at 2 and 4), dp4_b
(resumed at 2 in a copy of dp4's out_dir), dp4_k2 (dp4 at
`--steps_per_call 2`), cp and cp_k2 (data 2 × time 2, 2 steps), long_dp4
and long_dp4_k2 (`kinetics_256_48f`, 1 clip a rank, 2 steps), long_cp4
(the long clip over 4 time ranks, batch 4 as 2 × 2), dp4_f32 and cp_f32
(f32 batch 4, d_steps 1, from `off_init`, against one process fed the same
draws at PAR_F32_*), and the default train command with neither
`--n_devices` nor `--multihost` at K 4 (`plan` takes all four cards,
`spawn` starts the ranks). Checked (`check_card_runs`): backend nccl with
4 ranks in every run, the default's too; equal digests; each rank's
launches as `launches_per_step` predicts; dp4_b and dp4_k2 with dp4's
bits, cp_k2 with cp's, long_dp4_k2 with long_dp4's, in every leaf; the
f32 runs within the limits. Then the rates alone on the cards
(`time_cards`, `card_rates_rank`): one rank on cuda:0 against the four
ranks, each at steps_per_call 1 and at the trainer's K (flagship 4, long
clip 2), one reading each in turns, at strong scaling (global batch 8)
and, for the flagship, weak (8 clips a rank): ms a step (the trainer's
own steps/s of each logged interval of a reading but its first,
`steady_ms`, both sides alike), clips/s per card, idle share, NCCL's
device ms a step (`device_view` of the K graph's replay), collectives and
bytes a rank-step, peak memory a rank, and the syncs of one K call (none
allowed). Every phase runs even where an
earlier one failed; any failure makes the exit code non-zero and drops
the result line. It exits non-zero when fewer than four cards are
visible, and its last line is the result line.

The default run, on one card:

1. prints the card's name and power limit (nvidia-smi) and builds every
   kernel of the port from csrc/ with nvcc (one process per source, all
   started together);
2. holds K1 against its plain PyTorch version at the shapes EMA-G sampling
   gives it (the four ucf101_64 GRU levels, T=16, B=16), in f32 with TF32
   off (atol 1e-4) and in bf16 (atol 3e-2; tensor cores), and times both
   (CUDA events, median of 10 runs after warm-up); every K1 and K2 row of
   this script also has its TFLOP/s, the profiler's device ms of one call
   beside the event ms, the device µs of each kind of launch and the
   host's µs per launch; then each kernel (K1, K2, K3, K4's cluster form,
   K5a, K5b, K6a, K6b) at one driven shape in bf16 captured into a CUDA
   graph and replayed twice, its outputs poisoned in between: the eager
   call's bits each time, its launches counted once, during the capture
   (`graph_replay`), and K6 so at each shape of K6_DOMAIN_SHAPES;
3. drives the sample entry (`python -m dvdgan_tpu_torch --mode sample
   --preset ucf101_64 --n_samples 16 --bf16 1`) with the launch counters
   zeroed just before, checks the clip (shape, finite, in [-1, 1]) and that
   every kernel of the path launched, then times sampling in clips/s and
   holds a small f32 sample on the card against the CPU (plain) path; then
   the same for DVD-GAN-FP (`--preset kinetics_64 --n_frames 16
   --cond_frames 5`: the first 5 frames of the CLI's dataset items
   condition the 11 frames G generates; K1 also runs the warm-up over the
   prefix at every level), whose clips/s are printed beside ucf101_64's,
   and the same z with other items' prefixes must give other clips; then
   the paths of K6's whole domain: P1 (`--preset ucf101_64 --ch 48
   --attn_fused on`, batch 16: its 32²×96 attention, c8 12 on weights
   zero-padded to 16), P2 (`--preset kinetics_128 --ch 96 --attn_fused
   on`, batch 8: BigGAN's 128 px base width, 32²×384 in the wide sweep)
   and P3 (DVD-GAN-FP at 128 px, `--preset kinetics_128 --n_frames 16
   --cond_frames 5`, batch 8: K3 at 64² over the warm-up's 5 frames, then
   over the 11 generated ones from the warm-up's last state, each K3 call
   recorded (`k3_calls`); an f32 batch-2 clip card vs CPU);
4. drives the train entry (`python -m dvdgan_tpu_torch --mode train
   --dataset synthetic ...`, `train.trainer.Trainer`: every step logged, a
   checkpoint at the last step) in child processes whose launch counters
   start at 0 and which log each step's launches, all side by side (a run
   spends most of its time starting up), the final state read from the
   last checkpoint:
   - the trainer at the flagship step, `--preset ucf101_64 --batch_size 8
     --bf16 1`, on the reference's schedule (`--log_step 1 --sample_step 2
     --model_save_step 2`; per step K1 256, K2 256): A, 4 steps with
     `--keep_checkpoints 2`; B, the same command with
     `--keep_checkpoints 1`, resumed at step 2 in a copy of A's out_dir as
     it stood then (`out_dir_at`). Checked: checkpoints 2 and 4 in A and
     only 4 in B, the grid PNGs at steps 2 and 4 (signature, the grid's
     IHDR size), the GIFs, the four losses and steps_per_sec in
     `scalars.jsonl` at every step, B with A's bits in every leaf;
   - the same under `--steps_per_call 2` (two steps a CUDA-graph replay):
     A_K, 4 steps logged, sampled and saved at 2 and 4, and B_K, resumed
     at 2 from A_K's out_dir: both with A's bits in every leaf (else the
     differing leaves are named);
   - the flagship on frame folders of `.npy` uint8 clips the script
     writes (3 classes, 20–23 frames of 72×88: window, crop, resize and
     epoch wrap all run), 4 steps at `--steps_per_call` 1 and 2, the
     two with the same bits;
   - the flagship step with `--ups_fused full --attn_fused on`, 3 steps
     (per step K1 256, K2 256, K5a 8, K5b 8, K6a 4);
   - the long-clip step, `--preset kinetics_256_48f --batch_size 4
     --grad_accum 2` (256 px, 48 frames, per-level remat, two micro-batches
     of 2), 2 steps, unfused and fused (K1, K2 and K3 exactly as often as
     one fake pass plus grad_accum G forwards and backwards need: the remat
     backward reruns no sequence; fused: K5a 18, K5b 24, K6a 6, none from
     the remat backward);
   - the 128 px step whose attention sits at 64², `--preset kinetics_128
     --batch_size 8 --attn_res 64 --remat 1`, 2 steps, with `--attn_fused`
     off and on (K6b 4 per step; K1, K2, K3 at its own five levels);
   - DVD-GAN-FP at kinetics_64 (5 real frames, 11 generated), batch 8, 2
     steps at `--steps_per_call` 1 and 2, the two with the same bits, the
     frame encoder among the trees that moved (per step K1 256, K2 256:
     the warm-up's and the generation's steps, K2's dh0 feeding the
     warm-up's K2);
   - P1, P2 (`--remat 1`) and P3, 2 steps at batch 8 (P_TRAIN; started
     as the 128 px and the long-clip runs end), their launches a step
     printed (K6a 4 on P1 and P2; K3 at 64² on P2 and P3, P3's over the
     warm-up and the generation);
   - the trainer's A and A_K with `--eval_step 2 --eval_samples 16`
     (started as the two long-clip runs end): `fvd`, `is_mean`, `is_std`
     in the scalars and an `eval @` line at steps 2 and 4, and A's bits in
     every leaf (an evaluation must not move the training);
   each run: finite losses, G/DS/DT params, the three SN u trees and G's BN
   stats moved, launches per step as predicted, peak memory printed; then
   the frames loader alone on `.npy` clips at UCF-101's frame size
   (320×240, 180–187 frames) that it writes: host ms per batch and per
   call of 4 steps, the ms to read a clip whole and a window of it, and
   `native.available()`; then the evaluation (`drive_eval`): `--mode
   eval` children at `--preset ucf101_64 --dataset synthetic --n_samples
   64 --batch_size 16` with `--is_protocol i3d` (writing `--real_stats`)
   and `c3d`, and the prediction protocol at FP's kinetics_64 (32 clips),
   side by side, then the i3d run again reading the stats (the same fvd
   bitwise): the reference's JSON keys, finite fvd and fid ≥ 0, 1 ≤
   is_mean ≤ the classifier's classes, every `*_published_comparable`
   false, K1 launched 128 times a batch of 16 and no other kernel, the
   evaluation's wall time and its sampling's share; meanwhile I3D (64 →
   224², logits and avgpool), Inception-v3 (2 × 16 frames, 64 → 299²)
   and C3D (64 → 112² and the antialiased 128 → 112²) on 2 clips, card vs
   CPU from one generator with every BN moment, scale, offset and bias
   moved off its init (TF32 off on both; limit 1e-4 × max|CPU|, which
   the card's output with TF32 on must fail), and
   `Trainer.evaluate()` twice in this process (the same fvd bitwise);
   after the children, each network's CUDA-event ms for a batch of 16
   clips with TF32 off and on, and its peak memory;
   meanwhile, from a thread of this process (`migration_children`), the
   migration to and from PyTorch state dicts: trainer run A's newest
   checkpoint exported (`tools/torch_export_checkpoint.py`, a child
   process) as G, G_ema, DS and DT `.pth` state dicts, imported back into
   a fresh out_dir (`tools/torch_import_checkpoint.py`), G, G_ema, DS and
   DT params and G's BN stats bitwise A's, the step A's; the imported
   checkpoint through `--mode sample --pretrained_model` in child
   processes (`SAMPLE_CHILD`): bf16 batch 16 with the launches
   `sample_launches` predicts (K1 128), and the f32 batch-2 clip card vs
   CPU at SAMPLE_TOL; and `--mode train --pretrained_model` resumed for
   MIGRATE_STEPS steps (finite losses, launches per step as
   `launches_per_step`: K1 256, K2 256); the phase's seconds printed;
   then the parallel phase (`drive_parallel`): each run is two train CLI
   processes started as the ranks of one `--multihost` run on cuda:0
   (ranks that share one card talk over gloo through the host: what is
   measured is that path, not a data-parallel speed-up), checked as the
   runs above are from the leader's lines and checkpoint, with the
   backend line (gloo), every rank's state digest equal and every rank's
   kernel launches over the run (printed at its end) as predicted: DP2, the
   flagship's global batch 8 over 2 data ranks, 4 steps, checkpoints at 2
   and 4, and DP2-B resumed at 2 in a copy of its out_dir, with DP2's bits
   in every leaf; CP2, the flagship over data 1 x time 2, 2 steps; the
   long clip's CP2 (`--time_shards 2`, batch 4, grad_accum 2; started as
   CP2 ends): ms a step, each rank's peak memory, K1, K2 and K3 launches
   a rank-step against `launches_per_step`, collectives and bytes a step;
   f32 DP2 and CP2 at d_steps 1, 1 step, global batch 4 (TF32 off,
   deterministic cuDNN): rank 0 against one process fed the same draws
   (`par_f32_reference`), losses atol 1e-3, Adam mu within 1e-4 x max|mu|;
   meanwhile this process holds the flagship f32 step card vs CPU (phase
   6);
   then, from a thread of this process while it runs phases 5 to 8 (three
   at a time; beside the train, evaluation or parallel children they
   outlasted those and slowed them), the serving artifacts (`ARTIFACTS`):
   for each, the EMA-G weights of the seeded init moved off it
   (`g_off_init`: both attention γ ≠ 0), an export child
   (`tools/torch_export_serving.py`), then a load child that imports
   torch and `kernels.library` alone (`LOAD_CHILD`) and serves each batch
   once, its launch counters from 0: A1
   `ucf101_64` bf16 batch 16 (K1), A2 `ucf101_64` polymorphic bf16 with
   `--ups_fused fwd --attn_fused on` served at 1, 16 and 32 (K1, K5a,
   K6a), A3 `kinetics_128 --attn_res 64 --attn_fused on` bf16 batch 2 (K1,
   K3, K6b), A4 DVD-GAN-FP at `kinetics_64` bf16 batch 8, A5 `ucf101_64`
   f32 batch 2 for the card and for the CPU (`check_artifacts`): every
   clip equal to eager `step.sample` of the same route, weights and inputs
   in this process bitwise (else printed and held at atol 5e-3, rtol
   5e-2), the launches a call `sample_launches` predicts, no model module
   in the load child, A5 card vs CPU at atol 2e-3; then A1 and
   `step.sample` of its weights at batch 16, each eager and from a CUDA
   graph of 10 calls (`tools/torch_bench_sample.py`), ms a batch and
   device idle share, and one sample call traced under `profiling.trace`
   with spans on, the trace holding the span "dvdgan.sample" and K1's
   kernels (`time_serving`);
5. holds K2 against its plain version at the shapes the flagship step's G
   update gives it (the four levels, T=16, B=8), in f32 with TF32 off (atol
   1e-4 × max|ref| per output) and in bf16 (5e-2 × max|ref|), two runs
   bitwise equal (dgx, dcx, dh0: the ordered split-K sums), timed beside
   its plain version and the plain autograd backward through K1's plain
   version; times flagship train steps/s in bf16 (median of 5 after 2
   warm-ups) and reads the device idle share and the time by kernel from
   torch.profiler; the z and frame-index draws of steps 2 and 3 the same
   fresh and resumed; the syncs of one bare step (sync debug mode);
   `AsyncSaver`'s snapshot ms, write s and bytes for the flagship and the
   kinetics_256_48f state, each restored on the card bitwise;
6. holds one f32 train step at the flagship widths, batch 2, d_steps 1,
   on the card against the CPU from the same state and draws (losses atol
   1e-3; Adam mu, the gradient, within 1e-3 × max|mu| of each model; run
   in the parallel phase): from a state off its init (`off_init`) for
   three draw sets (its own, `TorchDraws(1, 0)`'s and `TorchDraws(2,
   0)`'s), and from the init for five (its own, `TorchDraws(1 … 4, 0)`'s),
   where g_loss, which the G phase reads after Adam's sign-like first D
   update, is held by a float64 step on the CPU instead: the card's f32 no
   farther from it than twice the CPU's f32 plus 1e-3 (`F64_G_LOSS`); and
   at the FP widths, batch 2, at d_steps 1 and with `--fake_gen per_step`
   at d_steps 2;
7. holds K3 against its plain version at the three large level shapes of
   the long-clip preset kinetics_256_48f (32²×256, 64²×128, 128²×64; T=48,
   B=2: one G micro-batch), f32 atol 1e-4 and bf16 3e-2 (bf16 on the
   tensor cores, with the tile its plan gives), and in bf16 at the fake
   pass's B=8, two runs bitwise equal, timed beside its plain version and
   K1's kernel at the same shape (the numbers that place the K1/K3
   boundary), each row with K1's and K3's TFLOP/s and the profiler's view
   as K1's rows have it; and K1 (the
   levels `ops/convgru.py` gives it, at B=2 and B=8) and K2 (all six
   levels, B=2) at that preset's shapes against their plain versions, at
   the tolerances of phases 2 and 5, and prints the device µs of the gate
   and dh launches at 4²×512 and 8²×512;
8. holds one f32 long-clip-shaped step (the 256 px schedules at ch 8, T 4,
   batch 2, grad_accum 2, remat on; its 64² and 128² levels go to K3) on
   the card against the CPU, at phase 6's limits; then runs the long-clip
   step under each `--remat_save` policy in this process
   (`check_remat_policies`: gru+ups twice, then gru, ups and none, each 1
   warm-up and 1 timed step from one state, batch and draws): ms, peak
   memory, K1/K2/K3 launches as `launches_per_step` predicts (K1 and K3
   rerun in the backward under ups and none), and each state equal to
   gru+ups's bitwise if its two runs are, else within their gap;
9. holds K5a and K5b (the fused upsample conv and its backward; bf16 on
   the tensor cores, f32 on the CUDA cores) against their plain versions
   at the four ucf101_64 levels (N = T·B = 128, and 256 as the fake pass
   and sampling give it) and the six kinetics_256_48f levels (N = 96; K5a
   also at the fake pass's 384): f32 atol 1e-4 (K5b: 1e-4 × max|ref| per
   output), bf16 3e-2 (K5b 5e-2 × max|ref|), two K5b runs bitwise equal;
   timed beside the plain versions and the unfused route (cuDNN phase conv
   + interleave, and autograd through it) on the same inputs, each row
   with its TFLOP/s and ms / library ms;
10. holds K4 (the single GRU step) against its plain version at the ten
    level shapes (B 16 for ucf101_64, B 2 for kinetics_256_48f), and drives
    the single-step entry `ops.convgru.convgru_cell` over the T steps of
    both presets' levels (bf16; 16 steps at B 16, 48 steps at B 2; launch
    counter zeroed just before): K4 on K1's own gx/cx and states gives K1's
    next state, bit for bit where it takes K1's two launches (planes over
    8×8), within atol 3e-2 where it takes its one launch (CUDA-core sums
    against K1's tensor cores), and the entry's sequence agrees with
    `ops.convgru.convgru`;
11. holds K6a and K6b (the fused spatial attention through its two
    entries) against their plain version at every call of the driven paths
    (K6a: 32²×64 at N = 256 and 128, 32²×256 at N = 384 and 96; K6b: 64²×64
    at N = 192 and 96): f32 atol 1e-4, bf16 one bf16 ulp at the output's
    scale on at most 0.5% of the elements, γ = 0 bitwise; timed beside the
    plain version and the unfused route's spatial pass on the same inputs,
    each row with its TFLOP/s, the device µs of each of its two launches
    (bf16; profiler, `device_view` in a fresh process, `k6_views`: None
    where it missed one) and a second bound `bound_ms_tc` with the logits
    at the 3×TF32 rate (the bf16 kernel's bound; `bound_ms` keeps them at
    the f32 CUDA-core rate, as the f32-logit kernel's rows were counted,
    and so overstates the bf16 kernel's least time); and so at the shapes
    of K6_DOMAIN_SHAPES (the 4² map at C 256 and 512, P1's and P2's calls,
    16²×768, 8²×1536 and 64²×384, at N 96 but P1's 256: the `kernels`
    line lists the off-path ones under K6a's and K6b's entries); and K1,
    K2, K3 at the shapes the 128 px path
    gives them (the kinetics_128 levels, T = 12, B = 8 and 16);
12. drives the sample CLI with both fused routes (4 K5a and 2 K6a launches,
    the bf16 clip within 0.05 of the unfused one, an f32 batch-2 sample
    card vs CPU); with both attention γ off their zero init, the bf16 clips
    of `--attn_fused on` within 0.05 of `off`'s and an f32 sample card vs
    CPU; flagship steps/s with both fused routes; and one f32 flagship step
    with them (d_steps 1, γ off zero) card vs CPU and against the unfused
    attention on the card;
13. times the routes in this one call: the long-clip step off and on
    (one reading each, the first profiled) and the 128 px step off and on
    (one reading each, both profiled; median of 2 steps after 1 warm-up,
    with peak memory), and sampling off, on, on, off; and
    `Trainer.train()` at steps_per_call 1 and K in turns 1, K
    (`time_steps_per_call`): the flagship at K 4 (8 steps a
    reading, log_step 4), FP, the 128 px step and the long clip at K 2 (2
    steps), with
    ms a step, device time and idle share, the syncs of a train() of K
    steps, the capture's one-time cost and the peak memory;
14. prints one JSON line of the kernels, each with its launches on the
    driven paths and its bound (the larger of bytes over 3.35 TB/s and
    operations over the peak rate of its type; K5a/K5b also their TFLOP/s
    and ms / library ms over the levels), then the result line.

Cut against earlier versions of this script to stay inside its time limit:
the train CLI runs share the card instead of running one after the other;
a resumed run starts from a copy of its uninterrupted run's out_dir at the
resume step instead of a first leg of its own; the trainer's child run A
is the flagship run whose launches are counted, and A_K, which must have
A's bits, stands for a repeat of A; the trainer's ms a step at K 1 is
`time_steps_per_call`'s only; the profiler traces the device alone;
the flagship and long-clip runs with a fused route carry both fused routes
at once (as do the fused sample run, the fused flagship steps/s and the
fused f32 step, which takes d_steps 1); the long-clip step is timed over 2
steps per reading instead of 3, a route's repeat reading skips the
profiler, and (to make room for the evaluation's phase) the long-clip
step's `--ups_fused full` pair is no longer timed in turns (its kernels are
timed at the long-clip levels in phase 9, and the long-clip child runs
it); and (to make room for the parallel phase) the long-clip routes are
read once each, not in turns, and the long-clip K 1 vs K 2 turns take 2
steps a reading instead of 4; and (to make room for the serving
artifacts) the 128 px routes are read once each, not in turns; and (to
make room for K6's domain paths) the K 1 vs K turns take 8 flagship steps
a reading instead of 12, and 2 FP and 128 px steps instead of 4; and (to
make room for the migration phase) the K 1 vs K turns are read once
each, 1 then K, not 1, K, K, 1, on one trainer a configuration instead of
one a mode, and children started side by side take a share of the host's
cores (`child_threads`).

Any failing phase raises, so the script exits non-zero without the result
line; so does a machine without a CUDA device. Imports nothing of JAX or
of the JAX package (the train CLI reads the port's own numpy-only synthetic
clips, `dvdgan_tpu_torch.data`).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import traceback
import types

import numpy as np
import torch

LEVELS = [(4, 4, 256), (8, 8, 256), (16, 16, 128), (32, 32, 64)]  # H, W, C
T, B = 16, 16
B_TRAIN = 8         # the flagship train batch: K2 runs at the G update's
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# K2, relative to max|ref| of each output: bf16 roundings of rh, da and the
# dh carry flip with the summation order and compound over 16 steps
K2_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
SAMPLE_TOL = 2e-3   # f32 clip, card vs CPU: cuDNN vs CPU conv sum order
TRAIN_STEPS = 3
# the long-clip path: kinetics_256_48f's GRU levels (H, W, C), its frames,
# one G micro-batch, the fake pass's batch. K3 is held to its plain version
# at the three planes the reference's split gives its blocked kernel,
# whichever of them `ops/convgru.py` gives K3.
LONG_LEVELS = [(4, 4, 512), (8, 8, 512), (16, 16, 256), (32, 32, 256),
               (64, 64, 128), (128, 128, 64)]
K3_LEVELS = LONG_LEVELS[3:]
LONG_T, LONG_B, LONG_B_FAKE = 48, 2, 8
LONG_ARGV = ["--mode", "train", "--preset", "kinetics_256_48f", "--dataset",
             "synthetic", "--batch_size", "4", "--grad_accum", "2"]
LONG_STEPS = 2
# published peaks of one H100 SXM at its 700 W limit: HBM bytes/s, dense
# FLOP/s by operand type (bf16 tensor cores; f32 outside the tensor cores)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_TF32 = 495e12      # dense TF32 on the tensor cores
CONVGRU_KERNELS = ("gate_kernel", "cand_kernel", "cand_bwd_kernel",
                   "drh_kernel", "dh_kernel", "blocked_step_kernel",
                   "blocked_mma_kernel", "conv3x3_mma_kernel")
UPS_KERNELS = ("ups2x_fwd_kernel", "ups2x_dx_kernel", "ups2x_dw_kernel")
# the upsample conv of each G level: (H, W, Cin, Cout) of its source plane
UPS_LEVELS = [(4, 4, 256, 256), (8, 8, 256, 128), (16, 16, 128, 64),
              (32, 32, 64, 32)]
LONG_UPS_LEVELS = [(4, 4, 512, 512), (8, 8, 512, 256), (16, 16, 256, 256),
                   (32, 32, 256, 128), (64, 64, 128, 64), (128, 128, 64, 32)]
FUSED_CLIP_TOL = 0.05   # bf16 clip, fused vs unfused route: both round each
#                         level's conv once, from f32 sums in another order
FULL = ["--ups_fused", "full"]
# the fused spatial attention: (N frames, H, W, C) of every call on the
# driven paths. K6a: sampling and the flagship fake pass (N 256), the
# flagship G update (128), the long-clip fake pass (384) and micro-batch
# (96); K6b: the 128 px / attn-64 fake pass (192) and G update (96)
K6A_SHAPES = [(256, 32, 32, 64), (128, 32, 32, 64), (384, 32, 32, 256),
              (96, 32, 32, 256)]
K6B_SHAPES = [(192, 64, 64, 64), (96, 64, 64, 64)]
# K6a's wide body: the 8² attention at C 512 of kinetics_128 with
# `--attn_res 8`, its sampling (N = 8 · 12 frames) and its train step's fake
# pass (192)
K6A_WIDE_SHAPES = [(96, 8, 8, 512), (192, 8, 8, 512)]
# the sample CLI on that path: bf16, batch 8, with `--attn_fused` off / on
PX128_ATTN8 = ["--preset", "kinetics_128", "--attn_res", "8"]
PX128_ATTN8_B = 8
# K6 over the rest of the shapes the reference's kernels take, (N, H, W, C)
# each with the name of its `kernels` entry: the 4² map (4 keys, padded to
# 16 and masked; no model's: G's attention sits after an upsampling level)
# at C 256 and 512; the attention of the driven paths P1 (32²×96: c8 12,
# weights zero-padded; its sample's N 16·16) and P2 (32²×384: the wide
# sweep; its sample's N 8·12); kinetics_128 at ch 96 with `--attn_res 16`
# and `8` (16²×768, 8²×1536: the wide body in 3 and 6 passes) and 256 px
# at ch 96 with `--attn_res 64` (64²×384, K6b: the wide sweep), at N 96
K6_DOMAIN_SHAPES = {"K6a 4x4": [(96, 4, 4, 256), (96, 4, 4, 512)],
                    "K6a P1": [(256, 32, 32, 96)],
                    "K6a P2": [(96, 32, 32, 384)],
                    "K6a wide widths": [(96, 16, 16, 768), (96, 8, 8, 1536)],
                    "K6b wide sweep": [(96, 64, 64, 384)]}
# the driven paths of K6's whole domain: P1, the flagship at ch 48 (its
# attention 32²×96); P2, kinetics_128 at BigGAN's 128 px base width ch 96
# (32²×384); P3, DVD-GAN-FP at 128 px (K3 at 64² over the warm-up's T 5,
# then from its last state over the 11 generated frames). Each: the sample
# CLI (bf16; P3 also an f32 batch-2 clip card vs CPU) and a 2-step train
# child. Cut: the batches (P1 sample 16, train 8; P2 and P3 8) and, for P2's
# child, its activations recomputed (`--remat 1`)
P1_PRESET = ["--preset", "ucf101_64", "--ch", "48"]
P2_PRESET = ["--preset", "kinetics_128", "--ch", "96"]
P3_PRESET = ["--preset", "kinetics_128", "--n_frames", "16",
             "--cond_frames", "5", "--dataset", "synthetic"]
P_SAMPLE_B = {"p1": 16, "p2": 8, "p3": 8}
P_STEPS = 2
P_TRAIN = {
    "p1": ["--mode", "train", *P1_PRESET, "--dataset", "synthetic",
           "--batch_size", str(B_TRAIN), "--bf16", "1", "--attn_fused", "on"],
    "p2": ["--mode", "train", *P2_PRESET, "--dataset", "synthetic",
           "--batch_size", "8", "--remat", "1", "--bf16", "1",
           "--attn_fused", "on"],
    "p3": ["--mode", "train", *P3_PRESET, "--batch_size", "8", "--bf16",
           "1"]}
ATTN_KERNELS = ("attn_kv_kernel", "attn_fwd_kernel")
K6_DIFFER = 0.005       # bf16: share of K6's output elements that may differ
#                         from the plain version by their one ulp
ON = ["--attn_fused", "on"]
FUSED = FULL + ON       # both fused routes of G at once
ATTN_CLIP_TOL = 0.05    # bf16 clip, fused vs unfused attention with γ ≠ 0:
#                         the routes round q, k, v and the logits elsewhere
# the 128 px step whose attention sits at 64² (the reference's own A/B of
# its tiled kernel): kinetics_128 at full width, the batch cut to 8
PX128_ARGV = ["--mode", "train", "--preset", "kinetics_128", "--dataset",
              "synthetic", "--batch_size", "8", "--attn_res", "64", "--remat",
              "1"]
PX128_STEPS = 2
PX128_LEVELS = [(4, 4, 512), (8, 8, 512), (16, 16, 256), (32, 32, 128),
                (64, 64, 64)]
PX128_T, PX128_B, PX128_B_FAKE = 12, 8, 16
REPO = os.path.dirname(os.path.abspath(__file__))


def gpu_lines() -> list[str]:
    """Every visible card's name and power limit, as nvidia-smi prints
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    return out.splitlines()


def gpu_line() -> str:
    return gpu_lines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() in ms, one CUDA-event pair per run."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, n_bytes: float, dtype) -> dict:
    """The least time the card could take: the larger of bytes over its
    memory rate and operations over its peak rate for the operand type."""
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    by_bytes = n_bytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes"}


def fwd_flops(t, b, h, w, c) -> float:
    """K1's and K3's operations: the two hidden-side 3×3 convs per step."""
    return 2 * 9 * t * b * h * w * c * 3 * c


def bwd_flops(t, b, h, w, c) -> float:
    """K2's operations: the gate and candidate recompute (3C), the two
    transposed convs (C + 2C) and the two weight gradients (2C + C) per
    step."""
    return 2 * 9 * t * b * h * w * c * 9 * c


def fwd_bound(t, b, h, w, c, dtype) -> dict:
    """K1's and K3's function: gx, cx, h0 and the weights read once, hs
    written once."""
    px = t * b * h * w
    n_el = px * 3 * c + b * h * w * c + 27 * c * c + px * c
    return bound(fwd_flops(t, b, h, w, c), n_el * dtype.itemsize, dtype)


def bwd_bound(t, b, h, w, c, dtype) -> dict:
    """K2's function: gx, cx, h0, weights, hs and g read, dgx, dcx, dh0,
    dW written."""
    px = t * b * h * w
    n_el = (px * 3 * c + b * h * w * c + 27 * c * c + 2 * px * c
            + px * 3 * c + b * h * w * c + 27 * c * c)
    return bound(bwd_flops(t, b, h, w, c), n_el * dtype.itemsize, dtype)


def launch_kind(key: str) -> str:
    """The launch a kernel name stands for: the epilogue of a tensor-core
    launch (`conv3x3_mma_kernel<…, GateEpi>`), else the kernel's own
    name."""
    found = (re.search(r"(\w+Epi)\b", key)
             or re.search(r"(\w+_kernel)\b", key))
    return found.group(1) if found else key[:40]


def device_view(fn, launches: int, names=CONVGRU_KERNELS,
                tries: int = 3) -> dict:
    """One fn() call seen from the device and the host: torch.profiler's
    device time of all its kernels (ms), the mean device µs of each kind
    of launch of the kernels `names` and how many of those launches the
    profiler saw; and the host's µs per launch to enqueue the call (host
    clock from its start to its return, before the synchronize). The
    profiler traces a warm-up call before the call it keeps, and it can
    still miss a call's kernels (seen on the H100: 1 of 24 in a session):
    the call is traced again, up to `tries` times, until it sees all
    `launches`. If no try does, `device_ms` is None (not measured: what
    the profiler saw is not the call), the kinds it saw keep their means
    and `profiled_launches` says how many it saw (`profiled_kernels`: all
    kernels it saw)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    best = None
    for _ in range(tries):
        kept = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: kept.append(p.key_averages())
                     ) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        kernels = [e for e in kept[0] if e.device_type == DeviceType.CUDA]
        total, count = {}, {}
        for e in kernels:
            if any(k in e.key for k in names):
                kind = launch_kind(e.key)
                total[kind] = total.get(kind, 0.0) + dev_us(e)
                count[kind] = count.get(kind, 0) + e.count
        seen = sum(count.values())
        view = {"device_ms": sum(dev_us(e) for e in kernels) / 1e3,
                "launch_device_us": {k: total[k] / count[k] for k in total},
                "launch_count": count,
                "profiled_launches": seen,
                "profiled_kernels": sum(e.count for e in kernels)}
        if best is None or seen > best["profiled_launches"]:
            best = view
        if seen >= launches:
            break
    if best["profiled_launches"] < launches:
        best["device_ms"] = None
    return {**best, "host_us_per_launch": (host_s * 1e6 / launches
                                           if launches else None)}


def k1_inputs(h: int, w: int, c: int, dtype, device, seed: int, b: int = B,
              t: int = T):
    g = torch.Generator().manual_seed(seed)
    scale = (9 * c) ** -0.5          # unit-gain 3×3 convs, as SN leaves them

    def rand(*shape, s=1.0):
        return (s * torch.randn(shape, generator=g)).to(device, dtype)

    return (rand(t, b, h, w, 2 * c), rand(t, b, h, w, c),
            torch.tanh(rand(b, h, w, c)).contiguous(),
            rand(3, 3, c, 2 * c, s=scale), rand(3, 3, c, c, s=scale))


def check_k1(device, levels=LEVELS, t: int = T, b: int = B,
             reps: int = 10) -> list[dict]:
    from dvdgan_tpu_torch.kernels import convgru_seq as k1
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, (h, w, c) in enumerate(levels):
            args = k1_inputs(h, w, c, dtype, device, seed=i, b=b, t=t)
            ref = k1.gru_sequence_reference(*args)
            out = k1.gru_sequence_fused(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            row = {"dtype": str(dtype).replace("torch.", ""),
                   "shape": [t, b, h, w, c],
                   "max_abs_err": float(err.max()),
                   "mean_abs_err": float(err.mean()),
                   "ms": cuda_ms(lambda: k1.gru_sequence_fused(*args), reps),
                   "plain_ms": cuda_ms(
                       lambda: k1.gru_sequence_reference(*args), reps),
                   **fwd_bound(t, b, h, w, c, dtype),
                   **device_view(lambda: k1.gru_sequence_fused(*args),
                                 t * k1.LAUNCHES_PER_STEP)}
            row["tflops"] = fwd_flops(t, b, h, w, c) / row["ms"] / 1e9
            print("K1 " + json.dumps(row), flush=True)
            if not row["max_abs_err"] <= TOL[dtype]:
                raise AssertionError(f"K1 disagrees with its plain version: "
                                     f"{row} (atol {TOL[dtype]})")
            rows.append(row)
    return rows


def time_sample(device, g_cfg, seed: int = 0, batch: int = B, cond=None):
    """Steady-state serving rate of `g_cfg`, bf16 batch `batch`, weights
    already on the card (for FP conditioned on the prefixes `cond`, bf16 on
    the card): median of 5 after 2 warm-ups. -> (the rate, the state's
    trees, z, y)."""
    from dvdgan_tpu_torch.models.generator import GeneratorState
    from dvdgan_tpu_torch.train import step
    trees = GeneratorState.create(g_cfg, seed).to(device).trees()
    gen = torch.Generator().manual_seed(1)
    z = torch.randn(batch, g_cfg.z_dim, generator=gen).to(device,
                                                          torch.bfloat16)
    y = torch.randint(0, g_cfg.n_classes, (batch,), generator=gen).to(device)
    for _ in range(2):
        step.sample(*trees, z, y, g_cfg, cond_video=cond)
    torch.cuda.synchronize()
    secs = []
    for _ in range(5):
        t0 = time.perf_counter()
        step.sample(*trees, z, y, g_cfg, cond_video=cond)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    sec = statistics.median(secs)
    clips = {"batch": batch, "dtype": "bfloat16", "img_size": g_cfg.img_size,
             "cond_frames": g_cfg.cond_frames, "n_frames": g_cfg.n_frames,
             "attn_res": g_cfg.attn_res, "ups_fused": g_cfg.ups_fused,
             "attn_fused": g_cfg.attn_fused, "ms_per_batch": sec * 1e3,
             "clips_per_s": batch / sec}
    print("sample_rate " + json.dumps(clips), flush=True)
    return clips, trees, z, y


@contextlib.contextmanager
def k3_calls():
    """Records each call `ops/convgru.py` makes of K3's entry while the
    block runs: its T, plane, the largest |h0| it starts from and its
    launches."""
    from dvdgan_tpu_torch import kernels
    from dvdgan_tpu_torch.kernels import convgru_blocked as k3
    real, log = kernels.gru_sequence_blocked, []

    def recorded(gx, cx, h0, wg, wc):
        n0 = k3.gru_sequence_blocked.launches
        out = real(gx, cx, h0, wg, wc)
        log.append({"t": gx.shape[0], "plane": list(h0.shape[1:]),
                    "h0_max_abs": float(h0.float().abs().max()),
                    "launches": k3.gru_sequence_blocked.launches - n0})
        return out

    kernels.gru_sequence_blocked = recorded
    try:
        yield log
    finally:
        kernels.gru_sequence_blocked = real


def drive_sample(device, route=(), preset=("--preset", "ucf101_64"),
                 batch: int = B, f32_vs_cpu: bool = True
                 ) -> tuple[dict, dict, np.ndarray]:
    """The sample CLI of `preset` at `batch` with the flags `route` (none:
    the unfused routes; FULL: the fused upsample; ON: the fused attention),
    the launch counters zeroed just before. `f32_vs_cpu`: also an f32
    batch-2 sample, card against the CPU. For FP (`--cond_frames` in
    `preset`) the clips are the frames generated after the CLI's dataset
    prefixes; K1 also runs the warm-up over them at every level, and the
    same z with the prefixes of other dataset items must give other clips.
    Each K3 call is recorded (`k3_calls`); for FP, K3 must run the warm-up
    over the prefix and then the generated frames from its last state (h0
    ≠ 0). -> (launches of K1, K3, K5a and K6a, the serving rate, the
    clips)."""
    from dvdgan_tpu_torch import cli
    from dvdgan_tpu_torch.kernels import attention_spatial as k6
    from dvdgan_tpu_torch.kernels import convgru_blocked as k3
    from dvdgan_tpu_torch.kernels import convgru_seq as k1
    from dvdgan_tpu_torch.kernels import ups2x_fused as k5
    from dvdgan_tpu_torch.models.generator import GeneratorState
    from dvdgan_tpu_torch.train import step, trainer
    from dvdgan_tpu_torch.utils.config import parse_config

    argv = ["--mode", "sample", *preset, "--n_samples", str(batch), "--bf16",
            "1", *route]
    cfg = parse_config(argv)
    g_cfg = cfg.g_config()
    with tempfile.TemporaryDirectory() as tmp:
        k1.gru_sequence_fused.launches = k5.ups2x.launches = 0
        k3.gru_sequence_blocked.launches = 0
        k6.spatial_attn_fused.launches = k6.spatial_attn_tiled.launches = 0
        with k3_calls() as k3_log:
            videos = cli.main(argv + ["--out_dir", tmp])
        launches = k1.gru_sequence_fused.launches
        k3_launches = k3.gru_sequence_blocked.launches
        k5a = k5.ups2x.launches
        k6a = k6.spatial_attn_fused.launches
        k6b = k6.spatial_attn_tiled.launches
        saved = np.load(os.path.join(tmp, "samples.npy"))
    want_shape = (batch, g_cfg.n_frames, g_cfg.img_size, g_cfg.img_size, 3)
    if videos.shape != want_shape or saved.shape != want_shape:
        raise AssertionError(f"sample shape {videos.shape}, want {want_shape}")
    if not np.isfinite(videos).all():
        raise AssertionError("non-finite values in the sampled clips")
    if videos.min() < -1.0 or videos.max() > 1.0:
        raise AssertionError(f"clip range [{videos.min()}, {videos.max()}]")
    # FP: each level's GRU also runs over the prefix (the warm-up)
    got = {"k1": launches, "k3": k3_launches, "k5a": k5a, "k6a": k6a,
           "k6b": k6b}
    if got != sample_launches(g_cfg):
        raise AssertionError(f"launches in the sample run with --ups_fused "
                             f"{cfg.ups_fused} --attn_fused {cfg.attn_fused}: "
                             f"{got}, want {sample_launches(g_cfg)}")
    print(f"sample {' '.join(preset[1:])} ups {cfg.ups_fused} attn "
          f"{cfg.attn_fused}: shape {videos.shape} range [{videos.min():.4f}, "
          f"{videos.max():.4f}] K1 launches {launches} K3 launches "
          f"{k3_launches} K5a launches {k5a} K6a launches {k6a} K6b "
          f"launches {k6b}", flush=True)
    if k3_log:
        print(f"sample {' '.join(preset[1:])}: K3 calls {json.dumps(k3_log)}",
              flush=True)
    if k3_log and cfg.cond_frames > 0:
        warm = [c for c in k3_log if c["t"] == g_cfg.cond_frames]
        gen = [c for c in k3_log if c["t"] == g_cfg.n_frames
               and c["h0_max_abs"] > 0]
        if not (warm and gen and all(c["launches"] > 0 for c in k3_log)):
            raise AssertionError(f"K3 did not run the warm-up and then the "
                                 f"generation from its last state: {k3_log}")

    cond = None
    if cfg.cond_frames > 0:     # the CLI's prefixes
        cond = trainer.dataset_prefixes(trainer.build_dataset(cfg),
                                        cfg.cond_frames, batch)
    cond_card = None if cond is None else cond.to(device, torch.bfloat16)
    clips, trees, z, y = time_sample(device, g_cfg, cfg.seed, batch,
                                     cond_card)
    counts = {"k1": launches, "k3": k3_launches, "k5a": k5a, "k6a": k6a}
    if cond is not None:
        # another prefix, the same z and y: another continuation
        again = step.sample(*trees, z, y, g_cfg, cond_video=cond_card)
        other = step.sample(*trees, z, y, g_cfg,
                            cond_video=cond_card.roll(1, 0))
        gap = float((again.float() - other.float()).abs().max())
        print(f"sample {' '.join(preset[1:])}: rolled prefixes, the same z: "
              f"max_abs {gap:.3e}", flush=True)
        if not gap > 0.01:
            raise AssertionError(f"FP clips of other prefixes differ by "
                                 f"{gap} only")
    if not f32_vs_cpu:
        return counts, clips, videos

    # a small f32 sample: card (K1) against the CPU (plain K1 version)
    z2, y2 = z[:2].float(), y[:2]
    c2 = None if cond is None else cond[:2]
    on_card = step.sample(*trees, z2, y2, g_cfg, cond_video=None if c2 is None
                          else c2.to(device)).cpu()
    cpu_trees = GeneratorState.create(g_cfg, cfg.seed).trees()
    on_cpu = step.sample(*cpu_trees, z2.cpu(), y2.cpu(), g_cfg,
                         cond_video=c2)
    err = float((on_card - on_cpu).abs().max())
    print(f"sample {' '.join(preset[1:])} ups {cfg.ups_fused} attn "
          f"{cfg.attn_fused} f32 card vs cpu: max_abs_err {err:.3e} "
          f"(atol {SAMPLE_TOL})", flush=True)
    if not err <= SAMPLE_TOL:
        raise AssertionError(f"f32 sample on the card disagrees with the "
                             f"CPU path: {err}")
    return counts, clips, videos


def check_k2(device, levels=LEVELS, t: int = T, b: int = B_TRAIN,
             reps: int = 10, autograd: bool = True) -> list[dict]:
    """`autograd=False` leaves out the timing of the plain autograd
    backward (its graph holds every f32 intermediate of the sequence)."""
    from dvdgan_tpu_torch.kernels import convgru_bwd as k2
    from dvdgan_tpu_torch.kernels import convgru_seq as k1
    names = ("dgx", "dcx", "dh0", "dwg", "dwc")
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, (h, w, c) in enumerate(levels):
            args = k1_inputs(h, w, c, dtype, device, seed=10 + i, b=b, t=t)
            hs = k1.gru_sequence_fused(*args)
            g = torch.randn(hs.shape, generator=torch.Generator().manual_seed(
                20 + i)).to(device, dtype)
            ref = k2.gru_sequence_bwd_reference(*args, hs, g)
            out = k2.gru_sequence_bwd(*args, hs, g)
            again = k2.gru_sequence_bwd(*args, hs, g)
            torch.cuda.synchronize()
            errs = {n: float((o.float() - r.float()).abs().max())
                    for n, o, r in zip(names, out, ref)}
            scales = {n: float(r.float().abs().max())
                      for n, r in zip(names, ref)}
            # the kernel's own outputs (dW are cuDNN's weight gradients)
            same = all(torch.equal(o, a) for o, a in zip(out[:3], again[:3]))
            del ref, out, again
            row = {"dtype": str(dtype).replace("torch.", ""),
                   "shape": [t, b, h, w, c],
                   "max_abs_err": max(errs.values()),
                   "max_rel_err": max(errs[n] / scales[n] for n in names),
                   "two_runs_bitwise_equal": same,
                   "ms": cuda_ms(lambda: k2.gru_sequence_bwd(*args, hs, g),
                                 reps),
                   "plain_ms": cuda_ms(
                       lambda: k2.gru_sequence_bwd_reference(*args, hs, g),
                       reps),
                   **bwd_bound(t, b, h, w, c, dtype),
                   **device_view(lambda: k2.gru_sequence_bwd(*args, hs, g),
                                 t * k2.LAUNCHES_PER_STEP)}
            row["tflops"] = bwd_flops(t, b, h, w, c) / row["ms"] / 1e9
            if autograd:
                # the plain autograd backward through K1's plain version
                leaves = [a.detach().clone().requires_grad_(True)
                          for a in args]
                hs_plain = k1.gru_sequence_reference(*leaves)
                row["plain_autograd_ms"] = cuda_ms(
                    lambda: torch.autograd.grad(hs_plain, leaves, g,
                                                retain_graph=True), reps)
                del hs_plain, leaves
            print("K2 " + json.dumps(row), flush=True)
            bad = [n for n in names if not errs[n] <= K2_TOL[dtype] * scales[n]]
            if bad or not same:
                raise AssertionError(
                    f"K2 disagrees with its plain version on {bad} or with "
                    f"itself: {errs} (atol {K2_TOL[dtype]} × {scales})")
            rows.append(row)
    return rows


def check_k3(device, reps: int = 10, levels=K3_LEVELS, t: int = LONG_T,
             b: int = LONG_B, b_fake: int = LONG_B_FAKE) -> list[dict]:
    """K3 against its plain version (K1's) at the planes `levels` (the
    long-clip preset's three large ones), timed beside the plain version
    and K1's kernel: in f32 and bf16 at one G micro-batch, and in bf16 at
    the fake pass's batch. Each row: two runs bitwise equal, the bf16 tile
    of the plan, TFLOP/s (the two convs without the rim) and the
    profiler's view of one call (`device_view`), K1's beside it."""
    from dvdgan_tpu_torch.kernels import convgru_blocked as k3
    from dvdgan_tpu_torch.kernels import convgru_seq as k1
    rows = []
    for dtype, nb in ((torch.float32, b), (torch.bfloat16, b),
                      (torch.bfloat16, b_fake)):
        for i, (h, w, c) in enumerate(levels):
            args = k1_inputs(h, w, c, dtype, device, seed=30 + nb + i, b=nb,
                             t=t)
            ref = k3.gru_sequence_blocked_reference(*args)
            out = k3.gru_sequence_blocked(*args)
            again = k3.gru_sequence_blocked(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            same = torch.equal(out, again)
            del ref, out, again
            launches = t * k3.LAUNCHES_PER_STEP
            row = {"dtype": str(dtype).replace("torch.", ""),
                   "shape": [t, nb, h, w, c],
                   "tile": (k3.TILES[k3.plan(nb, h, w, c).tile][:2]
                            if dtype == torch.bfloat16 else [8, 8]),
                   "max_abs_err": float(err.max()),
                   "mean_abs_err": float(err.mean()),
                   "two_runs_bitwise_equal": same,
                   "ms": cuda_ms(lambda: k3.gru_sequence_blocked(*args), reps),
                   "plain_ms": cuda_ms(
                       lambda: k3.gru_sequence_blocked_reference(*args), reps),
                   "k1_ms": cuda_ms(lambda: k1.gru_sequence_fused(*args),
                                    reps),
                   **fwd_bound(t, nb, h, w, c, dtype),
                   **device_view(lambda: k3.gru_sequence_blocked(*args),
                                 launches)}
            flops = fwd_flops(t, nb, h, w, c)
            row["tflops"] = flops / row["ms"] / 1e9
            row["k1_tflops"] = flops / row["k1_ms"] / 1e9
            row["k1_device_ms"] = device_view(
                lambda: k1.gru_sequence_fused(*args),
                t * k1.LAUNCHES_PER_STEP)["device_ms"]
            del err, args
            print("K3 " + json.dumps(row), flush=True)
            if not row["max_abs_err"] <= TOL[dtype] or not same:
                raise AssertionError(f"K3 disagrees with its plain version or "
                                     f"with itself: {row} (atol {TOL[dtype]})")
            rows.append(row)
    return rows


def k5_inputs(n, h, w, cin, cout, dtype, device, seed: int):
    """(wall, xp, g): unit-gain phase kernels, a ReLU'd input zero-padded as
    the layer pads it, and an output cotangent."""
    gen = torch.Generator().manual_seed(seed)
    wall = ((4 * cin) ** -0.5 * torch.randn(4 * cin, 4 * cout, generator=gen)
            ).to(device, dtype)
    x = torch.relu(torch.randn(n, h, w, cin, generator=gen)).to(device, dtype)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1)).contiguous()
    g = torch.randn(n, 2 * h, 2 * w, cout, generator=gen).to(device, dtype)
    return wall, xp, g


def ups_bounds(n, h, w, cin, cout, dtype) -> tuple[dict, dict]:
    """(K5a's, K5b's) bound. K5a: the four useful phases, 16·Cin·Cout MACs
    per source pixel; xp and wall read, out written. K5b: the same product
    twice (dxp, dwall); wall, xp and g read, dxp and dwall written in f32."""
    flops = 2 * n * h * w * 16 * cin * cout
    n_xp, n_wall = n * (h + 2) * (w + 2) * cin, 16 * cin * cout
    n_out = n * 4 * h * w * cout
    return (bound(flops, (n_xp + n_wall + n_out) * dtype.itemsize, dtype),
            bound(2 * flops, (n_xp + n_wall + n_out) * dtype.itemsize
                  + (n_xp + n_wall) * 4, dtype))


def rates(row: dict, flops: float) -> dict:
    """`row` with the kernel's achieved TFLOP/s and its time over the
    library route's (below 1: the kernel is faster)."""
    return {**row, "tflops": flops / row["ms"] / 1e9,
            "vs_library": row["ms"] / row["library_ms"]}


def check_k5(device, levels, n: int, dtypes, reps: int = 5,
             bwd: bool = True) -> tuple[list[dict], list[dict]]:
    """K5a and K5b against their plain versions at the upsample convs of
    `levels` with N = `n` frames, timed beside the plain versions and the
    unfused route on the same inputs (cuDNN phase conv + interleave;
    autograd through it), each row with TFLOP/s and ms / library ms.
    -> (K5a rows, K5b rows)."""
    from dvdgan_tpu_torch.kernels import ups2x_fused as k5
    from dvdgan_tpu_torch.ops import layers
    rows_a, rows_b = [], []
    for dtype in dtypes:
        for i, (h, w, cin, cout) in enumerate(levels):
            wall, xp, g = k5_inputs(n, h, w, cin, cout, dtype, device,
                                    seed=40 + i)
            wall4 = wall.reshape(2, 2, cin, 4 * cout)
            bound_a, bound_b = ups_bounds(n, h, w, cin, cout, dtype)
            flops = 2 * n * h * w * 16 * cin * cout      # K5a; K5b twice
            ref = k5.ups2x_reference(wall, xp)
            out = k5.ups2x(wall, xp)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            row = {"dtype": str(dtype).replace("torch.", ""),
                   "shape": [n, h, w, cin, cout],
                   "max_abs_err": float(err.max()),
                   "mean_abs_err": float(err.mean()),
                   "ms": cuda_ms(lambda: k5.ups2x(wall, xp), reps),
                   "plain_ms": cuda_ms(lambda: k5.ups2x_reference(wall, xp),
                                       reps),
                   "library_ms": cuda_ms(
                       lambda: layers.phase_conv_interleave(wall4, xp), reps),
                   **bound_a}
            row = rates(row, flops)
            del ref, out, err
            print("K5a " + json.dumps(row), flush=True)
            if not row["max_abs_err"] <= TOL[dtype]:
                raise AssertionError(f"K5a disagrees with its plain version: "
                                     f"{row} (atol {TOL[dtype]})")
            rows_a.append(row)
            if not bwd:
                continue

            names = ("dwall", "dxp")
            ref = k5.ups2x_bwd_reference(wall, xp, g)
            out = k5.ups2x_bwd(wall, xp, g)
            again = k5.ups2x_bwd(wall, xp, g)
            torch.cuda.synchronize()
            errs = {k: float((o - r).abs().max())
                    for k, o, r in zip(names, out, ref)}
            scales = {k: float(r.abs().max()) for k, r in zip(names, ref)}
            same = all(torch.equal(a, b) for a, b in zip(out, again))
            del ref, out, again
            leaves = [a.detach().clone().requires_grad_(True)
                      for a in (wall4, xp)]
            unfused = layers.phase_conv_interleave(*leaves)
            row = {"dtype": str(dtype).replace("torch.", ""),
                   "shape": [n, h, w, cin, cout],
                   "max_abs_err": max(errs.values()),
                   "max_rel_err": max(errs[k] / scales[k] for k in names),
                   "two_runs_bitwise_equal": same,
                   "ms": cuda_ms(lambda: k5.ups2x_bwd(wall, xp, g), reps),
                   "plain_ms": cuda_ms(
                       lambda: k5.ups2x_bwd_reference(wall, xp, g), reps),
                   "library_ms": cuda_ms(
                       lambda: torch.autograd.grad(unfused, leaves, g,
                                                   retain_graph=True), reps),
                   **bound_b}
            row = rates(row, 2 * flops)
            del unfused, leaves
            print("K5b " + json.dumps(row), flush=True)
            bad = [k for k in names if not errs[k] <= K2_TOL[dtype] * scales[k]]
            if bad or not same:
                raise AssertionError(
                    f"K5b disagrees with its plain version on {bad} or with "
                    f"itself: {row} (atol {K2_TOL[dtype]} x {scales})")
            rows_b.append(row)
    return rows_a, rows_b


def k6_inputs(n, h, w, c, dtype, device, seed: int, gamma: float = 0.7):
    """(x, wq, wk, wv, wo, γ): unit-gain projections, as SN leaves them."""
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return (shape[0] ** -0.5 * torch.randn(shape, generator=gen)
                ).to(device, dtype)

    x = torch.randn(n, h, w, c, generator=gen).to(device, dtype)
    return (x, rand(c, c // 8), rand(c, c // 8), rand(c, c // 2),
            rand(c // 2, c), torch.tensor(gamma, device=device))


def k6_flops(n, h, w, c) -> tuple[float, float]:
    """K6's operations, as the reference's `cost_estimate` counts them: the
    logits, and the rest (q, k and v once per frame, attn·v, o·Wo)."""
    hw, kvn, c8, c2 = h * w, h * w // 4, c // 8, c // 2
    return (2 * n * hw * kvn * c8,
            2 * n * (hw * c * c8 + kvn * c * (c8 + c2) + hw * kvn * c2
                     + hw * c2 * c))


def k6_bound(n, h, w, c, dtype) -> dict:
    """K6's function: x read and out written once; its operations, each at
    the peak rate of its operands' type: the logits' are f32 whatever the
    activation type (`bound_ms`, at the f32 CUDA-core rate, as the
    f32-logit kernel's rows were counted). `bound_ms_tc` (bf16): the logits at the rate of 3×TF32 on the
    tensor cores, as the bf16 kernel forms them (three TF32 products)."""
    logits, rest = k6_flops(n, h, w, c)
    by_bytes = 2 * n * h * w * c * dtype.itemsize / PEAK_BYTES * 1e3
    by_ops = (logits / PEAK_FLOPS[torch.float32]
              + rest / PEAK_FLOPS[dtype]) * 1e3
    out = {"bound_ms": max(by_ops, by_bytes),
           "bound_by": "operations" if by_ops >= by_bytes else "bytes"}
    if dtype == torch.bfloat16:
        by_tc = (logits / (PEAK_TF32 / 3) + rest / PEAK_FLOPS[dtype]) * 1e3
        out["bound_ms_tc"] = max(by_tc, by_bytes)
    return out


def bf16_ulp(scale: float) -> float:
    """One bf16 ulp (8 significand bits) at magnitude `scale`."""
    return 2.0 ** (int(np.floor(np.log2(scale))) - 7)


def k6_views() -> dict:
    """The profiler's view of one bf16 K6 call (`device_view`) at each
    driven shape, by (N, H, W, C), read in a fresh process
    (`tools/torch_k6_launches.py`). Ten minutes into this script's own
    process torch.profiler on the H100 lost most of K6's short calls (0 of
    their 2 launches seen in 3 tries, f32 calls too) while the ConvGRU
    rows' long calls around them were seen whole; a fresh process saw
    every launch of every call."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_k6_launches.py"),
         "--tag", "k6"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    if proc.returncode:
        raise RuntimeError(f"tools/torch_k6_launches.py failed:\n"
                           f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    views = {}
    for line in proc.stdout.splitlines():
        if line.startswith("k6 "):
            r = json.loads(line[3:])
            views[tuple(r["shape"])] = {
                k: r[k] for k in ("device_ms", "launch_device_us",
                                  "profiled_launches", "profiled_kernels",
                                  "host_us_per_launch")}
    return views


def check_k6(device, name: str, shapes, reps_of, views) -> list[dict]:
    """K6a or K6b against its plain version at the (N, H, W, C) `shapes`,
    through the entry `ops/attention.py` picks for the map, timed beside
    the plain version and the `off` route's spatial pass on the same
    inputs (`library_ms`: cuBLAS products, a softmax kernel, the logits and
    attn through device memory). f32 (TF32 off): atol 1e-4. bf16: one bf16
    ulp at the output's scale on at most K6_DIFFER of the elements. γ = 0
    must give x back bit for bit. Each row also has its TFLOP/s and the
    call's plan; a bf16 row the profiler's view of one call at its shape
    from `views` (`k6_views`: the device µs of each of the two launches;
    `device_ms`, the call's device time with the wrapper's small weight
    copies, None where the profiler missed a launch)."""
    from dvdgan_tpu_torch.kernels import attention_spatial as k6
    from dvdgan_tpu_torch.ops import attention
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, (n, h, w, c) in enumerate(shapes):
            args = k6_inputs(n, h, w, c, dtype, device, seed=80 + i)
            entry = (k6.spatial_attn_tiled if attention.uses_tiled(h, w)
                     else k6.spatial_attn_fused)
            p = {"spatial": dict(zip(("theta", "phi", "g", "out"),
                                     ({"w": a} for a in args[1:5])),
                                 gamma=args[5])}
            ref = k6.spatial_attn_kernel_reference(*args)
            out = entry(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            scale = float(ref.float().abs().max())
            limit = TOL[dtype] if dtype == torch.float32 else bf16_ulp(scale)
            same = torch.equal(entry(*args[:5], torch.zeros_like(args[5])),
                               args[0])
            reps = reps_of(n)
            row = {"dtype": str(dtype).replace("torch.", ""),
                   "shape": [n, h, w, c], "entry": entry.__name__,
                   "max_abs_err": float(err.max()),
                   "mean_abs_err": float(err.mean()), "limit": limit,
                   "n_differ": int((out != ref).sum()), "n": out.numel(),
                   "max_abs_ref": scale, "gamma0_bitwise": same,
                   "ms": cuda_ms(lambda: entry(*args), reps),
                   "plain_ms": cuda_ms(
                       lambda: k6.spatial_attn_kernel_reference(*args), reps),
                   "library_ms": cuda_ms(
                       lambda: attention.spatial_attn(p, args[0]), reps),
                   **k6_bound(n, h, w, c, dtype)}
            row["tflops"] = sum(k6_flops(n, h, w, c)) / row["ms"] / 1e9
            if dtype == torch.bfloat16:
                row.update(views[(n, h, w, c)])
            row["plan"] = dataclasses.asdict(k6.plan(dtype, n, h, w, c,
                                                     c // 8, c // 2))
            del ref, out, err
            print(f"{name} " + json.dumps(row), flush=True)
            differ_ok = (dtype == torch.float32
                         or row["n_differ"] <= K6_DIFFER * row["n"])
            if not row["max_abs_err"] <= limit or not same or not differ_ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version, or γ = 0 moved x: {row}")
            rows.append(row)
    return rows


def sample_route_gap(device, argv=("--preset", "ucf101_64"), batch: int = B,
                     f32_vs_cpu: bool = True) -> dict:
    """EMA-G sampling with `--attn_fused on` against `off` with both
    attention γ off their zero init (at γ = 0 the spatial pass returns x on
    either route): the bf16 clips (batch `batch`) of the two routes on the
    card, and (`f32_vs_cpu`) an f32 batch-2 sample with `on`, card against
    CPU."""
    from dvdgan_tpu_torch.kernels import attention_spatial as k6
    from dvdgan_tpu_torch.models.generator import GeneratorState
    from dvdgan_tpu_torch.train import step
    from dvdgan_tpu_torch.utils.config import parse_config

    argv = list(argv)
    cfgs = {m: parse_config(argv + ["--attn_fused", m]).g_config()
            for m in ("off", "on")}

    def trees(dev):
        state = GeneratorState.create(cfgs["on"], 0).to(dev)
        params, stats, sn_u = state.trees()
        for name, g in (("spatial", 0.6), ("temporal", -0.5)):
            params["attn"][name]["gamma"] = torch.tensor(g, device=dev)
        return params, stats, sn_u

    gen = torch.Generator().manual_seed(3)
    z = torch.randn(batch, cfgs["on"].z_dim, generator=gen).to(device)
    y = torch.randint(0, cfgs["on"].n_classes, (batch,), generator=gen
                      ).to(device)
    card = trees(device)
    k6.spatial_attn_fused.launches = 0
    clips = {m: step.sample(*card, z.bfloat16(), y, cfg).float()
             for m, cfg in cfgs.items()}
    gap = (clips["on"] - clips["off"]).abs()
    res = {"preset": " ".join(argv), "batch": batch,
           "k6a_launches": k6.spatial_attn_fused.launches,
           "bf16_on_vs_off_max_abs": float(gap.max()),
           "bf16_on_vs_off_mean_abs": float(gap.mean()),
           "limit": ATTN_CLIP_TOL}
    if f32_vs_cpu:
        on_card = step.sample(*card, z[:2], y[:2], cfgs["on"]).cpu()
        on_cpu = step.sample(*trees("cpu"), z[:2].cpu(), y[:2].cpu(),
                             cfgs["on"])
        res["f32_on_card_vs_cpu_max_abs"] = float(
            (on_card - on_cpu).abs().max())
        res["f32_limit"] = SAMPLE_TOL
    print("sample attn on vs off (gamma 0.6, -0.5) " + json.dumps(res),
          flush=True)
    if not res["bf16_on_vs_off_max_abs"] <= ATTN_CLIP_TOL:
        raise AssertionError(f"the fused attention's clips differ from the "
                             f"unfused route's: {res}")
    if res["k6a_launches"] != k6.LAUNCHES_PER_CALL:
        raise AssertionError(f"the fused attention's sample launched K6a "
                             f"{res['k6a_launches']} times, want "
                             f"{k6.LAUNCHES_PER_CALL}")
    if f32_vs_cpu and not res["f32_on_card_vs_cpu_max_abs"] <= SAMPLE_TOL:
        raise AssertionError(f"f32 sample with the fused attention, card vs "
                             f"CPU: {res}")
    return res


def k4_launches(args, cluster: int = 0):
    """One K4 step as its launches alone, without the wrapper's Python: the
    C entry of the form `convgru_cell.plan` gives (`cluster`: clusters of
    that size), or K1's gate + candidate pair (`convgru_seq.Steps`, K4's
    two-launch form) where it gives none. -> a function that makes them."""
    from dvdgan_tpu_torch.kernels import convgru_cell as k4
    from dvdgan_tpu_torch.kernels import convgru_seq as k1
    gx, cx, h, wg, wc = args
    b, hh, ww, c = h.shape
    out = torch.empty_like(h)
    pl = k4.plan(h.dtype, b, hh, ww, c, force_cluster=cluster)
    if pl is None:
        return k1_pair_launches((gx[None], cx[None], h, wg, wc), out)
    lib = k4._lib()
    gx_b, gx_pix = k1._pixel_strides(gx[None], "gx")
    cx_b, cx_pix = k1._pixel_strides(cx[None], "cx")
    ptrs = (k1.device_index(h.device), h.data_ptr(), gx.data_ptr(), gx_b,
            gx_pix, cx.data_ptr(), cx_b, cx_pix, wg.data_ptr(), wc.data_ptr(),
            out.data_ptr())
    stream = torch.cuda.current_stream(h.device).cuda_stream
    if h.dtype == torch.bfloat16:
        call = functools.partial(lib.convgru_cell_cluster_step, *ptrs, b, hh,
                                 ww, c, pl.cluster, stream)
    else:
        call = functools.partial(lib.convgru_cell_plane_step, 0, *ptrs, b, hh,
                                 ww, c, stream)

    def launch():
        err = call()
        if err:
            raise RuntimeError(f"K4 launch failed ({err})")
    launch.keep = out
    return launch


def k1_pair_launches(args, out=None):
    """K1's gate + candidate launches of one step (T = 1) alone: args are
    K1's (gx (1, B, H, W, 2C), cx, h0, wg, wc)."""
    from dvdgan_tpu_torch.kernels import convgru_seq as k1
    gx, cx, h, wg, wc = args
    out = torch.empty_like(h) if out is None else out
    steps = k1.Steps(gx, cx, h, wg, wc, h.device)
    ptrs = (h.data_ptr(), gx.data_ptr(), cx.data_ptr(), out.data_ptr())
    counter = types.SimpleNamespace(launches=0)
    launch = functools.partial(steps.run, counter, *ptrs)
    launch.keep = out
    return launch


def launches_ms(launch, per_rep: int = 50, reps: int = 5) -> float:
    """Device ms of one `launch()` call: `per_rep` calls back to back
    between one CUDA-event pair (a ctypes launch takes a few µs of host
    time, so the device sets the pace), median of `reps`."""
    return cuda_ms(lambda: [launch() for _ in range(per_rep)], reps) / per_rep


def check_k4(device, levels, b: int, reps: int = 10) -> list[dict]:
    """K4 against its plain version (one step of K1's) at the GRU planes
    `levels` with batch `b`; `launches` is per call (1 or 2). `ms` is a
    wrapper call in CUDA events (its host work included); `kernel_ms` the
    launches alone, back to back (`k4_launches`). Where K4 takes its
    one-launch form, `k1_pair_ms` and `k1_pair_kernel_ms` are the other
    form at the same shape, K1's gate + candidate launches (K1 at T = 1),
    and a bf16 row names its `cluster` size; at B 2 (the long clip) a bf16
    row also runs clusters of 16 (the card's non-portable most): its
    kernel ms, and the same bits as the plan's clusters of 8."""
    from dvdgan_tpu_torch.kernels import convgru_cell as k4
    from dvdgan_tpu_torch.kernels import convgru_seq as k1
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, (h, w, c) in enumerate(levels):
            gx, cx, h0, wg, wc = k1_inputs(h, w, c, dtype, device,
                                           seed=50 + i, b=b, t=1)
            args = (gx[0], cx[0], h0, wg, wc)
            ref = k4.gru_cell_reference(*args)
            before = k4.gru_cell_fused.launches
            out = k4.gru_cell_fused(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            row = {"dtype": str(dtype).replace("torch.", ""),
                   "shape": [b, h, w, c],
                   "launches_per_call": k4.gru_cell_fused.launches - before,
                   "max_abs_err": float(err.max()),
                   "mean_abs_err": float(err.mean()),
                   "ms": cuda_ms(lambda: k4.gru_cell_fused(*args), reps),
                   "plain_ms": cuda_ms(lambda: k4.gru_cell_reference(*args),
                                       reps),
                   "kernel_ms": launches_ms(k4_launches(args)),
                   **fwd_bound(1, b, h, w, c, dtype)}
            pl = k4.plan(dtype, b, h, w, c)
            if row["launches_per_call"] == 1:
                row["k1_pair_ms"] = cuda_ms(
                    lambda: k1.gru_sequence_fused(gx, cx, h0, wg, wc), reps)
                row["k1_pair_kernel_ms"] = launches_ms(
                    k1_pair_launches((gx, cx, h0, wg, wc)))
            if dtype == torch.bfloat16 and pl is not None:
                row["cluster"] = pl.cluster
                if b == LONG_B:
                    plan = k4.plan
                    k4.plan = functools.partial(plan, force_cluster=16)
                    try:
                        wide = k4.gru_cell_fused(*args)
                    finally:
                        k4.plan = plan
                    row["cluster16"] = {
                        "kernel_ms": launches_ms(k4_launches(args, 16)),
                        "bitwise_vs_cluster8": torch.equal(wide, out)}
            print("K4 " + json.dumps(row), flush=True)
            if not row["max_abs_err"] <= TOL[dtype]:
                raise AssertionError(f"K4 disagrees with its plain version: "
                                     f"{row} (atol {TOL[dtype]})")
            if not row.get("cluster16", {}).get("bitwise_vs_cluster8", True):
                raise AssertionError(f"K4's clusters of 16 change the bits of "
                                     f"its clusters of 8: {row}")
            rows.append(row)
    return rows


def drive_cell(device, levels=LEVELS, t: int = T, b: int = B) -> int:
    """The single-step entry over `t` steps at the GRU planes `levels`
    (bf16, batch `b`): K4 on K1's own gx/cx and K1's previous state must
    give K1's next state, bit for bit where K4 takes K1's two launches
    (planes over 8×8), within K1's atol where it takes its one cluster
    launch (K1 adds its split-K partial sums there: another order); and
    `ops.convgru.convgru_cell` unrolled must agree with
    `ops.convgru.convgru` (their input convs run at other batch sizes, so
    cuDNN may sum them in another order: atol as K1's). -> K4's launches
    in the unroll through the entry."""
    from dvdgan_tpu_torch.kernels import convgru_cell as k4
    from dvdgan_tpu_torch.kernels import convgru_seq as k1
    from dvdgan_tpu_torch.ops import convgru
    dtype = torch.bfloat16
    launches = 0
    for i, (h, w, c) in enumerate(levels):
        gx, cx, h0, wg, wc = k1_inputs(h, w, c, dtype, device, seed=60 + i,
                                       b=b, t=t)
        hs = k1.gru_sequence_fused(gx, cx, h0, wg, wc)
        one_launch = max(h, w) <= k4.PLANE_MAX
        step_err = 0.0
        for k in range(t):
            hid = k4.gru_cell_fused(gx[k], cx[k], h0 if k == 0 else hs[k - 1],
                                    wg, wc)
            step_err = max(step_err,
                           float((hid.float() - hs[k].float()).abs().max()))
            if not (step_err <= TOL[dtype] if one_launch
                    else torch.equal(hid, hs[k])):
                raise AssertionError(f"K4 differs from K1's step at level "
                                     f"{(h, w, c)}, step {k}: {step_err}")

        gen = torch.Generator().manual_seed(70 + i)
        p = convgru.convgru_init(gen, c)
        p = {k: {n: ((9 * c) ** -0.5 * v).to(device, dtype)
                 for n, v in d.items()} for k, d in p.items()}
        x = torch.randn(t, b, h, w, c, generator=gen).to(device, dtype)
        seq = convgru.convgru(p, x, time_major=True)
        hid = torch.zeros(b, h, w, c, dtype=dtype, device=device)
        k4.gru_cell_fused.launches = 0
        outs = []
        for k in range(t):
            hid = convgru.convgru_cell(p, x[k], hid)
            outs.append(hid)
        torch.cuda.synchronize()
        n = k4.gru_cell_fused.launches
        want = t * (1 if max(h, w) <= k4.PLANE_MAX else 2)
        if n != want:
            raise AssertionError(f"K4 launched {n} times over {t} steps at "
                                 f"{(h, w, c)}, want {want}")
        launches += n
        err = float((torch.stack(outs).float() - seq.float()).abs().max())
        print(f"cell unroll {(t, b, h, w, c)}: K4 on K1's gx/cx and state "
              + (f"max_abs_err {step_err:.3e} (one launch)" if one_launch
                 else "bitwise equal (K1's two launches)")
              + f"; convgru_cell vs convgru max_abs_err {err:.3e}, "
              f"bitwise {torch.equal(torch.stack(outs), seq)}; K4 launches "
              f"{n}", flush=True)
        if not err <= TOL[dtype]:
            raise AssertionError(f"convgru_cell unrolled disagrees with "
                                 f"convgru at {(h, w, c)}: {err}")
    return launches


def _tree_moved(before, after) -> tuple[int, int]:
    """(leaves that changed, leaves) of two flat {path: array} dicts."""
    moved = sum(not np.array_equal(before[k], after[k]) for k in before)
    return moved, len(before)


FLAGSHIP_ARGV = ["--mode", "train", "--preset", "ucf101_64", "--dataset",
                 "synthetic", "--batch_size", str(B_TRAIN), "--bf16", "1"]
# DVD-GAN-FP at the paper's Kinetics-600 prediction setting, with the
# reference's own flags: 64 px, 16-frame clips of which 5 are the real
# prefix and 11 are generated; ch 32, 600 classes. Cut: the batch (16 to
# sample, 8 to train) and the data (synthetic clips, not Kinetics)
FP_PRESET = ["--preset", "kinetics_64", "--n_frames", "16", "--cond_frames",
             "5", "--dataset", "synthetic"]
FP_ARGV = ["--mode", "train", *FP_PRESET, "--batch_size", str(B_TRAIN),
           "--bf16", "1"]
FP_STEPS = 2
# started as two other flagship-sized children end (`drive_trains`): eleven
# children at once ran the 80 GB card out of memory, as fifteen did before
FP_AFTER = {"fp_k1": ("train_fused", None, FP_ARGV, FP_STEPS),
            "fp_k2": ("frames_k1", None, FP_ARGV + [
                "--steps_per_call", "2", "--log_step", "2"], FP_STEPS)}
# K6's domain paths' train children (P_TRAIN), each started as a child of
# the flagship's or the long clip's size ends: P2 (ch 96) and P3 (FP at
# 128 px, 21 frames) where a long-clip child leaves its ~10 GB
P_AFTER = {"p1_train": ("px128", None, P_TRAIN["p1"], P_STEPS),
           "p2_train": ("longclip", None, P_TRAIN["p2"], P_STEPS),
           "p3_train": ("longclip_fused", None, P_TRAIN["p3"], P_STEPS)}
# the f32 step card vs CPU at the FP widths, batch 2: d_steps 1 (ROADMAP
# Queue 3: f32 steps at d_steps 2 are chaotic), and the per_step fakes
FP_F32 = ("--preset", "kinetics_64", "--n_frames", "16", "--cond_frames",
          "5", "--batch_size", "2", "--d_steps", "1")
FP_F32_PER_STEP = (*FP_F32[:-1], "2", "--fake_gen", "per_step")


def launches_per_step(cfg) -> dict[str, int]:
    """Kernel launches of one train step of `cfg`: the D phase's fake
    forwards (one pooled, or d_steps with `--fake_gen per_step`) and one G
    forward per micro-batch run each level's sequence kernel (K3 where
    `ops/convgru.py` sends the plane, else K1) over T steps, and one K2 per
    level and micro-batch goes back over them. For FP (cond_frames > 0)
    every level's GRU also runs over the prefix before (the warm-up), and
    its K2 goes back over it: cond_frames + T steps each. With remat, a
    policy that keeps no GRU output (`--remat_save ups` or `none`) reruns
    each G forward's generation sequences in the backward, and one that
    keeps no upsample output (`gru`, `ups`, `none`) reruns the fused conv
    (`models/generator.py:_level`)."""
    from dvdgan_tpu_torch.kernels import convgru_blocked as k3
    from dvdgan_tpu_torch.kernels import convgru_bwd as k2
    from dvdgan_tpu_torch.kernels import convgru_seq as k1
    from dvdgan_tpu_torch.kernels import attention_spatial as k6
    from dvdgan_tpu_torch.kernels import ups2x_fused as k5
    from dvdgan_tpu_torch.ops import attention, convgru
    g_cfg = cfg.g_config()
    planes = [(g_cfg.base_res * 2 ** i, g_cfg.level_channels(i)[0])
              for i in range(g_cfg.n_levels)]
    n_k3 = sum(convgru.uses_blocked(r, r) for r, _ in planes)
    t, ka = g_cfg.cond_frames + g_cfg.n_frames, cfg.grad_accum
    fwd = (1 if cfg.fake_gen == "pooled" else cfg.d_steps) + ka
    # the fused upsample conv: K5a once per level in every G forward (none
    # from a remat backward under `gru+ups`), K5b once per level in every G
    # backward
    k5a = cfg.ups_fused != "off"
    k5b = cfg.ups_fused == "full"
    # the remat backward's reruns: the G forwards' sequences (not the FP
    # warm-up's, which runs outside the regions) and fused convs
    rerun_gru = ka * (g_cfg.remat and g_cfg.remat_save in ("ups", "none"))
    rerun_ups = ka * (g_cfg.remat and g_cfg.remat_save != "gru+ups")
    # the fused spatial attention: one call (two launches) per G forward,
    # through the entry the map's size picks; none from a backward (the
    # backward recomputes the unfused math, and under remat the fused pass
    # runs outside the checkpoint regions)
    n_k6 = (cfg.attn_fused == "on" and g_cfg.attn_res is not None) * (
        fwd * k6.LAUNCHES_PER_CALL)
    tiled = g_cfg.attn_res is not None and attention.uses_tiled(
        g_cfg.attn_res, g_cfg.attn_res)
    n = g_cfg.n_frames
    return {"k1_launches": (g_cfg.n_levels - n_k3) * (t * fwd + n * rerun_gru)
            * k1.LAUNCHES_PER_STEP,
            "k2_launches": g_cfg.n_levels * t * ka * k2.LAUNCHES_PER_STEP,
            "k3_launches": n_k3 * (t * fwd + n * rerun_gru)
            * k3.LAUNCHES_PER_STEP,
            "k5a_launches": k5a * g_cfg.n_levels * (fwd + rerun_ups)
            * k5.LAUNCHES_PER_CALL,
            "k5b_launches": k5b * g_cfg.n_levels * ka
            * k5.BWD_LAUNCHES_PER_CALL,
            "k6a_launches": 0 if tiled else n_k6,
            "k6b_launches": n_k6 if tiled else 0}


@contextlib.contextmanager
def child_threads(n_children: int):
    """Inside the block, child processes started take a share of the host's
    cores for torch's CPU work (OMP_NUM_THREADS), as a launcher sets them
    (`pmesh.share_cores`): children side by side with a thread a core each
    oversubscribe the host."""
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = str(max(
        1, len(os.sched_getaffinity(0)) // n_children))
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = saved


def start_train(argv, n_steps: int, tmp=None, first: int = 0) -> dict:
    """Starts the train CLI in a child process (its launch counters start
    at 0), every step logged and a checkpoint at the last one unless `argv`
    says otherwise; `finish_train` waits for it and checks the run. `tmp`:
    the out_dir of an earlier run to resume, at step `first`."""
    from dvdgan_tpu_torch.utils.config import parse_config

    argv = ["--log_step", "1", "--sample_step", "0", "--model_save_step",
            str(n_steps), *argv, "--total_step", str(n_steps)]
    tmp = tmp or tempfile.TemporaryDirectory()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dvdgan_tpu_torch", *argv, "--out_dir",
         tmp.name], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return {"procs": [proc], "tmp": tmp, "cfg": parse_config(argv),
            "n_steps": n_steps, "first": first, "t0": time.perf_counter()}


def finish_train(run: dict, keep: bool = False) -> dict:
    """Waits for a `start_train` run; returns its K1 … K6b launches, its
    wall seconds, its peak device memory and its stdout; with `keep` also
    its final state (flat) and out_dir, which then outlives the call."""
    proc = run["procs"][0]
    try:
        try:
            stdout, stderr = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        secs = time.perf_counter() - run["t0"]
        print(stdout, end="", flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"train CLI exited {proc.returncode}:\n"
                                 f"{stderr[-4000:]}")
    except BaseException:
        if not keep:
            run["tmp"].cleanup()
        raise
    return checked_run(run, stdout, secs, keep)


def checked_run(run: dict, stdout: str, secs: float, keep: bool) -> dict:
    """A train CLI run that ended with its stdout (the leader's, for a run
    of ranks) checked: its newest checkpoint, step lines, launches per
    step, finite losses and state, the trees that moved. -> its launches,
    seconds, peak memory and stdout (with `keep`: its state and out_dir,
    which then outlives the call)."""
    from dvdgan_tpu_torch import interop
    from dvdgan_tpu_torch.train import checkpoint as ckpt
    from dvdgan_tpu_torch.train import state as train_state
    from dvdgan_tpu_torch.utils.logging import parse_step_line

    cfg, n_steps = run["cfg"], run["n_steps"]
    g_cfg = cfg.g_config()
    tmp = run["tmp"].name
    try:
        ckpt_dir = os.path.join(tmp, "checkpoints")
        if ckpt.latest_step(ckpt_dir) != n_steps:
            raise AssertionError(f"newest checkpoint "
                                 f"{ckpt.latest_step(ckpt_dir)}, want "
                                 f"{n_steps}")
        with np.load(os.path.join(ckpt_dir, str(n_steps),
                                  ckpt.STATE_FILE)) as f:
            after = {k: f[k] for k in f.files}
    finally:
        if not keep:
            run["tmp"].cleanup()
    steps = [parse_step_line(ln) for ln in stdout.splitlines()
             if ln.startswith("step ")]
    logged = [s for s in range(run["first"] + 1, n_steps + 1)
              if s % cfg.log_step == 0]
    if [n for n, _ in steps] != logged:
        raise AssertionError(f"step lines {[n for n, _ in steps]}, want "
                             f"{logged}")
    want = launches_per_step(cfg)
    for _, s in steps:
        losses = [s[k] for k in ("d_loss", "d_loss_s", "d_loss_t", "g_loss")]
        if not np.isfinite(losses).all():
            raise AssertionError(f"non-finite loss in the train run: {s}")
        got = {k: int(s[k]) for k in want}
        if got != want:
            raise AssertionError(f"launches per train step {got}, want {want}")
    if int(after["step"]) != n_steps:
        raise AssertionError(f"final step {after['step']}")
    if not all(np.isfinite(v).all() for v in after.values()):
        raise AssertionError("non-finite values in the final train state")
    before = interop.train_state_to_flat(train_state.create(
        cfg.seed, g_cfg, cfg.ds_config(), cfg.dt_config()))
    moved = {}
    fp = ("g/params/fp_enc/",) if g_cfg.cond_frames else ()
    for prefix in ("g/params/", *fp, "ds/params/", "dt/params/", "g/sn_u/",
                   "ds/sn_u/", "dt/sn_u/", "g/stats/"):
        keys = [k for k in before if k.startswith(prefix)]
        moved[prefix] = _tree_moved({k: before[k] for k in keys},
                                    {k: after[k] for k in keys})
    print("train moved leaves " + json.dumps(moved), flush=True)
    # one step from the orthogonal init leaves every SN u where it was
    for prefix, (n_moved, n) in moved.items() if n_steps > 1 else ():
        # every param tree moves almost whole; an SN u moves once its
        # (orthogonally initialised) kernel has left the orthogonal group
        least = 0.9 * n if "/params/" in prefix else 1
        if n_moved < least:
            raise AssertionError(f"{prefix}: {n_moved} of {n} leaves moved")
    peak = [float(ln.split()[3]) for ln in stdout.splitlines()
            if ln.startswith("peak device memory ")]
    n_run = n_steps - run["first"]
    out = {**{k[:-len("_launches")]: n_run * n for k, n in want.items()},
           "per_step": want, "cli_s": secs,
           "peak_mem_gib": peak[0] if peak else None,     # none on a CPU
           "stdout": stdout}
    if keep:
        out.update(state=after, out_dir=tmp, tmp=run["tmp"])
    return out


def out_dir_at(src: str, step: int) -> tempfile.TemporaryDirectory:
    """A copy of the train CLI's out_dir `src` as a run stopped at `step`
    leaves it: its checkpoints, sample files and scalar lines up to `step`
    (`samples/<step>_…`, `logs/scalars.jsonl`)."""
    tmp = tempfile.TemporaryDirectory()

    def later(name: str) -> bool:
        head = name.split("_")[0]
        return head.isdigit() and int(head) > step

    shutil.copytree(src, tmp.name, dirs_exist_ok=True,
                    ignore=lambda d, names: [n for n in names if later(n)])
    scalars = os.path.join(tmp.name, "logs", "scalars.jsonl")
    with open(scalars) as f:
        keep = [ln for ln in f if json.loads(ln)["step"] <= step]
    with open(scalars, "w") as f:
        f.writelines(keep)
    return tmp


def drive_trains(runs: dict[str, tuple], resumes=None, keep=(),
                 start=start_train, finish=finish_train,
                 meanwhile=None) -> dict[str, dict]:
    """The train CLI once per entry of `runs` ({name: (flags, steps)}), the
    child processes side by side on the one card (each takes most of its
    time to start: the interpreter, CUDA, the seeded init), each checked
    when it ends, in order. `resumes` ({name: (run it resumes, step, flags,
    steps)}): a run started, as soon as the earlier one has ended, in a
    copy of that one's out_dir as it stood at `step` (`out_dir_at`); with
    step None, a fresh run that only waits for the earlier one, so that
    fewer runs share the card's memory at once. Runs named in `keep` keep
    their out_dir and final state (the caller cleans up). `start` and
    `finish` start and check one run (`start_train`, `finish_train`; the
    ranks of one run: `start_ranks`, `finish_ranks`); `meanwhile()` runs
    on a thread of this process while the runs go on (its error is raised
    once they have ended), else the parent launches nothing meanwhile."""
    resumes = resumes or {}
    specs = {**runs, **{k: v[2:] for k, v in resumes.items()}}
    sources = {src for src, at, _, _ in resumes.values() if at is not None}
    started = {name: start(*run) for name, run in runs.items()}
    order, done = list(started), {}
    side = concurrent.futures.ThreadPoolExecutor(1)
    try:
        aside = side.submit(meanwhile or (lambda: None))
        while order:
            name = order.pop(0)
            print(f"--- train CLI run {name!r}: "
                  f"{' '.join(specs[name][0][2:])}", flush=True)
            done[name] = finish(started[name], keep=(
                name in keep or name in sources))
            print(f"train CLI run {name!r}: ended {done[name]['cli_s']:.1f} s "
                  f"after it began, peak device memory "
                  f"{done[name]['peak_mem_gib']} GiB", flush=True)
            for later, (src, at, argv, steps) in resumes.items():
                if src == name:
                    started[later] = (
                        start(argv, steps) if at is None else
                        start(argv, steps,
                              out_dir_at(done[src]["out_dir"], at), at))
                    order.append(later)
        aside.result()
    finally:
        for run in started.values():        # stop whatever still runs
            for proc in run["procs"]:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        side.shutdown()
        kept = {id(done[k]["tmp"]) for k in keep if k in done}
        for run in done.values():
            if "tmp" in run and id(run["tmp"]) not in kept:
                run["tmp"].cleanup()
    return done


class Replay:
    """Fixed draws (z by stream, frame indices by stream) on one device."""

    def __init__(self, zs: dict, ids: dict, device):
        self.zs, self.ids, self.device = zs, ids, device

    def z(self, i):
        return self.zs[i].to(self.device)

    def idx(self, i):
        return self.ids[i].to(self.device)


def step_configs(argv):
    """(batch, seed, G, DS, DT and train configs) of the CLI flags `argv`."""
    from dvdgan_tpu_torch.utils.config import parse_config
    cfg = parse_config(argv)
    return (cfg.batch_size, cfg.seed, cfg.g_config(), cfg.ds_config(),
            cfg.dt_config(), cfg.train_config())


def time_train(device, name: str = "train_rate", argv=FLAGSHIP_ARGV,
               n_warm: int = 2, n_steps: int = 5, n_prof: int = 2,
               n_top: int = 15) -> dict:
    """bf16 train steps/s of the configuration `argv` names (the flagship
    at batch 8 by default), and the profiler's view over `n_prof` further
    steps (none with `n_prof=0`: the repeat reading of a pair)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dvdgan_tpu_torch.train import state as train_state
    from dvdgan_tpu_torch.train import step

    batch, seed, g_cfg, ds_cfg, dt_cfg, tc = step_configs(argv)
    state = train_state.to_device(
        train_state.create(seed, g_cfg, ds_cfg, dt_cfg), device)
    gen = torch.Generator(device).manual_seed(seed)
    real = torch.tanh(torch.randn(batch, dt_cfg.n_frames, g_cfg.img_size,
                                  g_cfg.img_size, 3, generator=gen,
                                  device=device)).to(torch.bfloat16)
    y = torch.randint(0, g_cfg.n_classes, (batch,), generator=gen,
                      device=device)
    torch.cuda.reset_peak_memory_stats()
    i = 0

    def one():
        nonlocal state, i
        draws = step.TorchDraws(seed, i, batch, g_cfg.z_dim, g_cfg.n_frames,
                                ds_cfg.k_frames, torch.bfloat16, device)
        state, metrics = step.train_step(state, real, y, draws, g_cfg,
                                         ds_cfg, dt_cfg, tc)
        i += 1
        return metrics

    for _ in range(n_warm):
        one()
    torch.cuda.synchronize()
    secs = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    sec = statistics.median(secs)
    out = {"batch": batch, "grad_accum": tc.grad_accum, "dtype": "bfloat16",
           "ups_fused": g_cfg.ups_fused, "attn_fused": g_cfg.attn_fused,
           "frames": g_cfg.n_frames, "img_size": g_cfg.img_size,
           "ms_per_step": sec * 1e3, "steps_per_s": 1.0 / sec,
           "step_ms_all": [x * 1e3 for x in secs],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    if n_prof == 0:
        print(name + " " + json.dumps(out), flush=True)
        return out

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_prof):
            one()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side entries only: a host op's self device time repeats its
    # kernels', and kernels launched through ctypes land on the enclosing
    # autograd Function's range as well
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_us = sum(dev_us(e) for e in kernels)
    gru_us = sum(dev_us(e) for e in kernels
                 if any(k in e.key for k in CONVGRU_KERNELS))
    ups_us = sum(dev_us(e) for e in kernels
                 if any(k in e.key for k in UPS_KERNELS))
    attn_us = sum(dev_us(e) for e in kernels
                  if any(k in e.key for k in ATTN_KERNELS))
    softmax_us = sum(dev_us(e) for e in kernels if "softmax" in e.key.lower())
    top = sorted(kernels, key=dev_us, reverse=True)[:15]
    out = {**out,
           "ups2x_kernels_ms_per_step": ups_us / n_prof / 1e3,
           # K6's two kernels; and every softmax kernel of the step (both
           # routes' temporal pass and backward, the `off` route's spatial
           # pass): the part of the unfused attention that has a name
           "attn_kernels_ms_per_step": attn_us / n_prof / 1e3,
           "softmax_kernels_ms_per_step": softmax_us / n_prof / 1e3,
           "profiled_ms_per_step": wall_us / n_prof / 1e3,
           "device_busy_ms_per_step": busy_us / n_prof / 1e3,
           "convgru_kernels_ms_per_step": gru_us / n_prof / 1e3,
           "convgru_kernels_share": gru_us / busy_us,
           # against the unprofiled step (the profiler slows the host)
           "device_idle_share": 1.0 - busy_us / n_prof / 1e6 / sec,
           "device_idle_share_profiled": 1.0 - busy_us / wall_us}
    print(name + " " + json.dumps(out), flush=True)
    for e in top[:n_top]:
        print(f"  device {dev_us(e) / n_prof / 1e3:9.3f} ms/step "
              f"x{e.count // n_prof:<5d} {e.key[:90]}", flush=True)
    return out


LONG_F32_ARGV = ["--preset", "kinetics_256_48f", "--ch", "8", "--d_ch", "8",
                 "--n_frames", "4", "--k_frames", "2", "--batch_size", "2",
                 "--grad_accum", "2"]


def off_init(state: dict, seed: int) -> dict:
    """`state` moved off its init, as the CPU step tests' `reference_state`
    moves theirs: every parameter plus 0.05 N(0, 1), Adam's count 3 with mu
    1e-3 N(0, 1) and nu |1e-4 N(0, 1)|. At the init Adam's state is zero
    and its first update is sign-like: a D gradient entry within rounding
    of zero moves its weight by +lr on one device and -lr on the other, and
    the G phase after it scores against two different Ds. Off the init an
    update is a smooth function of the gradient."""
    from dvdgan_tpu_torch.core import tree

    gen = torch.Generator().manual_seed(seed)

    def noise(v, scale):
        return scale * torch.randn(v.shape, generator=gen)

    out = dict(state)
    for m in ("g", "ds", "dt"):
        part = dict(state[m])
        part["params"] = tree.tree_map(lambda v: v + noise(v, 0.05),
                                       state[m]["params"])
        part["opt"] = {
            "count": torch.tensor(3, dtype=torch.int32),
            "mu": tree.tree_map(lambda v: noise(v, 1e-3), state[m]["opt"]["mu"]),
            "nu": tree.tree_map(lambda v: noise(v, 1e-4).abs(),
                                state[m]["opt"]["nu"])}
        out[m] = part
    out["g_ema"] = tree.tree_map(torch.clone, out["g"]["params"])
    return out


# from the init, the card's f32 g_loss against the float64 step: within
# F64_G_LOSS[0] x the CPU f32's distance from it + F64_G_LOSS[1] (the
# largest over the draw sets of each); PERF.md §6, before the first run
F64_G_LOSS = (2.0, 1e-3)


def check_train_f32(device, name: str = "train f32",
                    argv=("--preset", "ucf101_64", "--batch_size", "2",
                          "--d_steps", "1"), draw_seeds=(None,),
                    start_off_init: bool = False,
                    f64_witness: bool = False) -> dict:
    """One f32 step of the configuration `argv` names (the flagship widths
    at batch 2, d_steps 1, by default), card against CPU: losses atol 1e-3,
    Adam mu within 1e-3 x max|mu|, for each draw set of `draw_seeds` (None:
    z and indices from this check's own generator; an int s: the draws
    `TorchDraws(s, 0, ...)` gives on the CPU, replayed on both devices).

    d_steps 1: a second D step starts from Adam's first update, which is
    sign-like (every weight moves by ±lr), so a gradient entry near zero
    that differs by one f32 ulp between card and CPU moves its weight
    apart by 2·lr, and the second step's gradient with it (ROADMAP Queue
    3: the flagship check at d_steps 2 once read g_loss 5.3e-3 and DS mu
    1.5e-3 x max|mu| apart with `TorchDraws(1, 0, …)`'s draws).
    `start_off_init` starts from `off_init`'s state: from the init
    (`start_off_init=False`) d_steps 1 still read g_loss 1.2e-4–2.6e-3
    apart (|g_loss| 247–410: the G phase scores against the D that Adam's
    sign-like first update left) and G's mu 1.2–1.8e-4 x max|mu| over the
    three draw sets (an H100 80GB HBM3 at 700 W).

    `f64_witness` also runs each step on the CPU in float64 (the state,
    clip and z; the same draws) and holds g_loss by it instead of card
    against CPU: over the draw sets, the card's largest distance from the
    float64 g_loss within twice the CPU f32's plus 1e-3 (`F64_G_LOSS`).
    The D losses and every Adam mu stay held card against CPU.

    With `--attn_fused on` both attention γ are set off their zero init (at
    γ = 0 the spatial pass returns x on either route), and the step also
    runs on the card with the route off: `on` is held to `off` on the same
    card as well (losses 1e-3, mu 1e-4 x max|mu|: the kernel's own
    difference), and `off` against the CPU is printed as the witness.
    Measured on an H100 at these widths, `on` against `off` on the card:
    mu 6.3e-4 x max|mu| and g_loss 1e-2 apart with d_steps 2, 1.2e-5 and
    1.5e-5 with d_steps 1."""
    from dvdgan_tpu_torch.core import tree
    from dvdgan_tpu_torch.kernels import convgru_blocked as k3
    from dvdgan_tpu_torch.train import state as train_state
    from dvdgan_tpu_torch.train import step

    b, seed, g_cfg, ds_cfg, dt_cfg, tc = step_configs(list(argv))
    gen = torch.Generator().manual_seed(seed + 1)
    # whole clips (an FP prefix included); frame indices over the frames
    # G generates
    real = torch.tanh(torch.randn(b, dt_cfg.n_frames, g_cfg.img_size,
                                  g_cfg.img_size, 3, generator=gen))
    y = torch.randint(0, g_cfg.n_classes, (b,), generator=gen)
    n_streams = 3 * tc.d_steps + 2     # z at multiples of 3, indices between
    own = (
        {i: torch.randn(b, g_cfg.z_dim, generator=gen)
         for i in range(0, n_streams, 3)},
        {i: torch.rand(b, g_cfg.n_frames, generator=gen).argsort(dim=1)[
            :, :ds_cfg.k_frames] for i in range(n_streams) if i % 3})

    def draw_set(s):
        if s is None:
            return own
        held = step.HeldDraws(tc.d_steps, b, g_cfg.z_dim, ds_cfg.k_frames,
                              torch.float32, "cpu")
        held.fill(step.TorchDraws(s, 0, b, g_cfg.z_dim, g_cfg.n_frames,
                                  ds_cfg.k_frames, torch.float32, "cpu"))
        return held.zs, held.ids

    state = train_state.create(seed, g_cfg, ds_cfg, dt_cfg)
    if start_off_init:
        state = off_init(state, seed + 2)
    fused_attn = g_cfg.attn_fused == "on"
    if fused_attn:
        for part, gamma in (("spatial", 0.6), ("temporal", -0.5)):
            state["g"]["params"]["attn"][part]["gamma"] = torch.tensor(gamma)

    def run(dev, cfg, draws, dtype=torch.float32):
        def cast(v):
            return v.to(dtype) if v.is_floating_point() else v

        return step.train_step(
            train_state.to_device(tree.tree_map(cast, state), dev),
            real.to(dev, dtype), y.to(dev),
            Replay({i: cast(v) for i, v in draws[0].items()}, draws[1], dev),
            cfg, ds_cfg, dt_cfg, tc)

    def gaps(out, ref):
        """(loss |differences|, per model max |mu difference| / max|mu|)."""
        loss = {k: abs(float(out[1][k]) - float(ref[1][k])) for k in ref[1]}
        mu = {}
        for m in ("g", "ds", "dt"):
            ref_mu = tree.flatten_with_paths(ref[0][m]["opt"]["mu"])
            out_mu = tree.flatten_with_paths(out[0][m]["opt"]["mu"])
            scale = max(float(v.abs().max()) for v in ref_mu.values())
            mu[m] = max(float((out_mu[k].cpu() - v.cpu()).abs().max())
                        for k, v in ref_mu.items()) / scale
        return loss, mu

    res = {"ups_fused": g_cfg.ups_fused, "attn_fused": g_cfg.attn_fused,
           "cond_frames": g_cfg.cond_frames, "d_steps": tc.d_steps,
           "fake_gen": tc.fake_gen, "by_draws": []}
    for s in draw_seeds:
        draws = draw_set(s)
        t0 = time.perf_counter()
        ref = run("cpu", g_cfg, draws)
        cpu_s = time.perf_counter() - t0
        k3_before = k3.gru_sequence_blocked.launches
        out = run(device, g_cfg, draws)
        k3_launches = k3.gru_sequence_blocked.launches - k3_before
        loss_err, mu_err = gaps(out, ref)
        row = {"draws": "own" if s is None else f"TorchDraws({s}, 0)",
               "losses": {k: float(v) for k, v in ref[1].items()},
               "loss_abs_err": loss_err, "mu_err_over_max_mu": mu_err,
               "cpu_step_s": cpu_s, "k3_launches": k3_launches}
        if f64_witness:
            t0 = time.perf_counter()
            f64 = run("cpu", g_cfg, draws, torch.float64)[1]["g_loss"]
            row["f64_step_s"] = time.perf_counter() - t0
            row["g_loss_f64"] = float(f64)
            row["g_loss_card_vs_f64"] = abs(float(out[1]["g_loss"]) - float(f64))
            row["g_loss_cpu_vs_f64"] = abs(float(ref[1]["g_loss"]) - float(f64))
        if fused_attn:
            off = run(device, dataclasses.replace(g_cfg, attn_fused="off"),
                      draws)
            row["off_card_vs_cpu"] = gaps(off, ref)
            row["on_vs_off_on_card"] = gaps(out, off)
        res["by_draws"].append(row)
    res["max_loss_abs_err"] = max(max(r["loss_abs_err"].values())
                                  for r in res["by_draws"])
    res["max_mu_err_over_max_mu"] = max(max(r["mu_err_over_max_mu"].values())
                                        for r in res["by_draws"])
    res["k3_launches"] = min(r["k3_launches"] for r in res["by_draws"])
    if f64_witness:
        res["g_loss_vs_f64"] = {
            who: max(r[f"g_loss_{who}_vs_f64"] for r in res["by_draws"])
            for who in ("card", "cpu")}
        res["g_loss_vs_f64"]["limit"] = (
            F64_G_LOSS[0] * res["g_loss_vs_f64"]["cpu"] + F64_G_LOSS[1])
    print(name + " card vs cpu " + json.dumps(res), flush=True)
    if f64_witness and not (res["g_loss_vs_f64"]["card"]
                            <= res["g_loss_vs_f64"]["limit"]):
        raise AssertionError(f"f32 g_loss on the card farther from the "
                             f"float64 step than the CPU's allows: "
                             f"{res['g_loss_vs_f64']}")
    for row in res["by_draws"]:
        if fused_attn and not (
                max(row["on_vs_off_on_card"][0].values()) <= 1e-3
                and max(row["on_vs_off_on_card"][1].values()) <= 1e-4):
            raise AssertionError(f"f32 train step, fused attention vs "
                                 f"unfused on the card: "
                                 f"{row['on_vs_off_on_card']}")
        held = {k: v for k, v in row["loss_abs_err"].items()
                if not (f64_witness and k == "g_loss")}
        if not max(held.values()) <= 1e-3:
            raise AssertionError(f"f32 train losses, card vs CPU "
                                 f"({row['draws']}): {row['loss_abs_err']}")
        if not max(row["mu_err_over_max_mu"].values()) <= 1e-3:
            raise AssertionError(f"f32 gradients (Adam mu), card vs CPU "
                                 f"({row['draws']}): "
                                 f"{row['mu_err_over_max_mu']}")
    return res


# the trainer's child runs: the flagship step on the reference's schedule
# (every step logged, samples and checkpoints every 2 steps)
TRAINER_ARGV = FLAGSHIP_ARGV + ["--log_step", "1", "--sample_step", "2",
                                "--model_save_step", "2"]
TRAINER_RUNS = {
    "trainer_A": (TRAINER_ARGV + ["--keep_checkpoints", "2"], 4)}
TRAINER_RESUMES = {   # from A's out_dir as it stood at step 2
    "trainer_B": ("trainer_A", 2, TRAINER_ARGV + ["--keep_checkpoints", "1"],
                  4)}
TRAINER_KEEP = ("trainer_A", "trainer_B")
LOSSES = ("d_loss", "d_loss_s", "d_loss_t", "g_loss")


def state_gaps(x: dict, y: dict) -> dict[str, float]:
    """max |x − y| over each state tree (g/params, g/opt, …, g_ema, step)
    of two flat train states."""
    out: dict[str, float] = {}
    for k, v in x.items():
        parts = k.split("/")
        tree = parts[0] if parts[0] in ("step", "g_ema") else "/".join(
            parts[:2])
        d = np.abs(v.astype(np.float64) - y[k].astype(np.float64))
        out[tree] = max(out.get(tree, 0.0), float(d.max()) if d.size else 0.0)
    return out


def check_trainer_runs(done: dict) -> dict:
    """The trainer's child runs: A (4 steps) and B (resumed at step 2 from
    A's out_dir as it stood then, `out_dir_at`, to 4). Files: A keeps
    checkpoints 2 and 4, B only 4; grid PNGs at steps 2 and 4 with the
    grid's IHDR size; GIFs; the four losses and steps_per_sec in
    scalars.jsonl at every step; B resumed from step 2. Resume: B has A's
    bits in every leaf (A_K, another process, must have them too:
    `check_k_runs`); each state tree's max|B − A| is printed."""
    from dvdgan_tpu_torch.utils.config import parse_config

    cfg = parse_config(TRAINER_ARGV)
    g_cfg = cfg.g_config()
    n_show, pad = min(4, cfg.batch_size), 2
    grid_wh = (g_cfg.n_frames * (g_cfg.img_size + pad) + pad,
               n_show * (g_cfg.img_size + pad) + pad)
    a, b = (done[k] for k in TRAINER_KEEP)
    for name, run, kept in (("A", a, ["2", "4"]), ("B", b, ["4"])):
        out = run["out_dir"]
        got = sorted(os.listdir(os.path.join(out, "checkpoints")))
        if got != kept:
            raise AssertionError(f"trainer run {name}: checkpoints {got}, "
                                 f"want {kept}")
        for s in (2, 4):
            with open(os.path.join(out, "samples", f"{s}_grid.png"),
                      "rb") as f:
                head = f.read(24)
            if (head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR"
                    or struct.unpack(">II", head[16:24]) != grid_wh):
                raise AssertionError(f"trainer run {name}: {s}_grid.png "
                                     f"starts {head!r}, want a PNG of "
                                     f"{grid_wh}")
            for i in range(n_show):
                with open(os.path.join(out, "samples", f"{s}_sample{i}.gif"),
                          "rb") as f:
                    if f.read(6) != b"GIF89a":
                        raise AssertionError(f"trainer run {name}: "
                                             f"{s}_sample{i}.gif")
        tags: dict[int, set] = {}
        with open(os.path.join(out, "logs", "scalars.jsonl")) as f:
            for ln in f:
                r = json.loads(ln)
                tags.setdefault(r["step"], set()).add(r["tag"])
        for s in range(1, 5):
            if not {*LOSSES, "steps_per_sec"} <= tags.get(s, set()):
                raise AssertionError(f"trainer run {name}: scalars at step "
                                     f"{s}: {sorted(tags.get(s, ()))}")
    if "resumed from checkpoint step 2" not in b["stdout"]:
        raise AssertionError("trainer run B did not resume from step 2")
    differ = [k for k, v in b["state"].items()
              if not np.array_equal(v, a["state"][k])]
    res = {"b_resumed_bitwise": not differ, "differ": differ[:20],
           "max_abs_b_resumed": state_gaps(b["state"], a["state"])}
    print("trainer runs " + json.dumps(res), flush=True)
    if differ:
        raise AssertionError(f"the resumed B differs from A in "
                             f"{len(differ)} leaves: {differ[:20]}")
    for k in TRAINER_KEEP:
        done[k]["tmp"].cleanup()
        del done[k]["state"]
    return res


def check_draws(device) -> None:
    """The z and frame-index draws of steps 2 and 3 on the card: the same
    from a run that made steps 0 and 1's first and from a fresh start after
    other draws of the default generator (a resume)."""
    from dvdgan_tpu_torch.train import step
    from dvdgan_tpu_torch.utils.config import parse_config

    cfg = parse_config(FLAGSHIP_ARGV)
    g_cfg, ds_cfg, n = cfg.g_config(), cfg.ds_config(), cfg.d_steps

    def draws(s):
        d = step.TorchDraws(cfg.seed, s, cfg.batch_size, g_cfg.z_dim,
                            g_cfg.n_frames, ds_cfg.k_frames, torch.bfloat16,
                            device)
        # the train step's order: the D phase's z, its indices, then G's
        out = [d.z(3 * i) for i in range(n)]
        out += [d.idx(3 * i + j) for i in range(n) for j in (1, 2)]
        return out + [d.z(3 * n), d.idx(3 * n + 1)]

    fresh = [draws(s) for s in range(4)][2:]
    torch.randn(1000, device=device)
    resumed = [draws(s) for s in (2, 3)]
    if not all(torch.equal(x, y) for f, r in zip(fresh, resumed)
               for x, y in zip(f, r)):
        raise AssertionError("the draws of steps 2 and 3 differ between a "
                             "fresh and a resumed TorchDraws")
    print(f"draws of steps 2 and 3: {sum(map(len, fresh))} tensors the same "
          f"fresh and resumed", flush=True)


def profile_busy_us(fn) -> tuple[float, float]:
    """(device kernel µs, wall µs) of fn() under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # the device's activity alone: its kernels are all that is read, and
    # the host ops' trace took longer to read than the steps to run
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    return busy, wall_us


def time_checkpoint(state: dict, ckpt_dir: str, step: int) -> dict:
    """`AsyncSaver` on a state on the card, twice (the second reuses the
    pinned buffers): the snapshot's ms on the caller's thread, the write's
    s on the background thread, the file's bytes; and the state restored on
    the card from the file, leaf for leaf against the state."""
    from dvdgan_tpu_torch import interop
    from dvdgan_tpu_torch.train import checkpoint as ckpt

    saver, rows = ckpt.AsyncSaver(), []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saver.save(ckpt_dir, step + i, state, max_to_keep=1)
        t1 = time.perf_counter()
        saver.wait()
        rows.append(((t1 - t0) * 1e3, time.perf_counter() - t1))
    path = os.path.join(ckpt_dir, str(step + 1), ckpt.STATE_FILE)
    back = ckpt.restore(ckpt_dir, step + 1, state)
    want = interop.train_state_paths(state)
    same = all(torch.equal(v, want[k]) and v.device == want[k].device
               for k, v in interop.train_state_paths(back).items())
    del back
    return {"snapshot_ms": [r[0] for r in rows],
            "write_s": [r[1] for r in rows], "file_bytes":
            os.path.getsize(path), "state_bytes": sum(
                v.numel() * v.element_size() for v in want.values()),
            "round_trip_bitwise": same}


def time_checkpoints(device) -> dict:
    """The syncs of one bare flagship step (torch.cuda sync debug
    warnings; the trainer's, at K 1 and K, are `time_steps_per_call`'s),
    and the checkpoint's snapshot, write and round trip for the flagship
    state and for the kinetics_256_48f state."""
    import warnings

    from dvdgan_tpu_torch.train import state as train_state
    from dvdgan_tpu_torch.train import step
    from dvdgan_tpu_torch.utils.config import parse_config

    def state_of(cfg):
        return train_state.to_device(train_state.create(
            cfg.seed, cfg.g_config(), cfg.ds_config(), cfg.dt_config()),
            device)

    cfg = parse_config(FLAGSHIP_ARGV)
    g_cfg, ds_cfg = cfg.g_config(), cfg.ds_config()
    state = state_of(cfg)
    draws = step.TorchDraws(cfg.seed, 0, cfg.batch_size, g_cfg.z_dim,
                            g_cfg.n_frames, ds_cfg.k_frames, torch.bfloat16,
                            device)
    real = torch.zeros(cfg.batch_size, g_cfg.n_frames, cfg.img_size,
                       cfg.img_size, 3, device=device, dtype=torch.bfloat16)
    y = torch.zeros(cfg.batch_size, dtype=torch.long, device=device)
    step.train_step(state, real, y, draws, g_cfg, ds_cfg, cfg.dt_config(),
                    cfg.train_config())         # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as step_w:
            warnings.simplefilter("always")
            state, _ = step.train_step(state, real, y, draws, g_cfg, ds_cfg,
                                       cfg.dt_config(), cfg.train_config())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with tempfile.TemporaryDirectory() as tmp:
        flag_ckpt = time_checkpoint(state, os.path.join(tmp, "ck"), 2)
        del state
        state = state_of(parse_config(LONG_ARGV))
        long_ckpt = time_checkpoint(state, os.path.join(tmp, "lk"), 0)
        del state
    torch.cuda.empty_cache()
    out = {"syncs_in_one_bare_step": len(step_w),
           "sync_sites": sorted({str(w.message)[:120] for w in step_w})[:8],
           "checkpoint_flagship": flag_ckpt,
           "checkpoint_kinetics_256_48f": long_ckpt}
    print("checkpoints " + json.dumps(out), flush=True)
    for name, row in (("flagship", flag_ckpt),
                      ("kinetics_256_48f", long_ckpt)):
        if not row["round_trip_bitwise"]:
            raise AssertionError(f"the {name} state restored on the card "
                                 f"differs from the state saved")
    return out


def graph_replay(name: str, fn, wrapper) -> dict:
    """One kernel's wrapper call `fn()` on fixed inputs: eagerly, then
    captured into a CUDA graph (after a warm-up call on a side stream, as
    `torch.cuda.graphs` asks) and replayed twice, its outputs filled with
    NaN before each replay. Each replay must give the eager call's bits;
    the wrapper's counter (`wrapper.launches`) moves by the eager call's
    launches during the capture and not at all in a replay."""
    def outs():
        o = fn()
        return list(o) if isinstance(o, (tuple, list)) else [o]

    n0 = wrapper.launches
    eager = [o.clone() for o in outs()]
    n_eager = wrapper.launches - n0
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        outs()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n0 = wrapper.launches
    with torch.cuda.graph(graph):
        captured = outs()
    n_captured = wrapper.launches - n0
    same = []
    for _ in range(2):
        for o in captured:
            o.fill_(float("nan"))
        n0 = wrapper.launches
        graph.replay()
        torch.cuda.synchronize()
        if wrapper.launches != n0:
            raise AssertionError(f"{name}: a replay moved the launch count")
        same.append(all(torch.equal(o, e) for o, e in zip(captured, eager)))
    row = {"kernel": name, "launches_eager": n_eager,
           "launches_captured": n_captured, "replays_bitwise": same,
           "replay_ms": cuda_ms(graph.replay, reps=5, warmup=1),
           "eager_ms": cuda_ms(fn, reps=5, warmup=1)}
    print("graph_replay " + json.dumps(row), flush=True)
    if n_captured != n_eager or not all(same):
        raise AssertionError(f"{name} replayed from a CUDA graph differs "
                             f"from its eager call: {row}")
    del graph
    return row


def check_graphs(device) -> dict[str, dict]:
    """Each kernel captured in a CUDA graph and replayed (`graph_replay`)
    at one shape of a driven path, bf16: K1 and K4 (its cluster form) at
    the flagship's 4²×256 level (B 16, T 16 for K1), K2 there at B 8, K3
    at the long clip's 64²×128 plane (T 48, B 2), K5a/K5b at the flagship's
    8²→16² level (N 128, 256→128), K6a at (128, 32², 64), K6b at (96, 64²,
    64); and K6 at each shape of K6_DOMAIN_SHAPES."""
    from dvdgan_tpu_torch.kernels import attention_spatial as k6
    from dvdgan_tpu_torch.kernels import convgru_blocked as k3
    from dvdgan_tpu_torch.kernels import convgru_bwd as k2
    from dvdgan_tpu_torch.kernels import convgru_cell as k4
    from dvdgan_tpu_torch.kernels import convgru_seq as k1
    from dvdgan_tpu_torch.kernels import ups2x_fused as k5
    bf16 = torch.bfloat16
    rows = {}
    a1 = k1_inputs(4, 4, 256, bf16, device, seed=90)
    rows["K1"] = graph_replay("K1", lambda: k1.gru_sequence_fused(*a1),
                              k1.gru_sequence_fused)
    a2 = k1_inputs(4, 4, 256, bf16, device, seed=91, b=B_TRAIN)
    hs = k1.gru_sequence_fused(*a2)
    g2 = torch.randn(hs.shape, generator=torch.Generator().manual_seed(92)
                     ).to(device, bf16)
    rows["K2"] = graph_replay("K2", lambda: k2.gru_sequence_bwd(*a2, hs, g2),
                              k2.gru_sequence_bwd)
    a3 = k1_inputs(64, 64, 128, bf16, device, seed=93, b=LONG_B, t=LONG_T)
    rows["K3"] = graph_replay("K3", lambda: k3.gru_sequence_blocked(*a3),
                              k3.gru_sequence_blocked)
    gx, cx, h0, wg, wc = k1_inputs(4, 4, 256, bf16, device, seed=94, t=1)
    if k4.plan(bf16, B, 4, 4, 256) is None:
        raise AssertionError("K4 takes no cluster launch at 4x4x256")
    rows["K4"] = graph_replay(
        "K4", lambda: k4.gru_cell_fused(gx[0], cx[0], h0, wg, wc),
        k4.gru_cell_fused)
    wall, xp, g5 = k5_inputs(T * B_TRAIN, 8, 8, 256, 128, bf16, device, 95)
    rows["K5a"] = graph_replay("K5a", lambda: k5.ups2x(wall, xp), k5.ups2x)
    rows["K5b"] = graph_replay("K5b", lambda: k5.ups2x_bwd(wall, xp, g5),
                               k5.ups2x_bwd)
    a6 = k6_inputs(128, 32, 32, 64, bf16, device, 96)
    rows["K6a"] = graph_replay("K6a", lambda: k6.spatial_attn_fused(*a6),
                               k6.spatial_attn_fused)
    a6b = k6_inputs(96, 64, 64, 64, bf16, device, 97)
    rows["K6b"] = graph_replay("K6b", lambda: k6.spatial_attn_tiled(*a6b),
                               k6.spatial_attn_tiled)
    from dvdgan_tpu_torch.ops import attention
    for group, shapes in K6_DOMAIN_SHAPES.items():
        for i, (n, h, w, c) in enumerate(shapes):
            a = k6_inputs(n, h, w, c, bf16, device, 98 + i)
            entry = (k6.spatial_attn_tiled if attention.uses_tiled(h, w)
                     else k6.spatial_attn_fused)
            name = f"{group} {h}x{w}x{c}"
            rows[name] = graph_replay(name, lambda: entry(*a), entry)
    return rows


# the trainer's child runs under --steps_per_call 2 (one CUDA graph of two
# steps a call): A_K, A's 4 steps with logs, samples and checkpoints at 2
# and 4; B_K, resumed at 2 from A_K's out_dir as it stood then, to 4. Each
# must have A's bits
TRAINER_ARGV_K = FLAGSHIP_ARGV + ["--log_step", "2", "--sample_step", "2",
                                  "--model_save_step", "2",
                                  "--steps_per_call", "2"]
TRAINER_RUNS_K = {
    "trainer_AK": (TRAINER_ARGV_K + ["--keep_checkpoints", "2"], 4)}
TRAINER_RESUMES_K = {
    "trainer_BK": ("trainer_AK", 2, TRAINER_ARGV_K + ["--keep_checkpoints",
                                                       "1"], 4)}
# the flagship on frame folders (.npy uint8 clips the script writes): 3
# classes of 4 clips, 20 to 23 frames of 72×88 (so that the window, the
# center crop and the resize all run, and epochs wrap), at K 1 and K 2
FRAMES_SHAPE = dict(n_classes=3, n_videos=4, t0=20, h=72, w=88)
FRAMES_ARGV = [*FLAGSHIP_ARGV, "--dataset", "frames", "--n_classes", "3"]
FRAMES_STEPS = 4
# the loader alone at UCF-101's published frame size (320×240) and about
# its mean clip length (7.2 s at 25 fps): 2 classes of 8 clips, 180 to 187
# frames (41.5 MB a clip as uint8 .npy), 2 batches of 8 an epoch
UCF_SHAPE = dict(n_classes=2, n_videos=8, t0=180, h=240, w=320)


def write_frames(root: str, n_classes: int, n_videos: int, t0: int, h: int,
                 w: int) -> str:
    """root/class_<c>/video_<v>.npy: uint8 (t0 + v, h, w, 3) clips from a
    seeded generator."""
    rng = np.random.default_rng(0)
    for c in range(n_classes):
        os.makedirs(os.path.join(root, f"class_{c}"))
        for v in range(n_videos):
            np.save(os.path.join(root, f"class_{c}", f"video_{v}.npy"),
                    rng.integers(0, 256, (t0 + v, h, w, 3), dtype=np.uint8))
    return root


def time_frames_loader(n_batches: int = 12, k: int = 4) -> dict:
    """The frame-folder loader as the trainer builds it (flagship clips,
    batch 8, its threads and prefetch) on `.npy` clips of UCF_SHAPE that it
    writes to a temporary directory (read back from the page cache: the
    files were just written): host ms per batch over `n_batches` after one,
    and per call of `k` steps; the ms to read one clip whole (`np.load`)
    and one window of the flagship's frames (`np.load(mmap_mode="r")`, the
    dataset's read), over the folder's clips; which clip path ran
    (`native.available()`)."""
    from dvdgan_tpu_torch import native
    from dvdgan_tpu_torch.data import FrameFolderDataset, Loader
    from dvdgan_tpu_torch.utils.config import parse_config

    with tempfile.TemporaryDirectory() as tmp:
        root = write_frames(os.path.join(tmp, "data"), **UCF_SHAPE)
        cfg = parse_config(FRAMES_ARGV + ["--data_path", root,
                                          "--n_classes",
                                          str(UCF_SHAPE["n_classes"])])
        ds = FrameFolderDataset(root, cfg.n_frames, cfg.img_size,
                                seed=cfg.seed)
        loader = Loader(ds, cfg.batch_size, seed=cfg.seed,
                        num_threads=cfg.loader_threads, prefetch=cfg.prefetch)
        data = loader.forever()
        try:
            clip, _ = next(data)
            t0 = time.perf_counter()
            for _ in range(n_batches):
                next(data)
            ms = (time.perf_counter() - t0) / n_batches * 1e3
        finally:
            data.close()
            loader.close()
        paths = [p for p, _ in ds.items]
        read_ms = {}
        for kind in ("whole", "window"):
            t0 = time.perf_counter()
            for p in paths:
                if kind == "whole":
                    np.load(p)
                else:
                    np.array(np.load(p, mmap_mode="r")[:cfg.n_frames])
            read_ms[kind] = (time.perf_counter() - t0) / len(paths) * 1e3
        clip_bytes = os.path.getsize(paths[0])
    frame_bytes = UCF_SHAPE["h"] * UCF_SHAPE["w"] * 3
    out = {"native_available": native.available(), "ms_per_batch": ms,
           f"ms_per_call_of_{k}": k * ms, "read_ms_per_clip": read_ms,
           "clip_bytes": clip_bytes,
           "window_bytes_per_batch": cfg.batch_size * cfg.n_frames
           * frame_bytes, "clip_shape": [UCF_SHAPE["t0"], UCF_SHAPE["h"],
                                         UCF_SHAPE["w"], 3],
           "batch_shape": list(clip.shape), "items": len(ds),
           "loader_threads": cfg.loader_threads, "prefetch": cfg.prefetch}
    print("frames_loader " + json.dumps(out), flush=True)
    if clip.shape != (cfg.batch_size, cfg.n_frames, cfg.img_size,
                      cfg.img_size, 3) or not np.isfinite(clip).all():
        raise AssertionError(f"frames loader batch {clip.shape}")
    return out


def check_k_runs(done: dict) -> dict:
    """A_K and B_K (resumed at 2) against A, and the frames and FP runs at
    K 2 against K 1: the same bits in every leaf (the differing leaves named);
    A_K keeps checkpoints 2 and 4, wrote grids at 2 and 4 and captured its
    graph; B_K resumed from step 2."""
    a = done["trainer_A"]["state"]
    res = {}
    for name, ref, got in (("A_K", a, done["trainer_AK"]),
                           ("B_K", a, done["trainer_BK"]),
                           ("frames_K2", done["frames_k1"]["state"],
                            done["frames_k2"]),
                           ("fp_K2", done["fp_k1"]["state"],
                            done["fp_k2"])):
        differ = [k for k, v in ref.items()
                  if not np.array_equal(v, got["state"][k])]
        res[name] = {"leaves": len(ref), "differ": differ[:20],
                     "n_differ": len(differ)}
        if "captured 2 train steps into one CUDA graph" not in got["stdout"]:
            raise AssertionError(f"{name}: no CUDA graph was captured")
    out = done["trainer_AK"]["out_dir"]
    if sorted(os.listdir(os.path.join(out, "checkpoints"))) != ["2", "4"]:
        raise AssertionError("trainer run A_K: checkpoints "
                             f"{os.listdir(os.path.join(out, 'checkpoints'))}")
    for s in (2, 4):
        if not os.path.exists(os.path.join(out, "samples", f"{s}_grid.png")):
            raise AssertionError(f"trainer run A_K: no {s}_grid.png")
    if "resumed from checkpoint step 2" not in done["trainer_BK"]["stdout"]:
        raise AssertionError("trainer run B_K's second leg did not resume "
                             "from step 2")
    print("steps_per_call runs " + json.dumps(res), flush=True)
    bad = {k: v for k, v in res.items() if v["n_differ"]}
    if bad:
        raise AssertionError(f"runs under --steps_per_call 2 differ from "
                             f"their single-step runs: {bad}")
    for k in ("trainer_AK", "trainer_BK", "frames_k1", "frames_k2", "fp_k1",
              "fp_k2"):
        done[k]["tmp"].cleanup()
        del done[k]["state"]
    return res


def time_steps_per_call(device, argv, k: int, n_steps: int,
                        name: str) -> dict:
    """One configuration through `Trainer.train()` in this process at
    steps_per_call 1 and k, synthetic clips, log_step k, no save or dump:
    one trainer warmed up over k steps at 1, then k at k (the capture of
    its graph: the one-time cost), then `n_steps`-step readings in turns
    1, k (host clock around train(), which waits for its last step). Per
    mode: ms a step; the device time a step (the graph's replay in CUDA
    events, and torch.profiler's kernel time over one call at k: the same
    work at either K) and the idle share against the turns' step time;
    the syncs of a train() of k steps (`torch.cuda.set_sync_debug_mode`);
    and the peak device memory by the end of its warm-up above what was
    allocated before the trainer was built (at k: with the graph's pool
    and the state buffers)."""
    import warnings

    from dvdgan_tpu_torch.train.trainer import Trainer
    from dvdgan_tpu_torch.utils.config import parse_config

    t_in = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    rows, tr = {}, None
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(parse_config(argv + [
            "--steps_per_call", str(k), "--log_step", str(k),
            "--sample_step", "0", "--model_save_step", "0",
            "--out_dir", tmp.name]))
        for kk in (1, k):
            tr.steps_per_call = kk
            t0 = time.perf_counter()
            tr.train(total_step=tr.start_step + k)
            rows[kk] = {"steps_per_call": kk,
                        "warmup_s": time.perf_counter() - t0,
                        "capture_s": tr._multi.capture_s if kk > 1 else None,
                        "peak_mem_gib": (torch.cuda.max_memory_allocated()
                                         - base) / 2**30}
        turns = []
        for kk in (1, k):
            tr.steps_per_call = kk
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train(total_step=tr.start_step + n_steps)
            turns.append((kk, (time.perf_counter() - t0) / n_steps * 1e3))
        for kk, row in rows.items():
            row["ms_per_step"] = [ms for x, ms in turns if x == kk]
            tr.steps_per_call = kk
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    tr.train(total_step=tr.start_step + k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            # per train() call: its log step waits on one event, and the
            # return value's reads come after the loop
            row[f"syncs_in_{k}_steps"] = len(caught)
            row["sync_sites"] = sorted({str(w.message)[:100]
                                        for w in caught})[:4]
        # the device's work a step, the same at either K: the graph's
        # replay in CUDA events, and torch.profiler over one call (its
        # trace takes far longer to read than the steps take to run)
        device_ms = cuda_ms(tr._multi.graph.replay, reps=3, warmup=1) / k
        busy_us, _ = profile_busy_us(lambda: tr.train(
            total_step=tr.start_step + k))
        rows[k]["device_ms_per_step_profiler"] = busy_us / k / 1e3
        for kk, row in rows.items():
            row["device_ms_per_step"] = device_ms
            row["device_idle_share"] = (
                1.0 - device_ms / statistics.mean(row["ms_per_step"]))
    finally:
        if tr is not None:
            tr.close()
        tr = None
        tmp.cleanup()
        torch.cuda.empty_cache()
    out = {"name": name, "turns_ms_per_step": turns,
           "rows": [rows[1], rows[k]], "seconds": time.perf_counter() - t_in}
    print(f"{name} " + json.dumps(out), flush=True)
    return out


# ------------------------------------------------------------- evaluation
# --mode eval at the flagship's widths, 64 clips in batches of 16
# (the reference's evaluate_generator batch), with each IS protocol; the
# first run writes the real side's features to --real_stats and a second
# run reads them; and the prediction protocol at FP's kinetics_64, 32 clips
EVAL_ARGV = ["--mode", "eval", "--preset", "ucf101_64", "--dataset",
             "synthetic", "--n_samples", "64", "--batch_size", "16"]
EVAL_FP_ARGV = ["--mode", "eval", *FP_PRESET, "--n_samples", "32",
                "--batch_size", "16"]
EVAL_BATCH = 16         # evaluate_generator's default, as main.py calls it
# the keys of the reference's --mode eval line (main.py)
EVAL_KEYS = {"fvd", "fid", "is_mean", "is_std", "extractor",
             "fvd_published_comparable", "is_classifier",
             "is_published_comparable", "frame_extractor",
             "fid_published_comparable"}
# the in-training evaluation: the trainer's run A (and A_K) with
# --eval_step 2 over its 4 steps, which must leave A's bits; each started
# as a long-clip child ends, for the card's memory
EVAL_TRAIN = ["--eval_step", "2", "--eval_samples", "16"]
EVAL_AFTER = {
    "eval_k1": ("longclip", None, TRAINER_ARGV + ["--keep_checkpoints", "2",
                                                  *EVAL_TRAIN], 4),
    "eval_k2": ("longclip_fused", None, TRAINER_ARGV_K + [
        "--keep_checkpoints", "2", *EVAL_TRAIN], 4)}
# the scoring networks card vs CPU: max |card − CPU| ≤ EXTRACTOR_TOL ×
# max |CPU| per output, TF32 off on both. cuDNN and the CPU sum in other
# orders through up to ~95 conv layers: ≤ 2.7e-6 of the scale on the H100;
# TF32 on moves the outputs 7.5e-4–9.1e-4 of it, and each case must fail
# the limit with TF32 on, so that the check sees a broken `exact_f32`
EXTRACTOR_TOL = 1e-4
EXTRACTOR_CASES = (     # (network, feature, clips or frames, side, resize)
    ("i3d", "logits", (2, 16), 64, 224),
    ("i3d", "avgpool", (2, 16), 64, 224),
    ("inception", "pool", (32,), 64, 299),
    ("c3d", "logits", (2, 16), 64, 112),
    ("c3d", "logits", (2, 16), 128, 112),     # the antialiased shrink
)
# a batch of 16 clips of 16 frames at 64², as --mode eval gives each
# network: I3D and C3D the clips, Inception-v3 their 256 frames
EXTRACTOR_BATCHES = (("i3d", "logits", (16, 16)),
                     ("inception", "pool", (256,)),
                     ("c3d", "logits", (16, 16)))


def move_off_init(params: dict, gen: torch.Generator) -> dict:
    """Every BN mean, var, scale and offset and every bias of a scoring
    network's params moved off its init (drawn from `gen`), so that eps
    and the order of the BN arithmetic show. Also used by the GPU tests."""
    for k, v in params.items():
        if k.endswith("/bn/mean"):
            v.normal_(0, 0.2, generator=gen)
        elif k.endswith("/bn/var"):
            v.uniform_(0.25, 1.75, generator=gen)
        elif k.endswith("/bn/scale"):
            v.uniform_(0.5, 1.5, generator=gen)
        elif k.endswith(("/bn/offset", "/b")):
            v.normal_(0, 0.05, generator=gen)
    return params


def eval_nets(seed: int = 0) -> dict[str, dict]:
    """I3D, Inception-v3 and C3D params (CPU) from one torch.Generator,
    moved off their init (`move_off_init`)."""
    from dvdgan_tpu_torch.eval import c3d, i3d, inception
    gen = torch.Generator().manual_seed(seed)
    nets = {"i3d": i3d.init(gen), "inception": inception.init(gen),
            "c3d": c3d.init(gen)}
    for params in nets.values():
        move_off_init(params, gen)
    return nets


def eval_apply(name: str):
    from dvdgan_tpu_torch.eval import c3d, i3d, inception
    return {"i3d": i3d, "inception": inception, "c3d": c3d}[name].apply


def check_extractors(device, nets: dict) -> list[dict]:
    """Each scoring network at its protocol's input size and width on 2
    clips (Inception-v3: their 32 frames), on the card and on the CPU
    from the same params and inputs, TF32 off on both (`exact_f32`); then
    the card's output with TF32 on, which must fail the same limit (the
    check would catch TF32 left on)."""
    from dvdgan_tpu_torch.eval import layers
    rows = []
    for i, (name, feature, lead, side, resize) in enumerate(EXTRACTOR_CASES):
        x = torch.from_numpy(np.random.RandomState(i).uniform(
            -1, 1, (*lead, side, side, 3)).astype(np.float32))
        apply = eval_apply(name)
        card = {k: v.to(device) for k, v in nets[name].items()}
        with layers.exact_f32():
            got = apply(card, x.to(device), feature, resize).cpu()
            ref = apply(nets[name], x, feature, resize)
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
            tf32 = apply(card, x.to(device), feature, resize).cpu()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        err_tf32 = float((tf32 - ref).abs().max())
        row = {"network": name, "feature": feature,
               "input": [*lead, side, side, 3], "resize": resize,
               "shape": list(got.shape), "max_abs_err": err,
               "max_abs_cpu": scale, "rel_err": err / scale,
               "rel_err_tf32_on": err_tf32 / scale, "limit": EXTRACTOR_TOL}
        print("extractor card vs cpu " + json.dumps(row), flush=True)
        if not (torch.isfinite(got).all() and err <= EXTRACTOR_TOL * scale):
            raise AssertionError(f"{name} {feature}: card vs CPU {err} > "
                                 f"{EXTRACTOR_TOL} × {scale}")
        if err_tf32 <= EXTRACTOR_TOL * scale:
            raise AssertionError(f"{name} {feature}: TF32 on passes the "
                                 f"limit ({err_tf32} ≤ {EXTRACTOR_TOL} × "
                                 f"{scale}), which then cannot see it")
        rows.append(row)
    return rows


def time_extractors(device, nets: dict) -> list[dict]:
    """Each network on a batch of 16 clips (16 frames at 64², resized to
    its protocol's size): CUDA-event ms (median of 5 after 1 warm-up),
    with TF32 off (the extractors' setting) and then on (one pair, to
    price the exact f32), the outputs' gap between the two, and the peak
    device memory of the call above what was allocated before it."""
    from dvdgan_tpu_torch.eval import layers
    rows = []
    for name, feature, lead in EXTRACTOR_BATCHES:
        apply = eval_apply(name)
        params = {k: v.to(device) for k, v in nets[name].items()}
        x = torch.from_numpy(np.random.RandomState(7).uniform(
            -1, 1, (*lead, 64, 64, 3)).astype(np.float32)).to(device)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with layers.exact_f32():
            off = apply(params, x, feature)
            ms_off = cuda_ms(lambda: apply(params, x, feature), 5, 1)
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
            on = apply(params, x, feature)
            ms_on = cuda_ms(lambda: apply(params, x, feature), 5, 1)
        row = {"network": name, "feature": feature, "batch": list(lead),
               "ms": ms_off, "ms_tf32_on": ms_on,
               "tf32_rel_gap": float((on - off).abs().max()
                                     / off.abs().max()),
               "peak_mem_gib": peak}
        print("extractor batch of 16 clips " + json.dumps(row), flush=True)
        rows.append(row)
        del params, x, off, on
    torch.cuda.empty_cache()
    return rows


def eval_k1_per_batch(cfg) -> int:
    """K1 launches of one EMA-G sample batch of `cfg`."""
    return sample_launches(cfg.g_config())["k1"]


def start_eval(argv, out_dir: str) -> dict:
    proc = subprocess.Popen(
        [sys.executable, "-m", "dvdgan_tpu_torch", *argv, "--out_dir",
         out_dir], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return {"proc": proc, "argv": argv, "t0": time.perf_counter()}


def finish_eval(run: dict) -> dict:
    """Waits for a `start_eval` child and checks its result line: every
    key of the reference's, finite fvd and fid ≥ 0, 1 ≤ is_mean ≤ the IS
    classifier's class count, every network labelled not
    published-comparable (random init), K1 launched as often as the
    fakes' batches need and no other kernel."""
    from dvdgan_tpu_torch.train.trainer import build_dataset
    from dvdgan_tpu_torch.utils.config import parse_config
    proc = run["proc"]
    try:
        stdout, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    secs = time.perf_counter() - run["t0"]
    print(stdout, end="", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"eval CLI exited {proc.returncode}:\n"
                             f"{stderr[-4000:]}")
    lines = stdout.strip().splitlines()

    def tagged(tag):
        return json.loads(next(ln for ln in lines
                               if ln.startswith(tag + " "))[len(tag) + 1:])

    out, launches, timing = json.loads(lines[-1]), tagged("eval_launches"), \
        tagged("eval_time")
    cfg = parse_config(run["argv"])
    classes = 101 if cfg.is_protocol == "c3d" else 400
    missing = EVAL_KEYS - set(out)
    if missing:
        raise AssertionError(f"eval result lacks {sorted(missing)}: {out}")
    if not all(np.isfinite(out[k]) and out[k] >= 0 for k in ("fvd", "fid")):
        raise AssertionError(f"eval fvd / fid: {out}")
    if not 1.0 <= out["is_mean"] <= classes:
        raise AssertionError(f"eval is_mean {out['is_mean']} outside "
                             f"[1, {classes}]")
    if any(out[k] for k in ("fvd_published_comparable",
                            "is_published_comparable",
                            "fid_published_comparable")):
        raise AssertionError(f"random-init networks labelled comparable: "
                             f"{out}")
    n = min(cfg.n_samples, len(build_dataset(cfg)))
    batches = -(-n // EVAL_BATCH)
    want = {k: 0 for k in launches}
    want["k1"] = batches * eval_k1_per_batch(cfg)
    if launches != want:
        raise AssertionError(f"eval launches {launches}, want {want}")
    return {"result": out, "launches": launches,
            "k1_per_batch": launches["k1"] // batches, "time": timing,
            "cli_s": secs}


def check_repeat_eval(device) -> dict:
    """`Trainer.evaluate()` twice in this process (ucf101_64, bf16, 32
    clips, the default I3D): the same fvd bitwise (bf16 G steps and the
    extractor's deterministic f32 convs repeat on this card)."""
    from dvdgan_tpu_torch.train.trainer import Trainer
    from dvdgan_tpu_torch.utils.config import parse_config
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(parse_config(EVAL_ARGV + ["--out_dir", tmp]))
        try:
            runs = [tr.evaluate(n_samples=32) for _ in range(2)]
        finally:
            tr.close()
    res = {"runs": runs, "same_bits": runs[0] == runs[1]}
    print("evaluate twice " + json.dumps(res), flush=True)
    if not res["same_bits"]:
        raise AssertionError(f"Trainer.evaluate() gave {runs}")
    del tr
    torch.cuda.empty_cache()
    return res


def drive_eval(device) -> dict:
    """--mode eval children: the ucf101_64 run with --is_protocol i3d
    (writing --real_stats), with c3d, and the FP protocol side by side,
    then the i3d run again as the first ends, reading the stats (the same
    fvd bitwise). Meanwhile this process holds the networks to the CPU and
    repeats `Trainer.evaluate()`; once the children have ended it times
    the networks on the card alone."""
    torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory()
    stats = os.path.join(tmp.name, "real_stats.npz")

    def out(name):
        return os.path.join(tmp.name, name)

    i3d_argv = EVAL_ARGV + ["--real_stats", stats]
    runs = {"i3d": start_eval(i3d_argv, out("i3d")),
            "c3d": start_eval(EVAL_ARGV + ["--is_protocol", "c3d"],
                              out("c3d")),
            "fp": start_eval(EVAL_FP_ARGV, out("fp"))}
    done = {}
    try:
        nets = eval_nets()
        extractors = check_extractors(device, nets)
        repeat = check_repeat_eval(device)
        done["i3d"] = finish_eval(runs["i3d"])
        if not os.path.isfile(stats):
            raise AssertionError(f"the i3d eval run wrote no {stats}")
        runs["i3d_cached"] = start_eval(i3d_argv, out("i3d_cached"))
        for name in ("c3d", "fp", "i3d_cached"):
            done[name] = finish_eval(runs[name])
    finally:
        for run in runs.values():
            if run["proc"].poll() is None:
                run["proc"].kill()
                run["proc"].communicate()
        tmp.cleanup()
    first, again = done["i3d"]["result"], done["i3d_cached"]["result"]
    print("eval runs " + json.dumps(done), flush=True)
    for name, d in done.items():
        t = d["time"]
        print(f"eval {name}: {d['cli_s']:.1f} s in all, evaluation "
              f"{t['eval_s']:.2f} s of which sampling {t['sample_s']:.2f} s "
              f"({t['sample_s'] / t['eval_s']:.3f}), peak device memory "
              f"{t['peak_mem_gib']:.3f} GiB", flush=True)
    if again["fvd"] != first["fvd"]:
        raise AssertionError(f"the run that read --real_stats gave fvd "
                             f"{again['fvd']}, the one that wrote it "
                             f"{first['fvd']}")
    timed = time_extractors(device, nets)
    return {**done, "extractors": extractors, "timed": timed,
            "repeat": repeat}


def check_eval_runs(done: dict) -> dict:
    """The in-training evaluations: fvd, is_mean and is_std in the scalars
    at steps 2 and 4 and an `eval @` line for each, and the final state
    with A's bits in every leaf (at K 1, and at K 2 where A_K has them)."""
    a = done["trainer_A"]["state"]
    res = {}
    for name in EVAL_AFTER:
        run = done[name]
        with open(os.path.join(run["out_dir"], "logs", "scalars.jsonl")) as f:
            rows = [json.loads(ln) for ln in f]
        fvd = {r["step"]: r["value"] for r in rows if r["tag"] == "fvd"}
        tags = {r["tag"] for r in rows if r["step"] == 4}
        differ = [k for k, v in a.items()
                  if not np.array_equal(v, run["state"][k])]
        res[name] = {"fvd": fvd, "n_differ": len(differ),
                     "differ": differ[:20]}
        if sorted(fvd) != [2, 4] or not np.isfinite(list(fvd.values())).all() \
                or not {"is_mean", "is_std"} <= tags:
            raise AssertionError(f"{name}: eval scalars {fvd}, {tags}")
        if not all(f"eval @ {s}: fvd " in run["stdout"] for s in (2, 4)):
            raise AssertionError(f"{name}: no eval @ line")
        run["tmp"].cleanup()
        del run["state"]
    print("in-training eval runs " + json.dumps(res), flush=True)
    bad = {k: v for k, v in res.items() if v["n_differ"]}
    if bad:
        raise AssertionError(f"an evaluation moved the training: {bad}")
    return res


# ----------------------------------------------------------- the parallel phase
# Each run is two train CLI processes started as the ranks of one
# `--multihost` run on cuda:0 (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
# MASTER_PORT set as a launcher sets them): two ranks that share one card
# talk over gloo through the host. What they measure is that path, not a
# data-parallel speed-up.
PAR_WORLD = 2
PAR_RUNS = {
    # DP2: the flagship's global batch 8 over 2 data ranks, 4 steps,
    # checkpoints at 2 and 4 (DP2-B resumes from the first)
    "dp2": (FLAGSHIP_ARGV + ["--model_save_step", "2"], 4),
    # CP2: data 1 x time 2, DT time-sharded, G and DS replicated
    "cp2": (FLAGSHIP_ARGV + ["--time_shards", "2"], 2),
    # the f32 steps held to one process (TF32 off, deterministic cuDNN)
    "dp2_f32": (["--mode", "train", "--preset", "ucf101_64", "--dataset",
                 "synthetic", "--batch_size", "4", "--bf16", "0",
                 "--d_steps", "1"], 1),
}
PAR_RUNS["cp2_f32"] = (PAR_RUNS["dp2_f32"][0] + ["--time_shards", "2"], 1)
PAR_AFTER = {   # started as an earlier run ends ({name: (after, step, ...)})
    "dp2_b": ("dp2", 2, PAR_RUNS["dp2"][0], 4),
    # the long clip, where context parallelism is meant
    "cp2_long": ("cp2", None, LONG_ARGV + ["--time_shards", "2"], 2),
}
PAR_F32 = ("dp2_f32", "cp2_f32")
# one process at exact f32 (the step's rank 0 prelude for the f32 runs)
F32_MAIN = ("import sys, torch; "
            "torch.backends.cuda.matmul.allow_tf32 = False; "
            "torch.backends.cudnn.allow_tf32 = False; "
            "torch.backends.cudnn.deterministic = True; "
            "from dvdgan_tpu_torch.cli import main; main(sys.argv[1:])")
# the f32 limits, rank 0 against one process fed the same draws (PERF.md
# §6): losses atol 1e-3; Adam mu (the gradient) within 1e-4 x max|mu| of
# each model. G's under DP, off the init, read 1.5e-5 on the card and
# 4.4e-5 on the CPU at test scale; a planted fault in its cross-replica BN
# (each rank's own moments, or their all-reduce without its backward)
# reads 0.83 and 0.62 there (`tools/torch_parallel_conditioning.py`)
PAR_F32_LOSS_TOL = 1e-3
PAR_F32_MU_TOL = 1e-4


def start_ranks(argv, n_steps: int, tmp=None, first: int = 0,
                world: int = PAR_WORLD, device: str = "cuda:0") -> dict:
    """Starts `world` train CLI processes as the ranks of one --multihost
    run on `device` (`cuda:0`: all on the one card, over gloo; a bare
    `cuda` gives each local rank its own card, over NCCL), stdout and
    stderr to files (a full pipe would stall a rank inside a collective);
    `finish_ranks` waits for them. `tmp`: the out_dir of an earlier run to
    resume, at step `first`. An f32 run (`--bf16 0`) runs with TF32 off
    and deterministic cuDNN (F32_MAIN)."""
    from dvdgan_tpu_torch.parallel.mesh import free_port
    from dvdgan_tpu_torch.utils.config import parse_config

    argv = ["--log_step", "1", "--sample_step", "0", "--model_save_step",
            str(n_steps), *argv, "--total_step", str(n_steps),
            "--multihost", "1", "--device", device]
    cfg = parse_config(argv)
    tmp = tmp or tempfile.TemporaryDirectory()
    logs = tempfile.TemporaryDirectory()
    env = {**os.environ, "WORLD_SIZE": str(world),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    head = ([sys.executable, "-m", "dvdgan_tpu_torch"] if cfg.bf16
            else [sys.executable, "-c", F32_MAIN])
    procs, files = [], []
    for r in range(world):
        out = open(os.path.join(logs.name, f"rank{r}.out"), "w")
        err = open(os.path.join(logs.name, f"rank{r}.err"), "w")
        files += [out, err]
        procs.append(subprocess.Popen(
            [*head, *argv, "--out_dir", tmp.name], cwd=REPO,
            env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
            stdout=out, stderr=err, text=True))
    return {"procs": procs, "files": files, "logs": logs, "tmp": tmp,
            "cfg": cfg, "n_steps": n_steps, "first": first,
            "t0": time.perf_counter()}


def finish_ranks(run: dict, keep: bool = False,
                 expect: str = "gloo", timeout_s: float = 900) -> dict:
    """Waits for a `start_ranks` run; any rank that failed fails it (the
    others are stopped). Checked: the backend line (`expect`, every rank
    of the run), every rank's state digest equal, every rank's kernel
    launches over the run (its last lines) those of `launches_per_step`,
    and the leader's run as `checked_run` checks a train run. ->
    `checked_run`'s result with each rank's launches and peak memory, the
    backend line, the digests, the collectives a step and ms a step."""
    procs = run["procs"]
    world = len(procs)
    deadline = time.perf_counter() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        secs = time.perf_counter() - run["t0"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in run["files"]:
            f.close()
    outs, errs = [], []
    for r in range(world):
        with open(os.path.join(run["logs"].name, f"rank{r}.out")) as f:
            outs.append(f.read())
        with open(os.path.join(run["logs"].name, f"rank{r}.err")) as f:
            errs.append(f.read())
    run["logs"].cleanup()
    for r, out in enumerate(outs):
        print(f"--- rank {r}:\n{out}", end="", flush=True)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        if not keep:
            run["tmp"].cleanup()
        raise AssertionError(
            f"ranks {bad} of the run exited "
            f"{[procs[r].returncode for r in bad]}:\n" + "\n".join(
                f"rank {r} stderr:\n{errs[r][-3000:]}" for r in bad))
    backend = [ln for ln in outs[0].splitlines()
               if ln.startswith("parallel: backend ")]
    digests = [re.findall(r"^rank \d+: state digest (\w+) over (\d+) leaves",
                          out, re.M) for out in outs]
    launched = [re.findall(r"^rank \d+: launches (\{.*\}) over (\d+) steps$",
                           out, re.M) for out in outs]
    res = checked_run(run, outs[0], secs, keep)
    n_run = run["n_steps"] - run["first"]
    by_rank = []
    for r, found in enumerate(launched):
        if not found or int(found[-1][1]) != n_run:
            raise AssertionError(f"rank {r}: launches over {n_run} steps "
                                 f"not printed: {found}")
        counts = json.loads(found[-1][0])
        want = {k[:-len("_launches")]: n_run * n
                for k, n in res["per_step"].items()}
        if counts != want:
            raise AssertionError(f"rank {r}: launches over the run {counts}, "
                                 f"want {want}")
        by_rank.append(counts)
    per_rank_step = [{k: n // max(n_run, 1) for k, n in c.items()}
                     for c in by_rank]
    rates = [parse_step(ln)["steps/s"] for ln in outs[0].splitlines()
             if ln.startswith("step ")]
    comm = [{k: int(v) for k, v in parse_step(ln).items()
             if k.startswith("comm_")}
            for ln in outs[0].splitlines() if ln.startswith("step ")]
    peaks = [[float(ln.split()[3]) for ln in out.splitlines()
              if ln.startswith("peak device memory ")] for out in outs]
    res.update(backend=backend[0] if backend else None,
               launches_by_rank=by_rank,
               launches_per_rank_step=per_rank_step,
               digests=[d[-1] if d else None for d in digests],
               peak_mem_gib_by_rank=[p[0] if p else None for p in peaks],
               comm_per_step=comm[-1] if comm else None,
               # the last interval's rate (the first holds start-up)
               ms_per_step=1e3 / rates[-1] if rates and rates[-1] else None)
    if not (res["backend"] or "").startswith(
            f"parallel: backend {expect} ") or (
            f" {world} ranks," not in res["backend"]):
        raise AssertionError(f"backend line {res['backend']!r}: {world} "
                             f"ranks over {expect} expected")
    if None in res["digests"] or len(set(res["digests"])) != 1:
        raise AssertionError(f"the ranks' state digests differ: "
                             f"{res['digests']}")
    print(f"ranks: peak device memory {res['peak_mem_gib_by_rank']} GiB, "
          f"{res['backend']}", flush=True)
    return res


def parse_step(line: str) -> dict[str, float]:
    from dvdgan_tpu_torch.utils.logging import parse_step_line
    return parse_step_line(line)[1]


def par_f32_reference(device, argv, world: int = PAR_WORLD
                      ) -> tuple[dict, dict]:
    """One f32 step in this process of the run `argv` names, from its
    `--weights` state, at its whole global batch (the loader's first batch,
    as the ranks read it), fed the data ranks' draws (`ShardedDraws`;
    `TorchDraws` with one data rank): TF32 off, deterministic cuDNN.
    -> (flat state, losses)."""
    from dvdgan_tpu_torch import interop
    from dvdgan_tpu_torch.data import Loader
    from dvdgan_tpu_torch.parallel import mesh as pmesh
    from dvdgan_tpu_torch.train import state as train_state
    from dvdgan_tpu_torch.train import step
    from dvdgan_tpu_torch.train.trainer import build_dataset
    from dvdgan_tpu_torch.utils.config import parse_config

    cfg = parse_config(argv)
    g_cfg, ds_cfg, dt_cfg = cfg.g_config(), cfg.ds_config(), cfg.dt_config()
    n_data, _ = pmesh.plan(world, cfg.time_shards, cfg.batch_size,
                           torch.device("cpu"))
    loader = Loader(build_dataset(cfg), cfg.batch_size, seed=cfg.seed,
                    num_threads=1)
    data = loader.forever()
    try:
        clips, labels = next(data)
    finally:
        data.close()
        loader.close()
    draw_args = (cfg.seed, 0, cfg.batch_size, g_cfg.z_dim, g_cfg.n_frames,
                 ds_cfg.k_frames, torch.float32, device)
    draws = (step.ShardedDraws(n_data, *draw_args) if n_data > 1
             else step.TorchDraws(*draw_args))
    state = train_state.to_device(
        interop.load_train_state_npz(cfg.weights), device)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        new, m = step.train_step(
            state, torch.from_numpy(clips).to(device), torch.from_numpy(
                labels).to(device).long(), draws, g_cfg, ds_cfg, dt_cfg,
            cfg.train_config())
    return interop.train_state_to_flat(new), {k: float(v)
                                              for k, v in m.items()}


def check_par_f32(device, name: str, run: dict, argv,
                  world: int = PAR_WORLD, ref=None) -> dict:
    """Rank 0's f32 step (its checkpoint, its scalars) against
    `par_f32_reference` (or `ref`, its result) at the limits PAR_F32_*."""
    ref, losses = ref or par_f32_reference(device, argv, world)
    got = run["state"]
    scalars = {}
    with open(os.path.join(run["out_dir"], "logs", "scalars.jsonl")) as f:
        for ln in f:
            r = json.loads(ln)
            if r["step"] == 1:
                scalars[r["tag"]] = r["value"]
    loss_err = {k: abs(scalars[k] - v) for k, v in losses.items()}
    mu_err = {}
    for m in ("g", "ds", "dt"):
        keys = [k for k in ref if k.startswith(f"{m}/opt/0/mu/")]
        scale = max(float(np.abs(ref[k]).max()) for k in keys)
        mu_err[m] = max(float(np.abs(got[k] - ref[k]).max())
                        for k in keys) / scale
    res = {"losses": losses, "loss_abs_err": loss_err,
           "mu_err_over_max_mu": mu_err, "limits": {
               "loss": PAR_F32_LOSS_TOL, "mu": PAR_F32_MU_TOL}}
    print(f"{name} rank 0 vs one process " + json.dumps(res), flush=True)
    if not max(loss_err.values()) <= PAR_F32_LOSS_TOL:
        raise AssertionError(f"{name}: f32 losses, ranks vs one process: "
                             f"{loss_err}")
    for m, err in mu_err.items():
        if not err <= PAR_F32_MU_TOL:
            raise AssertionError(f"{name}: f32 {m} Adam mu, ranks vs one "
                                 f"process: {err} > {PAR_F32_MU_TOL}")
    return res


def drive_parallel(device) -> dict:
    """The parallel runs (PAR_RUNS, then PAR_AFTER as their runs end,
    through `drive_trains`), two ranks each on cuda:0; meanwhile this
    process holds the flagship f32 step card vs CPU (`check_train_f32`,
    d_steps 1: from the init beside a float64 step, and off it). Checked:
    every run as `finish_ranks` checks it; DP2-B resumed at 2 with DP2's
    bits in every leaf; the f32 runs against one process; the long clip's
    ms a step, each rank's peak memory and launches, and bytes all-reduced
    a step printed."""
    from dvdgan_tpu_torch import interop
    from dvdgan_tpu_torch.train import state as train_state
    from dvdgan_tpu_torch.utils.config import parse_config

    torch.cuda.empty_cache()
    # the f32 runs start off the init (`off_init`), from --weights
    weights = tempfile.TemporaryDirectory()
    path = os.path.join(weights.name, "off_init.npz")
    cfg = parse_config(PAR_RUNS["dp2_f32"][0])
    interop.save_train_state_npz(path, off_init(train_state.create(
        cfg.seed, cfg.g_config(), cfg.ds_config(), cfg.dt_config()),
        cfg.seed + 2))
    runs = {name: (argv + ["--weights", path] if name in PAR_F32 else argv,
                   n) for name, (argv, n) in PAR_RUNS.items()}

    def meanwhile():
        # the flagship f32 step card vs CPU at d_steps 1: from the init
        # five draw sets beside a float64 step, off it three
        check_train_f32(device, "train f32 from the init",
                        draw_seeds=(None, 1, 2, 3, 4), f64_witness=True)
        check_train_f32(device, "train f32 off the init",
                        draw_seeds=(None, 1, 2), start_off_init=True)

    done = {}
    try:
        done = drive_trains(runs, PAR_AFTER, ("dp2", "dp2_b", *PAR_F32),
                            start_ranks, finish_ranks, meanwhile)
        f32 = {name: check_par_f32(device, name, done[name], runs[name][0])
               for name in PAR_F32}
    finally:
        for run in done.values():
            if "tmp" in run:
                run["tmp"].cleanup()
        weights.cleanup()
    a, b = done["dp2"], done["dp2_b"]
    if "resumed from checkpoint step 2" not in b["stdout"]:
        raise AssertionError("DP2-B did not resume from step 2")
    differ = [k for k, v in b["state"].items()
              if not np.array_equal(v, a["state"][k])]
    long_run = done["cp2_long"]
    res = {"dp2_b_resumed_bitwise": not differ, "differ": differ[:20],
           "leaves": len(a["state"]), "digests": {
               k: v["digests"] for k, v in done.items()},
           "backend": done["dp2"]["backend"],
           "by_run": {k: {"ms_per_step": v["ms_per_step"],
                          "peak_mem_gib_by_rank": v["peak_mem_gib_by_rank"],
                          "collectives_per_step": v["comm_per_step"],
                          "launches_per_rank_step":
                              v["launches_per_rank_step"],
                          "cli_s": v["cli_s"]} for k, v in done.items()},
           "longclip_cp2": {
               "ms_per_step": long_run["ms_per_step"],
               "peak_mem_gib_by_rank": long_run["peak_mem_gib_by_rank"],
               "launches_per_rank_step": long_run["launches_per_rank_step"],
               "launches_per_step_predicted": long_run["per_step"],
               "collectives_per_step": long_run["comm_per_step"]},
           "f32": f32}
    print("parallel runs " + json.dumps(res), flush=True)
    if differ:
        raise AssertionError(f"DP2-B differs from DP2 in {len(differ)} "
                             f"leaves: {differ[:20]}")
    for v in done.values():
        v.pop("state", None)
        v.pop("stdout", None)
    return done


# ------------------------------------------------ the serving artifacts (7b)
# Each artifact: the flags of `tools/torch_export_serving.py` (the model and
# route), --serve_batch, --serve_dtype, the batches it serves, the device
# it is exported for. A5 is exported twice, for the card and the CPU. In
# the order their chains start (the longest first; `serving_children`).
ARTIFACTS = {
    # one polymorphic program with the fused routes (K1, K5a, K6a)
    "a2": (["--preset", "ucf101_64", "--ups_fused", "fwd", "--attn_fused",
            "on"], 0, "bfloat16", (1, 16, 32), "cuda"),
    # the serving config: bf16 batch 16, default routes (K1)
    "a1": (["--preset", "ucf101_64"], 16, "bfloat16", (16,), "cuda"),
    # 128 px with the attention at 64² (K1, K3, K6b)
    "a3": (["--preset", "kinetics_128", "--attn_res", "64", "--attn_fused",
            "on"], 2, "bfloat16", (2,), "cuda"),
    # DVD-GAN-FP: 5 real frames, 11 generated (K1 over both)
    "a4": (FP_PRESET, 8, "bfloat16", (8,), "cuda"),
    # f32: the card's artifact against the CPU's
    "a5": (["--preset", "ucf101_64"], 2, "float32", (2,), "cuda"),
    "a5_cpu": (["--preset", "ucf101_64"], 2, "float32", (2,), "cpu"),
}
# an artifact's clip against eager `step.sample` where they are not bitwise
# equal: the reference's round trip (tests/test_tools.py)
ARTIFACT_ATOL, ARTIFACT_RTOL = 5e-3, 5e-2
# the load child: torch and the registered ops only, no model code
LOAD_CHILD = r"""
import json, sys, time
import numpy as np
import torch
from dvdgan_tpu_torch.kernels import library
counters = {"k1": library.convgru_seq.gru_sequence_fused,
            "k3": library.convgru_blocked.gru_sequence_blocked,
            "k5a": library.ups2x_fused.ups2x,
            "k6a": library.attention_spatial.spatial_attn_fused,
            "k6b": library.attention_spatial.spatial_attn_tiled}
device, path, out = sys.argv[1], sys.argv[2], sys.argv[3]
# the parent's flags: f32 convs and matmuls in full f32 (cuDNN's default
# runs f32 convs in TF32)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.perf_counter()
serve = torch.export.load(path).module()
load_s = time.perf_counter() - t0
launches, clips = {}, {}
for name in sys.argv[4:]:
    with np.load(name) as f:
        args = [torch.from_numpy(f[k]).to(device) for k in sorted(f.files)]
    before = {k: c.launches for k, c in counters.items()}
    clip = serve(*args)
    launches[str(args[0].shape[0])] = {
        k: c.launches - before[k] for k, c in counters.items()}
    clips[str(args[0].shape[0])] = clip.float().cpu().numpy()
np.savez(out, **clips)
print(json.dumps({"launches": launches, "load_s": load_s, "modules": sorted(
    m for m in sys.modules if m.startswith("dvdgan_tpu"))}))
"""


def g_off_init(state, seed: int):
    """A `GeneratorState` moved off its init in place: every parameter
    plus 0.05 N(0, 1) (so both attention γ leave 0), every BN running mean
    N(0, 0.1) and var U(0.5, 1.5). -> the state."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in state.params.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
        for name, v in state.stats.named_buffers():
            if name.endswith("mean"):
                v.normal_(0, 0.1, generator=gen)
            else:
                v.uniform_(0.5, 1.5, generator=gen)
    return state


def sample_launches(g_cfg) -> dict[str, int]:
    """Kernel launches of one EMA-G sample call of `g_cfg`: each level's
    sequence kernel (K3 where `ops/convgru.py` sends the plane, else K1)
    over the prefix and the generated frames, K5a once a level with a
    fused upsample, K6a or K6b once with the fused attention."""
    from dvdgan_tpu_torch.kernels import attention_spatial as k6
    from dvdgan_tpu_torch.kernels import convgru_blocked as k3
    from dvdgan_tpu_torch.kernels import convgru_seq as k1
    from dvdgan_tpu_torch.kernels import ups2x_fused as k5
    from dvdgan_tpu_torch.ops import attention, convgru
    res = [g_cfg.base_res * 2 ** i for i in range(g_cfg.n_levels)]
    n_k3 = sum(convgru.uses_blocked(r, r) for r in res)
    t = g_cfg.cond_frames + g_cfg.n_frames
    attn = (g_cfg.attn_fused == "on" and g_cfg.attn_res is not None) * (
        k6.LAUNCHES_PER_CALL)
    tiled = g_cfg.attn_res is not None and attention.uses_tiled(
        g_cfg.attn_res, g_cfg.attn_res)
    return {"k1": (g_cfg.n_levels - n_k3) * t * k1.LAUNCHES_PER_STEP,
            "k3": n_k3 * t * k3.LAUNCHES_PER_STEP,
            "k5a": (g_cfg.ups_fused != "off") * g_cfg.n_levels
            * k5.LAUNCHES_PER_CALL,
            "k6a": 0 if tiled else attn, "k6b": attn if tiled else 0}


def artifact_inputs(g_cfg, b: int, seed: int) -> dict[str, np.ndarray]:
    """f32 z, int64 y and, for FP, an f32 prefix in [-1, 1]; the keys sort
    in the artifact's argument order."""
    rng = np.random.RandomState(seed)
    out = {"0_z": rng.randn(b, g_cfg.z_dim).astype(np.float32),
           "1_y": rng.randint(0, g_cfg.n_classes, b).astype(np.int64)}
    if g_cfg.cond_frames:
        out["2_cond"] = np.tanh(rng.randn(
            b, g_cfg.cond_frames, g_cfg.img_size, g_cfg.img_size, 3)).astype(
                np.float32)
    return out


def serving_children(root: str) -> dict[str, dict]:
    """Per artifact: its weights (the seeded init moved off it,
    `g_off_init`) and inputs written, an export child
    (`tools/torch_export_serving.py`), then a load child (`LOAD_CHILD`:
    torch and `kernels.library` only) that serves each batch once; three
    chains at a time (two took 180 s, where the phases beside them take
    ~130). -> {name: launches a call by batch, the modules the load child
    imported, export and load seconds, files}."""
    from dvdgan_tpu_torch import interop
    from dvdgan_tpu_torch.models.generator import GeneratorState
    from dvdgan_tpu_torch.utils.config import parse_config

    def chain(name):
        argv, batch, dtype, batches, dev = ARTIFACTS[name]
        seed = int(name[1])
        g_cfg = parse_config(argv).g_config()
        weights = os.path.join(root, f"{name}_weights.npz")
        interop.save_state_npz(weights, g_off_init(
            GeneratorState.create(g_cfg, seed), seed))
        ins = []
        for b in batches:
            ins.append(os.path.join(root, f"{name}_in_{b}.npz"))
            np.savez(ins[-1], **artifact_inputs(g_cfg, b, seed + b))
        path = os.path.join(root, f"{name}.pt2")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools",
                                          "torch_export_serving.py"), *argv,
             "--weights", weights, "--export_path", path, "--serve_batch",
             str(batch), "--serve_dtype", dtype, "--device", dev],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        export_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"export {name} exited {proc.returncode}:\n"
                                 f"{proc.stderr[-4000:]}")
        t0 = time.perf_counter()
        outs = os.path.join(root, f"{name}_out.npz")
        load = subprocess.run(
            [sys.executable, "-c", LOAD_CHILD, dev, path, outs, *ins],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        if load.returncode != 0:
            raise AssertionError(f"load {name} exited {load.returncode}:\n"
                                 f"{load.stderr[-4000:]}")
        res = json.loads(load.stdout.strip().splitlines()[-1])
        print(f"artifact {name}: {proc.stdout.strip().splitlines()[-1]}; "
              f"export child {export_s:.1f} s, load child "
              f"{time.perf_counter() - t0:.1f} s (artifact load "
              f"{res['load_s']:.2f} s)", flush=True)
        return {**res, "export_s": export_s, "weights": weights, "ins": ins,
                "outs": outs, "path": path, "bytes": os.path.getsize(path)}

    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futures = {name: pool.submit(chain, name) for name in ARTIFACTS}
        return {name: f.result() for name, f in futures.items()}


def check_artifacts(device, runs: dict[str, dict]) -> dict[str, dict]:
    """Each artifact's clips (from its load child) against eager
    `step.sample` of the same route, weights and inputs in this process:
    bitwise (else the gap is printed and held at the reference's round
    trip, ARTIFACT_ATOL/RTOL); its launches a call as `sample_launches`
    predicts; the load child without the model code. A5: the card's
    artifact against the CPU's at SAMPLE_TOL."""
    from dvdgan_tpu_torch import interop
    from dvdgan_tpu_torch.train import step
    from dvdgan_tpu_torch.utils.config import parse_config

    out = {}
    for name, run in runs.items():
        argv, batch, dtype, batches, dev = ARTIFACTS[name]
        bad = [m for m in run["modules"] if m.startswith(
            ("dvdgan_tpu_torch.models", "dvdgan_tpu_torch.ops",
             "dvdgan_tpu_torch.train")) or m.split(".")[0] == "dvdgan_tpu"]
        if bad:
            raise AssertionError(f"artifact {name}'s load child imported "
                                 f"{bad}")
        g_cfg = parse_config(argv).g_config()
        want = sample_launches(g_cfg)
        if dev == "cpu":
            want = dict.fromkeys(want, 0)
        for b, got in run["launches"].items():
            if got != want:
                raise AssertionError(f"artifact {name} at batch {b} "
                                     f"launched {got}, want {want}")
        compute = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        trees = interop.load_state_npz(run["weights"]).to(dev).trees()
        gaps = {}
        with np.load(run["outs"]) as clips:
            for b, path in zip(batches, run["ins"]):
                with np.load(path) as f:
                    args = [torch.from_numpy(f[k]).to(dev)
                            for k in sorted(f.files)]
                cond = args[2].to(compute) if len(args) > 2 else None
                ref = step.sample(*trees, args[0].to(compute), args[1], g_cfg,
                                  cond_video=cond).float().cpu().numpy()
                got = clips[str(b)]
                if got.shape != ref.shape or not np.isfinite(got).all():
                    raise AssertionError(f"artifact {name} at batch {b}: "
                                         f"shape {got.shape}, want "
                                         f"{ref.shape}, or non-finite")
                gaps[b] = float(np.abs(got - ref).max())
                if gaps[b] and not np.allclose(got, ref, atol=ARTIFACT_ATOL,
                                               rtol=ARTIFACT_RTOL):
                    raise AssertionError(f"artifact {name} at batch {b} "
                                         f"off eager step.sample by "
                                         f"{gaps[b]}")
        out[name] = {"launches_per_call": want, "calls": len(batches),
                     "bitwise": not any(gaps.values()), "max_abs_gap": gaps,
                     "bytes": run["bytes"], "export_s": run["export_s"],
                     "load_s": run["load_s"]}
        print(f"artifact {name} ({' '.join(argv)}, batch {batch or 'any'}, "
              f"{dtype}, {dev}): launches a call {want}, against eager "
              f"step.sample max_abs {gaps} "
              f"({'bitwise' if out[name]['bitwise'] else 'NOT bitwise'})",
              flush=True)
    with np.load(runs["a5"]["outs"]) as card, \
            np.load(runs["a5_cpu"]["outs"]) as cpu:
        err = float(np.abs(card["2"] - cpu["2"]).max())
    print(f"artifact a5 f32 card vs cpu: max_abs_err {err:.3e} (atol "
          f"{SAMPLE_TOL})", flush=True)
    if not err <= SAMPLE_TOL:
        raise AssertionError(f"the f32 artifact on the card disagrees with "
                             f"the CPU's: {err}")
    out["a5"]["card_vs_cpu"] = err
    return out


def time_serving(device, runs: dict[str, dict]) -> dict:
    """A1 and `step.sample` of the same weights at batch 16, each eager and
    from a CUDA graph of SCAN_STEPS calls (`tools/torch_bench_sample.py`),
    host ms a batch and the device idle share (1 − profiler kernel time /
    the unprofiled time) of each; then one sample call traced under
    `profiling.trace` with spans on: the trace must hold the sampler's
    span ("dvdgan.sample", `profiling.span`) and K1's kernels."""
    from dvdgan_tpu_torch import interop, serving
    from dvdgan_tpu_torch.train import step
    from dvdgan_tpu_torch.utils import profiling
    from dvdgan_tpu_torch.utils.config import parse_config
    from tools import torch_bench_sample as bench

    argv, batch = ARTIFACTS["a1"][:2]
    g_cfg = parse_config(argv).g_config()
    trees = interop.load_state_npz(runs["a1"]["weights"]).to(device).trees()
    serve = serving.load_sampler(runs["a1"]["path"])
    calls = {"artifact": (lambda z, y: serve(z, y), torch.float32),
             "step_sample": (lambda z, y: step.sample(*trees, z, y, g_cfg),
                             torch.bfloat16)}
    rows = {}
    for name, (call, dtype) in calls.items():
        for graph in (False, True):
            draws = bench.Draws(batch, g_cfg.z_dim, g_cfg.n_classes, dtype,
                                device)
            run = (bench.graphed(call, draws) if graph else
                   functools.partial(bench.scan, call, draws))
            secs = bench.seconds_per_call(run, draws)
            busy, _ = profile_busy_us(run)
            per = busy / 1e3 / bench.SCAN_STEPS
            rows[f"{name}_{'graph' if graph else 'eager'}"] = {
                "ms_per_batch": secs * 1e3, "clips_per_s": batch / secs,
                "device_ms_per_batch": per,
                "device_idle_share": 1.0 - per / (secs * 1e3)}
    print("serving_rate " + json.dumps({"batch": batch, **rows}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        z = torch.randn(batch, g_cfg.z_dim, device=device).bfloat16()
        y = torch.zeros(batch, dtype=torch.long, device=device)
        profiling.enable(True)
        try:
            with profiling.trace(tmp, device):
                step.sample(*trees, z, y, g_cfg)
        finally:
            profiling.enable(False)
        (path,) = [os.path.join(tmp, f) for f in os.listdir(tmp)]
        with open(path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    k1_names = sorted({n for n in names
                       if any(k in n for k in CONVGRU_KERNELS)})
    span = profiling.PREFIX + "sample"
    print(f"trace of one sample call: {len(names)} event names, span "
          f"{span!r} {span in names}, K1 kernels {k1_names[:3]}",
          flush=True)
    if span not in names or not k1_names:
        raise AssertionError("the sample trace lacks the span or K1's "
                             "kernels")
    return rows


REMAT_POLICY_ORDER = ("gru+ups", "gru+ups", "gru", "ups", "none")


def check_remat_policies(device) -> dict[str, dict]:
    """The long-clip step (`kinetics_256_48f`, batch 4 as 2 micro-batches)
    under each `--remat_save` policy in this one process, from one state,
    batch and draws: 1 warm-up step and 1 timed step each (ms, peak
    memory, K1/K2/K3 launches of the timed step against
    `launches_per_step`). `gru+ups` runs twice first: if its two states
    are bitwise equal every other policy's must be too, else each model's
    leaves within the largest gap between those two runs."""
    from dvdgan_tpu_torch.core import tree
    from dvdgan_tpu_torch.kernels import convgru_blocked as k3
    from dvdgan_tpu_torch.kernels import convgru_bwd as k2
    from dvdgan_tpu_torch.kernels import convgru_seq as k1
    from dvdgan_tpu_torch.train import state as train_state
    from dvdgan_tpu_torch.train import step
    from dvdgan_tpu_torch.utils.config import parse_config

    batch, seed, g_cfg, ds_cfg, dt_cfg, tc = step_configs(LONG_ARGV)
    state0 = train_state.to_device(
        train_state.create(seed, g_cfg, ds_cfg, dt_cfg), device)
    gen = torch.Generator(device).manual_seed(seed)
    real = torch.tanh(torch.randn(batch, dt_cfg.n_frames, g_cfg.img_size,
                                  g_cfg.img_size, 3, generator=gen,
                                  device=device)).to(torch.bfloat16)
    y = torch.randint(0, g_cfg.n_classes, (batch,), generator=gen,
                      device=device)
    counters = {"k1": k1.gru_sequence_fused, "k2": k2.gru_sequence_bwd,
                "k3": k3.gru_sequence_blocked}
    rows, ref, gaps = [], None, None
    for policy in REMAT_POLICY_ORDER:
        cfg = dataclasses.replace(g_cfg, remat_save=policy)
        state = tree.tree_map(torch.clone, state0)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for i in range(2):
            draws = step.TorchDraws(seed, i, batch, g_cfg.z_dim,
                                    g_cfg.n_frames, ds_cfg.k_frames,
                                    torch.bfloat16, device)
            before = {k: c.launches for k, c in counters.items()}
            t0 = time.perf_counter()
            state, _ = step.train_step(state, real, y, draws, cfg, ds_cfg,
                                       dt_cfg, tc)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launched = {k: c.launches - before[k] for k, c in counters.items()}
        want = launches_per_step(parse_config(
            LONG_ARGV + ["--remat_save", policy]))
        want = {k: want[f"{k}_launches"] for k in counters}
        if launched != want:
            raise AssertionError(f"remat {policy}: launches {launched}, "
                                 f"want {want}")
        # on the host: a state held on the card would count in the next
        # run's peak
        flat = {p: v.cpu() for p, v in tree.flatten_with_paths(state).items()
                if torch.is_tensor(v) and v.is_floating_point()}
        del state
        row = {"remat_save": policy, "ms_step": secs * 1e3,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": launched}
        if ref is None:
            ref = flat
        else:
            model_gap = {}
            for p, v in flat.items():
                m = p.split("/")[0]
                d = float((v - ref[p]).abs().max())
                model_gap[m] = max(model_gap.get(m, 0.0), d)
            row["max_abs_gap_vs_first"] = model_gap
            if gaps is None:
                gaps = model_gap
                row["repeats_bitwise"] = not any(gaps.values())
            elif any(d > gaps.get(m, 0.0) for m, d in model_gap.items()):
                raise AssertionError(f"remat {policy}: state off gru+ups's "
                                     f"by {model_gap}, beyond its repeat's "
                                     f"{gaps}")
        rows.append(row)
        print("remat_policy " + json.dumps(row), flush=True)
    return rows


# ----------------------- the migration to and from PyTorch state dicts
# trainer run A's newest checkpoint out as state dicts in the interchange
# naming and back into a fresh out_dir, in child processes; the import then
# sampled and resumed for MIGRATE_STEPS steps
MIGRATE_STEPS = 2
MIGRATE_TREES = ("g/params/", "g_ema/", "ds/params/", "dt/params/",
                 "g/stats/")
MIGRATE_FILES = {"g": "G", "g_ema": "G_ema", "ds": "DS", "dt": "DT"}
# the sample CLI in a child, the parent's f32 flags set (cuDNN's default
# runs f32 convs in TF32), its launch counters printed after it
SAMPLE_CHILD = r"""
import json, sys
import torch
from dvdgan_tpu_torch import cli
from dvdgan_tpu_torch.kernels import attention_spatial as k6
from dvdgan_tpu_torch.kernels import convgru_blocked as k3
from dvdgan_tpu_torch.kernels import convgru_seq as k1
from dvdgan_tpu_torch.kernels import ups2x_fused as k5
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cli.main(sys.argv[1:])
print("launches " + json.dumps({
    "k1": k1.gru_sequence_fused.launches,
    "k3": k3.gru_sequence_blocked.launches, "k5a": k5.ups2x.launches,
    "k6a": k6.spatial_attn_fused.launches,
    "k6b": k6.spatial_attn_tiled.launches}))
"""


def migration_source(run: dict) -> dict:
    """A copy of a kept train CLI run's newest checkpoint (its out_dir
    goes with the run's own check) and its final flat state."""
    step = int(run["state"]["step"])
    tmp = tempfile.TemporaryDirectory()
    shutil.copytree(os.path.join(run["out_dir"], "checkpoints", str(step)),
                    os.path.join(tmp.name, "checkpoints", str(step)))
    return {"tmp": tmp, "step": step, "state": dict(run["state"])}


def _tool(args, timeout_s: float = 300) -> tuple[str, float]:
    """A child process of this interpreter from the repository's root;
    -> (its stdout, its seconds). Raises with its stderr if it fails."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout_s)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(args[:2])} exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    return proc.stdout, time.perf_counter() - t0


def migration_children(src: dict, argv=FLAGSHIP_ARGV) -> dict:
    """The migration of `migration_source(A)`: `tools/
    torch_export_checkpoint.py` writes its {G,G_ema,DS,DT}.pth, `tools/
    torch_import_checkpoint.py` takes them (and the step) into a fresh
    out_dir (all with A's flags, `argv`); G, G_ema, DS and DT params and
    G's BN stats must be A's bitwise, the step A's. Then, side by side,
    the sample CLI on the
    imported checkpoint (`--pretrained_model`; `SAMPLE_CHILD`): bf16 batch
    B with `sample_launches`' launches and a clip of the right shape,
    finite, in [-1, 1]; f32 batch 2 on the card and on the CPU, within
    SAMPLE_TOL; and the train CLI resumed from it for MIGRATE_STEPS steps
    (`start_train`, checked by `finish_train`: finite losses, launches per
    step as `launches_per_step`). -> seconds, bytes, launches, the gap."""
    from dvdgan_tpu_torch.train import checkpoint as ckpt
    from dvdgan_tpu_torch.utils.config import parse_config

    t_in = time.perf_counter()
    step, root = src["step"], src["tmp"].name
    exported = os.path.join(root, "exported")
    imported = tempfile.TemporaryDirectory()
    res: dict = {"step": step}
    resume = None
    try:
        out, res["export_s"] = _tool([
            "tools/torch_export_checkpoint.py", *argv, "--out_dir",
            root, "--export_dir", exported])
        print(f"migration: {out.strip()}", flush=True)
        files = {k: os.path.join(exported, f"{n}.pth")
                 for k, n in MIGRATE_FILES.items()}
        res["state_dict_bytes"] = {k: os.path.getsize(p)
                                   for k, p in files.items()}
        out, res["import_s"] = _tool([
            "tools/torch_import_checkpoint.py", *argv, "--out_dir",
            imported.name, "--step", str(step),
            *(a for k, p in files.items() for a in (f"--{k}_ckpt", p))])
        print(f"migration: {out.strip()}", flush=True)
        with np.load(os.path.join(imported.name, "checkpoints", str(step),
                                  ckpt.STATE_FILE)) as f:
            back = {k: f[k] for k in f.files}
        a = src["state"]
        held = [k for k in a if k.startswith(MIGRATE_TREES)]
        differ = [k for k in held if k not in back
                  or back[k].dtype != a[k].dtype
                  or not np.array_equal(back[k], a[k])]
        res["round_trip"] = {"leaves": len(held), "differ": differ[:20],
                             "step": int(back["step"]),
                             "same_paths": back.keys() == a.keys()}
        if differ or int(back["step"]) != step or back.keys() != a.keys():
            raise AssertionError(f"the migration's round trip: "
                                 f"{res['round_trip']}")

        # the sample CLI (each child in an out_dir of its own that links
        # the imported checkpoints) beside the resumed train CLI
        t0 = time.perf_counter()
        samples = {}
        for name, flags in (
                ("bf16", ["--n_samples", str(B), "--bf16", "1"]),
                ("f32_card", ["--n_samples", "2", "--bf16", "0"]),
                ("f32_cpu", ["--n_samples", "2", "--bf16", "0", "--device",
                             "cpu"])):
            out_dir = os.path.join(root, f"sample_{name}")
            os.makedirs(out_dir)
            os.symlink(os.path.join(imported.name, "checkpoints"),
                       os.path.join(out_dir, "checkpoints"))
            samples[name] = (out_dir, subprocess.Popen(
                [sys.executable, "-c", SAMPLE_CHILD, *argv, "--mode",
                 "sample", *flags, "--out_dir", out_dir,
                 "--pretrained_model", str(step)], cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        resume = start_train(argv + ["--pretrained_model", str(step)],
                             step + MIGRATE_STEPS, imported, step)
        clips, launches = {}, {}
        try:
            for name, (out_dir, proc) in samples.items():
                stdout, stderr = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    raise AssertionError(f"the sample CLI ({name}) on the "
                                         f"imported checkpoint exited "
                                         f"{proc.returncode}:\n"
                                         f"{stderr[-4000:]}")
                launches[name] = json.loads(
                    stdout.strip().splitlines()[-1][len("launches "):])
                clips[name] = np.load(os.path.join(out_dir, "samples.npy"))
            res["sample_s"] = time.perf_counter() - t0
        finally:
            for _, proc in samples.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        g_cfg = parse_config(argv).g_config()
        want = sample_launches(g_cfg)
        bf16 = clips["bf16"]
        shape = (B, g_cfg.n_frames, g_cfg.img_size, g_cfg.img_size, 3)
        res["sample_launches"] = launches["bf16"]
        gap = float(np.abs(clips["f32_card"] - clips["f32_cpu"]).max())
        res["f32_card_vs_cpu"] = gap
        print(f"migration: the imported checkpoint sampled, bf16 {shape}: "
              f"range [{bf16.min():.4f}, {bf16.max():.4f}], launches "
              f"{launches['bf16']} (want {want}); f32 batch 2 card vs cpu "
              f"max_abs_err {gap:.3e} (atol {SAMPLE_TOL})", flush=True)
        if (bf16.shape != shape or not np.isfinite(bf16).all()
                or bf16.min() < -1.0 or bf16.max() > 1.0):
            raise AssertionError(f"the imported checkpoint's bf16 clips: "
                                 f"{bf16.shape}, [{bf16.min()}, "
                                 f"{bf16.max()}]")
        if launches["bf16"] != want:
            raise AssertionError(f"launches in the imported checkpoint's "
                                 f"sample: {launches['bf16']}, want {want}")
        if not gap <= SAMPLE_TOL:
            raise AssertionError(f"the imported checkpoint's f32 sample, "
                                 f"card vs CPU: {gap}")
        imported = None     # the run's check cleans its out_dir up
        run = finish_train(resume)
        if f"resumed from checkpoint step {step}" not in run["stdout"]:
            raise AssertionError(f"the train CLI did not resume the imported "
                                 f"checkpoint at step {step}")
        res["resume"] = {k: run[k] for k in ("per_step", "cli_s",
                                             "peak_mem_gib", "k1", "k2")}
    finally:
        if resume is not None and resume["procs"][0].poll() is None:
            resume["procs"][0].kill()
            resume["procs"][0].communicate()
        if imported is not None:
            imported.cleanup()
    res["seconds"] = time.perf_counter() - t_in
    print("migration " + json.dumps(res), flush=True)
    return res


# ------------------------------------- four cards, NCCL one card a rank (6b)
# `python3 chip_smoke.py --cards 4`: the train CLI as `--multihost` ranks
# with `--device cuda` (rank i on cuda:i, NCCL), all full width, bf16
# unless said, on synthetic clips. {name: (flags, steps)}; the global batch
# splits over the data ranks.
CARDS = 4
K2_ARGV = ["--steps_per_call", "2", "--log_step", "2"]
DP4_ARGV = FLAGSHIP_ARGV + ["--model_save_step", "2"]     # 2 clips a rank
CP_ARGV = FLAGSHIP_ARGV + ["--time_shards", "2"]          # data 2 x time 2
LONG_DP4_ARGV = LONG_ARGV + ["--grad_accum", "1"]         # 1 clip a rank
CARD_RUNS = {
    "dp4": (DP4_ARGV, 4),
    "dp4_k2": (DP4_ARGV + K2_ARGV, 4),
    # the flagship train command with neither --n_devices nor --multihost:
    # `plan` takes every visible card, `spawn` starts the ranks (K 4)
    "default": (FLAGSHIP_ARGV + ["--steps_per_call", "4", "--log_step", "4"],
                4),
}
CARD_AFTER = {  # started as an earlier run ends ({name: (after, step, ...)})
    "dp4_b": ("dp4", 2, DP4_ARGV, 4),
    "cp": ("dp4_k2", None, CP_ARGV, 2),
    "cp_k2": ("default", None, CP_ARGV + K2_ARGV, 2),
    "long_dp4": ("dp4_b", None, LONG_DP4_ARGV, 2),
    "long_dp4_k2": ("cp", None, LONG_DP4_ARGV + K2_ARGV, 2),
    # the reference's long-clip topology: the clip over 4 time ranks,
    # batch 4 as 2 micro-batches of 2
    "long_cp4": ("cp_k2", None, LONG_ARGV + ["--time_shards", "4"], 2),
    # the f32 steps held to one process (PAR_F32_*), from `off_init`
    "dp4_f32": ("long_dp4", None, PAR_RUNS["dp2_f32"][0], 1),
    "cp_f32": ("long_dp4_k2", None, PAR_RUNS["cp2_f32"][0], 1),
}
CARD_F32 = ("dp4_f32", "cp_f32")
# pairs that must have the same bits in every leaf: (run, its reference)
CARD_BITS = (("dp4_b", "dp4"), ("dp4_k2", "dp4"), ("cp_k2", "cp"),
             ("long_dp4_k2", "long_dp4"))
# the rates: one rank alone on cuda:0 against the CARDS ranks, each at
# steps_per_call 1 and at the trainer's K; strong scaling (the global
# batch of one card over the ranks) and weak (one card's batch a rank).
# {name: (the ranks' flags, the one rank's flags, K, steps a reading)}
CARD_RATES = {
    "flagship_strong": (FLAGSHIP_ARGV, FLAGSHIP_ARGV, 4, 12),
    "flagship_weak": (FLAGSHIP_ARGV + ["--batch_size", str(CARDS * B_TRAIN)],
                      FLAGSHIP_ARGV, 4, 12),
    # (the long clip's weak point, 8 clips a rank, would add ~1 minute)
    "longclip_strong": (
        LONG_ARGV + ["--batch_size", "8", "--grad_accum", "1"],
        LONG_ARGV + ["--batch_size", "8", "--grad_accum", "4"], 2, 6),
}
# in turns: (who, steps_per_call 1 or K); a reading's rate is the trainer's
# own steps_per_sec of each logged interval but its first (`steady_ms`)
RATE_TURNS = (("one", 1), ("ranks", 1), ("ranks", "K"), ("one", "K"))
# a reading longer than this dumps every thread's stack into its rank's log
# and ends the rank: a stalled reading then fails the phase with a trace of
# where, not at the ranks' overall limit without one
TURN_LIMIT_S = 240
NCCL_KERNELS = ("nccl",)


def check_card_runs(done: dict, refs: dict) -> dict:
    """The four-card runs: each as `finish_ranks` checked it (nccl, equal
    digests, launches), the `default` run's ranks; the pairs of CARD_BITS
    bitwise (else the differing leaves named); dp4_b resumed at 2; the f32
    runs against one process (`refs`: `par_f32_reference` of each)."""
    res = {}
    out = done["default"]["stdout"]
    backend = [ln for ln in out.splitlines()
               if ln.startswith("parallel: backend ")]
    digests = re.findall(r"^rank \d+: state digest (\w+) over", out, re.M)
    res["default"] = {"backend": backend, "digests": digests,
                      "captured": out.count("into one CUDA graph")}
    if (len(backend) != 1 or not backend[0].startswith(
            "parallel: backend nccl ") or f" {CARDS} ranks," not in backend[0]
            or len(digests) != CARDS or len(set(digests)) != 1
            or res["default"]["captured"] != CARDS):
        raise AssertionError(f"the default train command: {res['default']}")
    if "resumed from checkpoint step 2" not in done["dp4_b"]["stdout"]:
        raise AssertionError("dp4_b did not resume from step 2")
    bits = {}
    for run, ref in CARD_BITS:
        a, b = done[ref]["state"], done[run]["state"]
        differ = [k for k, v in b.items() if not np.array_equal(v, a[k])]
        bits[f"{run} vs {ref}"] = {
            "bitwise": not differ, "leaves": len(a), "differ": differ[:20],
            "max_abs": state_gaps(b, a) if differ else None}
    res["bits"] = bits
    res["f32"] = {name: check_par_f32(None, name, done[name], None, CARDS,
                                      refs[name]) for name in CARD_F32}
    res["by_run"] = {
        k: {"ms_per_step": v.get("ms_per_step"),
            "peak_mem_gib_by_rank": v.get("peak_mem_gib_by_rank"),
            "collectives_per_rank_step": v.get("comm_per_step"),
            # every rank's launches and digest checked by `finish_ranks`
            "launches_per_rank_step": (v.get("launches_per_rank_step")
                                       or [None])[0],
            "launches_per_step_predicted": v["per_step"],
            "digest": (v.get("digests") or [None])[0], "cli_s": v["cli_s"]}
        for k, v in done.items()}
    print("four-card runs " + json.dumps(res), flush=True)
    bad = [k for k, v in bits.items() if not v["bitwise"]]
    if bad:
        raise AssertionError(f"runs without their reference's bits: "
                             f"{ {k: bits[k]['differ'] for k in bad} }")
    return res


def drive_cards(device) -> dict:
    """The four-card runs (CARD_RUNS, then CARD_AFTER as their runs end,
    through `drive_trains`; `start_ranks` with `--device cuda` and a world
    of CARDS, `finish_ranks` expecting nccl; the `default` run through
    `start_train`); meanwhile this process computes the f32 runs' one
    process step on cuda:0. Checked by `check_card_runs`."""
    from dvdgan_tpu_torch import interop
    from dvdgan_tpu_torch.train import state as train_state
    from dvdgan_tpu_torch.utils.config import parse_config

    weights = tempfile.TemporaryDirectory()
    path = os.path.join(weights.name, "off_init.npz")
    cfg = parse_config(PAR_RUNS["dp2_f32"][0])
    interop.save_train_state_npz(path, off_init(train_state.create(
        cfg.seed, cfg.g_config(), cfg.ds_config(), cfg.dt_config()),
        cfg.seed + 2))
    after = {name: (src, at, argv + ["--weights", path], n)
             if name in CARD_F32 else (src, at, argv, n)
             for name, (src, at, argv, n) in CARD_AFTER.items()}
    refs = {}

    def meanwhile():
        for name in CARD_F32:
            refs[name] = par_f32_reference(device, after[name][2], CARDS)

    def start(argv, n_steps, tmp=None, first=0):
        if argv is CARD_RUNS["default"][0]:     # one CLI process, 4 ranks
            return start_train(argv, n_steps)
        return start_ranks(argv, n_steps, tmp, first, CARDS, "cuda")

    def finish(run, keep=False):
        if len(run["procs"]) == 1:
            return finish_train(run, keep)
        return finish_ranks(run, keep, "nccl", timeout_s=300)

    keep = {k for pair in CARD_BITS for k in pair} | set(CARD_F32)
    done = {}
    try:
        # up to three runs of CARD_RUNS' ranks at a time share the host
        with child_threads(3 * CARDS):
            done = drive_trains(CARD_RUNS, after, tuple(keep), start, finish,
                                meanwhile)
        return check_card_runs(done, refs)
    finally:
        for run in done.values():
            if "tmp" in run:
                run["tmp"].cleanup()
        weights.cleanup()


def profile_kernels(fn) -> dict:
    """fn() once under torch.profiler (after one unprofiled call): the
    device µs of all its kernels and of NCCL's (`NCCL_KERNELS`, through
    `device_view` with one try: every rank must run fn the same number of
    times), and how many NCCL launches it saw."""
    view = device_view(fn, 0, NCCL_KERNELS, tries=1)
    nccl = sum(view["launch_device_us"][k] * view["launch_count"][k]
               for k in view["launch_device_us"])
    return {"device_ms": view["device_ms"], "nccl_ms": nccl / 1e3,
            "nccl_launches": view["profiled_launches"]}


def steady_ms(log_dir: str, after: int, upto: int, every: int
              ) -> list[float]:
    """ms a step of each interval the trainer logged (its `steps_per_sec`,
    the train stream's time between two log steps) that ends in
    (after + every, upto]: a reading's steady state. Its first interval is
    left out (it holds the loader's start, the first batch placed
    synchronously, a capture), and so is the digest and the launch line a
    multi-rank run prints after its last step."""
    out = []
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if (rec["tag"] == "steps_per_sec"
                    and after + every < rec["step"] <= upto):
                out.append(1e3 / rec["value"])
    return out


def _rate_trainer(argv, k: int, par, tmp: str):
    """A trainer of `argv` for both steps_per_call 1 and k (logging every k
    steps, no dump or save), warmed up over k steps at 1; its K graph is
    captured by its first `train` call at k: -> (trainer, its peak device
    memory in GiB above what was allocated before it was built). Its
    `steps_per_call` picks the mode of the next `train` call."""
    from dvdgan_tpu_torch.train.trainer import Trainer
    from dvdgan_tpu_torch.utils.config import parse_config

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(parse_config(argv + [
        "--steps_per_call", str(k), "--log_step", str(k), "--sample_step",
        "0", "--model_save_step", "0", "--out_dir", tmp]), par)
    tr.steps_per_call = 1
    tr.train(total_step=tr.start_step + k)
    return tr, (torch.cuda.max_memory_allocated() - base) / 2**30


def card_rates_rank(local_rank: int, out: str, rates=None,
                    cards: int = CARDS, device: str = "cuda") -> None:
    """One rank of the rates (`time_cards`): for each entry of `rates`
    (default CARD_RATES) in a world of `cards` ranks, the readings in
    RATE_TURNS (a gloo barrier between turns; the other ranks wait out the
    one rank's), each `steady_ms` of its own trainer, both sides alike: on
    rank 0 one rank's trainer (no process group: cuda:0 alone), and the
    ranks' trainer. Each is built at its first turn and warmed up at
    steps_per_call 1, captures its K graph at its first K turn, and is
    closed after its last turn, once its K graph has been replayed under
    the profiler (`profile_kernels`) and one bare K call has been run for
    its syncs; with the collectives and bytes a step and the peak memory
    (the larger of its warm-up's and its first K turn's). A trainer keeps
    its K graph's private pool until it is closed: the long clip's one-card
    graph (batch 8, the fake pass at 16) reserves ~44 GiB, its eager step
    ~20 GiB more, so on rank 0 no graph is alive at the one card's K 1
    reading, nor the ranks' trainer at its capture (`ROADMAP.md` Queue 3).
    Its stdout goes to a file; the rows to out/rates_rank<r>.json. Rank 0
    also prints each step of the phase, with its seconds and memory, and
    each entry's row as it ends to the launcher's stdout, so that a call
    cut short keeps what was done."""
    import faulthandler
    import gc
    import warnings

    from dvdgan_tpu_torch.parallel import collectives
    from dvdgan_tpu_torch.parallel import mesh as pmesh

    sys.stdout = open(os.path.join(out, f"rank{local_rank}.log"), "w")
    t0 = time.perf_counter()

    def note(msg: str) -> None:
        if local_rank == 0:
            mem = (f", allocated {torch.cuda.memory_allocated() / 2**30:.2f}"
                   f" GiB, reserved {torch.cuda.memory_reserved() / 2**30:.2f}"
                   f" GiB" if torch.cuda.is_available() else "")
            print(f"[rates {time.perf_counter() - t0:6.1f} s{mem}] {msg}",
                  file=sys.__stdout__, flush=True)

    def release() -> None:
        gc.collect()                # the graphs and their pools
        torch.cuda.empty_cache()

    def read(name: str, side: str, tr, k: int, kk: int, n: int) -> dict:
        """One reading of `tr` at steps_per_call kk over n steps; its first
        K turn (the capture) also measures the peak memory."""
        tr.steps_per_call = kk
        first = tr.start_step
        comms = collectives.COUNTS.snapshot()
        capture = kk > 1 and tr._multi is None
        if capture:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        faulthandler.dump_traceback_later(TURN_LIMIT_S, exit=True,
                                          file=sys.stdout)
        tr.train(total_step=first + n)
        faulthandler.cancel_dump_traceback_later()
        if capture:
            peaks[side] = (torch.cuda.max_memory_allocated() - base) / 2**30
        if kk > 1:      # a replay moves no counter
            comms = tr._multi.comms
        else:
            comms = {c: (v - comms[c]) // n for c, v in
                     collectives.COUNTS.snapshot().items()}
        note(f"{name}: read {side} at K {kk}")
        return {"who": side, "k": kk, "ms_per_step": (
            steady_ms(os.path.join(tr.out_dir, "logs"), first, first + n, k)
            if tr.is_main else None), "comms_per_step": comms}

    def profiled(side: str, k: int) -> dict:
        """The K graph of `side`'s trainer replayed under the profiler and
        one bare K call's syncs; then the trainer is closed."""
        tr, warm_peak = who.pop(side)
        multi = tr._multi
        view = profile_kernels(lambda: multi.graph.replay())
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                multi(multi.state, multi.reals, multi.ys, 0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        row = {
            "peak_mem_gib": max(warm_peak, peaks.pop(side)),
            "reserved_gib": torch.cuda.memory_reserved() / 2**30,
            "capture_s": multi.capture_s,
            "device_ms_per_step": view["device_ms"] / k,
            "nccl_ms_per_step": view["nccl_ms"] / k,
            "nccl_launches_per_step": view["nccl_launches"] / k,
            "comms_per_step_k": multi.comms,
            "syncs_in_a_k_call": len(caught),
            "sync_sites": sorted({str(w.message)[:100] for w in caught})[:4]}
        tr.close()
        return row

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    par = pmesh.init_from_env(torch.device(device), 1, cards * B_TRAIN)
    coord = torch.distributed.new_group(backend="gloo")
    tmp = tempfile.TemporaryDirectory()
    rows, who, peaks = {}, {}, {}
    last = {side: i for i, (side, _) in enumerate(RATE_TURNS)}
    failed = False
    try:
        for name, (argv, one_argv, k, n) in (rates or CARD_RATES).items():
            row, turns = {}, []
            for i, (side, kk) in enumerate(RATE_TURNS):
                torch.distributed.barrier(group=coord)
                if side == "one" and not par.is_main:
                    continue
                if side not in who:
                    release()
                    who[side] = _rate_trainer(
                        argv if side == "ranks" else one_argv, k,
                        par if side == "ranks" else None,
                        os.path.join(tmp.name, f"{side}_{name}"))
                    note(f"{name}: the {side} side's trainer built and "
                         f"warmed up at K 1, peak {who[side][1]:.2f} GiB")
                turns.append(read(name, side, who[side][0], k,
                                  k if kk == "K" else kk, n))
                if i == last[side]:
                    if side == "ranks":     # the ranks' K call on all
                        torch.distributed.barrier(group=coord)
                    row[side] = profiled(side, k)
                    release()
            torch.distributed.barrier(group=coord)
            rows[name] = {"turns": turns, **row}
            note(f"{name}: {json.dumps(rows[name])}")
            with open(os.path.join(out, f"rates_rank{local_rank}.json"),
                      "w") as f:            # what is done so far
                json.dump(rows, f)
    except BaseException:
        # the error to the launcher's stderr first: the group's destruction
        # waits on any graph that still holds its collectives, and so a
        # failed rank leaves the group to its process's end
        failed = True
        traceback.print_exc(file=sys.__stderr__)
        sys.__stderr__.flush()
        raise
    finally:
        faulthandler.cancel_dump_traceback_later()
        for tr, _ in who.values():
            tr.close()
        who.clear()     # their graphs, before the group goes
        tmp.cleanup()
        if not failed:
            par.close()
        sys.stdout.close()


def time_cards() -> dict:
    """The rates (`card_rates_rank` on CARDS ranks, one card each): for
    each entry of CARD_RATES and each of one rank and the CARDS ranks at
    steps_per_call 1 and K, rank 0's ms a step (each steady interval of
    its reading, `steady_ms`; their median), the clips/s per card, the
    device ms a step (the K graph's replay under the profiler) and NCCL's
    share of it, the idle share, the collectives and bytes a rank-step,
    the peak memory a rank and the syncs of one K call. The ranks' K call
    must make none."""
    from dvdgan_tpu_torch.parallel import mesh as pmesh
    from dvdgan_tpu_torch.utils.config import parse_config

    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    try:
        try:
            pmesh.spawn(card_rates_rank, CARDS, (tmp.name,), timeout_s=480)
        finally:
            ranks = []
            for r in range(CARDS):
                path = os.path.join(tmp.name, f"rates_rank{r}.json")
                if os.path.exists(path):
                    with open(path) as f:
                        ranks.append(json.load(f))
            print("four-card rates, each rank's rows "
                  + json.dumps(ranks), flush=True)
    finally:
        for r in range(CARDS):      # the ranks' own lines, the end of each
            path = os.path.join(tmp.name, f"rank{r}.log")
            if os.path.exists(path):
                with open(path) as f:
                    tail = f.read()[-6000:]
                print(f"--- rates rank {r} (end of its stdout):\n{tail}",
                      flush=True)
        tmp.cleanup()
    out = {}
    for name, (argv, one_argv, k, n) in CARD_RATES.items():
        batch = {"ranks": parse_config(argv).batch_size,
                 "one": parse_config(one_argv).batch_size}
        lead = ranks[0][name]
        res = {"batch": batch, "k": k, "steps_a_reading": n}
        for side in ("one", "ranks"):
            cards = CARDS if side == "ranks" else 1
            dev = lead[side]["device_ms_per_step"]
            for kk in (1, k):
                turn, = [t for t in lead["turns"]
                         if t["who"] == side and t["k"] == kk]
                mid = statistics.median(turn["ms_per_step"])
                res[f"{side}_k{kk}"] = {
                    "ms_per_step": turn["ms_per_step"],
                    "median_ms_per_step": mid,
                    "clips_per_s_per_card": batch[side] / mid * 1e3 / cards,
                    "idle_share": 1.0 - dev / mid,
                    "comms_per_rank_step": turn["comms_per_step"]}
            views = [r[name][side] for r in ranks if side in r[name]]
            res[side] = {
                "device_ms_per_step": [v["device_ms_per_step"]
                                       for v in views],
                "nccl_ms_per_step": [v["nccl_ms_per_step"] for v in views],
                "nccl_launches_per_step": [v["nccl_launches_per_step"]
                                           for v in views],
                "peak_mem_gib_by_rank": [v["peak_mem_gib"] for v in views],
                "capture_s": [v["capture_s"] for v in views],
                "comms_per_step_k": views[0]["comms_per_step_k"],
                "syncs_in_a_k_call": [v["syncs_in_a_k_call"] for v in views],
                "sync_sites": views[0]["sync_sites"]}
        for kk in (1, k):
            one, many = res[f"one_k{kk}"], res[f"ranks_k{kk}"]
            many["per_card_vs_one"] = (many["clips_per_s_per_card"]
                                       / one["clips_per_s_per_card"])
        out[name] = res
    out["seconds"] = time.perf_counter() - t0
    print("four-card rates " + json.dumps(out), flush=True)
    bad = {name: out[name]["ranks"]["syncs_in_a_k_call"] for name in CARD_RATES
           if any(out[name]["ranks"]["syncs_in_a_k_call"])}
    if bad:
        raise AssertionError(f"syncs in the ranks' K call: {bad}")
    return out


def main_cards() -> int:
    """`--cards 4`: the kernels built, the four-card runs (`drive_cards`)
    and rates (`time_cards`), then the result line."""
    from dvdgan_tpu_torch.kernels import _build

    n = torch.cuda.device_count()
    if n < CARDS:
        print(f"chip_smoke --cards {CARDS}: {n} CUDA devices visible",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    def phase(name: str) -> None:
        print(f"[{time.perf_counter() - t_start:7.1f} s] done: {name}",
              flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    for line in gpu_lines():
        print(line, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nccl "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))} devices "
          f"{[torch.cuda.get_device_name(i) for i in range(n)]}", flush=True)
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # every phase runs even where an earlier one failed; a failure fails
    # the script at the end, without the result line
    failed, res = {}, {}
    for name, fn in (("the four-card runs", lambda: drive_cards(device)),
                     ("the four-card rates", time_cards)):
        try:
            res[name] = fn()
        except Exception as e:
            traceback.print_exc()
            failed[name] = repr(e)[:500]
        phase(name + (" (failed)" if name in failed else ""))
    if failed:
        print(f"chip_smoke --cards {CARDS}: failed: {json.dumps(failed)}",
              file=sys.stderr, flush=True)
        return 1
    runs = res["the four-card runs"]
    print(gpu_line(), flush=True)    # again, beside the numbers it goes with
    print(json.dumps({"four_cards": {
        "bits": runs["bits"], "f32": runs["f32"],
        "rates_s": res["the four-card rates"]["seconds"]}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="the port's smoke run on the card")
    p.add_argument("--cards", type=int, choices=(1, CARDS), default=1,
                   help=f"{CARDS}: the NCCL phase alone (one rank a card)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.cards > 1:
        return main_cards()
    from dvdgan_tpu_torch.kernels import _build
    from dvdgan_tpu_torch.kernels import attention_spatial as k6
    from dvdgan_tpu_torch.ops import convgru
    from dvdgan_tpu_torch.utils.config import parse_config

    t_start = time.perf_counter()

    def phase(name: str) -> None:
        print(f"[{time.perf_counter() - t_start:7.1f} s] done: {name}",
              flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(gpu_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    rows = check_k1(device)
    graphs = check_graphs(device)
    phase("K1, and every kernel replayed from a CUDA graph")
    sample_run, sample_rate, clips_off = drive_sample(device)
    fp_sample, fp_rate, _ = drive_sample(device, (), FP_PRESET)
    print("sample_rate_fp_beside_ucf101_64 " + json.dumps(
        {"fp": fp_rate, "ucf101_64": sample_rate}), flush=True)
    phase("the sample CLI (ucf101_64, and DVD-GAN-FP at kinetics_64)")
    # K6's domain: P1 and P2 with the fused attention, P3 (FP at 128 px; its
    # f32 batch-2 clip card vs CPU at SAMPLE_TOL, as FP-64's)
    p_samples = {
        "p1": drive_sample(device, ON, P1_PRESET, P_SAMPLE_B["p1"], False),
        "p2": drive_sample(device, ON, P2_PRESET, P_SAMPLE_B["p2"], False),
        "p3": drive_sample(device, (), P3_PRESET, P_SAMPLE_B["p3"])}
    print("p_samples " + json.dumps({k: {"launches": v[0], "rate": v[1]}
                                     for k, v in p_samples.items()}),
          flush=True)
    phase("the sample CLI of P1 (ucf101_64 at ch 48), P2 (kinetics_128 at "
          "ch 96) with the fused attention, and P3 (DVD-GAN-FP at 128 px)")
    frames_tmp = tempfile.TemporaryDirectory()
    frames = write_frames(os.path.join(frames_tmp.name, "data"),
                          **FRAMES_SHAPE)
    frames_argv = FRAMES_ARGV + ["--data_path", frames]
    # every train CLI run of this script, side by side; this process hands
    # its cached blocks back first, for the children
    torch.cuda.empty_cache()
    train_runs = {
        **TRAINER_RUNS, **TRAINER_RUNS_K,
        "longclip": (LONG_ARGV, LONG_STEPS),
        "longclip_fused": (LONG_ARGV + FUSED, LONG_STEPS),
        "train_fused": (FLAGSHIP_ARGV + FUSED, TRAIN_STEPS),
        "px128": (PX128_ARGV, PX128_STEPS),
        "px128_on": (PX128_ARGV + ON, PX128_STEPS),
        "frames_k1": (frames_argv, FRAMES_STEPS),
        "frames_k2": (frames_argv + ["--steps_per_call", "2", "--log_step",
                                     "2"], FRAMES_STEPS)}
    with child_threads(len(train_runs)):
        runs = drive_trains(
            train_runs, {**TRAINER_RESUMES, **TRAINER_RESUMES_K, **FP_AFTER,
                         **EVAL_AFTER, **P_AFTER},
            TRAINER_KEEP + ("trainer_AK", "trainer_BK", "frames_k1",
                            "frames_k2", *FP_AFTER, *EVAL_AFTER))
    frames_tmp.cleanup()
    train_fused = runs["train_fused"]
    long_run, long_fused = runs["longclip"], runs["longclip_fused"]
    px_off, px_on = runs["px128"], runs["px128_on"]
    trainer_a = runs["trainer_A"]
    fp_k1, fp_k2 = runs["fp_k1"], runs["fp_k2"]
    p_runs = {name: runs[f"{name}_train"] for name in P_TRAIN}
    print("p_train_launches_per_step " + json.dumps(
        {k: v["per_step"] for k, v in p_runs.items()}), flush=True)
    check_k_runs(runs)
    check_eval_runs(runs)
    migrate_src = migration_source(trainer_a)
    check_trainer_runs(runs)
    phase("the train CLI runs (the trainer's, under --steps_per_call 2, on "
          "frame folders, the long clip, the 128 px step, DVD-GAN-FP, with "
          "--eval_step)")
    time_frames_loader()
    phase("the frames loader at UCF-101's frame size")
    # the migration's children from a thread, beside the evaluation's
    # (up to four and three at a time)
    migrate_pool = concurrent.futures.ThreadPoolExecutor(1)
    with child_threads(7):
        migrate_future = migrate_pool.submit(migration_children, migrate_src)
        evals = drive_eval(device)
        phase("the evaluation (--mode eval: i3d, c3d, cached, FP; the "
              "networks card vs CPU and timed; Trainer.evaluate() twice)")
        try:
            migration = migrate_future.result()
        finally:
            migrate_pool.shutdown()
            migrate_src["tmp"].cleanup()
    print(f"the migration: {migration['seconds']:.1f} s (export "
          f"{migration['export_s']:.1f}, import {migration['import_s']:.1f}, "
          f"samples {migration['sample_s']:.1f}, resume "
          f"{migration['resume']['cli_s']:.1f})", flush=True)
    phase("the migration to and from PyTorch state dicts (export, import, "
          "A's bits, the imported checkpoint sampled and resumed)")
    par = drive_parallel(device)
    phase("the parallel runs (two ranks on the card over gloo: DP2, DP2-B, "
          "CP2, the long clip's CP2, the f32 DP2 and CP2 against one "
          "process) and the flagship f32 step card vs CPU")
    # the serving artifacts' export and load children, from a thread,
    # beside this process's kernel checks and steps up to the remat
    # policies (beside the train, evaluation and parallel children they
    # outlasted them and slowed them: the CPU was busy)
    serving_tmp = tempfile.TemporaryDirectory()
    serving_pool = concurrent.futures.ThreadPoolExecutor(1)
    t_serving = time.perf_counter()
    serving_future = serving_pool.submit(serving_children, serving_tmp.name)
    rows_k2 = check_k2(device)
    phase("K2")
    time_train(device)
    phase("the flagship step's rate")
    check_train_f32(device, "fp f32", FP_F32)
    check_train_f32(device, "fp f32 per_step", FP_F32_PER_STEP)
    phase("the DVD-GAN-FP f32 steps, card vs CPU")
    check_draws(device)
    time_checkpoints(device)
    phase("the draws and the checkpoints")

    # the long-clip path
    rows_k3 = check_k3(device)
    k1_levels = [lv for lv in LONG_LEVELS
                 if not convgru.uses_blocked(*lv[:2])]
    rows_long = check_k1(device, k1_levels, LONG_T, LONG_B, reps=5)
    rows_long_fake = check_k1(device, k1_levels, LONG_T, LONG_B_FAKE, reps=3)
    on_path = [r for r in rows_k3
               if convgru.uses_blocked(*r["shape"][2:4])]
    rows_k3_path = [r for r in on_path if r["shape"][1] == LONG_B]
    rows_k3_fake = [r for r in on_path if r["shape"][1] == LONG_B_FAKE]
    rows_k2_long = check_k2(device, LONG_LEVELS, LONG_T, LONG_B, reps=5,
                            autograd=False)
    # the launches at the 4² and 8² long-clip levels, one at a time
    print("convgru_launch_device_us " + json.dumps(
        {f"{name} {r['shape'][2]}x{r['shape'][3]}x{r['shape'][4]} B "
         f"{r['shape'][1]}": r["launch_device_us"]
         for name, rows_of in (("K1", rows_long), ("K2", rows_k2_long))
         for r in rows_of
         if r["dtype"] == "bfloat16" and r["shape"][2] <= 8}), flush=True)
    res = check_train_f32(device, "long-clip-shaped f32", LONG_F32_ARGV)
    if res["k3_launches"] <= 0:
        raise AssertionError("the long-clip-shaped f32 step launched no K3")
    phase("the long-clip step")
    serving_runs = serving_future.result()
    serving_pool.shutdown()
    print(f"the serving artifacts' children: "
          f"{time.perf_counter() - t_serving:.1f} s from their start",
          flush=True)
    t0 = time.perf_counter()
    artifacts = check_artifacts(device, serving_runs)
    serving_rate = time_serving(device, serving_runs)
    serving_tmp.cleanup()
    print(f"the serving artifacts' checks in this process: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase("the serving artifacts' children and A1-A5 against eager "
          "step.sample, A1 and step.sample eager and graphed, the sample "
          "trace")
    t0 = time.perf_counter()
    remat_rows = check_remat_policies(device)
    print(f"the remat policies: {time.perf_counter() - t0:.1f} s",
          flush=True)
    phase("the long-clip step under each remat policy")

    # the fused-upsample route (K5a, K5b) and the single-step entry (K4)
    bf16, both = (torch.bfloat16,), (torch.float32, torch.bfloat16)
    k5a_flag, k5b_flag = check_k5(device, UPS_LEVELS, T * B_TRAIN, both)
    k5a_flag_fake, _ = check_k5(device, UPS_LEVELS, T * B, bf16, bwd=False)
    k5a_long, k5b_long = check_k5(device, LONG_UPS_LEVELS, LONG_T * LONG_B,
                                  both)
    k5a_long_fake, _ = check_k5(device, LONG_UPS_LEVELS,
                                LONG_T * LONG_B_FAKE, bf16, reps=3, bwd=False)
    k4_flag = check_k4(device, LEVELS, B)
    k4_long = check_k4(device, LONG_LEVELS, LONG_B)
    cell_launches = drive_cell(device)
    cell_launches_long = drive_cell(device, LONG_LEVELS, LONG_T, LONG_B)
    phase("K5a/K5b and K4 against their plain versions")

    # the fused spatial attention (K6a, K6b) and the 128 px path's GRU shapes
    def reps_k6(n):
        return 5 if n >= 192 else 10
    views = k6_views()
    rows_k6a = check_k6(device, "K6a", K6A_SHAPES, reps_k6, views)
    rows_k6b = check_k6(device, "K6b", K6B_SHAPES, reps_k6, views)
    rows_k6w = check_k6(device, "K6a wide", K6A_WIDE_SHAPES, reps_k6, views)
    rows_k6d = {group: check_k6(device, group, shapes, reps_k6, views)
                for group, shapes in K6_DOMAIN_SHAPES.items()}
    px_k1_levels = [lv for lv in PX128_LEVELS
                    if not convgru.uses_blocked(*lv[:2])]
    px_k3_levels = [lv for lv in PX128_LEVELS if convgru.uses_blocked(*lv[:2])]
    rows_px_k1 = check_k1(device, px_k1_levels, PX128_T, PX128_B, reps=3)
    rows_px_k1_fake = check_k1(device, px_k1_levels, PX128_T, PX128_B_FAKE,
                               reps=3)
    rows_px_k3 = check_k3(device, 3, px_k3_levels, PX128_T, PX128_B,
                          PX128_B_FAKE)
    rows_px_k2 = check_k2(device, PX128_LEVELS, PX128_T, PX128_B, reps=3,
                          autograd=False)
    phase("K6a/K6b and the 128 px GRU shapes against their plain versions")

    # sampling and the flagship step with both fused routes of G
    sample_fused, _, clips_fused = drive_sample(device, FUSED)
    gap = np.abs(clips_fused - clips_off)
    print(f"sample fused vs off (bf16, same z): max_abs {gap.max():.3e} "
          f"mean_abs {gap.mean():.3e} (limit {FUSED_CLIP_TOL})", flush=True)
    if not gap.max() <= FUSED_CLIP_TOL:
        raise AssertionError(f"the fused routes' clips differ from the "
                             f"unfused routes' by {gap.max()}")
    sample_route_gap(device)
    time_train(device, argv=FLAGSHIP_ARGV + FUSED, n_top=6)
    check_train_f32(device, "train f32 fused",
                    ("--preset", "ucf101_64", "--batch_size", "2",
                     "--d_steps", "1", *FUSED))
    phase("sampling and the flagship step with the fused routes")

    # the 128 px sample with its attention at 8² (C 512): K6a's wide body
    wide_off, _, clips_w_off = drive_sample(
        device, ["--attn_fused", "off"], PX128_ATTN8, PX128_ATTN8_B, False)
    wide_on, _, clips_w_on = drive_sample(device, ON, PX128_ATTN8,
                                          PX128_ATTN8_B, False)
    gap = np.abs(clips_w_on - clips_w_off)
    print(f"sample {' '.join(PX128_ATTN8)} attn on vs off (bf16, γ at its "
          f"zero init): max_abs {gap.max():.3e} (limit {ATTN_CLIP_TOL})",
          flush=True)
    if not gap.max() <= ATTN_CLIP_TOL:
        raise AssertionError(f"the wide K6a's clips differ from the unfused "
                             f"route's by {gap.max()}")
    if (wide_off["k6a"], wide_on["k6a"]) != (0, k6.LAUNCHES_PER_CALL):
        raise AssertionError(f"K6a launched {wide_off['k6a']} and "
                             f"{wide_on['k6a']} times in the off / on "
                             f"samples")
    wide_gap = sample_route_gap(device, PX128_ATTN8, PX128_ATTN8_B, False)
    phase("the 128 px sample with the 8×8 attention")

    # the routes in turns, in this one call
    keys = ("ups_fused", "attn_fused", "ms_per_step", "steps_per_s",
            "device_busy_ms_per_step", "ups2x_kernels_ms_per_step",
            "attn_kernels_ms_per_step", "softmax_kernels_ms_per_step",
            "peak_mem_gib")
    # (the profiler's view with a route's first reading only)
    # (cut to one reading a route, the first profiled, for the parallel
    # phase's room)
    long_rates = [
        time_train(device, "longclip_rate", LONG_ARGV + route, n_warm=1,
                   n_steps=2, n_prof=int(i == 0), n_top=15)
        for i, route in enumerate(([], ON))]
    print("longclip_pairs " + json.dumps(
        [{k: r.get(k) for k in keys} for r in long_rates]), flush=True)
    phase("the long-clip routes in turns")
    # (cut to one reading a route, each profiled, for the serving phase's
    # room)
    px_rates = [
        time_train(device, "px128_rate", PX128_ARGV + route, n_warm=1,
                   n_steps=2, n_prof=1, n_top=15)
        for route in ([], ON)]
    print("px128_pairs " + json.dumps(
        [{k: r.get(k) for k in keys} for r in px_rates]), flush=True)
    phase("the 128 px routes in turns")
    g_cfgs = {m: parse_config(["--preset", "ucf101_64", "--attn_fused", m]
                              ).g_config() for m in ("off", "on")}
    serve = [time_sample(device, g_cfgs[m])[0]
             for m in ("off", "on", "on", "off")]
    print("sample_pairs " + json.dumps(serve), flush=True)
    phase("sampling's routes in turns")
    # the trainer at steps_per_call 1 and K, in turns
    # (cut to 8 steps a flagship reading and 2 an FP and 128 px one, for
    # the room of K6's domain paths)
    for argv, k, n, name in ((FLAGSHIP_ARGV, 4, 8, "flagship"),
                             (FP_ARGV, 2, 2, "fp"),
                             (LONG_ARGV, 2, 2, "longclip"),
                             (PX128_ARGV, 2, 2, "px128")):
        time_steps_per_call(device, argv, k, n, f"steps_per_call_{name}")
        phase(f"the {name} trainer at steps_per_call 1 and {k} in turns")

    def entry(name, source, replaces, rows, by_path, per_step, also=(),
              **extra):
        """`by_path`: launches in each driven run; `per_step`: launches per
        train step (per call for the sample and cell entries). `also`: the
        same kernel's rows at the path's other batch; their
        errors count, their times are given apart. `library_ms` is the sum
        of the rows' where they have one (no single PyTorch call computes a
        GRU step or a T-step recurrence)."""
        bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
        also = [r for r in also if r["dtype"] == "bfloat16"]
        if also:
            extra["ms_fake_batch"] = sum(r["ms"] for r in also)
        library = [r["library_ms"] for r in bf16 if "library_ms" in r]
        by = {kind: sum(r["bound_ms"] for r in bf16 if r["bound_by"] == kind)
              for kind in ("operations", "bytes")}
        if all("tflops" in r for r in bf16):
            extra["tflops"] = (sum(r["tflops"] * r["ms"] for r in bf16)
                               / sum(r["ms"] for r in bf16))
        if library and len(library) == len(bf16):
            extra["vs_library"] = (sum(r["ms"] for r in bf16)
                                   / sum(library))
        if all(r.get("device_ms") is not None for r in bf16):
            extra["device_ms"] = sum(r["device_ms"] for r in bf16)
        return {"name": name, "route": "cuda",
                "source": f"dvdgan_tpu_torch/kernels/csrc/{source}",
                "replaces": f"dvdgan_tpu/kernels/{replaces}",
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "launches_per_step": per_step,
                "max_abs_err": max(r["max_abs_err"] for r in bf16 + also),
                "ms": sum(r["ms"] for r in bf16),
                "plain_ms": sum(r["plain_ms"] for r in bf16),
                "bound_ms": sum(r["bound_ms"] for r in bf16),
                # of a sum over levels: the kind that bounds most of it
                "bound_by": max(by, key=by.get),
                "library_ms": sum(library) if library else None, **extra}

    def k6_extra(rows):
        """K6's second bound (the logits at the 3×TF32 rate, the bf16
        kernel's own: `bound_ms` counts them at the f32 CUDA-core rate, as
        the f32-logit kernel's rows were counted) and its two launches' device µs, summed over the bf16
        calls; a launch's sum is None unless the profiler saw it in every
        call."""
        bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
        return {"bound_ms_tc": sum(r["bound_ms_tc"] for r in bf16),
                "bound_note": "bound_ms_tc is the bf16 kernel's bound; "
                              "bound_ms counts the logits at the f32 "
                              "CUDA-core rate, as the f32-logit "
                              "kernel's rows were counted",
                "launch_device_us": {
                    k: (sum(r["launch_device_us"][k] for r in bf16)
                        if all(k in r["launch_device_us"] for r in bf16)
                        else None)
                    for k in ATTN_KERNELS}}

    def k6_off_path(rows):
        """K6's bf16 rows at shapes no driven path gives it: each with
        its numbers, apart from the entry's sums."""
        keys = ("shape", "entry", "max_abs_err", "limit", "n_differ", "n",
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_ms_tc",
                "bound_by", "tflops", "plan", "launch_device_us")
        return [{k: r.get(k) for k in keys} for r in rows
                if r["dtype"] == "bfloat16"]

    def k4_extra(rows):
        """K4's launches alone (`kernel_ms`, back to back: a call's event
        ms holds the wrapper's host work) and, for its one-launch rows, K1's
        pair at the same shapes, wrapper and launches alone."""
        bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
        one = [r for r in bf16 if r["launches_per_call"] == 1]
        return {"kernel_ms": sum(r["kernel_ms"] for r in bf16),
                "one_launch_kernel_ms": sum(r["kernel_ms"] for r in one),
                "k1_pair_ms_one_launch_shapes": sum(r["k1_pair_ms"]
                                                    for r in one),
                "k1_pair_kernel_ms_one_launch_shapes": sum(
                    r["k1_pair_kernel_ms"] for r in one),
                "cluster": {"x".join(map(str, r["shape"][1:])): r["cluster"]
                            for r in one}}

    def k4_per_call(rows):
        return {"x".join(map(str, r["shape"][1:])): r["launches_per_call"]
                for r in rows if r["dtype"] == "bfloat16"}

    def par_paths(kernel, names):
        """A kernel's launches in the parallel runs, each rank's as it
        printed them."""
        return {f"{n}_rank{r}": c[kernel] for n in names
                for r, c in enumerate(par[n]["launches_by_rank"])}

    def par_per_step(kernel, names):
        """... and per step."""
        return {f"{n}_rank{r}": c[kernel] for n in names
                for r, c in enumerate(par[n]["launches_per_rank_step"])}

    def art_paths(kernel, names):
        """A kernel's launches in the artifacts' load children (every
        batch each served once)."""
        return {f"artifact_{n}": artifacts[n]["launches_per_call"][kernel]
                * artifacts[n]["calls"] for n in names}

    def art_per_call(kernel, names):
        """... and per sample call."""
        return {f"artifact_{n}": artifacts[n]["launches_per_call"][kernel]
                for n in names}

    def p_paths(kernel, names, sample=True):
        """A kernel's launches in K6's domain paths' sample CLI and train
        children."""
        out = {f"{n}_train": p_runs[n][kernel] for n in names}
        if sample:
            out.update({f"sample_{n}": p_samples[n][0][kernel]
                        for n in names})
        return out

    def p_per_step(kernel, names, sample=True):
        """... per train step (and per sample call)."""
        out = {f"{n}_train": p_runs[n]["per_step"][f"{kernel}_launches"]
               for n in names}
        if sample:
            out.update({f"sample_{n}": p_samples[n][0][kernel]
                        for n in names})
        return out

    flag_par = ("dp2", "dp2_b", "cp2", "dp2_f32", "cp2_f32")
    k1_src, k2_src, k5_src = ("convgru_seq.cu", "convgru_bwd.cu",
                              "ups2x_fused.cu")
    k1_at, k2_at = "convgru_seq.py:104", "convgru_bwd.py:194"
    long_shapes = "kinetics_256_48f levels, T=48, B=2"
    px_shapes = "kinetics_128 levels, T=12, B=8"
    kernels = [
        entry("convgru_seq (K1, bf16, sum of the 4 ucf101_64 levels, B=16)",
              k1_src, k1_at, rows,
              {"sample": sample_run["k1"], "sample_fused": sample_fused["k1"],
               "train_fused": train_fused["k1"], "trainer": trainer_a["k1"],
               "sample_fp": fp_sample["k1"], "fp": fp_k1["k1"],
               "fp_k2": fp_k2["k1"],
               **{f"eval_{name}": evals[name]["launches"]["k1"]
                  for name in ("i3d", "c3d", "i3d_cached", "fp")},
               **par_paths("k1", flag_par),
               **art_paths("k1", ("a1", "a2", "a4", "a5")),
               "sample_p1": p_samples["p1"][0]["k1"],
               "p1_train": p_runs["p1"]["k1"],
               "migrated_sample": migration["sample_launches"]["k1"],
               "migrated_resume": migration["resume"]["k1"]},
              {"sample": sample_run["k1"],
               "migrated_sample": migration["sample_launches"]["k1"],
               "migrated_resume": migration["resume"]["per_step"][
                   "k1_launches"],
               "p1_train": p_runs["p1"]["per_step"]["k1_launches"],
               "trainer": trainer_a["per_step"]["k1_launches"],
               **par_per_step("k1", ("dp2", "cp2")),
               "sample_fp": fp_sample["k1"],
               "fp": fp_k1["per_step"]["k1_launches"],
               "eval_batch_16": evals["i3d"]["k1_per_batch"],
               "eval_fp_batch_16": evals["fp"]["k1_per_batch"],
               **art_per_call("k1", ("a1", "a2", "a4", "a5"))},
              in_graph=graphs["K1"], remat_policies=remat_rows,
              serving_rate=serving_rate),
        entry(f"convgru_seq (K1, bf16, sum of its {len(k1_levels)} "
              f"{long_shapes})",
              k1_src, k1_at, rows_long,
              {"longclip": long_run["k1"],
               "longclip_fused": long_fused["k1"],
               **par_paths("k1", ("cp2_long",))},
              {"longclip": long_run["per_step"]["k1_launches"],
               **par_per_step("k1", ("cp2_long",))},
              also=rows_long_fake),
        entry("convgru_bwd (K2, bf16, sum of the 4 ucf101_64 levels, B=8)",
              k2_src, k2_at, rows_k2,
              {"sample": 0, "train_fused": train_fused["k2"],
               "trainer": trainer_a["k2"], "fp": fp_k1["k2"],
               "fp_k2": fp_k2["k2"], **par_paths("k2", flag_par),
               "p1_train": p_runs["p1"]["k2"],
               "migrated_resume": migration["resume"]["k2"]},
              {"trainer": trainer_a["per_step"]["k2_launches"],
               "migrated_resume": migration["resume"]["per_step"][
                   "k2_launches"],
               "p1_train": p_runs["p1"]["per_step"]["k2_launches"],
               **par_per_step("k2", ("dp2", "cp2")),
               "fp": fp_k1["per_step"]["k2_launches"]},
              in_graph=graphs["K2"]),
        entry(f"convgru_bwd (K2, bf16, sum of the 6 {long_shapes})",
              k2_src, k2_at, rows_k2_long,
              {"longclip": long_run["k2"], "longclip_fused": long_fused["k2"],
               **par_paths("k2", ("cp2_long",))},
              {"longclip": long_run["per_step"]["k2_launches"],
               **par_per_step("k2", ("cp2_long",))}),
        entry(f"convgru_blocked (K3, bf16, sum of its "
              f"{len(rows_k3_path) // 2} {long_shapes})",
              "convgru_blocked.cu", "convgru_blocked.py:182", rows_k3_path,
              {"longclip": long_run["k3"], "longclip_fused": long_fused["k3"],
               **par_paths("k3", ("cp2_long",))},
              {"longclip": long_run["per_step"]["k3_launches"],
               **par_per_step("k3", ("cp2_long",))},
              also=rows_k3_fake,
              k1_ms_same_shapes=sum(r["k1_ms"] for r in rows_k3_path
                                    if r["dtype"] == "bfloat16"),
              in_graph=graphs["K3"]),
        entry("convgru_cell (K4, bf16, one step at the 4 ucf101_64 levels, "
              "B=16: one cluster launch at 4x4 and 8x8, K1's pair above)",
              "convgru_cell.cu", "convgru_cell.py:162", k4_flag,
              {"cell_unroll": cell_launches}, k4_per_call(k4_flag),
              in_graph=graphs["K4"], **k4_extra(k4_flag)),
        entry("convgru_cell (K4, bf16, one step at the 6 kinetics_256_48f "
              "levels, B=2: one cluster launch at 4x4 and 8x8, K1's pair "
              "above)", "convgru_cell.cu", "convgru_cell.py:162",
              k4_long, {"cell_unroll": cell_launches_long},
              k4_per_call(k4_long), **k4_extra(k4_long)),
        entry("ups2x_fused fwd (K5a, bf16 on mma.sync, sum of the 4 "
              "ucf101_64 levels, N=128; fake pass and sampling N=256)", k5_src,
              "ups2x_fused.py:195", k5a_flag,
              {"sample_fused": sample_fused["k5a"],
               "train_fused": train_fused["k5a"], **art_paths("k5a", ("a2",))},
              {"sample_fused": sample_fused["k5a"],
               "train_fused": train_fused["per_step"]["k5a_launches"],
               **art_per_call("k5a", ("a2",))},
              also=k5a_flag_fake, in_graph=graphs["K5a"]),
        entry("ups2x_fused fwd (K5a, bf16 on mma.sync, sum of the 6 "
              "kinetics_256_48f levels, N=96; fake pass N=384)", k5_src,
              "ups2x_fused.py:195",
              k5a_long, {"longclip_fused": long_fused["k5a"]},
              {"longclip_fused": long_fused["per_step"]["k5a_launches"]},
              also=k5a_long_fake),
        entry("ups2x_fused bwd (K5b, bf16 on mma.sync, sum of the 4 "
              "ucf101_64 levels, N=128)", k5_src, "ups2x_fused.py:290",
              k5b_flag,
              {"train_fused": train_fused["k5b"]},
              {"train_fused": train_fused["per_step"]["k5b_launches"]},
              in_graph=graphs["K5b"]),
        entry("ups2x_fused bwd (K5b, bf16 on mma.sync, sum of the 6 "
              "kinetics_256_48f levels, N=96)", k5_src, "ups2x_fused.py:290",
              k5b_long,
              {"longclip_fused": long_fused["k5b"]},
              {"longclip_fused": long_fused["per_step"]["k5b_launches"]}),
        entry("attention_spatial (K6a, the fused entry, bf16, sum of its 4 "
              "calls: 32x32x64 at N=256 and 128, 32x32x256 at N=384 and 96)",
              "attention_spatial.cu", "attention_spatial.py:104", rows_k6a,
              {"sample_fused": sample_fused["k6a"], "train_fused": train_fused["k6a"],
               "longclip_fused": long_fused["k6a"],
               **art_paths("k6a", ("a2",))},
              {"sample_fused": sample_fused["k6a"],
               "train_fused": train_fused["per_step"]["k6a_launches"],
               "longclip_fused": long_fused["per_step"]["k6a_launches"],
               **art_per_call("k6a", ("a2",))},
              in_graph=graphs["K6a"],
              off_path=k6_off_path(rows_k6d["K6a 4x4"]
                                   + rows_k6d["K6a wide widths"]),
              off_path_in_graph=[graphs[f"{g} {h}x{w}x{c}"]
                                 for g in ("K6a 4x4", "K6a wide widths")
                                 for _, h, w, c in K6_DOMAIN_SHAPES[g]],
              **k6_extra(rows_k6a)),
        entry("attention_spatial (K6a, the fused entry, bf16, P1's call: "
              "32x32x96 at N=256, ucf101_64 --ch 48: c8 12, the weights "
              "zero-padded to 16)", "attention_spatial.cu",
              "attention_spatial.py:104", rows_k6d["K6a P1"],
              {"sample_p1": p_samples["p1"][0]["k6a"],
               "p1_train": p_runs["p1"]["k6a"]},
              {"sample_p1": p_samples["p1"][0]["k6a"],
               "p1_train": p_runs["p1"]["per_step"]["k6a_launches"]},
              in_graph=graphs["K6a P1 32x32x96"],
              **k6_extra(rows_k6d["K6a P1"])),
        entry("attention_spatial (K6a, the fused entry's wide sweep, bf16, "
              "P2's call: 32x32x384 at N=96, kinetics_128 --ch 96)",
              "attention_spatial.cu", "attention_spatial.py:104",
              rows_k6d["K6a P2"],
              {"sample_p2": p_samples["p2"][0]["k6a"],
               "p2_train": p_runs["p2"]["k6a"]},
              {"sample_p2": p_samples["p2"][0]["k6a"],
               "p2_train": p_runs["p2"]["per_step"]["k6a_launches"]},
              in_graph=graphs["K6a P2 32x32x384"],
              **k6_extra(rows_k6d["K6a P2"])),
        entry("attention_spatial (K6a, the fused entry's wide body, bf16, sum "
              "of its 2 calls: 8x8x512 at N=96 and 192, kinetics_128 "
              "--attn_res 8)", "attention_spatial.cu",
              "attention_spatial.py:104", rows_k6w,
              {"sample_px128_attn8_on": wide_on["k6a"],
               "sample_px128_attn8_gap": wide_gap["k6a_launches"]},
              {"sample_px128_attn8_on": wide_on["k6a"]},
              **k6_extra(rows_k6w)),
        entry("attention_spatial (K6b, the tiled entry, bf16, sum of its 2 "
              "calls: 64x64x64 at N=192 and 96)",
              "attention_spatial.cu", "attention_spatial.py:217", rows_k6b,
              {"px128_on": px_on["k6b"], **art_paths("k6b", ("a3",))},
              {"px128_on": px_on["per_step"]["k6b_launches"],
               **art_per_call("k6b", ("a3",))},
              in_graph=graphs["K6b"],
              off_path=k6_off_path(rows_k6d["K6b wide sweep"]),
              off_path_in_graph=[graphs[f"K6b wide sweep {h}x{w}x{c}"]
                                 for _, h, w, c in
                                 K6_DOMAIN_SHAPES["K6b wide sweep"]],
              **k6_extra(rows_k6b)),
        entry(f"convgru_seq (K1, bf16, sum of its {len(px_k1_levels)} "
              f"{px_shapes})", k1_src, k1_at, rows_px_k1,
              {"px128": px_off["k1"], "px128_on": px_on["k1"],
               **art_paths("k1", ("a3",)), **p_paths("k1", ("p2", "p3"))},
              {"px128": px_off["per_step"]["k1_launches"],
               **art_per_call("k1", ("a3",)),
               **p_per_step("k1", ("p2", "p3"))},
              also=rows_px_k1_fake),
        entry(f"convgru_bwd (K2, bf16, sum of the 5 {px_shapes})",
              k2_src, k2_at, rows_px_k2,
              {"px128": px_off["k2"], "px128_on": px_on["k2"],
               **p_paths("k2", ("p2", "p3"), sample=False)},
              {"px128": px_off["per_step"]["k2_launches"],
               **p_per_step("k2", ("p2", "p3"), sample=False)}),
        entry(f"convgru_blocked (K3, bf16, its {len(px_k3_levels)} "
              f"{px_shapes})", "convgru_blocked.cu", "convgru_blocked.py:182",
              [r for r in rows_px_k3 if r["shape"][1] == PX128_B],
              {"px128": px_off["k3"], "px128_on": px_on["k3"],
               **art_paths("k3", ("a3",)), **p_paths("k3", ("p2", "p3"))},
              {"px128": px_off["per_step"]["k3_launches"],
               **art_per_call("k3", ("a3",)),
               **p_per_step("k3", ("p2", "p3"))},
              also=[r for r in rows_px_k3 if r["shape"][1] == PX128_B_FAKE]),
    ]
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    if idle:
        raise AssertionError(f"kernels that no driven path launched: {idle}")
    print(gpu_line(), flush=True)    # again, beside the numbers it goes with
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
