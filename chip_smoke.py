#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rcgan_tpu_torch``) on one NVIDIA GPU.

Drives the port's four paths once at the flagship width
(``ResnetGANConfig()``: z_dim 128, dim_g 128, dim_d 128, embedding 300,
10 classes): the serving path (float32), the discriminator forward
(``rcgan_tpu_torch.entry.entry()`` and the CIFAR losses), the training
cycle (``CifarTrainer.step``: 1 G step + 5 critic steps) and the CIFAR app
around it (``rcgan_tpu_torch.apps.cifar_app.main``); then the MNIST stack
at the archived recipes' width (``DCGANConfig()``), the PGGAN family at its
app's default width (``apps/pggan_app.py``: 64x64, max_stage 4, dim 128)
and the CIFAR app's Inception-v3 scorer:

1. device check (CUDA required), card name and power limit, versions;
2. build of the hand-written kernels from the repo's sources (the six
   nvcc builds in parallel),
   with what ``ptxas -v`` reports for each CUDA kernel (registers, spills,
   static shared memory) and the dynamic shared memory each conv tile asks
   for; then the float32 policy: a float32 ``entry()`` built before any
   ``Sampler`` leaves cuDNN's TF32 off, and gives the same bits again after
   a ``Sampler`` was built; ``example_normal`` rows do not depend on the
   batch they are drawn in;
3. each kernel against its plain PyTorch version on the card, TF32 off:
   cond-BN (with and without its fused ReLU) and conv3x3 at every generator
   shape, and conv3x3 at every
   discriminator shape, batch 1, 8, 32, 64 and 100 (cond-BN and D also 128), float32
   and bfloat16, each call checked to have taken the route that
   ``conv3x3_variant`` names (``wgmma``: the tensor-core kernel; ``ffma``:
   the CUDA-core one, split-K at bucket 1; ``cudnn``: the ragged 3-channel
   convs); conv3x3 in bfloat16 at every G and D shape of the training
   cycle, batch 64 and 128, with forward and input-grad filters, likewise,
   and once at 8200 images of 32x32, more M tiles than a grid's y dimension
   holds; spectral norm as the path groups it (the 15 weights of a D pass
   in one launch, the projection embedding and the perm classifier alone)
   and on a group of ragged shapes, each also for the same bits on a second
   run; the all-label projection at batch 64 and 128 for the path's dtypes (all
   float32, all bfloat16) and one mix;
4. the serving slice: a seeded generator (or ``--checkpoint_dir``'s
   ``generator.npz``) behind ``Sampler`` and ``make_server``, concurrent
   ``/sample`` requests plus ``/healthz``, ``/models`` and ``/metrics``,
   with the kernels' launch counters read around that run, and the card's
   output held against the same generator run on the CPU;
5. medians of CUDA-event times: each kernel against its plain version,
   cond-BN (ReLU fused) per generator pass and bucket in CUDA graphs and
   issued alone beside its bound, the float32 G pass's convs per bucket in
   CUDA graphs (FFMA against cuDNN float32 and the bound, and the ragged
   call on cuDNN), the projection in
   CUDA graphs and issued alone against ``torch.addmm``, with a host-time
   breakdown of one projection call, the generator forward per bucket,
   ``/sample`` latency and its host stages at 100 images; and a
   ``torch.profiler`` trace of the forward at buckets 1 and 100 for the
   device's busy share and the time by kernel (at bucket 100 no ReLU
   kernel may remain: the generator's seven run inside cond-BN);
6. the discriminator slice at batch 64: ``entry()`` in float32 (against
   the same weights on the CPU, 1e-3 of the logits' scale) and bfloat16
   (finite, against the CPU's bfloat16 run, and far enough from float32 to
   show it computes in bf16); ``disc_loss`` for rcgan
   and rcgan-u and ``gen_loss`` for rcgan-u, forward under ``no_grad``,
   costs and spectral-norm ``u`` state against the CPU's; each path's
   launch counts asserted exactly, conv3x3's per route too (``entry()``
   bf16: 17 wgmma + 2 cudnn; sn: one launch per D pass and one per lone
   layer); then times of spectral norm per D pass (a group of 15 and a
   group of one) in CUDA graphs and issued alone, the projection,
   ``entry()`` and ``disc_loss``, and a profiler trace of ``entry()``;
7. the training slice: the conv3x3 and cond-BN autograd functions (input
   and weight grads, table grads; cond-BN with and without its ReLU)
   against autograd of their plain versions
   at every G and D shape of the cycle (batch 64 and 128, float32 and
   bfloat16); the dequantisation kernel bit for bit against its plain
   version (the same splitmix64 hash in int64 tensor ops) at batch 1, 64
   and 100, on the card and on the CPU, noise in [0, 1/128), rows that do
   not depend on the batch, other seeds other rows; its device time in CUDA
   graphs and issued alone against the plain version's; two cycles at
   batch 8 on the card against the CPU from
   the same weights and noise, float32, rcgan and rcgan-u (perm classifier,
   ``confuse_init``): Adam moments, parameters, SN ``u`` and costs (the
   check runs under PyTorch's deterministic algorithms, so it repeats from
   run to run, at five data seeds, ``CHECK_TRAIN["data_seeds"]``; the
   median and the max of each reading are held to 3x the spread that
   ``python3 -m rcgan_tpu_torch.diagnostics.sum_order --scan`` printed
   over nine arithmetics of the float32 kernels, ``TRAIN_SPREAD``); then
   ``bench.py``'s configuration (batch 64, bf16, n_critic 5,
   gen_bs_multiple 2) on a device-resident dataset of 50 000 images:
   launches per cycle asserted exactly (conv3x3 per route: rcgan 174
   wgmma + 14 cudnn; sn 12 per rcgan cycle, 28 per rcgan-u cycle with the
   perm classifier), cycles/s for rcgan and rcgan-u, a
   profiler breakdown of a cycle of each (device-busy share, top kernels,
   conv3x3, cuDNN's weight grads, Adam, sn, cond-BN), and an rcgan cycle's 3x3 convs
   timed by kind and route (forward and input grad through ``conv3x3``,
   on cuDNN in bf16 and on the plain version; weight grads), beside their
   bound at the H100's peaks and the share of it each reaches;
8. the CIFAR app at full width (bf16, batch 64, rcgan-u with the perm
   classifier and ``confuse_init``, so that all five kernels run) on
   synthetic data, under PyTorch's deterministic algorithms: 12 iterations
   in blocks of 4 with the inception score, the dev cost, the sample grid,
   the generated-label accuracy and checkpoints landing inside the run;
   launches asserted exactly for every cycle, every kernel launched, the
   run dir's files; then the same run killed by ``RCGAN_FAULT_AT_STEP`` at
   iteration 11 and restarted with ``--restore`` from checkpoint 9, whose
   final state must equal the uninterrupted run's bit for bit; the app's
   own timings (cycles/s, each eval, checkpoint save and restore);
9. the MNIST slice (the projection D with spectral norm and max-norm,
   rcgan-u with the perm classifier; the sn kernel is its only kernel):
   ``example_uniform`` on the card; sn against its plain version at
   MNIST's groups (a D pass's four convs, and ``concat_y``'s), the same
   bits twice, timed in CUDA graphs and issued alone beside the bound; two
   float32 ``MnistTrainer`` iterations on the card against the CPU from the
   same state over five data seeds, under deterministic algorithms, their
   spread printed and held to ``MNIST_SPREAD``; full width, bf16, batch 100,
   ``step_scan`` on the 70 000 synthetic digits resident on the card, 4 sn
   launches and nothing else asserted per iteration, iterations/s and a
   profiler breakdown; ``mnist_app.main`` with the rcgan-u recipe's flags
   cut to 100 iterations, its run dir, every iteration's launches, then the
   run restored without ``--train`` to the same bits and the same recovery;
   an MNIST ``Sampler`` on that checkpoint behind ``make_server``, card
   against CPU;
10. the PGGAN slice (conv3x3, cond-BN and sn at shapes no other path
   reaches): conv3x3 at every G and D map (8 to 64 pixels, C = O = 128,
   batch 64), forward and input grad, on wgmma in bf16 and FFMA in float32;
   cond-BN at every G map (4 to 64 pixels), with and without its ReLU, bf16
   and float32; sn at the stage-4 transition's group of 16 weights, the same
   bits twice; the 64x64 conv, cond-BN and that group timed in CUDA graphs
   beside their bounds; one iteration of each of the three phases of
   ``max_stage`` 2 at full width, float32, card against CPU from the same
   state over five data seeds under deterministic algorithms, the spread
   printed and held to ``PG_SPREAD``; full width, bf16, batch 64,
   ``max_stage`` 4, iterations in each of the 7 phases on 2 048 images
   resident on the card, each iteration's launches asserted exactly
   (``pggan_counts``: 18 conv3x3 on wgmma and 4 cond-BN per stage, 3 sn),
   ms per stage-4 iteration (stab and trans) and a profiler breakdown;
   ``train_progressive`` at full width, ``max_stage`` 2, crashed in phase 3
   by its data and resumed from the phase checkpoint to the uninterrupted
   run's bits; ``pggan_app.main`` at its defaults cut to 2 iterations a
   phase, the run's sn, cond-BN and wgmma launches (its training and its
   evals' generator passes), its rows, grids and checkpoints, then again
   with ``--resume`` (no step, the same rows); a PGGAN ``Sampler`` on that
   checkpoint, card against CPU at buckets 1 and 8, and over HTTP;
11. Inception-v3 (``evals/inception_v3.py``, cuDNN convs, no kernel of its
   own): ``random_weights(0)`` on the card against the CPU for 4 images, its
   time on 5 000 samples, and ``cifar_app.main`` with an
   ``inception_v3.npz`` in its own data dir, which must score with it;
12. data parallelism (``rcgan_tpu_torch/parallel/mesh.py``, no kernel of
   its own: the collectives are NCCL's or gloo's), in ranks that
   ``parallel.launch`` spawns: NCCL at world size 1 at ``bench.py``'s
   configuration (rcgan and rcgan-u, bf16, batch 64), two cycles through
   the group bit-equal to two without it under deterministic algorithms,
   each cycle's launches (``cycle_counts``) and its bytes all-reduced
   (every step's gradients and the state, exactly), ms per cycle and
   NCCL's share of a profiled cycle's device time (in this process); two
   gloo ranks sharing
   cuda:0 (NCCL refuses two ranks on one card), full width, float32, batch
   16 a rank: rcgan and rcgan-u two cycles, both ranks' whole states
   bit-equal, each rank's launches a cycle, finite costs, ms per cycle and
   the time inside the collectives; with ``normalization_g=False`` the
   two-rank run against the one-rank run on the same global batches, each
   cycle from one state under deterministic algorithms: the costs under
   JAX's tolerance, cycle 2's state under JAX's tolerances, cycle 1's (Adam
   from zero moments) under phase 7's iteration-1 maxima; the same for ``MnistTrainer``
   at ``DCGANConfig()``
   (bit-equal ranks, 4 sn launches an iteration, ``prob_real`` gathered);
   ``cifar_app.main`` in two gloo ranks on cuda:0 (rcgan-u with the perm
   classifier, ``--multi_gpu_multi_batch``: batch 64, 4 iterations, every
   eval once), one run dir, its checkpoints, bit-equal ranks, each cycle's
   launches; a CIFAR ``Sampler`` on that checkpoint, card against CPU and
   over HTTP.  Two ranks on one card check correctness; their times say
   nothing of scaling;
13. the compiled programs (``rcgan_tpu_torch/train/graphs.py``: each
   program captured once into a CUDA graph and replayed), each against its
   eager body (``graphs=False``) from the same start state under
   deterministic algorithms, every tensor of the state bit-equal (sha256)
   and the metrics too: ``CifarTrainer.step`` at ``bench.py``'s
   configuration (bf16, batch 64) for rcgan and rcgan-u, cycles 0 (eager:
   no G step), 1 (the warm-up before the capture), 2 and 3 (replays), each
   cycle's launches against ``cycle_counts``; ``step_scan`` over a block of
   8 cycles (one copy of the block, a replay per cycle) against eight
   eager cycles; ``MnistTrainer.step_scan`` at ``DCGANConfig()``, rcgan-u
   with the perm classifier, bf16, a block of 50 iterations, 4 sn launches
   each; the CIFAR ``Sampler`` at buckets 1, 8, 32 and 100, float32, the
   warm-up and a replay bit-equal to the eager pass, a replay's launches 6
   conv3x3 and 7 cond-BN.  Each program's ms per cycle, iteration or pass
   (CUDA events, median of 12), device busy ms (profiler), capture seconds
   and graph pool MB, eager against captured, also as the line
   ``{"compiled": ...}``.  The trainers and samplers of phases 4 to 10
   capture as well (by default on the card without a group), so their
   checks, launch counts and resumes hold the replays.

The line before the last is ``{"kernels": [...]}`` with all five kernels,
each with its bound (``bound_ms``, ``bound_by``) and the time of one
PyTorch call computing the same function where there is one
(``library_ms``); conv3x3's row is its FFMA kernel (``conv3x3.cu``) on the
six hand-written calls of a float32 generator pass at batch 100, as in
earlier runs, and adds the calls split by route (``variants``), each
kernel's own row (``by_variant``: wgmma on the rcgan cycle's bf16 convs,
ffma on that float32 pass in CUDA graphs), the cuDNN route's row
(``library_route``: the cycle's 14 ragged convs), the float32 pass per
bucket (``g_pass_f32``) and the cycle's bf16 convs together
(``cycle_bf16_ms``, ``cycle_bf16_plain_ms``, ``cycle_bf16_bound_ms``,
``cycle_bf16_library_ms``); the dequantisation's row is one call at
[64, 3072] in CUDA graphs, issued alone beside it; cond_bn's and sn's rows are device times in
CUDA graphs (a float32 generator pass's seven calls at batch 100 with the
ReLU fused; the two launches of a D pass), with the same calls issued
alone beside them (``alone_ms``, ``plain_alone_ms``), and sn's adds
MNIST's group (``mnist_group``); conv3x3's, cond_bn's and sn's rows add
``pggan``: the launches per iteration by stage and the times at PGGAN's
shapes (conv3x3's also the stage-4 iteration's times); the projection's
row adds its device time in CUDA graphs beside ``torch.addmm``'s;
the last line is ``{"ok": true, "device": {...}}``, printed only when every
phase passed.  Exits non-zero without a result when CUDA is unavailable or
any check fails.

    python3 chip_smoke.py [--checkpoint_dir DIR] [--seed 0]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import json
import math
import statistics
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib

BUCKETS = (1, 8, 32, 100)
KERNEL_BATCHES = (1, 8, 32, 64, 100)  # every serving bucket, and 64

# Generator shapes per pass (ResnetGANConfig() at batch B).
COND_BN_SHAPES = [(16, 1024), (64, 256), (64, 256), (256, 256), (256, 256),
                  (1024, 256), (1024, 256)]                      # (S, C) of [B, S, C]
CONV_SHAPES = [(8, 1024, 256), (8, 256, 256), (16, 256, 256), (16, 256, 256),
               (32, 256, 256), (32, 256, 256), (32, 256, 3)]     # (H=W, C, O)
# Discriminator shapes per D pass: the 12 3x3 convs, at batch 64 (entry(),
# one D pass of rcgan-u) and 128 (the concatenated real+fake pass).
D_CONV_SHAPES = [(32, 3, 128), (32, 128, 128), (16, 128, 128), (16, 128, 128)] \
    + [(8, 128, 128)] * 8
D_BATCHES = KERNEL_BATCHES + (128,)
D_TIMED_BATCHES = (64, 128)
# Spectral-norm weights [m, cout] per D call: 15 in D, the projection's
# D.Embedding_y, and the perm classifier's (checked, not on the timed pass).
SN_SHAPES = [(3, 128), (27, 128), (1152, 128), (128, 128), (1152, 128), (1152, 128)] \
    + [(1152, 128)] * 8 + [(128, 1), (300, 128)]
SN_EXTRA_SHAPES = [(3072, 10)]
# the groups the path launches: a D pass's 15 weights, D.Embedding_y alone,
# the perm classifier alone; and one of ragged shapes (a single element,
# fewer rows than the cluster has blocks, cout not a multiple of 4, cout
# above one pass-2 chunk, a row range longer than the shared tile)
SN_GROUPS = {"a D pass": SN_SHAPES[:-1], "D.Embedding_y": SN_SHAPES[-1:],
             "the perm classifier": SN_EXTRA_SHAPES,
             "ragged": [(1, 1), (5, 3), (40, 24), (7, 129), (9, 1), (33, 2000), (100000, 3),
                        (1152, 128)]}
PROJ_BATCHES = (64, 128)
# the projection's input dtypes (feat, emb, wgan): the path's (float32 in
# the losses' checks, bf16 in training) and one mix
PROJ_DTYPES = (("float32",) * 3, ("bfloat16",) * 3, ("bfloat16", "float32", "float16"))
# The H100 SXM's published peaks (dense): bf16 tensor cores, float32 on
# the CUDA cores, HBM3.  A kernel's bound is the larger of its operations
# over the peak for their type and its bytes (each input read once, each
# output written once) over the memory rate.
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
# 32-bit integer instructions: 64 lanes per SM, half the float32 lanes, on
# 132 SMs at the 1.98 GHz at which 128 float32 lanes give the 67 TFLOP/s
# above (two operations per FMA), so 16.7e12 per second.
PEAK_INT32 = 64 * 132 * 1.98e9
# The dequantisation's work per element in 32-bit instructions: two
# splitmix64 (a 64-bit add, three 64-bit shift-xors and two 64-bit
# multiplies by constants, about 20 instructions), the xor between them,
# the shift to the top 24 bits, two conversions to float and four float
# operations.
DEQUANT_OPS = 48
# Launches per path (perm classifier off): conv3x3 (hand-written kernels
# only), cond_bn, sn, projection.
# sn: one launch per D pass (its 15 layers are one group) and one per call
# of D.Embedding_y (once per ``projection(labels)``, once per
# ``all_label_logits``); cond_bn: one launch per call, seven calls per G pass.
PATH_COUNTS = {
    "entry() bfloat16": {"conv3x3": 17, "cond_bn": 7, "sn": 2, "projection": 0},
    "entry() float32": {"conv3x3": 17, "cond_bn": 7, "sn": 2, "projection": 0},
    "disc_loss rcgan": {"conv3x3": 17, "cond_bn": 7, "sn": 2, "projection": 0},
    "disc_loss rcgan-u": {"conv3x3": 28, "cond_bn": 7, "sn": 4, "projection": 1},
    "gen_loss rcgan-u": {"conv3x3": 17, "cond_bn": 7, "sn": 2, "projection": 1},
}
# conv3x3 per route on those paths: G's output conv (O = 3) and D's first
# (C = 3, once per D pass) on cuDNN; the rest on the tensor cores in bf16
# and on FFMA in float32 (the losses' check).
PATH_VARIANTS = {
    "entry() bfloat16": {"wgmma": 17, "ffma": 0, "cudnn": 2},
    "entry() float32": {"wgmma": 0, "ffma": 17, "cudnn": 2},
    "disc_loss rcgan": {"wgmma": 0, "ffma": 17, "cudnn": 2},
    "disc_loss rcgan-u": {"wgmma": 0, "ffma": 28, "cudnn": 3},
    "gen_loss rcgan-u": {"wgmma": 0, "ffma": 17, "cudnn": 2},
}

# Tolerances, |kernel - plain| <= atol * max|plain| + rtol * |plain|:
# - float32: the kernels and the plain versions sum in another order (up to
#   K = 9*1024 terms per conv output, B*S per cond-BN channel); that error
#   grows like sqrt(K) * 2^-24 * scale, ~6e-6 of the output's scale, so
#   1e-4 of the scale leaves a wide margin and rtol is 0.
# - bfloat16: both sides read the same bf16-rounded inputs and accumulate in
#   float32; the plain side stays in float32 while the kernel rounds its
#   output to bf16, which costs up to half a bf16 ulp, 2^-8 of |value|.
#   rtol 2^-7 is twice that; atol covers the summation order as in float32.
TOL = {"float32": (1e-4, 0.0), "bfloat16": (1e-4, 2.0 ** -7)}
# Whole generator on the card against the same weights on the CPU (plain
# versions), float32: seven convs and seven cond-BNs, each within its own
# tolerance, then tanh.  Outputs lie in [-1, 1].
SLICE_ATOL = 1e-3
# Spectral norm, float32: sums of at most 3072 terms in another order give
# ~sqrt(m) * 2^-24 ~ 3e-6 relative; W/sigma and u' within 1e-5 of their
# scale, sigma within 1e-5 relative.
SN_TOL = 1e-5
# Projection: float32 dots of 128 terms on float32 (or exactly widened
# bfloat16) inputs, float32 out: 1e-5 of the output's scale.
PROJ_TOL = 1e-5
# entry() on the card against the CPU, float32: 19 convs, 7 cond-BNs, 16
# spectral norms, each within its own tolerance; 1e-3 of max |logit|, as the
# generator check.
ENTRY_F32_TOL = 1e-3
# entry() in bfloat16, card against CPU: both sides round to bf16 at the
# same ops (every kernel and its plain version widen, sum in float32 and
# round once), so they differ only where a float32 sum in another order
# flips a bf16 rounding, by one ulp (2^-8 relative), which the ~40 layers
# of G and D carry forward.  Measured 6.2e-3 of max |logit| on an H100 at
# seed 0; 1.5e-2 is about 2.5x that.  A bound this loose would also pass a
# float32 forward with only its output cast, so the bf16 policy itself is
# checked against the card's float32 forward on the same weights: G's image
# and D's features must depart from their float32 values, in mean |diff|,
# by at least ENTRY_BF16_DRIFT times what rounding the float32 values to
# bf16 gives (measured 8.7x and 2.4x on an H100 at seed 0), and some logit
# must lie more than one bf16 ulp from its float32 value (measured 1.9),
# which rounding only the output (half an ulp at most) cannot do.  Nearness
# to the CPU's bf16 run is no test of the policy here: re-rounding at every
# layer turns each one-ulp flip between two correct bf16 runs into bf16
# noise downstream, so they end about half as far apart as bf16 is from
# float32.
ENTRY_BF16_TOL = 1.5e-2
ENTRY_BF16_DRIFT = {"image": 4.0, "feat": 1.5}
# Losses and SN state, card against CPU, float32: each logit within 1e-3 of
# the logits' scale and the losses are 1-Lipschitz means of them, so a cost
# within 1e-3 * (1 + |cost|); each u' is a unit vector from the same W and
# u by both sides (no activation enters it): within SN_TOL.
LOSS_TOL = 1e-3

# The training phase.  Kernel checks at the cycle's batches (64: each D
# step's G; 128: the G step's G and D, and rcgan's concatenated D pass).
TRAIN_BATCHES = (64, 128)
# A bf16 conv3x3 whose M tiles outnumber a grid's y dimension (65535).
BIG_M_BATCH = 8200
# Card against CPU, float32, TF32 off, with the same injected noise (numpy),
# two cycles (iteration 0 skips the G step), each from the same state (the
# card's, copied to the CPU bit for bit), rcgan and rcgan-u, over the data
# seeds ``seed + CHECK_TRAIN["data_seeds"]`` (every one checked; none
# chosen).  The check runs under PyTorch's deterministic algorithms
# (:func:`deterministic_algorithms`), so its readings repeat from run to
# run.  ``train_readings`` says what each reading is.  The readings are large
# for float32 because the gradients are ill-conditioned, not because the
# card is off: on the CPU alone, nudging every parameter by 1e-7 relative
# moves the G step's gradient by up to 2.0e-2 of a tensor's max (rcgan-u;
# 7.4e-3 for rcgan), and Adam's first, sign-like update turns rounding in
# near-zero gradients into +-lr steps that the next step sees; which
# readings sit on such a near-tie depends on the data and on the order in
# which the float32 kernels sum.  So TRAIN_SPREAD is the spread that
# ``python3 -m rcgan_tpu_torch.diagnostics.sum_order --scan`` printed on the
# card: per iteration, the median and the max of each reading over the two
# algorithms, the five data seeds and nine arithmetics of the float32
# kernels (the shipped ones, their plain versions, float64, other conv
# geometries), on an H100 80GB HBM3 at 700.00 W (the readings repeat bit
# for bit between calls under deterministic algorithms).  The check holds
# the median and the max of the shipped arithmetic's readings over the five
# data seeds to TRAIN_MARGIN times them, or, where that was 0, to
# TRAIN_MARGIN times the smallest nonzero value the reading can take: one
# parameter of the group for ``far``, and for ``dead`` the threshold that
# makes a tensor dead (:func:`train_limits`).
CHECK_TRAIN = {"batch": 8, "n_critic": 2, "gen_bs_multiple": 2,
               "data_seeds": (200, 201, 202, 203, 204)}
TRAIN_MARGIN = 3.0
TRAIN_SPREAD = {
    0: {"cost": (8.46e-08, 1.24e-06), "dead.disc": (0.0, 0.0), "far.disc": (0.00506, 0.0316),
        "mu.disc": (0.00668, 0.0108), "nu.disc": (0.00207, 0.00916),
        "params_max": (0.499, 0.684), "u": (1.42e-05, 0.000242)},
    1: {"cost": (3.76e-06, 2.49e-05), "dead.disc": (0.0, 5.96e-07),
        "dead.gen": (2.37e-08, 4.3e-08), "far.confusion": (0.0, 0.0),
        "far.disc": (0.225, 0.279), "far.gen": (0.000787, 0.00182),
        "mu.confusion": (1.86e-06, 4.11e-06), "mu.disc": (0.0199, 0.0589),
        "mu.gen": (0.0139, 0.0329), "nu.confusion": (3.44e-06, 8.19e-06),
        "nu.disc": (0.00821, 0.0163), "nu.gen": (0.00749, 0.0261),
        "params_max": (0.999, 1.04), "u": (5.71e-05, 0.000161)},
}
# a dead tensor's largest |mu| is under 1e-4 of its group's largest
DEAD_THRESHOLD = 1e-4


def train_limits(it: int, one_param: dict) -> dict:
    """``{reading: (median limit, max limit)}`` of the check's iteration
    ``it``; ``one_param`` is ``{"far.<group>": 1 / the group's size}``, the
    smallest nonzero ``far`` reading."""
    def floor(k):
        return DEAD_THRESHOLD if k.startswith("dead.") else one_param.get(k, 0.0)

    return {k: tuple(TRAIN_MARGIN * max(v, floor(k)) for v in spread)
            for k, spread in TRAIN_SPREAD.get(it, {}).items()}


def one_param_of(ts) -> dict:
    """One parameter's share of each group of ``ts``."""
    return {f"far.{g}": 1.0 / sum(p.numel() for p in ts.group_params(g)) for g in ts.groups}


# bench.py's configuration, timed: full width, batch 64, bf16, rcgan, hinge,
# n_critic 5, gen_bs_multiple 2, on a device-resident dataset of 50 000
# random uint8 images with one-coin alpha 0.6 labels.
TIMED_TRAIN = {"dataset": 50000, "batch": 64, "cycles": 12}

KERNEL_INFO = {
    "cond_bn": {"route": "cuda", "source": "rcgan_tpu_torch/csrc/cond_bn.cu",
                "replaces": "rcgan_tpu/ops/pallas/norm_kernel.py:123"},
    # the row's own numbers are the FFMA kernel's (a float32 generator
    # pass); each variant's are under by_variant, with its source
    "conv3x3": {"route": "cuda", "source": "rcgan_tpu_torch/csrc/conv3x3.cu",
                "replaces": "rcgan_tpu/ops/pallas/conv_kernel.py:101"},
    "sn": {"route": "cuda", "source": "rcgan_tpu_torch/csrc/sn.cu",
           "replaces": "rcgan_tpu/ops/pallas/sn_kernel.py:73"},
    "projection": {"route": "cuda", "source": "rcgan_tpu_torch/csrc/projection.cu",
                   "replaces": "rcgan_tpu/ops/pallas/projection_kernel.py:32"},
    "dequant": {"route": "cuda", "source": "rcgan_tpu_torch/csrc/dequant.cu",
                "replaces": "rcgan_tpu/ops/pallas/dequant_kernel.py:51"},
}
CONV_SOURCES = {"wgmma": "rcgan_tpu_torch/csrc/conv3x3_wgmma.cu",
                "ffma": "rcgan_tpu_torch/csrc/conv3x3.cu"}

failures: list = []


def check(ok: bool, what: str) -> bool:
    print(("ok   " if ok else "FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)
    return ok


def event_ms(torch, fn, reps: int = 30, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(torch, fn, calls: int = 10, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in a CUDA
    graph, the graph replayed ``reps`` times, median by CUDA events.  The
    host's cost of issuing each call is left out, which ``event_ms`` of a
    single eager call includes when the host is slower than the kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return statistics.median(times)


def device_profile(torch, fn, reps: int = 10):
    """(wall ms per call under the profiler, device ms per call, top kernels):
    a ``torch.profiler`` trace of ``reps`` calls after one warm-up.  The
    profiler's own host cost inflates the wall time, so the busy share it
    gives is a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    rows = [(e.self_device_time_total / 1e3 / reps, e.count // reps, e.key)
            for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(reverse=True)
    return wall, sum(r[0] for r in rows), rows


def print_breakdown(rows, kinds: dict, rest: str, per: float = 1) -> dict:
    """Prints a profile's device time (``device_profile``'s rows) by kind,
    per ``per`` calls: each kernel in the first kind one of whose keys
    (``kinds``: ``{label: keys}``) its name holds, lower case, and the rest.
    Returns ``{label: ms}``."""
    out, left = {}, list(rows)
    for label, keys in kinds.items():
        hit = [r for r in left if any(k in r[2].lower() for k in keys)]
        left = [r for r in left if r not in hit]
        out[label] = sum(r[0] for r in hit) / per
        print(f"    {label}: {out[label]:.3f} ms per iteration in "
              f"{sum(r[1] for r in hit) / per:g} launches", flush=True)
    print(f"    the rest ({rest}): {sum(r[0] for r in left) / per:.3f} ms per iteration in "
          f"{sum(r[1] for r in left) / per:g} launches", flush=True)
    return out


def compare(torch, got, ref, dtype_name: str):
    """(ok, max abs err, max rel err) under TOL[dtype_name]."""
    atol, rtol = TOL[dtype_name]
    got = got.float()
    err = (got - ref).abs()
    scale = max(ref.abs().max().item(), 1e-6)
    ok = bool(torch.isfinite(got).all()) and bool((err <= atol * scale + rtol * ref.abs()).all())
    rel = (err / (ref.abs() + 1e-3 * scale)).max().item()
    return ok, err.max().item(), rel


def bound(flops: float, nbytes: float, peak: float):
    """(least ms, what sets it) for work of ``flops`` operations at ``peak``
    and ``nbytes`` moved at the HBM rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv_work(b: int, hw: int, c: int, o: int, itemsize: int):
    """(operations, bytes) of a 3x3/SAME conv [b,hw,hw,c] x [3,3,c,o]."""
    return 2.0 * b * hw * hw * 9 * c * o, itemsize * (b * hw * hw * (c + o) + 9 * c * o)


def conv_bound(calls, itemsize: int, peak: float):
    """(least ms, what sets most of it) of the convs ``calls``, a list of
    ``(b, hw, c, o)``: the sum of each call's bound."""
    total = ops = 0.0
    for b, hw, c, o in calls:
        ms, by = bound(*conv_work(b, hw, c, o, itemsize), peak)
        total += ms
        ops += ms if by == "operations" else 0.0
    return total, ("operations" if 2 * ops >= total else "bytes")


def cudnn_conv(x, w):
    """The one PyTorch call for conv3x3: ``F.conv2d`` (cuDNN on the card) on
    NCHW views of NHWC ``x`` and HWIO ``w``."""
    import torch.nn.functional as F

    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)


def g_pass_conv_times(torch, inputs) -> dict:
    """Device time (``graph_ms``) of a float32 generator pass's 3x3 convs
    at each serving bucket, TF32 off, printed: the calls on the FFMA kernel
    against cuDNN float32 on the same calls (alternating: kernel, cuDNN,
    cuDNN, kernel; medians of each pair), beside their bound at the float32
    peak, and G's output conv (256 -> 3) on its cuDNN route.  Returns
    ``{bucket: {"kernel", "cudnn", "bound", "bound_by", "ragged",
    "ragged_bound", "n"}}``."""
    from rcgan_tpu_torch.ops.kernels.conv_kernel import conv3x3, conv3x3_variant

    out = {}
    print(f"  float32 G pass, 3x3 convs per bucket, device time in CUDA graphs (TF32 off; the "
          f"bound at {PEAK_F32 / 1e12:.0f} TFLOP/s):", flush=True)
    for b in BUCKETS:
        r = dict(kernel=0.0, cudnn=0.0, ragged=0.0, ragged_bound=0.0, n=0)
        calls = []
        for s_ in sorted(set(CONV_SHAPES)):
            mult = CONV_SHAPES.count(s_)
            x, w = inputs[("conv3x3", b, *s_)]
            with torch.no_grad():
                if conv3x3_variant(x.shape, s_[2], torch.float32) == "cudnn":
                    r["ragged"] += mult * graph_ms(torch, lambda: conv3x3(x, w))
                    r["ragged_bound"] += mult * bound(*conv_work(b, *s_, 4), PEAK_F32)[0]
                    continue
                tk, tc = paired_ms(torch, graph_ms, lambda: conv3x3(x, w),
                                   lambda: cudnn_conv(x, w))
            r["kernel"] += mult * tk
            r["cudnn"] += mult * tc
            r["n"] += mult
            calls += [(b, *s_)] * mult
        r["bound"], r["bound_by"] = conv_bound(calls, 4, PEAK_F32)
        out[b] = r
        print(f"    bucket {b}: {r['n']} FFMA calls {r['kernel']:.4f} ms vs cuDNN float32 "
              f"{r['cudnn']:.4f} ms ({r['kernel'] / r['cudnn']:.2f}x), bound {r['bound']:.4f} ms "
              f"({r['bound_by']}): kernel {r['bound'] / r['kernel']:.1%} of it, cuDNN "
              f"{r['bound'] / r['cudnn']:.1%}; G's output conv on cuDNN {r['ragged']:.4f} ms "
              f"(bound {r['ragged_bound']:.4f} ms)", flush=True)
    return out


def cond_bn_work(b: int, itemsize: int = 4):
    """(operations, bytes) of a generator pass's seven cond-BNs at batch
    ``b``: seven operations an element (moments 3, apply 4; the ReLU rides
    on the store); x read once and the output written once, the labels and
    both float32 tables read once."""
    ops = nbytes = 0
    for s_, c in COND_BN_SHAPES:
        n = b * s_ * c
        ops += 7 * n
        nbytes += itemsize * 2 * n + 8 * b + 4 * 2 * 10 * c
    return ops, nbytes


def cond_bn_times(torch, inputs) -> dict:
    """A float32 generator pass's seven cond-BNs, ReLU fused, at each
    serving bucket, printed: device time in CUDA graphs (``graph_ms``) of
    the kernel and of the plain version with its ReLU (alternating: kernel,
    plain, plain, kernel; medians of each pair), beside the bound.  Returns
    ``{bucket: {"kernel", "plain", "bound", "bound_by"}}``."""
    from rcgan_tpu_torch.ops.kernels.norm_kernel import cond_batchnorm, cond_batchnorm_plain

    out = {}
    print("  float32 G pass, 7 cond-BNs with the ReLU fused, per bucket, device time in CUDA "
          "graphs:", flush=True)
    for b in BUCKETS:
        r = dict(kernel=0.0, plain=0.0)
        for s_, c in sorted(set(COND_BN_SHAPES)):
            a = inputs[("cond_bn", b, s_, c)]
            with torch.no_grad():
                tk = graph_ms(torch, lambda: cond_batchnorm(*a, relu=True))
                tp = graph_ms(torch, lambda: cond_batchnorm_plain(*a, relu=True), calls=2, reps=3)
                tp2 = graph_ms(torch, lambda: cond_batchnorm_plain(*a, relu=True), calls=2, reps=3)
                tk2 = graph_ms(torch, lambda: cond_batchnorm(*a, relu=True))
            mult = COND_BN_SHAPES.count((s_, c))
            r["kernel"] += mult * statistics.median([tk, tk2])
            r["plain"] += mult * statistics.median([tp, tp2])
            if b == BUCKETS[-1]:
                print(f"    [{b},{s_},{c}] x{mult}: kernel {statistics.median([tk, tk2]):.4f} ms, "
                      f"plain {statistics.median([tp, tp2]):.4f} ms, bound "
                      f"{2 * 4 * b * s_ * c / PEAK_BYTES * 1e3:.4f} ms", flush=True)
        r["bound"], r["bound_by"] = bound(*cond_bn_work(b), PEAK_F32)
        out[b] = r
        print(f"    bucket {b}: kernel {r['kernel']:.4f} ms, plain {r['plain']:.4f} ms "
              f"({r['plain'] / r['kernel']:.1f}x), bound {r['bound']:.4f} ms ({r['bound_by']}): "
              f"kernel {r['bound'] / r['kernel']:.1%} of it", flush=True)
    return out


def projection_times(torch, args) -> dict:
    """The projection at ``args`` (float32 ``feat [64, 128]``, ``emb``,
    ``wgan``) against ``torch.addmm`` (cuBLAS), each timed two ways,
    alternating (kernel, addmm, addmm, kernel; medians of each pair):
    device time in CUDA graphs (``graph_ms``) and one call issued alone
    (``event_ms``, the host's cost included); then where the host time of
    one call goes (:func:`projection_host_breakdown`).  Returns
    ``{"graph", "addmm_graph", "alone", "addmm_alone", "host_us"}``."""
    from rcgan_tpu_torch.ops.kernels.projection_kernel import all_label_projection_logits

    feat, emb, wgan = args

    def kern():
        return all_label_projection_logits(feat, emb, wgan)

    def addmm():
        return torch.addmm(wgan, feat, emb.t())

    out = {}
    with torch.no_grad():
        for key, timer in (("graph", graph_ms), ("alone", event_ms)):
            out[key], out[f"addmm_{key}"] = paired_ms(torch, timer, kern, addmm)
    print(f"  projection [64,128]x[10,128] float32: device time in CUDA graphs {out['graph']:.4f} "
          f"ms vs torch.addmm {out['addmm_graph']:.4f} ms; issued alone (host included) "
          f"{out['alone']:.4f} ms vs torch.addmm {out['addmm_alone']:.4f} ms", flush=True)
    out["host_us"] = projection_host_breakdown(torch, feat, emb, wgan)
    return out


def projection_host_breakdown(torch, feat, emb, wgan, n: int = 2000) -> dict:
    """Host microseconds per projection call, no grad, by host clock over
    ``n`` calls each: the whole call (``ProjectionLogitsFn.apply``), the
    bare launch (``_launch``), and the launch's stages one at a time (the
    checks, the output's ``torch.empty``, the library's entry point, the
    current device and stream by ``runtime.on_device``'s raw lookups, the
    four ``data_ptr``s, the ``ctypes`` call itself, the launch count),
    beside the lookup the wrappers made before (``torch.cuda.device`` and
    ``torch.cuda.current_stream``).  Printed; returns ``{stage: us}``."""
    from rcgan_tpu_torch.ops.kernels import projection_kernel as pk
    from rcgan_tpu_torch.ops.kernels import runtime

    b, d = feat.shape
    v = emb.shape[0]
    out = torch.empty((b, v), dtype=torch.float32, device=feat.device)
    fn = runtime.cuda_library("projection").projection_logits
    stream = torch.cuda.current_stream().cuda_stream
    args = (feat.data_ptr(), 0, emb.data_ptr(), 0, wgan.data_ptr(), 0, out.data_ptr(), b, v, d,
            stream)

    def context_stream():
        with torch.cuda.device(feat.device):
            return torch.cuda.current_stream(feat.device).cuda_stream

    stages = {
        "whole call": lambda: pk.all_label_projection_logits(feat, emb, wgan),
        "bare launch": lambda: pk._launch(feat, emb, wgan),
        "checks": lambda: pk._check(feat, emb, wgan),
        "torch.empty": lambda: torch.empty((b, v), dtype=torch.float32, device=feat.device),
        "entry point": lambda: runtime.cuda_library("projection").projection_logits,
        "device and stream": lambda: torch._C._cuda_getCurrentRawStream(
            torch._C._cuda_getDevice()),
        "data_ptr x4": lambda: (feat.data_ptr(), emb.data_ptr(), wgan.data_ptr(), out.data_ptr()),
        "ctypes call": lambda: fn(*args),
        "launch count": lambda: runtime.count_launch("projection"),
        "former device and stream (context)": context_stream,
    }
    us = {}
    with torch.no_grad():
        for name, f in stages.items():
            f()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                f()
            us[name] = (time.perf_counter() - t) / n * 1e6
            torch.cuda.synchronize()
    print("  projection host time per call (us, host clock, mean of " + str(n) + "): "
          + ", ".join(f"{k} {v_:.2f}" for k, v_ in us.items()), flush=True)
    return us


def png_size(body: bytes):
    """(width, height) of a PNG after checking its signature, IHDR and that
    its IDAT data inflates to the size the header implies (8-bit RGB or
    grey)."""
    if body[:8] != b"\x89PNG\r\n\x1a\n" or body[12:16] != b"IHDR":
        raise ValueError("not a PNG")
    w, h = struct.unpack(">II", body[16:24])
    channels = {0: 1, 2: 3}[body[25]]
    pos, idat = 8, b""
    while pos < len(body):
        (n,) = struct.unpack(">I", body[pos:pos + 4])
        tag = body[pos + 4:pos + 8]
        if tag == b"IDAT":
            idat += body[pos + 8:pos + 8 + n]
        pos += 12 + n
    if len(zlib.decompress(idat)) != h * (1 + channels * w):
        raise ValueError("IDAT size does not match IHDR")
    return w, h


def paired_ms(torch, timer, f, g):
    """Medians of ``timer(torch, .)`` on ``f`` and on ``g``, run
    alternating (f, g, g, f), so a drift of the card's clock falls on both."""
    tf, tg, tg2, tf2 = (timer(torch, h) for h in (f, g, g, f))
    return statistics.median([tf, tf2]), statistics.median([tg, tg2])


def check_cond_bn(torch, x, labels, scale, offset, dtype_name: str, tag: str,
                  max_err: dict) -> None:
    """cond_bn on float32 ``x [B, S, C]`` cast to ``dtype_name``, without and
    with its ReLU, against the plain version: one launch a call, the input's
    dtype out, the same bits on two runs, nothing below 0 with the ReLU.
    The float32 calls' largest error goes to ``max_err["cond_bn"]``."""
    from rcgan_tpu_torch.ops.kernels import runtime
    from rcgan_tpu_torch.ops.kernels.norm_kernel import cond_batchnorm, cond_batchnorm_plain

    xd = x.to(getattr(torch, dtype_name))
    res = []
    with torch.no_grad():
        for relu in (False, True):
            before = runtime.launch_counts()["cond_bn"]
            got = cond_batchnorm(xd, labels, scale, offset, relu=relu)
            launched = runtime.launch_counts()["cond_bn"] - before
            again = cond_batchnorm(xd, labels, scale, offset, relu=relu)
            ref = cond_batchnorm_plain(xd.float(), labels, scale, offset, relu=relu)
            torch.cuda.synchronize()
            ok, err, rel = compare(torch, got, ref, dtype_name)
            res.append((ok and launched == 1 and got.dtype == xd.dtype and torch.equal(got, again)
                        and (not relu or got.min().item() >= 0.0), err, rel))
            if dtype_name == "float32":
                max_err["cond_bn"] = max(max_err["cond_bn"], err)
    check(all(r[0] for r in res),
          f"{tag} {list(x.shape)} {dtype_name}, one launch a call, the same bits on two runs: "
          f"max abs err {res[0][1]:.3e} (rel {res[0][2]:.3e}); with ReLU {res[1][1]:.3e} (rel "
          f"{res[1][2]:.3e})")


def check_conv3x3(torch, x, w, dtype_name: str, tag: str, max_err: dict, cotangent=None) -> str:
    """conv3x3 on float32 ``x [B, H, W, C]`` and ``w [3, 3, C, O]`` cast to
    ``dtype_name``, against the plain version, each call on the route that
    ``conv3x3_variant`` names and on no other; with ``cotangent`` (float32
    ``[B, H, W, O]``) also the backward: the input grad through conv3x3, the
    weight grad on cuDNN.  The forward's and the input grad's largest errors
    go to ``max_err`` by dtype and route.  Returns the forward's route."""
    from rcgan_tpu_torch.ops.kernels import runtime
    from rcgan_tpu_torch.ops.kernels.conv_kernel import (conv3x3, conv3x3_plain,
                                                         conv3x3_variant, ffma_geometry)

    dt = getattr(torch, dtype_name)
    c, o = w.shape[2], w.shape[3]
    routes = [conv3x3_variant(x.shape, o, dt)]
    xd, wd = x.detach().to(dt), w.detach().to(dt)
    before = runtime.variant_counts("conv3x3")
    if cotangent is None:
        got, ref = [conv3x3(xd, wd)], [conv3x3_plain(xd.float(), wd.float())]
    else:
        routes.append(conv3x3_variant((*x.shape[:3], o), c, dt))
        xd, wd = xd.requires_grad_(True), wd.requires_grad_(True)
        y = conv3x3(xd, wd)
        got = [y, *torch.autograd.grad(y, (xd, wd), cotangent.to(dt))]
        xr, wr = (t.detach().float().requires_grad_(True) for t in (xd, wd))
        y = conv3x3_plain(xr, wr)
        ref = [y, *torch.autograd.grad(y, (xr, wr), cotangent.to(dt).float())]
    ran = {k: n - before[k] for k, n in runtime.variant_counts("conv3x3").items()}
    torch.cuda.synchronize()
    res = [compare(torch, a, r.detach(), dtype_name) for a, r in zip(got, ref)]
    for route, (_, err, _) in zip(routes, res):
        if dtype_name == "bfloat16":
            max_err["conv3x3_bf16"][route] = max(max_err["conv3x3_bf16"][route], err)
        else:
            key = "conv3x3_cudnn" if route == "cudnn" else "conv3x3"
            max_err[key] = max(max_err[key], err)
    want = {v: routes.count(v) for v in ran}
    geo = ""
    if routes[0] == "ffma":
        geo = f" (bm, bn, splits) = {ffma_geometry(xd.shape, o, runtime.sm_count(xd))}"
    check(all(ok for ok, _, _ in res) and ran == want,
          f"{tag} [{','.join(map(str, x.shape))}]x[3,3,{c},{o}] {dtype_name} on {routes[0]}{geo} "
          f"(ran {ran}): "
          + ", ".join(f"{n} err {err:.3e} (rel {rel:.2e})"
                      for n, (_, err, rel) in zip(("y", "dx", "dw (cuDNN)"), res)))
    return routes[0]


def check_sn_group(torch, pairs, tag: str, max_err: dict) -> float:
    """The sn kernel on ``pairs`` (``[(w [M, O], u [1, O])]``, float32) in
    one launch against the plain version per weight, within SN_TOL of each
    output's scale, and the same bits on a second run (no atomics).
    Returns the largest abs error of W/sigma, also kept in ``max_err``."""
    from rcgan_tpu_torch.ops.kernels import runtime
    from rcgan_tpu_torch.ops.kernels.sn_kernel import sn_plain, spectral_norm_group

    with torch.no_grad():
        before = runtime.launch_counts()["sn"]
        got = spectral_norm_group(pairs)
        launched = runtime.launch_counts()["sn"] - before
        again = spectral_norm_group(pairs)
    torch.cuda.synchronize()
    worst, ok, err_abs = [0.0, 0.0, 0.0], launched == 1, 0.0
    for (w, u), g3, a3 in zip(pairs, got, again):
        for i, (g, a, r) in enumerate(zip(g3, a3, sn_plain(w, u))):
            scale = r.abs().max().item()
            err = (g - r).abs().max().item()
            ok = ok and bool(torch.isfinite(g).all()) and err <= SN_TOL * scale \
                and torch.equal(g, a) and g.shape == r.shape
            worst[i] = max(worst[i], err / scale)
            if i == 0:
                err_abs = max(err_abs, err)
    max_err["sn"] = max(max_err["sn"], err_abs)
    shapes = [tuple(w.shape) for w, _ in pairs]
    check(ok, f"sn group of {len(shapes)} ({tag}: {sorted(set(shapes))}) float32, {launched} "
              f"launch, the same bits on two runs: max err of scale W/sigma {worst[0]:.3e}, u' "
              f"{worst[1]:.3e}, sigma {worst[2]:.3e} (limit {SN_TOL})")
    return err_abs


def sn_group_times(torch, pairs) -> dict:
    """The sn kernel on ``pairs`` in one launch against the plain version
    per weight, each timed two ways (``paired_ms``): device time in CUDA
    graphs and issued alone (host included); beside the bound (5
    operations a weight entry, each weight and u read once, W/sigma, u'
    and sigma written once)."""
    from rcgan_tpu_torch.ops.kernels.sn_kernel import sn_plain, spectral_norm_group

    def group():
        with torch.no_grad():
            return spectral_norm_group(pairs)

    def plain():
        with torch.no_grad():
            return [sn_plain(w, u) for w, u in pairs]

    out = {}
    for key, timer in (("ms", graph_ms), ("alone_ms", event_ms)):
        out[key], out[f"plain_{key}"] = paired_ms(torch, timer, group, plain)
    shapes = [tuple(w.shape) for w, _ in pairs]
    out["bound_ms"], out["bound_by"] = bound(
        sum(5 * m * co for m, co in shapes),
        sum(4 * (2 * m * co + 2 * co + 1) for m, co in shapes), PEAK_F32)
    return out


def state_differences(torch, ts_a, ts_b):
    """``(compared, differ, same)`` of two train states on one device: the
    number of tensors compared (every group's parameters, the state, Adam's
    moments), the names of those that are not bit-equal, and whether the
    steps and Adam's counts agree.  Compared where they lie, with no copy."""
    from rcgan_tpu_torch.core.module import state_tree

    def flat(ts):
        out = [(f"{g}/{k}", p) for g, ps in ts.groups.items() for k, p in ps.items()]
        out += [(f"state {la}/{v}", t) for la, d in state_tree(ts.gan).items()
                for v, t in d.items()]
        out += [(f"{m} {g}/{k}", t) for g, st in ts.opt_states.items() for m in ("mu", "nu")
                for k, t in zip(ts.groups[g], getattr(st, m))]
        return out

    a, b = flat(ts_a), flat(ts_b)
    differ = [n for (n, x), (m, y) in zip(a, b) if n != m or not torch.equal(x, y)]
    same = ts_a.step == ts_b.step and len(a) == len(b) and all(
        st.count == ts_b.opt_states[g].count for g, st in ts_a.opt_states.items())
    return len(a), differ, same


def sampler_slice(torch, dev, model: str, ckpt: str, z_of, compare_ns, paths: dict,
                  tol: float, note: str) -> dict:
    """The ``model`` sampler on the checkpoint ``ckpt``: on the card against
    the CPU at each of ``compare_ns`` images (z from ``z_of(n)``, the labels
    0 to 9 in turn), within ``tol`` of the images' scale; then behind
    ``make_server``, where each of ``paths`` (``{path: images}``) must
    answer with a PNG grid of that many images (grey where the model's
    images are).  Returns the kernels' launches over the HTTP requests."""
    import numpy as np

    from rcgan_tpu_torch.ops.kernels import runtime
    from rcgan_tpu_torch.serving import Sampler, make_server

    name = model.upper() if model != "pggan" else "PGGAN"
    sampler = Sampler.from_checkpoint(model, ckpt, buckets=BUCKETS, device=dev)
    cpu = Sampler.from_checkpoint(model, ckpt, buckets=BUCKETS, device="cpu")
    for n in compare_ns:
        z, labels = z_of(n), np.arange(n) % 10
        on_card, on_cpu = sampler.sample_with_z(z, labels), cpu.sample_with_z(z, labels)
        err, scale = float(np.abs(on_card - on_cpu).max()), float(np.abs(on_cpu).max())
        check(on_card.shape == (n, *on_cpu.shape[1:]) and err <= tol * scale,
              f"{name} generator on the card vs on the CPU, {n} image(s) of "
              f"{list(on_cpu.shape[1:])}, float32, {note}: max abs err {err:.3e} (limit {tol} "
              f"of {scale:.3f})")
    hw, grey = on_cpu.shape[1], on_cpu.shape[3] == 1
    srv = make_server(sampler, port=0, host="127.0.0.1")
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    runtime.reset_launch_counts()
    try:
        for path, n in paths.items():
            t = time.perf_counter()
            with urllib.request.urlopen(url + path, timeout=300) as r:
                code, body = r.status, r.read()
            ms = (time.perf_counter() - t) * 1e3
            side = int(np.ceil(np.sqrt(n)))
            check(code == 200 and (body[25] == 0) == grey
                  and png_size(body) == (hw * side, hw * side),
                  f"{name} GET {path}: HTTP {code}, {'grey' if grey else 'RGB'} PNG "
                  f"{png_size(body)} in {ms:.1f} ms")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    return runtime.launch_counts()


def discriminator_slice(torch, dev, seed: int, max_err: dict):
    """Phase 6: the discriminator slice at full width, batch 64.  Returns the
    launches of each kernel summed over the slice's paths, conv3x3's by
    variant, and the times of spectral norm per D pass (``{"graph",
    "plain_graph", "alone", "plain_alone"}``)."""
    import numpy as np

    from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig, CifarGAN
    from rcgan_tpu_torch.core.module import scoped_modules, state_tree
    from rcgan_tpu_torch.entry import entry
    from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
    from rcgan_tpu_torch.ops.kernels import conv_kernel, runtime
    from rcgan_tpu_torch.ops.kernels.sn_kernel import sn_plain, spectral_norm_group

    batch = 64
    totals = {k: 0 for k in runtime.KERNELS}
    var_totals = dict.fromkeys(runtime.VARIANTS["conv3x3"], 0)

    def run_path(name, fn):
        """One run of a path on the card, its launches counted and checked."""
        runtime.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts, variants = runtime.launch_counts(), runtime.variant_counts("conv3x3")
        for k, v in counts.items():
            totals[k] += v
        for k, v in variants.items():
            var_totals[k] += v
        want = dict(PATH_COUNTS[name], dequant=0)
        check(counts == want and variants == PATH_VARIANTS[name],
              f"{name}: launches {counts}, conv3x3 by variant {variants} "
              f"(want {want}, {PATH_VARIANTS[name]})")
        return out

    # ---- entry(), float32 and bfloat16, each against the CPU on the same weights
    models, tensors = {}, {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        fwd, (z, labels) = entry(dev, dt, seed=seed)
        seen = {}
        hooks = [fwd.G.register_forward_hook(lambda m, a, o: seen.update(image=o.float())),
                 fwd.D.register_forward_hook(lambda m, a, o: seen.update(feat=o[0].float()))]
        out = run_path(f"entry() {dt_name}", lambda: fwd(z, labels))
        for h in hooks:
            h.remove()
        cpu = entry("cpu", dt, seed=seed)[0]
        cpu.load_state_dict({k: v.cpu() for k, v in fwd.state_dict().items()})
        ref = cpu(z.cpu(), labels.cpu()).float()
        got = out.float().cpu()
        err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        tol = ENTRY_F32_TOL if dt_name == "float32" else ENTRY_BF16_TOL
        check(out.shape == (batch,) and out.dtype == dt and bool(torch.isfinite(got).all())
              and err <= tol * scale,
              f"entry() {dt_name}, batch {batch}, card vs CPU: max abs err {err:.3e} "
              f"(limit {tol} of max |logit| {scale:.4f})")
        models[dt_name] = (fwd, z, labels)
        seen["logits"] = got
        tensors[dt_name] = seen
    # ---- the bf16 forward really computes in bf16
    same = all(torch.equal(a, b) for a, b in zip(models["float32"][0].state_dict().values(),
                                                 models["bfloat16"][0].state_dict().values()))
    check(same, "entry() float32 and bfloat16 hold the same weights")
    for key, factor in ENTRY_BF16_DRIFT.items():
        t16, t32 = tensors["bfloat16"][key], tensors["float32"][key]
        drift = (t16 - t32).abs().mean().item()
        cast = (t32.bfloat16().float() - t32).abs().mean().item()
        check(drift >= factor * cast,
              f"entry() bfloat16 {key} {tuple(t16.shape)}: mean |diff| to float32 {drift:.3e}, "
              f"{drift / cast:.2f}x that of float32 rounded to bf16 ({cast:.3e}; want >= {factor}x)")
    got16, got32 = tensors["bfloat16"]["logits"], tensors["float32"]["logits"]
    ulp = 2.0 ** (torch.floor(torch.log2(got32.abs().clamp_min(1e-30))) - 7)
    ulps = ((got16 - got32).abs() / ulp).max().item()
    check(ulps > 1.0, f"entry() bfloat16 on the card: largest gap to the float32 logits "
                      f"{ulps:.2f} bf16 ulps (want > 1: more than the output's rounding)")

    # ---- the losses, forward, card against CPU in float32: costs, logits, u state
    rng = np.random.default_rng(seed + 2)
    nb = {"real_data": rng.uniform(-1, 1, (batch, 3072)).astype(np.float32),
          "labels": rng.integers(0, 10, batch), "labels_random": rng.integers(0, 10, batch),
          "labels_biased": rng.integers(0, 10, batch),
          "labels_inv_weights": rng.uniform(-0.5, 1.5, (batch, 10)).astype(np.float32)}
    zn = rng.standard_normal((batch, 128)).astype(np.float32)
    c = np.full((10, 10), 0.4 / 9, np.float32)  # one-coin noise at 0.6
    np.fill_diagonal(c, 0.6)
    loss_gans = {}
    for alg, calls in (("rcgan", ("disc_loss",)), ("rcgan-u", ("disc_loss", "gen_loss"))):
        cfg, acfg = ResnetGANConfig(algorithm=alg), CifarAlgoConfig(algorithm=alg)
        gans = {"card": CifarGAN(cfg, acfg, seed, dev), "cpu": CifarGAN(cfg, acfg, seed, "cpu")}
        gans["cpu"].load_state_dict({k: v.cpu() for k, v in gans["card"].state_dict().items()})
        loss_gans[alg] = gans["card"]
        for call in calls:
            outs = {}
            for side in ("card", "cpu"):
                d = dev if side == "card" else torch.device("cpu")
                bt = {k: torch.from_numpy(v).to(d) for k, v in nb.items()}
                zt, ct, gan = torch.from_numpy(zn).to(d), torch.from_numpy(c).to(d), gans[side]

                def go():
                    with torch.no_grad():
                        if call == "disc_loss":
                            return gan.disc_loss(bt, zt, ct)
                        return gan.gen_loss(bt["labels_random"], bt["labels_biased"], zt, ct)

                outs[side] = run_path(f"{call} {alg}", go) if side == "card" else go()
            key = "disc_cost" if call == "disc_loss" else "gen_cost"
            got, ref = outs["card"][key].item(), outs["cpu"][key].item()
            check(math.isfinite(got) and abs(got - ref) <= LOSS_TOL * (1 + abs(ref)),
                  f"{call} {alg}, float32, card vs CPU: {key} {got:.6f} vs {ref:.6f}")
            for k in ("disc_real", "disc_fake") if call == "disc_loss" else ():
                g, r = outs["card"][k].cpu(), outs["cpu"][k]
                err, scale = (g - r).abs().max().item(), r.abs().max().item()
                check(err <= LOSS_TOL * scale, f"{call} {alg}: {k} max abs err {err:.3e} "
                                               f"(limit {LOSS_TOL} of {scale:.4f})")
            su, sc = state_tree(gans["card"]), state_tree(gans["cpu"])
            err = max((su[k]["u"].cpu() - sc[k]["u"]).abs().max().item() for k in sc)
            check(sorted(su) == sorted(sc) and len(sc) == 16 and err <= SN_TOL,
                  f"{call} {alg}: SN u state after the call, card vs CPU, {len(sc)} layers: "
                  f"max abs err {err:.3e} (limit {SN_TOL})")

    check(all(totals[k] > 0 for k in PATH_COUNTS["disc_loss rcgan-u"]),
          f"every kernel of the slice launched: {totals}")

    # ---- times
    fwd, z, labels = models["bfloat16"]
    sn_layers = [m for m in scoped_modules(fwd).values() if getattr(m, "spectral_normed", False)]
    pairs = []
    for m in sn_layers:
        w = (m.Filters if hasattr(m, "Filters") else m.W).detach().float()
        pairs.append((w.reshape(-1, w.shape[-1]).contiguous(), m.u))
    check(sorted(tuple(w.shape) for w, _ in pairs) == sorted(SN_SHAPES),
          f"the {len(pairs)} SN weights of a D pass have the shapes of SN_SHAPES")
    # as the path groups them: D's 15 layers in one launch, D.Embedding_y alone
    groups = [[p for p, m in zip(pairs, sn_layers) if m.scope != "D.Embedding_y"],
              [p for p, m in zip(pairs, sn_layers) if m.scope == "D.Embedding_y"]]
    check([len(g) for g in groups] == [15, 1], "D's SN layers: 15 in D and D.Embedding_y")

    def sn_pass():
        with torch.no_grad():
            return [spectral_norm_group(g) for g in groups]

    def sn_pass_plain():
        with torch.no_grad():
            return [[sn_plain(w, u) for w, u in g] for g in groups]

    runtime.reset_launch_counts()
    got, ref = sn_pass(), sn_pass_plain()
    torch.cuda.synchronize()
    err = max((a - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
              for gg, rg in zip(got, ref) for g3, r3 in zip(gg, rg) for a, r in zip(g3, r3))
    check(err <= SN_TOL and runtime.launch_counts()["sn"] == 2,
          f"sn on D's own 16 weights in {runtime.launch_counts()['sn']} launches, kernel vs "
          f"plain: max err {err:.2e} of scale (limit {SN_TOL})")

    print(f"D-slice times, batch {batch}: medians of CUDA events, TF32 off", flush=True)
    sn_ms = {}
    for key, timer in (("graph", graph_ms), ("alone", event_ms)):
        sn_ms[key], sn_ms[f"plain_{key}"] = paired_ms(torch, timer, sn_pass, sn_pass_plain)
    with torch.no_grad():
        t15 = graph_ms(torch, lambda: spectral_norm_group(groups[0]))
        t1 = graph_ms(torch, lambda: spectral_norm_group(groups[1]))
    print(f"  sn per D pass (16 weights in 2 launches): device time in CUDA graphs "
          f"{sn_ms['graph']:.4f} ms (the group of 15: {t15:.4f} ms, D.Embedding_y alone: "
          f"{t1:.4f} ms), plain {sn_ms['plain_graph']:.4f} ms; issued alone (host included) "
          f"{sn_ms['alone']:.4f} ms, plain {sn_ms['plain_alone']:.4f} ms", flush=True)
    for dt_name in ("bfloat16", "float32"):
        f, zz, ll = models[dt_name]
        ms = event_ms(torch, lambda: f(zz, ll), reps=20)
        print(f"  entry() forward, {dt_name}: {ms:.3f} ms ({batch / ms * 1e3:.1f} images/s)",
              flush=True)
    # the host's cost of the autograd function around a no-grad conv:
    # conv3x3 (through Conv3x3Fn) against the bare launch it wraps, D's 8x8
    # conv at batch 64 in bf16, alternating, each call issued alone
    xs = torch.randn(batch, 8, 8, 128, device=dev).to(torch.bfloat16)
    ws = (torch.randn(3, 3, 128, 128, device=dev) * 0.04).to(torch.bfloat16)
    via_fn, bare = [], []
    with torch.no_grad():
        for _ in range(3):
            via_fn.append(event_ms(torch, lambda: conv_kernel.conv3x3(xs, ws)))
            bare.append(event_ms(torch, lambda: conv_kernel._forward(xs, ws)))
    print(f"  conv3x3 [{batch},8,8,128]x[3,3,128,128] bf16, no grad, one call issued alone: "
          f"through Conv3x3Fn {statistics.median(via_fn) * 1e3:.1f} us, bare launch "
          f"{statistics.median(bare) * 1e3:.1f} us (medians of 3 alternating medians)", flush=True)
    bt = {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}
    zt = torch.from_numpy(zn).to(dev)
    for dt_name in ("bfloat16", "float32"):
        gan = CifarGAN(ResnetGANConfig(algorithm="rcgan-u"), CifarAlgoConfig(algorithm="rcgan-u"),
                       seed, dev, getattr(torch, dt_name))

        def d_step():
            with torch.no_grad():
                return gan.disc_loss(bt, zt)["disc_cost"]

        check(math.isfinite(d_step().item()), f"disc_loss rcgan-u {dt_name}: finite cost")
        ms = event_ms(torch, d_step, reps=20)
        print(f"  disc_loss rcgan-u forward, {dt_name}: {ms:.3f} ms", flush=True)
    wall, busy, rows = device_profile(torch, lambda: fwd(z, labels))
    print(f"  entry() bfloat16 profiled: {wall:.3f} ms per forward, device busy {busy:.3f} ms "
          f"({busy / wall:.0%}); by kernel:", flush=True)
    for t, n, name in rows[:8]:
        print(f"    {t:.4f} ms x{n} {name[:70]}", flush=True)
    return totals, var_totals, sn_ms


def cycle_counts(algorithm: str, perm: bool, n_critic: int, g_step: bool) -> dict:
    """Launches of each kernel in one training cycle, read from the code.
    A G forward runs 7 conv3x3 and 7 cond-BN (one launch each, its ReLU
    inside); a D pass 12 conv3x3 and one SN launch for its 15 layers, the
    projection head's D.Embedding_y one more SN launch per call, the perm
    classifier one.  The G step runs G then D on the fakes, and every conv
    of both needs its input grad (the fakes carry G's gradient); D's
    weights are frozen, so their SN has no backward.  A D step runs G
    frozen (no backward), then D on real and fake data: one pass on the
    concatenated batch, or two for rcgan-u (real alone, then fake against
    every label through the projection kernel), each taking input grads in
    all its convs but the first, whose input is data.  conv3x3 counts the
    hand-written kernels' launches only: the ragged convs
    (:func:`ragged_convs`) go to cuDNN."""
    g_conv, g_bn, d_conv, d_sn = 7, 7, 12, 1
    u = algorithm == "rcgan-u"
    counts = {"cond_bn": 0, "conv3x3": 0, "sn": 0, "projection": 0, "dequant": 0}
    if g_step:
        counts["conv3x3"] += 2 * (g_conv + d_conv)
        counts["cond_bn"] += g_bn
        counts["sn"] += d_sn + 1 + perm
        counts["projection"] += u
    passes = 2 if u else 1
    per_d_step = {"conv3x3": g_conv + passes * (2 * d_conv - 1), "cond_bn": g_bn,
                  "sn": passes * (d_sn + 1) + perm, "projection": int(u), "dequant": 1}
    for k, v in per_d_step.items():
        counts[k] += n_critic * v
    counts["conv3x3"] -= ragged_convs(algorithm, n_critic, g_step)
    return counts


def ragged_convs(algorithm: str, n_critic: int, g_step: bool) -> int:
    """3x3 convs of one training cycle with C or O = 3, which take the
    cuDNN route: G's output conv (O = 3) and D's first conv (C = 3), in the
    G step the forward and the input grad of each (4); in each critic step
    G's output conv once and D's first conv once per D pass (its input grad
    is not taken, its input being data)."""
    passes = 2 if algorithm == "rcgan-u" else 1
    return 4 * g_step + n_critic * (1 + passes)


def cycle_variants(algorithm: str, perm: bool, n_critic: int, g_step: bool) -> dict:
    """conv3x3 calls of one bf16 training cycle by route: the ragged ones
    on cuDNN, every other (C and O multiples of 64, maps that tile by 128
    pixels) on the tensor cores, none on FFMA."""
    return {"wgmma": cycle_counts(algorithm, perm, n_critic, g_step)["conv3x3"], "ffma": 0,
            "cudnn": ragged_convs(algorithm, n_critic, g_step)}


@contextlib.contextmanager
def deterministic_algorithms(torch):
    """PyTorch's deterministic algorithms for the block (warn only, so an op
    without one still runs), then the former setting.  The card-vs-CPU
    training check runs under it: eager PyTorch accumulates some gradients
    with atomics (``index_add_`` on the card, ``index_put_`` with
    duplicates on the CPU), whose order, and with it the check's
    iteration-1 readings, otherwise changes from run to run on both
    sides."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def check_train_feeds(seed: int, data_seed: int) -> list:
    """The data and noise of the card-vs-CPU training check: two cycles of
    ``(d_batches, g_labels, noise)`` at ``CHECK_TRAIN``'s sizes, drawn with
    numpy from ``seed + data_seed``."""
    import numpy as np

    b, nc, gm = CHECK_TRAIN["batch"], CHECK_TRAIN["n_critic"], CHECK_TRAIN["gen_bs_multiple"]
    rng = np.random.default_rng(seed + data_seed)
    feeds = []
    for _ in range(2):
        d = {"images": rng.integers(0, 256, (nc, b, 3072), dtype=np.uint8),
             "labels": rng.integers(0, 10, (nc, b)), "labels_random": rng.integers(0, 10, (nc, b)),
             "labels_biased": rng.integers(0, 10, (nc, b)),
             "labels_inv_weights": rng.uniform(-0.5, 1.5, (nc, b, 10)).astype(np.float32)}
        g = {"random": rng.integers(0, 10, gm * b), "biased": rng.integers(0, 10, gm * b)}
        noise = {"zg": rng.standard_normal((gm * b, 128)).astype(np.float32),
                 "z": rng.standard_normal((nc, b, 128)).astype(np.float32),
                 "u": (rng.random((nc, b, 3072)) / 128).astype(np.float32)}
        feeds.append((d, g, noise))
    return feeds


def check_spread(readings: dict, limits: dict, margin: float, what: str) -> None:
    """Readings of ``train_readings`` over the data seeds (``{reading:
    [(value, seed, where)]}``): the median and the max of each held to
    ``limits`` (``{reading: (median limit, max limit)}``), and every reading
    must have one; then the spread printed (min / median / max)."""
    worst = {k: max(vs) for k, vs in readings.items()}
    med = {k: statistics.median(v for v, _, _ in vs) for k, vs in readings.items()}
    check(bool(limits) and set(readings) <= set(limits) and all(
        med[k] <= limits[k][0] and v <= limits[k][1] for k, (v, _, _) in worst.items()),
          f"{what}: " + ", ".join(f"{k} median {med[k]:.3g} max {v:.3g} (seed {s}"
                                  f"{', at ' + w if w else ''}; limits {limits[k][0]:.3g}, "
                                  f"{limits[k][1]:.3g})"
                                  for k, (v, s, w) in sorted(worst.items()) if k in limits)
          + f"; readings without a limit: {sorted(set(readings) - set(limits))}")
    print(f"  spread (min / median / max; limits {margin}x the calibration median and max):",
          flush=True)
    for k, vs in sorted(readings.items()):
        vals = sorted(v for v, _, _ in vs)
        print(f"    {k}: {vals[0]:.3g} / {statistics.median(vals):.3g} / {vals[-1]:.3g}",
              flush=True)


def train_readings(np_ref, np_got, m_ref, m_got, lr: float, steps: dict,
                   cost_keys=("d_cost", "d_cost_mean", "g_cost")):
    """How far one train state is from another (``to_jax_train_state``
    layout): ``(readings, where)``, each reading the larger the worse and
    ``where`` naming the tensor behind each per-tensor one.  Per group that
    took ``steps[group]`` updates in the cycle, its tensors split into live
    and dead: a dead tensor's gradient is zero but for rounding (a conv
    bias that a batch-norm follows, rcgan-u's D.Output/b; largest |mu| on
    the CPU under 1e-4 of the group's largest), and Adam turns that noise
    into steps of +-lr with random signs.  Readings: ``mu.<group>`` and
    ``nu.<group>``, over the live tensors the worst max |diff| over the
    tensor's own max; ``dead.<group>``, the card's largest |mu| in a dead
    tensor over the group's largest (a dead tensor stays dead);
    ``far.<group>``, the share of the live tensors' parameters more than
    lr/100 apart; ``params_max``, the largest parameter gap of any tensor in
    units of 2·lr per update; ``u``, the SN ``u`` max abs error; ``stats``
    (where the state holds BN moving statistics), the worst max |diff| of
    one over its own max; ``cost``, each of ``cost_keys``' |diff| /
    (1 + |cost|)."""
    import numpy as np

    out, where = {"params_max": 0.0}, {}

    def worst(key, items):
        err, name = max(items)
        out[key], where[key] = float(err), name

    for g, (ref, _) in np_ref.opt_states.items():
        if not steps[g]:
            continue  # no step this cycle (the G and C groups at iteration 0)
        got = np_got.opt_states[g][0]
        gmax = max(np.abs(x).max() for d in ref.mu.values() for x in d.values())
        keys = [(la, v) for la, d in np_ref.groups[g].items() for v in d]
        live = [k for k in keys if np.abs(ref.mu[k[0]][k[1]]).max() > 1e-4 * gmax]
        dead = [k for k in keys if k not in live]
        for mom in ("mu", "nu"):
            a, b = getattr(got, mom), getattr(ref, mom)
            worst(f"{mom}.{g}", [(np.abs(a[la][v] - b[la][v]).max() / np.abs(b[la][v]).max(),
                                  f"{la}/{v}") for la, v in live])
        if dead:
            worst(f"dead.{g}", [(np.abs(got.mu[la][v]).max() / gmax, f"{la}/{v}")
                                for la, v in dead])
        diff = np.concatenate([np.abs(np_got.groups[g][la][v] - np_ref.groups[g][la][v]).ravel()
                               for la, v in live])
        out[f"far.{g}"] = float(np.mean(diff > lr / 100))
        full = max(np.abs(np_got.groups[g][la][v] - np_ref.groups[g][la][v]).max()
                   for la, v in keys)
        out["params_max"] = max(out["params_max"], float(full / (2 * lr * steps[g])))
    out["u"] = float(max(np.abs(np_got.state[la]["u"] - np_ref.state[la]["u"]).max()
                         for la, d in np_ref.state.items() if "u" in d))
    stats = [(la, v) for la, d in np_ref.state.items() for v in d if v != "u"]
    if stats:
        worst("stats", [(np.abs(np_got.state[la][v] - np_ref.state[la][v]).max()
                         / max(np.abs(np_ref.state[la][v]).max(), 1e-12), f"{la}/{v}")
                        for la, v in stats])
    out["cost"] = max(abs(float(m_got[k]) - float(m_ref[k])) / (1 + abs(float(m_ref[k])))
                      for k in cost_keys)
    return out, where


def training_slice(torch, dev, seed: int, card: str, max_err: dict):
    """Phase 7: the training cycle.  Returns a dict: the launches of each
    kernel over the timed configuration's counted cycles (``counts``),
    conv3x3's by variant (``variants``), the dequantisation's times at
    [64, 3072] (``dequant_ms``: kernel and plain, in CUDA graphs and issued
    alone) and the bytes it moves (``dequant_bytes``), and an rcgan cycle's
    conv times (``cycle_conv_times``).  The dequantisation's ``max_err`` is
    its largest difference from the plain version (0: bit for bit)."""
    import numpy as np

    from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
    from rcgan_tpu_torch.bridge import to_jax_train_state, train_state_from_jax
    from rcgan_tpu_torch.core import rng as trng
    from rcgan_tpu_torch.data.cifar10 import device_dataset_of
    from rcgan_tpu_torch.data.confusion import build_confusion, corrupt_dataset_numpy
    from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
    from rcgan_tpu_torch.ops.kernels import runtime
    from rcgan_tpu_torch.ops.kernels.conv_kernel import (conv3x3, conv3x3_plain,
                                                         conv3x3_weight_grad)
    from rcgan_tpu_torch.ops.kernels.dequant_kernel import (dequantize, dequantize_plain,
                                                            row_noise)
    from rcgan_tpu_torch.ops.kernels.norm_kernel import cond_batchnorm, cond_batchnorm_plain
    from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer

    gen = torch.Generator().manual_seed(seed + 7)
    c_mat, c_inv = build_confusion(0.6)

    # ---- Conv3x3Fn and CondBatchNormFn against autograd of the plain versions,
    # in float32 on the same inputs (bf16 rounded once, as TOL's forward checks)
    for tag, shapes in (("G", CONV_SHAPES), ("D", D_CONV_SHAPES)):
        for b in TRAIN_BATCHES:
            for hw, c, o in sorted(set(shapes)):
                x = torch.relu(torch.randn(b, hw, hw, c, generator=gen)).to(dev)
                w = (torch.randn(3, 3, c, o, generator=gen) * (2.0 / (9 * c)) ** 0.5).to(dev)
                g = torch.randn(b, hw, hw, o, generator=gen).to(dev)
                for dt_name in ("float32", "bfloat16"):
                    dt = getattr(torch, dt_name)
                    xd, wd = (t.to(dt).requires_grad_(True) for t in (x, w))
                    got = torch.autograd.grad(conv3x3(xd, wd), (xd, wd), g.to(dt))
                    # float32 math on the same (bf16-rounded) values, unrounded
                    xr, wr = (t.detach().float().requires_grad_(True) for t in (xd, wd))
                    ref = torch.autograd.grad(conv3x3_plain(xr, wr), (xr, wr), g.to(dt).float())
                    torch.cuda.synchronize()
                    res = [compare(torch, a, r.float(), dt_name) for a, r in zip(got, ref)]
                    check(all(ok for ok, _, _ in res) and all(a.dtype == dt for a in got),
                          f"conv3x3 grads {tag} [{b},{hw},{hw},{c}]x[3,3,{c},{o}] {dt_name}: "
                          f"dx err {res[0][1]:.3e} (rel {res[0][2]:.2e}), dw err {res[1][1]:.3e} "
                          f"(rel {res[1][2]:.2e})")
    for b in TRAIN_BATCHES:
        for s_, c in sorted(set(COND_BN_SHAPES)):
            x = (torch.randn(b, s_, c, generator=gen) * 2.0 + 0.5).to(dev)
            labels = torch.randint(0, 10, (b,), generator=gen).to(dev)
            tables = [(1.0 + 0.1 * torch.randn(10, c, generator=gen)).to(dev),
                      (0.1 * torch.randn(10, c, generator=gen)).to(dev)]
            g = torch.randn(b, s_, c, generator=gen).to(dev)
            for dt_name in ("float32", "bfloat16"):
                dt = getattr(torch, dt_name)
                for relu in (False, True):
                    ins = [x.to(dt).requires_grad_(True)] + [t.clone().requires_grad_(True)
                                                              for t in tables]
                    out = cond_batchnorm(ins[0], labels, *ins[1:], relu=relu)
                    got = torch.autograd.grad(out, ins, g.to(dt))
                    refs = [t.detach().float().requires_grad_(True) for t in ins]
                    # the ReLU's mask from the kernel's own output, so that an
                    # element within rounding of 0 takes the same side on both
                    ref_out = cond_batchnorm_plain(refs[0], labels, *refs[1:])
                    cot = g.to(dt).float() * (out > 0) if relu else g.to(dt).float()
                    ref = torch.autograd.grad(ref_out, refs, cot)
                    torch.cuda.synchronize()
                    res = [compare(torch, a, r.float(), dt_name) for a, r in zip(got, ref)]
                    check(all(ok for ok, _, _ in res),
                          f"cond_bn grads [{b},{s_},{c}] {dt_name}{' with ReLU' if relu else ''}: "
                          f"dx err {res[0][1]:.3e}, dscale {res[1][1]:.3e}, doffset "
                          f"{res[2][1]:.3e}")

    # ---- dequantisation: the kernel against its plain version (the same
    # hash in int64 tensor ops), bit for bit, on the card and on the CPU
    for b in (1, 64, 100):
        xb = torch.randint(0, 256, (b, 3072), generator=gen, dtype=torch.uint8).to(dev)
        sb = torch.from_numpy(trng.example_seeds(seed + b, b)).to(dev)
        got = dequantize(xb, sb)
        plain = dequantize_plain(xb, row_noise(sb, 3072))
        on_cpu = dequantize(xb.cpu(), sb.cpu())
        torch.cuda.synchronize()
        err = (got - plain).abs().max().item()
        max_err["dequant"] = max(max_err["dequant"], err)
        check(got.dtype == torch.float32 and got.shape == (b, 3072) and torch.equal(got, plain)
              and torch.equal(got.cpu(), on_cpu),
              f"dequant [{b},3072]: kernel bit-equal to its plain version on the card and on the "
              f"CPU (max abs err {err:.1e})")
    x = torch.randint(0, 256, (64, 3072), generator=gen, dtype=torch.uint8).to(dev)
    seeds = torch.from_numpy(trng.example_seeds(seed, 64)).to(dev)
    out = dequantize(x, seeds)
    base = dequantize_plain(x, torch.zeros(64, 3072, device=dev))
    noise = out.double() - base.double()
    at_top = noise == 1.0 / 128
    check(noise.min().item() >= 0.0 and noise.max().item() <= 1.0 / 128
          and bool((base[at_top].abs() >= 2.0 ** -7).all())
          and bool((noise[base == 0] < 1.0 / 128).all()),
          f"dequant [64,3072]: noise in [0, 1/128) ({noise.min().item() * 128:.6f} to "
          f"{noise.max().item() * 128:.6f} /128; {int(at_top.sum())} element(s) rounded up to "
          f"base + 1/128 by float32, all at |base| >= 2^-7; < 1/128 strictly where base = 0), "
          f"mean {noise.mean().item() * 256:.5f}/256")
    perm = torch.randperm(64, generator=gen).to(dev)
    check(torch.equal(dequantize(x[perm], seeds[perm]), out[perm])
          and torch.equal(dequantize(x[5:21].contiguous(), seeds[5:21].contiguous()), out[5:21]),
          "dequant: the same seeds give bit-identical rows in a permuted and a sliced batch")
    check(bool((dequantize(x, seeds + 1) != out).any(dim=1).all()),
          "dequant: other seeds give other rows")
    dequant_bytes = x.numel() * x.element_size() + seeds.numel() * seeds.element_size() \
        + out.numel() * out.element_size()

    def dq_plain():
        return dequantize_plain(x, row_noise(seeds, 3072))

    dq = {"graph": graph_ms(torch, lambda: dequantize(x, seeds), calls=20),
          "plain_graph": graph_ms(torch, dq_plain, calls=20),
          "alone": statistics.median([event_ms(torch, lambda: dequantize(x, seeds))
                                      for _ in range(2)]),
          "plain_alone": statistics.median([event_ms(torch, dq_plain) for _ in range(2)])}
    print(f"  dequant [64,3072]: kernel {dq['graph']:.4f} ms in CUDA graphs, {dq['alone']:.4f} "
          f"ms issued alone; plain (hash in int64 tensor ops) {dq['plain_graph']:.4f} ms in "
          f"graphs, {dq['plain_alone']:.4f} ms alone", flush=True)

    # ---- card against CPU, float32, TF32 off: two cycles from the same weights and noise,
    # under PyTorch's deterministic algorithms so that a reading repeats from run to run,
    # at each data seed; the spread of the readings held to train_limits
    b, nc, gm = CHECK_TRAIN["batch"], CHECK_TRAIN["n_critic"], CHECK_TRAIN["gen_bs_multiple"]
    tcfg = CifarTrainConfig(n_critic=nc, gen_bs_multiple=gm)
    readings = {0: {}, 1: {}}
    with deterministic_algorithms(torch):
        for alg, perm in (("rcgan", False), ("rcgan-u", True)):
            cfg = ResnetGANConfig(algorithm=alg)
            acfg = CifarAlgoConfig(algorithm=alg, perm_classifier=perm, confuse_init=perm)
            # the cycle's eager body on the card: each seed's two cycles
            # (iteration 0, then a first G step) run eagerly on a capturing
            # trainer too, and phase 13 holds the graphs to the eager body
            trainers = {side: CifarTrainer(cfg, acfg, tcfg, c_mat,
                                           dev if side == "card" else "cpu",
                                           graphs=False if side == "card" else None)
                        for side in ("card", "cpu")}
            for data_seed in CHECK_TRAIN["data_seeds"]:
                ts_card = trainers["card"].init(seed)
                one_param = one_param_of(ts_card)
                for it, (d, g, noise) in enumerate(check_train_feeds(seed, data_seed)):
                    # each cycle from one state: the card's, copied to the CPU
                    # (bit-exact), so that no earlier cycle's rounding is carried in
                    ts_cpu = train_state_from_jax(to_jax_train_state(ts_card), cfg, acfg, tcfg,
                                                  "cpu")
                    before = {k: st.count for k, st in ts_card.opt_states.items()}
                    ts_cpu, m_cpu = trainers["cpu"].step(ts_cpu, d, g, it, seed, noise=noise)
                    ts_card, m_card = trainers["card"].step(ts_card, d, g, it, seed, noise=noise)
                    steps = {k: st.count - before[k] for k, st in ts_card.opt_states.items()}
                    r, where = train_readings(to_jax_train_state(ts_cpu),
                                              to_jax_train_state(ts_card), m_cpu, m_card, tcfg.lr,
                                              steps)
                    for k, v in r.items():
                        readings[it].setdefault(k, []).append(
                            (v, f"{alg} {data_seed}", where.get(k, "")))
    for it in (0, 1):
        check_spread(readings[it], train_limits(it, one_param), TRAIN_MARGIN,
                     f"training rcgan and rcgan-u (perm+confuse_init), batch {b}, n_critic {nc}, "
                     f"float32, card vs CPU from the same state, cycle at iteration {it}, data "
                     f"seeds {seed} + {CHECK_TRAIN['data_seeds']}")

    # ---- bench.py's configuration on a device-resident dataset: counts, times, profile
    n = TIMED_TRAIN["dataset"]
    drs = np.random.RandomState(seed)
    y = drs.randint(0, 10, n)
    y_real, y_gen, y_fake, inv_w = corrupt_dataset_numpy(drs, y, c_mat, c_inv)
    ds = device_dataset_of({"images": drs.randint(0, 256, (n, 3072)).astype(np.uint8),
                            "labels": y_real, "labels_random": y_gen, "labels_biased": y_fake,
                            "labels_inv_weights": inv_w}, dev)
    mb = sum(v.numel() * v.element_size() for v in ds.values()) / 1e6
    print(f"device-resident dataset: N {n}, {mb:.1f} MB on the card", flush=True)
    tcfg = CifarTrainConfig()
    bt = TIMED_TRAIN["batch"]
    totals = {k: 0 for k in runtime.KERNELS}
    var_totals = dict.fromkeys(runtime.VARIANTS["conv3x3"], 0)
    for alg, perm in (("rcgan", False), ("rcgan-u", True)):
        acfg = CifarAlgoConfig(algorithm=alg, perm_classifier=perm, confuse_init=perm)
        tr = CifarTrainer(ResnetGANConfig(algorithm=alg), acfg, tcfg, c_mat, dev,
                          torch.bfloat16, ds)
        ts = tr.init(seed)
        state = {"ts": ts, "it": 0}

        def cycle():
            idx = drs.randint(0, n, (tcfg.n_critic, bt))
            gi = drs.randint(0, n, tcfg.gen_bs_multiple * bt)
            it = state["it"]
            state["ts"], m = tr.step(state["ts"], {"index": idx},
                                     {"random": y_gen[gi], "biased": y_fake[gi]}, it,
                                     trng.fold_in(seed, it))
            state["it"] += 1
            return m

        for it in range(2):  # iteration 0 (G skipped), then a full cycle
            runtime.reset_launch_counts()
            m = cycle()
            torch.cuda.synchronize()
            counts, variants = runtime.launch_counts(), runtime.variant_counts("conv3x3")
            want = cycle_counts(alg, perm, tcfg.n_critic, g_step=it > 0)
            want_v = cycle_variants(alg, perm, tcfg.n_critic, g_step=it > 0)
            for k, v in counts.items():
                totals[k] += v
            for k, v in variants.items():
                var_totals[k] += v
            check(counts == want and variants == want_v,
                  f"training {alg} bf16 batch {bt}, cycle at iteration {it}: launches {counts}, "
                  f"conv3x3 by variant {variants} (want {want}, {want_v})")
        ms = event_ms(torch, cycle, reps=TIMED_TRAIN["cycles"], warmup=2)
        m = cycle()
        finite = all(math.isfinite(float(v)) for v in m.values())
        finite = finite and all(bool(torch.isfinite(p).all()) for p in state["ts"].gan.parameters())
        check(finite, f"training {alg} bf16: costs and parameters finite after "
                      f"{state['it']} cycles (d_cost {float(m['d_cost']):.4f}, "
                      f"g_cost {float(m['g_cost']):.4f})")
        print(f"  training {alg}{' perm+confuse_init' if perm else ''}, bf16, batch {bt}, "
              f"n_critic {tcfg.n_critic}, gen_bs_multiple {tcfg.gen_bs_multiple}, on {card}: "
              f"{ms:.3f} ms per cycle ({1e3 / ms:.3f} cycles/s; median of "
              f"{TIMED_TRAIN['cycles']} cycles by CUDA events)", flush=True)
        wall, busy, rows = device_profile(torch, cycle, reps=3)
        print(f"  training {alg} profiled: {wall:.3f} ms per cycle, device busy {busy:.3f} ms "
              f"({busy / wall:.0%}); by kernel:", flush=True)
        for t, k, name in rows[:12]:
            print(f"    {t:.4f} ms x{k} {name[:90]}", flush=True)
        groups = {"conv3x3 (forward + input grad)": "conv3x3",
                  "weight grads (cuDNN kernels named *wgrad*)": "wgrad",
                  "Adam (foreach)": "multi_tensor_apply",
                  "sn (one launch per D pass and per lone layer)": "sn_group_kernel",
                  "cond-BN forward (ReLU fused)": "cond_bn_kernel"}
        for label, key in groups.items():
            hit = [r for r in rows if key in r[2]]
            print(f"    {label}: {sum(r[0] for r in hit):.3f} ms per cycle in "
                  f"{sum(r[1] for r in hit)} launches", flush=True)
        if alg == "rcgan":
            conv_ms = cycle_conv_times(torch, dev, gen, bt)
    return {"counts": totals, "variants": var_totals, "dequant_ms": dq,
            "dequant_bytes": dequant_bytes, "cycle_conv_times": conv_ms}


def cycle_conv_times(torch, dev, gen, b: int) -> dict:
    """Times of one rcgan cycle's 3x3 convs, bf16, summed with their
    multiplicities, and printed: per kind (forward, input grad) and per
    route, the device time (``graph_ms``) through ``conv3x3`` (the kernels,
    and cuDNN for the ragged convs), on cuDNN in bf16 (``F.conv2d`` on
    channels-last views) and on the plain version, beside their bound at
    the H100's bf16 peak; the time of each call issued alone from the host
    (``event_ms``: host cost included), ``conv3x3`` and cuDNN; the largest
    conv's rate; the weight grads (cuDNN).  Returns
    ``{"fwd"|"dx"|"wgmma"|"ffma"|"cudnn": {"kernel", "cudnn", "plain",
    "bound", "bound_ops", "eager", "eager_cudnn", "n"}, "dw": {"ms", "n"},
    "largest": (ms, flops)}``, where ``bound_ops`` sums the bounds of the
    calls that the operations, not the bytes, bound."""
    from rcgan_tpu_torch.ops.kernels.conv_kernel import (conv3x3, conv3x3_plain,
                                                         conv3x3_variant, conv3x3_weight_grad)

    # (batch, H=W, C, O) -> (forwards, input grads, weight grads) per cycle
    calls = {}

    def add(bb, hw, c, o, fwd, dx, dw):
        k = (bb, hw, c, o)
        old = calls.get(k, (0, 0, 0))
        calls[k] = (old[0] + fwd, old[1] + dx, old[2] + dw)

    for hw, c, o in CONV_SHAPES:  # G: the G step at 2B (grads), each D step at B
        add(2 * b, hw, c, o, 1, 1, 1)
        add(b, hw, c, o, 5, 0, 0)
    for i, (hw, c, o) in enumerate(D_CONV_SHAPES):  # D at 2B: G step, then 5 D steps
        add(2 * b, hw, c, o, 6, 1 + (5 if i else 0), 5)
    out = {k: dict(kernel=0.0, cudnn=0.0, plain=0.0, bound=0.0, bound_ops=0.0, eager=0.0,
                   eager_cudnn=0.0, n=0) for k in ("fwd", "dx", "wgmma", "ffma", "cudnn")}
    out["dw"] = {"ms": 0.0, "n": 0}
    out["largest"] = (0.0, 0.0)
    for (bb, hw, c, o), (nf, nd, nw) in calls.items():
        x = torch.randn(bb, hw, hw, c, generator=gen).to(dev, torch.bfloat16)
        w = (torch.randn(3, 3, c, o, generator=gen) * 0.05).to(dev, torch.bfloat16)
        g = torch.randn(bb, hw, hw, o, generator=gen).to(dev, torch.bfloat16)
        wt = torch.flip(w, (0, 1)).transpose(2, 3).contiguous()
        with torch.no_grad():
            for key, n_calls, args, (ci, co) in (("fwd", nf, (x, w), (c, o)),
                                                 ("dx", nd, (g, wt), (o, c))):
                if not n_calls:
                    continue
                bound_ms, bound_by = bound(*conv_work(bb, hw, ci, co, 2), PEAK_BF16)
                t = {"kernel": graph_ms(torch, lambda: conv3x3(*args)),
                     "cudnn": graph_ms(torch, lambda: cudnn_conv(*args)),
                     "plain": graph_ms(torch, lambda: conv3x3_plain(*args), calls=2, reps=3),
                     "bound": bound_ms,
                     "bound_ops": bound_ms if bound_by == "operations" else 0.0,
                     "eager": event_ms(torch, lambda: conv3x3(*args), reps=10),
                     "eager_cudnn": event_ms(torch, lambda: cudnn_conv(*args), reps=10)}
                variant = conv3x3_variant(args[0].shape, co, torch.bfloat16)
                for group in (key, variant):
                    for k, v in t.items():
                        out[group][k] += n_calls * v
                    out[group]["n"] += n_calls
                flops = conv_work(bb, hw, ci, co, 2)[0]
                if flops > out["largest"][1]:
                    out["largest"] = (t["kernel"], flops)
            if nw:
                out["dw"]["ms"] += nw * event_ms(torch, lambda: conv3x3_weight_grad(x, g), reps=10)
                out["dw"]["n"] += nw
    print(f"  per rcgan cycle, bf16, batch {b}: 3x3 convs by kind and route, device time "
          f"in CUDA graphs (conv3x3; cuDNN bf16; plain; the bound at {PEAK_BF16 / 1e12:.0f} "
          f"TFLOP/s, and the share of it each reaches), then each call issued alone (host "
          f"included)", flush=True)
    for label, key in (("forwards", "fwd"), ("input grads", "dx"),
                       ("tensor-core kernel (wgmma)", "wgmma"), ("FFMA kernel", "ffma"),
                       ("cuDNN route (ragged: C or O = 3)", "cudnn")):
        r = out[key]
        if not r["n"]:
            print(f"    {label}: no calls", flush=True)
            continue
        print(f"    {label} ({r['n']} calls): conv3x3 {r['kernel']:.3f} ms, cuDNN bf16 "
              f"{r['cudnn']:.3f} ms, plain {r['plain']:.3f} ms, bound {r['bound']:.3f} ms; share "
              f"of bound: conv3x3 {r['bound'] / r['kernel']:.1%}, cuDNN "
              f"{r['bound'] / r['cudnn']:.1%}; issued alone: conv3x3 {r['eager']:.3f} ms, cuDNN "
              f"{r['eager_cudnn']:.3f} ms", flush=True)
    k = out["fwd"]["kernel"] + out["dx"]["kernel"]
    c = out["fwd"]["cudnn"] + out["dx"]["cudnn"]
    bd = out["fwd"]["bound"] + out["dx"]["bound"]
    print(f"    forwards + input grads ({out['fwd']['n'] + out['dx']['n']} calls): conv3x3 "
          f"{k:.3f} ms vs cuDNN bf16 {c:.3f} ms ({k / c:.2f}x), bound {bd:.3f} ms: conv3x3 "
          f"{bd / k:.1%} of it, cuDNN {bd / c:.1%}", flush=True)
    ms, fl = out["largest"]
    print(f"    largest conv ({fl / 1e9:.1f} GFLOP): kernel {ms:.4f} ms, {fl / ms / 1e9:.1f} "
          f"TFLOP/s, {fl / ms / 1e9 / (PEAK_BF16 / 1e12):.1%} of peak", flush=True)
    print(f"    weight grads ({out['dw']['n']} calls, cuDNN): {out['dw']['ms']:.3f} ms", flush=True)
    return out


# Phase 8, the CIFAR app at full width on synthetic data.  The split holds 10
# batches of 64; each iteration takes 5 critic and 2 generator batches, so
# iteration 10 begins an epoch of both: a run resumed from checkpoint 9
# (whose batch iterators restart at position 0 of the split, as JAX's do)
# draws what the uninterrupted run drew from there.  Checkpoints land at 0,
# 3, 6 and 9, the inception score at 7, the dev cost, the sample grid and
# the generated-label accuracy at 5 and 11.
APP = {"niters": 12, "fault_at": 11, "resume_from": 9}
APP_FLAGS = ["--algorithm", "rcgan-u", "--alpha", "0.6", "--perm_classifier", "--confuse_init",
             "--perm_gen_label_acc", "--mesh_devices", "1", "--nomulti_gpu_multi_batch",
             "--synthetic_train_size", "640", "--eval_train_size", "2000",
             "--niters", str(APP["niters"]), "--scan_block", "4", "--ckpt_early_every", "3",
             "--sample_freq", "6", "--generated_label_accuracy_freq", "6"]


def app_slice(torch, seed: int, card: str) -> dict:
    """Phase 8: ``cifar_app.main`` on the card (module doc, item 8).
    Returns the launches of each kernel over the uninterrupted run
    (``counts``) and conv3x3's by variant (``variants``)."""
    import os
    import pickle
    import shutil

    import numpy as np

    from rcgan_tpu_torch.apps import cifar_app
    from rcgan_tpu_torch.ops.kernels import runtime
    from rcgan_tpu_torch.train.cifar_loop import CifarTrainer

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke_app")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    os.environ["RCGAN_SYNTH_CACHE"] = "0"
    os.environ.pop("RCGAN_FAULT_AT_STEP", None)

    def argv(expt, *extra):
        # a data dir that does not exist, inside the run's own ground: load()
        # takes the synthetic split whatever lies around the checkout
        return APP_FLAGS + ["--seed", str(seed), "--parent_dir", root, "--expt_dir", expt,
                            "--data_dir", os.path.join(root, "data"),
                            "--log_file", os.path.join(root, f"{expt}.log"), *extra]

    # every call's launches, counted around CifarTrainer.step and step_scan
    # (a block of cycles, each cycle a replay: the block's launches are its
    # cycles' summed), with the iterations of its cycles
    calls = []
    step, step_scan = CifarTrainer.step, CifarTrainer.step_scan

    def counting(fn, iterations):
        def run(self, ts, *args, **kwargs):
            its = iterations(ts, *args)
            before = runtime.launch_counts(), runtime.variant_counts("conv3x3")
            out = fn(self, ts, *args, **kwargs)
            after = runtime.launch_counts(), runtime.variant_counts("conv3x3")
            calls.append((its, {k: after[0][k] - before[0][k] for k in after[0]},
                          {k: after[1][k] - before[1][k] for k in after[1]}))
            return out
        return run

    def summed(table, its):
        return {k: sum(table("rcgan-u", True, 5, it > 0)[k] for it in its)
                for k in table("rcgan-u", True, 5, True)}

    stats, resumed_stats = {}, {}
    with deterministic_algorithms(torch):
        CifarTrainer.step = counting(step, lambda ts, d, g, iteration, *a: [iteration])
        CifarTrainer.step_scan = counting(
            step_scan, lambda ts, idx, *a: list(range(ts.step, ts.step + len(idx))))
        try:
            runtime.reset_launch_counts()
            t = time.perf_counter()
            whole, acc = cifar_app.main(argv("whole", "--inception_freq", "8"), device="cuda",
                                        stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts, variants = runtime.launch_counts(), runtime.variant_counts("conv3x3")
        finally:
            CifarTrainer.step, CifarTrainer.step_scan = step, step_scan
        os.environ["RCGAN_FAULT_AT_STEP"] = str(APP["fault_at"])
        try:
            cifar_app.main(argv("killed", "--inception_freq", "1000000"), device="cuda")
            killed = None
        except RuntimeError as e:
            killed = str(e)
        finally:
            os.environ.pop("RCGAN_FAULT_AT_STEP", None)
        ck = os.path.join(root, "killed", "checkpoint")
        left = sorted(int(n) for n in os.listdir(ck) if n.isdigit())
        t = time.perf_counter()
        resumed, _ = cifar_app.main(argv("killed", "--inception_freq", "1000000"),
                                    device="cuda", stats=resumed_stats)
        torch.cuda.synchronize()
        wall_resumed = time.perf_counter() - t

    cycles = [it for its, _, _ in calls for it in its]
    check(cycles == list(range(APP["niters"])) and all(
        c == summed(cycle_counts, its) and v == summed(cycle_variants, its)
        for its, c, v in calls),
          f"app rcgan-u bf16 batch 64: {len(cycles)} cycles in {len(calls)} calls (blocks of "
          f"{[len(its) for its, _, _ in calls]}), each call with its cycles' launches "
          f"(the last: {calls[-1][1] if calls else None}, conv3x3 by variant "
          f"{calls[-1][2] if calls else None})")
    check(all(counts[k] > 0 for k in runtime.KERNELS),
          f"app: every kernel launched over the run: {counts}, conv3x3 by variant {variants}")
    run = os.path.join(root, "whole")
    names = set(os.listdir(run))
    want = {"checkpoint", "samples_5.png", "samples_11.png", "log.pkl", "metrics.jsonl",
            "command.txt", "config.json", "scripts"}
    with open(os.path.join(run, "log.pkl"), "rb") as f:
        hist = pickle.load(f)
    text = open(os.path.join(root, "whole.log")).read()
    with open(os.path.join(run, "samples_11.png"), "rb") as f:
        grid = png_size(f.read())
    ckpts = sorted(int(n) for n in os.listdir(os.path.join(run, "checkpoint")) if n.isdigit())
    # each eval's value as the app's MetricLogger recorded it (one inception
    # score, two dev costs)
    score = max(hist.get("inception_50k", {}).values(), default=float("nan"))
    dev_costs = list(hist.get("dev_cost", {}).values())
    dev_cost = dev_costs[-1] if len(dev_costs) == 2 else float("nan")
    check(want <= names and ckpts == [0, 3, 6, 9] and grid == (320, 320)
          and 1.0 <= score <= 10.0 and math.isfinite(dev_cost) and 0.0 <= acc <= 1.0
          and all(math.isfinite(v) for v in hist["d_cost"].values())
          and "final generated label accuracy" in text and "learned-C recovery" in text,
          f"app run dir: {sorted(names & want)} (want {sorted(want)}), checkpoints {ckpts}, "
          f"sample grid {grid}, inception (stand-in) {score:.4f} at 7, dev cost {dev_cost:.4f} "
          f"at 11, final gen-label-acc {acc:.4f}, d_cost finite")
    compared, differ, same = state_differences(torch, whole, resumed)
    check(killed is not None and f"at step {APP['fault_at']}" in killed
          and left[-1] == APP["resume_from"] and not differ and same
          and resumed.step == APP["niters"]
          and f"restored from step {APP['resume_from'] + 1}" in open(
              os.path.join(root, "killed.log")).read(),
          f"app: killed at iteration {APP['fault_at']} ({killed}), checkpoints left {left}, "
          f"resumed from {APP['resume_from']}: {compared - len(differ)} of {compared} tensors, "
          f"the Adam counts and the step bit-equal to the uninterrupted run "
          f"(differ: {differ[:3]})")

    tr_s, tr_n = stats["train"]
    print(f"  app on {card}: {wall:.1f} s for the uninterrupted run ({tr_n} cycles in "
          f"{tr_s:.3f} s of blocks, {tr_n / tr_s:.3f} cycles/s, first block's warm-up "
          f"included); the resumed run {wall_resumed:.1f} s", flush=True)
    for k in ("data", "classifier", "inception", "dev_cost", "samples", "gen_label_acc",
              "checkpoint_save"):
        sec, n = stats.get(k, (float("nan"), 0))
        print(f"    {k}: {sec:.3f} s over {n} call(s) ({sec / max(n, 1):.3f} s each)", flush=True)
    sec, n = resumed_stats.get("restore", (float("nan"), 0))
    print(f"    restore: {sec:.3f} s ({n} call)", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return {"counts": counts, "variants": variants,
            "dequant_per_cycle": sum(c["dequant"] for _, c, _ in calls) / max(len(cycles), 1)}


# Phase 9, the MNIST slice at the archived recipes' configuration
# (``scripts/run_rcganu.sh``): ``DCGANConfig()`` at full width (batch 100,
# z 100, gf/df 64, gfc/dfc 1024, 28x28x1, 10 classes), the projection D with
# spectral norm and max-norm, alpha 0.3, hinge, bf16, rcgan-u (a learned C
# and the perm classifier).  The sn kernel is the path's only kernel: one
# group of D's four convs per D pass, four passes an iteration (the D
# step's real and fake passes, one fake pass per G step).
MNIST_SN_GROUPS = {"a projection D pass": [(25, 64)] + [(1600, 64)] * 3,
                   "concat_y at layer 1": [(275, 64)] + [(1600, 64)] * 3}
MNIST_PATH_COUNTS = {"sn": 4, "cond_bn": 0, "conv3x3": 0, "projection": 0, "dequant": 0}
MNIST_RECIPE = ["--algorithm", "rcgan", "--alpha", "0.3", "--disc_type", "projection",
                "--estimate_confuse", "--aux_classifier", "--noadd_noise", "--noconcat_y",
                "--spectral_norm", "--max_norm"]
# the app phase: 20 iterations an epoch, gen-label-acc and the learned-C
# report at epoch 4, 50 recovery steps on the reference's batch of 500
MNIST_APP = ["--train_size", "2000", "--epoch", "5", "--eval_train_size", "2000",
             "--recover_epoch", "50"]
# full width, bf16, batch 100, on the 70 000 synthetic digits resident on
# the card: blocks of 50 iterations, the first a warm-up
MNIST_TIMED = {"batch": 100, "block": 50, "blocks": 4}
# Card against CPU, float32, TF32 off, under deterministic algorithms: two
# iterations (iteration 1 starts from Adam moments that iteration 0 left),
# each from the card's state copied to the CPU bit for bit, with the same
# batch and z, at batch 16, over the data seeds ``seed + MNIST_CHECK["data_seeds"]``
# (every one checked; none chosen).  ``train_readings`` says what each
# reading is; ``stats`` reads the BN moving statistics.  MNIST_SPREAD is the
# spread that a calibration run printed (median, max over the five data
# seeds; H100 80GB HBM3 at 700.00 W; the readings repeat bit for bit between
# calls under deterministic algorithms).  Both the median and the max over
# the seeds are held to MNIST_MARGIN times their calibration value, or, where
# that was 0, to MNIST_MARGIN parameters of the group.  At iteration 0 one
# seed (304) sits on a near-tie: Adam's first steps (``g / (|g| + eps)``) on
# gradients that are zero but for rounding go apart there, so its maxima of
# the G and C moments (``mu.gen`` 0.374) bound little, and the medians carry
# the check; iteration 1, from the card's state, is within a few float32
# steps at every seed.
MNIST_CHECK = {"batch": 16, "data_seeds": (300, 301, 302, 303, 304)}
MNIST_MARGIN = 3.0
MNIST_SPREAD = {
    0: {"cost": (8.89e-08, 1.12e-05), "u": (2.19e-06, 1.47e-05), "stats": (2.93e-04, 7.64e-04),
        "params_max": (0.537, 1.02),
        "mu.disc": (1.08e-05, 3.9e-03), "nu.disc": (1.16e-05, 1.61e-03),
        "dead.disc": (8.85e-08, 1.72e-07), "far.disc": (2.2e-05, 3.15e-05),
        "mu.gen": (4.86e-03, 0.374), "nu.gen": (2.25e-03, 0.147),
        "dead.gen": (3.97e-08, 4.72e-08), "far.gen": (5.11e-03, 0.391),
        "mu.confusion": (7.18e-06, 7.24e-03), "nu.confusion": (7.42e-06, 2.31e-03),
        "far.confusion": (0.0, 0.21)},
    1: {"cost": (3.81e-08, 4.27e-08), "u": (7.45e-08, 8.94e-08), "stats": (1.46e-04, 1.64e-04),
        "params_max": (0.381, 0.41),
        "mu.disc": (6.37e-06, 9.98e-06), "nu.disc": (6.48e-06, 6.84e-06),
        "dead.disc": (1.26e-07, 1.58e-07), "far.disc": (0.0, 0.0),
        "mu.gen": (2.16e-06, 2.33e-06), "nu.gen": (2.05e-06, 2.42e-06),
        "dead.gen": (2.08e-08, 2.91e-08), "far.gen": (0.0, 2.83e-07),
        "mu.confusion": (1.86e-06, 2.54e-06), "nu.confusion": (1.18e-06, 2.3e-06),
        "far.confusion": (0.0, 0.0)},
}
# one parameter's share of its group at this width (318 059 in disc, 7 065 211
# in gen, 100 in confusion): the smallest nonzero ``far`` reading
MNIST_ONE_PARAM = {"far.disc": 1 / 318059, "far.gen": 1 / 7065211, "far.confusion": 1 / 100}


def mnist_train_limits(it: int) -> dict:
    """``{reading: (median limit, max limit)}`` of iteration ``it``."""
    return {k: tuple(MNIST_MARGIN * max(v, MNIST_ONE_PARAM.get(k, 0.0)) for v in spread)
            for k, spread in MNIST_SPREAD[it].items()}


MNIST_COST_KEYS = ("d_loss", "g_loss", "class_loss_real", "class_loss_fake")
# serving: the trained generator on the card against the same checkpoint on
# the CPU, float32, BN in inference mode, within 1e-4 of the images' scale
MNIST_SERVE_TOL = 1e-4


def mnist_check_feeds(seed: int, data_seed: int, b: int):
    """Two iterations' ``(batch, z)`` of the card-vs-CPU check, numpy from
    ``seed + data_seed``."""
    import numpy as np

    rng = np.random.default_rng(seed + data_seed)
    feeds = []
    for _ in range(2):
        batch = {"images": rng.random((b, 28, 28, 1), dtype=np.float32),
                 "y_real": rng.integers(0, 10, b), "y_gen": rng.integers(0, 10, b),
                 "y_fake": rng.integers(0, 10, b),
                 "y_real_weights": rng.uniform(-0.5, 1.5, (b, 10)).astype(np.float32)}
        feeds.append((batch, rng.uniform(-1, 1, (b, 100)).astype(np.float32)))
    return feeds


def mnist_slice(torch, dev, seed: int, card: str, max_err: dict) -> dict:
    """Phase 9: the MNIST slice on the card (module doc, item 9).  Returns
    the launches of each kernel over the timed full-width iterations and the
    app's training (``counts``) and the sn kernel's row for MNIST's group
    (``sn_group``)."""
    import os
    import pickle
    import shutil

    import numpy as np

    from rcgan_tpu_torch.algorithms.mnist import MnistAlgoConfig
    from rcgan_tpu_torch.apps import mnist_app
    from rcgan_tpu_torch.bridge import mnist_train_state_from_jax, to_jax_train_state
    from rcgan_tpu_torch.data.mnist import load_mnist
    from rcgan_tpu_torch.models.dcgan import DCGANConfig
    from rcgan_tpu_torch.ops.kernels import runtime
    from rcgan_tpu_torch.train.mnist_loop import MnistTrainConfig, MnistTrainer, dataset_to_device

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke_mnist")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    os.environ["RCGAN_SYNTH_CACHE"] = os.path.join(root, "synth")  # one render for the phase
    gen = torch.Generator().manual_seed(seed + 9)
    cfg = DCGANConfig(disc_type="projection")  # full width, the recipes' D
    acfg = MnistAlgoConfig(algorithm="rcgan", estimate_confuse=True, perm_regularizer=True)
    tcfg = MnistTrainConfig()

    # ---- z keyed per example on the card (U[-1, 1), the MNIST prior)
    from rcgan_tpu_torch.core import rng as trng

    zu = trng.example_uniform(seed + 13, 128, 100, dev, -1.0, 1.0)
    check(torch.equal(trng.example_uniform(seed + 13, 40, 100, dev, -1.0, 1.0, first_index=64),
                      zu[64:104])
          and torch.equal(zu.cpu(), trng.example_uniform(seed + 13, 128, 100, "cpu", -1.0, 1.0))
          and float(zu.min()) >= -1.0 and float(zu.max()) < 1.0,
          f"example_uniform on the card: rows independent of the batch, the CPU's bits, in "
          f"[-1, 1) (mean {zu.mean().item():.4f}, variance {zu.var().item():.4f})")

    # ---- the sn kernel against its plain version at MNIST's groups
    print(f"MNIST slice on {card}", flush=True)
    sn_rows = {}
    for tag, shapes in MNIST_SN_GROUPS.items():
        pairs = [((0.02 * torch.randn(m, cout, generator=gen)).to(dev),
                  torch.randn(1, cout, generator=gen).to(dev)) for m, cout in shapes]
        err_abs = check_sn_group(torch, pairs, f"MNIST {tag}", max_err)
        t = sn_group_times(torch, pairs)
        sn_rows[tag] = dict(shapes=shapes, max_abs_err=err_abs, **t)
        print(f"  sn {tag} {shapes}: kernel {t['ms']:.4f} ms in CUDA graphs, "
              f"{t['alone_ms']:.4f} ms issued alone; plain {t['plain_ms']:.4f} ms in graphs, "
              f"{t['plain_alone_ms']:.4f} ms alone; bound {t['bound_ms'] * 1e3:.3f} us "
              f"({t['bound_by']})", flush=True)

    # ---- card against CPU, float32, TF32 off: two iterations from one state
    b = MNIST_CHECK["batch"]
    small = DCGANConfig(disc_type="projection", batch_size=b)
    c_true = np.eye(10, dtype=np.float32)
    spread = {0: {}, 1: {}}
    with deterministic_algorithms(torch):
        trainers = {side: MnistTrainer(small, acfg, tcfg, c_true, device=side)
                    for side in (dev, "cpu")}
        for data_seed in MNIST_CHECK["data_seeds"]:
            ts_card = trainers[dev].init(seed + data_seed)
            for it, (batch, z) in enumerate(mnist_check_feeds(seed, data_seed, b)):
                ts_cpu = mnist_train_state_from_jax(to_jax_train_state(ts_card), small, acfg,
                                                    tcfg, "cpu")
                ts_cpu, m_cpu = trainers["cpu"].step(ts_cpu, batch, 0, z=z)
                ts_card, m_card = trainers[dev].step(ts_card, batch, 0, z=z)
                r, where = train_readings(to_jax_train_state(ts_cpu), to_jax_train_state(ts_card),
                                          m_cpu, m_card, tcfg.learning_rate,
                                          {"disc": 1, "gen": 2, "confusion": 2},
                                          cost_keys=MNIST_COST_KEYS)
                for k, v in r.items():
                    spread[it].setdefault(k, []).append((v, data_seed, where.get(k)))
    for it, readings in spread.items():
        check_spread(readings, mnist_train_limits(it), MNIST_MARGIN,
                     f"MNIST training rcgan-u + perm, batch {b}, iteration {it}, float32, card vs "
                     f"CPU from the same state over data seeds {list(MNIST_CHECK['data_seeds'])}")

    # ---- full width, bf16, batch 100, on the resident dataset: launches, times, profile
    t = time.perf_counter()
    data = load_mnist(os.path.join(root, "data"), 0.3, seed=547)
    data_s = time.perf_counter() - t
    ds = dataset_to_device(data, len(data), dev)
    mb = sum(v.numel() * v.element_size() for v in ds.values()) / 1e6
    print(f"  MNIST: {len(data)} synthetic digits, {mb:.1f} MB resident on the card (load "
          f"{data_s:.2f} s)", flush=True)
    bt, blk = MNIST_TIMED["batch"], MNIST_TIMED["block"]
    trainer = MnistTrainer(cfg, acfg, tcfg, data.confusion, device=dev,
                           compute_dtype=torch.bfloat16)
    state = {"ts": trainer.init(seed), "pos": 0}

    def block(k=blk):
        n_b = len(data) // bt
        rows = [(state["pos"] + j) % n_b for j in range(k)]
        idx = np.stack([np.arange(r * bt, (r + 1) * bt) for r in rows])
        state["pos"] += k
        state["ts"], ms = trainer.step_scan(state["ts"], ds, idx, seed)
        return ms

    counts = {k: 0 for k in runtime.KERNELS}
    times = []
    for i in range(MNIST_TIMED["blocks"]):
        runtime.reset_launch_counts()
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        ms = block()
        e.record()
        e.synchronize()
        got = runtime.launch_counts()
        want = {k: v * blk for k, v in MNIST_PATH_COUNTS.items()}
        for k, v in got.items():
            counts[k] += v
        check(got == want, f"MNIST bf16 batch {bt}, block {i} of {blk} iterations: launches "
                           f"{got} (want {want}: 4 sn launches per iteration, nothing else)")
        if i:
            times.append(a.elapsed_time(e))
    finite = all(bool(torch.isfinite(v).all()) for v in ms.values()) and all(
        bool(torch.isfinite(p).all()) for p in state["ts"].gan.parameters())
    check(finite, f"MNIST bf16: losses and parameters finite after {state['ts'].step} "
                  f"iterations (d_loss {float(ms['d_loss'][-1]):.4f}, g_loss "
                  f"{float(ms['g_loss'][-1]):.4f})")
    it_ms = statistics.median(times) / blk
    sn_per_iteration = counts["sn"] / (MNIST_TIMED["blocks"] * blk)  # measured, not the table
    print(f"  MNIST training rcgan-u + perm, bf16, batch {bt}, on {card}: {it_ms:.3f} ms per "
          f"iteration ({1e3 / it_ms:.2f} iterations/s; median of {len(times)} blocks of {blk} "
          f"by CUDA events, warm-up block left out)", flush=True)
    wall, busy, rows = device_profile(torch, lambda: block(10), reps=2)
    print(f"  MNIST training profiled: {wall / 10:.3f} ms per iteration, device busy "
          f"{busy / 10:.3f} ms ({busy / wall:.0%}); by kernel, per iteration:", flush=True)
    for tk, n, name in rows[:12]:
        print(f"    {tk / 10:.4f} ms x{n / 10:g} {name[:90]}", flush=True)
    print_breakdown(rows, {"sn (one launch per D pass)": ("sn_group_kernel",),
                           "cuDNN convs and transposed convs (fprop, dgrad, wgrad)": (
                               "conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit_gemm"),
                           "Adam (foreach)": ("multi_tensor_apply",),
                           "matmuls (cuBLAS)": ("gemm", "gemv", "cutlass", "xmma")},
                    "elementwise, reductions, copies", per=10)

    # ---- the app: the rcgan-u recipe cut down, then restored to recover again
    app_root = os.path.join(root, "app")
    argv = MNIST_RECIPE + MNIST_APP + ["--checkpoint_dir", app_root,
                                       "--data_dir", os.path.join(root, "data"),
                                       "--logs_dir", os.path.join(root, "logs")]
    # every call's launches (step: one iteration; step_scan: a block, each
    # iteration a replay), per iteration
    iters = []
    step, step_scan = MnistTrainer.step, MnistTrainer.step_scan

    def counting(fn, n_of):
        def run(self, ts, *args, **kwargs):
            before = runtime.launch_counts()
            out = fn(self, ts, *args, **kwargs)
            after = runtime.launch_counts()
            n = n_of(*args)
            iters.extend([{k: (after[k] - before[k]) / n for k in after}] * n)
            return out
        return run

    stats, stats2 = {}, {}
    with deterministic_algorithms(torch):
        MnistTrainer.step = counting(step, lambda *a: 1)
        MnistTrainer.step_scan = counting(step_scan, lambda dataset, idx, *a: len(idx))
        try:
            runtime.reset_launch_counts()
            t = time.perf_counter()
            ts, rec = mnist_app.main(argv + ["--train"], device=dev, stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            app_counts = runtime.launch_counts()
        finally:
            MnistTrainer.step, MnistTrainer.step_scan = step, step_scan
        run_name = next(d for d in os.listdir(app_root) if d.startswith("rcgan_0.3_projection_"))
        run = os.path.join(app_root, run_name)
        # the run's metric history, before the restored run rewrites log.pkl
        with open(os.path.join(run, "log.pkl"), "rb") as f:
            hist = pickle.load(f)
        t = time.perf_counter()
        again, rec2 = mnist_app.main(argv + ["--checkpoint", run_name], device=dev,
                                     stats=stats2)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t
    for k, v in app_counts.items():
        counts[k] += v
    check(len(iters) == 100 and all(c == MNIST_PATH_COUNTS for c in iters),
          f"MNIST app: {len(iters)} iterations (want 100), each with the launches "
          f"{MNIST_PATH_COUNTS} (a block's launches over its iterations; "
          f"{sum(c == MNIST_PATH_COUNTS for c in iters)} did)")
    names = set(os.listdir(run))
    want = {"ckpt", "samples", "recovery.txt", "recover_wrong_images.png", "command.txt",
            "config.json", "scripts", "log.pkl", "metrics.jsonl"}
    acc = list(hist.get("gen_label_acc", {}).values())
    tv = list(hist.get("c_recovery_tv_perm", {}).values())
    with open(os.path.join(run, "recover_wrong_images.png"), "rb") as f:
        panel = f.read()
    check(want <= names and os.listdir(os.path.join(run, "ckpt")) == ["100"]
          and len(acc) == 1 and 0.0 <= acc[0] <= 1.0 and len(tv) == 1 and math.isfinite(tv[0])
          and 0.0 <= rec["accuracy"] <= 1.0 and panel[25] == 0 and png_size(panel)[1] == 15 * 28
          and all(math.isfinite(v) for v in hist["d_loss"].values()),
          f"MNIST app run dir: {sorted(names & want)} (want {sorted(want)}), checkpoints "
          f"{os.listdir(os.path.join(run, 'ckpt'))}, gen-label-acc at epoch 4 {acc}, learned-C "
          f"perm-TV {tv}, recovery accuracy {rec['accuracy']}, grey recovery panel")
    compared, differ, same = state_differences(torch, ts, again)
    check(not differ and same and again.step == 100 and rec2["accuracy"] == rec["accuracy"]
          and np.array_equal(rec2["y_recover"], rec["y_recover"]),
          f"MNIST app restored with --checkpoint and without --train: {compared - len(differ)} "
          f"of {compared} tensors, the Adam counts and the step bit-equal to the saved state "
          f"(differ: {differ[:3]}), step {again.step}, recovery accuracy {rec2['accuracy']} "
          f"again (was {rec['accuracy']})")
    tr_s, tr_n = stats["train"]
    print(f"  MNIST app on {card}: {wall:.1f} s ({tr_n} iterations in {tr_s:.3f} s of blocks, "
          f"{tr_n / tr_s:.2f} iterations/s, the first block's warm-up included); restored run "
          f"{wall2:.1f} s; recovery accuracy {rec['accuracy']}, gen-label-acc {acc}", flush=True)
    for k in ("data", "classifier", "samples", "checkpoint_save", "gen_label_acc", "recovery"):
        sec, n = stats.get(k, (float("nan"), 0))
        print(f"    {k}: {sec:.3f} s over {n} call(s)", flush=True)
    for k in ("data", "classifier", "restore", "recovery"):
        sec, n = stats2.get(k, (float("nan"), 0))
        print(f"    restored run, {k}: {sec:.3f} s over {n} call(s)", flush=True)

    # ---- serving: the app's generator behind make_server, card against CPU
    rng = np.random.default_rng(seed)
    served = sampler_slice(torch, dev, "mnist", os.path.join(run, "ckpt"),
                           lambda n: rng.uniform(-1, 1, (n, cfg.z_dim)).astype(np.float32),
                           (1, 100), {"/sample?labels=3&seed=1": 1, "/sample?n=100&seed=2": 100},
                           MNIST_SERVE_TOL, "BN in inference mode")
    check(served == {k: 0 for k in runtime.KERNELS},
          f"MNIST serving launches no hand-written kernel: {served}")
    os.environ.pop("RCGAN_SYNTH_CACHE", None)
    shutil.rmtree(root, ignore_errors=True)
    row = dict(sn_rows["a projection D pass"], launches_per_iteration=sn_per_iteration,
               iteration_ms=it_ms,
               ms_is="MNIST's group of a projection D pass ([25, 64] and three [1600, 64]) in "
                     "one launch, device time in CUDA graphs (plain_ms: sn_plain per weight, "
                     "likewise; alone_ms: issued alone, host included)",
               concat_y=sn_rows["concat_y at layer 1"])
    return {"counts": counts, "sn_group": row}


# Phase 10, the PGGAN family at the JAX app's default full width
# (``apps/pggan_app.py``: size 64, max_stage 4, dim 128, z_dim 128, batch 64,
# bf16, hinge, Adam beta (0, 0.99), lr 2e-4, the conditional critic).  Its
# kernels: conv3x3 (C = O = 128 on maps of 8 to 64 pixels: every map is a
# power of two, so bf16 takes wgmma and float32 FFMA; ToRGB and FromRGB are
# 1x1), cond-BN (G's N1 on maps of 4 to 32 pixels, N2 on 8 to 64) and sn
# (one group per D pass).
PG_WIDTH = dict(z_dim=128, dim=128)
PG_BATCH = 64
PG_CONV_MAPS = (8, 16, 32, 64)
PG_BN_MAPS = (4, 8, 16, 32, 64)
# the stage-4 transition's sn group, in call order: FromRGB.4, Block.4
# (Shortcut, Conv1, Conv2), FromRGB.3, Blocks 3 to 1, Output, Embedding_y
_PG_BLOCK = [(128, 128), (1152, 128), (1152, 128)]
PG_SN_GROUP = [(3, 128)] + _PG_BLOCK + [(3, 128)] + _PG_BLOCK * 3 + [(128, 1), (300, 128)]


def pggan_counts(stage: int) -> dict:
    """Launches per PGGAN iteration at ``stage`` (either phase): the D step
    runs G (no grad) and two D passes with their backward, the G step G and
    one D pass with the backward through both.  Each block holds two 3x3
    convs: 2 per block for a G forward, 2 for a D forward, 2 for each
    backward's input grads, so 2 (G) + 8 (D step) + 8 (G step) per block;
    two cond-BNs per block and G pass, two G passes; one sn group per D
    pass.  The transition's extra layers are 1x1 (no conv3x3)."""
    return {"cond_bn": 4 * stage, "conv3x3": 18 * stage, "sn": 3, "projection": 0,
            "dequant": 0}


def pggan_variants(stage: int) -> dict:
    """conv3x3 by route per bf16 iteration: all on wgmma (C = O = 128, maps
    of 8 to 64 pixels tile by 128)."""
    return {"wgmma": 18 * stage, "ffma": 0, "cudnn": 0}


# Card against CPU, float32, TF32 off, under deterministic algorithms, at
# full width with the depth cut to max_stage 2: one iteration of each of the
# three phases (alpha 0.5 in the transition), each from the card's state
# copied to the CPU bit for bit, with the same batch and z, at batch 8, over
# the data seeds ``seed + PG_CHECK["data_seeds"]`` (every one checked; none
# chosen).  PG_SPREAD holds the calibration run's (median, max) of each
# reading over the five seeds by phase (H100 80GB HBM3 at 700.00 W; the
# first run of this check, before any limit existed); both are held to
# PG_MARGIN times it, or, where it was 0, to PG_MARGIN parameters of the
# group.  The maxima of mu and nu (0.037 of a tensor's max) and of far.gen
# (0.9%) are Adam's sign-like first steps on gradients zero but for
# rounding, as in the MNIST check; the medians carry the check there.
# ``params_max`` is left out: with beta1 = 0 one step moves a parameter at
# most lr * sqrt((1 - beta2^t) / (1 - beta2)) at Adam's count t (lr, 1.41 lr
# and 1.72 lr at t = 1 to 3), so card and CPU cannot part by more than that whatever
# the kernels do; the cost, u, statistics and moments' medians hold them.
PG_CHECK = {"batch": 8, "max_stage": 2, "data_seeds": (400, 401, 402, 403, 404)}
PG_MARGIN = 3.0
PG_SPREAD = {
    0: {"cost": (2.7e-07, 3.57e-06), "u": (8.94e-08, 8.94e-08), "stats": (8.59e-05, 4.42e-04),
        "mu.disc": (6.87e-06, 0.0368), "nu.disc": (5.97e-06, 0.0264),
        "dead.disc": (1.23e-07, 1.54e-07), "far.disc": (1.69e-05, 5.93e-05),
        "mu.gen": (3.64e-06, 2.98e-04), "nu.gen": (3.54e-06, 4.35e-04),
        "dead.gen": (2.95e-08, 3.61e-08), "far.gen": (2.92e-05, 2.79e-04)},
    1: {"cost": (1.44e-07, 3.77e-07), "u": (7.45e-08, 1.04e-07), "stats": (5.39e-05, 6.58e-05),
        "mu.disc": (1.48e-05, 1.66e-05), "nu.disc": (1.56e-05, 2.87e-05),
        "dead.disc": (1.46e-07, 2.26e-07), "far.disc": (7.5e-06, 1.8e-05),
        "mu.gen": (3.82e-03, 0.0193), "nu.gen": (7.15e-03, 0.01),
        "dead.gen": (4.58e-08, 5.2e-08), "far.gen": (1.62e-03, 5.33e-03)},
    2: {"cost": (2.54e-07, 5.48e-07), "u": (1.04e-07, 1.04e-07), "stats": (4.2e-05, 5.18e-05),
        "mu.disc": (1.77e-05, 4.12e-05), "nu.disc": (7.13e-06, 1.33e-05),
        "dead.disc": (1.25e-07, 1.67e-07), "far.disc": (0.0, 1.5e-06),
        "mu.gen": (3.23e-03, 0.037), "nu.gen": (1.94e-03, 0.0247),
        "dead.gen": (3.38e-08, 4.44e-08), "far.gen": (1.14e-03, 8.88e-03)},
}
# full width, bf16, batch 64, max_stage 4: iterations per phase (the first
# of each a warm-up), on 2 048 random images of 64x64 resident on the card
PG_TIMED = {"dataset": 2048, "iters": 3, "stage4_iters": 8}
# crash and resume at full width, max_stage 2, bf16, batch 64: 2 + 2 + 2
# iterations, checkpoints at 2 and 4, the data raises at iteration 4
PG_RESUME = {"trans_iters": 2, "stab_iters": 2, "crash_at": 4}
# the app at full width (its defaults), cut: 2 iterations a phase, 640
# training images, 128 eval samples a phase
PG_APP_ITERS, PG_APP_EVAL = 2, 128
PG_APP = ["--trans_iters", str(PG_APP_ITERS), "--stab_iters", str(PG_APP_ITERS),
          "--train_size", "640", "--eval_samples", str(PG_APP_EVAL)]
# serving: the app's generator on the card against the CPU, float32, cond-BN
# on the bucket's statistics: 8 convs and 8 cond-BNs at stage 4, within
# SLICE_ATOL of the images' scale
PG_SERVE_BUCKETS = (1, 8)


# one parameter's share of its group in the check's model (898 566 in gen,
# 667 065 in disc): the smallest nonzero ``far`` reading
PG_ONE_PARAM = {"far.gen": 1 / 898566, "far.disc": 1 / 667065}


def pggan_limits(phase: int) -> dict:
    """``{reading: (median limit, max limit)}`` of the check's ``phase``."""
    return {k: tuple(PG_MARGIN * max(v, PG_ONE_PARAM.get(k, 0.0)) for v in spread)
            for k, spread in PG_SPREAD.get(phase, {}).items()}


def pggan_kernels(torch, dev, gen, max_err: dict) -> dict:
    """conv3x3, cond-BN and sn at PGGAN's shapes against their plain
    versions (phase 3's checks); returns the times of the 64x64 conv (FFMA
    float32, wgmma bf16), of the cond-BN at [64, 64 x 64, 128] and of the
    stage-4 transition's sn group, in CUDA graphs beside their bounds."""
    from rcgan_tpu_torch.ops.kernels.conv_kernel import conv3x3, conv3x3_plain
    from rcgan_tpu_torch.ops.kernels.norm_kernel import cond_batchnorm, cond_batchnorm_plain

    b, c = PG_BATCH, PG_WIDTH["dim"]
    out = {}
    for hw in PG_CONV_MAPS:
        x = torch.relu(torch.randn(b, hw, hw, c, generator=gen)).to(dev)
        w = (torch.randn(3, 3, c, c, generator=gen) * (2.0 / (9 * c)) ** 0.5).to(dev)
        g = torch.randn(b, hw, hw, c, generator=gen).to(dev)
        for name in ("float32", "bfloat16"):
            route = check_conv3x3(torch, x, w, name, "PGGAN conv3x3", max_err, cotangent=g)
            if hw != 64:
                continue
            dt = getattr(torch, name)
            xd, wd = x.to(dt), w.to(dt)
            with torch.no_grad():
                ms, lib = paired_ms(torch, graph_ms, lambda: conv3x3(xd, wd),
                                    lambda: cudnn_conv(xd, wd))
                plain = graph_ms(torch, lambda: conv3x3_plain(xd, wd), calls=2, reps=3)
            bms, by = bound(*conv_work(b, hw, c, c, dt.itemsize),
                            PEAK_F32 if name == "float32" else PEAK_BF16)
            out[f"conv_{route}"] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                                    "bound_ms": bms, "bound_by": by}
            print(f"  PGGAN conv3x3 [{b},64,64,{c}] {name} on {route}, device time in CUDA "
                  f"graphs: {ms:.4f} ms, cuDNN {lib:.4f} ms, plain {plain:.4f} ms; bound "
                  f"{bms:.4f} ms ({by}): kernel {bms / ms:.1%} of it", flush=True)
    for hw in PG_BN_MAPS:
        x = (torch.randn(b, hw * hw, c, generator=gen) * 2.0 + 0.5).to(dev)
        labels = torch.randint(0, 10, (b,), generator=gen).to(dev)
        tables = [(1.0 + 0.1 * torch.randn(10, c, generator=gen)).to(dev),
                  (0.1 * torch.randn(10, c, generator=gen)).to(dev)]
        for name in ("float32", "bfloat16"):
            check_cond_bn(torch, x, labels, *tables, name, "PGGAN cond_bn", max_err)
            if hw != 64:
                continue
            a = (x.to(getattr(torch, name)), labels, *tables)
            with torch.no_grad():
                ms, plain = paired_ms(torch, graph_ms, lambda: cond_batchnorm(*a, relu=True),
                                      lambda: cond_batchnorm_plain(*a, relu=True))
            n = b * hw * hw * c
            bms, by = bound(7 * n, a[0].element_size() * 2 * n + 8 * b + 4 * 2 * 10 * c,
                            PEAK_F32)
            out[f"cond_bn_{name}"] = {"ms": ms, "plain_ms": plain, "bound_ms": bms,
                                      "bound_by": by}
            print(f"  PGGAN cond_bn [{b},64x64,{c}] {name}, ReLU fused, device time in CUDA "
                  f"graphs: {ms:.4f} ms, plain {plain:.4f} ms; bound {bms:.4f} ms ({by}): kernel "
                  f"{bms / ms:.1%} of it", flush=True)
    pairs = [((0.05 * torch.randn(m, co, generator=gen)).to(dev),
              torch.randn(1, co, generator=gen).to(dev)) for m, co in PG_SN_GROUP]
    err_abs = check_sn_group(torch, pairs, "PGGAN stage-4 transition", max_err)
    out["sn"] = dict(sn_group_times(torch, pairs), max_abs_err=err_abs)
    t = out["sn"]
    print(f"  sn PGGAN stage-4 transition group: {t['ms']:.4f} ms in CUDA graphs, "
          f"{t['alone_ms']:.4f} ms issued alone; plain {t['plain_ms']:.4f} ms in graphs; bound "
          f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']})", flush=True)
    return out


def pggan_check_feeds(seed: int, data_seed: int, b: int):
    """The three phases' ``(images, z)`` of the card-vs-CPU check, numpy from
    ``seed + data_seed``: 16x16 images in [-1, 1] (max_stage 2's full
    resolution), labels, z."""
    import numpy as np

    rng = np.random.default_rng(seed + data_seed)
    return [({"x": rng.uniform(-1, 1, (b, 16, 16, 3)).astype(np.float32),
              "labels": rng.integers(0, 10, b)},
             rng.standard_normal((b, PG_WIDTH["z_dim"])).astype(np.float32))
            for _ in range(3)]


def pggan_slice(torch, dev, seed: int, card: str, max_err: dict) -> dict:
    """Phase 10: the PGGAN family on the card (module doc, item 10).
    Returns the launches of each kernel over the counted full-width
    iterations and the app's run (``counts``), conv3x3's by variant
    (``variants``), the kernels' times at PGGAN's shapes (``kernels``) and
    the stage-4 iteration's times (``iteration``)."""
    import os
    import shutil

    import numpy as np

    from rcgan_tpu_torch.apps import pggan_app
    from rcgan_tpu_torch.bridge import pggan_train_state_from_jax, to_jax_train_state
    from rcgan_tpu_torch.core import rng as trng
    from rcgan_tpu_torch.models.pggan import PGGANConfig
    from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
    from rcgan_tpu_torch.ops.kernels import runtime
    from rcgan_tpu_torch.train.checkpoint import Checkpointer
    from rcgan_tpu_torch.train.pggan_loop import PGGANTrainConfig, PGGANTrainer

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke_pggan")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    os.environ["RCGAN_SYNTH_CACHE"] = os.path.join(root, "synth")
    gen = torch.Generator().manual_seed(seed + 10)
    print(f"PGGAN slice on {card}", flush=True)
    kern = pggan_kernels(torch, dev, gen, max_err)
    base = ResnetGANConfig(dim_g=PG_WIDTH["dim"], dim_d=PG_WIDTH["dim"],
                           z_dim=PG_WIDTH["z_dim"])
    tcfg = PGGANTrainConfig()

    # ---- card against CPU, float32, TF32 off: one iteration of each phase
    b = PG_CHECK["batch"]
    small = PGGANConfig(max_stage=PG_CHECK["max_stage"], **PG_WIDTH)
    phases = [(1, False, 1.0), (2, True, 0.5), (2, False, 1.0)]
    spread = {i: {} for i in range(len(phases))}
    with deterministic_algorithms(torch):
        trainers = {side: PGGANTrainer(small, base, tcfg, device=side) for side in (dev, "cpu")}
        for data_seed in PG_CHECK["data_seeds"]:
            ts_card = trainers[dev].init(seed + data_seed)
            if data_seed == PG_CHECK["data_seeds"][0]:
                sizes = {g: sum(p.numel() for p in ps.values()) for g, ps in ts_card.groups.items()}
                print(f"  PGGAN check model (dim {small.dim}, max_stage {small.max_stage}): "
                      f"parameters by group {sizes}", flush=True)
            for i, ((stage, trans, alpha), (images, z)) in enumerate(
                    zip(phases, pggan_check_feeds(seed, data_seed, b))):
                ts_cpu = pggan_train_state_from_jax(to_jax_train_state(ts_card), small, base,
                                                    tcfg, "cpu")
                ts_cpu, m_cpu = trainers["cpu"].step(ts_cpu, images, 0, alpha, stage, trans, z=z)
                ts_card, m_card = trainers[dev].step(ts_card, images, 0, alpha, stage, trans, z=z)
                r, where = train_readings(to_jax_train_state(ts_cpu), to_jax_train_state(ts_card),
                                          m_cpu, m_card, tcfg.lr, {"gen": 1, "disc": 1},
                                          cost_keys=("d_cost", "g_cost"))
                r.pop("params_max")  # bounded by Adam itself (PG_CHECK's note)
                for k, v in r.items():
                    spread[i].setdefault(k, []).append((v, data_seed, where.get(k)))
    for i, readings in spread.items():
        check_spread(readings, pggan_limits(i), PG_MARGIN,
                     f"PGGAN training, full width, max_stage 2, batch {b}, phase {phases[i][:2]}, "
                     f"float32, card vs CPU from the same state over data seeds "
                     f"{list(PG_CHECK['data_seeds'])}")

    # ---- full width, bf16, batch 64, max_stage 4, every phase: launches, times, profile
    cfg = PGGANConfig(max_stage=4, **PG_WIDTH)
    full = cfg.resolution(cfg.max_stage)
    n = PG_TIMED["dataset"]
    x_dev = (torch.rand(n, full, full, 3, generator=gen) * 2 - 1).to(dev)
    y_dev = torch.randint(0, 10, (n,), generator=gen).to(dev)
    print(f"  PGGAN: {n} random {full}x{full} images, "
          f"{x_dev.numel() * 4 / 1e6:.1f} MB resident on the card", flush=True)
    trainer = PGGANTrainer(cfg, base, tcfg, device=dev, compute_dtype=torch.bfloat16)
    state = {"ts": trainer.init(seed), "it": 0}
    drs = np.random.RandomState(seed)

    def iteration(stage, trans, alpha):
        idx = torch.from_numpy(drs.randint(0, n, PG_BATCH)).to(dev)
        state["ts"], m = trainer.step(state["ts"], {"x": x_dev[idx], "labels": y_dev[idx]},
                                      trng.fold_in(seed, state["it"]), alpha, stage, trans)
        state["it"] += 1
        return m

    counts = {k: 0 for k in runtime.KERNELS}
    variants = dict.fromkeys(runtime.VARIANTS["conv3x3"], 0)
    times = {}
    ok_counts, seen = True, []
    for stage, trans, _ in trainer.phases():
        k = PG_TIMED["stage4_iters"] if stage == 4 else PG_TIMED["iters"]
        ts_ms = []
        for i in range(k):
            alpha = (i + 1) / k if trans else 1.0
            runtime.reset_launch_counts()
            a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            m = iteration(stage, trans, alpha)
            e.record()
            e.synchronize()
            got, got_v = runtime.launch_counts(), runtime.variant_counts("conv3x3")
            for kk, v in got.items():
                counts[kk] += v
            for kk, v in got_v.items():
                variants[kk] += v
            ok_counts = ok_counts and got == pggan_counts(stage) and got_v == pggan_variants(stage)
            seen.append((stage, trans, got, got_v))
            if i:
                ts_ms.append(a.elapsed_time(e))
        times[(stage, trans)] = statistics.median(ts_ms)
    check(ok_counts, f"PGGAN bf16 batch {PG_BATCH}, max_stage 4, {len(seen)} iterations over "
                     f"the 7 phases: launches per iteration as pggan_counts and pggan_variants "
                     f"say (stage 4: {pggan_counts(4)}, {pggan_variants(4)}; last seen "
                     f"{seen[-1][2]}, {seen[-1][3]}; wrong: "
                     f"{[s[:2] for s in seen if s[2] != pggan_counts(s[0])][:3]})")
    finite = all(math.isfinite(float(v)) for v in m.values()) and all(
        bool(torch.isfinite(p).all()) for p in state["ts"].gan.parameters())
    check(finite, f"PGGAN bf16: costs and parameters finite after {state['it']} iterations "
                  f"(d_cost {float(m['d_cost']):.4f}, g_cost {float(m['g_cost']):.4f})")
    for (stage, trans), ms in times.items():
        print(f"  PGGAN bf16 batch {PG_BATCH}, stage {stage} ({cfg.resolution(stage)}x"
              f"{cfg.resolution(stage)}) {'trans' if trans else 'stab'}: {ms:.3f} ms per "
              f"iteration (median by CUDA events, warm-up left out)", flush=True)
    prof_ms, busy, rows = device_profile(torch, lambda: iteration(4, False, 1.0), reps=3)
    print(f"  PGGAN stage-4 stab iteration profiled: {prof_ms:.3f} ms, device busy {busy:.3f} ms "
          f"({busy / prof_ms:.0%}); by kernel:", flush=True)
    for t, kk, name in rows[:12]:
        print(f"    {t:.4f} ms x{kk} {name[:90]}", flush=True)
    breakdown = print_breakdown(rows, {"conv3x3 (wgmma, forward + input grad)": ("conv3x3",),
                                       "cuDNN weight grads (*wgrad*)": ("wgrad",),
                                       "cond-BN forward (ReLU fused)": ("cond_bn_kernel",),
                                       "sn (one launch per D pass)": ("sn_group_kernel",),
                                       "Adam (foreach)": ("multi_tensor_apply",)},
                                "1x1 convs, BN, pixel norm, pools, elementwise, copies")

    # ---- crash in phase 3 and resume from the phase checkpoint: bit for bit
    rcfg = PGGANConfig(max_stage=2, **PG_WIDTH)
    rt = PGGANTrainConfig(trans_iters=PG_RESUME["trans_iters"],
                          stab_iters=PG_RESUME["stab_iters"])
    xr = x_dev[:, ::4, ::4, :].contiguous()  # 16x16, max_stage 2's full resolution

    def data_fn(it):
        idx = torch.from_numpy(np.random.RandomState(100 + it).randint(0, n, PG_BATCH)).to(dev)
        return {"x": xr[idx], "labels": y_dev[idx]}

    def crashing(it):
        if it >= PG_RESUME["crash_at"]:
            raise RuntimeError(f"injected fault at iteration {it}")
        return data_fn(it)

    ck = Checkpointer(os.path.join(root, "resume_ck"))
    with deterministic_algorithms(torch):
        tr_a = PGGANTrainer(rcfg, base, rt, device=dev, compute_dtype=torch.bfloat16)
        whole = tr_a.train_progressive(tr_a.init(seed), data_fn, seed + 1)
        tr_b = PGGANTrainer(rcfg, base, rt, device=dev, compute_dtype=torch.bfloat16)
        try:
            tr_b.train_progressive(tr_b.init(seed), crashing, seed + 1, ckpt=ck)
            crashed = None
        except RuntimeError as e:
            crashed = str(e)
        left_ck = ck.steps()
        tr_c = PGGANTrainer(rcfg, base, rt, device=dev, compute_dtype=torch.bfloat16)
        resumed = ck.restore(tr_c.init(seed + 99))
        from_step = resumed.step
        resumed = tr_c.train_progressive(resumed, data_fn, seed + 1, ckpt=ck)
    compared, differ, same = state_differences(torch, whole, resumed)
    check(crashed is not None and left_ck == [2, 4] and from_step == 4 and not differ and same
          and resumed.step == 6,
          f"PGGAN train_progressive, full width, max_stage 2, bf16: crashed ({crashed}), "
          f"checkpoints {left_ck}, resumed from {from_step}: {compared - len(differ)} of "
          f"{compared} tensors, the counts and the step bit-equal to the uninterrupted run "
          f"(differ: {differ[:3]})")
    shutil.rmtree(os.path.join(root, "resume_ck"), ignore_errors=True)

    # ---- the app at full width, then again with --resume
    run = os.path.join(root, "app", "run")
    argv = ["--run_dir", run, "--seed", str(seed)] + PG_APP
    stats, stats2 = {}, {}
    runtime.reset_launch_counts()
    t = time.perf_counter()
    app_ts, rows = pggan_app.main(argv, device=dev, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    app_counts, app_variants = runtime.launch_counts(), runtime.variant_counts("conv3x3")
    for k, v in app_counts.items():
        counts[k] += v
    for k, v in app_variants.items():
        variants[k] += v
    t = time.perf_counter()
    app_ts2, rows2 = pggan_app.main(argv, device=dev, stats=stats2)
    wall2 = time.perf_counter() - t
    phases_app = [(s, t_) for s, t_, _ in trainer.phases()]
    grids = {}
    for s, t_ in phases_app:
        name = f"samples_stage{s}_{'trans' if t_ else 'stab'}.png"
        with open(os.path.join(run, name), "rb") as f:
            grids[name] = png_size(f.read())
    # the run's sn, cond-BN and wgmma launches: PG_APP_ITERS iterations a
    # phase (pggan_counts), and per phase the eval's generator passes at the
    # stage (bf16: 2 cond-BNs and 2 convs per block); the eval classifier's
    # float32 convs take the FFMA and cuDNN routes, which are not counted
    passes = -(-PG_APP_EVAL // PG_BATCH) + 1  # the eval's batches and the grid of 100
    want = {"sn": 0, "cond_bn": 0, "wgmma": 0}
    for s, _ in phases_app:
        want["sn"] += PG_APP_ITERS * pggan_counts(s)["sn"]
        want["cond_bn"] += PG_APP_ITERS * pggan_counts(s)["cond_bn"] + passes * 2 * s
        want["wgmma"] += PG_APP_ITERS * pggan_variants(s)["wgmma"] + passes * 2 * s
    got = {"sn": app_counts["sn"], "cond_bn": app_counts["cond_bn"],
           "wgmma": app_variants["wgmma"]}
    check(got == want and stats["train"][1] == PG_APP_ITERS * len(phases_app)
          and [(r["stage"], r["trans"], r["iter"]) for r in rows]
          == [(s, t_, PG_APP_ITERS * (i + 1)) for i, (s, t_) in enumerate(phases_app)]
          and all(0.0 <= r["gen_label_acc"] <= 1.0 for r in rows)
          and all(g == (10 * cfg.resolution(int(nm[13])),) * 2 for nm, g in grids.items())
          and Checkpointer(os.path.join(run, "ckpt")).steps() == [6, 8, 10, 12, 14]
          and os.path.exists(os.path.join(root, "app", "eval_classifier_64_s"
                                          f"{seed}_n640.pkl")),
          f"PGGAN app at full width (size 64, max_stage 4, dim 128, bf16, batch 64): "
          f"{stats['train'][1]} iterations, launches {got} (want {want}), rows "
          f"{[(r['stage'], r['trans'], r['iter'], round(r['gen_label_acc'], 3)) for r in rows]}, "
          f"grids {sorted(set(grids.values()))}, checkpoints "
          f"{Checkpointer(os.path.join(run, 'ckpt')).steps()}")
    compared, differ, same = state_differences(torch, app_ts, app_ts2)
    check(app_ts2.step == 14 and rows2 == rows and not differ and same
          and stats2.get("restore", (0, 0))[1] == 1 and stats2.get("train", (0, 0))[1] == 0,
          f"PGGAN app again with --resume: step {app_ts2.step}, no iteration, the rows and "
          f"{compared - len(differ)} of {compared} tensors as the first run left them")
    tr_s, tr_n = stats["train"]
    print(f"  PGGAN app on {card}: {wall:.1f} s ({tr_n} iterations in {tr_s:.3f} s, evals and "
          f"saves left out); resumed run {wall2:.1f} s", flush=True)
    for k in ("data", "classifier", "eval", "checkpoint_save"):
        sec, cnt = stats.get(k, (float("nan"), 0))
        print(f"    {k}: {sec:.3f} s over {cnt} call(s)", flush=True)
    sec, cnt = stats2.get("restore", (float("nan"), 0))
    print(f"    resumed run, restore: {sec:.3f} s ({cnt} call)", flush=True)

    # ---- the sampler on the app's checkpoint, card against CPU, then over HTTP
    rng = np.random.default_rng(seed)
    served = sampler_slice(torch, dev, "pggan", os.path.join(run, "ckpt"),
                           lambda n: rng.standard_normal((n, PG_WIDTH["z_dim"])).astype(np.float32),
                           PG_SERVE_BUCKETS, {"/sample?labels=3&seed=1": 1, "/sample?n=8&seed=2": 8},
                           SLICE_ATOL, "cond-BN on the bucket's statistics")
    check(served["cond_bn"] == 2 * 8 and served["conv3x3"] == 2 * 8 and served["sn"] == 0,
          f"PGGAN serving, two passes at stage 4: launches {served} (want 8 cond_bn and 8 "
          f"FFMA conv3x3 a pass, no sn)")
    os.environ.pop("RCGAN_SYNTH_CACHE", None)
    shutil.rmtree(root, ignore_errors=True)
    per_iteration = {st: dict(c_) for st, _, c_, _ in seen}
    return {"counts": counts, "variants": variants, "kernels": kern,
            "per_iteration": per_iteration,
            "iteration": {"stab_ms": times[(4, False)], "trans_ms": times[(4, True)],
                          "busy_ms": busy, "profiled_ms": prof_ms,
                          "breakdown": breakdown}}


# Phase 11, the Inception-v3 scorer of the CIFAR app: ``random_weights(0)``
# on the card against the CPU, float32 with TF32 off on both (94 convs on
# cuDNN and the CPU's), within IV3_TOL of the logits' scale; its time on
# 5 000 samples in batches of 500; and the app scoring with it.
IV3_TOL = 1e-3


def inception_slice(torch, dev, seed: int, card: str) -> dict:
    """Phase 11 (module doc, item 11).  Returns the scorer's times."""
    import os
    import shutil

    import numpy as np

    from rcgan_tpu_torch.apps import cifar_app
    from rcgan_tpu_torch.evals import inception_v3

    params = inception_v3.random_weights(0)
    on_card = inception_v3.make_logits_fn(params, device=dev)
    on_cpu = inception_v3.make_logits_fn(params, device="cpu")
    imgs = np.random.default_rng(seed).uniform(-1, 1, (4, 3072)).astype(np.float32)
    got, ref = on_card(imgs).cpu().numpy(), on_cpu(imgs).numpy()
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    check(got.shape == (4, 1000) and err <= IV3_TOL * scale,
          f"Inception-v3 (random_weights(0)) on the card vs the CPU, 4 CIFAR images at 299, "
          f"float32, TF32 off: max abs err {err:.3e} (limit {IV3_TOL} of {scale:.3f})")
    batch = torch.from_numpy(np.random.default_rng(seed + 1).uniform(
        -1, 1, (500, 3072)).astype(np.float32)).to(dev)
    on_card(batch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(10):
        on_card(batch)
    e.record()
    e.synchronize()
    wall = time.perf_counter() - t
    print(f"  Inception-v3 on {card}: 5 000 samples in batches of 500, {a.elapsed_time(e):.1f} "
          f"ms by CUDA events ({wall:.2f} s host clock)", flush=True)

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke_iv3")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "data"))
    np.savez(os.path.join(root, "data", "inception_v3.npz"), **params)
    os.environ["RCGAN_SYNTH_CACHE"] = "0"
    log_file = os.path.join(root, "app.log")
    stats = {}
    t = time.perf_counter()
    cifar_app.main(["--algorithm", "rcgan", "--alpha", "0.6", "--parent_dir", root,
                    "--expt_dir", "iv3", "--log_file", log_file, "--niters", "2",
                    "--inception_freq", "2", "--sample_freq", "1000000",
                    "--generated_label_accuracy_freq", "1000000", "--mesh_devices", "1",
                    "--nomulti_gpu_multi_batch", "--synthetic_train_size", "640",
                    "--eval_train_size", "640", "--seed", str(seed),
                    "--data_dir", os.path.join(root, "data")], device="cuda", stats=stats)
    torch.cuda.synchronize()
    app_s = time.perf_counter() - t
    text = open(log_file).read()
    sec, cnt = stats.get("inception", (float("nan"), 0))
    check("inception scorer: Inception-v3 from" in text and cnt == 1
          and "finished inception score computation" in text,
          f"CIFAR app with inception_v3.npz in its data dir: the Inception-v3 route, one score "
          f"on 50 000 samples in {sec:.2f} s (the run {app_s:.1f} s)")
    os.environ.pop("RCGAN_SYNTH_CACHE", None)
    shutil.rmtree(root, ignore_errors=True)
    return {"ms_5000": a.elapsed_time(e), "app_inception_s": sec}


# Phase 12, data parallelism (``rcgan_tpu_torch/parallel/mesh.py``): the
# group's code path in spawned ranks.  NCCL refuses two ranks on one card
# ("duplicate GPU"), so on a one-card machine the two-rank runs are gloo
# ranks that share cuda:0: they check correctness, and their times say
# nothing of scaling.  NCCL runs at world size 1.
DP = {"nccl_batch": 64, "nccl_dataset": 4096, "gloo_batch": 16, "mnist_batch": 100,
      "timed": 3}
DP_APP = ["--algorithm", "rcgan-u", "--alpha", "0.6", "--perm_classifier", "--confuse_init",
          "--perm_gen_label_acc", "--mesh_devices", "2", "--multi_gpu_multi_batch",
          "--batch_size", "32", "--synthetic_train_size", "640", "--eval_train_size", "2000",
          "--niters", "8", "--ckpt_early_every", "1", "--sample_freq", "2",
          "--generated_label_accuracy_freq", "4", "--inception_freq", "4", "--run", "dp"]
DP_TIMEOUT = 600.0


def state_digest(torch, ts) -> str:
    """sha256 over every tensor of a train state (parameters, state, Adam
    moments) in name order, with the counts and the step: equal digests,
    equal bits."""
    import hashlib

    from rcgan_tpu_torch.train.checkpoint import state_payload

    p = state_payload(ts)
    h = hashlib.sha256(repr((p["step"], {g: s["count"] for g, s in p["opt_states"].items()}))
                       .encode())
    trees = [p["groups"][g] for g in sorted(p["groups"])] + [p["state"]] + [
        p["opt_states"][g][m] for g in sorted(p["opt_states"]) for m in ("mu", "nu")]
    for tree in trees:
        for k in sorted(tree):
            h.update(k.encode())
            h.update(tree[k].contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def dp_expected_bytes(ts, n_critic: int, g_step: bool) -> int:
    """Bytes one cycle all-reduces: each step's gradients and the state
    (float32), the G step's over G (and C), every critic step's over D,
    and the cycle's three costs."""
    from rcgan_tpu_torch.train.state import state_buffers

    def size(ts_):
        return sum(b.numel() * b.element_size() for b in state_buffers(ts_.gan))

    numel = {g: sum(p.numel() * p.element_size() for p in ts.group_params(g))
             for g in ts.groups}
    g_bytes = sum(v for g, v in numel.items() if g != "disc") + size(ts)
    return g_step * g_bytes + n_critic * (numel["disc"] + size(ts)) + 3 * 4


def dp_cifar_feeds(seed: int, b: int, n_critic: int, gen_mult: int, cycles: int):
    """Host batches and generator labels of ``cycles`` cycles at the global
    batch ``b``, numpy, from ``seed``."""
    import numpy as np

    rs = np.random.RandomState(seed)
    out = []
    for _ in range(cycles):
        d = {"images": rs.randint(0, 256, (n_critic, b, 3072)).astype(np.uint8),
             "labels": rs.randint(0, 10, (n_critic, b)),
             "labels_random": rs.randint(0, 10, (n_critic, b)),
             "labels_biased": rs.randint(0, 10, (n_critic, b)),
             "labels_inv_weights": rs.uniform(-0.5, 1.5, (n_critic, b, 10)).astype(np.float32)}
        out.append((d, {"random": rs.randint(0, 10, gen_mult * b),
                        "biased": rs.randint(0, 10, gen_mult * b)}))
    return out


def dp_nccl_run(group, seed: int):
    """Phase 12, NCCL at world size 1: ``bench.py``'s
    configuration (full width, bf16, batch 64, n_critic 5) for rcgan and
    rcgan-u; two cycles through the group and two without, from one seed
    on one resident dataset under deterministic algorithms; each grouped
    cycle's launches and bytes; ms per cycle, and a profile's share of
    device time in NCCL's kernels."""
    import numpy as np
    import torch

    from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
    from rcgan_tpu_torch.core import rng as trng
    from rcgan_tpu_torch.data.cifar10 import device_dataset_of
    from rcgan_tpu_torch.data.confusion import build_confusion, corrupt_dataset_numpy
    from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
    from rcgan_tpu_torch.ops.kernels import runtime
    from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer

    dev = group.device
    c_mat, c_inv = build_confusion(0.6)
    n, b = DP["nccl_dataset"], DP["nccl_batch"]
    rs = np.random.RandomState(seed)
    y_real, y_gen, y_fake, inv_w = corrupt_dataset_numpy(rs, rs.randint(0, 10, n), c_mat, c_inv)
    ds = device_dataset_of({"images": rs.randint(0, 256, (n, 3072)).astype(np.uint8),
                            "labels": y_real, "labels_random": y_gen, "labels_biased": y_fake,
                            "labels_inv_weights": inv_w}, dev)
    tcfg = CifarTrainConfig()
    out = {"backend": group.backend, "world": group.world_size}
    for alg, perm in (("rcgan", False), ("rcgan-u", True)):
        acfg = CifarAlgoConfig(algorithm=alg, perm_classifier=perm, confuse_init=perm)
        cfg = ResnetGANConfig(algorithm=alg)
        grouped = CifarTrainer(cfg, acfg, tcfg, c_mat, dev, torch.bfloat16, ds, group=group)
        alone = CifarTrainer(cfg, acfg, tcfg, c_mat, dev, torch.bfloat16, ds)
        # two checked cycles, then the timed ones (one warm-up), two profiled
        feeds = [(rs.randint(0, n, (tcfg.n_critic, b)), rs.randint(0, n, tcfg.gen_bs_multiple * b))
                 for _ in range(DP["timed"] + 5)]
        ts_g, ts_1, counts, nbytes = grouped.init(seed), alone.init(seed), [], []
        with deterministic_algorithms(torch):
            for it in range(2):
                idx, gi = feeds[it]
                gl = {"random": y_gen[gi], "biased": y_fake[gi]}
                runtime.reset_launch_counts()
                group.reset_counts()
                ts_g, m_g = grouped.step(ts_g, {"index": idx}, gl, it, trng.fold_in(seed, it))
                torch.cuda.synchronize()
                counts.append(runtime.launch_counts())
                nbytes.append((group.bytes_reduced, dp_expected_bytes(ts_g, tcfg.n_critic, it > 0)))
                ts_1, m_1 = alone.step(ts_1, {"index": idx}, gl, it, trng.fold_in(seed, it))
            compared, differ, same = state_differences(torch, ts_g, ts_1)
            costs_equal = all(torch.equal(m_g[k], m_1[k]) for k in m_g)
        state = {"ts": ts_g, "it": 2}

        def cycle():
            idx, gi = feeds[state["it"]]
            state["ts"], m = grouped.step(state["ts"], {"index": idx},
                                          {"random": y_gen[gi], "biased": y_fake[gi]},
                                          state["it"], trng.fold_in(seed, state["it"]))
            state["it"] += 1
            return m

        ms = event_ms(torch, cycle, reps=DP["timed"], warmup=1)
        wall = busy = nccl = float("nan")
        if alg == "rcgan":  # a profile of one cycle (rcgan-u's collectives are the same)
            wall, busy, rows = device_profile(torch, cycle, reps=1)
            nccl = sum(r[0] for r in rows if "nccl" in r[2].lower())
        out[alg] = {"counts": counts, "bytes": nbytes, "compared": compared, "differ": differ,
                    "same": same, "costs_equal": costs_equal, "ms": ms, "busy": busy,
                    "wall": wall, "nccl_ms": nccl}
    return out


def dp_gloo_rank(group, seed: int):
    """Phase 12, two gloo ranks sharing the card, in a spawned rank: full
    width, float32, batch ``DP["gloo_batch"]`` a rank, two cycles of rcgan
    and rcgan-u (each cycle's launches, bytes and costs, the final state's
    digest), rcgan with ``normalization_g=False`` (rank 0 returns its
    states for the one-rank comparison), ms per cycle with the time spent
    inside the collectives, and two ``MnistTrainer`` iterations at
    ``DCGANConfig()``."""
    import time as time_

    import numpy as np
    import torch

    from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
    from rcgan_tpu_torch.algorithms.mnist import MnistAlgoConfig
    from rcgan_tpu_torch.bridge import to_jax_train_state
    from rcgan_tpu_torch.data.confusion import build_confusion
    from rcgan_tpu_torch.models.dcgan import DCGANConfig
    from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
    from rcgan_tpu_torch.ops.kernels import runtime
    from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer
    from rcgan_tpu_torch.train.mnist_loop import MnistTrainConfig, MnistTrainer

    dev = group.device
    c_mat, _ = build_confusion(0.6)
    tcfg = CifarTrainConfig()
    b = DP["gloo_batch"] * group.world_size
    # two checked cycles, then the timed ones, two profiled, one synchronised
    feeds = dp_cifar_feeds(seed, b, tcfg.n_critic, tcfg.gen_bs_multiple, DP["timed"] + 6)
    out = {}
    for alg, perm, norm_g in (("rcgan", False, True), ("rcgan-u", True, True),
                              ("rcgan", False, False)):
        acfg = CifarAlgoConfig(algorithm=alg, perm_classifier=perm, confuse_init=perm)
        tr = CifarTrainer(ResnetGANConfig(algorithm=alg, normalization_g=norm_g), acfg, tcfg,
                          c_mat, dev, torch.float32, group=group)
        ts = tr.init(seed)
        states = [] if not norm_g and group.is_main else None
        counts, nbytes, costs = [], [], []
        # the layout check's run repeats bit for bit under deterministic algorithms
        with deterministic_algorithms(torch) if not norm_g else contextlib.nullcontext():
            for it in range(2):
                d, g = feeds[it]
                runtime.reset_launch_counts()
                group.reset_counts()
                ts, m = tr.step(ts, d, g, it + 1, seed + it)
                torch.cuda.synchronize()
                counts.append(runtime.launch_counts())
                nbytes.append((group.bytes_reduced, dp_expected_bytes(ts, tcfg.n_critic, True)))
                costs.append({k: float(v) for k, v in m.items()})
                if states is not None:
                    states.append(to_jax_train_state(ts))
        key = f"{alg}{'' if norm_g else ' normalization_g=False'}"
        out[key] = {"counts": counts, "bytes": nbytes, "costs": costs,
                    "digest": state_digest(torch, ts), "states": states}
        if alg == "rcgan" and norm_g:  # times: per cycle, and inside the collectives
            state = {"ts": ts, "it": 2}

            def cycle():
                d, g = feeds[state["it"]]
                state["ts"], m = tr.step(state["ts"], d, g, state["it"] + 1, seed + state["it"])
                state["it"] += 1
                return m

            ms = event_ms(torch, cycle, reps=DP["timed"], warmup=1)
            group.barrier()  # both ranks start the synchronised cycle together
            spent = [0.0]
            mean_ = group.mean_

            def timed_mean(tensors):
                torch.cuda.synchronize()
                t = time_.perf_counter()
                mean_(tensors)
                spent[0] += time_.perf_counter() - t

            group.mean_ = timed_mean
            t = time_.perf_counter()
            cycle()
            torch.cuda.synchronize()
            wall = (time_.perf_counter() - t) * 1e3
            group.mean_ = mean_
            out["timing"] = {"ms": ms, "synced_ms": wall, "collective_ms": spent[0] * 1e3}
            if group.is_main:  # the profiler in one rank; the other runs the same cycles
                prof = device_profile(torch, cycle, reps=1)
            else:
                cycle(), cycle()
                prof = None
            if prof is not None:
                out["timing"].update(profiled_ms=prof[0], busy_ms=prof[1], memcpy_ms=sum(
                    r[0] for r in prof[2] if "memcpy" in r[2].lower()))

    # MNIST at DCGANConfig(): the projection D with sn and max-norm, rcgan-u
    mb = DP["mnist_batch"]
    cfg = DCGANConfig(batch_size=mb, disc_type="projection", spectral_norm=True, max_norm=True)
    acfg = MnistAlgoConfig(algorithm="rcgan", estimate_confuse=True, perm_regularizer=True,
                           loss_fn="hinge")
    mtr = MnistTrainer(cfg, acfg, MnistTrainConfig(), build_confusion(0.3)[0], group=group,
                       device=dev)
    mts = mtr.init(seed)
    rs = np.random.RandomState(seed + 1)
    counts, losses = [], []
    for it in range(2):
        batch = {"images": rs.rand(mb, 28, 28, 1).astype(np.float32),
                 "y_real": rs.randint(0, 10, mb), "y_gen": rs.randint(0, 10, mb),
                 "y_fake": rs.randint(0, 10, mb),
                 "y_real_weights": rs.uniform(-0.5, 1.5, (mb, 10)).astype(np.float32)}
        runtime.reset_launch_counts()
        mts, m = mtr.step(mts, batch, seed + it)
        torch.cuda.synchronize()
        counts.append(runtime.launch_counts())
        losses.append({k: float(m[k]) for k in ("d_loss", "g_loss")})
        losses[-1]["prob_real_rows"] = int(m["prob_real"].shape[0])
    out["mnist"] = {"counts": counts, "losses": losses, "digest": state_digest(torch, mts)}
    return out


def dp_app_rank(group, argv):
    """Phase 12, ``cifar_app.main`` in a spawned rank of two gloo ranks on
    cuda:0: each cycle's launches, the final state's digest, the accuracy
    (rank 0) and the app's stats."""
    import torch

    from rcgan_tpu_torch.apps import cifar_app
    from rcgan_tpu_torch.ops.kernels import runtime
    from rcgan_tpu_torch.train.cifar_loop import CifarTrainer

    cycles = []
    step = CifarTrainer.step

    def counted(self, ts, d_batches, g_labels, iteration, seed_, noise=None):
        before = runtime.launch_counts()
        out = step(self, ts, d_batches, g_labels, iteration, seed_, noise)
        after = runtime.launch_counts()
        cycles.append((iteration, {k: after[k] - before[k] for k in after}))
        return out

    CifarTrainer.step = counted
    stats = {}
    runtime.reset_launch_counts()
    ts, acc = cifar_app.main(argv, device=str(group.device), stats=stats)
    torch.cuda.synchronize()
    return {"cycles": cycles, "counts": runtime.launch_counts(),
            "digest": state_digest(torch, ts), "acc": acc, "stats": stats}


def dp_close(ref, got, init, lr: float) -> dict:
    """Readings of a data-parallel state ``got`` against ``ref`` after the
    same updates from ``init`` (bridge layouts, numpy), by the rule of
    ``tests/test_torch_parallel_cifar.py``: the share of the live tensors'
    elements whose delta lies outside JAX's tolerance (``rtol 1e-4, atol
    2e-3`` of the tensor's update scale; limit 1e-3), the largest
    difference in units of lr per update (limit 2), the moments' worst
    error in units of the tensor's largest (limit 2e-3) and SN ``u``'s."""
    import numpy as np

    off = live = 0
    worst_lr = worst_mom = worst_u = 0.0
    for g, ps in ref.groups.items():
        adam = ref.opt_states[g][0]
        count = max(int(np.asarray(adam.count)), 1)
        group_max = max(np.abs(a).max() for d in adam.mu.values() for a in d.values())
        for la, vs in ps.items():
            for v, want in vs.items():
                mine, p0 = got.groups[g][la][v], init.groups[g][la][v]
                worst_lr = max(worst_lr, float(np.abs(mine - want).max()) / (lr * count))
                if np.abs(adam.mu[la][v]).max() <= 1e-4 * group_max:
                    continue
                d = want - p0
                s = max(float(np.abs(d).max()), 1e-8)
                bad = np.abs((mine - p0) / s - d / s) > 2e-3 + 1e-4 * np.abs(d / s)
                off, live = off + int(bad.sum()), live + bad.size
                for mom in ("mu", "nu"):
                    w = getattr(adam, mom)[la][v]
                    m = getattr(got.opt_states[g][0], mom)[la][v]
                    sc = max(float(np.abs(w).max()), 1e-30)
                    worst_mom = max(worst_mom, float(np.max(np.abs(m - w) - 1e-4 * np.abs(w)))
                                    / sc)
    for la, vs in ref.state.items():
        worst_u = max(worst_u, float(np.max(np.abs(got.state[la]["u"] - vs["u"])
                                            - 1e-4 * np.abs(vs["u"]))))
    return {"off_share": off / max(live, 1), "lr_units": worst_lr, "moments": worst_mom,
            "u": worst_u}


def parallel_slice(torch, dev, seed: int, card: str) -> dict:
    """Phase 12: data parallelism (module doc, item 12).  Returns the
    launches of each kernel over the ranks' counted runs (``counts``)."""
    import os
    import pickle
    import shutil

    import numpy as np

    from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
    from rcgan_tpu_torch.bridge import to_jax_train_state, train_state_from_jax
    from rcgan_tpu_torch.data.confusion import build_confusion
    from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
    from rcgan_tpu_torch.ops.kernels import runtime
    from rcgan_tpu_torch.parallel import launch
    from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer

    totals = {k: 0 for k in runtime.KERNELS}

    def add(c):
        for k, v in c.items():
            totals[k] += v

    # ---- NCCL at world size 1, in this process: the group's path gives the
    # bits of the path without it
    import datetime

    import torch.distributed as dist

    from rcgan_tpu_torch.parallel.mesh import DataGroup, free_port

    t = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=DP_TIMEOUT))
    try:
        nc = dp_nccl_run(DataGroup(rank=0, world_size=1, device=torch.device("cuda", 0),
                                   backend="nccl"), seed)
    finally:
        dist.destroy_process_group()
    print(f"  NCCL world 1: {time.perf_counter() - t:.1f} s", flush=True)
    for alg, perm in (("rcgan", False), ("rcgan-u", True)):
        r = nc[alg]
        want = [cycle_counts(alg, perm, 5, it > 0) for it in range(2)]
        for c in r["counts"]:
            add(c)
        check(nc["backend"] == "nccl" and r["counts"] == want and not r["differ"] and r["same"]
              and r["costs_equal"] and all(got == exp for got, exp in r["bytes"]),
              f"data parallel, NCCL world 1, {alg} bf16 batch {DP['nccl_batch']}: two cycles "
              f"through the group bit-equal to two without ({r['compared'] - len(r['differ'])} "
              f"of {r['compared']} tensors, costs equal {r['costs_equal']}; differ "
              f"{r['differ'][:3]}), launches {r['counts'][-1]} (want {want[-1]}), bytes "
              f"all-reduced {r['bytes']} (got, want)")
        prof = "" if math.isnan(r["busy"]) else (
            f"; profiled cycle {r['wall']:.3f} ms, device busy {r['busy']:.3f} ms, of it NCCL's "
            f"kernels {r['nccl_ms']:.3f} ms ({r['nccl_ms'] / r['busy']:.2%})")
        print(f"  data parallel NCCL world 1, {alg}, bf16, batch {DP['nccl_batch']}, on {card}: "
              f"{r['ms']:.3f} ms per cycle (CUDA events, median of {DP['timed']}); "
              f"{r['bytes'][-1][0] / 1e6:.3f} MB all-reduced per cycle{prof}", flush=True)

    # ---- two gloo ranks sharing the card: one model, launches per rank, layout
    t = time.perf_counter()
    ranks = launch(dp_gloo_rank, 2, backend="gloo", devices=["cuda:0", "cuda:0"],
                   args=(seed,), timeout=DP_TIMEOUT)
    print(f"  two gloo ranks on cuda:0: {time.perf_counter() - t:.1f} s for the spawned ranks",
          flush=True)
    for key, alg, perm in (("rcgan", "rcgan", False), ("rcgan-u", "rcgan-u", True),
                           ("rcgan normalization_g=False", "rcgan", False)):
        want = [dict(cycle_counts(alg, perm, 5, True),
                     **({"cond_bn": 0} if "normalization_g" in key else {}))] * 2
        per = [r[key] for r in ranks]
        for r in per:
            for c in r["counts"]:
                add(c)
        check(per[0]["digest"] == per[1]["digest"]
              and all(r["counts"] == want for r in per)
              and all(got == exp for r in per for got, exp in r["bytes"])
              and all(math.isfinite(v) for r in per for c in r["costs"] for v in c.values())
              and per[0]["costs"] == per[1]["costs"],
              f"data parallel, two gloo ranks on one card, {key}, float32, batch "
              f"{DP['gloo_batch']} a rank, two cycles: whole states bit-equal "
              f"({per[0]['digest'][:12]} / {per[1]['digest'][:12]}), each rank's launches a "
              f"cycle {per[0]['counts'][-1]} and {per[1]['counts'][-1]} (want {want[-1]}), bytes "
              f"{per[0]['bytes']} (got, want), costs {per[0]['costs'][-1]}")
    for r, rk in enumerate(ranks):
        tm = rk["timing"]
        print(f"  data parallel, two gloo ranks sharing {card} (correctness only: says nothing "
              f"of scaling), rcgan float32 batch {DP['gloo_batch']} a rank, rank {r}: "
              f"{tm['ms']:.3f} ms per cycle (CUDA events, median of {DP['timed']}); a cycle "
              f"with the card synchronised around each collective {tm['synced_ms']:.3f} ms, of "
              f"it {tm['collective_ms']:.3f} ms inside the collectives "
              f"({tm['collective_ms'] / tm['synced_ms']:.1%}; gloo stages each buffer through "
              f"the host); {rk['rcgan']['bytes'][-1][0] / 1e6:.3f} MB all-reduced per cycle",
              flush=True)
        if "busy_ms" in tm:
            print(f"    rank {r} profiled cycle {tm['profiled_ms']:.3f} ms, device busy "
                  f"{tm['busy_ms']:.3f} ms, of it the collectives' host staging copies "
                  f"(memcpy) {tm['memcpy_ms']:.3f} ms ({tm['memcpy_ms'] / tm['busy_ms']:.2%})",
                  flush=True)

    # the same global batches on one rank, normalization_g=False (per-rank
    # batch moments are the layout's one difference), both sides under
    # deterministic algorithms; each cycle from one state (the two ranks'
    # state before it), as phase 7's card-vs-CPU check takes its cycles, so
    # that no earlier cycle's rounding is carried in.  The costs are held
    # to JAX's tolerance in both cycles.  Cycle 2 (Adam past its first
    # steps) is held to JAX's tolerances on the state too.  Cycle 1 starts
    # Adam from zero moments, where an update is about sign(g) * lr: a
    # float32 gradient at rounding level flips sign between the two sum
    # orders and moves a weight by 2 lr, and the next critic steps carry it
    # into the moments and SN's u (on an H100: mu 2.3e-3 of a tensor's max,
    # u 2.4e-5, against JAX's 2e-3 and 1e-5); cycle 1's state is held to the
    # max limits of phase 7's float32 cycle at iteration 1 (train_limits)
    c_mat, _ = build_confusion(0.6)
    tcfg = CifarTrainConfig()
    cfg, acfg = ResnetGANConfig(algorithm="rcgan", normalization_g=False), \
        CifarAlgoConfig(algorithm="rcgan")
    tr = CifarTrainer(cfg, acfg, tcfg, c_mat, dev, torch.float32)
    feeds = dp_cifar_feeds(seed, 2 * DP["gloo_batch"], tcfg.n_critic, tcfg.gen_bs_multiple, 2)
    two = ranks[0]["rcgan normalization_g=False"]
    start = to_jax_train_state(tr.init(seed))
    for it, (d, g) in enumerate(feeds):
        with deterministic_algorithms(torch):
            ts = train_state_from_jax(start, cfg, acfg, tcfg, dev)
            ts, m = tr.step(ts, d, g, it + 1, seed + it)
        one_np = to_jax_train_state(ts)
        r = dp_close(one_np, two["states"][it], start, tcfg.lr)
        tr_r, where = train_readings(one_np, two["states"][it], m, two["costs"][it], tcfg.lr,
                                     {"gen": 1, "disc": tcfg.n_critic})
        cost_ok = all(abs(two["costs"][it][k] - float(m[k])) <= 1e-5 + 1e-4 * abs(float(m[k]))
                      for k in ("d_cost", "d_cost_mean", "g_cost"))
        jax_ok = (r["off_share"] <= 1e-3 and r["lr_units"] <= 2.0 and r["moments"] <= 2e-3
                  and r["u"] <= 1e-5)
        lim = {k: v[1] for k, v in train_limits(1, one_param_of(ts)).items()}
        train_ok = bool(lim) and all(v <= lim[k] for k, v in tr_r.items() if k != "cost")
        check(cost_ok and (jax_ok if it else train_ok),
              f"data parallel, layout: two gloo ranks against one rank, rcgan "
              f"normalization_g=False, float32, global batch {2 * DP['gloo_batch']}, cycle "
              f"{it + 1} from one state, its state held to "
              f"{'JAX' if it else 'the max limits of phase 7 iteration 1'}: costs "
              f"{two['costs'][it]['d_cost']:.6f}/"
              f"{float(m['d_cost']):.6f} (d), {two['costs'][it]['g_cost']:.6f}/"
              f"{float(m['g_cost']):.6f} (g); deltas outside JAX's tolerance "
              f"{r['off_share']:.2e} of the live elements (limit 1e-3), largest "
              f"{r['lr_units']:.3f} lr per update (limit 2), moments {r['moments']:.2e} (limit "
              f"2e-3), u {r['u']:.2e} (limit 1e-5); phase 7's readings: " + ", ".join(
                  f"{k} {v:.3g} (limit {lim.get(k)}){' at ' + where[k] if k in where else ''}"
                  for k, v in tr_r.items()))
        start = two["states"][it]

    mn = [r["mnist"] for r in ranks]
    want = [MNIST_PATH_COUNTS] * 2
    for r in mn:
        for c in r["counts"]:
            add(c)
    check(mn[0]["digest"] == mn[1]["digest"] and all(r["counts"] == want for r in mn)
          and mn[0]["losses"] == mn[1]["losses"]
          and all(math.isfinite(v) for r in mn for x in r["losses"] for v in x.values())
          and mn[0]["losses"][-1]["prob_real_rows"] == DP["mnist_batch"],
          f"data parallel, two gloo ranks on one card, MnistTrainer at DCGANConfig(), float32, "
          f"batch {DP['mnist_batch'] // 2} a rank, two iterations: whole states bit-equal, "
          f"launches an iteration {mn[0]['counts'][-1]} and {mn[1]['counts'][-1]} (want "
          f"{MNIST_PATH_COUNTS}), losses {mn[0]['losses'][-1]}, prob_real gathered to "
          f"{mn[0]['losses'][-1]['prob_real_rows']} rows")

    # ---- the app in two gloo ranks on the card, then the sampler on its checkpoint
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke_dp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    os.environ["RCGAN_SYNTH_CACHE"] = "0"
    argv = DP_APP + ["--seed", str(seed), "--parent_dir", root, "--data_dir",
                     os.path.join(root, "data"), "--log_file", os.path.join(root, "dp.log")]
    t = time.perf_counter()
    app = launch(dp_app_rank, 2, backend="gloo", devices=["cuda:0", "cuda:0"], args=(argv,),
                 timeout=DP_TIMEOUT)
    wall = time.perf_counter() - t
    runs = [d for d in os.listdir(root) if d.startswith("rcgan-u_alpha0.6_run-dp_")]
    run = os.path.join(root, runs[0]) if len(runs) == 1 else None
    ckpts = sorted(int(n) for n in os.listdir(os.path.join(run, "checkpoint"))
                   if n.isdigit()) if run else []
    text = open(os.path.join(root, "dp.log")).read()
    hist = {}
    if run:
        with open(os.path.join(run, "log.pkl"), "rb") as f:
            hist = pickle.load(f)
    iters = 4  # --niters 8 halved over two ranks; batch 32 doubled to 64
    for r in app:
        add(r["counts"])
    check(len(runs) == 1 and ckpts == list(range(iters))
          and {"samples_1.png", "samples_3.png", "log.pkl"} <= set(os.listdir(run))
          and "2 device(s); batch 64; iters 4" in text and "final generated label accuracy" in text
          and {"inception_50k", "dev_cost", "gen_label_acc"} <= set(hist)
          and app[0]["digest"] == app[1]["digest"] and app[1]["acc"] is None
          and 0.0 <= app[0]["acc"] <= 1.0
          and all([it for it, _ in r["cycles"]] == list(range(iters)) for r in app)
          and all(c == cycle_counts("rcgan-u", True, 5, it > 0) for r in app
                  for it, c in r["cycles"]),
          f"data parallel app, cifar_app.main in two gloo ranks on cuda:0 (rcgan-u, perm): "
          f"run dirs {runs}, checkpoints {ckpts}, both ranks' final states bit-equal "
          f"{app[0]['digest'] == app[1]['digest']}, accuracy {app[0]['acc']} (rank 1: "
          f"{app[1]['acc']}), each cycle's launches per rank as cycle_counts, inception, dev "
          f"cost, samples and gen-label-acc landed")
    tr_s, tr_n = app[0]["stats"].get("train", (float("nan"), 0))
    print(f"  data parallel app on two gloo ranks sharing {card}: {wall:.1f} s with the spawn; "
          f"{tr_n} cycles in {tr_s:.3f} s on rank 0 (global batch 64)", flush=True)
    rng = np.random.default_rng(seed)
    served = sampler_slice(torch, dev, "cifar", os.path.join(run, "checkpoint"),
                           lambda n: rng.standard_normal((n, 128)).astype(np.float32),
                           (1, 100), {"/sample?labels=3&seed=1": 1, "/sample?n=100&seed=2": 100},
                           SLICE_ATOL, "the data-parallel app's checkpoint")
    check(served["cond_bn"] == 2 * 7 and served["conv3x3"] == 2 * 6 and served["sn"] == 0,
          f"CIFAR serving of the app's checkpoint, two passes: launches {served} (want 7 cond_bn "
          f"and 6 FFMA conv3x3 a pass)")
    add(served)
    shutil.rmtree(root, ignore_errors=True)
    os.environ.pop("RCGAN_SYNTH_CACHE", None)
    return {"counts": totals}


# Phase 13, the compiled programs (``train/graphs.py``) at ``bench.py``'s
# configuration: the CIFAR cycle (bf16, batch 64, n_critic 5) on a resident
# dataset of 4 096 images, cycles 0 (eager in both: no G step) to 3, then a
# ``step_scan`` block of 8; MNIST ``DCGANConfig()`` rcgan-u + perm, bf16,
# batch 100, one ``step_scan`` block of 50 on 5 000 resident digits; the
# CIFAR sampler at every bucket, float32.  Times are medians of 12 by CUDA
# events, eager body against replays.
COMPILED = {"dataset": 4096, "batch": 64, "cycles": 4, "scan": 8, "timed": 12,
            "mnist_dataset": 5000, "mnist_block": 50}


def compiled_slice(torch, dev, seed: int, card: str) -> dict:
    """Phase 13: each compiled program, captured, against its eager body on
    the same start state under deterministic algorithms, every tensor of
    the state bit-equal (sha256 of the whole state, and the metrics); the
    launches of each replay against ``cycle_counts`` / 4 sn an MNIST
    iteration / 6 + 7 a float32 sampler pass; then per program, eager
    against captured: ms per cycle, iteration or pass (CUDA events), the
    device's busy ms (profiler), the capture's host seconds and the graph
    pool's MB.  Returns ``{"counts", "variants", "rows"}``: the launches of
    the checked runs, and the printed numbers."""
    import numpy as np

    from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
    from rcgan_tpu_torch.algorithms.mnist import MnistAlgoConfig
    from rcgan_tpu_torch.core import rng as trng
    from rcgan_tpu_torch.data.cifar10 import device_dataset_of
    from rcgan_tpu_torch.data.confusion import build_confusion, corrupt_dataset_numpy
    from rcgan_tpu_torch.models.dcgan import DCGANConfig
    from rcgan_tpu_torch.models.resnet_gan import Generator, ResnetGANConfig
    from rcgan_tpu_torch.ops.kernels import runtime
    from rcgan_tpu_torch.serving import Sampler
    from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer
    from rcgan_tpu_torch.train.mnist_loop import MnistTrainConfig, MnistTrainer
    from rcgan_tpu_torch.train.state import ScalelessAdam

    totals = {k: 0 for k in runtime.KERNELS}
    var_totals = dict.fromkeys(runtime.VARIANTS["conv3x3"], 0)
    rows = {}

    def counted(fn):
        runtime.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got, var = runtime.launch_counts(), runtime.variant_counts("conv3x3")
        for k in totals:
            totals[k] += got[k]
        for k in var_totals:
            var_totals[k] += var[k]
        return out, got, var

    def timed(label, eager_fn, graph_fn, step, per=1):
        """eager against captured: ms (median of COMPILED["timed"], CUDA
        events), busy ms (profiler), both per ``per`` units."""
        row, by_name = {}, {}
        for mode, fn in (("eager", eager_fn), ("captured", graph_fn)):
            ms = event_ms(torch, fn, reps=COMPILED["timed"], warmup=1) / per
            wall, busy, kernels = device_profile(torch, fn, reps=1 if mode == "eager" else 2)
            row[mode] = {"ms": ms, "busy_ms": busy / per, "profiled_ms": wall / per}
            by_name[mode] = {}
            for t, _, name in kernels:
                by_name[mode][name] = by_name[mode].get(name, 0.0) + t / per
        row["capture_s"], row["pool_mb"] = step.capture_s, step.pool_bytes / 2 ** 20
        rows[label] = row
        e, c = row["eager"], row["captured"]
        print(f"  {label} on {card}: eager {e['ms']:.3f} ms (busy {e['busy_ms']:.3f} ms, "
              f"{e['busy_ms'] / e['profiled_ms']:.0%} of its profiled time), captured "
              f"{c['ms']:.3f} ms (busy {c['busy_ms']:.3f} ms, "
              f"{c['busy_ms'] / c['profiled_ms']:.0%}); {e['ms'] / c['ms']:.2f}x; capture "
              f"{row['capture_s']:.2f} s, graph pool {row['pool_mb']:.1f} MB", flush=True)
        names = set(by_name["eager"]) | set(by_name["captured"])
        diff = sorted(((by_name["captured"].get(k, 0.0) - by_name["eager"].get(k, 0.0), k)
                       for k in names), reverse=True)
        print("    device ms captured minus eager, by kernel (largest 5): " + "; ".join(
            f"{d:+.3f} {k[:60]}" for d, k in diff[:5]), flush=True)

    t0 = time.perf_counter()
    # ---- Adam with its scalars on the device against the host-float form
    # (lr as addcmul's alpha): bit-equal, on the card as on the CPU, so that
    # the float32 card-vs-CPU checks of phases 7, 9 and 10 see one arithmetic
    gen = torch.Generator().manual_seed(seed + 15)
    shapes = [(3, 3, 128, 128), (128,), (1,), (1000003,)]
    for b1, b2 in ((0.0, 0.9), (0.5, 0.999)):
        adam = ScalelessAdam(b1, b2)
        params = [torch.randn(sh, generator=gen).to(dev) for sh in shapes]
        ref = [p.clone() for p in params]
        st, st_ref = adam.init(params), adam.init(ref)
        for t, lr in enumerate((2e-4, 1.9e-4, 1e-5)):
            grads = [(torch.randn(sh, generator=gen) * 10.0 ** (t - 1)).to(dev) for sh in shapes]
            adam.update_(params, grads, st, lr)
            with torch.no_grad():
                st_ref.count += 1
                torch._foreach_mul_(st_ref.mu, b1)
                torch._foreach_add_(st_ref.mu, grads, alpha=1.0 - b1)
                torch._foreach_mul_(st_ref.nu, b2)
                torch._foreach_addcmul_(st_ref.nu, grads, grads, value=1.0 - b2)
                denom = torch._foreach_div(st_ref.nu, float(adam.scalars(st_ref.count, lr)[2]))
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, adam.eps)
                step = torch._foreach_div(st_ref.mu, float(adam.scalars(st_ref.count, lr)[1]))
                torch._foreach_div_(step, denom)
                torch._foreach_add_(ref, step, alpha=-lr)
        differ = sum(int((a != r).sum()) for a, r in zip(params + st.mu + st.nu,
                                                           ref + st_ref.mu + st_ref.nu))
        check(differ == 0, f"Adam (b1 {b1}, b2 {b2}) on the card, lr and bias corrections read "
                           f"from a device tensor, three steps: bit-equal to the host-float form "
                           f"(alpha=-lr) at {shapes} ({differ} elements differ)")

    # ---- CIFAR: step and step_scan, rcgan and rcgan-u
    c_mat, c_inv = build_confusion(0.6)
    n, b = COMPILED["dataset"], COMPILED["batch"]
    rs = np.random.RandomState(seed + 13)
    y_real, y_gen, y_fake, inv_w = corrupt_dataset_numpy(rs, rs.randint(0, 10, n), c_mat, c_inv)
    ds = device_dataset_of({"images": rs.randint(0, 256, (n, 3072)).astype(np.uint8),
                            "labels": y_real, "labels_random": y_gen, "labels_biased": y_fake,
                            "labels_inv_weights": inv_w}, dev)
    tcfg = CifarTrainConfig()
    nc, gm = tcfg.n_critic, tcfg.gen_bs_multiple

    def feed():
        return rs.randint(0, n, (nc, b)), rs.randint(0, n, gm * b)

    for alg, perm in (("rcgan", False), ("rcgan-u", True)):
        cfg = ResnetGANConfig(algorithm=alg)
        acfg = CifarAlgoConfig(algorithm=alg, perm_classifier=perm, confuse_init=perm)
        eager = CifarTrainer(cfg, acfg, tcfg, c_mat, dev, torch.bfloat16, ds, graphs=False)
        graph = CifarTrainer(cfg, acfg, tcfg, c_mat, dev, torch.bfloat16, ds)
        check(graph.graphs and not eager.graphs, f"CIFAR {alg}: a trainer on the card with no "
                                                  f"group captures by default")
        with deterministic_algorithms(torch):
            ts_e, ts_g = eager.init(seed), graph.init(seed)
            for it in range(COMPILED["cycles"]):
                idx, gi = feed()
                gl = {"random": y_gen[gi], "biased": y_fake[gi]}
                (ts_g, m_g), got, var = counted(lambda: graph.step(
                    ts_g, {"index": idx}, gl, it, trng.fold_in(seed, it)))
                ts_e, m_e = eager.step(ts_e, {"index": idx}, gl, it, trng.fold_in(seed, it))
                compared, differ, same = state_differences(torch, ts_g, ts_e)
                # the whole state's sha256 after the last cycle
                last = it == COMPILED["cycles"] - 1
                digests = (state_digest(torch, ts_g), state_digest(torch, ts_e)) if last \
                    else ("", "")
                want = cycle_counts(alg, perm, nc, g_step=it > 0)
                want_v = cycle_variants(alg, perm, nc, g_step=it > 0)
                how = ("eager (no G step)" if it == 0 else "the warm-up before the capture"
                       if it == 1 else f"replay {graph.captured.replays}")
                check(not differ and same and digests[0] == digests[1]
                      and all(torch.equal(m_g[k], m_e[k]) for k in m_e)
                      and got == want and var == want_v,
                      f"CIFAR {alg} step, cycle at iteration {it} ({how}) against the eager "
                      f"body: {compared} tensors, {len(differ)} differ {differ[:3]}"
                      + (f", sha256 {digests[0][:12]} / {digests[1][:12]}" if last else "")
                      + f", metrics equal, launches {got} (want {want}), conv3x3 by route {var}")
            check(graph.captured.captures == 1 and graph.captured.replays == COMPILED["cycles"] - 2,
                  f"CIFAR {alg}: {graph.captured.captures} capture, {graph.captured.replays} "
                  f"replays")
            # step_scan: a block of K through one copy, against K eager cycles
            k = COMPILED["scan"]
            blk = [feed() for _ in range(k)]
            idx = np.stack([x for x, _ in blk])
            gr = np.stack([y_gen[gi] for _, gi in blk])
            gb = np.stack([y_fake[gi] for _, gi in blk])
            before = graph.captured.replays
            (ts_g, ms_g), got, _ = counted(lambda: graph.step_scan(ts_g, idx, gr, gb, seed))
            ms_e = []
            for j in range(k):
                ts_e, m = eager.step(ts_e, {"index": idx[j]}, {"random": gr[j], "biased": gb[j]},
                                     ts_e.step, trng.fold_in(seed, ts_e.step))
                ms_e.append(m)
            compared, differ, same = state_differences(torch, ts_g, ts_e)
            want = {kk: k * v for kk, v in cycle_counts(alg, perm, nc, True).items()}
            check(not differ and same and state_digest(torch, ts_g) == state_digest(torch, ts_e)
                  and all(torch.equal(ms_g[kk], torch.stack([m[kk] for m in ms_e]))
                          for kk in ms_g) and got == want,
                  f"CIFAR {alg} step_scan, a block of {k} (one capture for the block's rows, "
                  f"{graph.captured.replays - before} replays) against {k} eager cycles: "
                  f"{compared} tensors, {len(differ)} differ {differ[:3]}, metrics [K] equal, "
                  f"launches {got} (want {want})")

        def cycle_of(tr, state):
            def run():
                idx, gi = feed()
                state["ts"], m = tr.step(state["ts"], {"index": idx},
                                         {"random": y_gen[gi], "biased": y_fake[gi]},
                                         state["ts"].step, trng.fold_in(seed, state["ts"].step))
                return m
            return run

        timed(f"CIFAR {alg} cycle, bf16, batch {b}", cycle_of(eager, {"ts": ts_e}),
              cycle_of(graph, {"ts": ts_g}), graph.captured)
        del eager, graph, ts_e, ts_g
        print(f"  [CIFAR {alg}: {time.perf_counter() - t0:.1f} s into phase 13]", flush=True)

    # ---- MNIST: a captured step_scan block of 50 against the eager body
    mcfg = DCGANConfig(disc_type="projection")  # full width, the recipes' D
    macfg = MnistAlgoConfig(algorithm="rcgan", estimate_confuse=True, perm_regularizer=True)
    mb, mn, blk_n = mcfg.batch_size, COMPILED["mnist_dataset"], COMPILED["mnist_block"]
    mrs = np.random.RandomState(seed + 14)
    mds = {"images": torch.from_numpy(mrs.rand(mn, 28, 28, 1).astype(np.float32)).to(dev),
           "y_real_weights": torch.from_numpy(
               np.eye(10, dtype=np.float32)[mrs.randint(0, 10, mn)]).to(dev)}
    mds.update({k: torch.from_numpy(mrs.randint(0, 10, mn)).to(dev)
                for k in ("y_real", "y_gen", "y_fake")})
    c3 = build_confusion(0.3)[0]
    meager = MnistTrainer(mcfg, macfg, MnistTrainConfig(), c3, device=dev,
                          compute_dtype=torch.bfloat16, graphs=False)
    mgraph = MnistTrainer(mcfg, macfg, MnistTrainConfig(), c3, device=dev,
                          compute_dtype=torch.bfloat16)
    with deterministic_algorithms(torch):
        ts_e, ts_g = meager.init(seed), mgraph.init(seed)
        idx = np.stack([mrs.permutation(mn)[:mb] for _ in range(blk_n)])
        (ts_g, ms_g), got, _ = counted(lambda: mgraph.step_scan(ts_g, mds, idx, seed))
        ts_e, ms_e = meager.step_scan(ts_e, mds, idx, seed)
        compared, differ, same = state_differences(torch, ts_g, ts_e)
        want = {kk: blk_n * v for kk, v in MNIST_PATH_COUNTS.items()}
        check(not differ and same and state_digest(torch, ts_g) == state_digest(torch, ts_e)
              and all(torch.equal(ms_g[kk], ms_e[kk]) for kk in ms_e) and got == want
              and mgraph.captured.captures == 1 and mgraph.captured.replays == blk_n - 1,
              f"MNIST rcgan-u + perm step_scan, bf16, batch {mb}, a block of {blk_n} (the warm-up, "
              f"then {mgraph.captured.replays} replays) against the eager body: {compared} "
              f"tensors, {len(differ)} differ {differ[:3]}, metrics equal, launches {got} "
              f"(want {want})")

    def iteration_of(tr, state):
        def run():
            one = np.stack([mrs.permutation(mn)[:mb]])
            state["ts"], m = tr.step_scan(state["ts"], mds, one, seed)
            return m
        return run

    timed(f"MNIST rcgan-u + perm iteration, bf16, batch {mb}", iteration_of(meager, {"ts": ts_e}),
          iteration_of(mgraph, {"ts": ts_g}), mgraph.captured)
    del meager, mgraph, ts_e, ts_g, mds
    print(f"  [MNIST: {time.perf_counter() - t0:.1f} s into phase 13]", flush=True)

    # ---- the CIFAR sampler, float32, every bucket
    gen = Generator(ResnetGANConfig(), seed, device=dev)
    s_eager, s_graph = Sampler(gen, BUCKETS, graphs=False), Sampler(gen, BUCKETS)
    for bucket in BUCKETS:
        z = np.random.RandomState(seed + bucket).standard_normal((bucket, 128)).astype(np.float32)
        labels = np.arange(bucket) % 10
        first, got, _ = counted(lambda: s_graph.sample_with_z(z, labels))   # warm-up, capture
        again, got, _ = counted(lambda: s_graph.sample_with_z(z, labels))   # a replay
        ref = s_eager.sample_with_z(z, labels)
        want = {**dict.fromkeys(runtime.KERNELS, 0), "conv3x3": 6, "cond_bn": 7}
        check(np.array_equal(first, ref) and np.array_equal(again, ref) and got == want,
              f"CIFAR sampler, bucket {bucket}, float32: the captured pass (warm-up and replay) "
              f"bit-equal to the eager one {list(ref.shape)}, a replay's launches {got} (want "
              f"{want})")
        timed(f"CIFAR sampler pass at bucket {bucket}, float32",
              lambda: s_eager.sample_with_z(z, labels), lambda: s_graph.sample_with_z(z, labels),
              s_graph._passes_at[bucket][1])
    return {"counts": totals, "variants": var_totals, "rows": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint_dir", default=None,
                   help="serve this generator.npz instead of seeded random weights")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    # the phases' host seconds, printed as each ends
    clock = [time.perf_counter(), time.perf_counter()]

    def lap(phase: str):
        now = time.perf_counter()
        print(f"[{phase}: {now - clock[0]:.1f} s; {now - clock[1]:.1f} s in all]", flush=True)
        clock[0] = now

    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: this smoke run needs an NVIDIA GPU", flush=True)
        return 2

    import numpy as np

    from rcgan_tpu_torch.core import rng as trng
    from rcgan_tpu_torch.entry import entry
    from rcgan_tpu_torch.models.resnet_gan import Generator, ResnetGANConfig, sample
    from rcgan_tpu_torch.ops.kernels import runtime
    from rcgan_tpu_torch.ops.kernels.conv_kernel import (conv3x3, conv3x3_plain,
                                                         conv3x3_variant, ffma_geometry)
    from rcgan_tpu_torch.ops.kernels.norm_kernel import cond_batchnorm, cond_batchnorm_plain
    from rcgan_tpu_torch.ops.kernels.projection_kernel import (all_label_projection_logits,
                                                               projection_plain)
    from rcgan_tpu_torch.serving import Sampler, _to_png_grid, make_server, to_unit_range

    # ---------------------------------------------------------------- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a"
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    print(f"TF32 as the process starts: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)

    # ----------------------------------------------------------------- 2. build
    # one nvcc per CUDA source, all started together
    def timed_build(name):
        t = time.perf_counter()
        runtime.cuda_library(name)
        return time.perf_counter() - t

    t_all = time.perf_counter()
    cuda_sources = ("conv3x3", "conv3x3_wgmma", "sn", "projection", "cond_bn", "dequant")
    with concurrent.futures.ThreadPoolExecutor(len(cuda_sources)) as pool:
        builds = {name: pool.submit(timed_build, name) for name in cuda_sources}
        for name, fut in builds.items():
            print(f"build {name} (nvcc, sm_90a): {fut.result():.2f} s", flush=True)
    print(f"builds, all together: {time.perf_counter() - t_all:.2f} s", flush=True)
    gen_cpu = torch.Generator().manual_seed(args.seed)
    # the CUDA kernels as ptxas saw them (registers, spills, static shared
    # memory), and the dynamic shared memory each conv tile asks for
    for name in cuda_sources:
        log = runtime.build_logs.get(name)
        for line in (log or "not built by this process: no ptxas report\n").splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill", "not built")):
                print(f"  ptxas {name}: {line.strip()}", flush=True)
    smem = runtime.cuda_library("conv3x3_wgmma").conv3x3_wgmma_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    print("  conv3x3_wgmma dynamic shared memory per block: " + ", ".join(
        f"{bm} x {bn} tile {smem(bm, bn)} bytes" for bm, bn in ((64, 128), (128, 128), (128, 256))),
          flush=True)
    smem = runtime.cuda_library("conv3x3").conv3x3_ffma_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    print("  conv3x3 (FFMA) dynamic shared memory per block: " + ", ".join(
        f"{bm} x {bm} tile {smem(bm, size)} bytes ({name})"
        for bm in (128, 64) for size, name in ((4, "float32"), (2, "bf16"))), flush=True)

    # ---- the float32 policy, before any Sampler exists: a float32 entry()
    # turns TF32 off itself (core.module.float32_policy); its logits are held
    # again, bit for bit, after phase 4 has built a Sampler
    policy_fwd, policy_args = entry(dev, torch.float32, seed=args.seed)
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          f"a float32 EntryForward, built before any Sampler, leaves TF32 off: "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    policy_logits = policy_fwd(*policy_args).clone()
    torch.cuda.synchronize()
    # ---- z keyed per example: a row does not depend on the batch it is drawn
    # in, on the card as on the CPU (the same integer hash; log, cos and sqrt
    # round differently on the two: 1e-5 of values below 6.7)
    zs = trng.example_normal(args.seed + 11, 128, 128, dev)
    z_cpu = trng.example_normal(args.seed + 11, 128, 128, "cpu")
    check(torch.equal(trng.example_normal(args.seed + 11, 40, 128, dev, first_index=64), zs[64:104])
          and torch.equal(trng.example_bits(args.seed + 11, 128, 128, dev).cpu(),
                          trng.example_bits(args.seed + 11, 128, 128, "cpu"))
          and (zs.cpu() - z_cpu).abs().max().item() <= 1e-5
          and bool((trng.example_normal(args.seed + 12, 128, 128, dev) != zs).any(dim=1).all()),
          f"example_normal on the card: rows [64, 104) of a draw of 128 equal a draw of 40 from "
          f"index 64, the hashes equal the CPU's, the values lie within "
          f"{(zs.cpu() - z_cpu).abs().max().item():.1e} of the CPU's (limit 1e-5), another seed "
          f"gives other rows; mean {zs.mean().item():.4f}, variance {zs.var().item():.4f}")

    # ------------------------------------------------- 3. kernels against plain
    max_err = {k: 0.0 for k in runtime.KERNELS}
    inputs = {}  # float32 inputs at B in KERNEL_BATCHES, reused for timing
    for b in KERNEL_BATCHES + (128,):
        for s, c in sorted(set(COND_BN_SHAPES)):
            x = torch.randn(b, s, c, generator=gen_cpu) * 2.0 + 0.5
            labels = torch.randint(0, 10, (b,), generator=gen_cpu)
            scale = 1.0 + 0.1 * torch.randn(10, c, generator=gen_cpu)
            offset = 0.1 * torch.randn(10, c, generator=gen_cpu)
            args_f32 = [t.to(dev) for t in (x, labels, scale, offset)]
            if b in KERNEL_BATCHES:
                inputs[("cond_bn", b, s, c)] = args_f32
            for name in ("float32", "bfloat16"):
                check_cond_bn(torch, *args_f32, name, "cond_bn", max_err)
    # conv3x3 at the generator's shapes and at the discriminator's, each call
    # on the route conv3x3_variant names; float32 at bucket 1 includes
    # split-K geometries of the FFMA kernel (on this card's SM count)
    sms = runtime.sm_count(torch.empty(1, device=dev))
    split_calls = []
    max_err["conv3x3_cudnn"] = 0.0
    max_err["conv3x3_bf16"] = {v: 0.0 for v in runtime.VARIANTS["conv3x3"]}
    for tag, batches, shapes in (("conv3x3", KERNEL_BATCHES, CONV_SHAPES),
                                 ("conv3x3_d", D_BATCHES, D_CONV_SHAPES)):
        for b in batches:
            for hw, c, o in sorted(set(shapes)):
                x = torch.relu(torch.randn(b, hw, hw, c, generator=gen_cpu))
                w = torch.randn(3, 3, c, o, generator=gen_cpu) * (2.0 / (9 * c)) ** 0.5
                args_f32 = [x.to(dev), w.to(dev)]
                if tag == "conv3x3" or b in D_TIMED_BATCHES:
                    inputs[(tag, b, hw, c, o)] = args_f32
                for name in ("float32", "bfloat16"):
                    route = check_conv3x3(torch, *args_f32, name, tag, max_err)
                    if route == "ffma" and name == "float32" and b == 1 \
                            and ffma_geometry(args_f32[0].shape, o, sms)[2] > 1:
                        split_calls.append((hw, c, o))
    check(len(split_calls) > 0, f"float32 at bucket 1: {len(split_calls)} conv(s) launched the "
                                f"FFMA kernel split over K, {sorted(set(split_calls))}")
    # conv3x3 in bf16 at every shape of the training cycle, with forward and
    # input-grad filters: each call takes the route conv3x3_variant names
    # (wgmma unless C or O is 3, then cuDNN) and matches the plain version;
    # the largest error is kept per route
    for tag, shapes in (("G", CONV_SHAPES), ("D", D_CONV_SHAPES)):
        for b in TRAIN_BATCHES:
            for hw, c, o in sorted(set(shapes)):
                for kind, (ci, co) in (("forward", (c, o)), ("input grad", (o, c))):
                    x = torch.randn(b, hw, hw, ci, generator=gen_cpu)
                    x = (torch.relu(x) if kind == "forward" else x).to(dev)
                    w = (torch.randn(3, 3, ci, co, generator=gen_cpu) * (2.0 / (9 * ci)) ** 0.5)
                    check_conv3x3(torch, x, w.to(dev), "bfloat16", f"conv3x3 {tag} {kind}",
                                  max_err)
    # a bf16 call with more tiles of M = B*H*W than a grid's y dimension
    # holds (65535): 8200 images of 32x32, 64 -> 64 channels, 65 600 tiles of
    # 128 pixels.  A conv is per image, so the output's first and last eight
    # images and the eight around tile 65535 are held against the plain
    # version of those images alone.
    gen_dev = torch.Generator(device=dev).manual_seed(args.seed)
    xb = torch.relu(torch.randn(BIG_M_BATCH, 32, 32, 64, generator=gen_dev, device=dev,
                                dtype=torch.bfloat16))
    wb = (torch.randn(3, 3, 64, 64, generator=gen_cpu) * (2.0 / 576) ** 0.5).to(dev, torch.bfloat16)
    before = runtime.variant_counts("conv3x3")
    got = conv3x3(xb, wb)
    ran = {k: n - before[k] for k, n in runtime.variant_counts("conv3x3").items()}
    res = [compare(torch, got[i:i + 8], conv3x3_plain(xb[i:i + 8].float(), wb.float()), "bfloat16")
           for i in (0, 65535 * 128 // 1024 - 4, BIG_M_BATCH - 8)]
    finite = bool(torch.isfinite(got).all())
    torch.cuda.synchronize()
    check(finite and all(ok for ok, _, _ in res) and ran == {"wgmma": 1, "ffma": 0, "cudnn": 0},
          f"conv3x3 [{BIG_M_BATCH},32,32,64]x[3,3,64,64] bfloat16, {BIG_M_BATCH * 1024 // 128} "
          f"M tiles, on wgmma (launched {ran}): finite {finite}, max abs err "
          f"{max(r[1] for r in res):.3e}, max rel err {max(r[2] for r in res):.3e}")
    del xb, got
    torch.cuda.empty_cache()
    # spectral norm, each group in one launch, against the plain version per
    # weight; a second run must give the same bits (no atomics)
    for tag, shapes in SN_GROUPS.items():
        check_sn_group(torch, [((torch.randn(m, cout, generator=gen_cpu) / m ** 0.5).to(dev),
                                torch.randn(1, cout, generator=gen_cpu).to(dev))
                               for m, cout in shapes], tag, max_err)
    for b in PROJ_BATCHES:
        feat = torch.randn(b, 128, generator=gen_cpu).to(dev)
        emb = torch.randn(10, 128, generator=gen_cpu).to(dev)
        wgan = torch.randn(b, 1, generator=gen_cpu).to(dev)
        inputs[("projection", b)] = [feat, emb, wgan]
        for dts in PROJ_DTYPES:
            targs = [t.to(getattr(torch, dt)) for t, dt in zip((feat, emb, wgan), dts)]
            got, ref = all_label_projection_logits(*targs), projection_plain(*targs)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            ok = got.dtype == torch.float32 and bool(torch.isfinite(got).all()) \
                and err <= PROJ_TOL * scale
            max_err["projection"] = max(max_err["projection"], err)
            check(ok, f"projection [{b},128]x[10,128], feat/emb/wgan in {'/'.join(dts)}: max abs "
                      f"err {err:.3e} (limit {PROJ_TOL} of scale {scale:.2f})")

    # --------------------------------------------------------------- 4. slice
    if args.checkpoint_dir:
        sampler = Sampler.from_checkpoint("cifar", args.checkpoint_dir, buckets=BUCKETS,
                                          device="cuda")
        gen = sampler.generator
    else:
        gen = Generator(ResnetGANConfig(), seed=args.seed, device="cuda")
        sampler = Sampler(gen, buckets=BUCKETS)
    cfg = gen.cfg
    check(torch.equal(policy_fwd(*policy_args), policy_logits),
          "the float32 EntryForward gives the same bits after a Sampler was built as before")
    del policy_fwd
    print(f"generator: dim_g {cfg.dim_g}, z_dim {cfg.z_dim}, "
          f"{sum(p.numel() for p in gen.parameters())} params, buckets {BUCKETS}", flush=True)

    # the card's generator against the same weights on the CPU (plain versions)
    cpu_gen = Generator(cfg, device="cpu")
    cpu_gen.load_state_dict({k: v.cpu() for k, v in gen.state_dict().items()})
    rng = np.random.default_rng(args.seed)
    for b in (8, 32):
        z = rng.standard_normal((b, cfg.z_dim)).astype(np.float32)
        lab = np.arange(b) % cfg.vocab_size
        on_card = sample(gen, torch.from_numpy(z).to(dev), torch.from_numpy(lab).to(dev)).cpu()
        on_cpu = sample(cpu_gen, torch.from_numpy(z), torch.from_numpy(lab))
        err = (on_card - on_cpu).abs().max().item()
        check(err <= SLICE_ATOL, f"generator on the card vs on the CPU, batch {b}, float32: "
                                 f"max abs err {err:.3e} (limit {SLICE_ATOL})")

    for bkt in BUCKETS:  # warm-up
        sampler.sample_with_z(rng.standard_normal((bkt, cfg.z_dim)).astype(np.float32),
                              np.arange(bkt) % cfg.vocab_size)
    torch.cuda.synchronize()

    srv = make_server(sampler, port=0, host="127.0.0.1")
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    server_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    server_thread.start()

    def get(path: str):
        t = time.perf_counter()
        try:
            with urllib.request.urlopen(base + path, timeout=300) as r:
                return r.status, r.read(), time.perf_counter() - t
        except urllib.error.HTTPError as e:
            return e.code, e.read(), time.perf_counter() - t

    requests = {"/sample?labels=3&seed=1": 1, "/sample?n=16&seed=2": 16,
                "/sample?n=100&seed=3": 100, "/sample?n=130&seed=4": 130}
    latency_ms: dict = {}
    try:
        runtime.reset_launch_counts()
        passes0 = sampler.passes
        # ---- the main path: concurrent requests through the coalescer
        with concurrent.futures.ThreadPoolExecutor(len(requests)) as pool:
            results = dict(zip(requests, pool.map(get, requests)))
        solo = [get("/sample?n=16&seed=7") for _ in range(2)]
        raw = sampler.sample_with_z(rng.standard_normal((130, cfg.z_dim)).astype(np.float32),
                                    np.arange(130) % cfg.vocab_size)
        torch.cuda.synchronize()
        counts, serve_variants = runtime.launch_counts(), runtime.variant_counts("conv3x3")
        passes = sampler.passes - passes0
        # ---- checks on what came back
        for path, n in requests.items():
            code, body, _ = results[path]
            side = int(np.ceil(np.sqrt(n)))
            try:
                size = png_size(body) if code == 200 else None
            except ValueError as e:
                size = str(e)
            check(code == 200 and size == (32 * side, 32 * side),
                  f"GET {path}: HTTP {code}, PNG {size}, want {32 * side}x{32 * side}")
        check(solo[0][0] == solo[1][0] == 200 and solo[0][1] == solo[1][1],
              "same request and seed twice gives identical images")
        check(raw.shape == (130, 32, 32, 3) and bool(np.isfinite(raw).all())
              and float(np.abs(raw).max()) <= 1.0,
              f"sample_with_z(130): shape {raw.shape}, finite, max |x| "
              f"{float(np.abs(raw).max()):.4f} <= 1")
        for path, want in (("/healthz", b"ok"), ("/models", b'["default"]')):
            code, body, _ = get(path)
            check(code == 200 and body == want, f"GET {path}: HTTP {code} {body[:40]!r}")
        code, body, _ = get("/metrics")
        text = body.decode()
        check(code == 200 and 'rcgan_requests_total{model="default"} 6' in text,
              "GET /metrics: HTTP 200, 6 requests counted")
        check(get("/sample?labels=12")[0] == 400, "label out of range -> HTTP 400")
        for k, per in (("cond_bn", 7), ("conv3x3", 6)):
            check(passes > 0 and counts[k] == per * passes,
                  f"{k}: {counts[k]} launches over {passes} generator passes (want {per} per "
                  f"pass)")
        check(serve_variants == {"wgmma": 0, "ffma": 6 * passes, "cudnn": passes},
              f"conv3x3 by route on the float32 serving path: {serve_variants} (6 per pass on "
              f"ffma, G's output conv on cudnn)")
        for k in ("sn", "projection", "dequant"):
            check(counts[k] == 0, f"{k}: {counts[k]} launches on the serving path (want 0)")

        # ---------------------------------------------------------- 5. times
        for path in requests:
            lat = [get(path)[2] * 1e3 for _ in range(5)]
            latency_ms[path] = statistics.median(lat)
    finally:
        srv.shutdown()
        srv.server_close()
        server_thread.join(timeout=10)

    print(f"times on {card}: medians of CUDA events, float32, TF32 off", flush=True)
    # conv3x3's per-pass sums are its six FFMA calls; G's output conv (256 ->
    # 3, on cuDNN) is timed on its own line and in g_pass_conv_times
    ffma_shapes = [s_ for s_ in CONV_SHAPES
                   if conv3x3_variant((1, s_[0], s_[0], s_[1]), s_[2], torch.float32) == "ffma"]
    def cond_bn_relu(*a):  # as the generator calls it
        return cond_batchnorm(*a, relu=True)

    def cond_bn_plain_relu(*a):
        return cond_batchnorm_plain(*a, relu=True)

    impl = {"cond_bn": (cond_bn_relu, cond_bn_plain_relu, COND_BN_SHAPES,
                        "cond_bn (ReLU fused) per generator pass, each call issued alone"),
            "conv3x3": (conv3x3, conv3x3_plain, ffma_shapes,
                        f"conv3x3 per generator pass ({len(ffma_shapes)} calls on the FFMA kernel)"),
            "conv3x3_d": (conv3x3, conv3x3_plain, D_CONV_SHAPES,
                          "conv3x3 per D pass (12 calls: 11 on the kernels, 1 on cuDNN)"),
            "projection": (all_label_projection_logits, projection_plain, [()],
                           "projection, one call")}
    per_pass = {k: {} for k in impl}  # kind -> batch -> [kernel ms, plain ms]
    for key, targs in inputs.items():
        kname, b = key[0], key[1]
        kern, plain, shapes, _ = impl[kname]
        tk = event_ms(torch, lambda: kern(*targs))
        tp = event_ms(torch, lambda: plain(*targs))
        tk2 = event_ms(torch, lambda: kern(*targs))
        tp2 = event_ms(torch, lambda: plain(*targs))
        tk, tp = statistics.median([tk, tk2]), statistics.median([tp, tp2])
        mult = shapes.count(tuple(key[2:]))
        acc = per_pass[kname].setdefault(b, [0.0, 0.0])
        acc[0] += mult * tk
        acc[1] += mult * tp
        on = "kernel"
        if kname.startswith("conv3x3"):
            on = conv3x3_variant(targs[0].shape, key[4], torch.float32)
        print(f"  {kname} {key[1:]}: {on} {tk:.4f} ms, plain {tp:.4f} ms (x{mult} in the "
              f"per-pass sum)", flush=True)
    for kname, d in per_pass.items():
        for b, (tk, tp) in d.items():
            print(f"  {impl[kname][3]} at batch {b}: kernel {tk:.4f} ms, plain {tp:.4f} ms",
                  flush=True)
    # the one PyTorch call for conv3x3, on the FFMA kernel's six calls per
    # generator pass at batch 100, float32 (TF32 off): cuDNN
    conv_library_ms = sum(
        ffma_shapes.count(s_) * statistics.median(
            [event_ms(torch, lambda: cudnn_conv(*inputs[("conv3x3", 100, *s_)]))
             for _ in range(2)])
        for s_ in set(ffma_shapes))
    print(f"  conv3x3 per generator pass at batch 100, its {len(ffma_shapes)} FFMA calls on cuDNN "
          f"float32: {conv_library_ms:.4f} ms", flush=True)
    cbn = cond_bn_times(torch, inputs)
    g_pass = g_pass_conv_times(torch, inputs)
    proj = projection_times(torch, inputs[("projection", 64)])
    proj_library_ms = proj["addmm_alone"]
    for bkt in BUCKETS:
        zt = torch.from_numpy(rng.standard_normal((bkt, cfg.z_dim)).astype(np.float32)).to(dev)
        lt = torch.arange(bkt, device=dev) % cfg.vocab_size
        ms = event_ms(torch, lambda: sample(gen, zt, lt), reps=20)
        print(f"  generator forward, bucket {bkt}: {ms:.3f} ms "
              f"({bkt / ms * 1e3:.1f} images/s)", flush=True)
        if bkt in (BUCKETS[0], BUCKETS[-1]):
            wall, busy, rows = device_profile(torch, lambda: sample(gen, zt, lt))
            print(f"    profiled: {wall:.3f} ms per forward, device busy {busy:.3f} ms "
                  f"({busy / wall:.0%}); by kernel:", flush=True)
            for t, n, name in rows[:6]:
                print(f"      {t:.4f} ms x{n} {name[:70]}", flush=True)
            if bkt == BUCKETS[-1]:
                relus = [name for _, _, name in rows
                         if any(k in name.lower() for k in ("relu", "clamp", "threshold"))]
                bn = [n for _, n, name in rows if "cond_bn_kernel" in name]
                check(not relus and bn == [7],
                      f"the serving pass's profile at bucket {bkt}: {bn} cond_bn_kernel launches "
                      f"per pass (want [7]) and no ReLU kernel after them (found {relus})")
    for path, ms in latency_ms.items():
        print(f"  GET {path}: {ms:.2f} ms (median of 5, host clock)", flush=True)
    # host stages of a 100-image request: the sampler call (H2D, forward, D2H)
    # and the PNG encode; the rest of the latency is the coalescer's gather
    # window, z drawing and HTTP.
    z100 = rng.standard_normal((100, cfg.z_dim)).astype(np.float32)
    l100 = np.arange(100) % cfg.vocab_size
    t_sample, t_png = [], []
    for _ in range(5):
        t = time.perf_counter()
        imgs = sampler.sample_with_z(z100, l100)
        t_sample.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        _to_png_grid(to_unit_range(imgs))
        t_png.append((time.perf_counter() - t) * 1e3)
    ms_sample, ms_png = statistics.median(t_sample), statistics.median(t_png)
    rest = latency_ms["/sample?n=100&seed=3"] - ms_sample - ms_png
    print(f"  /sample?n=100 split (medians of 5, host clock): sample_with_z {ms_sample:.2f} ms, "
          f"PNG encode {ms_png:.2f} ms, rest (gather window, z, HTTP) {rest:.2f} ms", flush=True)

    # ------------------------------------------------ 6. the discriminator slice
    d_counts, d_variants, sn_ms = discriminator_slice(torch, dev, args.seed, max_err)
    lap("phases 1 to 6")

    # ------------------------------------------------------ 7. the training cycle
    t_res = training_slice(torch, dev, args.seed, card, max_err)
    lap("phase 7")

    # ------------------------------------------------------------- 8. the app
    app = app_slice(torch, args.seed, card)
    lap("phase 8")

    # ----------------------------------------------------- 9. the MNIST slice
    mnist = mnist_slice(torch, dev, args.seed, card, max_err)
    lap("phase 9")

    # ---------------------------------------------------- 10. the PGGAN slice
    pggan = pggan_slice(torch, dev, args.seed, card, max_err)
    lap("phase 10")

    # -------------------------------------------------- 11. Inception-v3 scorer
    iv3 = inception_slice(torch, dev, args.seed, card)
    lap("phase 11")

    # -------------------------------------------------- 12. data parallelism
    dp = parallel_slice(torch, dev, args.seed, card)
    lap("phase 12")

    # --------------------------------------------- 13. the compiled programs
    compiled = compiled_slice(torch, dev, args.seed, card)
    lap("phase 13")
    print(json.dumps({"compiled": compiled["rows"]}), flush=True)

    if failures:
        print(f"{len(failures)} check(s) failed:", *failures, sep="\n  ", flush=True)
        return 1
    # launches: the serving path's, the discriminator slice's paths' and the
    # counted training cycles', each counted from 0.  Times (and the bound
    # and the one-call library time beside each): per generator pass at
    # batch 100, float32 (cond_bn with its ReLU: device time in CUDA graphs,
    # each call issued alone beside it; conv3x3: its six FFMA calls, eager,
    # library: cuDNN float32 on them); per D pass (sn: its two launches in
    # CUDA graphs, issued alone beside it); one call at batch 64
    # issued alone (projection; library: cuBLAS addmm), with both in CUDA
    # graphs beside; one call at [64, 3072] in CUDA graphs (dequant; issued
    # alone beside it).  conv3x3 adds each
    # kernel's own row (by_variant: wgmma on the rcgan training cycle's bf16
    # convs, ffma on the float32 pass at batch 100, device time in CUDA
    # graphs), the cuDNN route's (library_route: the cycle's ragged convs),
    # the float32 pass per bucket (g_pass_f32), and the cycle's 188 bf16
    # forward and input-grad convs together (cycle_bf16_*; library: cuDNN
    # bf16).  Operations counted per element: cond-BN 7 (moments 3, apply
    # 4), sn 5 per weight entry (two GEMVs and the division), dequant
    # DEQUANT_OPS 32-bit instructions (the hash) at PEAK_INT32.
    conv = t_res["cycle_conv_times"]
    cycle_bound = conv["fwd"]["bound"] + conv["dx"]["bound"]
    cycle_ops = conv["fwd"]["bound_ops"] + conv["dx"]["bound_ops"]
    sn_w = [m * co for m, co in SN_SHAPES]
    rows = {
        "cond_bn": ((cbn[100]["kernel"], cbn[100]["plain"]),
                    (cbn[100]["bound"], cbn[100]["bound_by"]), None),
        "conv3x3": (per_pass["conv3x3"][100],
                    conv_bound([(100, *s_) for s_ in ffma_shapes], 4, PEAK_F32),
                    conv_library_ms),
        "sn": ((sn_ms["graph"], sn_ms["plain_graph"]), bound(sum(5 * n for n in sn_w),
                            sum(4 * (2 * m * co + 2 * co + 1) for m, co in SN_SHAPES), PEAK_F32),
               None),
        "projection": ((proj["alone"], per_pass["projection"][64][1]),
                       bound(2 * 64 * 128 * 10 + 64 * 10,
                             4 * (64 * 128 + 10 * 128 + 64 + 64 * 10), PEAK_F32),
                       proj_library_ms),
        "dequant": ((t_res["dequant_ms"]["graph"], t_res["dequant_ms"]["plain_graph"]),
                    bound(DEQUANT_OPS * 64 * 3072, t_res["dequant_bytes"], PEAK_INT32), None),
    }

    def bound_by(r):
        return "operations" if 2 * r["bound_ops"] >= r["bound"] else "bytes"

    kernels = []
    for k in runtime.KERNELS:
        (ms, plain_ms), (bound_ms, by), library_ms = rows[k]
        row = dict(name=k, **KERNEL_INFO[k],
                   launches=(counts[k] + d_counts[k] + t_res["counts"][k] + app["counts"][k]
                             + mnist["counts"][k] + pggan["counts"][k] + dp["counts"][k]
                             + compiled["counts"][k]),
                   max_abs_err=max_err[k], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=by, library_ms=library_ms)
        if k == "cond_bn":
            row.update(ms_is="a float32 generator pass's seven calls at batch 100, ReLU fused, "
                             "device time in CUDA graphs (plain_ms: the plain version with its "
                             "ReLU, likewise)",
                       alone_ms=per_pass["cond_bn"][100][0],
                       plain_alone_ms=per_pass["cond_bn"][100][1],
                       alone_ms_is="the same seven calls, each issued alone (host included), "
                                   "CUDA events",
                       launches_per_call=1,
                       g_pass_f32={str(b): {"ms": r["kernel"], "plain_ms": r["plain"],
                                            "bound_ms": r["bound"]} for b, r in cbn.items()})
        if k == "sn":
            row.update(ms_is="the 16 weights of a D pass as the path launches them (D's 15 "
                             "layers in one launch, D.Embedding_y in another), device time in "
                             "CUDA graphs (plain_ms: sn_plain per weight, likewise)",
                       alone_ms=sn_ms["alone"], plain_alone_ms=sn_ms["plain_alone"],
                       alone_ms_is="the same two launches issued alone (host included), CUDA "
                                   "events",
                       launches_per_d_pass=1, mnist_group=mnist["sn_group"])
        if k == "dequant":
            row.update(ms_is="one call at [64, 3072], device time in CUDA graphs (plain_ms: "
                             "dequantize_plain with row_noise, the same bits, likewise)",
                       alone_ms=t_res["dequant_ms"]["alone"],
                       plain_alone_ms=t_res["dequant_ms"]["plain_alone"],
                       alone_ms_is="the same call issued alone (host included), CUDA events",
                       launches_per_cycle=app["dequant_per_cycle"],
                       app_launches=app["counts"]["dequant"])
        if k == "projection":
            row.update(ms_is="one call at batch 64, float32, issued alone (host included), CUDA "
                             "events; library_ms: torch.addmm the same way",
                       device_ms=proj["graph"], library_device_ms=proj["addmm_graph"],
                       device_ms_is="the same call in CUDA graphs (device time), against "
                                    "torch.addmm in CUDA graphs",
                       host_us=proj["host_us"])
        if k == "conv3x3":
            row["variants"] = {v: serve_variants[v] + d_variants[v] + t_res["variants"][v]
                               + app["variants"][v] + pggan["variants"][v]
                               + compiled["variants"][v]
                               for v in runtime.VARIANTS[k]}
            row["ms_is"] = (f"the FFMA kernel on one float32 generator pass at batch 100 "
                            f"({len(ffma_shapes)} convs; G's 256 -> 3 conv is on cuDNN), eager, "
                            f"CUDA events")
            g100 = g_pass[100]
            row["by_variant"] = {
                "wgmma": {"source": CONV_SOURCES["wgmma"], "launches": row["variants"]["wgmma"],
                          "max_abs_err": max_err["conv3x3_bf16"]["wgmma"],
                          "ms": conv["wgmma"]["kernel"], "plain_ms": conv["wgmma"]["plain"],
                          "bound_ms": conv["wgmma"]["bound"], "bound_by": bound_by(conv["wgmma"]),
                          "library_ms": conv["wgmma"]["cudnn"],
                          "ms_is": f"the {conv['wgmma']['n']} calls on wgmma of an rcgan "
                                   f"training cycle, bf16, batch 64, device time in CUDA graphs"},
                "ffma": {"source": CONV_SOURCES["ffma"], "launches": row["variants"]["ffma"],
                         "max_abs_err": max_err["conv3x3"], "ms": g100["kernel"],
                         "plain_ms": per_pass["conv3x3"][100][1], "bound_ms": g100["bound"],
                         "bound_by": g100["bound_by"], "library_ms": g100["cudnn"],
                         "ms_is": f"the {g100['n']} FFMA calls of a float32 generator pass at "
                                  f"batch 100, device time in CUDA graphs (plain_ms eager)"}}
            row["library_route"] = {
                "variant": "cudnn", "calls": row["variants"]["cudnn"],
                "max_abs_err": max(max_err["conv3x3_bf16"]["cudnn"], max_err["conv3x3_cudnn"]),
                "ms": conv["cudnn"]["kernel"], "plain_ms": conv["cudnn"]["plain"],
                "bound_ms": conv["cudnn"]["bound"], "bound_by": bound_by(conv["cudnn"]),
                "ms_is": f"the {conv['cudnn']['n']} ragged calls (C or O = 3) of an rcgan "
                         f"training cycle, bf16, batch 64, through conv3x3 on cuDNN, device time "
                         f"in CUDA graphs",
                "g_pass_f32_ms": g100["ragged"], "g_pass_f32_bound_ms": g100["ragged_bound"]}
            row["g_pass_f32"] = {
                str(b): {"calls": r["n"], "ffma_ms": r["kernel"], "cudnn_ms": r["cudnn"],
                         "bound_ms": r["bound"], "ragged_cudnn_ms": r["ragged"]}
                for b, r in g_pass.items()}
            row["g_pass_f32_is"] = ("per float32 generator pass and bucket, device time in CUDA "
                                    "graphs, TF32 off: the FFMA calls, cuDNN float32 on the same "
                                    "calls, their bound, and G's output conv on cuDNN")
            row["cycle_bf16_is"] = (f"an rcgan training cycle's {conv['fwd']['n'] + conv['dx']['n']}"
                                    f" bf16 forward and input-grad convs at batch 64 through "
                                    f"conv3x3, device time in CUDA graphs")
            row.update(cycle_bf16_ms=conv["fwd"]["kernel"] + conv["dx"]["kernel"],
                       cycle_bf16_plain_ms=conv["fwd"]["plain"] + conv["dx"]["plain"],
                       cycle_bf16_bound_ms=cycle_bound,
                       cycle_bf16_bound_by="operations" if 2 * cycle_ops >= cycle_bound
                       else "bytes",
                       cycle_bf16_library_ms=conv["fwd"]["cudnn"] + conv["dx"]["cudnn"])
        if k in ("conv3x3", "cond_bn", "sn"):
            pk = pggan["kernels"]
            row["pggan"] = {"launches_per_iteration": {
                str(st): c_[k] for st, c_ in pggan["per_iteration"].items()}}
            if k == "conv3x3":
                row["pggan"].update(ffma_f32_64x64=pk["conv_ffma"], wgmma_bf16_64x64=pk["conv_wgmma"],
                                    ms_is="one conv [64, 64, 64, 128] x [3, 3, 128, 128], device "
                                        "time in CUDA graphs; library: cuDNN")
            if k == "cond_bn":
                row["pggan"].update(f32_64x64=pk["cond_bn_float32"],
                                    bf16_64x64=pk["cond_bn_bfloat16"],
                                    ms_is="one call at [64, 64 x 64, 128] with the ReLU, device "
                                        "time in CUDA graphs")
            if k == "sn":
                row["pggan"].update(stage4_trans_group=pk["sn"],
                                    ms_is="the stage-4 transition's group of 16 weights in one "
                                        "launch, device time in CUDA graphs")
            if k == "conv3x3":
                row["pggan"]["iteration"] = pggan["iteration"]
        kernels.append(row)
    print(f"Inception-v3 (no kernel: cuDNN convs): 5 000 samples {iv3['ms_5000']:.1f} ms; the "
          f"app's score on 50 000 samples {iv3['app_inception_s']:.2f} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
