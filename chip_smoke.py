#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rcgan_tpu_torch``) on one NVIDIA GPU.

Drives the port's three paths once at the flagship width
(``ResnetGANConfig()``: z_dim 128, dim_g 128, dim_d 128, embedding 300,
10 classes): the serving path (float32), the discriminator forward
(``rcgan_tpu_torch.entry.entry()`` and the CIFAR losses) and the training
cycle (``CifarTrainer.step``: 1 G step + 5 critic steps):

1. device check (CUDA required), card name and power limit, versions;
2. build of the hand-written kernels from the repo's sources (the five
   nvcc builds in parallel, the Triton dequantisation at first launch),
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
   bfloat16); the dequantisation kernel at [64, 3072] (exact noise-free
   part, noise in [0, 1/128), a flat 16-bin histogram, rows that do not
   depend on the batch, other seeds other rows) and its time against the
   plain version; two cycles at batch 8 on the card against the CPU from
   the same weights and noise, float32, rcgan and rcgan-u (perm classifier,
   ``confuse_init``): Adam moments, parameters, SN ``u`` and costs (the
   check runs under PyTorch's deterministic algorithms, so it repeats from
   run to run, on data from ``CHECK_TRAIN["data_seed"]``, chosen with
   ``python3 -m rcgan_tpu_torch.diagnostics.sum_order --scan`` away from
   the near-ties that a reordered float32 sum tips); then
   ``bench.py``'s configuration (batch 64, bf16, n_critic 5,
   gen_bs_multiple 2) on a device-resident dataset of 50 000 images:
   launches per cycle asserted exactly (conv3x3 per route: rcgan 174
   wgmma + 14 cudnn; sn 12 per rcgan cycle, 28 per rcgan-u cycle with the
   perm classifier), cycles/s for rcgan and rcgan-u, a
   profiler breakdown of a cycle of each (device-busy share, top kernels,
   conv3x3, cuDNN's weight grads, Adam, sn, cond-BN), and an rcgan cycle's 3x3 convs
   timed by kind and route (forward and input grad through ``conv3x3``,
   on cuDNN in bf16 and on the plain version; weight grads), beside their
   bound at the H100's peaks and the share of it each reaches.

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
``cycle_bf16_library_ms``); cond_bn's and sn's rows are device times in
CUDA graphs (a float32 generator pass's seven calls at batch 100 with the
ReLU fused; the two launches of a D pass), with the same calls issued
alone beside them (``alone_ms``, ``plain_alone_ms``); the projection's
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
# two cycles (iteration 0 skips the G step), each from the same state.
# ``data_seed`` is added to ``--seed`` for the check's data and noise
# (:func:`check_train_feeds`).  The check runs under PyTorch's deterministic
# algorithms (:func:`deterministic_algorithms`), so its readings repeat from
# run to run.  The limits below were derived at data seed 3, where the
# redesigned spectral-norm and cond-BN kernels, whose float32 sums run in
# another order, tip rcgan-u's iteration 0 over a near-tie (``far.disc``
# 0.0199) though each of their calls lies within 1.4e-6 of float64.  Data
# seed 92 is where ``python3 -m rcgan_tpu_torch.diagnostics.sum_order``
# found the readings farthest from such ties among the seeds 3 to 199: its
# table says which of nine arithmetics of the float32 kernels (the shipped
# ones, their plain versions, float64, other conv geometries) pass there
# under these unchanged limits.
CHECK_TRAIN = {"batch": 8, "n_critic": 2, "gen_bs_multiple": 2, "data_seed": 92}
# Bounds of that check by iteration (``train_readings`` says what each
# reads).  With beta1 = 0 Adam's update is about +-lr whatever the
# gradient's size, so the gradients are bounded through mu (and nu), the
# parameters as a share farther than lr/100 and a largest gap in units of
# 2*lr per update.  Each bound is 2-3x the largest of the rcgan and rcgan-u
# readings of two runs on an H100 at seed 0 and data seed 3, with the
# kernels of that time, in parentheses (rcgan-u's
# iteration 1 moves between runs: nu.confusion read 4.66e-7, then 3.52e-6;
# rcgan's repeats to three digits); where the reading is 0,
# the bound is the smallest step it can take (one confusion logit of 100)
# or, for dead tensors, the threshold that defines them.  The readings are
# large for float32 because the gradients are ill-conditioned, not because
# the card is off: on the CPU alone, nudging every parameter by 1e-7
# relative moves the G step's gradient by up to 2.0e-2 of a tensor's max
# (rcgan-u; 7.4e-3 for rcgan), and Adam's first, sign-like update turns
# rounding in near-zero gradients into +-lr steps that the next step sees.
TRAIN_TOL = {
    0: {"mu.disc": 8e-3,        # (3.13e-3)
        "nu.disc": 4e-3,        # (1.48e-3)
        "dead.disc": 1e-4,      # (0)
        "far.disc": 8e-3,       # (2.94e-3)
        "params_max": 1.5,      # (0.615)
        "u": 7e-6,              # (2.59e-6)
        "cost": 1.2e-7},        # (4.2e-8, one float32 ulp of the cost)
    1: {"mu.gen": 6e-2,         # (2.46e-2)
        "nu.gen": 2.5e-2,       # (1.05e-2)
        "dead.gen": 1e-4,       # (2.87e-8)
        "far.gen": 3e-3,        # (1.05e-3)
        "mu.confusion": 5e-6,   # (1.79e-6)
        "nu.confusion": 9e-6,   # (3.52e-6)
        "far.confusion": 1e-2,  # (0)
        "mu.disc": 7e-2,        # (2.66e-2)
        "nu.disc": 3e-2,        # (1.13e-2)
        "dead.disc": 1e-4,      # (0)
        "far.disc": 0.5,        # (0.205)
        "params_max": 2.5,      # (1.000)
        "u": 3.5e-4,            # (1.29e-4)
        "cost": 6e-6},          # (2.44e-6)
}
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
    "dequant": {"route": "triton", "source": "rcgan_tpu_torch/ops/kernels/dequant_kernel.py",
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
                tk = graph_ms(torch, lambda: conv3x3(x, w))
                tc = graph_ms(torch, lambda: cudnn_conv(x, w))
                tc2 = graph_ms(torch, lambda: cudnn_conv(x, w))
                tk2 = graph_ms(torch, lambda: conv3x3(x, w))
            r["kernel"] += mult * statistics.median([tk, tk2])
            r["cudnn"] += mult * statistics.median([tc, tc2])
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
            tk, ta, ta2, tk2 = (timer(torch, f) for f in (kern, addmm, addmm, kern))
            out[key], out[f"addmm_{key}"] = statistics.median([tk, tk2]), statistics.median([ta, ta2])
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
    its IDAT data inflates to the size the header implies (8-bit RGB)."""
    if body[:8] != b"\x89PNG\r\n\x1a\n" or body[12:16] != b"IHDR":
        raise ValueError("not a PNG")
    w, h = struct.unpack(">II", body[16:24])
    pos, idat = 8, b""
    while pos < len(body):
        (n,) = struct.unpack(">I", body[pos:pos + 4])
        tag = body[pos + 4:pos + 8]
        if tag == b"IDAT":
            idat += body[pos + 8:pos + 8 + n]
        pos += 12 + n
    if len(zlib.decompress(idat)) != h * (1 + 3 * w):
        raise ValueError("IDAT size does not match IHDR")
    return w, h


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
        tk, tp, tp2, tk2 = (timer(torch, f) for f in (sn_pass, sn_pass_plain, sn_pass_plain,
                                                      sn_pass))
        sn_ms[key] = statistics.median([tk, tk2])
        sn_ms[f"plain_{key}"] = statistics.median([tp, tp2])
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


def check_train_feeds(seed: int, data_seed: int = CHECK_TRAIN["data_seed"]) -> list:
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


def train_readings(np_ref, np_got, m_ref, m_got, lr: float, steps: dict):
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
    units of 2·lr per update; ``u``, the SN ``u`` max abs error; ``cost``,
    each cost's |diff| / (1 + |cost|)."""
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
                         for la in np_ref.state))
    out["cost"] = max(abs(float(m_got[k]) - float(m_ref[k])) / (1 + abs(float(m_ref[k])))
                      for k in ("d_cost", "d_cost_mean", "g_cost"))
    return out, where


def training_slice(torch, dev, seed: int, card: str, max_err: dict):
    """Phase 7: the training cycle.  Returns a dict: the launches of each
    kernel over the timed configuration's counted cycles (``counts``),
    conv3x3's by variant (``variants``), (kernel ms, plain ms) of the
    dequantisation at [64, 3072] (``dequant_ms``) and the bytes it moves
    (``dequant_bytes``), and an rcgan cycle's conv times
    (``cycle_conv_times``).  The dequantisation's ``max_err`` is how far
    its noise strays outside [0, 1/128]: its random bits are Philox's, so
    it is held to the plain version in distribution."""
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
    from rcgan_tpu_torch.ops.kernels.dequant_kernel import dequantize, dequantize_plain
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

    # ---- dequantisation at [64, 3072]
    x = torch.randint(0, 256, (64, 3072), generator=gen, dtype=torch.uint8).to(dev)
    seeds = torch.from_numpy(trng.example_seeds(seed, 64)).to(dev)
    out = dequantize(x, seeds)
    base = dequantize_plain(x, torch.zeros(64, 3072, device=dev))
    noise = out.double() - base.double()
    at_top = noise == 1.0 / 128
    max_err["dequant"] = max(0.0, -noise.min().item(), noise.max().item() - 1.0 / 128)
    check(out.dtype == torch.float32 and out.shape == (64, 3072)
          and noise.min().item() >= 0.0 and noise.max().item() <= 1.0 / 128
          and bool((base[at_top].abs() >= 2.0 ** -7).all())
          and bool((noise[base == 0] < 1.0 / 128).all()),
          f"dequant [64,3072]: noise in [0, 1/128) ({noise.min().item() * 128:.6f} to "
          f"{noise.max().item() * 128:.6f} /128; {int(at_top.sum())} element(s) rounded up to "
          f"base + 1/128 by float32, all at |base| >= 2^-7; < 1/128 strictly where base = 0)")
    hist = torch.histc((noise * 128).float(), bins=16, min=0.0, max=1.0)
    dev_ = (hist / hist.mean() - 1).abs().max().item()
    check(dev_ <= 0.05 and abs(noise.mean().item() * 256 - 1) <= 0.02,
          f"dequant noise: 16-bin histogram within {dev_:.4f} of flat (limit 0.05), mean "
          f"{noise.mean().item() * 256:.5f}/256")
    perm = torch.randperm(64, generator=gen).to(dev)
    check(torch.equal(dequantize(x[perm], seeds[perm]), out[perm])
          and torch.equal(dequantize(x[5:21].contiguous(), seeds[5:21].contiguous()), out[5:21]),
          "dequant: the same seeds give bit-identical rows in a permuted and a sliced batch")
    check(bool((dequantize(x, seeds + 1) != out).any(dim=1).all()),
          "dequant: other seeds give other rows")
    dequant_bytes = x.numel() * x.element_size() + seeds.numel() * seeds.element_size() \
        + out.numel() * out.element_size()
    tk = statistics.median([event_ms(torch, lambda: dequantize(x, seeds)) for _ in range(2)])
    tp = statistics.median([event_ms(torch, lambda: dequantize_plain(
        x, torch.rand(64, 3072, device=dev) / 128.0)) for _ in range(2)])
    print(f"  dequant [64,3072]: kernel {tk:.4f} ms, plain (torch.rand + ops) {tp:.4f} ms",
          flush=True)

    # ---- card against CPU, float32, TF32 off: two cycles from the same weights and noise,
    # under PyTorch's deterministic algorithms so that a reading repeats from run to run
    b, nc, gm = CHECK_TRAIN["batch"], CHECK_TRAIN["n_critic"], CHECK_TRAIN["gen_bs_multiple"]
    tcfg = CifarTrainConfig(n_critic=nc, gen_bs_multiple=gm)
    feeds = check_train_feeds(seed)
    with deterministic_algorithms(torch):
        for alg, perm in (("rcgan", False), ("rcgan-u", True)):
            cfg = ResnetGANConfig(algorithm=alg)
            acfg = CifarAlgoConfig(algorithm=alg, perm_classifier=perm, confuse_init=perm)
            trainers = {side: CifarTrainer(cfg, acfg, tcfg, c_mat,
                                           dev if side == "card" else "cpu")
                        for side in ("card", "cpu")}
            ts_card = trainers["card"].init(seed)
            for it, (d, g, noise) in enumerate(feeds):
                # each cycle from one state: the card's, copied to the CPU
                # (bit-exact), so that no earlier cycle's rounding is carried in
                ts_cpu = train_state_from_jax(to_jax_train_state(ts_card), cfg, acfg, tcfg, "cpu")
                before = {k: st.count for k, st in ts_card.opt_states.items()}
                ts_cpu, m_cpu = trainers["cpu"].step(ts_cpu, d, g, it, seed, noise=noise)
                ts_card, m_card = trainers["card"].step(ts_card, d, g, it, seed, noise=noise)
                steps = {k: st.count - before[k] for k, st in ts_card.opt_states.items()}
                r, where = train_readings(to_jax_train_state(ts_cpu), to_jax_train_state(ts_card),
                                          m_cpu, m_card, tcfg.lr, steps)
                limits = TRAIN_TOL[it]
                check(set(r) <= set(limits) and all(v <= limits[k] for k, v in r.items()),
                      f"training {alg}{' perm+confuse_init' if perm else ''}, batch {b}, "
                      f"n_critic {nc}, cycle at iteration {it} (updates {steps}), float32, card vs "
                      f"CPU from the same state: "
                      + ", ".join(f"{k} {v:.3g} (limit {limits.get(k)}"
                                  + (f", at {where[k]})" if k in where else ")")
                                  for k, v in r.items()))

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
    return {"counts": totals, "variants": var_totals, "dequant_ms": (tk, tp),
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint_dir", default=None,
                   help="serve this generator.npz instead of seeded random weights")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: this smoke run needs an NVIDIA GPU", flush=True)
        return 2

    import numpy as np
    import triton

    from rcgan_tpu_torch.core import rng as trng
    from rcgan_tpu_torch.entry import entry
    from rcgan_tpu_torch.models.resnet_gan import Generator, ResnetGANConfig, sample
    from rcgan_tpu_torch.ops.kernels import runtime
    from rcgan_tpu_torch.ops.kernels.conv_kernel import (conv3x3, conv3x3_plain,
                                                         conv3x3_variant, ffma_geometry)
    from rcgan_tpu_torch.ops.kernels.norm_kernel import cond_batchnorm, cond_batchnorm_plain
    from rcgan_tpu_torch.ops.kernels.projection_kernel import (all_label_projection_logits,
                                                               projection_plain)
    from rcgan_tpu_torch.ops.kernels.sn_kernel import sn_plain, spectral_norm_group
    from rcgan_tpu_torch.serving import Sampler, _to_png_grid, make_server, to_unit_range

    # ---------------------------------------------------------------- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a"
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, triton {triton.__version__}", flush=True)
    dev = torch.device("cuda")
    print(f"TF32 as the process starts: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)

    # ----------------------------------------------------------------- 2. build
    # one nvcc per CUDA source, all started together; the Triton kernel
    # (the dequantisation) compiles at its first launch, in phase 7
    def timed_build(name):
        t = time.perf_counter()
        runtime.cuda_library(name)
        return time.perf_counter() - t

    t_all = time.perf_counter()
    cuda_sources = ("conv3x3", "conv3x3_wgmma", "sn", "projection", "cond_bn")
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
            for dt in (torch.float32, torch.bfloat16):
                xd = args_f32[0].to(dt)
                name = str(dt).split(".")[1]
                res = []
                for relu in (False, True):
                    got = cond_batchnorm(xd, *args_f32[1:], relu=relu)
                    again = cond_batchnorm(xd, *args_f32[1:], relu=relu)
                    ref = cond_batchnorm_plain(xd.float(), *args_f32[1:], relu=relu)
                    torch.cuda.synchronize()
                    ok, err, rel = compare(torch, got, ref, name)
                    res.append((ok and torch.equal(got, again)
                                and (not relu or got.min().item() >= 0.0), err, rel))
                    if dt == torch.float32:
                        max_err["cond_bn"] = max(max_err["cond_bn"], err)
                check(all(r[0] for r in res),
                      f"cond_bn [{b},{s},{c}] {name}, the same bits on two runs: max abs err "
                      f"{res[0][1]:.3e} (rel {res[0][2]:.3e}); with ReLU {res[1][1]:.3e} "
                      f"(rel {res[1][2]:.3e})")
    # conv3x3 at the generator's shapes and at the discriminator's, each call
    # on the route conv3x3_variant names; float32 at bucket 1 includes
    # split-K geometries of the FFMA kernel (on this card's SM count)
    sms = runtime.sm_count(torch.empty(1, device=dev))
    split_calls = []
    max_err["conv3x3_cudnn"] = 0.0
    for tag, batches, shapes in (("conv3x3", KERNEL_BATCHES, CONV_SHAPES),
                                 ("conv3x3_d", D_BATCHES, D_CONV_SHAPES)):
        for b in batches:
            for hw, c, o in sorted(set(shapes)):
                x = torch.relu(torch.randn(b, hw, hw, c, generator=gen_cpu))
                w = torch.randn(3, 3, c, o, generator=gen_cpu) * (2.0 / (9 * c)) ** 0.5
                args_f32 = [x.to(dev), w.to(dev)]
                if tag == "conv3x3" or b in D_TIMED_BATCHES:
                    inputs[(tag, b, hw, c, o)] = args_f32
                for dt in (torch.float32, torch.bfloat16):
                    xd, wd = (t.to(dt) for t in args_f32)
                    route = conv3x3_variant(xd.shape, o, dt)
                    before = runtime.variant_counts("conv3x3")
                    got = conv3x3(xd, wd)
                    ran = {k: n - before[k] for k, n in runtime.variant_counts("conv3x3").items()}
                    ref = conv3x3_plain(xd.float(), wd.float())
                    torch.cuda.synchronize()
                    name = str(dt).split(".")[1]
                    ok, err, rel = compare(torch, got, ref, name)
                    geo = ""
                    if route == "ffma":
                        geo = " (bm, bn, splits) = {}".format(ffma_geometry(xd.shape, o, sms))
                        if dt == torch.float32:
                            max_err["conv3x3"] = max(max_err["conv3x3"], err)
                            if b == 1 and ffma_geometry(xd.shape, o, sms)[2] > 1:
                                split_calls.append((hw, c, o))
                    if route == "cudnn":
                        max_err["conv3x3_cudnn"] = max(max_err["conv3x3_cudnn"], err)
                    check(ok and ran == {v: int(v == route) for v in ran},
                          f"{tag} [{b},{hw},{hw},{c}]x[3,3,{c},{o}] {name} on {route}{geo} "
                          f"(ran {ran}): max abs err {err:.3e}, max rel err {rel:.3e}")
    check(len(split_calls) > 0, f"float32 at bucket 1: {len(split_calls)} conv(s) launched the "
                                f"FFMA kernel split over K, {sorted(set(split_calls))}")
    # conv3x3 in bf16 at every shape of the training cycle, with forward and
    # input-grad filters: each call takes the route conv3x3_variant names
    # (wgmma unless C or O is 3, then cuDNN) and matches the plain version;
    # the largest error is kept per route
    max_err["conv3x3_bf16"] = {v: 0.0 for v in runtime.VARIANTS["conv3x3"]}
    for tag, shapes in (("G", CONV_SHAPES), ("D", D_CONV_SHAPES)):
        for b in TRAIN_BATCHES:
            for hw, c, o in sorted(set(shapes)):
                for kind, (ci, co) in (("forward", (c, o)), ("input grad", (o, c))):
                    x = torch.randn(b, hw, hw, ci, generator=gen_cpu)
                    x = (torch.relu(x) if kind == "forward" else x).to(dev, torch.bfloat16)
                    w = (torch.randn(3, 3, ci, co, generator=gen_cpu) * (2.0 / (9 * ci)) ** 0.5)
                    w = w.to(dev, torch.bfloat16)
                    want = conv3x3_variant(x.shape, co, torch.bfloat16)
                    before = runtime.variant_counts("conv3x3")
                    got = conv3x3(x, w)
                    ran = {k: n - before[k] for k, n in runtime.variant_counts("conv3x3").items()}
                    ref = conv3x3_plain(x.float(), w.float())
                    torch.cuda.synchronize()
                    ok, err, rel = compare(torch, got, ref, "bfloat16")
                    max_err["conv3x3_bf16"][want] = max(max_err["conv3x3_bf16"][want], err)
                    check(ok and ran == {v: int(v == want) for v in ran},
                          f"conv3x3 {tag} {kind} [{b},{hw},{hw},{ci}]x[3,3,{ci},{co}] bfloat16 on "
                          f"{want} (launched {ran}): max abs err {err:.3e}, max rel err {rel:.3e}")
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
        pairs = [((torch.randn(m, cout, generator=gen_cpu) / m ** 0.5).to(dev),
                  torch.randn(1, cout, generator=gen_cpu).to(dev)) for m, cout in shapes]
        before = runtime.launch_counts()["sn"]
        got = spectral_norm_group(pairs)
        launched = runtime.launch_counts()["sn"] - before
        again = spectral_norm_group(pairs)
        torch.cuda.synchronize()
        worst, ok = [0.0, 0.0, 0.0], launched == 1
        for (w, u), g3, a3 in zip(pairs, got, again):
            for i, (g, a, r) in enumerate(zip(g3, a3, sn_plain(w, u))):
                scale = r.abs().max().item()
                err = (g - r).abs().max().item()
                ok = ok and bool(torch.isfinite(g).all()) and err <= SN_TOL * scale \
                    and torch.equal(g, a) and g.shape == r.shape
                worst[i] = max(worst[i], err / scale)
                if i == 0:
                    max_err["sn"] = max(max_err["sn"], err)
        check(ok, f"sn group of {len(shapes)} ({tag}: {sorted(set(shapes))}) float32, "
                  f"{launched} launch, the same bits on two runs: max err of scale W/sigma "
                  f"{worst[0]:.3e}, u' {worst[1]:.3e}, sigma {worst[2]:.3e} (limit {SN_TOL})")
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

    # ------------------------------------------------------ 7. the training cycle
    t_res = training_slice(torch, dev, args.seed, card, max_err)

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
    # graphs beside; one call at [64, 3072] (dequant).  conv3x3 adds each
    # kernel's own row (by_variant: wgmma on the rcgan training cycle's bf16
    # convs, ffma on the float32 pass at batch 100, device time in CUDA
    # graphs), the cuDNN route's (library_route: the cycle's ragged convs),
    # the float32 pass per bucket (g_pass_f32), and the cycle's 188 bf16
    # forward and input-grad convs together (cycle_bf16_*; library: cuDNN
    # bf16).  Operations counted per element: cond-BN 7 (moments 3, apply
    # 4), sn 5 per weight entry (two GEMVs and the division), dequant 30
    # (Philox's rounds and the scaling).
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
        "dequant": (t_res["dequant_ms"], bound(30 * 64 * 3072, t_res["dequant_bytes"], PEAK_F32),
                    None),
    }

    def bound_by(r):
        return "operations" if 2 * r["bound_ops"] >= r["bound"] else "bytes"

    kernels = []
    for k in runtime.KERNELS:
        (ms, plain_ms), (bound_ms, by), library_ms = rows[k]
        row = dict(name=k, **KERNEL_INFO[k],
                   launches=counts[k] + d_counts[k] + t_res["counts"][k],
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
                       launches_per_d_pass=1)
        if k == "projection":
            row.update(ms_is="one call at batch 64, float32, issued alone (host included), CUDA "
                             "events; library_ms: torch.addmm the same way",
                       device_ms=proj["graph"], library_device_ms=proj["addmm_graph"],
                       device_ms_is="the same call in CUDA graphs (device time), against "
                                    "torch.addmm in CUDA graphs",
                       host_us=proj["host_us"])
        if k == "conv3x3":
            row["variants"] = {v: serve_variants[v] + d_variants[v] + t_res["variants"][v]
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
        kernels.append(row)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
