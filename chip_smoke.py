#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rcgan_tpu_torch``) on one NVIDIA GPU.

Drives the port's two paths once at the flagship width
(``ResnetGANConfig()``: z_dim 128, dim_g 128, dim_d 128, embedding 300,
10 classes): the serving path (float32) and the discriminator forward
(``rcgan_tpu_torch.entry.entry()`` and the CIFAR losses):

1. device check (CUDA required), card name and power limit, versions;
2. build of the hand-written kernels from the repo's sources (the nvcc
   builds in parallel, the Triton kernels at first launch);
3. each kernel against its plain PyTorch version on the card, TF32 off:
   cond-BN and conv3x3 at every generator shape, batch 1, 8, 32, 64 and
   100, float32 and bfloat16; conv3x3 at every discriminator shape, batch
   64 and 128; spectral norm at every weight of the discriminator path;
   the all-label projection at batch 64 and 128, float32 and bfloat16 in;
4. the serving slice: a seeded generator (or ``--checkpoint_dir``'s
   ``generator.npz``) behind ``Sampler`` and ``make_server``, concurrent
   ``/sample`` requests plus ``/healthz``, ``/models`` and ``/metrics``,
   with the kernels' launch counters read around that run, and the card's
   output held against the same generator run on the CPU;
5. medians of CUDA-event times: each kernel against its plain version,
   the generator forward per bucket, ``/sample`` latency and its host
   stages at 100 images; and a ``torch.profiler`` trace of the forward at
   buckets 1 and 100 for the device's busy share and the time by kernel;
6. the discriminator slice at batch 64: ``entry()`` in float32 (against
   the same weights on the CPU, 1e-3 of the logits' scale) and bfloat16
   (finite, against the CPU's bfloat16 run, and far enough from float32 to
   show it computes in bf16); ``disc_loss`` for rcgan
   and rcgan-u and ``gen_loss`` for rcgan-u, forward under ``no_grad``,
   costs and spectral-norm ``u`` state against the CPU's; each path's
   launch counts asserted exactly; the gradient guard; then times of
   spectral norm per D pass, the projection, ``entry()`` and ``disc_loss``,
   and a profiler trace of ``entry()``.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Exits non-zero without a result when CUDA is unavailable or any check fails.

    python3 chip_smoke.py [--checkpoint_dir DIR] [--seed 0]
"""

from __future__ import annotations

import argparse
import concurrent.futures
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
D_BATCHES = (64, 128)
# Spectral-norm weights [m, cout] per D call: 15 in D, the projection's
# D.Embedding_y, and the perm classifier's (checked, not on the timed pass).
SN_SHAPES = [(3, 128), (27, 128), (1152, 128), (128, 128), (1152, 128), (1152, 128)] \
    + [(1152, 128)] * 8 + [(128, 1), (300, 128)]
SN_EXTRA_SHAPES = [(3072, 10)]
PROJ_BATCHES = (64, 128)
# Launches per path (perm classifier off): conv3x3, cond_bn, sn, projection.
PATH_COUNTS = {
    "entry() bfloat16": {"conv3x3": 19, "cond_bn": 7, "sn": 16, "projection": 0},
    "entry() float32": {"conv3x3": 19, "cond_bn": 7, "sn": 16, "projection": 0},
    "disc_loss rcgan": {"conv3x3": 19, "cond_bn": 7, "sn": 16, "projection": 0},
    "disc_loss rcgan-u": {"conv3x3": 31, "cond_bn": 7, "sn": 32, "projection": 1},
    "gen_loss rcgan-u": {"conv3x3": 19, "cond_bn": 7, "sn": 16, "projection": 1},
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

KERNEL_INFO = {
    "cond_bn": {"route": "triton", "source": "rcgan_tpu_torch/ops/kernels/norm_kernel.py",
                "replaces": "rcgan_tpu/ops/pallas/norm_kernel.py:123"},
    "conv3x3": {"route": "cuda", "source": "rcgan_tpu_torch/csrc/conv3x3.cu",
                "replaces": "rcgan_tpu/ops/pallas/conv_kernel.py:101"},
    "sn": {"route": "cuda", "source": "rcgan_tpu_torch/csrc/sn.cu",
           "replaces": "rcgan_tpu/ops/pallas/sn_kernel.py:73"},
    "projection": {"route": "triton",
                   "source": "rcgan_tpu_torch/ops/kernels/projection_kernel.py",
                   "replaces": "rcgan_tpu/ops/pallas/projection_kernel.py:32"},
}

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
    launches of each kernel summed over the slice's paths, and (kernel ms,
    plain ms) of spectral norm per D pass."""
    import numpy as np

    from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig, CifarGAN
    from rcgan_tpu_torch.core.module import scoped_modules, state_tree
    from rcgan_tpu_torch.entry import entry
    from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
    from rcgan_tpu_torch.ops.kernels import runtime
    from rcgan_tpu_torch.ops.kernels.conv_kernel import conv3x3
    from rcgan_tpu_torch.ops.kernels.norm_kernel import cond_batchnorm
    from rcgan_tpu_torch.ops.kernels.sn_kernel import sn_plain, spectral_norm

    batch = 64
    totals = {k: 0 for k in runtime.KERNELS}

    def run_path(name, fn):
        """One run of a path on the card, its launches counted and checked."""
        runtime.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = runtime.launch_counts()
        for k, v in counts.items():
            totals[k] += v
        check(counts == PATH_COUNTS[name], f"{name}: launches {counts} "
                                           f"(want {PATH_COUNTS[name]})")
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

    # ---- the gradient guard: no silent loss of gradients on the card
    for name, fn, fargs in (
            ("conv3x3", conv3x3, (torch.randn(1, 8, 8, 16, device=dev, requires_grad=True),
                                  torch.randn(3, 3, 16, 16, device=dev))),
            ("cond_batchnorm", cond_batchnorm,
             (torch.randn(2, 16, 8, device=dev), torch.zeros(2, dtype=torch.int64, device=dev),
              torch.ones(10, 8, device=dev, requires_grad=True), torch.zeros(10, 8, device=dev)))):
        try:
            fn(*fargs)
            raised = ""
        except RuntimeError as e:
            raised = str(e)
        check("no backward yet" in raised,
              f"{name} on CUDA, grad mode, an input requiring grad: raises ({raised[:48]!r})")
    check(all(v > 0 for v in totals.values()), f"every kernel launched on the slice: {totals}")

    # ---- times
    fwd, z, labels = models["bfloat16"]
    sn_layers = [m for m in scoped_modules(fwd).values() if getattr(m, "spectral_normed", False)]
    pairs = []
    for m in sn_layers:
        w = (m.Filters if hasattr(m, "Filters") else m.W).detach().float()
        pairs.append((w.reshape(-1, w.shape[-1]).contiguous(), m.u))
    check(sorted(tuple(w.shape) for w, _ in pairs) == sorted(SN_SHAPES),
          f"the {len(pairs)} SN weights of a D pass have the shapes of SN_SHAPES")
    err = max((g - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
              for w, u in pairs for g, r in zip(spectral_norm(w, u), sn_plain(w, u)))
    check(err <= SN_TOL, f"sn on D's own 16 weights, kernel vs plain: max err {err:.2e} "
                         f"of scale (limit {SN_TOL})")

    def sn_pass(fn):
        with torch.no_grad():
            for w, u in pairs:
                fn(w, u)

    print(f"D-slice times, batch {batch}: medians of CUDA events, TF32 off", flush=True)
    tp = event_ms(torch, lambda: sn_pass(sn_plain))
    tk = event_ms(torch, lambda: sn_pass(spectral_norm))
    tk2 = event_ms(torch, lambda: sn_pass(spectral_norm))
    tp2 = event_ms(torch, lambda: sn_pass(sn_plain))
    sn_ms = (statistics.median([tk, tk2]), statistics.median([tp, tp2]))
    print(f"  sn per D pass ({len(pairs)} calls): kernel {sn_ms[0]:.4f} ms, "
          f"plain {sn_ms[1]:.4f} ms", flush=True)
    for dt_name in ("bfloat16", "float32"):
        f, zz, ll = models[dt_name]
        ms = event_ms(torch, lambda: f(zz, ll), reps=20)
        print(f"  entry() forward, {dt_name}: {ms:.3f} ms ({batch / ms * 1e3:.1f} images/s)",
              flush=True)
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
    return totals, sn_ms


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

    from rcgan_tpu_torch.models.resnet_gan import Generator, ResnetGANConfig, sample
    from rcgan_tpu_torch.ops.kernels import runtime
    from rcgan_tpu_torch.ops.kernels.conv_kernel import conv3x3, conv3x3_plain
    from rcgan_tpu_torch.ops.kernels.norm_kernel import cond_batchnorm, cond_batchnorm_plain
    from rcgan_tpu_torch.ops.kernels.projection_kernel import (all_label_projection_logits,
                                                               projection_plain)
    from rcgan_tpu_torch.ops.kernels.sn_kernel import sn_plain, spectral_norm
    from rcgan_tpu_torch.serving import (Sampler, _to_png_grid, make_server, pin_float32,
                                         to_unit_range)

    # ---------------------------------------------------------------- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a"
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, triton {triton.__version__}", flush=True)
    pin_float32()
    dev = torch.device("cuda")
    print(f"TF32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)

    # ----------------------------------------------------------------- 2. build
    # one nvcc per CUDA source, all started together; the Triton kernels
    # compile at their first launch meanwhile
    def timed_build(name):
        t = time.perf_counter()
        runtime.cuda_library(name)
        return time.perf_counter() - t

    t_all = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = {name: pool.submit(timed_build, name) for name in ("conv3x3", "sn")}
        gen_cpu = torch.Generator().manual_seed(args.seed)
        x = torch.randn(2, 16, 8, generator=gen_cpu).to(dev)
        t0 = time.perf_counter()
        cond_batchnorm(x, torch.zeros(2, dtype=torch.int64, device=dev),
                       torch.ones(10, 8, device=dev), torch.zeros(10, 8, device=dev))
        torch.cuda.synchronize()
        print(f"build cond_bn (triton JIT, first launch): {time.perf_counter() - t0:.2f} s",
              flush=True)
        t0 = time.perf_counter()
        all_label_projection_logits(torch.zeros(2, 8, device=dev), torch.zeros(10, 8, device=dev),
                                    torch.zeros(2, 1, device=dev))
        torch.cuda.synchronize()
        print(f"build projection (triton JIT, first launch): {time.perf_counter() - t0:.2f} s",
              flush=True)
        for name, fut in builds.items():
            print(f"build {name} (nvcc, sm_90a): {fut.result():.2f} s", flush=True)
    print(f"builds, all together: {time.perf_counter() - t_all:.2f} s", flush=True)

    # ------------------------------------------------- 3. kernels against plain
    max_err = {k: 0.0 for k in runtime.KERNELS}
    inputs = {}  # float32 inputs at B in KERNEL_BATCHES, reused for timing
    for b in KERNEL_BATCHES:
        for s, c in sorted(set(COND_BN_SHAPES)):
            x = torch.randn(b, s, c, generator=gen_cpu) * 2.0 + 0.5
            labels = torch.randint(0, 10, (b,), generator=gen_cpu)
            scale = 1.0 + 0.1 * torch.randn(10, c, generator=gen_cpu)
            offset = 0.1 * torch.randn(10, c, generator=gen_cpu)
            args_f32 = [t.to(dev) for t in (x, labels, scale, offset)]
            inputs[("cond_bn", b, s, c)] = args_f32
            for dt in (torch.float32, torch.bfloat16):
                xd = args_f32[0].to(dt)
                got = cond_batchnorm(xd, *args_f32[1:])
                ref = cond_batchnorm_plain(xd.float(), *args_f32[1:])
                torch.cuda.synchronize()
                name = str(dt).split(".")[1]
                ok, err, rel = compare(torch, got, ref, name)
                if dt == torch.float32:
                    max_err["cond_bn"] = max(max_err["cond_bn"], err)
                check(ok, f"cond_bn [{b},{s},{c}] {name}: max abs err {err:.3e}, "
                          f"max rel err {rel:.3e}")
    # conv3x3 at the generator's shapes and at the discriminator's
    for tag, batches, shapes in (("conv3x3", KERNEL_BATCHES, CONV_SHAPES),
                                 ("conv3x3_d", D_BATCHES, D_CONV_SHAPES)):
        for b in batches:
            for hw, c, o in sorted(set(shapes)):
                x = torch.relu(torch.randn(b, hw, hw, c, generator=gen_cpu))
                w = torch.randn(3, 3, c, o, generator=gen_cpu) * (2.0 / (9 * c)) ** 0.5
                args_f32 = [x.to(dev), w.to(dev)]
                inputs[(tag, b, hw, c, o)] = args_f32
                for dt in (torch.float32, torch.bfloat16):
                    xd, wd = (t.to(dt) for t in args_f32)
                    got = conv3x3(xd, wd)
                    ref = conv3x3_plain(xd.float(), wd.float())
                    torch.cuda.synchronize()
                    name = str(dt).split(".")[1]
                    ok, err, rel = compare(torch, got, ref, name)
                    if dt == torch.float32:
                        max_err["conv3x3"] = max(max_err["conv3x3"], err)
                    check(ok, f"{tag} [{b},{hw},{hw},{c}]x[3,3,{c},{o}] {name}: max abs err "
                              f"{err:.3e}, max rel err {rel:.3e}")
    for m, cout in sorted(set(SN_SHAPES + SN_EXTRA_SHAPES)):
        w = (torch.randn(m, cout, generator=gen_cpu) / m ** 0.5).to(dev)
        u = torch.randn(1, cout, generator=gen_cpu).to(dev)
        got, ref = spectral_norm(w, u), sn_plain(w, u)
        torch.cuda.synchronize()
        errs = [(g - r).abs().max().item() for g, r in zip(got, ref)]
        scales = [r.abs().max().item() for r in ref]
        ok = all(bool(torch.isfinite(g).all()) for g in got) and all(
            e <= SN_TOL * s for e, s in zip(errs, scales))
        max_err["sn"] = max(max_err["sn"], errs[0])
        check(ok, f"sn [{m},{cout}] float32: max abs err W/sigma {errs[0]:.3e}, u' "
                  f"{errs[1]:.3e}, sigma rel {errs[2] / scales[2]:.3e} (limit {SN_TOL} of scale)")
    for b in PROJ_BATCHES:
        feat = torch.randn(b, 128, generator=gen_cpu).to(dev)
        emb = torch.randn(10, 128, generator=gen_cpu).to(dev)
        wgan = torch.randn(b, 1, generator=gen_cpu).to(dev)
        inputs[("projection", b)] = [feat, emb, wgan]
        for dt in (torch.float32, torch.bfloat16):
            targs = [t.to(dt) for t in (feat, emb, wgan)]
            got, ref = all_label_projection_logits(*targs), projection_plain(*targs)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            ok = got.dtype == torch.float32 and bool(torch.isfinite(got).all()) \
                and err <= PROJ_TOL * scale
            if dt == torch.float32:
                max_err["projection"] = max(max_err["projection"], err)
            check(ok, f"projection [{b},128]x[10,128] {str(dt).split('.')[1]} in: max abs err "
                      f"{err:.3e} (limit {PROJ_TOL} of scale {scale:.2f})")

    # --------------------------------------------------------------- 4. slice
    if args.checkpoint_dir:
        sampler = Sampler.from_checkpoint("cifar", args.checkpoint_dir, buckets=BUCKETS,
                                          device="cuda")
        gen = sampler.generator
    else:
        gen = Generator(ResnetGANConfig(), seed=args.seed, device="cuda")
        sampler = Sampler(gen, buckets=BUCKETS)
    cfg = gen.cfg
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

    for bkt in BUCKETS:  # warm-up: Triton specialises per shape
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
        counts = runtime.launch_counts()
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
        for k in ("cond_bn", "conv3x3"):
            check(passes > 0 and counts[k] == 7 * passes,
                  f"{k}: {counts[k]} launches over {passes} generator passes (want 7 per pass)")
        for k in ("sn", "projection"):
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
    impl = {"cond_bn": (cond_batchnorm, cond_batchnorm_plain, COND_BN_SHAPES,
                        "cond_bn per generator pass"),
            "conv3x3": (conv3x3, conv3x3_plain, CONV_SHAPES, "conv3x3 per generator pass"),
            "conv3x3_d": (conv3x3, conv3x3_plain, D_CONV_SHAPES,
                          "conv3x3 per D pass (12 calls)"),
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
        print(f"  {kname} {key[1:]}: kernel {tk:.4f} ms, plain {tp:.4f} ms "
              f"(x{mult} per pass)", flush=True)
    for kname, d in per_pass.items():
        for b, (tk, tp) in d.items():
            print(f"  {impl[kname][3]} at batch {b}: kernel {tk:.4f} ms, plain {tp:.4f} ms",
                  flush=True)
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
    d_counts, sn_ms = discriminator_slice(torch, dev, args.seed, max_err)

    if failures:
        print(f"{len(failures)} check(s) failed:", *failures, sep="\n  ", flush=True)
        return 1
    # launches: the serving path's and the discriminator slice's paths', each
    # counted from 0; times: per generator pass at batch 100 (cond_bn,
    # conv3x3), per D pass (sn), one call at batch 64 (projection)
    timed = {"cond_bn": per_pass["cond_bn"][100], "conv3x3": per_pass["conv3x3"][100],
             "sn": sn_ms, "projection": per_pass["projection"][64]}
    kernels = [dict(name=k, **KERNEL_INFO[k], launches=counts[k] + d_counts[k],
                    max_abs_err=max_err[k], ms=timed[k][0], plain_ms=timed[k][1])
               for k in runtime.KERNELS]
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
