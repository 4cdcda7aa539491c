#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rcgan_tpu_torch``) on one NVIDIA GPU.

Drives the port's serving path once at the flagship width
(``ResnetGANConfig()``: z_dim 128, dim_g 128, 10 classes, float32):

1. device check (CUDA required), card name and power limit, versions;
2. build of the hand-written kernels from the repo's sources;
3. each kernel against its plain PyTorch version on the card, at every
   generator shape, batch 1, 8, 32, 64 and 100, float32 and bfloat16, TF32 off;
4. the slice: a seeded generator (or ``--checkpoint_dir``'s
   ``generator.npz``) behind ``Sampler`` and ``make_server``, concurrent
   ``/sample`` requests plus ``/healthz``, ``/models`` and ``/metrics``,
   with the kernels' launch counters read around that run, and the card's
   output held against the same generator run on the CPU;
5. medians of CUDA-event times: each kernel against its plain version,
   the generator forward per bucket, ``/sample`` latency and its host
   stages at 100 images; and a ``torch.profiler`` trace of the forward at buckets 1 and 100 for the
   device's busy share and the time by kernel.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Exits non-zero without a result when CUDA is unavailable or any check fails.

    python3 chip_smoke.py [--checkpoint_dir DIR] [--seed 0]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
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

KERNEL_INFO = {
    "cond_bn": {"route": "triton", "source": "rcgan_tpu_torch/ops/kernels/norm_kernel.py",
                "replaces": "rcgan_tpu/ops/pallas/norm_kernel.py:123"},
    "conv3x3": {"route": "cuda", "source": "rcgan_tpu_torch/csrc/conv3x3.cu",
                "replaces": "rcgan_tpu/ops/pallas/conv_kernel.py:101"},
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
    t0 = time.perf_counter()
    runtime.cuda_library("conv3x3")
    print(f"build conv3x3 (nvcc, sm_90a): {time.perf_counter() - t0:.2f} s", flush=True)
    gen_cpu = torch.Generator().manual_seed(args.seed)
    x = torch.randn(2, 16, 8, generator=gen_cpu).to(dev)
    t0 = time.perf_counter()
    cond_batchnorm(x, torch.zeros(2, dtype=torch.int64, device=dev),
                   torch.ones(10, 8, device=dev), torch.zeros(10, 8, device=dev))
    torch.cuda.synchronize()
    print(f"build cond_bn (triton JIT, first launch): {time.perf_counter() - t0:.2f} s", flush=True)

    # ------------------------------------------------- 3. kernels against plain
    max_err = {"cond_bn": 0.0, "conv3x3": 0.0}
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
        for hw, c, o in sorted(set(CONV_SHAPES)):
            x = torch.relu(torch.randn(b, hw, hw, c, generator=gen_cpu))
            w = torch.randn(3, 3, c, o, generator=gen_cpu) * (2.0 / (9 * c)) ** 0.5
            args_f32 = [x.to(dev), w.to(dev)]
            inputs[("conv3x3", b, hw, c, o)] = args_f32
            for dt in (torch.float32, torch.bfloat16):
                xd, wd = (t.to(dt) for t in args_f32)
                got = conv3x3(xd, wd)
                ref = conv3x3_plain(xd.float(), wd.float())
                torch.cuda.synchronize()
                name = str(dt).split(".")[1]
                ok, err, rel = compare(torch, got, ref, name)
                if dt == torch.float32:
                    max_err["conv3x3"] = max(max_err["conv3x3"], err)
                check(ok, f"conv3x3 [{b},{hw},{hw},{c}]x[3,3,{c},{o}] {name}: max abs err "
                          f"{err:.3e}, max rel err {rel:.3e}")

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
        for k in runtime.KERNELS:
            check(passes > 0 and counts[k] == 7 * passes,
                  f"{k}: {counts[k]} launches over {passes} generator passes (want 7 per pass)")

        # ---------------------------------------------------------- 5. times
        for path in requests:
            lat = [get(path)[2] * 1e3 for _ in range(5)]
            latency_ms[path] = statistics.median(lat)
    finally:
        srv.shutdown()
        srv.server_close()
        server_thread.join(timeout=10)

    print(f"times on {card}: medians of CUDA events, float32, TF32 off", flush=True)
    per_pass = {"cond_bn": {b: [0.0, 0.0] for b in KERNEL_BATCHES},
                "conv3x3": {b: [0.0, 0.0] for b in KERNEL_BATCHES}}
    for key, targs in inputs.items():
        kname, b = key[0], key[1]
        kern, plain = ((cond_batchnorm, cond_batchnorm_plain) if kname == "cond_bn"
                       else (conv3x3, conv3x3_plain))
        tk = event_ms(torch, lambda: kern(*targs))
        tp = event_ms(torch, lambda: plain(*targs))
        tk2 = event_ms(torch, lambda: kern(*targs))
        tp2 = event_ms(torch, lambda: plain(*targs))
        tk, tp = statistics.median([tk, tk2]), statistics.median([tp, tp2])
        shapes = COND_BN_SHAPES if kname == "cond_bn" else CONV_SHAPES
        mult = shapes.count(tuple(key[2:]))
        per_pass[kname][b][0] += mult * tk
        per_pass[kname][b][1] += mult * tp
        print(f"  {kname} {key[1:]}: kernel {tk:.4f} ms, plain {tp:.4f} ms "
              f"(x{mult} per pass)", flush=True)
    for kname, d in per_pass.items():
        for b, (tk, tp) in d.items():
            print(f"  {kname} per generator pass at batch {b}: kernel {tk:.4f} ms, "
                  f"plain {tp:.4f} ms", flush=True)
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

    if failures:
        print(f"{len(failures)} check(s) failed:", *failures, sep="\n  ", flush=True)
        return 1
    kernels = [dict(name=k, **KERNEL_INFO[k], launches=counts[k], max_abs_err=max_err[k],
                    ms=per_pass[k][100][0], plain_ms=per_pass[k][100][1])
               for k in runtime.KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
