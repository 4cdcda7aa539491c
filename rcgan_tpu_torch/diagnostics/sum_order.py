"""How ``chip_smoke.py``'s float32 card-vs-CPU training check answers to the
order in which the hand-written float32 kernels sum.

The check (batch 8, two cycles of rcgan and of rcgan-u at five data seeds,
limits 3x ``TRAIN_SPREAD``) reads gradients that are ill-conditioned in
float32, with near-ties that a reordered sum can tip.  This replays it on
the card under several arithmetics of the FFMA conv3x3, the spectral-norm
and the cond-BN kernels, so that a failure after a change to the float32
path can be told apart from a wrong kernel, and so that the check's limits
can be derived from the spread over those arithmetics:

1. every FFMA conv, spectral-norm and cond-BN call of the check's iteration
   0, held against float64 on its own tensors (max |err| / max |ref|): the
   kernel's distance and, for sn and cond-BN, the plain version's;
2. the check itself, its readings against its limits
   (``chip_smoke.train_limits``), for each data seed asked for (default:
   ``CHECK_TRAIN["data_seeds"]``), with one kernel at a time replaced:
   conv3x3 by the shipped
   geometry (``ffma_geometry``), ``split first`` (64 x 64 tiles split over
   K wherever 64 x 64 tiles are fewer than the SMs), ``unsplit`` (the
   shipped tiles with K never split) and ``float64`` (each call computed in
   float64 and rounded once); sn and cond-BN each by the shipped kernel,
   their plain version and float64; and all three in float64 together.  A
   table per data seed says which arithmetics pass every reading.  With
   ``--scan`` it then prints the spread of every reading per iteration,
   its median and its max over the algorithms, the data seeds and the
   arithmetics, as the dict ``TRAIN_SPREAD`` from which ``chip_smoke.py``
   derives the check's limits: a change of the float32 sum order that stays
   within the spread of these nine cannot fail the check.  As in
   ``chip_smoke.py``, the replay runs under PyTorch's deterministic
   algorithms, so a reading repeats from run to run;
3. with ``--times``, the six FFMA calls of a float32 generator pass at each
   serving bucket under each geometry, device time in CUDA graphs.

Needs a card; run from the repository's root (it reads the check's data,
readings and limits from ``chip_smoke.py``):

    python3 -m rcgan_tpu_torch.diagnostics.sum_order [--data_seeds 200 201 ...] [--scan] [--times]
"""

from __future__ import annotations

import argparse
import collections
import statistics
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from rcgan_tpu_torch.ops.kernels import conv_kernel, norm_kernel, runtime, sn_kernel

_ROOT = Path(__file__).resolve().parents[2]


def _conv64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The conv in float64, NHWC x HWIO -> NHWC."""
    out = F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1)


def _split_first(x_shape, o: int, sms: int):
    b, h, w, c = x_shape
    m = b * h * w
    if conv_kernel._blocks(m, o, 128, 128) >= sms:
        return 128, 128, 1
    blocks = conv_kernel._blocks(m, o, 64, 64)
    if blocks >= sms:
        return 64, 64, 1
    return 64, 64, min(-(-sms // blocks), 9 * c // conv_kernel.FFMA_BK[64])


def _unsplit(x_shape, o: int, sms: int):
    bm, bn, _ = SHIPPED["ffma_geometry"](x_shape, o, sms)
    return bm, bn, 1


def _float64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _conv64(x, w).to(x.dtype).contiguous()


def _sn64(w: torch.Tensor, u0: torch.Tensor):
    """``sn_plain`` in float64, each output rounded once."""
    w, u0 = w.double(), u0.double()
    v = u0 @ w.T
    v = v / (torch.sqrt(torch.sum(v * v)) + 1e-12)
    u = v @ w
    u = u / (torch.sqrt(torch.sum(u * u)) + 1e-12)
    sigma = (v @ w @ u.T)[0, 0]
    return (w / sigma).float(), u.float(), sigma.float()


def _sn_group_by(fn):
    """A stand-in for ``sn_kernel._launch_group`` that runs ``fn`` per weight."""
    return lambda pairs: [t for w, u in pairs for t in fn(w, u)]


def _cond_bn_plain(x, labels, scale_table, offset_table, eps, relu=False):
    mean, inv = norm_kernel._moments_plain(x, eps)
    out = norm_kernel._apply_plain(x, labels, scale_table, offset_table, mean, inv, relu)
    return out, mean, inv


def _cond_bn64(x, labels, scale_table, offset_table, eps, relu=False):
    """The cond-BN forward in float64, each output rounded once."""
    x64 = x.double()
    mean = x64.mean(dim=(0, 1))
    inv = torch.rsqrt(torch.clamp((x64 * x64).mean(dim=(0, 1)) - mean * mean, min=0.0) + eps)
    out = (x64 - mean) * inv * scale_table.double()[labels][:, None, :] \
        + offset_table.double()[labels][:, None, :]
    return (torch.relu(out) if relu else out).to(x.dtype), mean.float(), inv.float()


SHIPPED = {"ffma_geometry": conv_kernel.ffma_geometry, "_launch_ffma": conv_kernel._launch_ffma,
           "sn": sn_kernel._launch_group, "cond_bn": norm_kernel._launch}
ARITHMETICS = {
    "shipped": {},
    "all three float64": {"_launch_ffma": _float64, "sn": _sn_group_by(_sn64),
                          "cond_bn": _cond_bn64},
    "conv3x3 float64": {"_launch_ffma": _float64},
    "conv3x3 split first": {"ffma_geometry": _split_first},
    "conv3x3 unsplit": {"ffma_geometry": _unsplit},
    "sn float64": {"sn": _sn_group_by(_sn64)},
    "sn plain": {"sn": _sn_group_by(sn_kernel.sn_plain)},
    "cond_bn float64": {"cond_bn": _cond_bn64},
    "cond_bn plain": {"cond_bn": _cond_bn_plain},
}


def _use(patch: dict) -> None:
    conv_kernel.ffma_geometry = patch.get("ffma_geometry", SHIPPED["ffma_geometry"])
    conv_kernel._launch_ffma = patch.get("_launch_ffma", SHIPPED["_launch_ffma"])
    sn_kernel._launch_group = patch.get("sn", SHIPPED["sn"])
    norm_kernel._launch = patch.get("cond_bn", SHIPPED["cond_bn"])


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.double() - ref.double()).abs().max()
            / ref.double().abs().max().clamp_min(1e-30)).item()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_seeds", type=int, nargs="*", default=None,
                   help="replay the check with its data drawn from each of these (default: "
                        "chip_smoke.py's CHECK_TRAIN['data_seeds'])")
    p.add_argument("--scan", action="store_true",
                   help="print the spread of every reading over the algorithms, the data seeds "
                        "and the arithmetics: chip_smoke.py's TRAIN_SPREAD")
    p.add_argument("--times", action="store_true",
                   help="also time a float32 G pass's FFMA convs under each geometry")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("CUDA is not available: this diagnostic needs an NVIDIA GPU", flush=True)
        return 2
    sys.path.insert(0, str(_ROOT))
    import chip_smoke as cs

    from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
    from rcgan_tpu_torch.bridge import to_jax_train_state, train_state_from_jax
    from rcgan_tpu_torch.data.confusion import build_confusion
    from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
    from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer

    dev = torch.device("cuda")
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    # as the check runs: deterministic algorithms, so that a replay repeats
    torch.use_deterministic_algorithms(True, warn_only=True)
    c_mat, _ = build_confusion(0.6)
    tcfg = CifarTrainConfig(n_critic=cs.CHECK_TRAIN["n_critic"],
                            gen_bs_multiple=cs.CHECK_TRAIN["gen_bs_multiple"])
    data_seeds = args.data_seeds or list(cs.CHECK_TRAIN["data_seeds"])
    algorithms = (("rcgan", False), ("rcgan-u", True))

    def trainers(alg, perm):
        # float32 trainers: they turn TF32 off themselves (float32_policy)
        cfg = ResnetGANConfig(algorithm=alg)
        acfg = CifarAlgoConfig(algorithm=alg, perm_classifier=perm, confuse_init=perm)
        # the cycle's eager body on the card: the check's two cycles (iteration
        # 0, then a first G step) run eagerly on a capturing trainer too
        return cfg, acfg, {side: CifarTrainer(cfg, acfg, tcfg, c_mat,
                                              dev if side == "card" else "cpu",
                                              graphs=False if side == "card" else None)
                           for side in ("card", "cpu")}

    # 1. every FFMA, sn and cond-BN call of iteration 0 against float64
    worst = collections.defaultdict(float)

    def conv_checked(x, w):
        y = SHIPPED["_launch_ffma"](x, w)
        geo = conv_kernel.ffma_geometry(x.shape, w.shape[3], runtime.sm_count(x))
        key = ("conv3x3", f"x {tuple(x.shape)} -> {w.shape[3]}, (bm, bn, splits) {geo}", "kernel")
        worst[key] = max(worst[key], _rel(y, _conv64(x, w)))
        return y

    def sn_checked(pairs):
        out = SHIPPED["sn"](pairs)
        for i, (w, u) in enumerate(pairs):
            ref = _sn64(w, u)
            for who, got in (("kernel", out[3 * i:3 * i + 3]), ("plain", sn_kernel.sn_plain(w, u))):
                key = ("sn", f"w {tuple(w.shape)}, in a group of {len(pairs)}", who)
                worst[key] = max(worst[key], max(_rel(g, r) for g, r in zip(got, ref)))
        return out

    def cond_bn_checked(x, labels, scale_table, offset_table, eps, relu=False):
        out = SHIPPED["cond_bn"](x, labels, scale_table, offset_table, eps, relu)
        ref = _cond_bn64(x, labels, scale_table, offset_table, eps, relu)
        plain = _cond_bn_plain(x, labels, scale_table, offset_table, eps, relu)
        for who, got in (("kernel", out), ("plain", plain)):
            key = ("cond_bn", f"x {tuple(x.shape)}, relu {bool(relu)}", who)
            worst[key] = max(worst[key], _rel(got[0], ref[0]))
        return out

    _use({"_launch_ffma": conv_checked, "sn": sn_checked, "cond_bn": cond_bn_checked})
    feeds = cs.check_train_feeds(0, data_seeds[0])
    for alg, perm in algorithms:
        _, _, tr = trainers(alg, perm)
        d, g, noise = feeds[0]
        tr["card"].step(tr["card"].init(0), d, g, 0, 0, noise=noise)
    torch.cuda.synchronize()
    _use({})
    print(f"TF32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)
    print("calls of the check's iteration 0 against float64 on their own tensors (worst max "
          "|err| / max |ref| over the call's outputs):", flush=True)
    for kernel, what in sorted({k[:2] for k in worst}):
        print(f"  {kernel} {what}: " + ", ".join(
            f"{who} {worst[(kernel, what, who)]:.2e}" for who in ("kernel", "plain")
            if (kernel, what, who) in worst), flush=True)

    # 2. the check under each arithmetic, each cycle from the card's state
    spread = {0: collections.defaultdict(list), 1: collections.defaultdict(list)}
    for data_seed in data_seeds:
        feeds = cs.check_train_feeds(0, data_seed)
        table = {}
        for name, patch in ARITHMETICS.items():
            _use(patch)
            for alg, perm in algorithms:
                cfg, acfg, tr = trainers(alg, perm)
                ts_card = tr["card"].init(0)
                one_param = cs.one_param_of(ts_card)
                for it, (d, g, noise) in enumerate(feeds):
                    ts_cpu = train_state_from_jax(to_jax_train_state(ts_card), cfg, acfg, tcfg,
                                                  "cpu")
                    before = {k: st.count for k, st in ts_card.opt_states.items()}
                    ts_cpu, m_cpu = tr["cpu"].step(ts_cpu, d, g, it, 0, noise=noise)
                    ts_card, m_card = tr["card"].step(ts_card, d, g, it, 0, noise=noise)
                    steps = {k: st.count - before[k] for k, st in ts_card.opt_states.items()}
                    r, _ = cs.train_readings(to_jax_train_state(ts_cpu),
                                             to_jax_train_state(ts_card), m_cpu, m_card, tcfg.lr,
                                             steps)
                    limits = cs.train_limits(it, one_param)
                    over = [k for k, v in r.items() if v > limits.get(k, (0, float("inf")))[1]]
                    table[(name, alg, it)] = over
                    for k, v in r.items():
                        spread[it][k].append(v)
                    print(f"  [data seed {data_seed}] [{name}] {alg} iteration {it}: "
                          + ", ".join(f"{k} {v:.3g}" for k, v in r.items())
                          + f"; over the max limits: {over or 'none'}", flush=True)
        _use({})
        print(f"data seed {data_seed}, readings over the max limits per arithmetic "
              f"(algorithm/iteration):", flush=True)
        for name in ARITHMETICS:
            cells = [f"{alg}/{it} " + (",".join(table[(name, alg, it)]) or "pass")
                     for alg, _ in algorithms for it in range(len(feeds))]
            print(f"  {name:22s} " + " | ".join(cells), flush=True)
    if args.scan:
        print(f"spread over {len(algorithms)} algorithms x {len(data_seeds)} data seeds "
              f"{data_seeds} x {len(ARITHMETICS)} arithmetics (median, max) per iteration, on "
              f"{torch.cuda.get_device_name(0)}:", flush=True)
        print("TRAIN_SPREAD = " + repr({it: {k: (float(f"{statistics.median(v):.3g}"),
                                                 float(f"{max(v):.3g}"))
                                             for k, v in sorted(d.items())}
                                        for it, d in spread.items()}), flush=True)

    # 3. the six FFMA calls of a float32 G pass per bucket, per geometry
    if not args.times:
        return 0
    torch.use_deterministic_algorithms(False)
    shapes = [s for s in cs.CONV_SHAPES if s[2] % conv_kernel.CHANNEL_MULTIPLE == 0]
    gen = torch.Generator().manual_seed(0)
    for b in cs.BUCKETS:
        conv_args = [(torch.randn(b, hw, hw, c, generator=gen).to(dev),
                      (torch.randn(3, 3, c, o, generator=gen) * 0.02).to(dev))
                     for hw, c, o in shapes]
        times = {}
        for name in ("shipped", "conv3x3 split first", "conv3x3 unsplit"):
            _use(ARITHMETICS[name])
            with torch.no_grad():
                times[name] = sum(cs.graph_ms(torch, lambda: conv_kernel.conv3x3(x, w))
                                  for x, w in conv_args)
        _use({})
        print(f"  {len(shapes)} FFMA calls of a float32 G pass at bucket {b}, CUDA graphs: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
