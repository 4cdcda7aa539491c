"""How ``chip_smoke.py``'s float32 card-vs-CPU training check answers to the
order in which the FFMA conv3x3 kernel sums.

The check (batch 8, two cycles of rcgan and of rcgan-u, ``TRAIN_TOL``)
reads gradients that are ill-conditioned in float32, with near-ties that a
reordered sum can tip.  This replays it on the card under several conv
arithmetics, so that a failure after a change to the float32 path can be
told apart from a wrong kernel:

1. every FFMA call of the check's iteration 0, held against float64 on its
   own tensors (max |err| / max |ref|), with its geometry;
2. the check itself, its readings against ``TRAIN_TOL``, with the FFMA
   calls made by: the shipped geometry (``ffma_geometry``); ``split
   first``, 64 x 64 tiles split over K wherever 64 x 64 tiles are fewer
   than the SMs (no 32 x 32 or 16 x 16 tiles); ``unsplit``, the shipped
   tiles with K never split; ``float64``, each call computed in float64
   and rounded once;
3. the six FFMA calls of a float32 generator pass at each serving bucket
   under each geometry, device time in CUDA graphs.

Needs a card; run from the repository's root (it reads the check's data,
readings and limits from ``chip_smoke.py``):

    python3 -m rcgan_tpu_torch.diagnostics.sum_order
"""

from __future__ import annotations

import collections
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from rcgan_tpu_torch.ops.kernels import conv_kernel, runtime

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
    bm, bn, _ = SHIPPED["geometry"](x_shape, o, sms)
    return bm, bn, 1


def _float64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _conv64(x, w).to(x.dtype).contiguous()


SHIPPED = {"geometry": conv_kernel.ffma_geometry, "launch": conv_kernel._launch_ffma}
ARITHMETICS = {"shipped": {}, "split first": {"ffma_geometry": _split_first},
               "unsplit": {"ffma_geometry": _unsplit}, "float64": {"_launch_ffma": _float64}}


def _use(patch: dict) -> None:
    conv_kernel.ffma_geometry = patch.get("ffma_geometry", SHIPPED["geometry"])
    conv_kernel._launch_ffma = patch.get("_launch_ffma", SHIPPED["launch"])


def _feeds(cs):
    """The check's two cycles of data and noise, as ``chip_smoke.py`` draws
    them at seed 0."""
    b, nc, gm = cs.CHECK_TRAIN["batch"], cs.CHECK_TRAIN["n_critic"], cs.CHECK_TRAIN["gen_bs_multiple"]
    rng = np.random.default_rng(3)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("CUDA is not available: this diagnostic needs an NVIDIA GPU", flush=True)
        return 2
    sys.path.insert(0, str(_ROOT))
    import chip_smoke as cs

    from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
    from rcgan_tpu_torch.bridge import to_jax_train_state, train_state_from_jax
    from rcgan_tpu_torch.data.confusion import build_confusion
    from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
    from rcgan_tpu_torch.serving import pin_float32
    from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer

    pin_float32()
    dev = torch.device("cuda")
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    c_mat, _ = build_confusion(0.6)
    tcfg = CifarTrainConfig(n_critic=cs.CHECK_TRAIN["n_critic"],
                            gen_bs_multiple=cs.CHECK_TRAIN["gen_bs_multiple"])
    feeds = _feeds(cs)
    algorithms = (("rcgan", False), ("rcgan-u", True))

    def trainers(alg, perm):
        cfg = ResnetGANConfig(algorithm=alg)
        acfg = CifarAlgoConfig(algorithm=alg, perm_classifier=perm, confuse_init=perm)
        return cfg, acfg, {side: CifarTrainer(cfg, acfg, tcfg, c_mat,
                                              dev if side == "card" else "cpu")
                           for side in ("card", "cpu")}

    # 1. every FFMA call of iteration 0 against float64
    worst = collections.defaultdict(float)

    def checked(x, w):
        y = SHIPPED["launch"](x, w)
        ref = _conv64(x, w)
        key = (tuple(x.shape), w.shape[3], conv_kernel.ffma_geometry(x.shape, w.shape[3],
                                                                     runtime.sm_count(x)))
        err = ((y.double() - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()
        worst[key] = max(worst[key], err)
        return y

    _use({"_launch_ffma": checked})
    for alg, perm in algorithms:
        _, _, tr = trainers(alg, perm)
        d, g, noise = feeds[0]
        tr["card"].step(tr["card"].init(0), d, g, 0, 0, noise=noise)
    torch.cuda.synchronize()
    _use({})
    print("FFMA calls of the check's iteration 0 against float64 (worst max |err| / max |ref|):",
          flush=True)
    for (shape, o, geo), err in sorted(worst.items()):
        print(f"  x {shape} -> {o}, (bm, bn, splits) {geo}: {err:.2e}", flush=True)

    # 2. the check under each arithmetic, each cycle from the card's state
    for name, patch in ARITHMETICS.items():
        _use(patch)
        for alg, perm in algorithms:
            cfg, acfg, tr = trainers(alg, perm)
            ts_card = tr["card"].init(0)
            for it, (d, g, noise) in enumerate(feeds):
                ts_cpu = train_state_from_jax(to_jax_train_state(ts_card), cfg, acfg, tcfg, "cpu")
                before = {k: st.count for k, st in ts_card.opt_states.items()}
                ts_cpu, m_cpu = tr["cpu"].step(ts_cpu, d, g, it, 0, noise=noise)
                ts_card, m_card = tr["card"].step(ts_card, d, g, it, 0, noise=noise)
                steps = {k: st.count - before[k] for k, st in ts_card.opt_states.items()}
                r, _ = cs.train_readings(to_jax_train_state(ts_cpu), to_jax_train_state(ts_card),
                                         m_cpu, m_card, tcfg.lr, steps)
                over = [k for k, v in r.items() if v > cs.TRAIN_TOL[it].get(k, float("inf"))]
                print(f"  [{name}] {alg} iteration {it}: "
                      + ", ".join(f"{k} {v:.3g}" for k, v in r.items())
                      + f"; over TRAIN_TOL: {over or 'none'}", flush=True)
    _use({})

    # 3. the six FFMA calls of a float32 G pass per bucket, per geometry
    shapes = [s for s in cs.CONV_SHAPES if s[2] % conv_kernel.CHANNEL_MULTIPLE == 0]
    gen = torch.Generator().manual_seed(0)
    for b in cs.BUCKETS:
        args = [(torch.randn(b, hw, hw, c, generator=gen).to(dev),
                 (torch.randn(3, 3, c, o, generator=gen) * 0.02).to(dev)) for hw, c, o in shapes]
        times = {}
        for name in ("shipped", "split first", "unsplit"):
            _use(ARITHMETICS[name])
            with torch.no_grad():
                times[name] = sum(cs.graph_ms(torch, lambda: conv_kernel.conv3x3(x, w))
                                  for x, w in args)
        _use({})
        print(f"  {len(shapes)} FFMA calls of a float32 G pass at bucket {b}, CUDA graphs: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
