"""MS-SSIM image similarity, ported from ``rcgan_tpu/evals/msssim.py``
(reference CLI: ``cifar10/common/msssim.py``, Wang et al. multi-scale SSIM
with the standard 5-level weights).

float32 throughout.  The Gaussian window is a depthwise VALID
``F.conv2d`` (``groups = C``), as JAX computes it with XLA's conv outside
any Pallas kernel: on the card it is cuDNN's, with TF32 off (the port's
float32 policy, applied by every function here).  Images are ``[B, H, W,
C]`` numpy arrays or tensors, moved to ``device`` (the card unless the
caller asks for the CPU).

CLI:  python -m rcgan_tpu_torch.evals.msssim --original_image a.png \\
        --compared_image b.png [--device cuda]
(8-bit grey, RGB or RGBA PNGs, decoded by ``utils/images.py::decode_png``
and taken as RGB, as the JAX CLI's ``Image.convert("RGB")`` does.)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from rcgan_tpu_torch.core.module import float32_policy
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device

_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _fspecial_gauss(size: int, sigma: float, device) -> torch.Tensor:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    k = np.outer(g, g)
    return torch.as_tensor((k / k.sum()).astype(np.float32), device=device)


def _filter2(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """'valid' 2-D filtering applied per channel; img [B,H,W,C]."""
    c = img.shape[-1]
    w = window[None, None].expand(c, 1, *window.shape)
    return F.conv2d(img.permute(0, 3, 1, 2), w, groups=c).permute(0, 2, 3, 1)


def _as_f32(img, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(img).to(device, torch.float32)


def ssim_per_image(img1, img2, max_val: float = 255.0, filter_size: int = 11,
                   filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
                   device="cuda"):
    """Returns ([B] SSIM, [B] contrast-structure) for [B,H,W,C] image pairs
    (spatial/channel mean only; :func:`ssim` is its batch mean)."""
    dev = resolve_device(device)
    float32_policy(torch.float32)
    img1, img2 = _as_f32(img1, dev), _as_f32(img2, dev)
    h, w = img1.shape[1:3]
    size = min(filter_size, h, w)
    sigma = size * filter_sigma / filter_size if filter_size else 0

    if size:
        window = _fspecial_gauss(size, sigma, dev)
        mu1, mu2 = _filter2(img1, window), _filter2(img2, window)
        sigma11 = _filter2(img1 * img1, window)
        sigma22 = _filter2(img2 * img2, window)
        sigma12 = _filter2(img1 * img2, window)
    else:
        mu1, mu2 = img1, img2
        sigma11, sigma22, sigma12 = img1 * img1, img2 * img2, img1 * img2

    mu11, mu22, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma11 = sigma11 - mu11
    sigma22 = sigma22 - mu22
    sigma12 = sigma12 - mu12

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    v1 = 2.0 * sigma12 + c2
    v2 = sigma11 + sigma22 + c2
    dims = (1, 2, 3)
    s = torch.mean((2.0 * mu12 + c1) * v1 / ((mu11 + mu22 + c1) * v2), dim=dims)
    cs = torch.mean(v1 / v2, dim=dims)
    return s, cs


def ssim(img1, img2, max_val: float = 255.0, filter_size: int = 11, filter_sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03, device="cuda"):
    """Returns (mean SSIM, mean contrast-structure) for [B,H,W,C] images."""
    s, cs = ssim_per_image(img1, img2, max_val, filter_size, filter_sigma, k1, k2, device)
    return torch.mean(s), torch.mean(cs)


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x average-pool; an odd edge is cropped first."""
    _, h, w, _ = img.shape
    img = img[:, : h - h % 2, : w - w % 2, :]
    return 0.25 * (img[:, ::2, ::2] + img[:, 1::2, ::2] + img[:, ::2, 1::2] + img[:, 1::2, 1::2])


def _scales(img1, img2, max_val: float, weights, device, per_image: bool):
    """SSIM and contrast-structure at each of ``len(weights)`` dyadic
    scales, clamped at 0 before the fractional powers: cs can go negative
    for very dissimilar pairs, and (negative)**0.0448 is NaN (the
    tf.image ssim_multiscale relu convention)."""
    dev = resolve_device(device)
    img1, img2 = _as_f32(img1, dev), _as_f32(img2, dev)
    fn = ssim_per_image if per_image else ssim
    mssim, mcs = [], []
    for _ in weights:
        s, cs = fn(img1, img2, max_val=max_val, device=dev)
        mssim.append(s)
        mcs.append(cs)
        img1, img2 = _downsample2(img1), _downsample2(img2)
    w = torch.tensor(weights, dtype=torch.float32, device=dev)
    return torch.clamp(torch.stack(mssim), min=0.0), torch.clamp(torch.stack(mcs), min=0.0), w


def msssim(img1, img2, max_val: float = 255.0, weights=_WEIGHTS, device="cuda") -> float:
    """Multi-scale SSIM over ``len(weights)`` dyadic scales."""
    mssim, mcs, w = _scales(img1, img2, max_val, weights, device, per_image=False)
    return float(torch.prod(mcs[:-1] ** w[:-1]) * (mssim[-1] ** w[-1]))


def msssim_pairs(img1, img2, max_val: float = 255.0, weights=_WEIGHTS,
                 device="cuda") -> torch.Tensor:
    """Per-pair multi-scale SSIM, batched: [B,H,W,C] × [B,H,W,C] → [B] (the
    mean intra-class MS-SSIM diversity protocol of Odena et al. 2017 reads
    the pairs' distribution, where :func:`msssim`'s scalar would conflate
    them)."""
    mssim, mcs, w = _scales(img1, img2, max_val, weights, device, per_image=True)
    w = w[:, None]
    return torch.prod(mcs[:-1] ** w[:-1], dim=0) * (mssim[-1] ** w[-1, 0])


def _rgb(path: str) -> np.ndarray:
    """``[1, H, W, 3]`` float32 of an 8-bit PNG: grey repeated to three
    channels, alpha dropped."""
    from rcgan_tpu_torch.utils.images import decode_png

    with open(path, "rb") as f:
        img = decode_png(f.read())
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] in (1, 2):  # grey (and alpha)
        img = np.repeat(img[:, :, :1], 3, axis=2)
    return img[None, :, :, :3].astype(np.float32)


def _main(argv=None):
    """CLI parity with ``python msssim.py --original_image a.png
    --compared_image b.png`` (``cifar10/common/msssim.py:36-218``)."""
    p = argparse.ArgumentParser(description="MS-SSIM between two images")
    p.add_argument("--original_image", required=True)
    p.add_argument("--compared_image", required=True)
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = p.parse_args(argv)
    a, b = _rgb(args.original_image), _rgb(args.compared_image)
    if a.shape != b.shape:
        raise SystemExit(f"image shapes differ: {a.shape[1:3]} vs {b.shape[1:3]}")
    print(msssim(a, b, device=args.device))


if __name__ == "__main__":
    _main()
