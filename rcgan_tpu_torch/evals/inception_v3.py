"""Inception-v3 for paper-scale inception scores, ported from
``rcgan_tpu/evals/inception_v3.py``.

The reference scores CIFAR samples with Google's frozen Inception-v3
(``cifar10/common/inception/inception_score_.py:26-48``; real CIFAR-10
scores 11.31 ± 0.08 there, ``:82``).  This is the inference graph in
torchvision's layer layout:

- **Weights** come from an ``.npz`` or pickle of numpy arrays named as
  torchvision's ``state_dict`` (``Conv2d_1a_3x3.conv.weight``,
  ``Mixed_5b.branch1x1.bn.running_mean``, ``fc.weight``, ...), dropped at
  ``<data_dir>/inception_v3.npz``; the aux head and ``num_batches_tracked``
  are dropped on load (:func:`load_weights`), and :func:`validate_weights`
  holds a state dict to :func:`weight_spec`.
- **Preprocessing** (:func:`preprocess`): images in [-1, 1] to [0, 1],
  bilinear resize to 299 with half-pixel centres (``jax.image.resize``'s
  ``"bilinear"``, which for an enlargement is ``F.interpolate`` with
  ``align_corners=False``), then ImageNet normalisation.  A reduction (an
  input above 299 pixels) is antialiased, as JAX's default is.
- **The graph**: conv (no bias) + frozen BN (eps 1e-3) + ReLU blocks,
  InceptionA-E, global average pool and ``fc``; the aux head is left out.
  The convs are ``F.conv2d`` (cuDNN on the card, TF32 off), as the JAX
  package runs them through ``lax.conv`` outside any Pallas kernel.
  Activations are NCHW inside; :func:`inception_v3_blocks` gives each
  block's output NHWC, as JAX's.

Without weights the apps score with the compact stand-in classifier
(``evals/classifier.py``), whose scores are not on the 11.31 scale.
"""

from __future__ import annotations

import functools
import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rcgan_tpu_torch.core.module import float32_policy
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device

# ImageNet eval preprocessing (torchvision): [0, 1] input, per channel
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)
_BN_EPS = 1e-3
SIZE = 299

Params = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------
# primitive blocks (NCHW; weights OIHW as in the torch state_dict)
# --------------------------------------------------------------------------


def _conv_bn(p: Params, name: str, x: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
    """BasicConv2d: conv (no bias) + frozen BN(eps=1e-3) + ReLU."""
    out = F.conv2d(x, p[f"{name}.conv.weight"], stride=stride, padding=padding)
    inv = p[f"{name}.bn.weight"] * torch.rsqrt(p[f"{name}.bn.running_var"] + _BN_EPS)
    shift = p[f"{name}.bn.bias"] - p[f"{name}.bn.running_mean"] * inv
    return F.relu(out * inv[:, None, None] + shift[:, None, None])


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


def _avg_pool_3x3_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool with pad 1, the pads counted (torch's
    default ``count_include_pad``)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1)


# --------------------------------------------------------------------------
# inception blocks (torchvision InceptionA..E)
# --------------------------------------------------------------------------


def _inception_a(p, n, x):
    b1 = _conv_bn(p, f"{n}.branch1x1", x)
    b5 = _conv_bn(p, f"{n}.branch5x5_2", _conv_bn(p, f"{n}.branch5x5_1", x), padding=2)
    b3 = _conv_bn(p, f"{n}.branch3x3dbl_1", x)
    b3 = _conv_bn(p, f"{n}.branch3x3dbl_2", b3, padding=1)
    b3 = _conv_bn(p, f"{n}.branch3x3dbl_3", b3, padding=1)
    bp = _conv_bn(p, f"{n}.branch_pool", _avg_pool_3x3_same(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b(p, n, x):
    b3 = _conv_bn(p, f"{n}.branch3x3", x, stride=2)
    bd = _conv_bn(p, f"{n}.branch3x3dbl_1", x)
    bd = _conv_bn(p, f"{n}.branch3x3dbl_2", bd, padding=1)
    bd = _conv_bn(p, f"{n}.branch3x3dbl_3", bd, stride=2)
    return torch.cat([b3, bd, _max_pool(x)], dim=1)


def _inception_c(p, n, x):
    b1 = _conv_bn(p, f"{n}.branch1x1", x)
    b7 = _conv_bn(p, f"{n}.branch7x7_1", x)
    b7 = _conv_bn(p, f"{n}.branch7x7_2", b7, padding=(0, 3))
    b7 = _conv_bn(p, f"{n}.branch7x7_3", b7, padding=(3, 0))
    bd = _conv_bn(p, f"{n}.branch7x7dbl_1", x)
    bd = _conv_bn(p, f"{n}.branch7x7dbl_2", bd, padding=(3, 0))
    bd = _conv_bn(p, f"{n}.branch7x7dbl_3", bd, padding=(0, 3))
    bd = _conv_bn(p, f"{n}.branch7x7dbl_4", bd, padding=(3, 0))
    bd = _conv_bn(p, f"{n}.branch7x7dbl_5", bd, padding=(0, 3))
    bp = _conv_bn(p, f"{n}.branch_pool", _avg_pool_3x3_same(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d(p, n, x):
    b3 = _conv_bn(p, f"{n}.branch3x3_2", _conv_bn(p, f"{n}.branch3x3_1", x), stride=2)
    b7 = _conv_bn(p, f"{n}.branch7x7x3_1", x)
    b7 = _conv_bn(p, f"{n}.branch7x7x3_2", b7, padding=(0, 3))
    b7 = _conv_bn(p, f"{n}.branch7x7x3_3", b7, padding=(3, 0))
    b7 = _conv_bn(p, f"{n}.branch7x7x3_4", b7, stride=2)
    return torch.cat([b3, b7, _max_pool(x)], dim=1)


def _inception_e(p, n, x):
    b1 = _conv_bn(p, f"{n}.branch1x1", x)
    b3 = _conv_bn(p, f"{n}.branch3x3_1", x)
    b3 = torch.cat([_conv_bn(p, f"{n}.branch3x3_2a", b3, padding=(0, 1)),
                    _conv_bn(p, f"{n}.branch3x3_2b", b3, padding=(1, 0))], dim=1)
    bd = _conv_bn(p, f"{n}.branch3x3dbl_1", x)
    bd = _conv_bn(p, f"{n}.branch3x3dbl_2", bd, padding=1)
    bd = torch.cat([_conv_bn(p, f"{n}.branch3x3dbl_3a", bd, padding=(0, 1)),
                    _conv_bn(p, f"{n}.branch3x3dbl_3b", bd, padding=(1, 0))], dim=1)
    bp = _conv_bn(p, f"{n}.branch_pool", _avg_pool_3x3_same(x))
    return torch.cat([b1, b3, bd, bp], dim=1)


# --------------------------------------------------------------------------
# full network
# --------------------------------------------------------------------------


def inception_v3_blocks(params: Params, x: torch.Tensor,
                        keep_blocks: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``x [B, 299, 299, 3]``, already ImageNet-normalized → ``(logits
    [B, 1000], {block: NHWC activation})`` (the dict empty without
    ``keep_blocks``); what the golden file pins, block by block."""
    blocks: Dict[str, torch.Tensor] = {}

    def rec(name, v):
        if keep_blocks:
            blocks[name] = v.permute(0, 2, 3, 1)
        return v

    h = x.permute(0, 3, 1, 2)
    h = rec("Conv2d_1a_3x3", _conv_bn(params, "Conv2d_1a_3x3", h, stride=2))
    h = rec("Conv2d_2a_3x3", _conv_bn(params, "Conv2d_2a_3x3", h))
    h = rec("Conv2d_2b_3x3", _conv_bn(params, "Conv2d_2b_3x3", h, padding=1))
    h = rec("maxpool1", _max_pool(h))
    h = rec("Conv2d_3b_1x1", _conv_bn(params, "Conv2d_3b_1x1", h))
    h = rec("Conv2d_4a_3x3", _conv_bn(params, "Conv2d_4a_3x3", h))
    h = rec("maxpool2", _max_pool(h))
    for n in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        h = rec(n, _inception_a(params, n, h))
    h = rec("Mixed_6a", _inception_b(params, "Mixed_6a", h))
    for n in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        h = rec(n, _inception_c(params, n, h))
    h = rec("Mixed_7a", _inception_d(params, "Mixed_7a", h))
    for n in ("Mixed_7b", "Mixed_7c"):
        h = rec(n, _inception_e(params, n, h))
    feat = h.mean(dim=(2, 3))  # adaptive average pool to 1x1
    return feat @ params["fc.weight"].T + params["fc.bias"], blocks


def inception_v3_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """``x [B, 299, 299, 3]`` already ImageNet-normalized → ``[B, 1000]``."""
    return inception_v3_blocks(params, x, keep_blocks=False)[0]


def preprocess(images: torch.Tensor, source_range: str = "[-1,1]",
               norm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """``images [B, H, W, 3]`` → ``[B, 299, 299, 3]``: to [0, 1] (from
    [-1, 1] unless ``source_range`` says otherwise), bilinear to 299, and
    ImageNet-normalized by ``norm`` (ImageNet's mean and std already on the
    images' device; made from the host constants when not given)."""
    x = images.float()
    if source_range == "[-1,1]":
        x = (x + 1.0) * 0.5
    antialias = max(x.shape[1], x.shape[2]) > SIZE
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(SIZE, SIZE), mode="bilinear",
                      align_corners=False, antialias=antialias).permute(0, 2, 3, 1)
    mean, std = norm if norm is not None else (torch.as_tensor(_MEAN, device=x.device),
                                                torch.as_tensor(_STD, device=x.device))
    return (x - mean) / std


def make_logits_fn(params: Dict[str, np.ndarray], source_range: str = "[-1,1]",
                   device="cuda"):
    """A ``logits_fn`` for :class:`rcgan_tpu_torch.evals.inception.
    InceptionScore`: takes flat ``[B, 3072]`` HWC CIFAR samples or
    ``[B, H, W, 3]`` images (numpy or tensors) → float32 logits on
    ``device``, TF32 off.  The weights and the normalization's constants
    move to ``device`` once, so that a call on a device tensor does no host
    work and can be captured in a CUDA graph (the Inception score's
    program)."""
    dev = resolve_device(device)
    float32_policy(torch.float32)
    p = {k: torch.as_tensor(np.asarray(v, np.float32)).to(dev) for k, v in params.items()}
    norm = (torch.as_tensor(_MEAN, device=dev), torch.as_tensor(_STD, device=dev))

    def logits_fn(imgs) -> torch.Tensor:
        x = torch.as_tensor(imgs if torch.is_tensor(imgs) else np.asarray(imgs, np.float32))
        x = x.to(dev, torch.float32)
        if x.dim() == 2:  # the HWC-flat CIFAR layout
            n = int(round((x.shape[-1] // 3) ** 0.5))
            x = x.reshape(-1, n, n, 3)
        with torch.no_grad():
            return inception_v3_logits(p, preprocess(x, source_range, norm))

    return logits_fn


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------


def load_weights(path: str) -> Dict[str, np.ndarray]:
    """A torchvision-named state dict from ``.npz`` or pickle, float32,
    without the aux head and the ``num_batches_tracked`` counters."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            raw = {k: data[k] for k in data.files}
    else:
        with open(path, "rb") as f:
            raw = pickle.load(f)
    return {k: np.asarray(v, np.float32) for k, v in raw.items()
            if not k.startswith("AuxLogits") and not k.endswith("num_batches_tracked")}


def find_weights(data_dir: str) -> Optional[str]:
    """``<data_dir>/inception_v3.npz`` (or ``.pkl``) where it exists."""
    for name in ("inception_v3.npz", "inception_v3.pkl"):
        p = os.path.join(data_dir, name)
        if os.path.exists(p):
            return p
    return None


def _spec_conv(d, name, cin, cout, kh, kw):
    d[f"{name}.conv.weight"] = (cout, cin, kh, kw)
    for suffix in ("bn.weight", "bn.bias", "bn.running_mean", "bn.running_var"):
        d[f"{name}.{suffix}"] = (cout,)


@functools.lru_cache(None)
def weight_spec() -> Dict[str, tuple]:
    """Every weight the graph reads, with its shape, in torchvision's
    order."""
    d: Dict[str, tuple] = {}
    _spec_conv(d, "Conv2d_1a_3x3", 3, 32, 3, 3)
    _spec_conv(d, "Conv2d_2a_3x3", 32, 32, 3, 3)
    _spec_conv(d, "Conv2d_2b_3x3", 32, 64, 3, 3)
    _spec_conv(d, "Conv2d_3b_1x1", 64, 80, 1, 1)
    _spec_conv(d, "Conv2d_4a_3x3", 80, 192, 3, 3)
    cin = 192
    for n, pool in (("Mixed_5b", 32), ("Mixed_5c", 64), ("Mixed_5d", 64)):
        _spec_conv(d, f"{n}.branch1x1", cin, 64, 1, 1)
        _spec_conv(d, f"{n}.branch5x5_1", cin, 48, 1, 1)
        _spec_conv(d, f"{n}.branch5x5_2", 48, 64, 5, 5)
        _spec_conv(d, f"{n}.branch3x3dbl_1", cin, 64, 1, 1)
        _spec_conv(d, f"{n}.branch3x3dbl_2", 64, 96, 3, 3)
        _spec_conv(d, f"{n}.branch3x3dbl_3", 96, 96, 3, 3)
        _spec_conv(d, f"{n}.branch_pool", cin, pool, 1, 1)
        cin = 64 + 64 + 96 + pool
    # Mixed_6a (B): 288 -> 384 + 96 + 288 = 768
    _spec_conv(d, "Mixed_6a.branch3x3", cin, 384, 3, 3)
    _spec_conv(d, "Mixed_6a.branch3x3dbl_1", cin, 64, 1, 1)
    _spec_conv(d, "Mixed_6a.branch3x3dbl_2", 64, 96, 3, 3)
    _spec_conv(d, "Mixed_6a.branch3x3dbl_3", 96, 96, 3, 3)
    cin = 384 + 96 + cin
    for n, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160), ("Mixed_6e", 192)):
        _spec_conv(d, f"{n}.branch1x1", cin, 192, 1, 1)
        _spec_conv(d, f"{n}.branch7x7_1", cin, c7, 1, 1)
        _spec_conv(d, f"{n}.branch7x7_2", c7, c7, 1, 7)
        _spec_conv(d, f"{n}.branch7x7_3", c7, 192, 7, 1)
        _spec_conv(d, f"{n}.branch7x7dbl_1", cin, c7, 1, 1)
        _spec_conv(d, f"{n}.branch7x7dbl_2", c7, c7, 7, 1)
        _spec_conv(d, f"{n}.branch7x7dbl_3", c7, c7, 1, 7)
        _spec_conv(d, f"{n}.branch7x7dbl_4", c7, c7, 7, 1)
        _spec_conv(d, f"{n}.branch7x7dbl_5", c7, 192, 1, 7)
        _spec_conv(d, f"{n}.branch_pool", cin, 192, 1, 1)
        cin = 192 * 4
    # Mixed_7a (D): 768 -> 320 + 192 + 768 = 1280
    _spec_conv(d, "Mixed_7a.branch3x3_1", cin, 192, 1, 1)
    _spec_conv(d, "Mixed_7a.branch3x3_2", 192, 320, 3, 3)
    _spec_conv(d, "Mixed_7a.branch7x7x3_1", cin, 192, 1, 1)
    _spec_conv(d, "Mixed_7a.branch7x7x3_2", 192, 192, 1, 7)
    _spec_conv(d, "Mixed_7a.branch7x7x3_3", 192, 192, 7, 1)
    _spec_conv(d, "Mixed_7a.branch7x7x3_4", 192, 192, 3, 3)
    cin = 320 + 192 + cin
    for n in ("Mixed_7b", "Mixed_7c"):
        _spec_conv(d, f"{n}.branch1x1", cin, 320, 1, 1)
        _spec_conv(d, f"{n}.branch3x3_1", cin, 384, 1, 1)
        _spec_conv(d, f"{n}.branch3x3_2a", 384, 384, 1, 3)
        _spec_conv(d, f"{n}.branch3x3_2b", 384, 384, 3, 1)
        _spec_conv(d, f"{n}.branch3x3dbl_1", cin, 448, 1, 1)
        _spec_conv(d, f"{n}.branch3x3dbl_2", 448, 384, 3, 3)
        _spec_conv(d, f"{n}.branch3x3dbl_3a", 384, 384, 1, 3)
        _spec_conv(d, f"{n}.branch3x3dbl_3b", 384, 384, 3, 1)
        _spec_conv(d, f"{n}.branch_pool", cin, 192, 1, 1)
        cin = 320 + 768 + 768 + 192
    d["fc.weight"] = (1000, 2048)
    d["fc.bias"] = (1000,)
    return d


def validate_weights(params: Dict[str, np.ndarray]) -> None:
    """Raise ValueError naming the first missing keys or the first
    misshapen weight."""
    spec = weight_spec()
    missing = sorted(set(spec) - set(params))
    if missing:
        raise ValueError(f"inception_v3 weights missing {len(missing)} keys, e.g. {missing[:5]}")
    for k, shape in spec.items():
        if tuple(params[k].shape) != shape:
            raise ValueError(f"inception_v3 weight {k}: expected {shape}, got {params[k].shape}")


def random_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """A shape-correct random state dict, the same arrays as the JAX
    package's ``random_weights(seed)`` (one ``RandomState`` drawn in
    :func:`weight_spec`'s order)."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, shape in weight_spec().items():
        if k.endswith("running_var"):
            out[k] = np.abs(rs.randn(*shape)).astype(np.float32) + 0.5
        elif k.endswith("bn.weight"):
            out[k] = np.ones(shape, np.float32)
        elif k.endswith(("bn.bias", "running_mean")):
            out[k] = (0.1 * rs.randn(*shape)).astype(np.float32)
        else:
            out[k] = (0.05 * rs.randn(*shape)).astype(np.float32)
    return out
