"""The FFMA conv3x3 (``csrc/conv3x3.cu``) and the cuDNN route on the CPU.

The kernel itself runs only on the card (``chip_smoke.py`` holds it against
the plain version there, at every G and D shape and every serving batch).
Here:

- its geometry: ``ffma_geometry`` fills the card (blocks times K splits at
  least the H100's 132 SMs) at every G and D shape in its class, batches
  1-100, shrinking the tile before it splits K (never at the training
  cycle's batches), and its K splits partition 9*C exactly, in whole K
  steps;
- its arithmetic: a numpy emulation of the kernel (per-tap K steps of BK
  channels, zero-filled halo rows, masked edge tiles, split-K partial sums
  added in split order) against ``conv3x3_fused`` in interpret mode;
- the ``"cudnn"`` route under ``Conv3x3Fn``'s gradients, with the CUDA
  branch forced and the route's calls recorded.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rcgan_tpu.ops.pallas.conv_kernel import conv3x3_fused
from rcgan_tpu_torch.ops.kernels import conv_kernel, runtime
from torch_parity import cuda_impls_on_cpu
from rcgan_tpu_torch.ops.kernels.conv_kernel import (FFMA_BK, FFMA_TILES, _blocks, conv3x3,
                                                     conv3x3_plain, conv3x3_variant,
                                                     ffma_geometry, ffma_k_ranges)

torch.set_num_threads(min(2, torch.get_num_threads()))

SMS = 132  # the H100 SXM's SMs
# (H=W, C, O) of the 3x3 convs of G and D at the flagship width, forwards
# and input grads, that are in the FFMA class (C and O multiples of 64)
FFMA_SHAPES = [(8, 1024, 256), (8, 256, 1024), (8, 256, 256), (16, 256, 256), (32, 256, 256),
               (32, 128, 128), (16, 128, 128), (8, 128, 128)]


def _geometries(hw, c, o):
    for b in list(range(1, 101)) + [128]:
        yield b, ffma_geometry((b, hw, hw, c), o, SMS)


# ---------------------------------------------------------------- geometry
@pytest.mark.parametrize("hw,c,o", FFMA_SHAPES)
def test_ffma_geometry_fills_the_card(hw, c, o):
    """Every batch from 1 to 100 (and 128): blocks x splits >= 132.  The
    largest square tile (128, 64, 32, 16) that alone gives a block per SM,
    unsplit; 64 x 64 split over K only where even 16 x 16 tiles are too
    few, never into more slices than K steps, and never at the training
    cycle's batches (8 and 16 in the card-vs-CPU check, 64 and 128 timed),
    where each output keeps its one in-order sum."""
    assert conv3x3_variant((1, hw, hw, c), o, torch.float32) == "ffma"
    for b, (bm, bn, splits) in _geometries(hw, c, o):
        m = b * hw * hw
        assert _blocks(m, o, bm, bn) * splits >= SMS, (b, bm, bn, splits)
        fits = [t for t in FFMA_TILES if _blocks(m, o, t, t) >= SMS]
        assert (bm, bn, splits > 1) == ((fits[0], fits[0], False) if fits else (64, 64, True)), b
        assert splits <= 9 * c // FFMA_BK[bm]
        assert splits == 1 or b not in (8, 16, 64, 128), b


@pytest.mark.parametrize("hw,c,o", FFMA_SHAPES)
def test_ffma_k_splits_partition_9c(hw, c, o):
    """The K slices of every geometry: contiguous from 0 to 9*C, none
    empty, each a whole number of K steps, and every K step inside one tap
    (BK divides C)."""
    assert c % FFMA_BK[128] == 0 and c % FFMA_BK[64] == 0
    for b, (bm, _, splits) in _geometries(hw, c, o):
        ranges = ffma_k_ranges(c, bm, splits)
        assert len(ranges) == splits
        assert ranges[0][0] == 0 and ranges[-1][1] == 9 * c, b
        assert all(r[1] == s[0] for r, s in zip(ranges, ranges[1:])), b
        assert all(e > s and s % FFMA_BK[bm] == 0 and e % FFMA_BK[bm] == 0 for s, e in ranges)


def test_ffma_geometry_edges():
    """The bucket-1 convs split K (G's 8 x 8 1024 -> 256: 4 tiles of 64 x
    64, 33 slices; D's 8 x 8 128 -> 128: 2 tiles, 66 of its 72 K steps); at
    bucket 8 the 8 x 8 convs take 16 x 16 tiles and D's 16 x 16 maps 32 x
    32, unsplit; a card with fewer SMs takes a larger tile."""
    assert ffma_geometry((1, 8, 8, 1024), 256, SMS) == (64, 64, 33)
    assert ffma_geometry((1, 8, 8, 128), 128, SMS) == (64, 64, 66)
    assert ffma_geometry((8, 8, 8, 1024), 256, SMS) == (16, 16, 1)
    assert ffma_geometry((8, 16, 16, 128), 128, SMS) == (32, 32, 1)
    assert ffma_geometry((1, 8, 8, 128), 128, 16) == (16, 16, 1)
    assert ffma_geometry((100, 32, 32, 256), 256, SMS) == (128, 128, 1)
    assert ffma_geometry((100, 8, 8, 256), 256, SMS) == (64, 64, 1)
    assert ffma_k_ranges(64, 64, 5) == [(0, 112), (112, 224), (224, 336), (336, 448), (448, 576)]
    for c, o in ((3, 128), (256, 3), (96, 128)):
        assert conv3x3_variant((1, 8, 8, c), o, torch.float32) == "cudnn"


# ---------------------------------------------------------------- arithmetic
def _emulate_ffma(x, w, bm, bn, splits):
    """The FFMA kernel's arithmetic on numpy, float32: per block (bm pixels
    x bn channels) and per split, K steps of BK channels of one tap, the A
    rows of pixels past M or off the map zero-filled, the filter rows past
    O zero-filled, a float32 product-sum into the split's slice (masked at
    the edge); then the slices added in split order."""
    b, h, wd, c = x.shape
    o = w.shape[3]
    m_all = b * h * wd
    xf, w9 = x.reshape(m_all, c), w.reshape(9 * c, o)
    bk = FFMA_BK[bm]
    pix = np.arange(m_all)
    py, px = (pix % (h * wd)) // wd, pix % wd
    ws = np.zeros((splits, m_all, o), np.float32)
    for m0 in range(0, m_all, bm):
        rows = np.arange(m0, m0 + bm)
        live = rows < m_all
        for n0 in range(0, o, bn):
            cols = np.arange(n0, n0 + bn)
            cols_ok = cols < o
            for z, (k_begin, k_end) in enumerate(ffma_k_ranges(c, bm, splits)):
                acc = np.zeros((bm, bn), np.float32)
                for k0 in range(k_begin, k_end, bk):
                    tap, c0 = divmod(k0, c)
                    dy, dx = tap // 3 - 1, tap % 3 - 1
                    ok = live.copy()
                    r = rows[live]
                    ok[live] = (py[r] + dy >= 0) & (py[r] + dy < h) & (px[r] + dx >= 0) \
                        & (px[r] + dx < wd)
                    a = np.zeros((bm, bk), np.float32)
                    a[ok] = xf[rows[ok] + dy * wd + dx, c0:c0 + bk]
                    bt = np.zeros((bk, bn), np.float32)
                    bt[:, cols_ok] = w9[k0:k0 + bk, cols[cols_ok]]
                    acc += a @ bt
                mr, nr = min(bm, m_all - m0), min(bn, o - n0)
                ws[z, m0:m0 + mr, n0:n0 + nr] = acc[:mr, :nr]
    y = ws[0].copy()
    for z in range(1, splits):
        y += ws[z]
    return y.reshape(b, h, wd, o)


@pytest.mark.parametrize("b,hw,c,o,bm,splits", [
    (1, 8, 64, 128, 64, 5),     # split K, 36 steps over 5 slices of 7 or 8
    (1, 8, 128, 128, 64, 66),   # D's bucket-1 geometry on a 132-SM card
    (1, 4, 64, 64, 64, 36),     # one K step per slice
    (2, 8, 128, 64, 64, 1),     # 64 x 64, unsplit
    (3, 6, 64, 192, 128, 1),    # 128 x 128: 108 pixels of 128, O 192 of 256
    (2, 16, 64, 128, 128, 1),   # 128 x 128, four whole tiles
    (3, 6, 64, 64, 32, 1),      # 32 x 32: 108 pixels, the last tile 12 of 32
    (1, 6, 128, 64, 16, 1),     # 16 x 16: 36 pixels, the last tile 4 of 16
])
def test_ffma_emulation_matches_pallas_conv(b, hw, c, o, bm, splits):
    """The emulated kernel against conv3x3_fused (Pallas, interpret mode),
    float32: sums of 9*C terms, split or not, in another order, so 1e-5 of
    the output's scale."""
    rs = np.random.RandomState(b * 100 + hw + c + o + splits)
    x = rs.randn(b, hw, hw, c).astype(np.float32)
    w = (rs.randn(3, 3, c, o) / np.sqrt(9 * c)).astype(np.float32)
    ref = np.asarray(conv3x3_fused(jnp.asarray(x), jnp.asarray(w)))
    got = _emulate_ffma(x, w, bm, bm, splits)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


# ---------------------------------------------------------- the cuDNN route
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cudnn_route_takes_conv3x3fn_gradients_on_cuda(monkeypatch, dtype):
    """With ``on_cuda`` mocked true, a ragged conv (3 -> 64 channels) in
    grad mode goes down the CUDA branch to the ``"cudnn"`` route, and so
    does its input grad (64 -> 3): two recorded calls, counted under the
    ``cudnn`` variant and not as kernel launches; neither kernel is called.
    The route runs its real ``F.conv2d`` (the CPU's here), and the gradients
    equal autograd of the plain version: float32 to 1e-5, bf16 to its
    output rounding (2^-7 relative)."""
    monkeypatch.setattr(runtime, "on_cuda", lambda *ts: True)
    cuda_impls_on_cpu(monkeypatch, "conv3x3")

    def refuse(x, w):
        raise AssertionError("a ragged conv reached a hand-written kernel")

    monkeypatch.setattr(conv_kernel, "_launch_wgmma", refuse)
    monkeypatch.setattr(conv_kernel, "_launch_ffma", refuse)
    calls, real = [], conv_kernel._launch_cudnn

    def record(x, w):
        calls.append((tuple(x.shape), w.shape[-1]))
        return real(x, w)

    monkeypatch.setattr(conv_kernel, "_launch_cudnn", record)
    runtime.reset_launch_counts()
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 6, 6, 3, generator=gen).to(dtype).requires_grad_(True)
    w = (torch.randn(3, 3, 3, 64, generator=gen) / 5).to(dtype).requires_grad_(True)
    r = torch.randn(2, 6, 6, 64, generator=gen).to(dtype)
    out = conv3x3(x, w)
    assert out.dtype == dtype and out.shape == (2, 6, 6, 64)
    torch.sum(out.float() * r.float()).backward()
    assert calls == [((2, 6, 6, 3), 64), ((2, 6, 6, 64), 3)]
    assert runtime.variant_counts("conv3x3") == {"wgmma": 0, "ffma": 0, "cudnn": 2}
    assert runtime.launch_counts()["conv3x3"] == 0
    got = (x.grad.float(), w.grad.float())
    xr, wr = (t.detach().float().requires_grad_(True) for t in (x, w))
    torch.sum(conv3x3_plain(xr, wr) * r.float()).backward()
    rtol, atol = (1e-5, 1e-6) if dtype == torch.float32 else (2.0 ** -7, 2e-2)
    for g, want in zip(got, (xr.grad, wr.grad)):
        torch.testing.assert_close(g, want, rtol=rtol, atol=atol * want.abs().max().item())
