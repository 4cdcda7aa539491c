"""The tensor-core conv3x3 (``csrc/conv3x3_wgmma.cu``) on the CPU: the
three-way route table, a numpy emulation of its addressing against the
Pallas kernel, and its wrapper with the launch mocked.

The kernel itself runs only on the card (``chip_smoke.py`` holds it against
the plain version there).  Here:

- the route: which route (the two kernels, or cuDNN for ragged channel
  counts) every conv of the training cycle and of ``entry()`` takes, and the
  totals per cycle, read from a real cycle at dim 64 whose conv calls are
  recorded instead of run;
- the addressing: per-tap TMA boxes with zero fill (negative coordinates
  included), K chunks of 64, BM tiles at 8x8, 16x16 and 32x32, against
  ``conv3x3_fused`` run in interpret mode as tests/test_pallas.py runs it;
- the wrapper: the arguments that reach the library, errors that propagate
  with no fallback, and the per-variant launch counters.
"""

import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rcgan_tpu.ops.pallas.conv_kernel import conv3x3_fused
from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
from rcgan_tpu_torch.data.confusion import build_confusion
from rcgan_tpu_torch.entry import entry
from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
from rcgan_tpu_torch.ops.kernels import conv_kernel, runtime
from rcgan_tpu_torch.ops.kernels.conv_kernel import (_box, conv3x3, conv3x3_variant,
                                                     wgmma_geometry)
from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer
from torch_parity import cuda_impls_on_cpu

torch.set_num_threads(min(2, torch.get_num_threads()))

# (H=W, C, O) of every 3x3 conv of G and of D at the flagship width, as
# chip_smoke.py lists them
G_SHAPES = [(8, 1024, 256), (8, 256, 256), (16, 256, 256), (16, 256, 256),
            (32, 256, 256), (32, 256, 256), (32, 256, 3)]
D_SHAPES = [(32, 3, 128), (32, 128, 128), (16, 128, 128), (16, 128, 128)] + [(8, 128, 128)] * 8


def _want_variant(c, o, dtype):
    if 3 in (c, o):
        return "cudnn"
    return "wgmma" if dtype == torch.bfloat16 else "ffma"


# ------------------------------------------------------------- route table
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_table_covers_every_cycle_and_entry_shape(dtype):
    """Forward (C -> O) and input grad (O -> C) of every G and D conv at
    batch 64 and 128: C or O = 3 goes to cuDNN in either dtype; otherwise
    bf16 goes to the tensor cores and float32 to FFMA.  The tensor-core calls take a 128 x 256 tile
    where O is a multiple of 256 and that gives at least 99 blocks (three
    quarters of the H100's 132 SMs), else BM = 64 exactly where 128 x 128
    would leave fewer than 132 blocks; their box covers BM pixels of whole
    rows or whole images."""
    for hw, c, o in set(G_SHAPES + D_SHAPES):
        for b in (64, 128):
            for cin, cout in ((c, o), (o, c)):
                shape = (b, hw, hw, cin)
                v = conv3x3_variant(shape, cout, dtype)
                assert v == _want_variant(cin, cout, dtype), (shape, cout, dtype)
                if v != "wgmma":
                    continue
                bm, bn, rows, imgs = wgmma_geometry(shape, cout, 132)
                m = b * hw * hw
                if cout % 256 == 0 and m // 128 * (cout // 256) >= 99:
                    assert (bm, bn) == (128, 256), (shape, cout)
                else:
                    assert (bm, bn) == ((64 if m // 128 * (cout // 128) < 132 else 128), 128)
                assert imgs * rows * hw == bm
                assert rows == hw if imgs > 1 else hw % rows == 0


def test_route_rule_edges():
    """C or O not a multiple of 64 goes to cuDNN in either dtype; bf16 maps
    that do not tile by 128 pixels (W not dividing 128, or H*W neither
    dividing nor divided by 128) go to FFMA; a map smaller than the tile
    takes whole images."""
    bf = torch.bfloat16
    assert conv3x3_variant((2, 8, 8, 96), 128, bf) == "cudnn"
    assert conv3x3_variant((2, 8, 8, 128), 96, bf) == "cudnn"
    assert conv3x3_variant((2, 8, 8, 96), 128, torch.float32) == "cudnn"
    assert conv3x3_variant((2, 8, 8, 128), 192, torch.float32) == "ffma"
    assert conv3x3_variant((2, 12, 12, 128), 128, bf) == "ffma"  # 144 px
    assert conv3x3_variant((2, 32, 12, 128), 128, bf) == "ffma"  # 384 px, W 12
    assert conv3x3_variant((2, 4, 4, 64), 64, bf) == "wgmma"
    assert _box(4, 4, 128) == (4, 8) and _box(4, 32, 128) == (4, 1)
    assert _box(3, 64, 128) is None and _box(64, 256, 128) is None  # 192 px; W > BM
    assert wgmma_geometry((1, 4, 4, 64), 64, 132) == (64, 128, 4, 4)
    assert wgmma_geometry((64, 32, 32, 256), 256, 132) == (128, 256, 4, 1)
    assert wgmma_geometry((64, 8, 8, 1024), 256, 132) == (64, 128, 8, 1)  # 32 blocks at 128 x 256
    # 128 blocks of 128 x 128: under a wave on 132 SMs, over one on 114
    assert wgmma_geometry((64, 16, 16, 128), 128, 132) == (64, 128, 4, 1)
    assert wgmma_geometry((64, 16, 16, 128), 128, 114) == (128, 128, 8, 1)


def _recording_route(monkeypatch):
    """Makes ``conv3x3`` take its CUDA implementation on CPU tensors and replaces the
    three routes by recorders that compute the plain version; returns the
    list of ``(variant, x shape, O)`` they see."""
    seen = []
    proxy = types.SimpleNamespace(**{k: getattr(runtime, k) for k in dir(runtime)
                                     if not k.startswith("__")})
    proxy.on_cuda = lambda *ts: True
    monkeypatch.setattr(conv_kernel, "runtime", proxy)
    cuda_impls_on_cpu(monkeypatch, "conv3x3")

    def recorder(variant):
        def launch(x, w):
            seen.append((variant, tuple(x.shape), w.shape[-1]))
            return conv_kernel.conv3x3_plain(x, w)
        return launch

    monkeypatch.setattr(conv_kernel, "_launch_wgmma", recorder("wgmma"))
    monkeypatch.setattr(conv_kernel, "_launch_ffma", recorder("ffma"))
    monkeypatch.setattr(conv_kernel, "_launch_cudnn", recorder("cudnn"))
    return seen


def _split(seen):
    return {v: sum(s[0] == v for s in seen) for v in ("wgmma", "ffma", "cudnn")}


# dim 64 keeps every C and O of the flagship's routes (multiples of 64, the
# 3-channel ends) at a quarter of its width
DIM64 = dict(dim_g=64, dim_d=64, embedding_dim=24)


@pytest.mark.parametrize("algorithm,want", [
    ("rcgan", {"wgmma": 174, "ffma": 0, "cudnn": 14}),
    ("rcgan-u", {"wgmma": 284, "ffma": 0, "cudnn": 19})])
def test_cycle_routes_174_14(monkeypatch, algorithm, want):
    """One full training cycle (a G step, five critic steps) in bf16 sends
    174 convs to the tensor cores, none to FFMA and 14 to cuDNN for rcgan
    (D's first conv and G's output conv, forwards and input grads), 284, 0
    and 19 for rcgan-u with the perm classifier: the totals chip_smoke.py
    asserts on the card."""
    seen = _recording_route(monkeypatch)
    perm = algorithm == "rcgan-u"
    acfg = CifarAlgoConfig(algorithm=algorithm, perm_classifier=perm, confuse_init=perm)
    tr = CifarTrainer(ResnetGANConfig(**DIM64, algorithm=algorithm), acfg, CifarTrainConfig(),
                      build_confusion(0.6)[0], "cpu", torch.bfloat16)
    ts = tr.init(seed=0)
    rs = np.random.RandomState(0)
    n, b = 5, 2
    d = {"images": rs.randint(0, 256, (n, b, 3072)).astype(np.uint8),
         "labels": rs.randint(0, 10, (n, b)), "labels_random": rs.randint(0, 10, (n, b)),
         "labels_biased": rs.randint(0, 10, (n, b)),
         "labels_inv_weights": rs.uniform(-0.5, 1.5, (n, b, 10)).astype(np.float32)}
    g = {"random": rs.randint(0, 10, 2 * b), "biased": rs.randint(0, 10, 2 * b)}
    tr.step(ts, d, g, 1, seed=0)
    assert _split(seen) == want
    assert all(v == _want_variant(x[3], o, torch.bfloat16) for v, x, o in seen)


def test_entry_routes_17_2(monkeypatch):
    """``entry()`` in bf16: G's seven convs and D's twelve, all but G's
    output conv and D's first (on cuDNN) on the tensor cores."""
    seen = _recording_route(monkeypatch)
    fwd, (z, labels) = entry("cpu", torch.bfloat16, cfg=ResnetGANConfig(**DIM64), batch=2)
    fwd(z, labels)
    assert _split(seen) == {"wgmma": 17, "ffma": 0, "cudnn": 2}


# -------------------------------------------------------------- addressing
def _tma_box(a, origin, box):
    """A TMA tiled load: the box of ``a`` (dims listed innermost first, as
    the tensor map lists them) at ``origin``, coordinates outside the
    tensor, negative ones included, filled with zeros."""
    nd = a.ndim
    out = np.zeros(box[::-1], a.dtype)
    src, dst = [], []
    for axis in range(nd):  # axis 0 is the innermost
        o, n, size = origin[axis], box[axis], a.shape[nd - 1 - axis]
        lo, hi = max(o, 0), min(o + n, size)
        if lo >= hi:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - o, hi - o))
    out[tuple(dst[::-1])] = a[tuple(src[::-1])]
    return out


def _emulate(x, w, bm, bn):
    """The wgmma kernel's arithmetic on numpy: per block (BM pixels x BN
    channels) and per K step (one tap x 64 channels), an x box at origin
    (c0, dx-1, y0+dy-1, b0) as a [BM, 64] tile, BN/64 [64 k x 64 n] filter
    boxes of w seen as [9C, O], a float32 product-sum; masked stores."""
    b, h, wd, c = x.shape
    o = w.shape[3]
    rows, imgs = _box(h, wd, bm)
    m = b * h * wd
    w9 = w.reshape(9 * c, o)
    y = np.zeros((m, o), np.float32)
    for m0 in range(0, m, bm):
        b0, y0 = m0 // (h * wd), (m0 % (h * wd)) // wd
        for n0 in range(0, o, bn):
            acc = np.zeros((bm, bn), np.float32)
            for k in range(9 * c // 64):
                tap, c0 = divmod(k, c // 64)
                dy, dx = divmod(tap, 3)
                a = _tma_box(x, (c0 * 64, dx - 1, y0 + dy - 1, b0), (64, wd, rows, imgs))
                bt = np.concatenate([_tma_box(w9, (n0 + n, tap * c + c0 * 64), (64, 64))
                                     for n in range(0, bn, 64)], axis=1)
                acc += a.reshape(bm, 64) @ bt
            mr, nr = min(bm, m - m0), min(bn, o - n0)
            y[m0:m0 + mr, n0:n0 + nr] = acc[:mr, :nr]
    return y.reshape(b, h, wd, o)


@pytest.mark.parametrize("bm,bn", [(64, 128), (128, 128), (128, 256)])
@pytest.mark.parametrize("b,hw", [(3, 8), (2, 16), (1, 32)])
def test_addressing_emulation_matches_pallas_conv(b, hw, bm, bn):
    """The emulated kernel against conv3x3_fused (Pallas, interpret mode),
    float32, C 128 (two K chunks a tap), O 192 (the last N block partly
    empty); at 8x8 an odd batch leaves the last BM = 128 tile half past the
    end.  Sums of 9*128 terms in another order: 1e-5 of the scale."""
    rs = np.random.RandomState(hw + bm + bn)
    x = rs.randn(b, hw, hw, 128).astype(np.float32)
    w = (rs.randn(3, 3, 128, 192) / np.sqrt(9 * 128)).astype(np.float32)
    ref = np.asarray(conv3x3_fused(jnp.asarray(x), jnp.asarray(w)))
    got = _emulate(x, w, bm, bn)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_tma_box_fills_out_of_bounds_with_zeros():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)  # dims (4, 3) innermost first
    box = _tma_box(a, (-1, -1), (3, 2))
    np.testing.assert_array_equal(box, [[0, 0, 0], [0, 0, 1]])
    assert not _tma_box(a, (4, 0), (2, 2)).any()


# ----------------------------------------------------------------- wrapper
class _FakeFn:
    def __init__(self, code=0):
        self.argtypes = self.restype = None
        self.calls, self.code = [], code

    def __call__(self, *args):
        self.calls.append(args)
        return self.code


def _fake_libs(monkeypatch, wgmma_code=0, sms=132):
    libs = {"conv3x3": types.SimpleNamespace(conv3x3_ffma_f32=_FakeFn(), conv3x3_ffma_bf16=_FakeFn(),
                                             conv3x3_error_string=_FakeFn()),
            "conv3x3_wgmma": types.SimpleNamespace(conv3x3_wgmma_bf16=_FakeFn(wgmma_code),
                                                   conv3x3_wgmma_error_string=_FakeFn())}
    libs["conv3x3_wgmma"].conv3x3_wgmma_error_string.code = b"an illegal memory access"
    monkeypatch.setattr(runtime, "on_cuda", lambda *ts: True)
    monkeypatch.setattr(runtime, "cuda_library", lambda name: libs[name])
    monkeypatch.setattr(runtime, "sm_count", lambda t: sms)
    monkeypatch.setattr(runtime, "on_device", lambda t, fn, *args: fn(*args, 7))  # stream 7
    cuda_impls_on_cpu(monkeypatch, "conv3x3")
    return libs


def test_wrapper_passes_the_geometry_and_counts_per_variant(monkeypatch):
    """A qualifying bf16 call reaches the tensor-core entry point with the
    pointers, shape, BM and box it computed, and the stream; a float32 call
    and a bf16 call whose map does not tile by 128 pixels reach the FFMA
    entry points, and a ragged bf16 call goes to cuDNN (here the CPU's
    conv).  Each kernel launch counts once under conv3x3 and once under its
    variant; the cuDNN call under its variant only."""
    libs = _fake_libs(monkeypatch)
    runtime.reset_launch_counts()
    x = torch.randn(2, 8, 8, 128).bfloat16()
    w = torch.randn(3, 3, 128, 256).bfloat16()
    y = conv3x3(x, w)
    assert y.shape == (2, 8, 8, 256) and y.dtype == torch.bfloat16
    (args,) = libs["conv3x3_wgmma"].conv3x3_wgmma_bf16.calls
    assert args[:2] == (x.data_ptr(), w.data_ptr()) and args[2] == y.data_ptr()
    assert args[3:] == (2, 8, 8, 128, 256, 64, 128, 8, 1, 7)
    assert libs["conv3x3_wgmma"].conv3x3_wgmma_bf16.argtypes is not None
    conv3x3(x.float(), w.float())
    conv3x3(torch.randn(2, 12, 12, 128).bfloat16(), torch.randn(3, 3, 128, 64).bfloat16())
    xr, wr = torch.randn(2, 8, 8, 3).bfloat16(), torch.randn(3, 3, 3, 128).bfloat16()
    yr = conv3x3(xr, wr)
    assert len(libs["conv3x3"].conv3x3_ffma_f32.calls) == 1
    # 288 pixels x 64 channels: 5 tiles of 64 x 64, so K splits 27 ways
    # (into a float32 workspace) to fill 132 SMs
    (args,) = libs["conv3x3"].conv3x3_ffma_bf16.calls
    assert isinstance(args[3], int) and args[4:] == (2, 12, 12, 128, 64, 64, 64, 27, 7)
    assert yr.dtype == torch.bfloat16 and yr.is_contiguous()
    torch.testing.assert_close(yr, conv_kernel.conv3x3_plain(xr, wr), rtol=2.0 ** -7, atol=1e-2)
    assert runtime.launch_counts()["conv3x3"] == 3
    assert runtime.variant_counts("conv3x3") == {"wgmma": 1, "ffma": 2, "cudnn": 1}
    runtime.reset_launch_counts()
    assert runtime.variant_counts("conv3x3") == {"wgmma": 0, "ffma": 0, "cudnn": 0}
    with pytest.raises(ValueError, match="variant"):
        runtime.count_launch("conv3x3")


def test_wrapper_tiles_by_the_cards_sm_count(monkeypatch):
    """The tile follows the SM count of the card the input lies on: 128
    blocks of 128 x 128 fill a wave of 114 SMs but not of 132, where the
    64 x 128 tile is taken."""
    x = torch.randn(64, 16, 16, 128).bfloat16()
    w = torch.randn(3, 3, 128, 128).bfloat16()
    for sms, tile in ((132, (64, 128, 4, 1)), (114, (128, 128, 8, 1))):
        libs = _fake_libs(monkeypatch, sms=sms)
        conv3x3(x, w)
        (args,) = libs["conv3x3_wgmma"].conv3x3_wgmma_bf16.calls
        assert args[8:12] == tile, sms


def test_wrapper_takes_more_m_tiles_than_a_grid_row(monkeypatch):
    """B*H*W past 65535 tiles of 128 pixels, the most a grid's y dimension
    holds (the kernel puts M tiles on x, which holds 2^31 - 1): the call is
    in the tensor-core class and reaches its entry point whole.  Meta
    tensors carry the shapes without the 1 GB of data."""
    libs = _fake_libs(monkeypatch)
    x = torch.empty(8200, 32, 32, 64, dtype=torch.bfloat16, device="meta")
    w = torch.empty(3, 3, 64, 64, dtype=torch.bfloat16, device="meta")
    assert conv3x3_variant(x.shape, 64, torch.bfloat16) == "wgmma"
    y = conv3x3(x, w)
    assert y.shape == (8200, 32, 32, 64)
    (args,) = libs["conv3x3_wgmma"].conv3x3_wgmma_bf16.calls
    assert args[3:] == (8200, 32, 32, 64, 64, 128, 128, 4, 1, 7)
    assert -(-8200 * 32 * 32 // 128) == 65600 > 65535


def test_tensor_core_failure_raises_with_no_fallback(monkeypatch):
    """A launch error of the tensor-core kernel, a failing build (the
    launcher raising) and a misaligned input all propagate: the FFMA kernel
    and the plain version are never called, and nothing is counted."""
    libs = _fake_libs(monkeypatch, wgmma_code=700)

    def refuse(*a, **k):
        raise AssertionError("fell back")

    monkeypatch.setattr(conv_kernel, "conv3x3_plain", refuse)
    runtime.reset_launch_counts()
    x = torch.randn(2, 16, 16, 64).bfloat16()
    w = torch.randn(3, 3, 64, 64).bfloat16()
    with pytest.raises(RuntimeError, match="illegal memory access"):
        conv3x3(x, w)
    base = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        conv3x3(base[1:].view(x.shape), w)

    def broken_build(name):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(runtime, "cuda_library", broken_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        conv3x3(x, w)
    assert not any(f.calls for f in vars(libs["conv3x3"]).values())
    assert runtime.launch_counts()["conv3x3"] == 0
