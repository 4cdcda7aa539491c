"""The 2x2 mean pool and the nearest upsample (``ops/kernels/resample_kernel.py``)
on the CPU:

- ``mean_pool`` and ``upsample_depth_to_space`` bit-equal to the plain
  forms they replaced (four strided slices added in JAX's order and divided
  by 4; a channel concat x4 and depth_to_space), in float32 and bf16, and
  to the JAX functions;
- the ops' gradients against autograd of the replaced forms, with x also
  feeding a second consumer taken before or after the op: the pool's
  value-equal (each input gets one term, g/4), the upsample's bit-equal
  (autograd adds its four phases in the concat's order, around the other
  gradient), where a 2x2 sum of the phases would not be in bf16; the
  upsample of four distinct maps and their gradients;
- ``gradcheck`` and ``gradgradcheck`` in float64, ``opcheck`` of both ops;
- a DTensor batch shard on two gloo ranks against the whole tensor, forward
  and backward;
- the CUDA wrappers, reached with ``runtime.on_cuda`` mocked true, against a
  numpy emulation of the kernels that reads and writes through the
  pointers the wrapper passes (the kernels' index arithmetic, 16-byte and
  scalar paths, bf16 rounding after each add): bit-equal to the plain
  forms, one count a launch, the raises, no fallback.

Rank functions are module-level and this module imports JAX only inside a
test function (a spawned rank imports this module).
"""

import ctypes

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from rcgan_tpu_torch.ops.conv import mean_pool, upsample_depth_to_space
from rcgan_tpu_torch.ops.kernels import resample_kernel as rk
from rcgan_tpu_torch.ops.kernels import runtime
from rcgan_tpu_torch.parallel import launch
from torch_parity import cuda_impls_on_cpu

torch.set_num_threads(min(2, torch.get_num_threads()))

DTYPES = (torch.float32, torch.bfloat16)
# [B, H, W, C] of the larger map: ragged and 3-channel maps, 16-byte rows in
# both dtypes, one image, a map one pixel wide after pooling
SHAPES = ((2, 4, 6, 3), (3, 8, 8, 16), (1, 2, 2, 8), (2, 6, 2, 12), (4, 16, 8, 64))
CASES = [(dt, s) for dt in DTYPES for s in SHAPES]


def _ids(case):
    dt, s = case
    return f"{str(dt).split('.')[-1]}-{'x'.join(map(str, s))}"


def old_mean_pool(x):
    """The form ``mean_pool`` replaced, as it stood in ``ops/conv.py``."""
    return (x[:, ::2, ::2, :] + x[:, 1::2, ::2, :] + x[:, ::2, 1::2, :]
            + x[:, 1::2, 1::2, :]) / 4.0


def old_upsample(x, *others):
    """The form ``upsample_depth_to_space`` replaced; with three more maps,
    its concat of four distinct maps."""
    b, h, w, c = x.shape
    y = torch.cat([x, *others] if others else [x, x, x, x], dim=3)
    y = y.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, h * 2, w * 2, c)


def _draw(shape, dtype, seed):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed)).to(dtype)


def _bits(t):
    """``t``'s bit patterns (zeros of either sign told apart)."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _small(shape):
    b, h, w, c = shape
    return (b, h // 2, w // 2, c)


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_forward_bit_equal_to_the_replaced_forms(case):
    dtype, shape = case
    x = _draw(shape, dtype, 1)
    assert torch.equal(_bits(mean_pool(x)), _bits(old_mean_pool(x)))
    assert torch.equal(_bits(rk.mean_pool_plain(x)), _bits(old_mean_pool(x)))
    small = _draw(_small(shape), dtype, 2)
    assert torch.equal(_bits(upsample_depth_to_space(small)), _bits(old_upsample(small)))
    assert torch.equal(_bits(rk.upsample_plain(small, small, small, small)),
                       _bits(old_upsample(small)))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_forward_matches_jax(dtype):
    """Both ops against JAX's ``mean_pool`` and ``upsample_depth_to_space``
    on the same values, bit for bit."""
    import jax.numpy as jnp
    from rcgan_tpu.ops import conv as jconv

    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    x = _draw((2, 8, 6, 16), dtype, 3)
    xj = jnp.asarray(x.float().numpy()).astype(jdt)
    for got, want in ((mean_pool(x), jconv.mean_pool(xj)),
                      (upsample_depth_to_space(x), jconv.upsample_depth_to_space(xj))):
        assert torch.equal(got.float(), torch.from_numpy(np.asarray(want.astype(jnp.float32))))


def test_ops_refuse_odd_maps_other_ranks_and_unlike_maps():
    with pytest.raises(ValueError, match="H and W even"):
        mean_pool(torch.zeros(1, 3, 4, 2))
    with pytest.raises(ValueError, match=r"four maps \[B, H, W, C\]"):
        upsample_depth_to_space(torch.zeros(3, 4, 2))
    z = torch.zeros(1, 2, 2, 3)
    with pytest.raises(ValueError, match="four maps"):
        rk.upsample2x_op(z, z, z, z.double(), 1.0)


# --------------------------------------------------------------- backward
def _grads_with_a_second_consumer(op, x0, other, g, first):
    """x's gradient where it feeds ``op`` and a product with ``other``,
    the product taken before the op (``first``) or after it."""
    x = x0.clone().requires_grad_()
    outs = (x * other, op(x)) if first else (op(x), x * other)
    cots = (torch.ones_like(other), g) if first else (g, torch.ones_like(other))
    return torch.autograd.grad(outs, x, cots)[0]


@pytest.mark.parametrize("first", [True, False], ids=["product-first", "op-first"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_pool_gradient_value_equal_with_a_second_consumer(case, first):
    """Values: a zero's sign may differ (autograd of the replaced form adds
    zeros of the other three phases)."""
    dtype, shape = case
    x0, other = _draw(shape, dtype, 4), _draw(shape, dtype, 5)
    g = _draw(_small(shape), dtype, 6)
    assert torch.equal(_grads_with_a_second_consumer(mean_pool, x0, other, g, first),
                       _grads_with_a_second_consumer(old_mean_pool, x0, other, g, first))


@pytest.mark.parametrize("first", [True, False], ids=["product-first", "op-first"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_upsample_gradient_bit_equal_with_a_second_consumer(case, first):
    dtype, shape = case
    x0, other = _draw(_small(shape), dtype, 7), _draw(_small(shape), dtype, 8)
    g = _draw(shape, dtype, 9)
    assert torch.equal(
        _bits(_grads_with_a_second_consumer(upsample_depth_to_space, x0, other, g, first)),
        _bits(_grads_with_a_second_consumer(old_upsample, x0, other, g, first)))


def test_a_summed_upsample_gradient_would_differ():
    """The order is the point in bf16: the other gradient plus the 2x2 sum
    of the phases (one kernel's result) differs from autograd's phase by
    phase accumulation, which the op keeps."""
    x0, other = _draw((8, 16, 16, 64), torch.bfloat16, 10), _draw((8, 16, 16, 64),
                                                                    torch.bfloat16, 11)
    g = _draw((8, 32, 32, 64), torch.bfloat16, 12)
    want = _grads_with_a_second_consumer(old_upsample, x0, other, g, False)
    summed = other + (g[:, ::2, ::2] + g[:, ::2, 1::2] + g[:, 1::2, ::2] + g[:, 1::2, 1::2])
    assert not torch.equal(_bits(summed), _bits(want))
    assert torch.equal(_bits(_grads_with_a_second_consumer(upsample_depth_to_space, x0, other,
                                                           g, False)), _bits(want))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_four_maps_and_their_gradients(dtype):
    """The upsample op interleaves four distinct maps, phase (a, b) from map
    ab, and hands each map its phase of the cotangent."""
    maps = [_draw((2, 3, 4, 8), dtype, 20 + i).requires_grad_() for i in range(4)]
    out = rk.upsample2x_op(*maps, 1.0)
    assert torch.equal(_bits(out), _bits(rk.upsample_plain(*maps)))
    for (a, b), m in zip(((0, 0), (0, 1), (1, 0), (1, 1)), maps):
        assert torch.equal(out[:, a::2, b::2], m)
    g = _draw((2, 6, 8, 8), dtype, 24)
    grads = torch.autograd.grad(out, maps, g)
    want = torch.autograd.grad(rk.upsample_plain(*maps), maps, g)
    assert all(torch.equal(_bits(a_), _bits(b_)) for a_, b_ in zip(grads, want))


@pytest.mark.parametrize("fn", [mean_pool, upsample_depth_to_space,
                                lambda *m: rk.upsample2x_op(*m, 0.25)],
                         ids=["mean_pool", "upsample", "four-maps-at-a-quarter"])
def test_gradcheck_float64(fn):
    n = 4 if fn not in (mean_pool, upsample_depth_to_space) else 1
    xs = tuple(_draw((2, 4, 6, 3), torch.float64, 13 + i).requires_grad_() for i in range(n))
    assert torch.autograd.gradcheck(fn, xs)
    assert torch.autograd.gradgradcheck(fn, xs)


@pytest.mark.parametrize("op", ["mean_pool", "upsample2x"])
def test_opcheck(op):
    """Schema, fake implementation, autograd registration and AOT dispatch
    of each op; the upsample on one map four times and on four maps, at
    both scales it is called with."""
    x = _draw((2, 4, 6, 8), torch.float32, 17).requires_grad_()
    if op == "mean_pool":
        torch.library.opcheck(rk.mean_pool_op, (x,))
    else:
        maps = [_draw((2, 4, 6, 8), torch.float32, 18 + i).requires_grad_() for i in range(4)]
        for args in ((x, x, x, x, 1.0), (x, x, x, x, 0.25), (*maps, 1.0)):
            torch.library.opcheck(rk.upsample2x_op, args)


def test_nothing_counted_on_the_cpu():
    runtime.reset_launch_counts()
    x = _draw((2, 4, 4, 8), torch.bfloat16, 12).requires_grad_()
    (mean_pool(upsample_depth_to_space(x)) * 3).sum().backward()
    assert x.grad is not None
    assert runtime.launch_counts() == dict.fromkeys(runtime.KERNELS, 0)


# ---------------------------------------------------------------- DTensor
def _dtensor_rank(group):
    """On a 1-D mesh of the ranks: both ops and their gradients on a batch
    shard of x, against the whole tensor; rank 0 returns the results."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (group.world_size,))
    out = {}
    for name, fn, shape in (("mean_pool", mean_pool, (4, 8, 6, 16)),
                            ("upsample", upsample_depth_to_space, (4, 4, 3, 16))):
        for dtype in DTYPES:
            x = _draw(shape, dtype, 13)
            whole = x.clone().requires_grad_()
            want = fn(whole)
            g = _draw(want.shape, dtype, 14)
            want.backward(g)
            shard = distribute_tensor(x.clone(), mesh, [Shard(0)]).requires_grad_()
            got = fn(shard)
            got.backward(distribute_tensor(g, mesh, [Shard(0)]))
            out[(name, str(dtype))] = (tuple(got.placements), got.full_tensor(), want.detach(),
                                       shard.grad.full_tensor(), whole.grad)
    x = _draw((4, 8, 6, 16), torch.float32, 15)
    got = mean_pool(distribute_tensor(x, mesh, [Replicate()]))
    out["replicated"] = (tuple(got.placements), got.full_tensor(), mean_pool(x))
    return out if group.rank == 0 else None


@pytest.fixture(scope="module")
def dtensor_results():
    return launch(_dtensor_rank, 2, backend="gloo", timeout=300.0)[0]


@pytest.mark.parametrize("op", ["mean_pool", "upsample"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_dtensor_batch_shard_equals_the_whole(dtensor_results, op, dtype):
    placements, got, want, grad, want_grad = dtensor_results[(op, str(dtype))]
    assert placements == (Shard(0),)
    assert torch.equal(_bits(got), _bits(want)) and torch.equal(grad, want_grad)


def test_dtensor_replicated_rule(dtensor_results):
    placements, got, want = dtensor_results["replicated"]
    assert placements == (Replicate(),) and torch.equal(got, want)


# ------------------------------------------------- the wrappers, emulated
def _widen(a):
    return (a.astype(np.uint32) << 16).view(np.float32) if a.dtype == np.uint16 else a


def _narrow(f, bf16):
    if not bf16:
        return f.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(f, np.float32)).to(torch.bfloat16).view(
        torch.int16).numpy().view(np.uint16)


def _at(ptr, n, bf16):
    ctype = ctypes.c_uint16 if bf16 else ctypes.c_float
    return np.ctypeslib.as_array((ctype * n).from_address(ptr))


def _geometry(ptrs, bf16, rows, c):
    """The kernels' vector width (16 bytes where C x itemsize and every
    pointer allow it), vectors a row, and each item's (row, vector)."""
    size = 2 if bf16 else 4
    vec = 16 // size if (c * size) % 16 == 0 and all(p % 16 == 0 for p in ptrs) else 1
    vecs = c // vec
    i = np.arange(rows * vecs)
    return vec, i // vecs, i % vecs


class _Entry:
    """A C entry point as ctypes shows it: ``argtypes`` and ``restype`` for
    the wrapper to set."""

    def __init__(self, fn):
        self.fn, self.argtypes, self.restype = fn, None, None

    def __call__(self, *args):
        return self.fn(*args)


class _EmulatedLibrary:
    """``csrc/resample.cu``'s entry points in numpy, reading and writing
    through the pointers they are given, by the kernels' own index
    arithmetic; each call is recorded, with its vector width."""

    def __init__(self):
        self.calls, self.vecs = [], []
        self.resample_pool2x2 = _Entry(self._pool)
        self.resample_up2x2 = _Entry(self._up)

    @staticmethod
    def resample_error_string(code):
        return b"an illegal memory access was encountered"

    def _pool(self, x_ptr, out_ptr, bf16, rows, w2, c, sms, stream):
        self.calls.append(("pool2x2", bf16, rows, w2, c, sms, stream))
        x, out = _at(x_ptr, 4 * rows * c, bf16), _at(out_ptr, rows * c, bf16)
        vec, r, k = _geometry((x_ptr, out_ptr), bf16, rows, c)
        self.vecs.append(vec)
        q, j = r // w2, r % w2
        row_in = 2 * w2 * c
        base = (2 * q * row_in + 2 * j * c + k * vec)[:, None] + np.arange(vec)
        s = _widen(x[base])
        for off in (row_in, c, row_in + c):  # phases (1,0), (0,1), (1,1)
            s = _widen(_narrow(s + _widen(x[base + off]), bf16))
        out[(r * c + k * vec)[:, None] + np.arange(vec)] = _narrow(s * np.float32(0.25), bf16)
        return 0

    def _up(self, p00, p01, p10, p11, out_ptr, bf16, rows, w, c, scale, sms, stream):
        ptrs = (p00, p01, p10, p11)
        self.calls.append(("up2x2", bf16, rows, w, c, scale, len(set(ptrs)), sms, stream))
        out = _at(out_ptr, 4 * rows * c, bf16)
        vec, r, k = _geometry((*ptrs, out_ptr), bf16, rows, c)
        self.vecs.append(vec)
        q, j = r // w, r % w
        row_out = 2 * w * c
        src = (r * c + k * vec)[:, None] + np.arange(vec)
        base = (2 * q * row_out + 2 * j * c + k * vec)[:, None] + np.arange(vec)
        for p, off in zip(ptrs, (0, c, row_out, row_out + c)):
            v = _at(p, rows * c, bf16)[src]
            out[base + off] = v if scale == 1.0 else _narrow(_widen(v) * np.float32(scale), bf16)
        return 0


@pytest.fixture
def emulated(monkeypatch):
    """The ops' CUDA implementations on CPU tensors over the emulated library
    (stream 7, 132 SMs), the plain versions refused."""
    monkeypatch.setattr(runtime, "on_cuda", lambda *ts: True)
    monkeypatch.setattr(runtime, "on_device", lambda t, f, *args: f(*args, 7))
    monkeypatch.setattr(runtime, "sm_count", lambda t: 132)
    cuda_impls_on_cpu(monkeypatch, "mean_pool", "upsample2x")
    lib = _EmulatedLibrary()
    monkeypatch.setattr(runtime, "cuda_library", lambda name: {"resample": lib}[name])
    refuse = lambda *a, **k: (_ for _ in ()).throw(AssertionError("fell back"))  # noqa: E731
    monkeypatch.setattr(rk, "mean_pool_plain", refuse)
    monkeypatch.setattr(rk, "upsample_plain", refuse)
    runtime.reset_launch_counts()
    return lib


def _misaligned(t):
    """``t``'s values in a contiguous tensor that starts one element past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_wrappers_against_the_emulated_kernels(emulated, case, aligned):
    """Forward and backward of both ops through the CUDA wrappers: each
    launch's arguments, one count a launch, and the results bit-equal to
    the replaced forms (the pool's gradient value-equal)."""
    dtype, shape = case
    place = (lambda t: t) if aligned else _misaligned
    big, small = place(_draw(shape, dtype, 16)), place(_draw(_small(shape), dtype, 17))
    gp, gu = place(_draw(_small(shape), dtype, 18)), place(_draw(shape, dtype, 19))
    b, h, w, c = shape
    bf16 = int(dtype == torch.bfloat16)

    x, xr = big.requires_grad_(), big.detach().clone().requires_grad_()
    pooled = mean_pool(x)
    pooled.backward(gp)
    old_mean_pool(xr).backward(gp)
    assert torch.equal(_bits(pooled), _bits(old_mean_pool(xr.detach())))
    assert torch.equal(x.grad, xr.grad)

    y, yr = small.requires_grad_(), small.detach().clone().requires_grad_()
    up = upsample_depth_to_space(y)
    up.backward(gu)
    old_upsample(yr).backward(gu)
    assert torch.equal(_bits(up), _bits(old_upsample(yr.detach())))
    assert torch.equal(_bits(y.grad), _bits(yr.grad))

    maps = [place(_draw(_small(shape), dtype, 30 + i)) for i in range(4)]
    assert torch.equal(_bits(rk.upsample2x_op(*maps, 1.0)), _bits(old_upsample(*maps)))

    rows = b * (h // 2) * (w // 2)
    # the pool, its gradient (the upsample of one map at 1/4), the upsample;
    # its gradient launches nothing; then four maps
    assert emulated.calls == [("pool2x2", bf16, rows, w // 2, c, 132, 7),
                              ("up2x2", bf16, rows, w // 2, c, 0.25, 1, 132, 7),
                              ("up2x2", bf16, rows, w // 2, c, 1.0, 1, 132, 7),
                              ("up2x2", bf16, rows, w // 2, c, 1.0, 4, 132, 7)]
    size = 2 if bf16 else 4
    assert emulated.vecs == [16 // size if aligned and (c * size) % 16 == 0 else 1] * 4
    assert runtime.launch_counts() == {**dict.fromkeys(runtime.KERNELS, 0),
                                       "pool2x2": 1, "up2x2": 3}
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    assert emulated.resample_pool2x2.argtypes == [ptr, ptr, i32, i64, i32, i32, i32, ptr]
    assert emulated.resample_up2x2.argtypes == [ptr] * 5 + [i32, i64, i32, i32, f32, i32, ptr]


def test_wrappers_refuse_what_the_kernels_do_not_take(emulated):
    """A non-contiguous, float64, odd or too large map raises before any
    launch; nothing is counted."""
    t = torch.zeros(2, 4, 4, 8).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        rk.mean_pool_op(t)
    with pytest.raises(ValueError, match="contiguous"):
        rk.upsample2x_op(t, t, t, t, 1.0)
    z = torch.zeros(2, 4, 4, 8)
    with pytest.raises(ValueError, match="four maps"):
        rk.upsample2x_op(z, z, z, torch.zeros(2, 4, 4, 4), 1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mean_pool(torch.zeros(2, 4, 4, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="H and W even"):
        mean_pool(torch.zeros(2, 4, 5, 8))
    with pytest.raises(ValueError, match="32-bit"):
        upsample_depth_to_space(torch.empty(1, 2**15, 2**15, 2, device="meta"))
    assert emulated.calls == [] and runtime.launch_counts() == dict.fromkeys(runtime.KERNELS, 0)


def test_empty_batch_launches_nothing(emulated):
    out = mean_pool(torch.zeros(0, 4, 4, 8))
    assert out.shape == (0, 2, 2, 8) and upsample_depth_to_space(out).shape == (0, 4, 4, 8)
    assert emulated.calls == [] and runtime.launch_counts() == dict.fromkeys(runtime.KERNELS, 0)


@pytest.mark.parametrize("failure", ["launch", "build"])
def test_wrappers_raise_with_no_fallback(monkeypatch, emulated, failure):
    """A failed launch or build raises; the plain versions are refused by the
    fixture, and nothing is counted."""
    if failure == "launch":
        emulated.resample_pool2x2 = _Entry(lambda *a: 700)
        match = "illegal memory access"
    else:
        def broken_build(name):
            raise RuntimeError("nvcc failed")

        monkeypatch.setattr(runtime, "cuda_library", broken_build)
        match = "nvcc failed"
    with pytest.raises(RuntimeError, match=match):
        mean_pool(torch.zeros(2, 4, 4, 8))
    assert runtime.launch_counts()["pool2x2"] == 0
