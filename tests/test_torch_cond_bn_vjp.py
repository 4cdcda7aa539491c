"""The cond-BN backward op and its CUDA kernel's Python side, on the CPU: a
numpy emulation of ``cond_bn_kernel_vjp``'s fold order (row blocks, the
per-sample segments and their slots, the block partials of m1 and m2, the
label fold in sample order, dx's regrouped formula) against the VJP of the
JAX package's cond-BN (``cond_batchnorm_bhwc``, ``cond_batchnorm_fused``)
for the three table shapes the models use (10 labels, one row per sample,
one row), with and without the ReLU, in float32 and with bf16 dx; the op's
CPU implementation bit for bit against the plain backward it replaced on
the autograd path; each subset of the gradients asked for; the backward
geometry at every generator map of the benchmark's models; and the CUDA
implementation against a fake library (pointers, geometry, null outputs,
one count a call, no fallback).
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rcgan_tpu.ops.pallas.norm_kernel import cond_batchnorm_bhwc, cond_batchnorm_fused
from rcgan_tpu_torch.ops.kernels import norm_kernel, runtime
from rcgan_tpu_torch.ops.kernels.norm_kernel import (THREADS, CondBatchNormFn,
                                                     cond_batchnorm_backward_op, geometry,
                                                     vector_width)
from torch_parity import cuda_impls_on_cpu

torch.set_num_threads(min(2, torch.get_num_threads()))

F32 = np.float32
SMS = 132  # blocks a cooperative launch holds on an H100: one per SM
EPS = 1e-5


def _tables(kind, b, c, rs):
    """``(labels, scale_table, offset_table)``: 10 labels (CIFAR, PGGAN), one
    row per sample indexed by ``arange`` (BigGAN's ``CondBN``), or one row
    (BigGAN's ``BatchNormReLU``)."""
    rows = {"10 labels": 10, "B rows": b, "1 row": 1}[kind]
    labels = {"10 labels": rs.randint(0, 10, b), "B rows": np.arange(b),
              "1 row": np.zeros(b, np.int64)}[kind]
    return (labels, (1.0 + 0.2 * rs.randn(rows, c)).astype(F32),
            (0.2 * rs.randn(rows, c)).astype(F32))


def _forward(x, labels, scale_t, offset_t, relu):
    """The forward's saved tensors on the CPU: ``(mean, inv, out)``."""
    xt = torch.from_numpy(x)
    mean, inv = norm_kernel._moments_plain(xt, EPS)
    out = norm_kernel._apply_plain(xt, torch.from_numpy(labels), torch.from_numpy(scale_t),
                                   torch.from_numpy(offset_t), mean, inv, relu)
    return mean.numpy(), inv.numpy(), out


def _emulate_vjp(g, x, out, labels, scale_t, mean, inv, relu, max_blocks, itemsize=4):
    """``csrc/cond_bn.cu``'s ``cond_bn_kernel_vjp`` in numpy, float32 (g, x
    and out as float32 arrays of their values; the channel blocks run the
    same steps on their own columns, so all columns go together): phase 1
    sums g' and g'·x̂ per segment (a sample's rows in a row block), each of
    the segment's lanes over its rows in order, the lanes in lane order, into
    slot (row block + sample), and adds scale[l_b] times them into the
    block's partials of m1, m2 in sample order; phase 2 folds the partials
    in row-block order, and each table row sums, in sample order, the
    samples of its label, each sample's segments in row-block order; phase
    3 is dx = inv·scale[l_b]·g' − ((x − mean)·inv²·m2 + inv·m1).  Returns
    ``(dx, dscale, doffset, geo)``."""
    b, s, c = x.shape
    n = b * s
    geo = geometry(n, c, itemsize, vector_width(c, itemsize, True), max_blocks, vjp=True)
    ty, rpb = THREADS // geo.tx, geo.rows_per_block
    gp = g.reshape(n, c).astype(F32)
    if relu:
        gp = gp * (out.reshape(n, c) > 0).astype(F32)
    xr = x.reshape(n, c)
    xh = (xr - mean) * inv
    slots = geo.rb + b - 1
    seg, part, used = np.zeros((2, slots, c), F32), np.zeros((2, geo.rb, c), F32), set()
    for blk in range(geo.rb):
        r0, r1 = blk * rpb, min(n, (blk + 1) * rpb)
        for smp in range(r0 // s, (r1 - 1) // s + 1):
            lo, hi = max(r0, smp * s), min(r1, (smp + 1) * s)
            sums = np.zeros((2, c), F32)
            for lane in range(min(ty, hi - lo)):
                acc = np.zeros((2, c), F32)
                for r in range(lo + lane, hi, ty):
                    acc = acc + np.stack([gp[r], gp[r] * xh[r]])
                sums = sums + acc
            assert blk + smp not in used  # one slot per (row block, sample)
            used.add(blk + smp)
            seg[:, blk + smp] = sums
            part[:, blk] = part[:, blk] + scale_t[labels[smp]] * sums
    m = np.zeros((2, c), F32)
    for blk in range(geo.rb):
        m = m + part[:, blk]
    m1, m2 = m / F32(n)
    tables = np.zeros((2, scale_t.shape[0], c), F32)
    for lab in range(scale_t.shape[0]):
        for smp in range(b):
            if labels[smp] == lab:
                v = np.zeros((2, c), F32)
                for k in range(smp * s // rpb, ((smp + 1) * s - 1) // rpb + 1):
                    v = v + seg[:, k + smp]
                tables[:, lab] = tables[:, lab] + v
    alpha = (scale_t[labels] * inv)[:, None, :]
    e, w = inv * m1, inv * inv * m2
    dx = alpha * gp.reshape(b, s, c) - ((x - mean) * w + e)
    return dx, tables[1], tables[0], geo


def _jax_vjp(x, labels, scale_t, offset_t, g, relu, fused=False):
    """``(dx, dscale, doffset)``: the VJP of JAX's cond-BN (and its ReLU) at
    cotangent ``g``, ``x [B, S, C]`` as a [B, S, 1, C] map, through
    ``cond_batchnorm_bhwc`` or, with ``fused``, ``cond_batchnorm_fused``
    with the affine gathered from the tables."""
    b, s, c = x.shape

    def f(x, sc, of):
        if fused:
            y = cond_batchnorm_fused(x, jnp.take(sc, labels, axis=0), jnp.take(of, labels, axis=0),
                                     EPS)
        else:
            y = cond_batchnorm_bhwc(x.reshape(b, s, 1, c), jnp.asarray(labels), sc, of,
                                    EPS).reshape(b, s, c)
        return jax.nn.relu(y) if relu else y

    _, pullback = jax.vjp(f, *(jnp.asarray(a) for a in (x, scale_t, offset_t)))
    return [np.asarray(t) for t in pullback(jnp.asarray(g))]


def _close(got, want, rel, rtol=0.0):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rel * np.abs(want).max())


# ------------------------------------------------- the kernel's fold order
@pytest.mark.parametrize("b,s,c,max_blocks", [(8, 4, 256, SMS), (3, 64, 256, SMS),
                                              (4, 6, 8, SMS), (5, 7, 12, 3), (6, 16, 128, 5)])
@pytest.mark.parametrize("kind", ["10 labels", "B rows", "1 row"])
@pytest.mark.parametrize("relu", [False, True])
def test_vjp_emulation_matches_jax(b, s, c, max_blocks, kind, relu):
    """The kernel's sums, split over row blocks, samples and lanes and folded
    in its fixed orders, against JAX's VJP of its cond-BN: 1e-5 of each
    gradient's scale (float32, sums of at most a few hundred terms in
    another order).  The shapes put several samples in a block with some
    lanes idle ([8, 4, 256]: two blocks of four samples), a sample across
    four blocks ([3, 64, 256]), one block of several samples and channel
    blocks ([5, 7, 12]), and several blocks of several samples at a small
    grid ([6, 16, 128])."""
    rs = np.random.RandomState(b * 1000 + s * 10 + c)
    x = (2.0 * rs.randn(b, s, c) + 0.5).astype(F32)
    labels, scale_t, offset_t = _tables(kind, b, c, rs)
    g = rs.randn(b, s, c).astype(F32)
    mean, inv, out = _forward(x, labels, scale_t, offset_t, relu)
    dx, dscale, doffset, geo = _emulate_vjp(g, x, out.numpy(), labels, scale_t, mean, inv, relu,
                                            max_blocks)
    assert geo.cb * geo.rb <= max_blocks and geo.rb * geo.rows_per_block >= b * s
    for got, want in zip((dx, dscale, doffset), _jax_vjp(x, labels, scale_t, offset_t, g, relu)):
        _close(got, want, 1e-5)


def test_vjp_emulation_matches_pallas_fused_vjp():
    """The same emulation against ``cond_batchnorm_fused``'s custom VJP
    (Pallas in interpret mode, C = 128, per-sample rows as BigGAN's tables)
    with the ReLU: 1e-5 of each gradient's scale."""
    rs = np.random.RandomState(41)
    b, s, c = 4, 16, 128
    x = (2.0 * rs.randn(b, s, c) + 0.5).astype(F32)
    labels, scale_t, offset_t = _tables("B rows", b, c, rs)
    g = rs.randn(b, s, c).astype(F32)
    mean, inv, out = _forward(x, labels, scale_t, offset_t, True)
    got = _emulate_vjp(g, x, out.numpy(), labels, scale_t, mean, inv, True, SMS)[:3]
    for a, want in zip(got, _jax_vjp(x, labels, scale_t, offset_t, g, True, fused=True)):
        _close(a, want, 1e-5)


@pytest.mark.parametrize("kind", ["10 labels", "B rows", "1 row"])
def test_vjp_emulation_bf16_dx(kind):
    """bf16 g, x and out (the geometry of 2-byte elements, 8 to a thread):
    the emulated dx rounded to bf16 within a bf16 rounding of JAX's VJP on
    the same bf16 values in float32 (2⁻⁸ of the value plus 1e-5 of the
    scale), the float32 tables within 1e-5 of their scale."""
    rs = np.random.RandomState(43)
    b, s, c = 6, 16, 64
    bf = lambda a: torch.from_numpy(a).bfloat16().float().numpy()  # noqa: E731
    x = bf((2.0 * rs.randn(b, s, c) + 0.5).astype(F32))
    labels, scale_t, offset_t = _tables(kind, b, c, rs)
    g = bf(rs.randn(b, s, c).astype(F32))
    mean, inv, out = _forward(x, labels, scale_t, offset_t, True)
    out = bf(out.numpy())
    dx, dscale, doffset, geo = _emulate_vjp(g, x, out, labels, scale_t, mean, inv, True, SMS,
                                            itemsize=2)
    assert geo.vec == 8
    dx = bf(dx)
    # JAX's ReLU mask from the same bf16 output, as the kernel takes it
    want = _jax_vjp(x, labels, scale_t, offset_t, g * (out > 0), False)
    _close(dx, want[0], 1e-5, rtol=2.0 ** -8)
    _close(dscale, want[1], 1e-5)
    _close(doffset, want[2], 1e-5)


# ------------------------------------------------- the op and its CPU route
def _parent_backward(relu, needs, g, x, labels, scale_table, mean, inv, out=None):
    """The plain backward as the autograd path ran it before the op: a copy,
    so that the CPU route is held to its bits."""
    g = g.float()
    if relu:
        g = g * (out > 0)
    xhat = (x.float() - mean) * inv
    dx = dscale = doffset = None
    if needs[0]:
        dxhat = g * scale_table.float()[labels][:, None, :]
        m1 = dxhat.mean(dim=(0, 1))
        m2 = (dxhat * xhat).mean(dim=(0, 1))
        dx = (inv * (dxhat - m1 - xhat * m2)).to(x.dtype)
    idx = labels.long()
    if needs[2]:
        dscale = torch.zeros(scale_table.shape, dtype=torch.float32, device=g.device)
        dscale.index_add_(0, idx, (g * xhat).sum(dim=1))
    if needs[3]:
        doffset = torch.zeros(scale_table.shape, dtype=torch.float32, device=g.device)
        doffset.index_add_(0, idx, g.sum(dim=1))
    return dx, dscale, doffset


def _op_inputs(dtype, relu, kind="10 labels", seed=51, b=5, s=9, c=16):
    rs = np.random.RandomState(seed)
    labels, scale_t, offset_t = _tables(kind, b, c, rs)
    x = torch.from_numpy((2.0 * rs.randn(b, s, c) + 0.5).astype(F32)).to(dtype)
    labels, scale_t, offset_t = (torch.from_numpy(a) for a in (labels, scale_t, offset_t))
    out, (mean, inv) = norm_kernel.cond_batchnorm_op(x, labels, scale_t, offset_t, EPS, relu)
    # a cotangent that is not contiguous, as autograd may hand one over
    g = torch.from_numpy(rs.randn(b, c, s).astype(F32)).to(dtype).transpose(1, 2)
    return g, x, (out if relu else None), labels, scale_t, offset_t, mean, inv


def _same_bits(a, b):
    return a is None and b is None or (a.dtype == b.dtype and torch.equal(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("kind", ["10 labels", "B rows", "1 row"])
def test_backward_op_cpu_is_the_plain_backward_bit_for_bit(dtype, relu, kind):
    """The op's CPU implementation, and ``CondBatchNormFn``'s gradients on
    the CPU, equal the plain backward that the autograd path ran before the
    op, bit for bit, for every subset of the gradients asked for (with a
    non-contiguous cotangent)."""
    g, x, out, labels, scale_t, offset_t, mean, inv = _op_inputs(dtype, relu, kind)
    for needs in [(a, b_, c_) for a in (False, True) for b_ in (False, True)
                  for c_ in (False, True)]:
        got = cond_batchnorm_backward_op(g, x, out, labels, scale_t, mean, inv, relu,
                                         list(needs))
        want = _parent_backward(relu, (needs[0], False) + needs[1:], g, x, labels, scale_t,
                                mean, inv, out)
        assert all(_same_bits(a, b_) for a, b_ in zip(got, want)), needs
    # through autograd, each subset of (x, scale, offset) requiring a gradient
    for req in [(a, b_, c_) for a in (False, True) for b_ in (False, True) for c_ in (False, True)
                if a or b_ or c_]:
        ins = [t.clone().requires_grad_(r) for t, r in zip((x, scale_t, offset_t), req)]
        y = CondBatchNormFn.apply(ins[0], labels, ins[1], ins[2], EPS, relu)
        y.backward(g)
        want = _parent_backward(relu, (req[0], False) + req[1:], g, x, labels, scale_t, mean,
                                inv, out)
        assert all(_same_bits(t.grad, w) for t, w in zip(ins, want)), req


def test_backward_op_schema_and_fake():
    """``torch.library.opcheck`` of the op on the CPU (its schema, and the fake
    implementation's shapes and dtypes against the CPU one), with and
    without the ReLU's output, every gradient and dx alone."""
    for relu, needs in ((True, [True, True, True]), (False, [True, False, False]),
                        (True, [False, True, False])):
        g, x, out, labels, scale_t, _, mean, inv = _op_inputs(torch.bfloat16, relu)
        torch.library.opcheck(cond_batchnorm_backward_op,
                              (g.contiguous(), x, out, labels, scale_t, mean, inv, relu, needs),
                              test_utils=("test_schema", "test_faketensor"))


# ------------------------------------------------------------ the geometry
def _g_maps():
    """(S, C) of every cond-BN of the benchmark's generators: CIFAR's seven
    (four distinct), PGGAN's at 4–64 pixels (dim 128), BigGAN-128's eleven
    (``g_arch(96, 128)``: two a block, then the output norm)."""
    from rcgan_tpu_torch.models.biggan import g_arch

    cifar = [(16, 1024), (64, 256), (256, 256), (1024, 256)]
    pggan = [(hw * hw, 128) for hw in (4, 8, 16, 32, 64)]
    ga = g_arch(96, 128)
    biggan = [m for cin, cout, r in zip(ga["in"], ga["out"], ga["resolution"])
              for m in (((r // 2) ** 2, cin), (r * r, cout))] + [(128 * 128, 96)]
    return cifar, pggan, biggan


@pytest.mark.parametrize("itemsize", [2, 4])
def test_vjp_geometry_at_every_generator_map(itemsize):
    """At every generator map of the cells at their batches (CIFAR 64 and
    128, PGGAN 64, BigGAN 256): the backward's grid fits a cooperative
    launch, its row blocks cover every row, its shared memory stays within
    224 KB with some rows of g' and x kept, 16-byte vectors are used, and the
    work buffer's slots (row blocks + B − 1) stay small beside the map."""
    cifar, pggan, biggan = _g_maps()
    assert len(biggan) == 11 and biggan[0] == (16, 1536)
    for batches, maps in (((64, 128), cifar), ((64,), pggan), ((256,), biggan)):
        for b in batches:
            for s, c in maps:
                vec = vector_width(c, itemsize, True)
                geo = geometry(b * s, c, itemsize, vec, SMS, vjp=True)
                fwd = geometry(b * s, c, itemsize, vec, SMS)
                assert vec == 16 // itemsize and geo[:5] == fwd[:5]
                assert geo.cb * geo.rb <= SMS and geo.tx * vec * geo.cb >= c
                assert (geo.rb - 1) * geo.rows_per_block < b * s <= geo.rb * geo.rows_per_block
                assert geo.smem_bytes <= 224 * 1024 and 0 < geo.keep_rows <= geo.rows_per_block
                assert (2 * geo.rb + 2 * (geo.rb + b - 1)) * c * 4 <= 8 * b * s * c * itemsize


# ------------------------------------------------ the wrapper's CUDA branch
class _FakeFn:
    def __init__(self, result=0):
        self.argtypes = self.restype = None
        self.calls, self.result = [], result

    def __call__(self, *args):
        self.calls.append(args)
        return self.result


def _fake_backward(monkeypatch, code=0, max_blocks=SMS):
    fn = _FakeFn(code)
    lib = types.SimpleNamespace(cond_bn_backward=fn, cond_bn_vjp_max_blocks=_FakeFn(max_blocks),
                                cond_bn_error_string=_FakeFn(b"cooperative launch too large"))
    monkeypatch.setattr(runtime, "on_cuda", lambda *ts: True)
    cuda_impls_on_cpu(monkeypatch, "cond_batchnorm_backward")
    monkeypatch.setattr(runtime, "cuda_library", lambda name: lib)
    monkeypatch.setattr(runtime, "on_device", lambda t, f, *args: f(*args, 7))
    monkeypatch.setattr(norm_kernel, "_max_blocks", lambda index, code, vec, vjp=False: max_blocks)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(norm_kernel, "_cond_batchnorm_backward",
                        lambda *a, **k: (_ for _ in ()).throw(AssertionError("fell back")))
    runtime.reset_launch_counts()
    return fn


@pytest.mark.parametrize("dtype,relu,label64", [(torch.float32, True, False),
                                                (torch.bfloat16, False, True),
                                                (torch.bfloat16, True, False)])
def test_backward_wrapper_passes_pointers_geometry_and_nulls(monkeypatch, dtype, relu, label64):
    """One call is one launch and one ``cond_bn_bwd`` count: the entry point
    gets the pointers of g, x, the forward's output (null without the
    ReLU), the labels (and whether they are int64), the scale table, mean,
    inv, the outputs (null where no gradient is asked for) and a float32
    work buffer of (2 rb + 2 (rb + B − 1)) rows of C, then the sizes, the
    table's rows, the dtype code, the backward ``geometry`` and the stream."""
    fn = _fake_backward(monkeypatch)
    b, s, c = 6, 64, 256
    x = torch.randn(b, s, c).to(dtype)
    g, out = torch.randn(b, s, c).to(dtype), torch.randn(b, s, c).to(dtype)
    labels = (torch.arange(b) % 10).to(torch.int64 if label64 else torch.int32)
    scale, mean, inv = torch.ones(10, c), torch.zeros(c), torch.ones(c)
    size = x.element_size()
    geo = geometry(b * s, c, size, 16 // size, SMS, vjp=True)
    for k, needs in enumerate(([True, True, True], [False, True, False], [True, False, True])):
        got = norm_kernel.cond_batchnorm_backward_cuda(g, x, out if relu else None, labels, scale,
                                                       mean, inv, relu, needs)
        assert runtime.launch_counts()["cond_bn_bwd"] == k + 1 and len(fn.calls) == k + 1
        a = fn.calls[k]
        assert a[:2] == (g.data_ptr(), x.data_ptr()) and a[2] == (out.data_ptr() if relu else None)
        assert a[3:8] == (labels.data_ptr(), int(label64), scale.data_ptr(), mean.data_ptr(),
                          inv.data_ptr())
        for ptr, t, need in zip(a[8:11], got, needs):
            assert (t is not None) == need and ptr == (t.data_ptr() if need else None)
        assert got[0] is None or (got[0].shape == x.shape and got[0].dtype == dtype)
        assert all(t is None or (t.shape == (10, c) and t.dtype == torch.float32) for t in got[1:])
        assert a[12:16] == (b * s, s, c, 10)
        assert a[16] == {torch.float32: 0, torch.bfloat16: 1}[dtype]
        assert a[17:24] == tuple(geo) and a[24] == 7
        assert len(fn.argtypes) == 25
    # the work buffer is the launch's own float32 scratch, sized by the geometry
    work_rows = 2 * geo.rb + 2 * (geo.rb + b - 1)
    with torch.no_grad():
        alloc = []
        real_empty = torch.empty
        monkeypatch.setattr(torch, "empty", lambda *sh, **kw: alloc.append((sh, kw))
                            or real_empty(*sh, **kw))
        norm_kernel.cond_batchnorm_backward_cuda(g, x, out if relu else None, labels, scale, mean,
                                                 inv, relu, [True, False, False])
    assert ((work_rows, c),) in [sh for sh, _ in alloc]


def test_backward_through_autograd_is_one_launch_a_call(monkeypatch):
    """Through ``CondBatchNormFn`` (the forward on its plain CPU route), a
    backward is one launch of the backward entry point with the gradients
    the inputs require; a backward that asks for none launches nothing."""
    fn = _fake_backward(monkeypatch)
    x = torch.randn(4, 16, 8, requires_grad=True)
    labels, scale = torch.tensor([1, 0, 1, 2]), torch.ones(10, 8, requires_grad=True)
    offset = torch.zeros(10, 8)
    y = CondBatchNormFn.apply(x, labels, scale, offset, EPS, True)
    y.backward(torch.randn_like(y))
    assert runtime.launch_counts()["cond_bn_bwd"] == 1 and len(fn.calls) == 1
    a = fn.calls[0]
    assert a[8] == x.grad.data_ptr() and a[9] == scale.grad.data_ptr() and a[10] is None
    assert norm_kernel.cond_batchnorm_backward_cuda(
        y.detach(), x.detach(), y.detach(), labels, scale.detach(), torch.zeros(8), torch.ones(8),
        True, [False, False, False]) == (None, None, None)
    assert runtime.launch_counts()["cond_bn_bwd"] == 1


def test_backward_wrapper_raises_with_no_fallback(monkeypatch):
    """A launch error, a failing build and inputs the kernel does not take
    all raise; the plain backward is never called and nothing is counted."""
    x, labels = torch.randn(2, 4, 8), torch.tensor([0, 1])
    scale, mean, inv = torch.ones(10, 8), torch.zeros(8), torch.ones(8)
    fn = _fake_backward(monkeypatch, code=720)
    with pytest.raises(RuntimeError, match="cooperative launch too large"):
        norm_kernel.cond_batchnorm_backward_cuda(x, x, x, labels, scale, mean, inv, True,
                                                 [True, True, True])
    with pytest.raises(ValueError, match="g like x"):
        norm_kernel.cond_batchnorm_backward_cuda(x.bfloat16(), x, None, labels, scale, mean, inv,
                                                 False, [True, True, True])
    with pytest.raises(ValueError, match="forward's output"):
        norm_kernel.cond_batchnorm_backward_cuda(x, x, None, labels, scale, mean, inv, True,
                                                 [True, True, True])
    with pytest.raises(ValueError, match="mean and inv"):
        norm_kernel.cond_batchnorm_backward_cuda(x, x, None, labels, scale, mean.double(), inv,
                                                 False, [True, True, True])
    assert len(fn.calls) == 1

    def broken_build(name):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(runtime, "cuda_library", broken_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        norm_kernel.cond_batchnorm_backward_cuda(x, x, None, labels, scale, mean, inv, False,
                                                 [True, False, False])
    assert runtime.launch_counts()["cond_bn_bwd"] == 0
