"""The CUDA cond-BN kernel's Python side and its fused ReLU, on the CPU: a
numpy emulation of the kernel's block partials and block-order fold against
the JAX package's ``cond_batchnorm_fused`` (Pallas, interpret mode); the
``relu=True`` forward and gradients against ``jax.nn.relu`` of JAX's
cond-BN; the generator with the ReLU fused against JAX's ``generator``; the
launch geometry; and the CUDA branch of the wrapper against a fake library.
Inputs come from numpy seeds; tolerances are stated per test.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rcgan_tpu.core.module import Ctx
from rcgan_tpu.models.resnet_gan import ResnetGANConfig as JaxConfig
from rcgan_tpu.models.resnet_gan import generator as jax_generator
from rcgan_tpu.ops.pallas.norm_kernel import cond_batchnorm_bhwc, cond_batchnorm_fused
from rcgan_tpu_torch.bridge import generator_from_jax
from rcgan_tpu_torch.models import resnet_gan as trg
from rcgan_tpu_torch.ops.kernels import norm_kernel, runtime
from rcgan_tpu_torch.ops.kernels.norm_kernel import (THREADS, CondBatchNormFn, cond_batchnorm,
                                                     cond_batchnorm_plain, geometry,
                                                     vector_width)
from torch_parity import cuda_impls_on_cpu

torch.set_num_threads(min(2, torch.get_num_threads()))

F32 = np.float32
SMS = 132  # blocks a cooperative launch holds on an H100: one per SM
# (S, C) of a full-width generator pass
G_SHAPES = [(16, 1024), (64, 256), (256, 256), (1024, 256)]


def _inputs(b, s, c, seed):
    rs = np.random.RandomState(seed)
    return ((2.0 * rs.randn(b, s, c) + 0.5).astype(F32), rs.randint(0, 10, b),
            (1.0 + 0.2 * rs.randn(10, c)).astype(F32), (0.2 * rs.randn(10, c)).astype(F32))


def _emulate_kernel(x, labels, scale_t, offset_t, eps, relu, max_blocks):
    """``csrc/cond_bn.cu`` in numpy, float32 throughout: the rows [B·S] split
    over ``rb`` row blocks; in a block each of its ``ty`` row lanes sums its
    rows (r0 + lane, r0 + lane + ty, ...) in order, the lanes are folded in
    lane order into the block's partial, and the partials in block order
    into the moments; then the affine by label and the ReLU."""
    b, s, c = x.shape
    rows = x.reshape(b * s, c)
    geo = geometry(b * s, c, 4, vector_width(c, 4, True), max_blocks)
    ty = THREADS // geo.tx
    tot, tot2 = np.zeros(c, F32), np.zeros(c, F32)
    for blk in range(geo.rb):
        r0 = blk * geo.rows_per_block
        r1 = min(b * s, r0 + geo.rows_per_block)
        part, part2 = np.zeros(c, F32), np.zeros(c, F32)
        for lane in range(ty):
            acc, acc2 = np.zeros(c, F32), np.zeros(c, F32)
            for r in range(r0 + lane, r1, ty):
                acc = acc + rows[r]
                acc2 = acc2 + rows[r] * rows[r]
            part, part2 = part + acc, part2 + acc2
        tot, tot2 = tot + part, tot2 + part2
    n = F32(b * s)
    mean = tot / n
    inv = F32(1.0) / np.sqrt(np.maximum(tot2 / n - mean * mean, F32(0)) + F32(eps))
    out = (x - mean) * inv * scale_t[labels][:, None, :] + offset_t[labels][:, None, :]
    return (np.maximum(out, 0) if relu else out).astype(F32), geo


# ---------------------------------------------- block partials, block order
@pytest.mark.parametrize("b,s,c,max_blocks", [(4, 6, 8, SMS), (3, 64, 256, SMS), (2, 16, 128, 5),
                                              (5, 7, 12, 3)])
@pytest.mark.parametrize("relu", [False, True])
def test_block_partial_emulation_matches_pallas_interpret(b, s, c, max_blocks, relu):
    """The same one-pass formula (float32 sums of x and x², var clamped at
    0) with the sums split over row blocks and lanes and folded in a fixed
    order: 1e-5 abs/rel on O(1) outputs against the Pallas kernels, and
    against the port's plain version."""
    x, labels, scale_t, offset_t = _inputs(b, s, c, b * 100 + c)
    got, geo = _emulate_kernel(x, labels, scale_t, offset_t, 1e-5, relu, max_blocks)
    assert geo.cb * geo.rb <= max_blocks and geo.rb * geo.rows_per_block >= b * s
    ref = np.asarray(cond_batchnorm_fused(jnp.asarray(x), jnp.asarray(scale_t[labels]),
                                          jnp.asarray(offset_t[labels]), 1e-5))
    ref = np.maximum(ref, 0) if relu else ref
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    plain = cond_batchnorm_plain(*(torch.from_numpy(a) for a in (x, labels, scale_t, offset_t)),
                                 relu=relu)
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_geometry_fills_the_card_and_keeps_small_maps_on_chip(itemsize):
    """At every generator shape and path batch: the grid fits a cooperative
    launch (at most one block per SM), the row blocks cover every row, a
    block's shared memory stays within 224 KB, 16-byte vectors are used,
    and every map of at most 25 MB is kept on chip whole (x is then read
    from device memory once): all at buckets 1-32, the three small float32
    maps at batch 100."""
    for b in (1, 8, 32, 64, 100, 128):
        for s, c in G_SHAPES:
            vec = vector_width(c, itemsize, True)
            geo = geometry(b * s, c, itemsize, vec, SMS)
            ty = THREADS // geo.tx
            assert vec == 16 // itemsize and geo.tx * vec * geo.cb >= c
            assert geo.cb * geo.rb <= SMS and geo.rows_per_block % ty == 0
            assert (geo.rb - 1) * geo.rows_per_block < b * s <= geo.rb * geo.rows_per_block
            assert geo.smem_bytes <= 224 * 1024 and 0 < geo.keep_rows <= geo.rows_per_block
            if b * s * c * itemsize <= 25e6:
                assert geo.keep_rows == geo.rows_per_block, (b, s, c)
    # a ragged channel count, or tensors off 16-byte alignment: one element a thread
    assert vector_width(36, 2, True) == 1 and vector_width(256, 4, False) == 1
    geo = geometry(15, 7, 4, 1, SMS)
    assert (geo.vec, geo.tx, geo.cb) == (1, 4, 2) and geo.rb * geo.rows_per_block >= 15
    with pytest.raises(ValueError, match="channel blocks"):
        geometry(4, 4096, 4, 1, 8)


# ------------------------------------------------------------ the fused ReLU
def test_relu_forward_and_grads_match_relu_of_jax_cond_batchnorm():
    """``relu=True`` against ``jax.nn.relu(cond_batchnorm_bhwc(...))``, which
    XLA fuses: the output to 1e-5 of its scale, and dx and both table
    gradients of sum(sin(out)·r) to 1e-4 of each gradient's scale (float32;
    the ReLU's mask comes from the forward's own output)."""
    b, h, w, c = 5, 3, 3, 8
    x, labels, scale_t, offset_t = _inputs(b, h * w, c, 21)
    x4 = x.reshape(b, h, w, c)
    r = np.random.RandomState(22).randn(b, h, w, c).astype(F32)

    def jout(x, s, o):
        return jax.nn.relu(cond_batchnorm_bhwc(x, jnp.asarray(labels), s, o))

    jargs = [jnp.asarray(a) for a in (x4, scale_t, offset_t)]
    ref = np.asarray(jout(*jargs))
    refs = jax.grad(lambda *a: jnp.sum(jnp.sin(jout(*a)) * r), argnums=(0, 1, 2))(*jargs)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale_t, offset_t)]
    out = cond_batchnorm(ts[0], torch.from_numpy(labels), ts[1], ts[2], relu=True)
    assert out.min().item() == 0.0
    np.testing.assert_allclose(out.detach().numpy().reshape(b, h, w, c), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    torch.sum(torch.sin(out.reshape(b, h, w, c)) * torch.from_numpy(r)).backward()
    for t, want in zip(ts, refs):
        want = np.asarray(want).reshape(t.shape)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_relu_bf16_dx_and_float32_tables():
    """bf16 activations through the fused ReLU: the output equals relu of
    the unfused output bit for bit (max commutes with the rounding); dx in
    bf16 and the table gradients in float32, each within a bf16 rounding of
    autograd of relu(plain) on the same inputs (2⁻⁷ of the value plus 1e-3
    of the scale, as the unfused bf16 test allows)."""
    rs = np.random.RandomState(23)
    x = torch.from_numpy((2.0 * rs.randn(4, 9, 16) + 0.5).astype(F32)).to(torch.bfloat16)
    labels = torch.tensor([2, 0, 2, 5])
    tables = [torch.from_numpy((1.0 + 0.2 * rs.randn(10, 16)).astype(F32)),
              torch.from_numpy((0.2 * rs.randn(10, 16)).astype(F32))]
    r = torch.from_numpy(rs.randn(4, 9, 16).astype(F32))
    assert torch.equal(cond_batchnorm(x, labels, *tables, relu=True),
                       torch.relu(cond_batchnorm(x, labels, *tables)))
    grads = []
    for fn in (lambda *a: CondBatchNormFn.apply(*a, 1e-5, True),
               lambda *a: torch.relu(cond_batchnorm_plain(*a))):
        ts = [x.clone().requires_grad_(True)] + [t.clone().requires_grad_(True) for t in tables]
        torch.sum(torch.tanh(fn(ts[0], labels, ts[1], ts[2]).float()) * r).backward()
        grads.append([t.grad for t in ts])
    assert [g.dtype for g in grads[0]] == [torch.bfloat16, torch.float32, torch.float32]
    for got, want in zip(*grads):
        got, want = got.float(), want.float()
        assert bool(((got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-3 * want.abs().max()).all())


@pytest.mark.parametrize("kind", ["relu", "lrelu"])
def test_generator_fuses_its_relus_and_matches_jax(kind, monkeypatch):
    """With ``nonlinearity == "relu"`` the generator's seven activations run
    inside cond-BN (``nonlinearity`` is never called, each cond-BN is asked
    for its ReLU); with ``lrelu`` none does.  Either way the images equal
    JAX's ``generator`` to 1e-4 abs (tanh outputs; float32, seven convs)."""
    rs = np.random.RandomState(31)
    z, labels = rs.randn(4, 128).astype(F32), rs.randint(0, 10, 4)
    jcfg = JaxConfig(dim_g=8, nonlinearity=kind)
    ctx = Ctx(rng=jax.random.key(3), init=True)
    jax_generator(ctx, jcfg, jnp.asarray(z), jnp.asarray(labels))
    params = jax.tree_util.tree_map(np.asarray, ctx.params)
    for d in params.values():
        for var, a in d.items():
            if var in ("scale", "offset", "Biases", "b"):
                d[var] = (a + 0.3 * rs.randn(*a.shape)).astype(F32)
    ref = jax_generator(Ctx(params=params, train=True, update_sn=False), jcfg, z, labels)

    calls = {"nonlinearity": 0, "fused": 0, "unfused": 0}
    real_nl, real_cbn = trg.nonlinearity, norm_kernel.cond_batchnorm

    def counting_nl(*a, **k):
        calls["nonlinearity"] += 1
        return real_nl(*a, **k)

    def counting_cbn(x, labels, scale, offset, eps=1e-5, relu=False):
        calls["fused" if relu else "unfused"] += 1
        return real_cbn(x, labels, scale, offset, eps, relu)

    monkeypatch.setattr(trg, "nonlinearity", counting_nl)
    monkeypatch.setattr(norm_kernel, "cond_batchnorm", counting_cbn)
    gen = generator_from_jax(params, trg.ResnetGANConfig(dim_g=8, nonlinearity=kind), device="cpu")
    out = trg.sample(gen, torch.from_numpy(z), torch.from_numpy(labels))
    want = {"nonlinearity": 0, "fused": 7, "unfused": 0} if kind == "relu" else \
        {"nonlinearity": 7, "fused": 0, "unfused": 7}
    assert calls == want
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


# ------------------------------------------------ the wrapper's CUDA branch
class _FakeFn:
    def __init__(self, result=0):
        self.argtypes = self.restype = None
        self.calls, self.result = [], result

    def __call__(self, *args):
        self.calls.append(args)
        return self.result


def _fake_cond_bn(monkeypatch, code=0, max_blocks=SMS):
    fn = _FakeFn(code)
    lib = types.SimpleNamespace(cond_bn_forward=fn, cond_bn_max_blocks=_FakeFn(max_blocks),
                                cond_bn_error_string=_FakeFn(b"cooperative launch too large"))
    monkeypatch.setattr(runtime, "on_cuda", lambda *ts: True)
    cuda_impls_on_cpu(monkeypatch, "cond_batchnorm")
    monkeypatch.setattr(runtime, "cuda_library", lambda name: lib)
    monkeypatch.setattr(runtime, "on_device", lambda t, f, *args: f(*args, 7))
    monkeypatch.setattr(norm_kernel, "_max_blocks", lambda index, code, vec: max_blocks)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for name in ("_moments_plain", "_apply_plain"):
        monkeypatch.setattr(norm_kernel, name,
                            lambda *a, **k: (_ for _ in ()).throw(AssertionError("fell back")))
    runtime.reset_launch_counts()
    return fn


@pytest.mark.parametrize("dtype,relu", [(torch.float32, True), (torch.bfloat16, False)])
def test_cond_bn_wrapper_passes_pointers_geometry_and_relu(monkeypatch, dtype, relu):
    """One call is one launch and one count: the entry point gets the
    pointers of x, the labels (and whether they are int64), both tables, the
    output and the stats buffer (mean, inv, then 2·rb partial rows), the
    sizes, the dtype code, ``geometry``'s launch shape, eps, the ReLU flag
    and the stream; ``mean`` and ``inv`` handed to the backward are the
    first two rows of that buffer."""
    fn = _fake_cond_bn(monkeypatch)
    b, s, c = 6, 64, 256
    x = torch.randn(b, s, c).to(dtype)
    labels = torch.arange(b, dtype=torch.int32) % 10
    scale, offset = torch.ones(10, c), torch.zeros(10, c)
    out, (mean, inv) = norm_kernel._launch(x, labels, scale, offset, 1e-5, relu)
    assert runtime.launch_counts()["cond_bn"] == 1 and len(fn.calls) == 1
    a = fn.calls[0]
    size = x.element_size()
    geo = geometry(b * s, c, size, 16 // size, SMS)
    assert a[:6] == (x.data_ptr(), labels.data_ptr(), 0, scale.data_ptr(), offset.data_ptr(),
                     out.data_ptr())
    assert a[6] == mean.data_ptr() and inv.data_ptr() == mean.data_ptr() + 4 * c
    assert a[7:10] == (b * s, s, c) and a[10] == {torch.float32: 0, torch.bfloat16: 1}[dtype]
    assert a[11:18] == tuple(geo)
    assert a[18] == pytest.approx(1e-5) and a[19:] == (int(relu), 7)
    assert out.shape == x.shape and out.dtype == dtype and mean.shape == inv.shape == (c,)
    assert len(fn.argtypes) == 21
    # int64 labels are flagged; through the autograd function the count is still one a call
    cond_batchnorm(x, labels.long(), scale, offset, relu=relu)
    assert fn.calls[1][2] == 1 and fn.calls[1][19] == int(relu)
    assert runtime.launch_counts()["cond_bn"] == 2


def test_cond_bn_wrapper_raises_with_no_fallback(monkeypatch):
    """A launch error, a failing build and inputs the kernel does not take
    all raise; the plain version is never called and nothing is counted."""
    x, labels = torch.randn(2, 4, 8), torch.tensor([0, 1])
    tables = torch.ones(10, 8), torch.zeros(10, 8)
    fn = _fake_cond_bn(monkeypatch, code=720)
    with pytest.raises(RuntimeError, match="cooperative launch too large"):
        cond_batchnorm(x, labels, *tables, relu=True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cond_batchnorm(x.double(), labels, *tables)
    with pytest.raises(ValueError, match="contiguous"):
        cond_batchnorm(x.transpose(1, 2), labels, torch.ones(10, 4), torch.zeros(10, 4))
    with pytest.raises(ValueError, match="affine tables"):
        cond_batchnorm(x, labels, tables[0].bfloat16(), tables[1])
    assert len(fn.calls) == 1

    def broken_build(name):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(runtime, "cuda_library", broken_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cond_batchnorm(x, labels, *tables)
    assert runtime.launch_counts()["cond_bn"] == 0
