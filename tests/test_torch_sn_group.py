"""The grouped spectral-norm kernel's Python side, on the CPU: a numpy
emulation of the kernel's cluster split against the JAX package's
``sn_fused`` (Pallas, interpret mode) and ``sn_math``; a group against the
plain version per weight; the VJP's closed form (``sn_vjp_plain``) against
JAX's VJP of ``sn_math`` and autograd's of ``sn_plain``, and a numpy
emulation of the VJP kernel's cluster split against both; the
discriminator's one group per forward against JAX's ``discriminator`` with
``u`` chained; and the CUDA branches of the forward and of the backward
against a fake library (the descriptor struct, the launch count, no
fallback).  Inputs come from numpy seeds; float32; tolerances per test.
"""

import ctypes

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rcgan_tpu.core.module import Ctx
from rcgan_tpu.models import resnet_gan as jrg
from rcgan_tpu.ops.pallas.sn_kernel import sn_fused, sn_math
from rcgan_tpu_torch.core.module import sn_updates, state_tree
from rcgan_tpu_torch.models import resnet_gan as trg
from rcgan_tpu_torch.ops import linear as tlinear
from rcgan_tpu_torch.ops import sn as tsn
from rcgan_tpu_torch.ops.kernels import runtime, sn_kernel
from rcgan_tpu_torch.ops.kernels.sn_kernel import (CLUSTER, MAX_WEIGHTS, cluster_rows,
                                                   group_smem, sn_plain, sn_vjp_plain,
                                                   spectral_norm, spectral_norm_group,
                                                   vjp_scratch, vjp_smem)
from torch_parity import TINY, cuda_impls_on_cpu, perturbed_trees

torch.set_num_threads(min(2, torch.get_num_threads()))

CFG = trg.ResnetGANConfig(**TINY)
JCFG = jrg.ResnetGANConfig(**TINY)
# D's own shapes at full width, the lone layers' (cout 1 and 10), fewer rows
# than the cluster has blocks (m 3) and a ragged small one
SHAPES = [(1152, 128), (27, 128), (3, 128), (128, 1), (3072, 10), (300, 128), (40, 24)]
# the VJP's: those of the CIFAR critic and its lone layers, MNIST's ([25, 64],
# [1600, 64]) and a single element
VJP_SHAPES = [(1, 1), (3, 128), (27, 128), (128, 1), (300, 128), (1152, 128), (3072, 10),
              (25, 64), (1600, 64)]
F32 = np.float32


def _pair(m, cout, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(m, cout) / np.sqrt(m)).astype(F32), rs.randn(1, cout).astype(F32)


def _emulate_cluster(w, u0):
    """``csrc/sn.cu`` in numpy, float32 throughout: block r of the cluster
    owns the rows ``cluster_rows(m)[r]``; each block's partial of |a|² and of
    t = v W is folded over the eight ranks in rank order; empty row ranges
    contribute zeros."""
    m, cout = w.shape
    ranges = cluster_rows(m)
    a = [w[lo:hi] @ u0[0] for lo, hi in ranges]              # pass 1: rows are local
    ss = F32(0)
    for part in a:                                           # rank order
        ss = F32(ss + np.sum(part * part, dtype=F32))
    vnorm = F32(np.sqrt(ss) + F32(1e-12))
    v = [part / vnorm for part in a]
    t = np.zeros(cout, F32)
    for (lo, hi), vr in zip(ranges, v):                      # pass 2, rank order
        t = (t + vr @ w[lo:hi]).astype(F32)
    tnorm = F32(np.sqrt(np.sum(t * t, dtype=F32)) + F32(1e-12))
    u_new = t / tnorm
    sigma = np.sum(t * u_new, dtype=F32)
    return w / sigma, u_new[None, :], sigma


# ------------------------------------------------------- the cluster's split
@pytest.mark.parametrize("m,cout", SHAPES)
def test_cluster_split_emulation_matches_sn_fused_and_sn_math(m, cout):
    """Eight row ranges that partition [0, m) in order (some empty when
    m < 8), partial sums folded in rank order: W/σ and u' within 1e-5 of
    their scale and σ within 1e-5 relative of the Pallas kernel (interpret
    mode) and of ``sn_math``: float32 sums of up to 3072 terms in another
    order, ~sqrt(m)·2⁻²⁴ relative."""
    ranges = cluster_rows(m)
    assert len(ranges) == CLUSTER and ranges[0][0] == 0 and ranges[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(hi >= lo for lo, hi in ranges)
    assert (m >= CLUSTER) or any(hi == lo for lo, hi in ranges)
    w, u0 = _pair(m, cout, m + cout)
    got = _emulate_cluster(w, u0)
    for ref_fn in (sn_fused, sn_math):
        wbar_r, u_r, sigma_r = (np.asarray(a) for a in ref_fn(jnp.asarray(w), jnp.asarray(u0)))
        np.testing.assert_allclose(got[0], wbar_r, rtol=0, atol=1e-5 * np.abs(wbar_r).max())
        np.testing.assert_allclose(got[1], u_r, rtol=0, atol=1e-5 * np.abs(u_r).max())
        np.testing.assert_allclose(got[2], float(sigma_r), rtol=1e-5)


def test_group_shared_memory_holds_a_d_pass_on_chip():
    """The capacities the wrapper hands the kernel: multiples of 4 floats,
    within 200 KB; for a D pass at full width every block's rows fit its
    tile (144 x 128 floats), so W is read from device memory once; a range
    too long for the tile or for v's buffer is capped, not refused."""
    d_pass = [(3, 128), (27, 128), (128, 128), (128, 1)] + [(1152, 128)] * 11
    t_cap, v_cap, tile_cap = group_smem(d_pass)
    assert (t_cap, v_cap, tile_cap) == (128, 144, 144 * 128)
    for shapes in (d_pass, [(3072, 10)], [(1, 1)], [(5, 3), (7, 129)], [(10 ** 6, 64)],
                   [(8, 16384)]):
        caps = group_smem(shapes)
        assert all(c % 4 == 0 and c >= 0 for c in caps) and sum(caps) <= 50 * 1024
        assert caps[0] >= max(cout for _, cout in shapes)
    assert group_smem([(10 ** 6, 64)])[1] == 8192          # v parked in W/σ beyond this
    assert group_smem([(10 ** 6, 64)])[2] < 125000 * 64    # rows re-read from L2


# ----------------------------------------------------------- a group on CPU
def test_group_of_mixed_shapes_equals_plain_per_weight_bit_for_bit():
    pairs = [tuple(torch.from_numpy(a) for a in _pair(m, cout, i))
             for i, (m, cout) in enumerate(SHAPES)]
    before = runtime.launch_counts()
    out = spectral_norm_group(pairs)
    assert runtime.launch_counts() == before  # the CPU route launches nothing
    assert len(out) == len(pairs) and spectral_norm_group([]) == []
    for (w, u), got in zip(pairs, out):
        want = sn_plain(w, u)
        assert all(torch.equal(g, r) for g, r in zip(got, want))
        assert all(torch.equal(g, r) for g, r in zip(spectral_norm(w, u), want))


def test_group_backward_runs_only_for_weights_that_need_it(monkeypatch):
    """One autograd function for the group; its backward re-runs the plain
    version under grad per weight whose gradient is asked for, and gives
    each the gradient a group of one gives."""
    pairs = [tuple(torch.from_numpy(a) for a in _pair(m, cout, i))
             for i, (m, cout) in enumerate([(40, 24), (12, 5), (9, 1)])]
    ws = [w.clone().requires_grad_(i != 1) for i, (w, _) in enumerate(pairs)]
    rs = [torch.randn(w.shape, generator=torch.Generator().manual_seed(i))
          for i, w in enumerate(ws)]
    out = spectral_norm_group([(w, u) for w, (_, u) in zip(ws, pairs)])
    calls = []
    real = sn_kernel.sn_plain
    monkeypatch.setattr(sn_kernel, "sn_plain", lambda w, u: calls.append(w.shape) or real(w, u))
    sum(torch.sum(o[0] * r) for o, r in zip(out, rs)).backward()
    assert calls == [torch.Size([40, 24]), torch.Size([9, 1])]
    assert ws[1].grad is None
    monkeypatch.undo()
    for i in (0, 2):
        w = pairs[i][0].clone().requires_grad_(True)
        torch.sum(spectral_norm(w, pairs[i][1])[0] * rs[i]).backward()
        assert torch.equal(ws[i].grad, w.grad)


# ------------------------------------------------------------------ the VJP
def _cotangents(m, cout, seed, full):
    """Ḡ always; g_u and g_σ too when ``full``, else None (zero)."""
    rs = np.random.RandomState(1000 + seed)
    gbar = torch.from_numpy(rs.randn(m, cout).astype(F32))
    if not full:
        return gbar, None, None
    return (gbar, torch.from_numpy(rs.randn(1, cout).astype(F32)),
            torch.tensor(rs.randn(), dtype=torch.float32))


def _vjp_scale(dw, gbar, sigma):
    """The size of dW's terms: dW itself, or Ḡ/σ where the terms cancel
    (a [1, 1] weight's dW is zero)."""
    return max(float(dw.abs().max()), float(gbar.abs().max() / abs(sigma)))


@pytest.mark.parametrize("full", [False, True], ids=["gbar", "gbar_gu_gsigma"])
@pytest.mark.parametrize("m,cout", VJP_SHAPES)
def test_vjp_plain_matches_autograd_of_sn_plain(m, cout, full):
    """The closed form against autograd's VJP of ``sn_plain`` through the
    power iteration, with Ḡ alone and with all three cotangents: within
    2e-6 of the terms' size.  Both are float32 sums of up to 3072 terms in
    other orders; each lies 0.5-2e-7 of that size from the float64 VJP."""
    w, u0 = (torch.from_numpy(a) for a in _pair(m, cout, m + cout))
    cts = _cotangents(m, cout, m + cout, full)
    x = w.clone().requires_grad_(True)
    keep = [(o, c) for o, c in zip(sn_plain(x, u0), cts) if c is not None]
    (want,) = torch.autograd.grad([o for o, _ in keep], (x,), [c for _, c in keep])
    got = sn_vjp_plain(w, u0, *cts)
    assert got.dtype == torch.float32 and got.shape == w.shape
    scale = _vjp_scale(want, cts[0], float(sn_plain(w, u0)[2]))
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6 * scale)


def _jax_vjp(w, u0, gbar, gu, gsigma):
    """JAX's VJP of ``sn_math`` with respect to W (the TPU kernel's
    ``_bwd``), the cotangents None for zero, as numpy float32."""
    outs, vjp = jax.vjp(sn_math, jnp.asarray(w), jnp.asarray(u0))
    cts = tuple(jnp.zeros_like(o) if c is None else jnp.asarray(np.asarray(c, dtype=F32))
                for o, c in zip(outs, (gbar, gu, gsigma)))
    return np.asarray(vjp(cts)[0])


@pytest.mark.parametrize("full", [False, True], ids=["gbar", "gbar_gu_gsigma"])
@pytest.mark.parametrize("m,cout", VJP_SHAPES)
def test_vjp_plain_matches_jax_vjp_of_sn_math(m, cout, full):
    """The closed form against the JAX package's VJP of ``sn_math`` through
    the power iteration (``jax.vjp``, as ``sn_fused``'s ``_bwd`` takes it),
    with Ḡ alone and with all three cotangents: within 2e-6 of the terms'
    size, as against autograd."""
    w, u0 = _pair(m, cout, m + cout)
    cts = _cotangents(m, cout, m + cout, full)
    want = _jax_vjp(w, u0, *cts)
    got = sn_vjp_plain(torch.from_numpy(w), torch.from_numpy(u0), *cts)
    scale = _vjp_scale(torch.from_numpy(want), cts[0],
                       float(sn_plain(torch.from_numpy(w), torch.from_numpy(u0))[2]))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6 * scale)


def _emulate_vjp_cluster(w, u0, gbar, gu, gsigma):
    """``csrc/sn.cu``'s ``sn_group_kernel_vjp`` in numpy, float32: block r
    owns the rows ``cluster_rows(m)[r]``; |a|², Σ Ḡ⊙W, t and a · v̄ are
    folded over the eight ranks in rank order; t̄ from t alone."""
    m, cout = w.shape
    ranges = cluster_rows(m)
    a = [w[lo:hi] @ u0[0] for lo, hi in ranges]
    ss, gw = F32(0), F32(0)
    for (lo, hi), ar in zip(ranges, a):
        ss = F32(ss + np.sum(ar * ar, dtype=F32))
        gw = F32(gw + np.sum(gbar[lo:hi] * w[lo:hi], dtype=F32))
    anorm = F32(np.sqrt(ss))
    an = F32(anorm + F32(1e-12))
    t = np.zeros(cout, F32)
    for (lo, hi), ar in zip(ranges, a):
        t = (t + (ar / an) @ w[lo:hi]).astype(F32)
    tnorm = F32(np.sqrt(np.sum(t * t, dtype=F32)))
    tn = F32(tnorm + F32(1e-12))
    sigma = np.sum(t * (t / tn), dtype=F32)
    sbar = F32((0 if gsigma is None else gsigma) - gw / (sigma * sigma))
    ubar = (0 if gu is None else gu[0]) + sbar * t
    tbar = sbar * (t / tn) + ubar / tn - t * (np.sum(t * ubar, dtype=F32) / (tn * tn * tnorm))
    vbar = [w[lo:hi] @ tbar for lo, hi in ranges]
    av = F32(0)
    for ar, vr in zip(a, vbar):
        av = F32(av + np.sum(ar * vr, dtype=F32))
    c_a = av / (an * an * anorm)
    return np.concatenate([gbar[lo:hi] / sigma + np.outer(ar / an, tbar)
                           + np.outer(vr / an - ar * c_a, u0[0])
                           for (lo, hi), ar, vr in zip(ranges, a, vbar)]).astype(F32)


@pytest.mark.parametrize("m,cout", SHAPES)
def test_vjp_cluster_split_emulation_matches_the_closed_form(m, cout):
    """The VJP kernel's split (eight row ranges, some empty when m < 8; the
    cluster's partials in rank order; t̄ per block from t) against
    ``sn_vjp_plain`` and against JAX's VJP of ``sn_math``, with all three
    cotangents: within 2e-6 of the terms' size, as the closed form against
    autograd."""
    w, u0 = _pair(m, cout, m + cout)
    gbar, gu, gsigma = _cotangents(m, cout, m + cout, True)
    got = _emulate_vjp_cluster(w, u0, gbar.numpy(), gu.numpy(), F32(gsigma))
    want = sn_vjp_plain(torch.from_numpy(w), torch.from_numpy(u0), gbar, gu, gsigma)
    scale = _vjp_scale(want, gbar, float(sn_plain(torch.from_numpy(w), torch.from_numpy(u0))[2]))
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=2e-6 * scale)
    np.testing.assert_allclose(got, _jax_vjp(w, u0, gbar, gu, gsigma), rtol=0,
                               atol=2e-6 * scale)


def test_vjp_shared_memory_holds_a_d_pass_and_caps_the_rest():
    """The VJP's capacities: multiples of 4 floats within 200 KB; at a D
    pass every block's rows of W and of Ḡ fit their tiles (144 x 128 each)
    and a, ā their row vectors, so no scratch; a range longer than the row
    vectors takes 2 m floats of scratch a weight of the launch; the widest
    cout leaves room for 1024 rows."""
    d_pass = [(3, 128), (27, 128), (128, 128), (128, 1)] + [(1152, 128)] * 11
    caps = vjp_smem(d_pass)
    assert caps == (128, 144, 144 * 128) and vjp_scratch(d_pass, caps[1]) == 0
    for shapes in (d_pass, [(3072, 10)], [(1, 1)], [(5, 3), (7, 129)], [(10 ** 6, 64)],
                   [(8, 16384)], [(9000, 16384)], [(1600, 64)] * 3 + [(25, 64)]):
        col, row, tile = vjp_smem(shapes)
        assert all(c % 4 == 0 and c >= 0 for c in (col, row, tile))
        assert 3 * col + 2 * row + 2 * tile <= 50 * 1024
        assert col >= max(cout for _, cout in shapes) and row > 0
    assert vjp_smem([(9000, 16384)])[1:] == (1024, 0)
    assert vjp_scratch([(9000, 16384)], 1024) == 2 * 9000       # 1125 rows a block
    assert vjp_scratch([(10 ** 6, 64), (3, 128)], 8192) == 2 * (10 ** 6 + 3)


# -------------------------------------------- the discriminator's one group
def _count_groups(monkeypatch):
    sizes = []
    real = tsn.spectral_norm_group
    monkeypatch.setattr(tsn, "spectral_norm_group",
                        lambda pairs: sizes.append(len(pairs)) or real(pairs))
    return sizes


@pytest.mark.parametrize("update_sn", [True, False])
def test_discriminator_group_matches_jax_with_u_chained_over_two_calls(update_sn, monkeypatch):
    """``Discriminator.forward`` does the step of its 15 layers as one group
    at its start.  Two forwards in one JAX context chain each ``u`` through
    the state (the second reads what the first wrote), or leave it alone
    with ``update_sn`` off: features and wgan logits of both calls to 1e-4
    of their scale (float32, twelve convs deep), each ``u`` to 1e-6."""
    rs = np.random.RandomState(8)
    xs = [rs.uniform(-1, 1, (3, CFG.output_dim)).astype(F32) for _ in range(2)]
    disc = trg.Discriminator(CFG, seed=2)
    params, state = perturbed_trees(disc, 8)
    ctx = Ctx(params=params, state=state, update_sn=update_sn)
    refs = [jrg.discriminator(ctx, JCFG, jnp.asarray(x), None) for x in xs]
    ref_state = ctx.updated_state()

    sizes = _count_groups(monkeypatch)
    with torch.no_grad(), sn_updates(disc, update_sn):
        outs = [disc(torch.from_numpy(x), None) for x in xs]
    assert sizes == [15, 15]
    assert not any(tsn._SLOT in m.__dict__ for m in disc.modules())
    for out, ref in zip(outs, refs):
        for got, want in zip(out, ref):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    for layer, d in state_tree(disc).items():
        np.testing.assert_allclose(d["u"].numpy(), np.asarray(ref_state[layer]["u"]), rtol=0,
                                   atol=1e-6, err_msg=layer)
        if not update_sn:
            np.testing.assert_array_equal(d["u"].numpy(), state[layer]["u"])


def test_prepared_slots_are_taken_once_and_cleared_when_a_forward_raises(monkeypatch):
    """A layer with a prepared slot takes it and empties it; without one it
    does its own group of one; a forward that raises midway leaves no slot
    behind for a later call to pick up."""
    sizes = _count_groups(monkeypatch)
    layer = tlinear.LinearLib(8, 4, "lin", spectral_normed=True)
    x = torch.randn(3, 8)
    with torch.no_grad():
        want = sn_plain(layer.W.detach(), layer.u)[0]
        tsn.prepare_spectral_norms([layer])
        assert tsn._SLOT in layer.__dict__ and sizes == [1]
        u_after = layer.u
        first = layer(x)
        assert tsn._SLOT not in layer.__dict__ and sizes == [1] and layer.u is u_after
        torch.testing.assert_close(first, x @ want + layer.b)
        layer(x)
        assert sizes == [1, 1]  # its own group of one, u advanced again
        assert layer.u is not u_after

    disc = trg.Discriminator(CFG, seed=2)
    monkeypatch.setattr(disc.blocks[2], "forward", lambda *a: (_ for _ in ()).throw(KeyError("x")))
    with torch.no_grad(), pytest.raises(KeyError):
        disc(torch.zeros(2, CFG.output_dim), None)
    assert not any(tsn._SLOT in m.__dict__ for m in disc.modules())


# ------------------------------------------------ the wrapper's CUDA branch
class _FakeSnLibrary:
    """Stands in for ``csrc/sn.cu``'s library: records each launch's group
    descriptor (copied out of the caller's memory) and arguments, the
    forward's in ``launches`` and the VJP's in ``vjp_launches``."""

    def __init__(self, code=0, group_bytes=None, vjp_bytes=None, vjp_code=0):
        self.launches, self.vjp_launches = [], []
        self.sn_group_f32 = self._Fn(self.launches, sn_kernel._SnGroup, code)
        self.sn_vjp_f32 = self._Fn(self.vjp_launches, sn_kernel._SnVjpGroup, vjp_code)
        self.sn_group_bytes = lambda: (ctypes.sizeof(sn_kernel._SnGroup)
                                       if group_bytes is None else group_bytes)
        self.sn_vjp_bytes = lambda: (ctypes.sizeof(sn_kernel._SnVjpGroup)
                                     if vjp_bytes is None else vjp_bytes)
        self.sn_max_weights = lambda: MAX_WEIGHTS
        self.sn_error_string = lambda code: b"too many resources requested for launch"

    class _Fn:
        def __init__(self, log, struct, code):
            self.log, self.struct, self.code = log, struct, code
            self.argtypes = self.restype = None

        def __call__(self, addr, n, smem_bytes, stream):
            group = self.struct.from_buffer_copy(ctypes.string_at(addr, ctypes.sizeof(self.struct)))
            self.log.append((group, n, smem_bytes, stream))
            return self.code


def _fake_sn(monkeypatch, **kw):
    lib = _FakeSnLibrary(**kw)
    monkeypatch.setattr(runtime, "on_cuda", lambda *ts: True)
    cuda_impls_on_cpu(monkeypatch, "sn_group")
    monkeypatch.setattr(runtime, "cuda_library", lambda name: lib)
    monkeypatch.setattr(runtime, "on_device", lambda t, f, *args: f(*args, 7))
    for plain in ("sn_plain", "sn_vjp_plain"):
        monkeypatch.setattr(sn_kernel, plain,
                            lambda *a: (_ for _ in ()).throw(AssertionError("fell back")))
    runtime.reset_launch_counts()
    return lib


def test_group_wrapper_fills_one_struct_and_counts_one_launch(monkeypatch):
    """A group reaches the entry point as one struct: per weight the pointers
    of W and u0 as given, of W/σ, u' and σ as returned, and m and cout; then
    the weight count, the shared-memory bytes of ``group_smem`` and the
    stream.  One launch, one count; more than ``MAX_WEIGHTS`` weights take a
    second launch."""
    lib = _fake_sn(monkeypatch)
    shapes = [(1152, 128), (27, 128), (128, 1), (5, 3)]
    pairs = [tuple(torch.from_numpy(a) for a in _pair(m, c, i)) for i, (m, c) in enumerate(shapes)]
    out = spectral_norm_group(pairs)
    assert runtime.launch_counts()["sn"] == 1 and len(lib.launches) == 1
    group, n, smem_bytes, stream = lib.launches[0]
    caps = group_smem(shapes)
    assert (n, stream) == (4, 7) and smem_bytes == 4 * sum(caps)
    assert (group.t_cap, group.v_cap, group.tile_cap) == caps
    for d, (w, u), (wbar, u_new, sigma) in zip(group.w, pairs, out):
        assert (d.w, d.u0, d.m, d.cout) == (w.data_ptr(), u.data_ptr(), *w.shape)
        assert (d.wbar, d.u_new, d.sigma) == (wbar.data_ptr(), u_new.data_ptr(),
                                              sigma.data_ptr())
        assert wbar.shape == w.shape and u_new.shape == u.shape and sigma.shape == ()
    assert lib.sn_group_f32.argtypes is not None

    many = [tuple(torch.from_numpy(a) for a in _pair(4, 4, i)) for i in range(MAX_WEIGHTS + 3)]
    runtime.reset_launch_counts()
    lib.launches.clear()
    assert len(spectral_norm_group(many)) == MAX_WEIGHTS + 3
    assert [la[1] for la in lib.launches] == [MAX_WEIGHTS, 3]
    assert runtime.launch_counts()["sn"] == 2
    assert lib.launches[1][0].w[0].w == many[MAX_WEIGHTS][0].data_ptr()


def test_group_wrapper_raises_with_no_fallback(monkeypatch):
    """A launch error, a library whose descriptor differs, a failing build
    and inputs the kernel does not take all raise; the plain version is
    never called and nothing is counted."""
    w, u = (torch.from_numpy(a) for a in _pair(12, 8, 0))
    _fake_sn(monkeypatch, code=701)
    with pytest.raises(RuntimeError, match="too many resources"):
        spectral_norm(w, u)
    _fake_sn(monkeypatch, group_bytes=8)
    with pytest.raises(RuntimeError, match="descriptor"):
        spectral_norm(w, u)
    lib = _fake_sn(monkeypatch)
    with pytest.raises(TypeError, match="float32"):
        spectral_norm(w.double(), u.double())
    with pytest.raises(ValueError, match=r"\[m, cout\]"):
        spectral_norm(w, u[0])
    with pytest.raises(ValueError, match="contiguous"):
        spectral_norm(w.t().contiguous().t(), u)
    assert lib.launches == []

    def broken_build(name):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(runtime, "cuda_library", broken_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        spectral_norm(w, u)
    assert runtime.launch_counts()["sn"] == 0


# --------------------------------------------- the backward's CUDA branch
def _vjp_through_fake(shapes, needs, full=()):
    """A group of ``shapes`` through the faked forward, the gradient of a
    loss over its W/σ (and over u' and σ of the weights in ``full``) taken
    for the weights in ``needs``: ``(ws, us, the cotangents autograd handed
    the backward by weight, the gradients)``."""
    pairs = [tuple(torch.from_numpy(a) for a in _pair(m, c, i)) for i, (m, c) in enumerate(shapes)]
    ws = [w.clone().requires_grad_(i in needs) for i, (w, _) in enumerate(pairs)]
    us = [u for _, u in pairs]
    out = spectral_norm_group(list(zip(ws, us)))
    seen = {}
    loss = 0
    for i, (wbar, u_new, sigma) in enumerate(out):
        parts = [wbar] + ([u_new, sigma] if i in full else [])
        for k, o in enumerate(parts):
            o.register_hook(lambda g, key=(i, k): seen.update({key: g}))
            loss = loss + torch.sum(o * (k + 1.5))
    grads = torch.autograd.grad(loss, [ws[i] for i in sorted(needs)])
    return ws, us, seen, grads


def test_group_backward_fills_one_struct_and_counts_one_launch(monkeypatch):
    """The backward's launch on the card: one struct for the weights that
    need a gradient, in order, with the pointers of W and u0 as saved, of
    the cotangents autograd handed it (null for u' and σ where they have
    none) and of the dW returned, m and cout; the weight count, the
    shared-memory bytes of ``vjp_smem`` and the stream; no scratch where the
    rows fit.  One launch, one ``sn_bwd`` count; more than ``MAX_WEIGHTS``
    weights take a second launch; a row range beyond the row vectors takes
    scratch."""
    lib = _fake_sn(monkeypatch)
    shapes = [(1152, 128), (27, 128), (128, 1), (5, 3)]
    ws, us, seen, grads = _vjp_through_fake(shapes, needs={0, 2, 3}, full={2})
    assert runtime.launch_counts()["sn_bwd"] == 1 and len(lib.vjp_launches) == 1
    assert runtime.launch_counts()["sn"] == 1
    group, n, smem_bytes, stream = lib.vjp_launches[0]
    kept = [shapes[i] for i in (0, 2, 3)]
    caps = vjp_smem(kept)
    assert (n, stream) == (3, 7) and (group.col_cap, group.row_cap, group.tile_cap) == caps
    assert smem_bytes == 4 * (3 * caps[0] + 2 * caps[1] + 2 * caps[2]) and not group.scratch
    for d, i, g in zip(group.w, (0, 2, 3), grads):
        assert (d.w, d.u0, d.m, d.cout) == (ws[i].data_ptr(), us[i].data_ptr(), *shapes[i])
        assert d.gbar == seen[(i, 0)].data_ptr() and d.dw == g.data_ptr()
        assert g.shape == ws[i].shape and g.dtype == torch.float32
        if i == 2:
            assert (d.gu, d.gsigma) == (seen[(i, 1)].data_ptr(), seen[(i, 2)].data_ptr())
        else:
            assert not d.gu and not d.gsigma
    assert lib.sn_vjp_f32.argtypes is not None

    runtime.reset_launch_counts()
    lib.vjp_launches.clear()
    many = [(4, 4)] * (MAX_WEIGHTS + 3)
    _vjp_through_fake(many, needs=set(range(len(many))))
    assert [la[1] for la in lib.vjp_launches] == [MAX_WEIGHTS, 3]
    assert runtime.launch_counts()["sn_bwd"] == 2

    lib.vjp_launches.clear()
    _vjp_through_fake([(100000, 3), (9, 2)], needs={0, 1})
    group = lib.vjp_launches[0][0]
    assert group.row_cap < 12500 and group.scratch  # 2 (100000 + 9) floats


def test_group_backward_raises_with_no_fallback(monkeypatch):
    """The backward's launch error, a library whose VJP descriptor differs,
    a failing build and a cotangent the kernel does not take all raise;
    the plain VJP is never called and no ``sn_bwd`` is counted."""
    for kw, match in (({"vjp_code": 701}, "too many resources"), ({"vjp_bytes": 8}, "descriptor")):
        _fake_sn(monkeypatch, **kw)
        with pytest.raises(RuntimeError, match=match):
            _vjp_through_fake([(12, 8)], needs={0})
    w, u = (torch.from_numpy(a) for a in _pair(12, 8, 0))
    _fake_sn(monkeypatch)
    with pytest.raises(TypeError, match="float32 cotangent"):
        sn_kernel._launch_vjp([(w, u, torch.ones(12, 8, dtype=torch.float64), None, None)])
    with pytest.raises(TypeError, match="float32 cotangent"):
        sn_kernel._launch_vjp([(w, u, torch.ones(12, 8), torch.ones(8), None)])
    out = spectral_norm(w.clone().requires_grad_(True), u)

    def broken_build(name):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(runtime, "cuda_library", broken_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        out[0].sum().backward()
    assert runtime.launch_counts()["sn_bwd"] == 0
