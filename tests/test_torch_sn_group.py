"""The grouped spectral-norm kernel's Python side, on the CPU: a numpy
emulation of the kernel's cluster split against the JAX package's
``sn_fused`` (Pallas, interpret mode) and ``sn_math``; a group against the
plain version per weight; the discriminator's one group per forward against
JAX's ``discriminator`` with ``u`` chained; and the CUDA branch of the
wrapper against a fake library (the descriptor struct, the launch count, no
fallback).  Inputs come from numpy seeds; float32; tolerances per test.
"""

import ctypes

import numpy as np
import pytest

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
                                                   group_smem, sn_plain, spectral_norm,
                                                   spectral_norm_group)
from torch_parity import TINY, perturbed_trees

torch.set_num_threads(min(2, torch.get_num_threads()))

CFG = trg.ResnetGANConfig(**TINY)
JCFG = jrg.ResnetGANConfig(**TINY)
# D's own shapes at full width, the lone layers' (cout 1 and 10), fewer rows
# than the cluster has blocks (m 3) and a ragged small one
SHAPES = [(1152, 128), (27, 128), (3, 128), (128, 1), (3072, 10), (300, 128), (40, 24)]
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
    descriptor (copied out of the caller's memory) and arguments."""

    def __init__(self, code=0, group_bytes=None):
        self.launches, self.code = [], code
        self.sn_group_f32 = self._Fn(self)
        self.sn_group_bytes = lambda: (ctypes.sizeof(sn_kernel._SnGroup)
                                       if group_bytes is None else group_bytes)
        self.sn_max_weights = lambda: MAX_WEIGHTS
        self.sn_error_string = lambda code: b"too many resources requested for launch"

    class _Fn:
        def __init__(self, lib):
            self.lib, self.argtypes, self.restype = lib, None, None

        def __call__(self, addr, n, smem_bytes, stream):
            group = sn_kernel._SnGroup.from_buffer_copy(
                ctypes.string_at(addr, ctypes.sizeof(sn_kernel._SnGroup)))
            self.lib.launches.append((group, n, smem_bytes, stream))
            return self.lib.code


def _fake_sn(monkeypatch, **kw):
    lib = _FakeSnLibrary(**kw)
    monkeypatch.setattr(runtime, "on_cuda", lambda *ts: True)
    monkeypatch.setattr(runtime, "cuda_library", lambda name: lib)
    monkeypatch.setattr(runtime, "on_device", lambda t, f, *args: f(*args, 7))
    monkeypatch.setattr(sn_kernel, "sn_plain",
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
