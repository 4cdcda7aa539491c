"""The spectral-norm and all-label projection kernels' plain versions and
autograd functions, the SN layers and their ``u`` state, against the JAX
package, on the CPU, in float32; and the CUDA branch of the conv3x3 and
cond-BN wrappers in grad mode, with the launch mocked.

The Pallas kernels run in interpret mode (their CPU route), as
tests/test_pallas.py runs them.  Inputs come from numpy seeds.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rcgan_tpu.core.module import Ctx
from rcgan_tpu.ops import conv as jconv
from rcgan_tpu.ops.linear import linear_lib as jlinear_lib
from rcgan_tpu.ops.pallas.projection_kernel import all_label_projection_logits as jproj
from rcgan_tpu.ops.pallas.sn_kernel import sn_fused
from rcgan_tpu_torch.bridge import load_tree, to_jax_tree
from rcgan_tpu_torch.core.module import sn_updates, state_tree
from rcgan_tpu_torch.ops import conv as tconv
from rcgan_tpu_torch.ops import linear as tlinear
from rcgan_tpu_torch.ops.kernels import conv_kernel, norm_kernel, projection_kernel, runtime
from rcgan_tpu_torch.ops.kernels.projection_kernel import (ProjectionLogitsFn,
                                                           all_label_projection_logits,
                                                           projection_plain)
from rcgan_tpu_torch.ops.kernels.sn_kernel import (SpectralNormGroupFn, sn_plain,
                                                   spectral_norm)
from torch_parity import cuda_impls_on_cpu

torch.set_num_threads(min(2, torch.get_num_threads()))

# every m x cout on the CIFAR D path, plus a ragged small one
SN_SHAPES = [(3, 128), (27, 128), (1152, 128), (128, 1), (300, 128), (3072, 10), (40, 24)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------- spectral norm
@pytest.mark.parametrize("m,cout", SN_SHAPES)
def test_sn_plain_matches_sn_fused(m, cout):
    """float32 on both sides; the GEMVs sum up to 3072 terms in another
    order (~sqrt(m) * 2^-24 relative), so W/σ and u' agree to 1e-5 of their
    scale and σ to 1e-5 relative."""
    rs = np.random.RandomState(m + cout)
    w = (rs.randn(m, cout) / np.sqrt(m)).astype(np.float32)
    u0 = rs.randn(1, cout).astype(np.float32)
    wbar_r, u_r, sigma_r = (np.asarray(a) for a in sn_fused(jnp.asarray(w), jnp.asarray(u0)))
    wbar, u_new, sigma = sn_plain(_t(w), _t(u0))
    assert wbar.shape == (m, cout) and u_new.shape == (1, cout) and sigma.shape == ()
    np.testing.assert_allclose(wbar.numpy(), wbar_r, rtol=0, atol=1e-5 * np.abs(wbar_r).max())
    np.testing.assert_allclose(u_new.numpy(), u_r, rtol=0, atol=1e-5 * np.abs(u_r).max())
    np.testing.assert_allclose(sigma.item(), float(sigma_r), rtol=1e-5)
    # the autograd route gives the plain version's values on the CPU
    for a, b in zip(spectral_norm(_t(w), _t(u0)), (wbar, u_new, sigma)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("all_outputs", [False, True])
def test_sn_gradient_flows_through_the_power_iteration(all_outputs):
    """d/dW of sum(W/σ·R) (and, with all_outputs, of σ and u' too) through
    SpectralNormGroupFn (a group of one) against jax.grad through sn_fused,
    whose VJP re-runs sn_math: 1e-4 of the gradient's scale (float32, a few
    hundred terms per entry in another order).  u0 gets no gradient."""
    rs = np.random.RandomState(7)
    w = rs.randn(40, 24).astype(np.float32)
    u0 = rs.randn(1, 24).astype(np.float32)
    r = rs.randn(40, 24).astype(np.float32)
    r2 = rs.randn(1, 24).astype(np.float32)

    def jloss(w):
        wbar, u_new, sigma = sn_fused(w, jnp.asarray(u0))
        out = jnp.sum(wbar * r)
        return out + 0.7 * sigma + jnp.sum(u_new * r2) if all_outputs else out

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(w)))
    wt = _t(w).requires_grad_(True)
    ut = _t(u0).requires_grad_(True)
    wbar, u_new, sigma = SpectralNormGroupFn.apply(wt, ut)
    loss = torch.sum(wbar * _t(r))
    if all_outputs:
        loss = loss + 0.7 * sigma + torch.sum(u_new * _t(r2))
    loss.backward()
    assert ut.grad is None
    np.testing.assert_allclose(wt.grad.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    # Miyato's stop-gradient (σ treated as a constant) would differ here
    miyato = r / float(sn_fused(jnp.asarray(w), jnp.asarray(u0))[2])
    assert np.abs(miyato - ref).max() > 1e-2 * np.abs(ref).max()


def _sn_conv_tree(cin, cout, k, rs):
    layer = tconv.Conv2dLib(cin, cout, k, "conv", spectral_normed=True, seed=k)
    params, state = to_jax_tree(layer)
    params["conv"]["Biases"] = rs.randn(cout).astype(np.float32)
    return params, state


@pytest.mark.parametrize("update_sn", [True, False])
@pytest.mark.parametrize("k", [3, 1])
def test_sn_conv2d_lib_matches_jax(update_sn, k):
    """conv2d_lib(spectral_normed=True): the output to 1e-5 abs (O(1)
    values, float32) and the u left in the state: advanced to u' with
    update_sn, untouched without."""
    rs = np.random.RandomState(11 + k)
    cin, cout = 5, 12
    x = rs.randn(2, 6, 6, cin).astype(np.float32)
    params, state = _sn_conv_tree(cin, cout, k, rs)
    ctx = Ctx(params=params, state=state, update_sn=update_sn)
    ref = jconv.conv2d_lib(ctx, jnp.asarray(x), cin, cout, k, 1, "conv", spectral_normed=True)
    ref_state = jax.tree_util.tree_map(np.asarray, ctx.updated_state())

    layer = load_tree(tconv.Conv2dLib(cin, cout, k, "conv", spectral_normed=True),
                      params, state, prefix="")
    with torch.no_grad(), sn_updates(layer, update_sn):
        out = layer(_t(x))
    assert layer.update_sn  # restored
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    got = state_tree(layer)["conv"]["u"].numpy()
    np.testing.assert_allclose(got, ref_state["conv"]["u"], rtol=0, atol=1e-6)
    if not update_sn:
        np.testing.assert_array_equal(got, state["conv"]["u"])


def test_sn_linear_lib_matches_jax_and_chains():
    """linear_lib(spectral_normed=True) called twice in one forward: the
    second call reads the u the first wrote, as JAX's Ctx.stat chains
    through new_state.  Outputs to 1e-5 abs, u to 1e-6 abs."""
    rs = np.random.RandomState(12)
    x1, x2 = (rs.randn(4, 20).astype(np.float32) for _ in range(2))
    layer = tlinear.LinearLib(20, 6, "lin", spectral_normed=True, seed=3)
    params, state = to_jax_tree(layer)
    params["lin"]["b"] = rs.randn(6).astype(np.float32)
    ctx = Ctx(params=params, state=state)
    refs = [np.asarray(jlinear_lib(ctx, jnp.asarray(x), 20, 6, "lin", spectral_normed=True))
            for x in (x1, x2)]
    ref_u = np.asarray(ctx.updated_state()["lin"]["u"])

    layer = load_tree(layer, params, state, prefix="")
    with torch.no_grad():
        outs = [layer(_t(x)).numpy() for x in (x1, x2)]
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(layer.u.numpy(), ref_u, rtol=0, atol=1e-6)


def test_sn_u_update_is_refused_under_inference_mode_and_survives_backward():
    """u is rebound, never written in place: a backward after the update
    still sees the u it saved.  An update under inference_mode would keep
    an inference tensor as state, so it raises; a frozen u is fine."""
    layer = tlinear.LinearLib(8, 4, "lin", spectral_normed=True)
    u_before = layer.u
    x = torch.randn(3, 8)
    layer(x).sum().backward()  # grad mode, update on
    assert layer.W.grad is not None and not torch.equal(layer.u, u_before)
    with torch.inference_mode():
        with pytest.raises(RuntimeError, match="inference_mode"):
            layer(x)
        with sn_updates(layer, False):
            layer(x)
    assert not layer.u.is_inference()


def test_spectral_normed_weight_with_sigma_and_num_iters():
    """with_sigma returns σ beside W/σ (JAX's with_sigma); num_iters > 1
    runs JAX's power-iteration loop in plain PyTorch (here against the same
    loop in numpy; ``tests/test_torch_ops_leftovers.py`` holds it to JAX's)
    and advances u."""
    from rcgan_tpu_torch.ops.sn import spectral_normed_weight

    layer = tlinear.LinearLib(8, 4, "lin", spectral_normed=True)
    want = sn_plain(layer.W.detach(), layer.u)
    with torch.no_grad():
        w_bar, sigma = spectral_normed_weight(layer, layer.W, with_sigma=True)
    assert torch.equal(w_bar, want[0]) and torch.equal(sigma, want[2])
    w, u = layer.W.detach().numpy().astype(np.float64), layer.u.numpy().astype(np.float64)
    for _ in range(2):
        v = u @ w.T / (np.linalg.norm(u @ w.T) + 1e-12)
        u = v @ w / (np.linalg.norm(v @ w) + 1e-12)
    with torch.no_grad():
        w_bar, sigma = spectral_normed_weight(layer, layer.W, num_iters=2, with_sigma=True)
    np.testing.assert_allclose(sigma.item(), (v @ w @ u.T)[0, 0], rtol=1e-5)
    np.testing.assert_allclose(w_bar.numpy(), w / (v @ w @ u.T)[0, 0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(layer.u.numpy(), u, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- projection
@pytest.mark.parametrize("b,d,v", [(64, 128, 10), (6, 16, 10), (5, 24, 3)])
def test_projection_plain_and_grads_match_interpret(b, d, v):
    """all_label_projection_logits: values to 1e-5 of scale (float32 dots
    of d terms), and its three gradients through ProjectionLogitsFn against
    jax.grad through the Pallas kernel's VJP, to 1e-5 of scale."""
    rs = np.random.RandomState(b + d)
    feat = rs.randn(b, d).astype(np.float32)
    emb = rs.randn(v, d).astype(np.float32)
    wgan = rs.randn(b, 1).astype(np.float32)
    r = rs.randn(b, v).astype(np.float32)
    ref = np.asarray(jproj(jnp.asarray(feat), jnp.asarray(emb), jnp.asarray(wgan)))
    out = projection_plain(_t(feat), _t(emb), _t(wgan))
    assert out.dtype == torch.float32 and out.shape == (b, v)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())

    grads_ref = jax.grad(lambda f, e, w: jnp.sum(jnp.tanh(jproj(f, e, w)) * r),
                         argnums=(0, 1, 2))(jnp.asarray(feat), jnp.asarray(emb), jnp.asarray(wgan))
    ts = [_t(a).requires_grad_(True) for a in (feat, emb, wgan)]
    torch.sum(torch.tanh(all_label_projection_logits(*ts)) * _t(r)).backward()
    for t, g in zip(ts, grads_ref):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max())


def test_projection_bf16_cotangents_keep_their_primal_dtypes():
    """The JAX package's bf16 regression (tests/test_pallas.py): every
    cotangent carries its primal's dtype, here with the logits sliced as
    the unbiased all-label real pass slices them.  Values against float32
    math on the same bf16-rounded inputs, to one bf16 rounding (2^-8)."""
    rs = np.random.RandomState(0)
    feat, emb, wgan = (torch.from_numpy(rs.randn(*s).astype(np.float32)).to(torch.bfloat16)
                       .requires_grad_(True) for s in ((8, 16), (10, 16), (8, 1)))
    logits = ProjectionLogitsFn.apply(feat, emb, wgan)
    assert logits.dtype == torch.float32
    logits[:4].sum().backward()
    for t in (feat, emb, wgan):
        assert t.grad.dtype == torch.bfloat16
    g = torch.zeros(8, 10)
    g[:4] = 1.0
    want_dfeat = g @ emb.detach().float()
    np.testing.assert_allclose(feat.grad.float().numpy(), want_dfeat.numpy(),
                               rtol=2.0 ** -8, atol=1e-6)
    np.testing.assert_array_equal(wgan.grad.float().numpy(), g.sum(1, keepdim=True).numpy())


# ------------------------------------------------- the projection's wrapper
class _FakeFn:
    def __init__(self, code=0):
        self.argtypes = self.restype = None
        self.calls, self.code = [], code

    def __call__(self, *args):
        self.calls.append(args)
        return self.code


def _fake_projection_library(monkeypatch, code=0):
    """A fake of ``csrc/projection.cu``'s library behind the CUDA branch:
    ``on_cuda`` mocked true, the stream handle 7; returns (entry point,
    library lookups)."""
    fn = _FakeFn(code)
    lib = types.SimpleNamespace(projection_logits=fn,
                                projection_error_string=_FakeFn(b"an illegal memory access"))
    lookups = []
    monkeypatch.setattr(runtime, "on_cuda", lambda *ts: True)
    cuda_impls_on_cpu(monkeypatch, "projection_logits")
    monkeypatch.setattr(runtime, "cuda_library", lambda name: lookups.append(name) or lib)
    monkeypatch.setattr(runtime, "on_device", lambda t, f, *args: f(*args, 7))
    return fn, lookups


@pytest.mark.parametrize("dtypes,codes", [
    ((torch.float32,) * 3, (0, 0, 0)),
    ((torch.bfloat16,) * 3, (1, 1, 1)),
    ((torch.bfloat16, torch.float32, torch.float16), (1, 0, 2)),
])
def test_projection_wrapper_passes_pointers_dtype_codes_and_counts(monkeypatch, dtypes, codes):
    """Each call reaches the CUDA entry point with the pointers, each
    input's own dtype code, the float32 output, B, V, D and the stream, and
    counts one launch; the entry point's argtypes are set at its first use."""
    fn, lookups = _fake_projection_library(monkeypatch)
    runtime.reset_launch_counts()
    feat, emb, wgan = (torch.randn(*s).to(dt) for s, dt in zip(((64, 128), (10, 128), (64, 1)),
                                                              dtypes))
    outs = [all_label_projection_logits(feat, emb, wgan) for _ in range(2)]
    assert all(o.shape == (64, 10) and o.dtype == torch.float32 for o in outs)
    assert [c[6] for c in fn.calls] == [o.data_ptr() for o in outs]
    for c in fn.calls:
        assert c[:6] == (feat.data_ptr(), codes[0], emb.data_ptr(), codes[1], wgan.data_ptr(),
                         codes[2])
        assert c[7:] == (64, 10, 128, 7)
    assert lookups == ["projection"] * 2 and len(fn.argtypes) == 11
    assert runtime.launch_counts()["projection"] == 2


def test_projection_wrapper_raises_with_no_fallback(monkeypatch):
    """A launch error, a failing build, a feat off 16-byte alignment and a
    D that is not a multiple of 8 all raise: the plain version is never
    called, and nothing is counted."""
    fn, _ = _fake_projection_library(monkeypatch, code=700)

    def refuse(*a, **k):
        raise AssertionError("fell back")

    monkeypatch.setattr(projection_kernel, "projection_plain", refuse)
    runtime.reset_launch_counts()
    feat, emb, wgan = torch.randn(8, 16), torch.randn(10, 16), torch.randn(8, 1)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        all_label_projection_logits(feat, emb, wgan)
    base = torch.zeros(8 * 16 + 1)
    with pytest.raises(ValueError, match="aligned"):
        all_label_projection_logits(base[1:].view(8, 16), emb, wgan)
    with pytest.raises(ValueError, match="multiple of 8"):
        all_label_projection_logits(torch.randn(8, 12), torch.randn(10, 12), wgan)
    assert len(fn.calls) == 1

    def broken_build(name):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(runtime, "cuda_library", broken_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        all_label_projection_logits(feat, emb, wgan)
    assert runtime.launch_counts()["projection"] == 0


# ------------------------------------------- grad mode on the CUDA branch
@pytest.mark.parametrize("kernel", ["conv3x3", "cond_batchnorm"])
def test_kernels_take_grad_mode_on_cuda_through_their_functions(monkeypatch, kernel):
    """With ``on_cuda`` mocked true and the launch replaced by the plain
    version, a call in grad mode on inputs that require grad goes down the
    CUDA branch (the launch is called: for conv3x3 once forward and once for
    the input-grad conv of the backward) and the gradients reach the filter
    and both tables, equal to autograd of the plain version."""
    monkeypatch.setattr(runtime, "on_cuda", lambda *ts: True)
    cuda_impls_on_cpu(monkeypatch, kernel)
    launches = []
    if kernel == "conv3x3":
        def launch(x, w):
            launches.append(x.shape)
            return conv_kernel.conv3x3_plain(x, w)

        monkeypatch.setattr(conv_kernel, "_launch", launch)
        args = [torch.randn(1, 4, 4, 2, requires_grad=True),
                torch.randn(3, 3, 2, 3, requires_grad=True)]
        fn, plain, want_launches = conv_kernel.conv3x3, conv_kernel.conv3x3_plain, 2
    else:
        def launch(x, labels, scale_table, offset_table, eps, relu=False):
            launches.append(x.shape)
            mean, inv = norm_kernel._moments_plain(x, eps)
            return (norm_kernel._apply_plain(x, labels, scale_table, offset_table, mean, inv,
                                             relu), torch.stack((mean, inv)))

        monkeypatch.setattr(norm_kernel, "_launch", launch)
        args = [torch.randn(2, 4, 3, requires_grad=True), torch.tensor([0, 1]),
                torch.ones(10, 3, requires_grad=True), torch.zeros(10, 3, requires_grad=True)]
        fn, plain, want_launches = norm_kernel.cond_batchnorm, norm_kernel.cond_batchnorm_plain, 1
    r = torch.randn(fn(*args).shape)
    launches.clear()
    torch.sum(torch.sin(fn(*args)) * r).backward()
    assert len(launches) == want_launches
    got = [a.grad for a in args if a.requires_grad]
    assert all(g is not None for g in got)
    for a in args:
        a.grad = None
    torch.sum(torch.sin(plain(*args)) * r).backward()
    for g, a in zip(got, [a for a in args if a.requires_grad]):
        torch.testing.assert_close(g, a.grad, rtol=1e-5, atol=1e-6)
