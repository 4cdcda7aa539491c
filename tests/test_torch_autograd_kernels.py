"""The autograd functions of the conv3x3 and cond-BN kernels against the JAX
package's VJPs, on the CPU.

``Conv3x3Fn`` against ``conv3x3_fused``'s ``custom_vjp`` (the Pallas kernel
in interpret mode, as tests/test_pallas.py runs it) and against autograd of
the plain version; ``CondBatchNormFn`` against ``cond_batchnorm_fused``
differentiated through the table gather of ``cond_batchnorm_bhwc``.
Inputs come from numpy seeds; tolerances are stated per test.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rcgan_tpu.ops.pallas.conv_kernel import conv3x3_fused
from rcgan_tpu.ops.pallas.norm_kernel import cond_batchnorm_bhwc, cond_batchnorm_fused
from rcgan_tpu_torch.ops import conv as tconv
from rcgan_tpu_torch.ops.kernels import conv_kernel
from rcgan_tpu_torch.ops.kernels.conv_kernel import Conv3x3Fn, conv3x3, conv3x3_plain
from rcgan_tpu_torch.ops.kernels.norm_kernel import CondBatchNormFn, cond_batchnorm_plain

torch.set_num_threads(min(2, torch.get_num_threads()))


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a)).requires_grad_(grad)


# ------------------------------------------------------------------ conv3x3
@pytest.mark.parametrize("b,h,w,c,o", [(2, 8, 8, 128, 128), (2, 4, 4, 128, 256)])
def test_conv3x3_fn_grads_match_the_pallas_vjp(b, h, w, c, o):
    """d/dx and d/dw of sum(sin(conv)·r) through Conv3x3Fn against jax.grad
    through conv3x3_fused (its _bwd: two XLA convs), float32: sums of up to
    9·O (dx) and B·H·W·9 (dw) terms in another order, 1e-4 of each
    gradient's scale."""
    rs = np.random.RandomState(c + o)
    x = rs.randn(b, h, w, c).astype(np.float32)
    wt = (rs.randn(3, 3, c, o) / np.sqrt(9 * c)).astype(np.float32)
    r = rs.randn(b, h, w, o).astype(np.float32)
    refs = jax.grad(lambda x, w: jnp.sum(jnp.sin(conv3x3_fused(x, w)) * r), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(wt))
    xt, wtt = _t(x, True), _t(wt, True)
    torch.sum(torch.sin(Conv3x3Fn.apply(xt, wtt)) * _t(r)).backward()
    for got, ref in zip((xt.grad, wtt.grad), refs):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_fn_matches_plain_autograd_and_keeps_primal_dtypes(dtype):
    """A ragged conv (C 5 → O 7, 5x6 maps): both gradients equal autograd of
    conv3x3_plain (the same float32 sums, each rounded once to the primal's
    dtype, so bit-equal on the CPU), and each cotangent carries its
    primal's dtype, as JAX's _bwd casts them.  Through Conv2dLib in bf16,
    the float32 parameters get float32 gradients."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(2, 5, 6, 5).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rs.randn(3, 3, 5, 7).astype(np.float32)).to(dtype)
    r = torch.from_numpy(rs.randn(2, 5, 6, 7).astype(np.float32))
    grads = []
    for fn in (conv3x3, conv3x3_plain):
        xt, wt = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        torch.sum(fn(xt, wt).float() * r).backward()
        grads.append((xt.grad, wt.grad))
    for got, want in zip(*grads):
        assert got.dtype == dtype
        assert torch.equal(got, want)

    layer = tconv.Conv2dLib(5, 7, 3, "conv", seed=1)
    layer.compute_dtype = dtype
    layer(x.float().requires_grad_(True)).float().sum().backward()
    assert layer.Filters.grad.dtype == torch.float32 and layer.Biases.grad.dtype == torch.float32


def test_conv3x3_fn_computes_only_the_gradients_asked_for(monkeypatch):
    """needs_input_grad: an input that takes no gradient (D's first conv on
    real images) runs no input-grad conv, and a frozen filter (D in the G
    step) runs no weight-grad reduction."""
    calls = {"dx": 0, "dw": 0}
    real_conv, real_wgrad = conv_kernel.conv3x3, conv_kernel.conv3x3_weight_grad

    def counting_conv(*a):
        calls["dx"] += 1
        return real_conv(*a)

    def counting_wgrad(*a):
        calls["dw"] += 1
        return real_wgrad(*a)

    monkeypatch.setattr(conv_kernel, "conv3x3", counting_conv)
    monkeypatch.setattr(conv_kernel, "conv3x3_weight_grad", counting_wgrad)
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(1, 4, 4, 3).astype(np.float32))
    w = torch.from_numpy(rs.randn(3, 3, 3, 2).astype(np.float32))
    for x_grad, w_grad, want in ((False, True, {"dx": 0, "dw": 1}),
                                 (True, False, {"dx": 1, "dw": 0}),
                                 (True, True, {"dx": 1, "dw": 1})):
        calls.update(dx=0, dw=0)
        xt, wt = x.clone().requires_grad_(x_grad), w.clone().requires_grad_(w_grad)
        Conv3x3Fn.apply(xt, wt).sum().backward()
        assert calls == want
        assert (xt.grad is not None) == x_grad and (wt.grad is not None) == w_grad


# ------------------------------------------------------------------ cond-BN
@pytest.mark.parametrize("route", ["fused", "bhwc"])
def test_cond_bn_fn_grads_match_jax(route):
    """dx, d scale_table and d offset_table of sum(sin(out)·r) through
    CondBatchNormFn against jax.grad of JAX's cond-BN with the per-example
    affine gathered from the tables (labels repeat, so the table grads
    accumulate over examples): through cond_batchnorm_fused's custom VJP
    (Pallas in interpret mode, C = 128) or cond_batchnorm_bhwc (its jnp
    branch at this size).  float32, 1e-4 of each gradient's scale."""
    rs = np.random.RandomState(5 if route == "fused" else 6)
    b, h, w, c = (4, 4, 4, 128) if route == "fused" else (5, 3, 3, 8)
    x = (2.0 * rs.randn(b, h, w, c) + 0.5).astype(np.float32)
    labels = np.array([3, 1, 3, 7, 1][:b])
    scale_t = (1.0 + 0.2 * rs.randn(10, c)).astype(np.float32)
    offset_t = (0.2 * rs.randn(10, c)).astype(np.float32)
    r = rs.randn(b, h, w, c).astype(np.float32)

    def jloss(x, s, o):
        if route == "fused":
            out = cond_batchnorm_fused(x.reshape(b, h * w, c), jnp.take(s, labels, axis=0),
                                       jnp.take(o, labels, axis=0), 1e-5).reshape(b, h, w, c)
        else:
            out = cond_batchnorm_bhwc(x, jnp.asarray(labels), s, o)
        return jnp.sum(jnp.sin(out) * r)

    refs = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, scale_t, offset_t)))
    ts = [_t(a, True) for a in (x, scale_t, offset_t)]
    out = CondBatchNormFn.apply(ts[0].reshape(b, h * w, c), _t(labels), ts[1], ts[2], 1e-5)
    torch.sum(torch.sin(out.reshape(b, h, w, c)) * _t(r)).backward()
    for t, ref in zip(ts, refs):
        ref = np.asarray(ref)
        assert t.grad.dtype == torch.float32
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    assert np.all(ts[1].grad.numpy()[[0, 2, 4, 5, 6, 8, 9]] == 0)  # labels never drawn


def test_cond_bn_fn_bf16_dx_and_float32_tables():
    """bf16 activations: dx in bf16, the table grads in float32 (the tables
    stay float32), each within a bf16 rounding of autograd of the plain
    version on the same inputs (2^-7 of the value plus 1e-3 of the scale:
    the plain version's autograd rounds its intermediates elsewhere)."""
    rs = np.random.RandomState(7)
    x = torch.from_numpy((2.0 * rs.randn(4, 9, 16) + 0.5).astype(np.float32)).to(torch.bfloat16)
    labels = torch.tensor([2, 0, 2, 5])
    tables = [torch.from_numpy((1.0 + 0.2 * rs.randn(10, 16)).astype(np.float32)),
              torch.from_numpy((0.2 * rs.randn(10, 16)).astype(np.float32))]
    r = torch.from_numpy(rs.randn(4, 9, 16).astype(np.float32))
    grads = []
    for fn in (lambda *a: CondBatchNormFn.apply(*a, 1e-5), cond_batchnorm_plain):
        ts = [x.clone().requires_grad_(True)] + [t.clone().requires_grad_(True) for t in tables]
        torch.sum(torch.tanh(fn(ts[0], labels, ts[1], ts[2]).float()) * r).backward()
        grads.append([t.grad for t in ts])
    assert [g.dtype for g in grads[0]] == [torch.bfloat16, torch.float32, torch.float32]
    for got, want in zip(*grads):
        got, want = got.float(), want.float()
        tol = 2.0 ** -7 * want.abs() + 1e-3 * want.abs().max()
        assert bool(((got - want).abs() <= tol).all())
