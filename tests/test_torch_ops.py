"""The port's ops and kernels' plain versions against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both frameworks as numpy
arrays.  The Pallas kernels run in interpret mode, as tests/test_pallas.py
runs them.  Every comparison is float32; tolerances are stated per test.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rcgan_tpu.core.module import Ctx
from rcgan_tpu.ops import conv as jconv
from rcgan_tpu.ops import norm as jnorm
from rcgan_tpu.ops.linear import linear_lib as jlinear_lib
from rcgan_tpu.ops.pallas.conv_kernel import conv3x3_fused
from rcgan_tpu.ops.pallas.norm_kernel import cond_batchnorm_fused
from rcgan_tpu_torch.bridge import load_tree
from rcgan_tpu_torch.core import initializers as inits
from rcgan_tpu_torch.core.module import count_params, param_tree
from rcgan_tpu_torch.ops import conv as tconv
from rcgan_tpu_torch.ops import linear as tlinear
from rcgan_tpu_torch.ops import norm as tnorm
from rcgan_tpu_torch.ops.kernels import runtime
from rcgan_tpu_torch.ops.kernels.conv_kernel import conv3x3, conv3x3_plain
from rcgan_tpu_torch.ops.kernels.norm_kernel import cond_batchnorm, cond_batchnorm_plain

torch.set_num_threads(min(2, torch.get_num_threads()))


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


# ------------------------------------------------------------------ cond-BN
@pytest.mark.parametrize("b,s,c", [(4, 6, 8), (2, 16, 128), (3, 64, 256)])
def test_cond_bn_plain_matches_pallas_interpret(b, s, c):
    """Same one-pass formula (E[x²] − mean², f32 sums) on both sides; only
    the summation order differs: 1e-5 abs/rel on O(1) outputs."""
    rs = np.random.RandomState(b * 100 + c)
    x = (2.0 * rs.randn(b, s, c) + 0.5).astype(np.float32)
    labels = rs.randint(0, 10, b)
    scale_t = (1.0 + 0.2 * rs.randn(10, c)).astype(np.float32)
    offset_t = (0.2 * rs.randn(10, c)).astype(np.float32)
    ref = cond_batchnorm_fused(jnp.asarray(x), jnp.asarray(scale_t[labels]),
                               jnp.asarray(offset_t[labels]), 1e-5)
    out = cond_batchnorm_plain(torch.from_numpy(x), torch.from_numpy(labels),
                               torch.from_numpy(scale_t), torch.from_numpy(offset_t))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_cond_bn_op_matches_jax_cond_batchnorm():
    """Port's ``ops.norm.cond_batchnorm`` (BHWC, table gather) against JAX's
    ``ops/norm.py::cond_batchnorm``, which takes the centred two-pass
    variance: with |mean| < std the two agree to 1e-5 in float32."""
    rs = np.random.RandomState(3)
    x = (1.5 * rs.randn(5, 4, 4, 16) - 0.3).astype(np.float32)
    labels = rs.randint(0, 10, 5)
    ctx = Ctx(rng=jax.random.key(0), init=True)
    jnorm.cond_batchnorm(ctx, jnp.asarray(x), jnp.asarray(labels), 10, "cbn")
    params = _np_tree(ctx.params)
    params["cbn"]["scale"] = (1.0 + 0.3 * rs.randn(10, 16)).astype(np.float32)
    params["cbn"]["offset"] = (0.3 * rs.randn(10, 16)).astype(np.float32)
    ref = jnorm.cond_batchnorm(Ctx(params=params), jnp.asarray(x), jnp.asarray(labels), 10, "cbn")

    layer = load_tree(tnorm.CondBatchNorm(10, 16, "cbn"), params, prefix="")
    with torch.inference_mode():
        out = layer(torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ conv3x3
def test_conv3x3_plain_matches_pallas_interpret():
    """(2,8,8,128) x (3,3,128,128), float32, K = 1152: summation order only,
    1e-5 of the output scale."""
    rs = np.random.RandomState(4)
    x = rs.randn(2, 8, 8, 128).astype(np.float32)
    w = (rs.randn(3, 3, 128, 128) / np.sqrt(9 * 128)).astype(np.float32)
    ref = np.asarray(conv3x3_fused(jnp.asarray(x), jnp.asarray(w)))
    out = conv3x3_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("cin,cout,k,biases", [(3, 5, 3, True), (8, 4, 3, False),
                                                (6, 6, 1, True), (16, 3, 3, True)])
def test_conv2d_lib_matches_jax(cin, cout, k, biases):
    """GAN_Lib Conv2D, 3x3 (kernel class) and 1x1 (F.conv2d), narrow
    channels, random biases: 1e-5 abs on O(1) outputs."""
    rs = np.random.RandomState(cin * 10 + cout)
    x = rs.randn(2, 6, 6, cin).astype(np.float32)
    ctx = Ctx(rng=jax.random.key(1), init=True)
    jconv.conv2d_lib(ctx, jnp.asarray(x), cin, cout, k, 1, "conv", biases=biases)
    params = _np_tree(ctx.params)
    if biases:
        params["conv"]["Biases"] = rs.randn(cout).astype(np.float32)
    ref = jconv.conv2d_lib(Ctx(params=params), jnp.asarray(x), cin, cout, k, 1, "conv",
                           biases=biases)
    layer = load_tree(tconv.Conv2dLib(cin, cout, k, "conv", biases=biases), params, prefix="")
    with torch.inference_mode():
        out = layer(torch.from_numpy(x))
    assert out.shape == (2, 6, 6, cout) and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_upsample_depth_to_space_matches_jax():
    """Exact: pure data movement.  Also a nearest-neighbour 2x upsample
    (the NHWC depth_to_space trap: no channel mixing)."""
    x = np.random.RandomState(5).randn(2, 3, 4, 5).astype(np.float32)
    ref = np.asarray(jconv.upsample_depth_to_space(jnp.asarray(x)))
    out = tconv.upsample_depth_to_space(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, x.repeat(2, axis=1).repeat(2, axis=2))


# ------------------------------------------------------------------- linear
@pytest.mark.parametrize("lead,din,dout,biases", [((4,), 7, 5, True), ((2, 3), 6, 6, False)])
def test_linear_lib_matches_jax(lead, din, dout, biases):
    """2-D and 3-D inputs (leading dims flattened and restored): 1e-5 abs."""
    rs = np.random.RandomState(din * dout)
    x = rs.randn(*lead, din).astype(np.float32)
    ctx = Ctx(rng=jax.random.key(2), init=True)
    jlinear_lib(ctx, jnp.asarray(x), din, dout, "lin", biases=biases)
    params = _np_tree(ctx.params)
    if biases:
        params["lin"]["b"] = rs.randn(dout).astype(np.float32)
    ref = jlinear_lib(Ctx(params=params), jnp.asarray(x), din, dout, "lin", biases=biases)
    layer = load_tree(tlinear.LinearLib(din, dout, "lin", biases=biases), params, prefix="")
    assert count_params(param_tree(layer)) == count_params(params)
    with torch.inference_mode():
        out = layer(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- initializers
def test_initializers_follow_the_reference_formulas():
    """Distributions, not values (the generators differ from jax.random)."""
    gen = torch.Generator().manual_seed(0)
    w = inits.conv_uniform(he=True)(gen, (3, 3, 64, 32))
    lim = np.sqrt(3.0) * np.sqrt(4.0 / (9 * 64 + 9 * 32))
    assert w.abs().max() <= lim and w.abs().max() > 0.95 * lim
    assert abs(w.std().item() - lim / np.sqrt(3.0)) < 0.02 * lim
    q = inits.linear_uniform()(gen, (24, 24))  # in == out -> orthogonal
    np.testing.assert_allclose((q.T @ q).numpy(), np.eye(24), atol=1e-5)
    g = inits.linear_uniform()(gen, (128, 2048))  # glorot
    assert g.abs().max() <= np.sqrt(3.0) * np.sqrt(2.0 / (128 + 2048))
    t = inits.truncated_normal(0.02)(gen, (10000,))
    assert t.abs().max() <= 0.04 and abs(t.std().item() - 0.0176) < 0.001
    assert torch.equal(inits.ones(gen, (2, 3)), torch.ones(2, 3))


# ------------------------------------------------------- wrappers / devices
def test_wrappers_take_plain_versions_on_cpu_without_counting():
    """CPU tensors go to the plain version, and only a kernel launch counts."""
    rs = np.random.RandomState(6)
    x = torch.from_numpy(rs.randn(2, 4, 4, 8).astype(np.float32))
    w = torch.from_numpy(rs.randn(3, 3, 8, 3).astype(np.float32))
    labels = torch.tensor([1, 7])
    tables = torch.ones(10, 8), torch.zeros(10, 8)
    before = runtime.launch_counts()
    assert torch.equal(conv3x3(x, w), conv3x3_plain(x, w))
    x3 = x.reshape(2, 16, 8)
    assert torch.equal(cond_batchnorm(x3, labels, *tables), cond_batchnorm_plain(x3, labels, *tables))
    assert runtime.launch_counts() == before


def test_absent_cuda_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runtime.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tconv.Conv2dLib(3, 3, 3, "c").to(runtime.resolve_device("cuda:0"))
    with pytest.raises(ValueError, match="different devices"):
        runtime.on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))
