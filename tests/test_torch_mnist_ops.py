"""The MNIST stack's ops in the port against the JAX package's, on the CPU:
``conv2d`` (5x5, stride 2, TF SAME, with and without spectral norm) at
28, 14, 7 and 4, ``deconv2d`` 7→14 and 14→28, ``conv_cond_concat``,
``lrelu``, ``linear`` with its max-norm registration, ``batch_norm`` in
train and eval mode (with ``zero_debias``, the moving statistics after two
chained calls), ``apply_constraints`` and ``example_uniform``.

The same numpy weights and inputs go through both, float32 and bfloat16.
Tolerances: float32 within 1e-5 of the output's scale (the same sums in
another order); bfloat16 within 2^-7 of the scale (both sides round the
same inputs to bf16 and accumulate in float32, so they differ by the
output's rounding and the sum order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rcgan_tpu.core.module import Ctx
from rcgan_tpu.core.rng import example_uniform as jax_example_uniform
from rcgan_tpu.ops import batch_norm, conv2d, conv_cond_concat, deconv2d, linear, lrelu
from rcgan_tpu.train.state import apply_constraints as jax_apply_constraints
from rcgan_tpu_torch.bridge import load_tree, to_jax_tree
from rcgan_tpu_torch.core import rng as trng
from rcgan_tpu_torch.core.module import set_compute_dtype
from rcgan_tpu_torch.ops import conv as tconv
from rcgan_tpu_torch.ops.linear import Linear
from rcgan_tpu_torch.ops.norm import BatchNorm
from rcgan_tpu_torch.train.state import apply_constraints, constraints_of

torch.set_num_threads(min(2, torch.get_num_threads()))

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -7)}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax(fn, params, state, dtype, train=True):
    """``fn(ctx)`` on the given trees; returns (output, new state)."""
    ctx = Ctx(params=params, state=state, init=False, train=train, compute_dtype=dtype)
    return fn(ctx), _np(ctx.updated_state())


def _jax_init(fn, dtype=jnp.float32, seed=0):
    ctx = Ctx(rng=jax.random.key(seed), init=True, compute_dtype=dtype)
    fn(ctx)
    return _np(ctx.params), _np(ctx.state), ctx.constraints


def _perturb(params, seed, names=("biases", "bias", "gamma", "beta")):
    rs = np.random.RandomState(seed)
    for d in params.values():
        for var, a in d.items():
            if var in names:
                d[var] = (a + 0.3 * rs.randn(*a.shape)).astype(np.float32)
    return params


def _close(got, ref, tol, what):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-6),
                               err_msg=what)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("sn", [False, True])
@pytest.mark.parametrize("hw", [28, 14, 7, 4])
def test_conv2d_matches_jax(hw, sn, dtype):
    """5x5 stride 2, TF SAME (asymmetric at 28, 14 and 4): the output, and
    with SN the advanced ``u``; two calls chain ``u`` as JAX's do."""
    jdt, tdt, tol = DTYPES[dtype]
    cin, cout = (1, 8) if hw == 28 else (8, 8)
    x = np.random.RandomState(hw).rand(3, hw, hw, cin).astype(np.float32)

    def f(ctx):
        a = conv2d(ctx, jnp.asarray(x), cout, "d_h0_conv", spectral_norm=sn)
        return a, conv2d(ctx, jnp.asarray(x), cout, "d_h0_conv", spectral_norm=sn)

    params, state, _ = _jax_init(f)
    params = _perturb(params, hw)
    (ja, jb), jstate = _jax(f, params, state, jdt)
    layer = tconv.Conv2d(cin, cout, "d_h0_conv", spectral_norm=sn)
    load_tree(set_compute_dtype(layer, tdt), params, state, prefix="")
    ta, tb = layer(torch.from_numpy(x)), layer(torch.from_numpy(x))
    assert ta.dtype == tdt and ta.shape == (3, -(-hw // 2), -(-hw // 2), cout)
    _close(ta, ja, tol, "first call")
    _close(tb, jb, tol, "second call")
    if sn:
        _close(layer.u, jstate["d_h0_conv"]["u"], 1e-5, "u after two calls")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h,cin,cout", [(7, 12, 8), (14, 12, 1)])
def test_deconv2d_matches_jax(h, cin, cout, dtype):
    """TF SAME conv2d_transpose at stride 2 (JAX ``conv_transpose`` with
    ``transpose_kernel``): 7→14 and 14→28, the filter in TF's
    ``[k, k, cout, cin]``."""
    jdt, tdt, tol = DTYPES[dtype]
    x = np.random.RandomState(h).randn(2, h, h, cin).astype(np.float32)
    f = lambda ctx: deconv2d(ctx, jnp.asarray(x), cout, "g_h2")  # noqa: E731
    params, state, _ = _jax_init(f)
    params = _perturb(params, h)
    ref, _ = _jax(f, params, state, jdt)
    layer = tconv.Deconv2d(cin, cout, "g_h2")
    assert tuple(layer.w.shape) == (5, 5, cout, cin)
    load_tree(set_compute_dtype(layer, tdt), params, state, prefix="")
    got = layer(torch.from_numpy(x))
    assert got.shape == (2, 2 * h, 2 * h, cout) and got.dtype == tdt
    _close(got, ref, tol, "deconv2d")


def test_same_padding_is_tensorflows():
    """TF's SAME for 5x5 at stride 2: (1, 2) at 28, 14 and 4, (2, 2) at 7;
    stride 1 is symmetric; an unpadded ``F.conv2d(padding=2)`` differs."""
    assert [tconv.same_padding(n, 5, 2) for n in (28, 14, 7, 4)] == [(1, 2), (1, 2), (2, 2),
                                                                      (1, 2)]
    assert tconv.same_padding(28, 5, 1) == (2, 2) and tconv.same_padding(6, 4, 1) == (1, 2)
    rs = np.random.RandomState(0)
    x, w = rs.randn(1, 28, 28, 2).astype(np.float32), rs.randn(5, 5, 2, 3).astype(np.float32)
    ref = jax.lax.conv_general_dilated(x, w, (2, 2), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
    sym = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                     torch.from_numpy(w).permute(3, 2, 0, 1), stride=2,
                                     padding=2).permute(0, 2, 3, 1)
    assert np.abs(sym.numpy() - np.asarray(ref)).max() > 0.1 * np.abs(ref).max()
    _close(tconv._conv(torch.from_numpy(x), torch.from_numpy(w), 2), ref, 1e-5, "SAME")


def test_conv_cond_concat_and_lrelu_match_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(3, 7, 7, 4).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[[1, 5, 9]]
    for yy in (y, y.reshape(3, 1, 1, 10)):
        for xdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            got = tconv.conv_cond_concat(torch.from_numpy(x).to(xdt), torch.from_numpy(yy))
            ref = conv_cond_concat(jnp.asarray(x, jdt), jnp.asarray(yy))
            assert got.dtype == xdt and got.shape == (3, 7, 7, 14)
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    np.testing.assert_array_equal(tconv.lrelu(torch.from_numpy(x)).numpy(),
                                  np.asarray(lrelu(jnp.asarray(x))))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("max_norm", [False, True])
def test_linear_matches_jax_and_registers_its_constraint(max_norm, dtype):
    """normal(0.02) ``Matrix [in, out]`` and ``bias``; ``max_norm`` registers
    the [-1, 1] clip of both, as JAX's init does."""
    jdt, tdt, tol = DTYPES[dtype]
    x = np.random.RandomState(1).randn(5, 20).astype(np.float32)
    f = lambda ctx: linear(ctx, jnp.asarray(x), 7, "d_h4_lin", max_norm=max_norm)  # noqa: E731
    params, state, constraints = _jax_init(f)
    params = _perturb(params, 1)
    ref, _ = _jax(f, params, state, jdt)
    layer = Linear(20, 7, "d_h4_lin", max_norm=max_norm)
    load_tree(set_compute_dtype(layer, tdt), params, state, prefix="")
    _close(layer(torch.from_numpy(x)), ref, tol, "linear")
    assert constraints_of(layer) == constraints
    assert bool(constraints) == max_norm


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("zero_debias", [False, True])
@pytest.mark.parametrize("ndim", [2, 4])
def test_batch_norm_matches_jax_over_two_chained_calls(ndim, zero_debias, dtype):
    """Train mode: batch moments in float32, the moving statistics moved by
    decay 0.9 with the *biased* batch variance, twice in a row (the second
    call reads what the first wrote); then eval mode reads them and writes
    nothing.  With ``zero_debias`` the debiased moving mean and its
    accumulator and step."""
    jdt, tdt, tol = DTYPES[dtype]
    rs = np.random.RandomState(ndim)
    shape = (6, 16) if ndim == 2 else (4, 5, 5, 16)
    xs = [(2.0 * rs.randn(*shape) + 0.7).astype(np.float32) for _ in range(3)]

    def f(ctx):
        a = batch_norm(ctx, jnp.asarray(xs[0]), "g_bn0", zero_debias=zero_debias)
        return a, batch_norm(ctx, jnp.asarray(xs[1]), "g_bn0", zero_debias=zero_debias)

    params, state, _ = _jax_init(f)
    params = _perturb(params, ndim)
    (ja, jb), jstate = _jax(f, params, state, jdt)
    layer = BatchNorm(16, "g_bn0", zero_debias=zero_debias)
    load_tree(layer, params, state, prefix="")
    ta = layer(torch.from_numpy(xs[0]).to(tdt))
    tb = layer(torch.from_numpy(xs[1]).to(tdt))
    assert ta.dtype == tdt
    _close(ta, ja, tol, "first call")
    _close(tb, jb, tol, "second call")
    got_state = to_jax_tree(layer)[1]["g_bn0"]
    assert set(got_state) == set(jstate["g_bn0"])
    for var, ref in jstate["g_bn0"].items():
        _close(got_state[var], ref, 1e-5 if dtype == "float32" else tol, var)
    # eval mode: the moving statistics, read and left alone
    je, jstate_e = _jax(lambda ctx: batch_norm(ctx, jnp.asarray(xs[2]), "g_bn0", train=False,
                                               zero_debias=zero_debias), params, jstate, jdt)
    before = {k: v.clone() for k, v in layer.named_buffers()}
    _close(layer(torch.from_numpy(xs[2]).to(tdt), train=False), je, tol, "eval")
    assert all(torch.equal(before[k], v) for k, v in layer.named_buffers())
    assert all(np.array_equal(jstate_e["g_bn0"][k], jstate["g_bn0"][k]) for k in jstate["g_bn0"])


def test_batch_norm_moving_variance_is_the_biased_one():
    """One train call from the initial state: moving_variance is 0.9 + 0.1 of
    the biased batch variance, not ``F.batch_norm``'s unbiased one."""
    x = torch.tensor([[0.0], [2.0]])
    layer = BatchNorm(1, "bn")
    layer(x)
    assert layer.moving_variance.item() == pytest.approx(0.9 + 0.1 * 1.0)
    assert layer.moving_mean.item() == pytest.approx(0.1 * 1.0)


def test_apply_constraints_matches_jax():
    """The clip of the registered variables only, in place, against JAX's
    ``apply_constraints`` on the same trees."""
    rs = np.random.RandomState(0)
    tree = {"d_h4_lin": {"Matrix": 3 * rs.randn(4, 1).astype(np.float32),
                         "bias": np.array([-2.5], np.float32)},
            "d_h1_conv": {"w": 3 * rs.randn(5, 5, 1, 2).astype(np.float32)}}
    constraints = {"d_h4_lin": {"Matrix": (-1.0, 1.0), "bias": (-1.0, 1.0)}}
    want = _np(jax_apply_constraints(tree, constraints))
    group = {(la, v): torch.from_numpy(a.copy()) for la, d in tree.items() for v, a in d.items()}
    apply_constraints(group, constraints)
    for (la, v), t in group.items():
        np.testing.assert_array_equal(t.numpy(), want[la][v])
    assert np.abs(tree["d_h1_conv"]["w"]).max() > 1  # left alone


def test_example_uniform_is_keyed_per_example():
    """U[-1, 1) latents: rows ``[k, k + m)`` of a draw of ``n`` equal a draw
    of ``m`` from index ``k``; values in range, another seed other rows; the
    moments of U[-1, 1) (the stream is the port's own, as JAX's
    ``example_uniform`` is threefry's)."""
    z = trng.example_uniform(5, 256, 100, "cpu", -1.0, 1.0)
    assert z.dtype == torch.float32 and z.shape == (256, 100)
    assert torch.equal(trng.example_uniform(5, 40, 100, "cpu", -1.0, 1.0, first_index=64),
                       z[64:104])
    assert float(z.min()) >= -1.0 and float(z.max()) < 1.0
    assert bool((trng.example_uniform(6, 256, 100, "cpu", -1.0, 1.0) != z).any(dim=1).all())
    assert abs(float(z.mean())) < 0.01 and abs(float(z.var()) - 1.0 / 3.0) < 0.01
    ref = np.asarray(jax_example_uniform(jax.random.key(0), 256, 100, None, -1.0, 1.0))
    assert abs(float(z.var()) - ref.var()) < 0.01
