"""The library leftovers of the port against the JAX package's op layer, on
the CPU, float32, on the same weights (the port's, moved to JAX through the
bridge, with every bias, gain and affine moved off its init): ``layer_norm``
and ``instance_norm`` (and the discriminator with ``normalization_d``),
``conv2d_lib``'s weight norm, PixelCNN masks, depthwise and separable convs
(with spectral norm, stride 2 and VALID padding), ``conv1d_lib`` with its
causal mask, ``linear_lib(weightnorm=True)``, ``embed_y``'s frozen table,
spectral norm with ``num_iters > 1`` and ``exact_sigma``; and the
profiling hook ``annotate``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rcgan_tpu.core.module import Ctx, transform
from rcgan_tpu.models import resnet_gan as jrg
from rcgan_tpu.ops import conv as jconv
from rcgan_tpu.ops import norm as jnorm
from rcgan_tpu.ops import sn as jsn
from rcgan_tpu.ops.linear import embed_y as jax_embed_y
from rcgan_tpu.ops.linear import linear_lib as jax_linear_lib
from rcgan_tpu_torch.bridge import load_tree, to_jax_tree
from rcgan_tpu_torch.core.module import param_tree, state_tree
from rcgan_tpu_torch.models import resnet_gan as trg
from rcgan_tpu_torch.ops import conv as tconv
from rcgan_tpu_torch.ops import linear as tlinear
from rcgan_tpu_torch.ops import norm as tnorm
from rcgan_tpu_torch.ops import sn as tsn
from rcgan_tpu_torch.utils import profiling as tprof

torch.set_num_threads(min(2, torch.get_num_threads()))

_MOVED = ("Biases", "b", "g", "gamma", "beta")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _trees(module: torch.nn.Module, seed: int):
    """The module's ``(params, state)`` as numpy trees with biases, weight-
    norm gains and affines moved off their inits, loaded back into it."""
    params, state = to_jax_tree(module)
    rs = np.random.RandomState(seed)
    for d in params.values():
        for var, a in d.items():
            if var in _MOVED:
                d[var] = (a * (1.0 + 0.3 * rs.rand(*a.shape)) + 0.3 * rs.randn(*a.shape)
                          ).astype(np.float32)
    load_tree(module, params, state, prefix="")
    return params, state


def _run_jax(fn, params, state, *args, update_sn=True):
    ctx = Ctx(params=jax.tree_util.tree_map(jnp.asarray, params),
              state=jax.tree_util.tree_map(jnp.asarray, state), update_sn=update_sn)
    out = fn(ctx, *[jnp.asarray(a) for a in args])
    return _np(out), _np(ctx.updated_state())


def _close(got: torch.Tensor, want, tol: float = 1e-5):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


def _states_close(module, jax_state):
    mine = state_tree(module)
    assert set(mine) == set(jax_state)
    for layer, d in mine.items():
        for var, t in d.items():
            np.testing.assert_allclose(t.numpy(), jax_state[layer][var], rtol=0, atol=1e-6,
                                       err_msg=f"{layer}/{var}")


# ------------------------------------------------------------------- norms
@pytest.mark.parametrize("kind", ["layer", "instance"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_and_instance_norm_match_jax(kind, dtype):
    """Float32 moments, the affine, the output in the input's dtype: 1e-5
    of scale in float32, bf16 to its rounding."""
    x = (np.random.RandomState(0).randn(4, 8, 8, 5) * 3 + 1).astype(np.float32)
    mod = (tnorm.LayerNorm if kind == "layer" else tnorm.InstanceNorm)(5, "ln")
    params, state = _trees(mod, 1)
    jfn = jnorm.layer_norm if kind == "layer" else jnorm.instance_norm
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref, _ = _run_jax(lambda ctx, x: jfn(ctx, x.astype(jdt), "ln").astype(jnp.float32),
                      params, state, x)
    out = mod(torch.from_numpy(x).to(dtype))
    assert out.dtype == dtype
    _close(out.float(), ref, 1e-5 if dtype == torch.float32 else 2.0 ** -7)
    # the normalisation itself: zero mean over the normalised dims
    plain = (tnorm.layer_norm if kind == "layer" else tnorm.instance_norm)(
        torch.from_numpy(x), torch.ones(5), torch.zeros(5))
    dims = (1, 2, 3) if kind == "layer" else (1, 2)
    np.testing.assert_allclose(plain.mean(dim=dims).numpy(), 0.0, atol=1e-5)


def test_discriminator_with_layer_norm_matches_jax():
    """``normalization_d``: every D block's norm is a layer norm, under
    JAX's scopes and shapes; the spectral-normed D forward (features,
    wgan logit) and its u's against JAX's."""
    kw = dict(dim_g=8, dim_d=16, embedding_dim=24, normalization_d=True)
    cfg, jcfg = trg.ResnetGANConfig(**kw), jrg.ResnetGANConfig(**kw)
    disc = trg.Discriminator(cfg, seed=1)
    lns = sorted(s for s, d in param_tree(disc).items() if set(d) == {"gamma", "beta"})
    assert lns and all(".N" in s for s in lns)
    params, state = _trees(disc, 2)
    rs = np.random.RandomState(3)
    x = rs.uniform(-1, 1, (3, cfg.output_dim)).astype(np.float32)
    labels = rs.randint(0, 10, 3).astype(np.int32)
    (feat, wgan), ref_state = _run_jax(lambda ctx, x, l: jrg.discriminator(ctx, jcfg, x, l),
                                       params, state, x, labels)
    with torch.no_grad():
        got = disc(torch.from_numpy(x), torch.from_numpy(labels).long())
    _close(got[0], feat, 1e-4)
    _close(got[1], wgan, 1e-4)
    _states_close(disc, ref_state)


# ------------------------------------------------------------------- convs
CONV_CASES = {
    "weightnorm": dict(input_dim=3, output_dim=16, filter_size=3, weightnorm=True),
    "weightnorm_sn": dict(input_dim=3, output_dim=16, filter_size=3, weightnorm=True,
                          spectral_normed=True),
    "mask_a": dict(input_dim=4, output_dim=8, filter_size=5, mask_type=("a", 2)),
    "mask_b_sn": dict(input_dim=6, output_dim=6, filter_size=3, mask_type=("b", 3),
                      spectral_normed=True),
    "stride2_valid": dict(input_dim=4, output_dim=6, filter_size=3, stride=2, padding="VALID"),
    "stride2_same": dict(input_dim=4, output_dim=6, filter_size=4, stride=2),
    "depthwise": dict(input_dim=4, output_dim=0, filter_size=3, conv_type="depthwise_conv2d",
                      channel_multiplier=2),
    "depthwise_sn_stride2": dict(input_dim=4, output_dim=0, filter_size=3, stride=2,
                                 conv_type="depthwise_conv2d", channel_multiplier=3,
                                 spectral_normed=True),
    "separable": dict(input_dim=4, output_dim=6, filter_size=3,
                      conv_type="separable_conv2d", channel_multiplier=2),
    "separable_sn_nobias": dict(input_dim=4, output_dim=6, filter_size=5, biases=False,
                                conv_type="separable_conv2d", channel_multiplier=2,
                                spectral_normed=True),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_lib_variants_match_jax(case):
    """Each variant's output (1e-5 of scale) and its state (the u of each
    spectral-normed filter, under JAX's scopes) against ``conv2d_lib``."""
    kw = CONV_CASES[case]
    x = np.random.RandomState(4).randn(2, 9, 9, kw["input_dim"]).astype(np.float32)
    mod = tconv.Conv2dLib(scope="C", **kw)
    params, state = _trees(mod, 5)
    ref, ref_state = _run_jax(lambda ctx, x: jconv.conv2d_lib(ctx, x, name="C", **kw),
                              params, state, x)
    with torch.no_grad():
        out = mod(torch.from_numpy(x))
    _close(out, ref)
    _states_close(mod, ref_state)


def test_conv2d_lib_weightnorm_starts_as_the_plain_conv_and_trains_g():
    """At init ``g`` is the filters' norm, so the conv equals the one
    without weight norm; doubling ``g`` doubles the output; ``g`` takes a
    gradient (``tests/test_ops.py``'s weight-norm oracle)."""
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 8, 8, 3).astype(np.float32))
    wn = tconv.Conv2dLib(3, 16, 3, "C", weightnorm=True)
    plain = tconv.Conv2dLib(3, 16, 3, "C")
    torch.testing.assert_close(wn.g.detach(), wn.Filters.detach().square().sum((0, 1, 2)).sqrt())
    torch.testing.assert_close(wn(x), plain(x), rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        wn.g.mul_(2.0)
    torch.testing.assert_close(wn(x) - wn.Biases, 2.0 * (plain(x) - plain.Biases), rtol=1e-4,
                               atol=1e-4)
    wn(x).square().sum().backward()
    assert wn.g.grad.abs().sum() > 0


def test_pixelcnn_mask_is_causal_and_matches_jax():
    """The mask equals JAX's ``_pixelcnn_mask``; a masked conv's output at
    rows above a poked row does not move."""
    for mt in (("a", 1), ("b", 1), ("a", 3), ("b", 2)):
        np.testing.assert_array_equal(tconv.pixelcnn_mask(mt, 5, 6, 6),
                                      jconv._pixelcnn_mask(mt, 5, 6, 6))
    mod = tconv.Conv2dLib(2, 4, 3, "m", mask_type=("a", 1))
    x = torch.randn(1, 6, 6, 2, generator=torch.Generator().manual_seed(1))
    x2 = x.clone()
    x2[0, 4:] = 123.0
    with torch.no_grad():
        torch.testing.assert_close(mod(x)[0, :4], mod(x2)[0, :4], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(), dict(mask_type=("a", 1)), dict(mask_type=("b", 2)),
                                dict(spectral_normed=True, stride=2),
                                dict(padding="VALID", biases=False)], ids=str)
def test_conv1d_lib_matches_jax_and_is_causal(kw):
    x = np.random.RandomState(6).randn(2, 16, 4).astype(np.float32)
    mod = tconv.Conv1dLib(4, 8, 5, "c1", **kw)
    params, state = _trees(mod, 7)
    ref, ref_state = _run_jax(
        lambda ctx, x: jconv.conv1d_lib(ctx, x, 4, 8, 5, name="c1", **kw), params, state, x)
    with torch.no_grad():
        out = mod(torch.from_numpy(x))
    _close(out, ref)
    _states_close(mod, ref_state)
    if "mask_type" in kw:  # position t does not see inputs after t
        x2 = x.copy()
        x2[:, 10:] = 99.0
        with torch.no_grad():
            torch.testing.assert_close(mod(torch.from_numpy(x2))[:, :10], out[:, :10],
                                       rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ linear
@pytest.mark.parametrize("sn", [False, True])
def test_linear_lib_weightnorm_matches_jax(sn):
    """W * g / ||W||_cols (then SN), on a 3-D input flattened and restored:
    1e-5 of scale; ``g`` starts at the columns' norms."""
    x = np.random.RandomState(1).randn(2, 3, 7).astype(np.float32)
    mod = tlinear.LinearLib(7, 5, "L", initialization="he", weightnorm=True, spectral_normed=sn)
    torch.testing.assert_close(mod.g.detach(), mod.W.detach().square().sum(0).sqrt())
    params, state = _trees(mod, 2)
    ref, ref_state = _run_jax(
        lambda ctx, x: jax_linear_lib(ctx, x, 7, 5, "L", weightnorm=True,
                                          spectral_normed=sn, initialization="he"),
        params, state, x)
    with torch.no_grad():
        out = mod(torch.from_numpy(x))
    _close(out, ref)
    _states_close(mod, ref_state)


def test_embed_y_frozen_table_matches_jax_and_takes_no_gradient():
    table = np.random.RandomState(0).randn(10, 8).astype(np.float32)
    labels = np.array([1, 3, 3, 9])
    mod = tlinear.Embedding(10, 8, "E", frozen_table=table)
    assert param_tree(mod) == {} and set(state_tree(mod)["E"]) == {"embedding_map_frozen"}
    ref, ref_state = _run_jax(
        lambda ctx, l: jax_embed_y(ctx, l, 10, 8, name="E", frozen_table=jnp.asarray(table)),
        {}, {"E": {"embedding_map_frozen": table}}, labels)
    out = mod(torch.from_numpy(labels))
    np.testing.assert_array_equal(out.numpy(), ref)
    _states_close(mod, ref_state)
    assert not out.requires_grad and not mod.embedding_map_frozen.requires_grad
    # the trainable table still gathers by label
    free = tlinear.Embedding(10, 8, "E")
    np.testing.assert_array_equal(free(torch.from_numpy(labels)).detach().numpy(),
                                  free.embedding_map.detach().numpy()[labels])


# -------------------------------------------------------------- spectral norm
@pytest.mark.parametrize("num_iters,update_sn", [(3, True), (2, False)])
def test_spectral_norm_power_iterations_match_jax(num_iters, update_sn):
    """JAX's ``fori_loop`` branch: W/σ, σ and the u left behind (advanced
    only with ``update_sn``), 1e-5; the gradient through the loop against
    JAX's."""
    w = np.random.RandomState(3).randn(3, 3, 4, 6).astype(np.float32)
    layer = tlinear.LinearLib(2, 6, "lay", spectral_normed=True)
    u0 = layer.u.numpy().copy()
    layer.update_sn = update_sn

    def jfn(ctx, w):
        return jsn.spectral_normed_weight(ctx, "lay", w, num_iters=num_iters, with_sigma=True)

    (w_bar, sigma), ref_state = _run_jax(jfn, {}, {"lay": {"u": u0}}, w, update_sn=update_sn)
    wt = torch.from_numpy(w).requires_grad_(True)
    got, got_sigma = tsn.spectral_normed_weight(layer, wt, num_iters=num_iters, with_sigma=True)
    _close(got, w_bar)
    np.testing.assert_allclose(got_sigma.item(), sigma, rtol=1e-5)
    np.testing.assert_allclose(layer.u.numpy(), ref_state["lay"]["u"], rtol=0, atol=1e-6)
    assert np.array_equal(layer.u.numpy(), u0) != update_sn
    r = np.random.RandomState(4).randn(*w.shape).astype(np.float32)
    (got * torch.from_numpy(r)).sum().backward()

    def loss(w):
        ctx = Ctx(params={}, state={"lay": {"u": jnp.asarray(u0)}}, update_sn=update_sn)
        return jnp.sum(jsn.spectral_normed_weight(ctx, "lay", w, num_iters=num_iters) * r)

    _close(wt.grad, jax.grad(loss)(jnp.asarray(w)), 1e-4)


def test_spectral_norm_converges_to_exact_sigma():
    """JAX's oracle test (``tests/test_ops.py``) from JAX's own ``w`` and
    initial ``u``: 50 iterations reach the SVD's σ, and ``exact_sigma``
    equals JAX's."""
    wj = jax.random.normal(jax.random.key(3), (5, 5, 16, 32))
    _, state = transform(lambda ctx: jsn.spectral_normed_weight(ctx, "lay", wj)).init(
        jax.random.key(0))
    w = torch.from_numpy(np.asarray(wj))
    layer = tlinear.LinearLib(2, 32, "lay", spectral_normed=True)
    layer.u = torch.from_numpy(np.asarray(state["lay"]["u"]))
    w_bar, sigma = tsn.spectral_normed_weight(layer, w, num_iters=50, with_sigma=True)
    want = tsn.exact_sigma(w)
    np.testing.assert_allclose(want.item(), float(jsn.exact_sigma(jnp.asarray(w.numpy()))),
                               rtol=1e-5)
    np.testing.assert_allclose(sigma.item(), want.item(), rtol=1e-3)
    np.testing.assert_allclose(tsn.exact_sigma(w_bar).item(), 1.0, rtol=1e-3)


def test_a_prepared_step_does_not_serve_more_iterations():
    layer = tlinear.LinearLib(4, 3, "lay", spectral_normed=True)
    tsn.prepare_spectral_norms([layer])
    with pytest.raises(ValueError, match="num_iters=2"):
        tsn.spectral_normed_weight(layer, layer.W, num_iters=2)


# --------------------------------------------------------------- profiling
def test_annotate_names_a_region_under_a_profiler_and_nothing_without(monkeypatch):
    """Under the profiler ``annotate`` puts its name into the profiler's
    events; with no profiler running it enters no ``record_function``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tprof.annotate("rcgan.region"):
            torch.ones(4).sum()
    assert "rcgan.region" in {e.key for e in prof.key_averages()}
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: entered.append(name))
    with tprof.annotate("rcgan.region"):
        torch.ones(4).sum()
    assert entered == []
