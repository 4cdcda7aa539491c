"""The port's PGGAN model pieces against the JAX package's, on the CPU,
float32: ``pixel_norm``; ``get_loss`` over every loss type and
``wgan_gp_penalty``; ``Normalize``'s routes (the PGGAN critic's
zero-debiased batch-norm, and the CIFAR modules building what JAX builds);
the generator and the critic at every ``(stage, trans)`` and alpha in
{0, 0.5, 1} with the critic's state after the pass; the fade-in contract;
and the spectral-norm group of each phase.

Tiny widths as ``tests/test_pggan.py::tiny`` (dim 8, embedding 12,
``max_stage`` 2, batch 4), the JAX weights with biases and cond-BN tables
moved off their inits, loaded into the port through the bridge.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rcgan_tpu.algorithms import losses as jlosses
from rcgan_tpu.core.module import Ctx, merge
from rcgan_tpu.models import pggan as jp
from rcgan_tpu.models import resnet_gan as jrg
from rcgan_tpu.ops import norm as jnorm
from rcgan_tpu.train import pggan_loop as jloop
from rcgan_tpu_torch.algorithms import losses as tlosses
from rcgan_tpu_torch.bridge import load_tree
from rcgan_tpu_torch.core.module import param_tree, state_tree
from rcgan_tpu_torch.models import pggan as tp
from rcgan_tpu_torch.models import resnet_gan as trg
from rcgan_tpu_torch.ops import sn as tsn
from rcgan_tpu_torch.ops.conv import upsample_depth_to_space
from rcgan_tpu_torch.ops.norm import BatchNorm, CondBatchNorm, pixel_norm

torch.set_num_threads(min(2, torch.get_num_threads()))

B = 4
TINY = dict(z_dim=8, dim=8, max_stage=2)
BASE = dict(dim_g=8, dim_d=8, embedding_dim=12)
PHASES = [(1, False), (2, True), (2, False)]
LOSS_TYPES = ["HINGE", "WGAN", "WGAN-GP", "LSGAN", "CGAN", "Goodfellow", "MiniMax"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """JAX's tiny PGGAN tree (every stage) with biases, cond-BN tables and
    the critic's BN affine moved off their inits, and the port's model
    holding it."""
    cfg, base = jp.PGGANConfig(**TINY), jrg.ResnetGANConfig(**BASE)
    jts = jloop.PGGANTrainer(cfg, base, jloop.PGGANTrainConfig()).init(jax.random.key(0), B)
    params, state = _np(merge(*jts.groups.values())), _np(jts.state)
    rs = np.random.RandomState(0)
    for d in params.values():
        for var, a in d.items():
            if var in ("scale", "offset", "Biases", "b", "gamma", "beta"):
                d[var] = (a + 0.3 * rs.randn(*a.shape)).astype(np.float32)
    gan = tp.PGGAN(tp.PGGANConfig(**TINY), trg.ResnetGANConfig(**BASE), device="cpu")
    load_tree(gan, params, state, prefix="")
    return cfg, base, params, state, gan


def _inputs(seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, 8).astype(np.float32), rs.randint(0, 10, B),
            (rs.rand(B, 16, 16, 3) * 2 - 1).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pixel_norm_matches_jax(dtype):
    """In float32 and cast back: float32 within 1e-6, bf16 bit-equal but
    for a one-ulp rounding of the float32 product (2^-8 relative)."""
    x = np.random.RandomState(1).randn(3, 4, 4, 16).astype(np.float32)
    want = np.asarray(jnorm.pixel_norm(jnp.asarray(x).astype(dtype)).astype(jnp.float32))
    got = pixel_norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    rtol = 1e-6 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("soft_plus", [False, True])
@pytest.mark.parametrize("loss_type", [t for t in LOSS_TYPES if t != "WGAN-GP"])
def test_get_loss_matches_jax(loss_type, soft_plus):
    """(gen_cost, disc_cost) on logits of both signs, within 1e-6 relative."""
    rs = np.random.RandomState(2)
    real, fake = (3.0 * rs.randn(16)).astype(np.float32), (3.0 * rs.randn(16)).astype(np.float32)
    want = jlosses.get_loss(jnp.asarray(real), jnp.asarray(fake), loss_type, soft_plus)
    got = tlosses.get_loss(torch.from_numpy(real), torch.from_numpy(fake), loss_type, soft_plus)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6, atol=1e-7)


def test_wgan_gp_penalty_matches_jax():
    """A small plain critic (``sum tanh(x W)`` per example): the penalty and
    its gradient in W (it trains D, so the input gradient keeps its graph)
    against JAX's with JAX's interpolation draw, within 1e-5 relative; and
    'WGAN-GP' in ``get_loss`` adds it."""
    rs = np.random.RandomState(3)
    real, fake = rs.randn(5, 4, 4, 3).astype(np.float32), rs.randn(5, 4, 4, 3).astype(np.float32)
    w = (0.3 * rs.randn(48, 7)).astype(np.float32)
    key = jax.random.key(7)
    eps = np.asarray(jax.random.uniform(key, (5, 1, 1, 1))).reshape(5)

    def jpen(wj):
        d = lambda x: jnp.sum(jnp.tanh(x.reshape(x.shape[0], -1) @ wj), axis=1)
        return jlosses.wgan_gp_penalty(d, jnp.asarray(real), jnp.asarray(fake), key)

    want, want_grad = jax.value_and_grad(jpen)(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    d = lambda x: torch.sum(torch.tanh(x.reshape(x.shape[0], -1) @ wt), dim=1)
    got = tlosses.wgan_gp_penalty(d, torch.from_numpy(real), torch.from_numpy(fake),
                                  torch.from_numpy(eps))
    got_grad, = torch.autograd.grad(got, wt)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want_grad)).max())
    logits = torch.from_numpy(rs.randn(5).astype(np.float32))
    g0, d0 = tlosses.get_loss(logits, -logits, "WGAN")
    g1, d1 = tlosses.get_loss(logits, -logits, "WGAN-GP", d_apply=d,
                              real=torch.from_numpy(real), fake=torch.from_numpy(fake),
                              eps=torch.from_numpy(eps))
    assert float(g1) == float(g0)
    np.testing.assert_allclose(float(d1 - d0), float(want), rtol=1e-5)
    with pytest.raises(ValueError, match="WGAN-GP needs"):
        tlosses.get_loss(logits, logits, "WGAN-GP")


def test_critic_blocks_take_zero_debiased_batch_norm():
    """``PG.D.Block.{s}.N{1,2}`` hold ``G.``: with no labels they take JAX's
    zero-debiased BN, with moving statistics, ``biased_mean`` and
    ``local_step``; the generator's blocks take cond-BN; with
    ``normalization_d`` a critic scope takes layer-norm, as JAX checks it
    first."""
    base = trg.ResnetGANConfig(**BASE)
    d = trg.ResidualBlock(base, 8, 8, 3, "PG.D.Block.1", "down", spectral_normed=True,
                          labeled=False)
    for n in (d.n1, d.n2):
        assert n.cbn is None and isinstance(n.bn, BatchNorm) and n.bn.zero_debias
    assert set(state_tree(d)["PG.D.Block.1.N1"]) == {"moving_mean", "moving_variance",
                                                     "biased_mean", "local_step"}
    g = trg.ResidualBlock(base, 8, 8, 3, "PG.G.Block.1", "up")
    assert isinstance(g.n1.cbn, CondBatchNorm) and g.n1.bn is None
    ln = trg.Normalize(trg.ResnetGANConfig(normalization_d=True), "PG.D.Block.1.N1", 8)
    assert ln.cbn is None and ln.bn is None and ln.ln.scope == "PG.D.Block.1.N1"


def _shapes(tree):
    return {la: {v: tuple(np.shape(a)) for v, a in d.items()} for la, d in tree.items()}


@pytest.mark.parametrize("algorithm", ["rcgan", "rcgan-u"])
def test_cifar_modules_build_what_jax_builds(algorithm):
    """The CIFAR generator, discriminator, projection and perm classifier
    hold exactly JAX's layers, vars and shapes (parameters and state), with
    cond-BN in G and no batch-norm anywhere: the Normalize repair leaves
    them as they were."""
    cfg = dict(dim_g=8, dim_d=16, embedding_dim=24, algorithm=algorithm)
    jcfg, tcfg = jrg.ResnetGANConfig(**cfg), trg.ResnetGANConfig(**cfg)
    ctx = Ctx(rng=jax.random.key(0), init=True)
    z, y = jnp.zeros((2, 128)), jnp.zeros((2,), jnp.int32)
    jrg.discriminator(ctx, jcfg, jrg.generator(ctx, jcfg, z, y), y)
    jrg.discriminator_projection(ctx, jcfg, y)
    jrg.perm_classifier(ctx, jcfg, jnp.zeros((2, 3072)))
    mods = [trg.Generator(tcfg, device="cpu"), trg.Discriminator(tcfg),
            trg.DiscriminatorProjection(tcfg), trg.PermClassifier(tcfg)]
    params, state = {}, {}
    for m in mods:
        params.update(param_tree(m))
        state.update(state_tree(m))
    assert _shapes(params) == _shapes(ctx.params)
    assert _shapes(state) == _shapes(ctx.updated_state())
    g_norms = [m for m in mods[0].modules() if isinstance(m, trg.Normalize)]
    d_norms = [m for mod in mods[1:] for m in mod.modules() if isinstance(m, trg.Normalize)]
    assert len(g_norms) == 7 and all(m.cbn is not None and m.bn is None for m in g_norms)
    assert len(d_norms) == 10 and all(m.cbn is None and m.bn is None for m in d_norms)
    assert not any(isinstance(m, BatchNorm) for mod in mods for m in mod.modules())


def test_pggan_tree_is_jax_tree(pair):
    """Every stage's layers, with JAX's scopes, vars and shapes, and the
    same state (SN ``u``, the critic's BN statistics)."""
    cfg, base, params, state, gan = pair
    assert _shapes(param_tree(gan)) == _shapes(params)
    assert _shapes(state_tree(gan)) == _shapes(state)


def _jax_ctx(params, state, update_sn=True):
    return Ctx(params=params, state=state, rng=None, init=False, train=True,
               update_sn=update_sn)


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("stage,trans", PHASES)
def test_generator_and_critic_match_jax(pair, stage, trans, alpha):
    """G's images and D's features and logits (real images and G's fakes,
    chained as the D step chains them) within 1e-5 of their scale; D's state
    after the two passes: ``u`` within 1e-5, BN statistics within 1e-5 of
    their scale, ``local_step`` exact; the state of the stages the phase
    does not call bit-equal to what it was."""
    cfg, base, params, state, gan = pair
    z, y, x = _inputs(10 * stage + int(trans) + int(4 * alpha))
    x = np.asarray(jloop.pool_to_stage(jnp.asarray(x), cfg, stage))
    ctx = _jax_ctx(params, state)
    fake = jp.generator(ctx, cfg, base, jnp.asarray(z), jnp.asarray(y), stage, trans, alpha)
    jf, jl = jp.discriminator(ctx, cfg, base, fake, stage, trans, alpha, labels=jnp.asarray(y))
    rf, rl = jp.discriminator(ctx, cfg, base, jnp.asarray(x), stage, trans, alpha,
                              labels=jnp.asarray(y))
    want_state = _np(ctx.updated_state())

    load_tree(gan, params, state, prefix="")
    before = {la: {v: t.clone() for v, t in d.items()} for la, d in state_tree(gan).items()}
    with torch.no_grad():
        got = gan.G(torch.from_numpy(z), torch.from_numpy(y), stage, trans, alpha)
        tf, tl = gan.D(got, stage, trans, alpha, torch.from_numpy(y))
        sf, sl = gan.D(torch.from_numpy(x), stage, trans, alpha, torch.from_numpy(y))
    assert got.shape == (B, 4 * 2 ** stage, 4 * 2 ** stage, 3)
    for mine, ref in ((got, fake), (tf, jf), (tl, jl), (sf, rf), (sl, rl)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(mine.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    active = {f"Block.{s}" for s in range(1, stage + 1)} | {f"FromRGB.{stage}"}
    if trans:
        active.add(f"FromRGB.{stage - 1}")
    for la, d in state_tree(gan).items():
        for var, t in d.items():
            ref = want_state[la][var]
            if not any(la.startswith(f"PG.D.{a}") for a in active) and la not in (
                    "PG.D.Output", "PG.D.Embedding_y"):
                assert torch.equal(t, before[la][var]), (la, var)
            if var == "local_step":
                assert float(t[0]) == float(ref[0]), la
                continue
            atol = 1e-5 if var == "u" else 1e-5 * max(np.abs(ref).max(), 1.0)
            np.testing.assert_allclose(t.numpy(), ref, rtol=0, atol=atol, err_msg=f"{la}/{var}")


@pytest.mark.parametrize("stage", [2])
def test_fade_in_alpha_zero_is_the_upsampled_previous_stage(pair, stage):
    """At alpha 0 a transition's output is the previous stage's image
    upsampled (JAX's ``test_fade_in_alpha_zero_equals_upsampled_low_res``):
    within 1e-6 (the blend's float32 weights are exactly 0 and 1)."""
    cfg, base, params, state, gan = pair
    z, y, _ = _inputs(5)
    with torch.no_grad():
        fade = gan.G(torch.from_numpy(z), torch.from_numpy(y), stage, True, 0.0)
        low = gan.G(torch.from_numpy(z), torch.from_numpy(y), stage - 1)
    np.testing.assert_allclose(fade.numpy(), upsample_depth_to_space(low).numpy(), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="transition needs stage >= 2"):
        gan.G(torch.from_numpy(z), torch.from_numpy(y), 1, True, 0.5)


@pytest.mark.parametrize("stage,trans", PHASES)
def test_one_sn_group_per_critic_pass_of_the_phase_layers(pair, stage, trans, monkeypatch):
    """A D pass runs one sn group: the phase's spectral-normed layers in
    call order, and no other."""
    cfg, base, params, state, gan = pair
    groups = []
    real = tsn.spectral_norm_group

    def spy(pairs):
        groups.append([tuple(w.shape) for w, _ in pairs])
        return real(pairs)

    monkeypatch.setattr(tsn, "spectral_norm_group", spy)
    _, y, x = _inputs(6)
    x = torch.from_numpy(np.asarray(jloop.pool_to_stage(jnp.asarray(x), cfg, stage)))
    with torch.no_grad():
        gan.D(x, stage, trans, 0.5, torch.from_numpy(y))
    scopes = [m.scope for m in gan.D.sn_group(stage, trans, True)]
    want = [f"PG.D.FromRGB.{stage}"]
    for s in range(stage, 0, -1):
        want += [f"PG.D.Block.{s}.{c}" for c in ("Shortcut", "Conv1", "Conv2")]
        if trans and s == stage:
            want.append(f"PG.D.FromRGB.{stage - 1}")
    want += ["PG.D.Output", "PG.D.Embedding_y"]
    assert scopes == want and len(groups) == 1 and len(groups[0]) == len(want)


def test_full_width_stage4_transition_group():
    """At the app's full width the stage-4 transition's group holds the 16
    weights the card's kernel takes in one launch: FromRGB.4 and .3
    [3, 128], four blocks' Shortcut [128, 128], Conv1 and Conv2
    [1152, 128], Output [128, 1], Embedding_y [300, 128]."""
    cfg = tp.PGGANConfig(max_stage=4)
    base = trg.ResnetGANConfig()
    d = tp.Discriminator(cfg, base)
    shapes = [tuple(getattr(m, m.sn_weight).reshape(-1, getattr(m, m.sn_weight).shape[-1]).shape)
              for m in d.sn_group(4, True, True)]
    block = [(128, 128), (1152, 128), (1152, 128)]
    assert shapes == [(3, 128)] + block + [(3, 128)] + block * 3 + [(128, 1), (300, 128)]
