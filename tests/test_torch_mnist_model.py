"""The MNIST DCGAN and its losses in the port against the JAX package's, on
the CPU: the generator in train and eval mode, the projection and vanilla
discriminators (also under ``concat_y``), both paths of
``discriminator_all_labels``, the classifier, and ``mnist_losses`` in the
six modes with and without ``g_step_only``: the losses, the new state
(spectral-norm ``u``, BN moving statistics) and the gradients of the
``disc``, ``gen`` and ``confusion`` groups.  The spectral norm runs as one
group per D pass, and ten chained groups when D is evaluated per label.

The JAX package's weights (biases, BN affine and moving statistics moved
off their inits) are loaded into the port by name; inputs come from numpy
seeds; ``TINY_MNIST`` widths (gf/df 8, gfc/dfc 32), batch 6.  JAX's
spectral norm runs its jnp path on the CPU, as the JAX tests run it.
Tolerances (float32): outputs, losses and state within 1e-5 of their scale
(1e-5 · (1 + |loss|) for a loss); gradients within 1e-4 of each tensor's
own scale plus 1e-5 of its group's largest (a conv bias that a batch-norm
follows has a gradient that is zero but for rounding).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rcgan_tpu.algorithms import mnist as jm
from rcgan_tpu.core.module import Ctx
from rcgan_tpu.models import dcgan as jd
from rcgan_tpu_torch.algorithms.mnist import (MnistAlgoConfig, MnistGAN, mnist_losses,
                                              partition_predicates)
from rcgan_tpu_torch.bridge import load_tree, to_jax_tree
from rcgan_tpu_torch.models.dcgan import DCGANConfig
from rcgan_tpu_torch.ops import sn as tsn
from torch_parity import TINY_MNIST, mnist_batch, perturb_mnist

torch.set_num_threads(min(2, torch.get_num_threads()))

B = 6
# the six training modes: (algorithm, D, concat_y, estimate_confuse, perm_regularizer)
MODES = {
    "biased": ("biased", "vanilla", False, False, True),
    "unbiased": ("unbiased", "projection", False, False, False),
    "rcgan": ("rcgan", "projection", False, False, False),
    "rcgan-u": ("rcgan", "projection", False, True, True),
    "ambient": ("ambient", "projection", False, False, True),
    "rcgan+y": ("rcgan", "projection", True, True, False),
}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _configs(mode, **over):
    alg, disc, concat, est, perm = MODES[mode]
    kw = dict(TINY_MNIST, disc_type=disc, concat_y=concat, concat_y_layers=(1, 3), **over)
    akw = dict(algorithm=alg, estimate_confuse=est, perm_regularizer=perm,
               confuse_init=mode == "rcgan-u")
    return (DCGANConfig(**kw), MnistAlgoConfig(**akw), jd.DCGANConfig(**kw),
            jm.MnistAlgoConfig(**akw))


def _setup(mode, seed=0, **over):
    """(port gan, JAX params, JAX state, batch, z, C) on the same weights."""
    cfg, acfg, jcfg, jacfg = _configs(mode, **over)
    batch, z, c = mnist_batch(B, seed)
    ctx = Ctx(rng=jax.random.key(seed), init=True)
    jm.mnist_losses(ctx, jcfg, jacfg, {k: jnp.asarray(v) for k, v in batch.items()},
                    jnp.asarray(z), jnp.asarray(c))
    params, state = perturb_mnist(_np(ctx.params), _np(ctx.state), seed)
    gan = MnistGAN(cfg, acfg, device="cpu")
    load_tree(gan, params, state, prefix="")
    return gan, params, state, batch, z, c, jcfg, jacfg


def _close(got, ref, tol, what):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-6),
                               err_msg=what)


def _assert_state(gan, jstate, what):
    got = to_jax_tree(gan)[1]
    assert set(got) == set(jstate), what
    for layer, d in jstate.items():
        for var, ref in d.items():
            _close(got[layer][var], ref, 1e-5, f"{what} {layer}/{var}")


def _tensors(batch, z, c):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return tb, torch.from_numpy(z), torch.from_numpy(c)


# ------------------------------------------------------------------ modules
@pytest.mark.parametrize("train", [True, False])
def test_generator_matches_jax(train):
    """z‖y through the FC, BN, deconv stack: images in (0, 1), and in train
    mode the moving statistics of g_bn0..2 moved as JAX's; eval mode reads
    them (perturbed here) and writes nothing."""
    gan, params, state, batch, z, c, jcfg, _ = _setup("rcgan")
    y = np.eye(10, dtype=np.float32)[batch["y_gen"]]
    ctx = Ctx(params=params, state=state, init=False, train=train)
    ref = jd.generator(ctx, jcfg, jnp.asarray(z), jnp.asarray(y), train=train)
    got = gan.G(torch.from_numpy(z), torch.from_numpy(y), train=train).detach()
    assert got.shape == (B, 28, 28, 1) and float(got.min()) > 0 and float(got.max()) < 1
    _close(got, ref, 1e-5, "G")
    _assert_state(gan, _np(ctx.updated_state()), "G state")


@pytest.mark.parametrize("mode", ["rcgan", "biased", "rcgan+y"])
def test_discriminator_matches_jax(mode):
    """The projection D, the vanilla D, and the projection D with the
    one-hot concatenated at layers 1 and 3: probabilities, logits, state."""
    gan, params, state, batch, z, c, jcfg, _ = _setup(mode)
    x, y = batch["images"], np.eye(10, dtype=np.float32)[batch["y_real"]]
    ctx = Ctx(params=params, state=state, init=False)
    jp, jl = jd.discriminator(ctx, jcfg, jnp.asarray(x), jnp.asarray(y))
    tp, tl = gan.D(torch.from_numpy(x), torch.from_numpy(y))
    assert tl.shape == (B, 1)
    _close(tl, jl, 1e-5, "logits")
    _close(tp, jp, 1e-5, "probabilities")
    _assert_state(gan, _np(ctx.updated_state()), "D state")
    if mode == "rcgan+y":  # the concatenated label widens layers 1 and 3
        assert tuple(gan.D.h0.w.shape) == (5, 5, 11, 8) and tuple(gan.D.h2.w.shape) == (5, 5, 18, 8)


@pytest.mark.parametrize("mode", ["rcgan", "rcgan+y", "biased"])
def test_all_labels_matches_jax(mode, monkeypatch):
    """``discriminator_all_labels``: the factorised path (projection, no
    concat_y: one trunk pass, one SN group) and the per-label path (ten D
    towers, each with its own BN moments and one SN group from the ``u``
    the tower before wrote; none for the vanilla D)."""
    groups = []
    real = tsn.spectral_norm_group
    monkeypatch.setattr(tsn, "spectral_norm_group",
                        lambda pairs: groups.append(len(pairs)) or real(pairs))
    gan, params, state, batch, z, c, jcfg, _ = _setup(mode)
    ctx = Ctx(params=params, state=state, init=False)
    ref = jd.discriminator_all_labels(ctx, jcfg, jnp.asarray(batch["images"]))
    got = gan.D.all_labels(torch.from_numpy(batch["images"]))
    assert got.shape == (B, 10)
    _close(got, ref, 1e-5, "all-label logits")
    _assert_state(gan, _np(ctx.updated_state()), "state")
    assert groups == {"rcgan": [4], "rcgan+y": [4] * 10, "biased": []}[mode]


def test_classifier_matches_jax():
    gan, params, state, batch, *_ = _setup("rcgan-u")
    ctx = Ctx(params=params, state=state, init=False)
    ref = jd.classifier(ctx, jd.DCGANConfig(**TINY_MNIST), jnp.asarray(batch["images"]))
    _close(gan.classifier(torch.from_numpy(batch["images"])), ref, 1e-5, "classifier")
    assert set(to_jax_tree(gan.classifier)[0]) == {"d_classifier_h1"}


def test_partition_puts_the_classifier_with_d():
    preds = partition_predicates()
    group = {n: next(g for g, p in preds.items() if p(n))
             for n in ("confusion_logits", "d_h0_conv", "d_classifier_h1", "g_bn0", "g_h3")}
    assert group == {"confusion_logits": "confusion", "d_h0_conv": "disc",
                     "d_classifier_h1": "disc", "g_bn0": "gen", "g_h3": "gen"}


# ------------------------------------------------------------------- losses
def _jax_losses(params, state, batch, z, c, jcfg, jacfg, g_step_only):
    """JAX's losses, new state, and the gradients of the D objective
    (``d_loss + class_loss_real``) and of the G objective (``g_loss +
    perm_multiplier * class_loss_fake``) with respect to every parameter."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def run(p):
        ctx = Ctx(params=p, state=state, init=False)
        out = jm.mnist_losses(ctx, jcfg, jacfg, jb, jnp.asarray(z), jnp.asarray(c),
                              g_step_only=g_step_only)
        return out, ctx.updated_state()

    def objective(p, which):
        out, _ = run(p)
        if which == "d":
            return out["d_loss"] + 1.0 * out["class_loss_real"]
        return out["g_loss"] + jacfg.perm_multiplier * out["class_loss_fake"]

    out, new_state = run(params)
    grads = {w: _np(jax.grad(objective)(params, w)) for w in ("d", "g")}
    return {k: np.asarray(v, np.float32) for k, v in out.items()}, _np(new_state), grads


@pytest.mark.parametrize("g_step_only", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_mnist_losses_match_jax(mode, g_step_only):
    """Losses, D probabilities, the new state and the gradients: the D
    objective's for the ``disc`` group, the G objective's for ``gen`` and
    ``confusion``, in each of the six modes."""
    gan, params, state, batch, z, c, jcfg, jacfg = _setup(mode, seed=3)
    jout, jstate, jgrads = _jax_losses(params, state, batch, z, c, jcfg, jacfg, g_step_only)
    tb, tz, tc = _tensors(batch, z, c)
    out = mnist_losses(gan, tb, tz, tc, g_step_only=g_step_only)
    for k in ("d_loss_real", "d_loss_fake", "d_loss", "g_loss", "class_loss_real",
              "class_loss_fake"):
        assert abs(float(out[k]) - float(jout[k])) <= 1e-5 * (1 + abs(float(jout[k]))), k
    for k in ("D", "D_", "confusion", "G"):
        _close(out[k], jout[k], 1e-5, k)
    _assert_state(gan, jstate, "new state")

    preds = partition_predicates()
    names = [(la, v, p) for la, m in _scoped(gan).items() for v, p in m.named_parameters(
        recurse=False)]
    d_obj = out["d_loss"] + 1.0 * out["class_loss_real"]
    g_obj = out["g_loss"] + jacfg.perm_multiplier * out["class_loss_fake"]
    for which, obj, groups in (("d", d_obj, ("disc",)), ("g", g_obj, ("gen", "confusion"))):
        grads = torch.autograd.grad(obj, [p for _, _, p in names], allow_unused=True,
                                    retain_graph=True)
        by_group = {}
        for (la, v, p), g in zip(names, grads):
            group = next(n for n, pred in preds.items() if pred(la))
            if group in groups:
                by_group.setdefault(group, []).append(
                    (la, v, torch.zeros_like(p) if g is None else g, jgrads[which][la][v]))
        for group, items in by_group.items():
            gmax = max(np.abs(ref).max() for *_, ref in items)
            for la, v, g, ref in items:
                np.testing.assert_allclose(
                    g.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max() + 1e-5 * gmax,
                    err_msg=f"{mode} {which}-grad {group} {la}/{v}")


def _scoped(gan):
    from rcgan_tpu_torch.core.module import scoped_modules

    return scoped_modules(gan)


def test_one_sn_group_per_d_pass(monkeypatch):
    """rcgan-u's losses: the real pass and the factorised fake pass each
    normalise D's four convs as one group (one launch on the card); with
    ``g_step_only`` only the fake pass runs.  Under concat_y the fake side
    runs ten towers, ten groups."""
    groups = []
    real = tsn.spectral_norm_group
    monkeypatch.setattr(tsn, "spectral_norm_group",
                        lambda pairs: groups.append([tuple(w.shape) for w, _ in pairs])
                        or real(pairs))
    for mode, g_only, want in (("rcgan-u", False, 2), ("rcgan-u", True, 1),
                               ("rcgan+y", False, 11), ("rcgan+y", True, 10)):
        gan, params, state, batch, z, c, *_ = _setup(mode)
        groups.clear()
        with torch.no_grad():
            mnist_losses(gan, *_tensors(batch, z, c), g_step_only=g_only)
        assert len(groups) == want, (mode, g_only, groups)
        first = 25 * (11 if mode == "rcgan+y" else 1)
        assert all(g == [(first, 8), (200, 8), (25 * (18 if mode == "rcgan+y" else 8), 8),
                         (200, 8)] for g in groups), groups
