"""The port's CIFAR losses against the JAX package, on the CPU, float32:
the loss zoo for every loss type with and without soft-plus, and
``disc_loss``/``gen_loss`` for the four algorithms with the perm classifier
on and off, including the spectral-norm ``u`` each call leaves behind (the
rcgan-u D-twice chaining, and ``gen_loss``'s frozen D with a live
projection embedding)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rcgan_tpu.algorithms import cifar as jcifar
from rcgan_tpu.algorithms import losses as jlosses
from rcgan_tpu.core.module import Ctx
from rcgan_tpu.models.resnet_gan import ResnetGANConfig as JaxConfig
from rcgan_tpu_torch.algorithms import losses as tlosses
from rcgan_tpu_torch.algorithms.cifar import (CifarAlgoConfig, CifarGAN, confusion_init_values,
                                              lr_decay, partition_predicates)
from rcgan_tpu_torch.bridge import load_tree
from rcgan_tpu_torch.core.module import state_tree
from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
from torch_parity import TINY, make_batch, perturbed_trees, to_torch

torch.set_num_threads(min(2, torch.get_num_threads()))

LOSS_TYPES = ["HINGE", "Goodfellow", "ce", "minimax", "WGAN", "WGAN-GP", "LSGAN"]


@pytest.mark.parametrize("soft_plus", [False, True])
@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_loss_zoo_matches_jax(loss_type, soft_plus):
    """d_real_loss, d_fake_loss and g_loss on logits spread over [-30, 30]
    (past softplus's cut-offs), bf16 logits included, and their gradients:
    float32 elementwise math, 1e-6 relative plus 1e-6 abs."""
    rs = np.random.RandomState(len(loss_type) + soft_plus)
    x = np.concatenate([rs.randn(40) * 3, [-30.0, -21.0, 0.0, 21.0, 30.0]]).astype(np.float32)
    for name in ("d_real_loss", "d_fake_loss", "g_loss"):
        jf, tf = getattr(jlosses, name), getattr(tlosses, name)
        ref = np.asarray(jf(jnp.asarray(x), loss_type, soft_plus))
        dref = np.asarray(jax.grad(lambda v: jnp.sum(jf(v, loss_type, soft_plus)))(jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_(True)
        out = tf(xt, loss_type, soft_plus)
        out.sum().backward()
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(xt.grad.numpy(), dref, rtol=1e-6, atol=1e-6, err_msg=name)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        refb = np.asarray(jf(jnp.asarray(x, jnp.bfloat16), loss_type, soft_plus))
        np.testing.assert_allclose(tf(xb, loss_type, soft_plus).numpy(), refb, rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="Unknown loss_type"):
        tlosses.g_loss(torch.zeros(2), "nonsense")


def test_sigmoid_ce_confusion_init_and_lr_decay_match_jax():
    rs = np.random.RandomState(0)
    logits = (rs.randn(6, 10) * 5).astype(np.float32)
    targets = (rs.rand(6, 10) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.sigmoid_ce(torch.from_numpy(logits), torch.from_numpy(targets)).numpy(),
        np.asarray(jlosses.sigmoid_ce(jnp.asarray(logits), jnp.asarray(targets))),
        rtol=1e-6, atol=1e-6)
    for diag in (0.2, 0.6, 0.995):
        a = jcifar.CifarAlgoConfig(confuse_init_diag=diag)
        np.testing.assert_array_equal(confusion_init_values(CifarAlgoConfig(confuse_init_diag=diag)),
                                      jcifar.confusion_init_values(a))
    for it in (0, 1, 25000, 49999, 50000, 120000):
        np.testing.assert_allclose(float(lr_decay(it)), float(jcifar.lr_decay(it)), rtol=1e-7)
    assert float(lr_decay(7, decay=False)) == 1.0
    preds = partition_predicates()
    assert [k for k, p in preds.items() if p("D.Output")] == ["disc"]
    assert [k for k, p in preds.items() if p("confusion_logits")] == ["confusion"]


# (algorithm, loss type, soft_plus): both noisy-label modes of the main path
# on HINGE, the other two on other loss types for coverage
MODES = [("biased", "Goodfellow", True), ("unbiased", "WGAN", False),
         ("rcgan", "HINGE", False), ("rcgan-u", "HINGE", True)]


def _jax_losses(jcfg, jacfg, params, state, batch, z, c):
    """JAX disc_loss and gen_loss, each from the same input state (as one D
    step and one G step of a trainer would see it), with the states each
    leaves behind."""
    def f(params, state, batch, z, c):
        dctx = Ctx(params=params, state=state)
        d = jcifar.disc_loss(dctx, jcfg, jacfg, batch, z, c)
        gctx = Ctx(params=params, state=state)
        g = jcifar.gen_loss(gctx, jcfg, jacfg, batch["labels_random"], batch["labels_biased"],
                            z, c)
        return d, dctx.updated_state(), g, gctx.updated_state()

    jbatch = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else jnp.float32)
              for k, v in batch.items()}
    out = jax.jit(f)(params, state, jbatch, jnp.asarray(z), jnp.asarray(c))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("perm", [False, True])
@pytest.mark.parametrize("algorithm,loss_type,soft_plus", MODES)
def test_disc_and_gen_loss_match_jax(algorithm, loss_type, soft_plus, perm, monkeypatch):
    """Costs to 1e-5 relative, disc_real/disc_fake/G to 1e-4 of their scale
    (float32, ~20 convs deep), and every u to 1e-6 (unit vectors).  JAX runs
    its all-label logits through the Pallas projection kernel (interpret)."""
    monkeypatch.setenv("RCGAN_PALLAS_PROJ", "1")
    kw = dict(TINY, algorithm=algorithm)
    acfg_kw = dict(algorithm=algorithm, loss_type=loss_type, soft_plus=soft_plus,
                   perm_classifier=perm, confuse_init=algorithm == "rcgan-u" and perm)
    gan = CifarGAN(ResnetGANConfig(**kw), CifarAlgoConfig(**acfg_kw), seed=7,
                   device="cpu")
    params, state = perturbed_trees(gan, 7)
    assert len(state) == 16 + perm
    batch, z, c = make_batch(4, 8)
    d_ref, d_state, g_ref, g_state = _jax_losses(
        JaxConfig(**kw), jcifar.CifarAlgoConfig(**acfg_kw), params, state, batch, z, c)

    args = (to_torch(batch), torch.from_numpy(z), torch.from_numpy(c))
    with torch.no_grad():
        d_out = gan.disc_loss(*args)
        d_mine = state_tree(gan)
        load_tree(gan, params, state, prefix="")  # the G step starts from the same u
        g_out = gan.gen_loss(args[0]["labels_random"], args[0]["labels_biased"], args[1], args[2])
        g_mine = state_tree(gan)

    for key, got, want in [("disc_cost", d_out, d_ref), ("perm_real", d_out, d_ref),
                           ("gen_cost", g_out, g_ref), ("perm_fake", g_out, g_ref)]:
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-5, atol=1e-7,
                                   err_msg=key)
    for key, got, want in [("disc_real", d_out, d_ref), ("disc_fake", d_out, d_ref),
                           ("confusion", d_out, d_ref), ("G", g_out, g_ref)]:
        want = want[key]
        np.testing.assert_allclose(got[key].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=key)
    for mine, ref in ((d_mine, d_state), (g_mine, g_state)):
        assert sorted(mine) == sorted(ref)
        for layer in mine:
            np.testing.assert_allclose(mine[layer]["u"].numpy(), ref[layer]["u"], rtol=0,
                                       atol=1e-6, err_msg=layer)
    # disc_loss advances every u; gen_loss only the projection's and perm's
    live = {"D.Embedding_y", "D.d_perm_classifier_h1"}
    for layer, d in g_mine.items():
        same = np.array_equal(d["u"].numpy(), state[layer]["u"])
        assert same == (layer not in live), layer
    assert not any(np.array_equal(d["u"].numpy(), state[k]["u"]) for k, d in d_mine.items())
