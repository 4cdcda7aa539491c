"""The port's CIFAR generator against the JAX package's, on the CPU, on the
same (bridged) weights and the same numpy inputs, float32."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rcgan_tpu.core.module import Ctx
from rcgan_tpu.models.resnet_gan import ResnetGANConfig as JaxConfig
from rcgan_tpu.models.resnet_gan import generator as jax_generator
from rcgan_tpu_torch.bridge import generator_from_jax
from rcgan_tpu_torch.models.resnet_gan import (Generator, Normalize, ResidualBlock,
                                               ResnetGANConfig, sample)

torch.set_num_threads(min(2, torch.get_num_threads()))


def _jax_g_params(cfg, z, labels, seed):
    """G-only JAX init, with the cond-BN tables and biases perturbed so the
    labels and biases matter."""
    ctx = Ctx(rng=jax.random.key(seed), init=True)
    jax_generator(ctx, cfg, jnp.asarray(z), jnp.asarray(labels))
    params = jax.tree_util.tree_map(np.asarray, ctx.params)
    rs = np.random.RandomState(seed)
    for d in params.values():
        for var, a in d.items():
            if var in ("scale", "offset", "Biases", "b"):
                d[var] = (a + 0.3 * rs.randn(*a.shape)).astype(np.float32)
    return params


@pytest.mark.parametrize("dim_g,batch", [(8, 6), (16, 4)])
def test_generator_matches_jax(dim_g, batch):
    """Seven convs and seven cond-BNs in float32 on both sides; the sums run
    in other orders, so outputs (tanh, in [-1, 1]) agree to 1e-4 abs."""
    rs = np.random.RandomState(dim_g)
    z = rs.randn(batch, 128).astype(np.float32)
    labels = rs.randint(0, 10, batch)
    jcfg = JaxConfig(dim_g=dim_g)
    params = _jax_g_params(jcfg, z, labels, dim_g)
    ref = jax.jit(lambda p, z, y: jax_generator(Ctx(params=p, train=True, update_sn=False),
                                                jcfg, z, y))(params, z, labels)
    gen = generator_from_jax(params, ResnetGANConfig(dim_g=dim_g), device="cpu")
    out = sample(gen, torch.from_numpy(z), torch.from_numpy(labels))
    assert out.dtype == torch.float32 and out.shape == (batch, 3072)
    assert not out.requires_grad and out.is_inference()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_seeded_init_is_deterministic_and_order_free():
    cfg = ResnetGANConfig(dim_g=8)
    a, b, c = (Generator(cfg, seed=s, device="cpu") for s in (3, 3, 4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["block1.conv1.Filters"], sc["block1.conv1.Filters"])
    # cond-BN starts at the identity affine, as in JAX
    assert torch.equal(sa["block2.n1.cbn.scale"], torch.ones(10, 16))
    assert torch.equal(sa["block2.n1.cbn.offset"], torch.zeros(10, 16))


def test_branches_not_ported_raise():
    """The branches once refused build now: layer_norm for a D scope with
    ``normalization_d`` (``tests/test_torch_ops_leftovers.py`` holds it to
    JAX's), and the unconditional generator's zero-debiased batch_norm."""
    with pytest.raises(ValueError, match="invalid resample"):
        ResidualBlock(ResnetGANConfig(dim_g=8), 8, 8, 3, "D.Block.3", resample="sideways")
    unconditional = Normalize(ResnetGANConfig(conditional=False), "G.Block.1.N1", 8)
    assert unconditional.cbn is None and unconditional.bn.zero_debias
    ln = Normalize(ResnetGANConfig(normalization_d=True), "D.Block.2.N1", 8)
    assert ln.cbn is None and ln.bn is None and ln.ln.scope == "D.Block.2.N1"
    assert ln.ln.gamma.shape == ln.ln.beta.shape == (8,)
    assert Normalize(ResnetGANConfig(normalization_g=False), "G.OutputNorm", 8).cbn is None
