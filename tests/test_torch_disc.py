"""The port's CIFAR discriminator against the JAX package, on the CPU:
``mean_pool``, the "down" residual block, ``optimized_resblock_disc1``,
``Discriminator``, the projection head (``DiscriminatorProjection``,
``all_label_logits``), ``perm_classifier``, ``entry()``'s forward, and the
gradients of ``disc_loss``.  Same weights (the port's, moved to JAX through
the bridge), same numpy inputs; float32 unless a test says otherwise, with
the SN ``u`` left behind compared as well.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rcgan_tpu.algorithms import cifar as jcifar
from rcgan_tpu.core.module import Ctx
from rcgan_tpu.models import resnet_gan as jrg
from rcgan_tpu.ops import conv as jconv
from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig, CifarGAN
from rcgan_tpu_torch.core.module import scoped_modules, state_tree
from rcgan_tpu_torch.entry import entry
from rcgan_tpu_torch.models import resnet_gan as trg
from rcgan_tpu_torch.ops import conv as tconv
from torch_parity import TINY, make_batch, perturbed_trees, to_torch

torch.set_num_threads(min(2, torch.get_num_threads()))

CFG = trg.ResnetGANConfig(**TINY)
JCFG = jrg.ResnetGANConfig(**TINY)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_states_close(torch_module, jax_state, atol=1e-6):
    """Every SN u the port holds equals the JAX state's (u' is unit-norm,
    so 1e-6 abs is float32 summation order)."""
    mine = state_tree(torch_module)
    for layer, d in mine.items():
        np.testing.assert_allclose(d["u"].numpy(), np.asarray(jax_state[layer]["u"]),
                                   rtol=0, atol=atol, err_msg=layer)


def _run_jax(fn, params, state, *args, update_sn=True, dtype=jnp.float32):
    def f(params, state, *args):
        ctx = Ctx(params=params, state=state, update_sn=update_sn, compute_dtype=dtype)
        return fn(ctx, *args), ctx.updated_state()

    out, new_state = jax.jit(f)(params, state, *args)
    return _np(out), _np(new_state)


# --------------------------------------------------------------- the blocks
def test_mean_pool_matches_jax():
    """The 4-phase slicing sum / 4, in the same order: exact in float32."""
    x = np.random.RandomState(1).randn(3, 8, 6, 5).astype(np.float32)
    ref = np.asarray(jconv.mean_pool(jnp.asarray(x)))
    np.testing.assert_array_equal(tconv.mean_pool(torch.from_numpy(x)).numpy(), ref)


@pytest.mark.parametrize("block", ["down", "optimized_disc1"])
def test_d_blocks_match_jax(block):
    """The "down" residual block (D.Block.2) and the first D block, all
    spectral-normed: outputs to 1e-5 of their scale (float32, 3x3 convs of
    at most 9*16 terms) and each u to 1e-6."""
    rs = np.random.RandomState(2)
    if block == "down":
        x = rs.randn(2, 16, 16, CFG.dim_d).astype(np.float32)
        mod = trg.ResidualBlock(CFG, CFG.dim_d, CFG.dim_d, 3, "D.Block.2", "down",
                                spectral_normed=True)
        jfn = lambda ctx, x: jrg.residual_block(ctx, JCFG, x, JCFG.dim_d, JCFG.dim_d, 3,  # noqa
                                                "D.Block.2", resample="down",
                                                spectral_normed=True)
        call = lambda x: mod(x, None)  # noqa: E731
    else:
        x = rs.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
        mod = trg.OptimizedResBlockDisc1(CFG)
        jfn = lambda ctx, x: jrg.optimized_resblock_disc1(ctx, JCFG, x)  # noqa: E731
        call = mod
    params, state = perturbed_trees(mod, 2)
    ref, ref_state = _run_jax(jfn, params, state, jnp.asarray(x))
    with torch.no_grad():
        out = call(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, x.shape[1] // 2, x.shape[2] // 2, CFG.dim_d)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    _assert_states_close(mod, ref_state)


@pytest.mark.parametrize("algorithm", ["rcgan", "rcgan-u"])
def test_discriminator_and_projection_head_match_jax(algorithm, monkeypatch):
    """Discriminator features and wgan logit, the projection embedding, the
    projection logit and the all-label logits (through the Pallas kernel,
    interpret mode, on the JAX side): 1e-4 of each output's scale
    (float32; twelve 3x3 convs deep), and the 16 u's to 1e-6."""
    monkeypatch.setenv("RCGAN_PALLAS_PROJ", "1")
    cfg, jcfg = (c.__class__(**TINY, algorithm=algorithm) for c in (CFG, JCFG))
    rs = np.random.RandomState(3)
    x = rs.uniform(-1, 1, (4, cfg.output_dim)).astype(np.float32)
    labels = rs.randint(0, 10, 4).astype(np.int32)
    holder = torch.nn.ModuleDict({"D": trg.Discriminator(cfg, seed=1),
                                  "P": trg.DiscriminatorProjection(cfg, seed=1)})
    params, state = perturbed_trees(holder, 3)

    def jfn(ctx, x, labels):
        feat, wgan = jrg.discriminator(ctx, jcfg, x, labels)
        emb = jrg.discriminator_projection(ctx, jcfg, labels)
        return (feat, wgan, emb, jrg.projection_logits(feat, wgan, emb),
                jrg.all_label_logits(ctx, jcfg, feat, wgan))

    ref, ref_state = _run_jax(jfn, params, state, jnp.asarray(x), jnp.asarray(labels))
    with torch.no_grad():
        feat, wgan = holder["D"](torch.from_numpy(x), torch.from_numpy(labels).long())
        emb = holder["P"](torch.from_numpy(labels).long())
        out = (feat, wgan, emb, trg.projection_logits(feat, wgan, emb),
               holder["P"].all_label_logits(feat, wgan))
    assert [tuple(o.shape) for o in out] == [(4, 16), (4,), (4, 16), (4,), (4, 10)]
    assert out[4].dtype == torch.float32
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert len(state_tree(holder)) == 16
    _assert_states_close(holder, ref_state)


@pytest.mark.parametrize("perm_type", ["linear", "2layer"])
def test_perm_classifier_matches_jax(perm_type):
    """SN linear (or two) on the flat image: 1e-5 of scale, u to 1e-6."""
    cfg, jcfg = (c.__class__(**TINY, perm_type=perm_type) for c in (CFG, JCFG))
    x = np.random.RandomState(4).uniform(-1, 1, (3, cfg.output_dim)).astype(np.float32)
    mod = trg.PermClassifier(cfg)
    params, state = perturbed_trees(mod, 4)
    ref, ref_state = _run_jax(lambda ctx, x: jrg.perm_classifier(ctx, jcfg, x),
                              params, state, jnp.asarray(x))
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()
    assert out.shape == (3, 10)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    _assert_states_close(mod, ref_state)


# ------------------------------------------------------------------ entry()
def _jax_entry_fwd(params, state, z, labels, dtype):
    """``__graft_entry__.entry()``'s ``fwd``, rebuilt at the tiny config;
    returns D's features as well as the logits."""
    ctx = Ctx(params=params, state=state, init=False, train=True, update_sn=False,
              compute_dtype=dtype)
    fake = jrg.generator(ctx, JCFG, z, labels)
    feat, wgan = jrg.discriminator(ctx, JCFG, fake, labels)
    emb = jrg.discriminator_projection(ctx, JCFG, labels)
    return feat, jrg.projection_logits(feat, wgan, emb)


def _bf16_ulps(x, ref):
    """|x - ref| in units of the bf16 spacing at |ref| (8 significant bits)."""
    exp = np.floor(np.log2(np.maximum(np.abs(ref), 1e-30)))
    return np.abs(x - ref) / 2.0 ** (exp - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_entry_forward_matches_jax(dtype):
    """G → D → projection logits at the tiny config, batch 8, SN frozen;
    D's features are read through a hook and compared as well.

    float32: 1e-4 of each output's scale (seven G and twelve D convs,
    summation order only).

    bfloat16: both frameworks round activations to bf16 at every conv,
    matmul and elementwise op, but not at the same places (XLA fuses
    elementwise chains in float32 before rounding; PyTorch rounds each op),
    so the two drift apart by a few bf16 ulps.  The logits are held to
    2.5e-2 of their scale (measured 1.09e-2 at this seed).  A tolerance that
    loose cannot tell a bf16 forward from a float32 one with only its output
    cast (their gap is ~5e-3 of the scale here), so two more checks pin the
    policy: D's features lie nearer to JAX's bf16 features than to JAX's
    float32 ones, by at least 2x in mean |diff| (measured 4.7x; a float32
    forward would sit at the float32 side); and some logit lies more than
    one bf16 ulp from the port's own float32 logit (measured 1.7 ulps),
    which rounding only the output, at most half an ulp, cannot do."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    fwd, (z, labels) = entry("cpu", tdt, cfg=CFG, batch=8, seed=5)
    params, state = perturbed_trees(fwd, 5)
    assert sorted(params) == sorted(k for k in params if k[:2] in ("G.", "D."))
    jax_fwd = jax.jit(_jax_entry_fwd, static_argnums=4)
    jargs = (params, state, jnp.asarray(z.numpy()), jnp.asarray(labels.numpy(), jnp.int32))
    ref_feat, ref = (np.asarray(a).astype(np.float32) for a in jax_fwd(*jargs, jdt))
    seen = {}
    fwd.D.register_forward_hook(lambda mod, args, out: seen.update(feat=out[0]))
    u_before = {k: v["u"].clone() for k, v in state_tree(fwd).items()}
    out = fwd(z, labels)
    assert out.dtype == tdt and out.shape == (8,) and out.is_inference()
    assert seen["feat"].dtype == tdt and seen["feat"].shape == (8, CFG.dim_d)
    assert all(torch.equal(state_tree(fwd)[k]["u"], u) for k, u in u_before.items())
    got, feat = out.float().numpy(), seen["feat"].float().numpy()
    scale = np.abs(ref).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale)
        np.testing.assert_allclose(feat, ref_feat, rtol=0, atol=1e-4 * np.abs(ref_feat).max())
        return
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.5e-2 * scale)
    ref32_feat, _ = (np.asarray(a) for a in jax_fwd(*jargs, jnp.float32))
    to_bf16, to_f32 = np.abs(feat - ref_feat).mean(), np.abs(feat - ref32_feat).mean()
    assert to_bf16 <= 0.5 * to_f32, (to_bf16, to_f32)
    fwd32, _ = entry("cpu", torch.float32, cfg=CFG, batch=8, seed=5)
    fwd32.load_state_dict(fwd.state_dict())
    got32 = fwd32(z, labels).numpy()
    assert _bf16_ulps(got, got32).max() > 1.0


# -------------------------------------------------------- disc_loss gradients
@pytest.mark.parametrize("algorithm", ["rcgan", "rcgan-u"])
def test_disc_loss_gradients_match_jax(algorithm):
    """d disc_cost / d(every D.* parameter and confusion_logits), port
    autograd on the CPU (plain conv, cond-BN; SN and projection through
    their autograd functions) against jax.grad, float32: each leaf to 1e-4
    of its own scale, plus 1e-6 of the largest gradient of the group for
    leaves whose gradient cancels to rounding (D.Output/b in rcgan-u)."""
    acfg = CifarAlgoConfig(algorithm=algorithm)
    jacfg = jcifar.CifarAlgoConfig(algorithm=algorithm)
    cfg, jcfg = (c.__class__(**TINY, algorithm=algorithm) for c in (CFG, JCFG))
    gan = CifarGAN(cfg, acfg, seed=6, device="cpu")
    params, state = perturbed_trees(gan, 6)
    batch, z, c = make_batch(4, 6)

    def jcost(params, state, batch, z, c):
        ctx = Ctx(params=params, state=state)
        return jcifar.disc_loss(ctx, jcfg, jacfg, batch, z, c)["disc_cost"]

    jbatch = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else jnp.float32)
              for k, v in batch.items()}
    ref_cost, ref = jax.jit(jax.value_and_grad(jcost))(params, state, jbatch, jnp.asarray(z),
                                                       jnp.asarray(c))
    ref = _np(ref)

    cost = gan.disc_loss(to_torch(batch), torch.from_numpy(z), torch.from_numpy(c))["disc_cost"]
    cost.backward()
    np.testing.assert_allclose(cost.item(), float(ref_cost), rtol=1e-5)
    layers = [k for k in params if k.startswith("D.") or k == "confusion_logits"]
    assert ("confusion_logits" in layers) == (algorithm == "rcgan-u")
    mods = scoped_modules(gan)
    group_scale = max(np.abs(g).max() for layer in layers for g in ref[layer].values())
    for layer in layers:
        for var, want in ref[layer].items():
            got = getattr(mods[layer], var).grad.numpy()
            atol = 1e-4 * np.abs(want).max() + 1e-6 * group_scale
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=f"{layer}/{var}")
