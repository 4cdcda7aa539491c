"""The port's data-parallel CIFAR cycle (``CifarTrainer(group=...)``) on the
CPU, over gloo ranks, against the JAX package's ``CifarTrainer(mesh=
make_mesh(2))`` on its 8-device virtual CPU mesh (``tests/conftest.py``):
two cycles (iterations 1 and 2) at ``dim 8``, ``embedding 12``, global
batch 16, ``n_critic`` 2, with JAX's ``z``, ``zg`` and dequantisation noise
injected, rcgan and rcgan-u with the perm classifier, G's cond-BN on (both
sides take per-shard moments).  Then: the ranks' whole train states are
bit-equal; with ``normalization_g=False`` a 2-rank and a 4-rank run match
the one-process run (the layout does not change the noise, as JAX's slow
test holds); ``step_scan`` refuses a group.

JAX's tolerances (``tests/test_parallel.py:95-117``): costs ``rtol 1e-4,
atol 1e-5``; parameter deltas ``rtol 1e-4, atol 2e-3`` of the update's
scale; the SN ``u`` and the Adam moments the same way.  Adam's first steps
are sign-like (``g / (|g| + eps)`` at count 1), so an element whose
gradient is at rounding level (1e-5 of its tensor's largest) moves by ±lr
with a random sign on either side; JAX's own test meets this at under
0.01% of the elements (``tests/test_parallel.py:108-113``), and between
the frameworks it reaches 0.17% of one 576-element tensor.  So, as
``tests/test_torch_train.py`` holds the port to JAX: the deltas within
JAX's tolerance on at least 99.9% of each group's elements, and every
element within 2·lr per update.  A tensor whose
gradient is zero but for rounding (a conv bias that a batch norm follows,
D.Output/b in rcgan-u; under 1e-4 of its group's largest, as
``tests/test_torch_mnist_train.py`` draws the line) takes Adam steps of
±lr with a random sign on either side (``tests/test_torch_train.py``): such
tensors are held to 2·lr per update instead.  The weights are the seed's
own, not perturbed as ``tests/test_torch_train.py`` perturbs them: with
biases moved ahead of G's batch norms the first G gradients lose three
digits to cancellation in either framework, and Adam's sign-like first
steps turn that into update differences (measured: 20% of G.Input/W past
2e-3 of the update's scale after two cycles, one device against JAX's one
device, batch 16).

Rank functions are module-level and this module imports JAX only inside
its test functions (a spawned rank imports this module).
"""

import numpy as np
import pytest
import torch

from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
from rcgan_tpu_torch.bridge import to_jax_train_state
from rcgan_tpu_torch.data.confusion import build_confusion
from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
from rcgan_tpu_torch.parallel import launch
from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer
from torch_parity import (assert_deltas_close, assert_states_bit_equal, bridge_of, jax_noise,
                          out_bias)

torch.set_num_threads(min(2, torch.get_num_threads()))

B, N_CRITIC, GEN_MULT = 16, 2, 2
WIDTHS = dict(dim_g=8, dim_d=8, embedding_dim=12)
TIMEOUT = 300.0


def _configs(alg, norm_g=True):
    perm = alg == "rcgan-u"
    return (ResnetGANConfig(**WIDTHS, algorithm=alg, normalization_g=norm_g),
            CifarAlgoConfig(algorithm=alg, perm_classifier=perm, confuse_init=perm),
            CifarTrainConfig(n_critic=N_CRITIC, gen_bs_multiple=GEN_MULT))


def _feeds(seed):
    """Two cycles' global batches and labels, numpy."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        d = {"images": rs.randint(0, 256, (N_CRITIC, B, 3072)).astype(np.uint8),
             "labels": rs.randint(0, 10, (N_CRITIC, B)).astype(np.int32),
             "labels_random": rs.randint(0, 10, (N_CRITIC, B)).astype(np.int32),
             "labels_biased": rs.randint(0, 10, (N_CRITIC, B)).astype(np.int32),
             "labels_inv_weights": rs.uniform(-0.5, 1.5, (N_CRITIC, B, 10)).astype(np.float32)}
        g = {"random": rs.randint(0, 10, GEN_MULT * B).astype(np.int32),
             "biased": rs.randint(0, 10, GEN_MULT * B).astype(np.int32)}
        out.append((d, g))
    return out


def _run(group, alg, norm_g, feeds, noises, seed=3):
    """Two cycles (iterations 1 and 2) from the seed's weights;
    ``noises[i]`` the injected noise of cycle ``i`` (None: the port's own,
    cycle ``i`` keyed by ``seed + i``).  Returns each cycle's metrics and
    the train state after it, in the bridge's numpy layout."""
    cfg, acfg, tcfg = _configs(alg, norm_g)
    tr = CifarTrainer(cfg, acfg, tcfg, build_confusion(0.6)[0], device="cpu", group=group)
    ts = tr.init(seed)
    out = [(None, to_jax_train_state(ts))]
    for i, ((d, g), noise) in enumerate(zip(feeds, noises)):
        ts, m = tr.step(ts, d, g, i + 1, seed + i, noise=noise)
        out.append(({k: float(v) for k, v in m.items()}, to_jax_train_state(ts)))
    return out


def _jax_mesh_run(alg, feeds, init_np):
    """JAX's ``CifarTrainer`` on a 2-device mesh from the port's initial
    state, two cycles; returns the keys, each cycle's metrics and states."""
    import jax
    import jax.numpy as jnp
    import optax

    from rcgan_tpu.algorithms import cifar as jcifar
    from rcgan_tpu.models import resnet_gan as jrg
    from rcgan_tpu.parallel.mesh import make_mesh
    from rcgan_tpu.train import cifar_loop as jloop
    from rcgan_tpu.train.state import TrainState

    perm = alg == "rcgan-u"
    jtr = jloop.CifarTrainer(jrg.ResnetGANConfig(**WIDTHS, algorithm=alg),
                             jcifar.CifarAlgoConfig(algorithm=alg, perm_classifier=perm,
                                                    confuse_init=perm),
                             jloop.CifarTrainConfig(n_critic=N_CRITIC, gen_bs_multiple=GEN_MULT),
                             build_confusion(0.6)[0], mesh=make_mesh(2))
    opt = {g: (optax.ScaleByAdamState(count=jnp.asarray(a.count), mu=a.mu, nu=a.nu),
               optax.EmptyState()) for g, (a, _) in init_np.opt_states.items()}
    jts = TrainState(groups=init_np.groups, state=init_np.state, opt_states=opt,
                     step=jnp.asarray(init_np.step))
    keys, out = [], []
    for i, (d, g) in enumerate(feeds):
        key = jax.random.key(100 + i)
        jts, m = jtr.step(jts, {k: jnp.asarray(v) for k, v in d.items()},
                          {k: jnp.asarray(v) for k, v in g.items()}, i + 1, key)
        keys.append(key)
        out.append(({k: float(v) for k, v in m.items()}, jax.tree_util.tree_map(np.asarray, jts)))
    return keys, out


@pytest.mark.parametrize("alg", ["rcgan", "rcgan-u"])
def test_two_ranks_match_jax_mesh_and_stay_one_model(alg):
    """Two gloo ranks against JAX's 2-device mesh from the same weights, the
    same global batches and JAX's noise; after every cycle both ranks' whole
    train states (parameters, state, moments, counts, step) are bit-equal."""
    feeds = _feeds(7)
    init = _run(None, alg, True, [], [])[0][1]  # the ranks' starting state, built alike
    keys, want = _jax_mesh_run(alg, feeds, init)
    noises = [jax_noise(k, B, N_CRITIC, GEN_MULT) for k in keys]
    ranks = launch(_run, 2, backend="gloo", args=(alg, True, feeds, noises), timeout=TIMEOUT)
    assert_states_bit_equal(ranks[0][0][1], init, f"{alg} initial state")
    for i in range(1, 3):
        assert_states_bit_equal(ranks[0][i][1], ranks[1][i][1], f"{alg} ranks after cycle {i}")
        m, (jm, jts) = ranks[0][i][0], want[i - 1]
        for k in ("d_cost", "d_cost_mean"):
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, atol=1e-5, err_msg=f"{alg} {k}")
        # D.Output/b enters gen_cost with weight -1 and disc_cost not at all
        # (real and fake cancel): its rounding-driven ±lr walk (module doc)
        # is taken out of g_cost
        jprev = init if i == 1 else want[i - 2][1]
        np.testing.assert_allclose(m["g_cost"] + out_bias(ranks[0][i - 1][1]),
                                   jm["g_cost"] + out_bias(jprev), rtol=1e-4, atol=1e-5,
                                   err_msg=f"{alg} g_cost")
        np.testing.assert_allclose(m["lr"], jm["lr"], rtol=1e-6)
        assert ranks[0][i][1].step == i
        assert_deltas_close(ranks[0][i][1], bridge_of(jts), init, f"{alg} cycle {i}", i)


@pytest.mark.parametrize("n", [2, 4])
def test_layout_does_not_change_the_noise(n):
    """With ``normalization_g=False`` (per-shard moments are the one
    layout-dependent piece), ``n`` ranks drawing their own noise by global
    row match the one-process run under JAX's tolerances."""
    feeds = _feeds(11)
    one = _run(None, "rcgan", False, feeds, [None, None])
    ranks = launch(_run, n, backend="gloo", args=("rcgan", False, feeds, [None, None]),
                   timeout=TIMEOUT)
    for i in range(1, 3):
        for k in ("d_cost", "d_cost_mean", "g_cost"):
            np.testing.assert_allclose(ranks[0][i][0][k], one[i][0][k], rtol=1e-4, atol=1e-5)
        assert_deltas_close(ranks[0][i][1], one[i][1], one[0][1], f"{n} ranks cycle {i}", i)
        for r in range(1, n):
            assert_states_bit_equal(ranks[r][i][1], ranks[0][i][1], f"rank {r} cycle {i}")


def _scan(group):
    cfg, acfg, tcfg = _configs("rcgan")
    tr = CifarTrainer(cfg, acfg, tcfg, build_confusion(0.6)[0], device="cpu", group=group)
    try:
        tr.step_scan(tr.init(0), np.zeros((1, N_CRITIC, B), np.int32),
                     np.zeros((1, GEN_MULT * B)), np.zeros((1, GEN_MULT * B)), 0)
    except ValueError as e:
        return str(e)
    return None


def test_step_scan_refuses_a_group():
    msgs = launch(_scan, 2, backend="gloo", timeout=TIMEOUT)
    assert all("with a group, call step per cycle" in m for m in msgs)
