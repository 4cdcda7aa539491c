"""The port's data-parallel MNIST step (``MnistTrainer(group=...)``) on the
CPU, over 2 and 4 gloo ranks, against the JAX package's
``MnistTrainer(mesh=make_mesh(n))`` on its virtual CPU mesh, with the
configuration of ``tests/test_parallel.py:120-145`` (batch 8, z 8, widths
4/16, the projection D with spectral norm and max-norm, rcgan with a
learned C and the perm classifier, hinge) and JAX's ``z`` injected: two
iterations (1 D step + 2 G/C steps each), ``d_max_norm`` starting far
outside its clip so the constraint after the update bites on every rank.

Held: ``d_loss``, ``g_loss`` and the other scalars under JAX's cost
tolerance (``rtol 1e-4, atol 1e-5``); ``prob_real``/``prob_fake`` gathered
to ``[8]`` in JAX's order; the BN moving statistics and SN ``u`` likewise,
the moving means also within the drift of the conv bias before them
(2·lr per D update, as ``tests/test_torch_mnist_train.py`` holds them);
the parameters by the rule of ``tests/test_torch_parallel_cifar.py``
(JAX's delta tolerance on 99.9% of each group's elements, every element
within 2·lr per update: Adam's first steps are sign-like); and the ranks'
whole states bit-equal.  Rank functions are module-level; JAX is imported
inside the test functions only.
"""

import numpy as np
import pytest
import torch

from rcgan_tpu_torch.algorithms.mnist import MnistAlgoConfig
from rcgan_tpu_torch.bridge import mnist_train_state_from_jax, to_jax_train_state
from rcgan_tpu_torch.data.confusion import build_confusion
from rcgan_tpu_torch.models.dcgan import DCGANConfig
from rcgan_tpu_torch.parallel import launch
from rcgan_tpu_torch.train.mnist_loop import MnistTrainConfig, MnistTrainer
from torch_parity import assert_states_bit_equal

torch.set_num_threads(min(2, torch.get_num_threads()))

B, Z = 8, 8
LR = 2e-4
CFG = dict(batch_size=B, z_dim=Z, gf_dim=4, df_dim=4, gfc_dim=16, dfc_dim=16,
           disc_type="projection", spectral_norm=True, max_norm=True)
ACFG = dict(algorithm="rcgan", estimate_confuse=True, perm_regularizer=True, loss_fn="hinge")
TIMEOUT = 300.0
SCALARS = ("d_loss", "d_loss_real", "d_loss_fake", "g_loss", "class_loss_real",
           "class_loss_fake")


def _batches():
    """Two iterations' global batches: the first is JAX's test's batch."""
    out = []
    for seed in (0, 1):
        rs = np.random.RandomState(seed)
        out.append({"images": rs.rand(B, 28, 28, 1).astype(np.float32),
                    "y_real": rs.randint(10, size=B), "y_gen": rs.randint(10, size=B),
                    "y_fake": rs.randint(10, size=B),
                    "y_real_weights": rs.rand(B, 10).astype(np.float32)})
    return out


def _run(group, np_ts, batches, zs):
    """Two iterations from ``np_ts`` with ``zs`` injected; each iteration's
    metrics (numpy) and state."""
    tr = MnistTrainer(DCGANConfig(**CFG), MnistAlgoConfig(**ACFG), MnistTrainConfig(),
                      build_confusion(0.7)[0], group=group, device="cpu")
    ts = mnist_train_state_from_jax(np_ts, tr.cfg, tr.acfg, tr.tcfg, device="cpu")
    out = []
    for i, (batch, z) in enumerate(zip(batches, zs)):
        ts, m = tr.step(ts, batch, seed=i, z=z)
        out.append(({k: v.numpy() for k, v in m.items()}, to_jax_train_state(ts)))
    return out


def _assert_params(np_ts, ref, init, label):
    for g, ps in ref.groups.items():
        count = int(np.asarray(ref.opt_states[g][0].count))
        assert int(np.asarray(np_ts.opt_states[g][0].count)) == count, (label, g)
        mu = ref.opt_states[g][0].mu
        group_max = max(np.abs(a).max() for d in mu.values() for a in d.values())
        n_live = n_off = 0
        for la, vs in ps.items():
            for v, want in vs.items():
                got, p0 = np_ts.groups[g][la][v], init.groups[g][la][v]
                lr = LR * (10.0 if g == "confusion" else 1.0)  # confuse_multiplier
                assert np.abs(got - want).max() <= 2 * lr * count, (label, g, la, v)
                if np.abs(mu[la][v]).max() <= 1e-4 * group_max:
                    continue
                d_want = want - p0
                scale = max(float(np.abs(d_want).max()), 1e-8)
                off = np.abs((got - p0) / scale - d_want / scale) > 2e-3 + 1e-4 * np.abs(
                    d_want / scale)
                n_live, n_off = n_live + off.size, n_off + int(off.sum())
        assert n_off <= 1e-3 * n_live, (label, g, n_off, n_live)


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_match_jax_mesh(n):
    import jax
    import jax.numpy as jnp

    from rcgan_tpu.algorithms import mnist as jm
    from rcgan_tpu.core.rng import example_uniform
    from rcgan_tpu.models import dcgan as jd
    from rcgan_tpu.parallel.mesh import make_mesh
    from rcgan_tpu.train import mnist_loop as jloop

    c = build_confusion(0.7)[0]
    batches = _batches()
    jtr = jloop.MnistTrainer(jd.DCGANConfig(**CFG), jm.MnistAlgoConfig(**ACFG),
                             jloop.MnistTrainConfig(), c, mesh=make_mesh(n))
    jts = jtr.init(jax.random.key(0), {k: jnp.asarray(v) for k, v in batches[0].items()})
    np_jts = jax.tree_util.tree_map(np.asarray, jts)
    # let the max-norm clip bite after the first D update
    d_h4 = np_jts.groups["disc"]["d_h4_lin"]
    np_jts.groups["disc"]["d_h4_lin"] = dict(d_h4, Matrix=d_h4["Matrix"] * 80.0)
    jts = jts.replace(groups=jax.tree_util.tree_map(jnp.asarray, np_jts.groups))
    tr = MnistTrainer(DCGANConfig(**CFG), MnistAlgoConfig(**ACFG), MnistTrainConfig(), c,
                      device="cpu")
    init = to_jax_train_state(mnist_train_state_from_jax(np_jts, tr.cfg, tr.acfg, tr.tcfg,
                                                         device="cpu"))
    zs, want = [], []
    for i, batch in enumerate(batches):
        key = jax.random.key(10 + i)
        zs.append(np.asarray(example_uniform(jax.random.fold_in(key, 0), B, Z, None, -1.0,
                                             1.0)))
        jts, jm_ = jtr.step(jts, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        want.append(({k: np.asarray(v) for k, v in jm_.items()},
                     jax.tree_util.tree_map(np.asarray, jts)))
    ranks = launch(_run, n, backend="gloo", args=(init, batches, zs), timeout=TIMEOUT)
    for i in range(2):
        for r in range(1, n):
            assert_states_bit_equal(ranks[r][i][1], ranks[0][i][1],
                                    f"rank {r} iteration {i + 1}")
        m, (jm_, jstate) = ranks[0][i][0], want[i]
        label = f"{n} ranks iteration {i + 1}"
        for k in SCALARS:
            np.testing.assert_allclose(m[k], jm_[k], rtol=1e-4, atol=1e-5,
                                       err_msg=f"{label} {k}")
        for k in ("prob_real", "prob_fake"):
            assert m[k].shape == (B,) == jm_[k].shape
            np.testing.assert_allclose(m[k], jm_[k], rtol=1e-4, atol=1e-5,
                                       err_msg=f"{label} {k}")
        np.testing.assert_allclose(m["confusion"], jm_["confusion"], rtol=1e-4, atol=1e-5)
        got = ranks[0][i][1]
        # a moving mean also carries its conv's bias, which walks by ±lr
        # per update (a bias that a batch norm follows: module doc)
        drift = 2 * LR * int(np.asarray(jstate.opt_states["disc"][0].count))
        for la, vs in jstate.state.items():
            for v, ref in vs.items():
                np.testing.assert_allclose(got.state[la][v], ref, rtol=1e-4,
                                           atol=1e-5 + (drift if v == "moving_mean" else 0),
                                           err_msg=f"{label} {la}/{v}")
        _assert_params(got, jstate, init, label)
        clipped = np.abs(got.groups["disc"]["d_h4_lin"]["Matrix"]).max()
        assert clipped == 1.0 if i == 0 else clipped <= 1.0, label


def _scan(group):
    tr = MnistTrainer(DCGANConfig(**CFG), MnistAlgoConfig(**ACFG), MnistTrainConfig(),
                      np.eye(10), group=group, device="cpu")
    try:
        tr.step_scan(tr.init(0), {}, np.zeros((1, B), np.int64), 0)
    except ValueError as e:
        return str(e)
    return None


def test_step_scan_refuses_a_group():
    assert all("with a group, call step per iteration" in m
               for m in launch(_scan, 2, backend="gloo", timeout=TIMEOUT))
