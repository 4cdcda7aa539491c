"""The port's MNIST trainer against the JAX package's, on the CPU, float32:
one and three ``MnistTrainer`` iterations (1 D step + 2 G/C steps each)
against JAX's ``MnistTrainer.step`` from the same weights with JAX's own
``example_uniform`` latents injected (parameters, Adam moments, state,
metrics); the max-norm constraints after a step; ``step_scan`` against a
loop of ``step``; ``sample`` against JAX's; and the train-state bridge both
ways.

``TINY_MNIST`` widths, batch 6, the JAX weights with biases, BN affine and
moving statistics moved off their inits.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from rcgan_tpu.algorithms import mnist as jm
from rcgan_tpu.core.rng import example_uniform
from rcgan_tpu.models import dcgan as jd
from rcgan_tpu.train import mnist_loop as jloop
from rcgan_tpu.train.state import TrainState as JaxTrainState
from rcgan_tpu_torch.algorithms.mnist import MnistAlgoConfig
from rcgan_tpu_torch.bridge import mnist_train_state_from_jax, to_jax_train_state
from rcgan_tpu_torch.core.rng import fold_in
from rcgan_tpu_torch.models.dcgan import DCGANConfig
from rcgan_tpu_torch.train.mnist_loop import MnistTrainConfig, MnistTrainer, dataset_to_device
from torch_parity import TINY_MNIST, mnist_batch, perturb_mnist

torch.set_num_threads(min(2, torch.get_num_threads()))

B = 6
LR = 2e-4
# (algorithm, D, estimate_confuse, perm_regularizer, concat_y)
MODES = {"rcgan-u": ("rcgan", "projection", True, True, False),
         "biased": ("biased", "vanilla", False, False, False)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(mode):
    """The JAX trainer and its state (perturbed), the port's trainer and the
    same state through the bridge, and the confusion matrix."""
    alg, disc, est, perm, concat = MODES[mode]
    kw = dict(TINY_MNIST, disc_type=disc, concat_y=concat)
    akw = dict(algorithm=alg, estimate_confuse=est, perm_regularizer=perm)
    batch, _, c = mnist_batch(B, 0)
    jtr = jloop.MnistTrainer(jd.DCGANConfig(**kw), jm.MnistAlgoConfig(**akw),
                             jloop.MnistTrainConfig(), c)
    jts = jtr.init(jax.random.key(0), {k: jnp.asarray(v) for k, v in batch.items()})
    params, state = perturb_mnist(_np(jts.params), _np(jts.state), 0)
    if "d_h4_lin" in params and disc == "projection":  # let the max-norm clip bite
        params["d_h4_lin"]["Matrix"] = params["d_h4_lin"]["Matrix"] * 80.0
    groups = {g: {la: params[la] for la in d} for g, d in jts.groups.items()}
    jts = jts.replace(groups=jax.tree_util.tree_map(jnp.asarray, groups),
                      state=jax.tree_util.tree_map(jnp.asarray, state))
    tr = MnistTrainer(DCGANConfig(**kw), MnistAlgoConfig(**akw), MnistTrainConfig(), c,
                      device="cpu")
    ts = mnist_train_state_from_jax(_np(jts), tr.cfg, tr.acfg, tr.tcfg, device="cpu")
    return jtr, jts, tr, ts


def _jax_z(rng):
    """The latents JAX's ``_step`` draws from ``rng``."""
    return np.asarray(example_uniform(jax.random.fold_in(rng, 0), B, 100, None, -1.0, 1.0))


def _close_frac(got, want, tol):
    return float(np.mean(np.abs(got - want) <= tol))


def _assert_like_jax(np_ts, jts, jmetrics, metrics, steps, label):
    """Adam's first steps are sign-like (m̂/√v̂ = ±1 at count 1), so a
    gradient that is zero but for rounding (a bias that a batch-norm
    follows; a logit bias whose hinge terms cancel) becomes a step of ±lr
    with a random sign on either side.  Hence:

    - ``mu`` (the gradients' running mean) within 2e-4 of each tensor's own
      max plus 1e-5 of its group's largest, ``nu`` at 5e-4;
    - parameters within lr/100 on at least 99.9% of the elements of the
      tensors whose gradient is not zero but for rounding, and every
      element within 2·lr per update;
    - SN ``u`` within 1e-5; BN moving variances within 1e-4 of their scale,
      moving means also within the bias drift above (2·lr per update);
    - scalar metrics within 1e-4 · (1 + |x|), probabilities within 1e-4,
      the confusion matrix within 1e-5."""
    jts = _np(jts)
    counts = []
    for g, (adam, _) in np_ts.opt_states.items():
        jadam = jts.opt_states[g][0]
        assert int(adam.count) == int(jadam.count), (label, g)
        counts.append(int(adam.count))
        for mom, tol in (("mu", 2e-4), ("nu", 5e-4)):
            mine, want = getattr(adam, mom), getattr(jadam, mom)
            floor = 1e-5 * max(np.abs(a).max() for d in want.values() for a in d.values())
            for layer, d in mine.items():
                for var, got in d.items():
                    ref = want[layer][var]
                    np.testing.assert_allclose(got, ref, rtol=0,
                                               atol=tol * np.abs(ref).max() + floor,
                                               err_msg=f"{label} {mom} {layer}/{var}")
        group_max = max(np.abs(a).max() for d in jadam.mu.values() for a in d.values())
        keys = [(layer, var) for layer, d in np_ts.groups[g].items() for var in d]
        live = [k for k in keys if np.abs(jadam.mu[k[0]][k[1]]).max() > 1e-4 * group_max]
        got, want = (np.concatenate([t[la][v].ravel() for la, v in live])
                     for t in (np_ts.groups[g], jts.groups[g]))
        assert _close_frac(got, want, LR / 100) >= 0.999, (label, g)
        got, want = (np.concatenate([t[la][v].ravel() for la, v in keys])
                     for t in (np_ts.groups[g], jts.groups[g]))
        assert np.abs(got - want).max() <= 2 * LR * int(adam.count), (label, g)
    drift = 2 * LR * max(counts)
    for layer, d in np_ts.state.items():
        for var, got in d.items():
            ref = jts.state[layer][var]
            atol = {"u": 1e-5, "moving_variance": 1e-4 * np.abs(ref).max(),
                    "moving_mean": 1e-4 * np.abs(ref).max() + drift}[var]
            np.testing.assert_allclose(got, ref, rtol=0, atol=atol,
                                       err_msg=f"{label} {layer}/{var}")
    assert int(np_ts.step) == int(jts.step) == steps
    for k in ("d_loss", "d_loss_real", "d_loss_fake", "g_loss", "class_loss_real",
              "class_loss_fake"):
        want = float(jmetrics[k])
        assert abs(float(metrics[k]) - want) <= 1e-4 * (1 + abs(want)), (label, k)
    for k, tol in (("prob_real", 1e-4), ("prob_fake", 1e-4), ("confusion", 1e-5)):
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(jmetrics[k], np.float32),
                                   rtol=0, atol=tol, err_msg=f"{label} {k}")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_iterations_match_jax_after_one_and_three(mode):
    """The slice's mode (rcgan with a learned C and the perm classifier, the
    projection D) and the flags' default (biased, vanilla D): each
    iteration's batch from numpy, its ``z`` JAX's own."""
    jtr, jts, tr, ts = _setup(mode)
    for it in range(3):
        batch, _, _ = mnist_batch(B, 10 + it)
        rng = jax.random.key(100 + it)
        jts, jm_ = jtr.step(jts, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        ts, m = tr.step(ts, batch, seed=0, z=_jax_z(rng))
        if it in (0, 2):
            _assert_like_jax(to_jax_train_state(ts), jts, jm_, m, it + 1, f"{mode} it {it + 1}")
    counts = {g: st.count for g, st in ts.opt_states.items()}
    assert counts == ({"disc": 3, "gen": 6, "confusion": 6} if mode == "rcgan-u"
                      else {"disc": 3, "gen": 6})


def test_max_norm_holds_after_the_step_as_in_jax():
    """d_h4_lin/d_h5_y_lin start far outside [-1, 1] here; after one step
    they lie inside and equal JAX's clipped values; the other D weights are
    not clipped."""
    jtr, jts, tr, ts = _setup("rcgan-u")
    before = ts.groups["disc"][("d_h4_lin", "Matrix")].detach().clone()
    assert float(before.abs().max()) > 1.0
    batch, _, _ = mnist_batch(B, 5)
    rng = jax.random.key(5)
    jts, _ = jtr.step(jts, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    ts, _ = tr.step(ts, batch, seed=0, z=_jax_z(rng))
    for la in ("d_h4_lin", "d_h5_y_lin"):
        for var in ("Matrix", "bias"):
            got = ts.groups["disc"][(la, var)].detach().numpy()
            assert np.abs(got).max() <= 1.0
            np.testing.assert_allclose(got, np.asarray(jts.groups["disc"][la][var]), rtol=0,
                                       atol=4 * LR)
    assert float(ts.groups["disc"][("d_h4_lin", "Matrix")].abs().max()) == 1.0
    assert any(float(p.abs().max()) > 1.0 for k, p in ts.groups["gen"].items())


def test_step_scan_equals_a_loop_of_step():
    """Index batches gathered from the resident dataset, each iteration keyed
    by ``fold_in(seed, step)``: bit-equal to ``step`` on the same rows."""
    _, _, tr, ts_a = _setup("rcgan-u")
    _, _, _, ts_b = _setup("rcgan-u")
    n = 30
    rs = np.random.RandomState(0)
    from rcgan_tpu_torch.data.mnist import MnistData

    data = MnistData(x=rs.rand(n, 28, 28, 1).astype(np.float32),
                     y_actual=rs.randint(0, 10, n).astype(np.int32),
                     y_real=rs.randint(0, 10, n).astype(np.int32),
                     y_gen=rs.randint(0, 10, n).astype(np.int32),
                     y_fake=rs.randint(0, 10, n).astype(np.int32),
                     y_real_weights=rs.randn(n, 10).astype(np.float32),
                     confusion=np.eye(10, dtype=np.float32),
                     confusion_inv=np.eye(10, dtype=np.float32))
    ds = dataset_to_device(data, n, "cpu")
    assert ds["images"].dtype == torch.float32 and ds["y_real"].dtype == torch.int64
    idx = rs.randint(0, n, (3, B))
    for j in range(3):
        rows = {k: getattr(data, k)[idx[j]] for k in ("y_real", "y_gen", "y_fake")}
        rows.update(images=data.x[idx[j]], y_real_weights=data.y_real_weights[idx[j]])
        ts_a, m_a = tr.step(ts_a, rows, fold_in(9, ts_a.step))
    ts_b, ms = tr.step_scan(ts_b, ds, idx, 9)
    assert ms["d_loss"].shape == (3,) and ms["prob_real"].shape == (3, B)
    assert torch.equal(ms["g_loss"][-1], m_a["g_loss"])
    for a, b in zip(jax.tree_util.tree_leaves(to_jax_train_state(ts_a)),
                    jax.tree_util.tree_leaves(to_jax_train_state(ts_b))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="dataset must hold"):
        tr.step_scan(ts_b, {"images": ds["images"]}, idx, 9)


def test_sample_matches_jax():
    """``gen_sampler``: G with BN in inference mode (the perturbed moving
    statistics), float32 ``[B, 28, 28, 1]``, no state written."""
    jtr, jts, tr, ts = _setup("rcgan-u")
    rs = np.random.RandomState(3)
    z = rs.uniform(-1, 1, (B, 100)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, B)]
    before = to_jax_train_state(ts).state
    got = tr.sample(ts, z, y)
    assert got.dtype == torch.float32 and got.shape == (B, 28, 28, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jtr.sample(jts, jnp.asarray(z),
                                                                  jnp.asarray(y))),
                               rtol=0, atol=1e-5)
    after = to_jax_train_state(ts).state
    assert all(np.array_equal(before[la][v], after[la][v]) for la in before for v in before[la])


def test_train_state_bridge_round_trip_is_bit_exact():
    """JAX's MNIST TrainState (numpy leaves) → port → JAX layout: every
    group, the state (u and the moving statistics), Adam count/mu/nu and
    step bit-equal, after a port iteration so that nothing is at its init;
    and back into the port the same."""
    jtr, jts, tr, ts = _setup("rcgan-u")
    batch, _, _ = mnist_batch(B, 1)
    ts, _ = tr.step(ts, batch, seed=3)
    np_ts = to_jax_train_state(ts)
    assert set(np_ts.groups) == {"disc", "gen", "confusion"} and int(np_ts.step) == 1
    assert {la for la, d in np_ts.state.items() if "moving_mean" in d} == {
        "g_bn0", "g_bn1", "g_bn2", "d_bn1", "d_bn2", "d_bn3"}
    assert int(np_ts.opt_states["gen"][0].count) == 2
    opt = {g: (optax.ScaleByAdamState(count=jnp.asarray(a.count), mu=a.mu, nu=a.nu),
               optax.EmptyState()) for g, (a, _) in np_ts.opt_states.items()}
    jax_ts = _np(JaxTrainState(groups=np_ts.groups, state=np_ts.state, opt_states=opt,
                               step=jnp.asarray(np_ts.step)))
    # the JAX trainer steps from the bridged state
    jtr.step(jax.tree_util.tree_map(jnp.asarray, jax_ts),
             {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(1))
    back = to_jax_train_state(mnist_train_state_from_jax(jax_ts, tr.cfg, tr.acfg, tr.tcfg,
                                                         device="cpu"))
    want, want_def = jax.tree_util.tree_flatten(np_ts)
    got, got_def = jax.tree_util.tree_flatten(back)
    assert got_def == want_def
    for a, b in zip(got, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mesh_raises_naming_the_roadmap():
    """JAX's ``mesh`` is a ``parallel.DataGroup`` here (``group=``; the
    data-parallel step: ``tests/test_torch_parallel_mnist.py``); anything
    else is refused."""
    with pytest.raises(TypeError, match="DataGroup"):
        MnistTrainer(DCGANConfig(**TINY_MNIST), MnistAlgoConfig(), MnistTrainConfig(),
                     np.eye(10), group=object(), device="cpu")
