"""The port's training cycle against the JAX package, on the CPU, float32:
the scaleless Adam against optax, the train-state bridge, whole cycles of
``CifarTrainer`` against JAX's ``CifarTrainer`` from the same weights with
JAX's own random numbers injected, the four modes, and index batches from a
device-resident dataset.

Inputs come from numpy seeds.  ``TINY`` widths (dim_g 8, dim_d 16,
embedding 24), batch 4, ``n_critic`` 2, ``gen_bs_multiple`` 2.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from rcgan_tpu.algorithms import cifar as jcifar
from rcgan_tpu.core.rng import example_keys, example_normal
from rcgan_tpu.models import resnet_gan as jrg
from rcgan_tpu.train import cifar_loop as jloop
from rcgan_tpu.train.state import TrainState as JaxTrainState
from rcgan_tpu.train.state import apply_updates_with_lr, scaleless_adam
from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
from rcgan_tpu_torch.bridge import to_jax_train_state, train_state_from_jax
from rcgan_tpu_torch.data.cifar10 import device_dataset_of
from rcgan_tpu_torch.data.confusion import build_confusion
from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer
from rcgan_tpu_torch.train.state import ScalelessAdam
from torch_parity import TINY, perturbed_trees

torch.set_num_threads(min(2, torch.get_num_threads()))

B, N_CRITIC, GEN_MULT = 4, 2, 2
LR = 2e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(alg):
    perm = alg == "rcgan-u"
    acfg = CifarAlgoConfig(algorithm=alg, perm_classifier=perm, confuse_init=perm)
    jacfg = jcifar.CifarAlgoConfig(algorithm=alg, perm_classifier=perm, confuse_init=perm)
    tcfg = CifarTrainConfig(n_critic=N_CRITIC, gen_bs_multiple=GEN_MULT)
    jtcfg = jloop.CifarTrainConfig(n_critic=N_CRITIC, gen_bs_multiple=GEN_MULT)
    return (ResnetGANConfig(**TINY, algorithm=alg), acfg, tcfg,
            jrg.ResnetGANConfig(**TINY, algorithm=alg), jacfg, jtcfg)


def _jax_state(np_ts) -> JaxTrainState:
    """A port train state (bridge layout, numpy) as the JAX TrainState."""
    opt = {g: (optax.ScaleByAdamState(count=jnp.asarray(a.count), mu=a.mu, nu=a.nu),
               optax.EmptyState()) for g, (a, _) in np_ts.opt_states.items()}
    return JaxTrainState(groups=np_ts.groups, state=np_ts.state, opt_states=opt,
                         step=jnp.asarray(np_ts.step))


def _host_batches(seed, n=N_CRITIC, b=B):
    rs = np.random.RandomState(seed)
    d = {"images": rs.randint(0, 256, (n, b, 3072)).astype(np.uint8),
         "labels": rs.randint(0, 10, (n, b)).astype(np.int32),
         "labels_random": rs.randint(0, 10, (n, b)).astype(np.int32),
         "labels_biased": rs.randint(0, 10, (n, b)).astype(np.int32),
         "labels_inv_weights": rs.uniform(-0.5, 1.5, (n, b, 10)).astype(np.float32)}
    g = {"random": rs.randint(0, 10, GEN_MULT * b).astype(np.int32),
         "biased": rs.randint(0, 10, GEN_MULT * b).astype(np.int32)}
    return d, g


def _jax_noise(rng, z_dim=128):
    """The random numbers JAX's ``_cycle`` draws from ``rng`` on the CPU
    (``dequantize_chw_to_hwc_keys``, not the Pallas kernel): the G step's
    ``zg``, and per critic step ``z`` and the dequantisation ``u``."""
    zg = example_normal(jax.random.fold_in(rng, 1), GEN_MULT * B, z_dim)
    z, u = [], []
    for k in jax.random.split(jax.random.fold_in(rng, 2), N_CRITIC):
        kz, kq = jax.random.split(k)
        u.append(jax.vmap(lambda kk: jax.random.uniform(kk, (3072,), jnp.float32, 0.0,
                                                        1.0 / 128.0))(example_keys(kq, B)))
        z.append(example_normal(kz, B, z_dim))
    return {"zg": np.asarray(zg), "z": np.asarray(jnp.stack(z)), "u": np.asarray(jnp.stack(u))}


# ---------------------------------------------------------------------- Adam
def test_scaleless_adam_matches_optax_over_three_steps():
    """β = (0, 0.9) and (0.5, 0.999), lr changing every step: params and
    both moments against optax's scale_by_adam ∘ scale(-1) ×
    apply_updates_with_lr, float32, to 1e-6 relative (the same ops in the
    same order, on other kernels); bfloat16 moments are stored as such."""
    rs = np.random.RandomState(0)
    p0 = [rs.randn(6, 5).astype(np.float32), rs.randn(7).astype(np.float32)]
    grads = [[rs.randn(*p.shape).astype(np.float32) for p in p0] for _ in range(3)]
    lrs = [2e-4, 1.5e-4, 3e-1]
    for b1, b2 in ((0.0, 0.9), (0.5, 0.999)):
        tx = scaleless_adam(b1, b2)
        jp = {"l": {"a": jnp.asarray(p0[0]), "b": jnp.asarray(p0[1])}}
        js = tx.init(jp)
        adam = ScalelessAdam(b1, b2)
        tp = [torch.from_numpy(p.copy()) for p in p0]
        ts = adam.init(tp)
        for g, lr in zip(grads, lrs):
            upd, js = tx.update({"l": {"a": jnp.asarray(g[0]), "b": jnp.asarray(g[1])}}, js, jp)
            jp = apply_updates_with_lr(jp, upd, lr)
            adam.update_(tp, [torch.from_numpy(x) for x in g], ts, lr)
        assert ts.count == int(js[0].count) == 3
        for i, var in enumerate("ab"):
            for got, want in ((tp[i], jp["l"][var]), (ts.mu[i], js[0].mu["l"][var]),
                              (ts.nu[i], js[0].nu["l"][var])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    # low-precision moments are stored in their dtype (held to JAX's
    # _scale_by_adam_lowp by test_torch_app_train.py); a non-float one is refused
    assert ScalelessAdam(0.0, 0.9, moment_dtype="bfloat16").init(
        [torch.zeros(3)]).mu[0].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="moment_dtype"):
        ScalelessAdam(0.0, 0.9, moment_dtype="int32")


# -------------------------------------------------------------------- bridge
def test_train_state_bridge_round_trip_is_bit_exact():
    """JAX TrainState (numpy leaves) → port → bridge layout: every group,
    SN u, Adam count/mu/nu and step bit-equal, after one port cycle so the
    moments and counts are not zeros; and port → JAX → port the same."""
    cfg, acfg, tcfg, jcfg, jacfg, jtcfg = _configs("rcgan-u")
    c, _ = build_confusion(0.6)
    tr = CifarTrainer(cfg, acfg, tcfg, c, device="cpu")
    ts = tr.init(seed=1)
    d, g = _host_batches(1)
    ts, _ = tr.step(ts, d, g, 1, seed=3)
    np_ts = to_jax_train_state(ts)
    assert set(np_ts.groups) == {"disc", "gen", "confusion"} and int(np_ts.step) == 1
    assert int(np_ts.opt_states["gen"][0].count) == 1
    assert int(np_ts.opt_states["disc"][0].count) == N_CRITIC
    jts = _np(_jax_state(np_ts))  # the JAX class, numpy leaves
    back = to_jax_train_state(train_state_from_jax(jts, cfg, acfg, tcfg, "cpu"))
    want_leaves, want_def = jax.tree_util.tree_flatten(_jax_state(np_ts))
    got_leaves, got_def = jax.tree_util.tree_flatten(_jax_state(back))
    assert got_def == want_def
    for a, b in zip(got_leaves, want_leaves):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------- whole cycles
def _close_frac(got, want, tol):
    return float(np.mean(np.abs(got - want) <= tol))


def _assert_like_jax(np_ts, jts, jmetrics, metrics, cycles, label):
    """The bounds of the Adam trap (β₁ = 0 makes Adam's update ≈ ±lr, so a
    parameter bound alone cannot see a wrong gradient):

    - ``mu`` is the last gradient itself: each tensor within 2e-4 of its
      own max |mu| (float32 sums in another order, then through the cycles),
      plus 1e-5 of the group's largest for tensors whose gradient is zero
      but for rounding (a conv bias that a batch-norm follows, D.Output/b
      in rcgan-u);
    - ``nu`` the same, at 5e-4 (it squares the gradients);
    - params within lr/100 on at least 99.9% of the elements of each group
      (measured: all but 3e-5 of them), counted over the tensors whose
      gradient is not zero but for rounding: Adam turns such a gradient into
      a step of ±lr with a random sign, so those elements, and every element,
      are held within 2·lr per update taken instead;
    - SN u within 1e-5 (unit vectors, measured 9e-7);
    - costs within 1e-4·(1 + |cost|): float32 rounding gives ~1e-7, and
      rcgan-u's ``D.Output/b``, whose disc_loss gradient is zero but for
      rounding, walks by ±lr per D step and shifts gen_loss by as much
      (measured 8.8e-5 at cycle 3)."""
    jts = _np(jts)
    for g, (adam, _) in np_ts.opt_states.items():
        jadam = jts.opt_states[g][0]
        assert int(adam.count) == int(jadam.count), (label, g)
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
        live = [k for k in keys if np.abs(jadam.mu[k[0]][k[1]]).max() > 1e-6 * group_max] \
            if int(jadam.count) else keys
        got, want = (np.concatenate([t[la][v].ravel() for la, v in live])
                     for t in (np_ts.groups[g], jts.groups[g]))
        assert _close_frac(got, want, LR / 100) >= 0.999, (label, g)
        got, want = (np.concatenate([t[la][v].ravel() for la, v in keys])
                     for t in (np_ts.groups[g], jts.groups[g]))
        assert np.abs(got - want).max() <= 2 * LR * max(int(adam.count), 1), (label, g)
    for layer, d in np_ts.state.items():
        np.testing.assert_allclose(d["u"], jts.state[layer]["u"], rtol=0, atol=1e-5,
                                   err_msg=f"{label} u {layer}")
    assert int(np_ts.step) == int(jts.step) == cycles
    for k in ("d_cost", "d_cost_mean", "g_cost"):
        want = float(jmetrics[k])
        assert abs(float(metrics[k]) - want) <= 1e-4 * (1 + abs(want)), (label, k)
    np.testing.assert_allclose(float(metrics["lr"]), float(jmetrics["lr"]), rtol=1e-6)


@pytest.mark.parametrize("alg", ["rcgan", "rcgan-u"])
def test_cycle_matches_jax_after_one_and_three_cycles(alg):
    """Same weights (the port's, perturbed, moved to JAX through the bridge),
    same batches, JAX's own z and dequantisation noise injected: cycle 1 is
    iteration 0 (G and C skipped, their Adam counts stay 0), cycles 2 and 3
    run every step.  rcgan-u runs with the perm classifier and confuse_init."""
    cfg, acfg, tcfg, jcfg, jacfg, jtcfg = _configs(alg)
    c, _ = build_confusion(0.6)
    tr = CifarTrainer(cfg, acfg, tcfg, c, device="cpu")
    ts = tr.init(seed=2)
    perturbed_trees(ts.gan, 2)
    jtr = jloop.CifarTrainer(jcfg, jacfg, jtcfg, c)
    jts = _jax_state(to_jax_train_state(ts))
    for it in range(3):
        d, g = _host_batches(10 + it)
        key = jax.random.key(100 + it)
        jts, jm = jtr.step(jts, {k: jnp.asarray(v) for k, v in d.items()},
                           {k: jnp.asarray(v) for k, v in g.items()}, it, key)
        ts, m = tr.step(ts, d, g, it, seed=0, noise=_jax_noise(key))
        if it == 0:
            assert float(m["g_cost"]) == 0.0 and ts.opt_states["gen"].count == 0
            assert ("confusion" in ts.opt_states) == (alg == "rcgan-u")
            if alg == "rcgan-u":
                assert ts.opt_states["confusion"].count == 0
        if it in (0, 2):
            _assert_like_jax(to_jax_train_state(ts), jts, jm, m, it + 1, f"{alg} cycle {it + 1}")


@pytest.mark.parametrize("alg", ["biased", "unbiased", "rcgan", "rcgan-u"])
def test_every_mode_cycles(alg):
    """Two cycles with the port's own noise (the dequantisation through the
    kernel's plain route): g_cost is 0 at iteration 0 and finite after, the
    D params move, the confusion group exists only for rcgan-u, the costs
    are finite device tensors, and the same seed repeats the run exactly."""
    cfg = ResnetGANConfig(**TINY, algorithm=alg)
    acfg = CifarAlgoConfig(algorithm=alg, perm_classifier=alg == "rcgan-u",
                           confuse_init=alg == "rcgan-u")
    tcfg = CifarTrainConfig(n_critic=N_CRITIC, gen_bs_multiple=GEN_MULT)
    tr = CifarTrainer(cfg, acfg, tcfg, build_confusion(0.6)[0], "cpu")
    runs = []
    for _ in range(2):
        ts = tr.init(seed=4)
        d0 = [p.detach().clone() for p in ts.group_params("disc")]
        d, g = _host_batches(4)
        ts, m0 = tr.step(ts, d, g, 0, seed=7)
        assert float(m0["g_cost"]) == 0.0 and np.isfinite(float(m0["d_cost"]))
        ts, m1 = tr.step(ts, d, g, 1, seed=8)
        assert np.isfinite(float(m1["g_cost"])) and float(m1["g_cost"]) != 0.0
        assert all(torch.is_tensor(v) and v.shape == () for v in m1.values())
        assert any(not torch.equal(a, p) for a, p in zip(d0, ts.group_params("disc")))
        assert ("confusion" in ts.groups) == (alg == "rcgan-u")
        runs.append(to_jax_train_state(ts))
    for a, b in zip(jax.tree_util.tree_leaves(runs[0]), jax.tree_util.tree_leaves(runs[1])):
        np.testing.assert_array_equal(a, b)


def test_device_dataset_index_batches_equal_host_fed_rows():
    """``{"index": ...}`` batches gathered from the resident dataset give the
    same cycle, bit for bit, as the same rows fed from the host (JAX's
    test_cifar_device_dataset_matches_host_fed); step_scan equals a loop of
    step with the step-keyed seed; eval_disc_cost updates nothing."""
    cfg, acfg, tcfg, *_ = _configs("rcgan")
    c, _ = build_confusion(0.6)
    n = 16
    rs = np.random.RandomState(0)
    from rcgan_tpu_torch.data.confusion import corrupt_dataset_numpy

    y = rs.randint(0, 10, n)
    lr_, lg, lb, w = corrupt_dataset_numpy(rs, y, *build_confusion(0.6))
    ds_np = {"images": rs.randint(0, 256, (n, 3072)).astype(np.uint8), "labels": lr_,
             "labels_random": lg, "labels_biased": lb, "labels_inv_weights": w}
    ds = device_dataset_of(ds_np, "cpu")
    assert ds["images"].dtype == torch.uint8 and ds["labels"].dtype == torch.int32
    idx = rs.randint(0, n, (2, N_CRITIC, B))
    g = {"random": rs.randint(0, 10, (2, GEN_MULT * B)), "biased": rs.randint(0, 10, (2, GEN_MULT * B))}

    tr_host = CifarTrainer(cfg, acfg, tcfg, c, "cpu")
    tr_dev = CifarTrainer(cfg, acfg, tcfg, c, "cpu", device_dataset=ds)
    ts_h, ts_d, ts_s = tr_host.init(5), tr_dev.init(5), tr_dev.init(5)
    from rcgan_tpu_torch.core.rng import fold_in

    for j in range(2):
        host = {k: v[idx[j]] for k, v in ds_np.items()}
        gl = {k: v[j] for k, v in g.items()}
        ts_h, m_h = tr_host.step(ts_h, host, gl, ts_h.step, fold_in(9, ts_h.step))
        ts_d, m_d = tr_dev.step(ts_d, {"index": idx[j]}, gl, ts_d.step, fold_in(9, ts_d.step))
        for k in m_h:
            assert torch.equal(m_h[k], m_d[k]), k
    ts_s, ms = tr_dev.step_scan(ts_s, idx, g["random"], g["biased"], 9)
    assert ms["d_cost"].shape == (2,) and torch.equal(ms["d_cost"][-1], m_d["d_cost"])
    for a, b in zip(jax.tree_util.tree_leaves(to_jax_train_state(ts_h)),
                    jax.tree_util.tree_leaves(to_jax_train_state(ts_s))):
        np.testing.assert_array_equal(a, b)

    before = to_jax_train_state(ts_h)
    cost = tr_host.eval_disc_cost(ts_h, {k: v[:B] for k, v in ds_np.items()}, seed=3)
    assert cost.shape == () and np.isfinite(float(cost))
    for a, b in zip(jax.tree_util.tree_leaves(before),
                    jax.tree_util.tree_leaves(to_jax_train_state(ts_h))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="device_dataset"):
        tr_host.step(ts_h, {"index": idx[0]}, {k: v[0] for k, v in g.items()}, 1, 0)
