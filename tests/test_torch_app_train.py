"""The app's training pieces in the port against the JAX package, on the
CPU: the dev cost over index batches (``eval_disc_cost_scan``) and
``sample`` with JAX's noise injected, the bfloat16 Adam moments against
``_scale_by_adam_lowp``, and checkpoints (a round trip bit for bit, the
newest five kept, the partial restore).

``TINY`` widths (dim_g 8, dim_d 16, embedding 24), batch 4, ``n_critic`` 2.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from rcgan_tpu.algorithms import cifar as jcifar
from rcgan_tpu.models import resnet_gan as jrg
from rcgan_tpu.train import cifar_loop as jloop
from rcgan_tpu.train.state import TrainState as JaxTrainState
from rcgan_tpu.train.state import apply_updates_with_lr, scaleless_adam
from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
from rcgan_tpu_torch.bridge import to_jax_train_state
from rcgan_tpu_torch.data.cifar10 import device_dataset_of
from rcgan_tpu_torch.data.confusion import build_confusion, corrupt_dataset_numpy
from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
from rcgan_tpu_torch.train.checkpoint import Checkpointer, optimistic_restore, state_payload
from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer
from rcgan_tpu_torch.train.state import ScalelessAdam
from torch_parity import TINY, perturbed_trees

torch.set_num_threads(min(2, torch.get_num_threads()))

B, N_CRITIC, GEN_MULT = 4, 2, 2


def _trainer(alg="rcgan-u", moment_dtype=None):
    perm = alg == "rcgan-u"
    cfg = ResnetGANConfig(**TINY, algorithm=alg)
    acfg = CifarAlgoConfig(algorithm=alg, perm_classifier=perm, confuse_init=perm)
    tcfg = CifarTrainConfig(n_critic=N_CRITIC, gen_bs_multiple=GEN_MULT, moment_dtype=moment_dtype)
    return CifarTrainer(cfg, acfg, tcfg, build_confusion(0.6)[0], "cpu")


def _jax_trainer(alg="rcgan-u"):
    perm = alg == "rcgan-u"
    return jloop.CifarTrainer(jrg.ResnetGANConfig(**TINY, algorithm=alg),
                              jcifar.CifarAlgoConfig(algorithm=alg, perm_classifier=perm,
                                                     confuse_init=perm),
                              jloop.CifarTrainConfig(n_critic=N_CRITIC, gen_bs_multiple=GEN_MULT),
                              build_confusion(0.6)[0])


def _jax_state(np_ts) -> JaxTrainState:
    opt = {g: (optax.ScaleByAdamState(count=jnp.asarray(a.count), mu=a.mu, nu=a.nu),
               optax.EmptyState()) for g, (a, _) in np_ts.opt_states.items()}
    return JaxTrainState(groups=np_ts.groups, state=np_ts.state, opt_states=opt,
                         step=jnp.asarray(np_ts.step))


def _dataset(n, seed):
    rs = np.random.RandomState(seed)
    y = rs.randint(0, 10, n)
    labels, lr_, lb, w = corrupt_dataset_numpy(rs, y, *build_confusion(0.6))
    return {"images": rs.randint(0, 256, (n, 3072)).astype(np.uint8), "labels": labels,
            "labels_random": lr_, "labels_biased": lb, "labels_inv_weights": w}


def _host_batches(seed):
    rs = np.random.RandomState(seed)
    d = _dataset(N_CRITIC * B, seed)
    d = {k: v.reshape((N_CRITIC, B) + v.shape[1:]) for k, v in d.items()}
    g = {"random": rs.randint(0, 10, GEN_MULT * B), "biased": rs.randint(0, 10, GEN_MULT * B)}
    return d, g


@pytest.mark.parametrize("alg", ["rcgan", "rcgan-u"])
def test_dev_cost_scan_and_sample_match_jax(alg):
    """Same weights (perturbed, moved through the bridge), SN ``u`` after one
    cycle: the mean dev cost over three index batches of a resident split
    with JAX's own z and dequantisation noise injected (JAX's keys: split
    over the batches, each split into ``kq``/``kz``), within
    1e-4·(1 + |cost|) as the cycle tests; no state moves.  Then ``sample``
    on JAX's z and labels, within 1e-4 of the [-1, 1] images."""
    tr = _trainer(alg)
    ts = tr.init(seed=3)
    perturbed_trees(ts.gan, 3)
    d, g = _host_batches(1)
    ts, _ = tr.step(ts, d, g, 1, seed=5)
    jts = _jax_state(to_jax_train_state(ts))
    ds_np = _dataset(16, 2)
    idx = np.arange(12, dtype=np.int32).reshape(3, B)[:, ::-1].copy()
    key = jax.random.key(7)
    zs, us = [], []
    for k in jax.random.split(key, 3):
        kq, kz = jax.random.split(k)
        us.append(jax.random.uniform(kq, (B, 3072), jnp.float32, 0.0, 1.0 / 128.0))
        zs.append(jax.random.normal(kz, (B, 128), jnp.float32))
    noise = {"z": np.asarray(jnp.stack(zs)), "u": np.asarray(jnp.stack(us))}
    want = float(_jax_trainer(alg).eval_disc_cost_scan(
        jts, {k: jnp.asarray(v) for k, v in ds_np.items()}, jnp.asarray(idx), key))
    before = to_jax_train_state(ts)
    got = tr.eval_disc_cost_scan(ts, device_dataset_of(ds_np, "cpu"), idx, seed=0, noise=noise)
    assert got.shape == () and abs(float(got) - want) <= 1e-4 * (1 + abs(want))
    for a, b in zip(jax.tree_util.tree_leaves(before),
                    jax.tree_util.tree_leaves(to_jax_train_state(ts))):
        np.testing.assert_array_equal(a, b)
    # the port's own noise: the dequantisation through the kernel's plain route
    own = tr.eval_disc_cost_scan(ts, device_dataset_of(ds_np, "cpu"), idx, seed=0)
    assert np.isfinite(float(own)) and torch.equal(
        own, tr.eval_disc_cost_scan(ts, device_dataset_of(ds_np, "cpu"), idx, seed=0))

    z = np.random.RandomState(4).randn(6, 128).astype(np.float32)
    labels = np.array([0, 3, 9, 1, 1, 5], np.int32)
    want_img = np.asarray(_jax_trainer(alg).sample(jts, jnp.asarray(z), jnp.asarray(labels)))
    got_img = tr.sample(ts, z, labels)
    assert got_img.dtype == torch.float32 and got_img.shape == (6, 3072)
    np.testing.assert_allclose(got_img.numpy(), want_img, rtol=0, atol=1e-4)


def test_bf16_adam_moments_match_jax_lowp():
    """``ScalelessAdam(moment_dtype="bfloat16")`` against
    ``scaleless_adam(..., moment_dtype="bfloat16")`` (``_scale_by_adam_lowp``)
    over three steps with the lr changing: moments stored in bfloat16 and
    equal to JAX's (float32 arithmetic in another order may flip a bf16
    rounding: at most one bf16 ulp, on under 1% of the elements), params
    within 1e-6 relative."""
    rs = np.random.RandomState(0)
    p0 = [rs.randn(16, 9).astype(np.float32), rs.randn(33).astype(np.float32)]
    grads = [[rs.randn(*p.shape).astype(np.float32) for p in p0] for _ in range(3)]
    for b1, b2 in ((0.0, 0.9), (0.5, 0.999)):
        tx = scaleless_adam(b1, b2, moment_dtype="bfloat16")
        jp = {"l": {"a": jnp.asarray(p0[0]), "b": jnp.asarray(p0[1])}}
        js = tx.init(jp)
        adam = ScalelessAdam(b1, b2, moment_dtype="bfloat16")
        tp = [torch.from_numpy(p.copy()) for p in p0]
        ts = adam.init(tp)
        assert all(m.dtype == torch.bfloat16 for m in ts.mu + ts.nu)
        for g, lr in zip(grads, (2e-4, 1.5e-4, 3e-1)):
            upd, js = tx.update({"l": {"a": jnp.asarray(g[0]), "b": jnp.asarray(g[1])}}, js, jp)
            jp = apply_updates_with_lr(jp, upd, lr)
            adam.update_(tp, [torch.from_numpy(x) for x in g], ts, lr)
        assert ts.count == int(js.count) == 3
        for i, var in enumerate("ab"):
            np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp["l"][var]), rtol=1e-6,
                                       atol=1e-7)
            for got, want in ((ts.mu[i], js.mu["l"][var]), (ts.nu[i], js.nu["l"][var])):
                got = got.float().numpy()
                want = np.asarray(want.astype(jnp.float32))
                np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
                assert np.mean(got != want) < 0.01
    with pytest.raises(ValueError, match="moment_dtype"):
        ScalelessAdam(0.0, 0.9, moment_dtype="int8")


def _leaves(ts):
    p = state_payload(ts)
    out = {}
    for g, d in p["groups"].items():
        out.update({f"groups/{g}/{k}": v for k, v in d.items()})
    out.update({f"state/{k}": v for k, v in p["state"].items()})
    for g, st in p["opt_states"].items():
        out[f"count/{g}"] = torch.tensor(st["count"])
        for mom in ("mu", "nu"):
            out.update({f"{mom}/{g}/{k}": v for k, v in st[mom].items()})
    out["step"] = torch.tensor(p["step"])
    return out


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_checkpointer_round_trip_is_bit_exact(tmp_path, moment_dtype):
    """After two cycles (moments, counts and SN ``u`` not at their init),
    save and restore into a train state drawn from another seed: every
    leaf (params of the three groups, SN ``u``, Adam count/mu/nu in their
    stored dtype, step) bit-equal and of the same dtype.  Without a
    checkpoint ``restore`` gives None and leaves the template as it was."""
    tr = _trainer("rcgan-u", moment_dtype)
    ts = tr.init(seed=1)
    for it in range(2):
        d, g = _host_batches(it)
        ts, _ = tr.step(ts, d, g, it, seed=it)
    ck = Checkpointer(str(tmp_path / "ck"))
    assert ck.latest_step() is None and ck.restore(tr.init(seed=9)) is None
    ck.save(1, ts)
    other = tr.init(seed=9)
    assert ck.restore(other) is other and ck.latest_step() == 1
    want, got = _leaves(ts), _leaves(other)
    assert set(got) == set(want) and len(want) > 100
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert other.opt_states["gen"].count == 1 and other.opt_states["disc"].count == 2 * N_CRITIC
    assert other.step == 2
    # the restored state trains on exactly as the saved one
    d, g = _host_batches(5)
    ts, m1 = tr.step(ts, d, g, 2, seed=3)
    other, m2 = tr.step(other, d, g, 2, seed=3)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)


def test_checkpointer_keeps_the_newest_five_and_restores_partially(tmp_path):
    """``max_to_keep=5``; a write leaves no temporary directory; an rcgan-u
    checkpoint restores into an rcgan state through ``optimistic_restore``
    (every G and D leaf and the D/G optimiser slots, not the confusion
    group), while the strict ``restore`` refuses it."""
    tr = _trainer("rcgan-u")
    ts = tr.init(seed=1)
    ck = Checkpointer(str(tmp_path / "ck"))
    for step in range(7):
        ck.save(step, ts)
    ck.close()
    assert ck.steps() == [2, 3, 4, 5, 6]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["2", "3", "4", "5", "6"]
    plain = _trainer("rcgan").init(seed=4)
    with pytest.raises(KeyError):
        Checkpointer(str(tmp_path / "ck")).restore(plain)
    plain, n = optimistic_restore(plain, str(tmp_path / "ck"))
    assert n > 50
    g_key = next(iter(plain.groups["gen"]))
    assert torch.equal(plain.groups["gen"][g_key], ts.groups["gen"][g_key])
    assert optimistic_restore(plain, str(tmp_path / "empty"))[1] == 0
