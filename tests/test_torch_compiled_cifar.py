"""The CIFAR cycle's one body (``CifarTrainer._cycle``), which the card
captures into a CUDA graph, on the CPU at tiny widths: every piece of state
keeps its address across cycles; the cycles chain to the same bits as the
cycle written with host floats and rebound state,
and to JAX's ``step`` within the tolerances of ``test_torch_train.py``; the
host part packs today's scalars; ``step_scan``'s block equals JAX's
``step_scan`` and K calls of ``step``; ``restore`` writes into the live
tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcgan_tpu.train import cifar_loop as jloop
from rcgan_tpu_torch.algorithms.cifar import lr_decay
from rcgan_tpu_torch.bridge import to_jax_train_state, train_state_from_jax
from rcgan_tpu_torch.core import rng
from rcgan_tpu_torch.data.cifar10 import (dequantize_chw_to_hwc, dequantize_chw_to_hwc_seeded,
                                          device_dataset_of)
from rcgan_tpu_torch.data.confusion import build_confusion
from rcgan_tpu_torch.train.checkpoint import Checkpointer
from rcgan_tpu_torch.train.cifar_loop import CifarTrainer
from rcgan_tpu_torch.train.state import _bias_correction, grads_of, state_buffers, trainable
from test_torch_compiled_graphs import _adam_with_host_floats
from test_torch_train import (B, GEN_MULT, N_CRITIC, _assert_like_jax, _configs, _host_batches,
                              _jax_noise, _jax_state)
from torch_parity import assert_states_bit_equal, perturbed_trees

torch.set_num_threads(min(2, torch.get_num_threads()))


def _host_float_cycle(tr, ts, d, g, iteration, seed, noise=None):
    """The cycle written with host floats for the learning rates and Adam's
    bias corrections, the seeds' int forms, and the state rebound by each
    layer and left there: the reference the one body is held to."""
    cfg, tcfg = tr.cfg, tr.tcfg
    decay = float(lr_decay(iteration, tcfg.decay))
    lr = tcfg.lr * decay
    confuse_lr = tcfg.lr * tcfg.confuse_multiplier * (decay if tcfg.confuse_lr_decay else 1.0)
    batches = tr._batch_to_device(d)
    b = batches["labels"].shape[1]
    gb = tcfg.gen_bs_multiple * b
    seeds = rng.cycle_seeds(seed, tcfg.n_critic, b)
    noise = None if noise is None else {k: torch.from_numpy(v) for k, v in noise.items()}
    if iteration > 0:
        zg = noise["zg"] if noise else rng.example_normal(seeds.g_z, gb, cfg.z_dim, "cpu")
        names = [n for n in ("gen", "confusion") if n in ts.groups]
        params = [p for n in names for p in ts.group_params(n)]
        with trainable(ts, names):
            out = ts.gan.gen_loss(torch.as_tensor(g["random"]).long(),
                                  torch.as_tensor(g["biased"]).long(), zg, tr.confusion_actual)
            grads = grads_of(out["gen_cost"], params)
        i = 0
        for n in names:
            ps = ts.group_params(n)
            _adam_with_host_floats(tr.optimizers[n], ps, grads[i:i + len(ps)], ts.opt_states[n],
                                   lr if n == "gen" else confuse_lr)
            i += len(ps)
        g_cost = out["gen_cost"].detach()
    else:
        g_cost = torch.zeros(())
    d_costs = []
    for k in range(tcfg.n_critic):
        batch = {key: v[k] for key, v in batches.items()}
        if noise:
            real = dequantize_chw_to_hwc(batch["images"], noise["u"][k], cfg.img_size, cfg.img_dim)
            z = noise["z"][k]
        else:
            real = dequantize_chw_to_hwc_seeded(batch["images"],
                                                torch.from_numpy(seeds.dequant[k]),
                                                cfg.img_size, cfg.img_dim)
            z = rng.example_normal(seeds.d_z[k], b, cfg.z_dim, "cpu")
        sb = dict({key: batch[key] for key in ("labels", "labels_random", "labels_biased",
                                               "labels_inv_weights")}, real_data=real)
        params = ts.group_params("disc")
        with trainable(ts, ["disc"]):
            out = ts.gan.disc_loss(sb, z, tr.confusion_actual)
            grads = grads_of(out["disc_cost"], params)
        _adam_with_host_floats(tr.optimizers["disc"], params, grads, ts.opt_states["disc"], lr)
        d_costs.append(out["disc_cost"].detach())
    ts.step += 1
    d_costs = torch.stack(d_costs)
    return {"d_cost": d_costs[-1], "d_cost_mean": d_costs.mean(), "g_cost": g_cost,
            "lr": torch.full((), lr)}


def _addresses(tr, ts):
    out = {f"{g}/{k}": p.data_ptr() for g, ps in ts.groups.items() for k, p in ps.items()}
    for g, st in ts.opt_states.items():
        out.update({f"{g} mu {i}": t.data_ptr() for i, t in enumerate(st.mu)})
        out.update({f"{g} nu {i}": t.data_ptr() for i, t in enumerate(st.nu)})
    out.update({f"state {i}": t.data_ptr() for i, t in enumerate(state_buffers(ts.gan))})
    out.update({f"metric {k}": t.data_ptr() for k, t in tr.block.outputs.items()})
    return out


@pytest.mark.parametrize("alg", ["rcgan", "rcgan-u"])
def test_cycle_keeps_every_address_and_chains(alg):
    """Three cycles (iteration 0, then two with the G step) with JAX's noise,
    and two with the port's own seeded noise: every parameter, Adam moment
    and SN ``u`` keeps its address from the first cycle on, and so do the
    metric outputs while the block's layout holds; the state and the
    metrics are bit-equal to the host-float cycle's from the same start;
    each cycle is within JAX's tolerances of JAX's ``step`` from the same
    state; the metrics are tensors of their own, not views of the block."""
    cfg, acfg, tcfg, jcfg, jacfg, jtcfg = _configs(alg)
    c, _ = build_confusion(0.6)
    tr = CifarTrainer(cfg, acfg, tcfg, c, device="cpu")
    ref_tr = CifarTrainer(cfg, acfg, tcfg, c, device="cpu")
    ts, ref = tr.init(seed=2), ref_tr.init(seed=2)
    perturbed_trees(ts.gan, 2)
    perturbed_trees(ref.gan, 2)
    jtr = jloop.CifarTrainer(jcfg, jacfg, jtcfg, c)
    addresses, held = None, []
    for it in range(3):
        d, g = _host_batches(30 + it)
        key = jax.random.key(300 + it)
        jts, jm = jtr.step(_jax_state(to_jax_train_state(ts)),
                           {k: jnp.asarray(v) for k, v in d.items()},
                           {k: jnp.asarray(v) for k, v in g.items()}, it, key)
        noise = _jax_noise(key)
        ts, m = tr.step(ts, d, g, it, seed=0, noise=noise)
        m_ref = _host_float_cycle(ref_tr, ref, d, g, it, 0, noise)
        addresses = addresses or _addresses(tr, ts)
        assert _addresses(tr, ts) == addresses, it
        assert_states_bit_equal(to_jax_train_state(ts), to_jax_train_state(ref), f"{alg} {it}")
        for k in m_ref:
            assert torch.equal(m[k], m_ref[k]), (it, k)
        _assert_like_jax(to_jax_train_state(ts), jts, jm, m, it + 1, f"{alg} cycle {it + 1}")
        held.append(m)
    assert len({float(h["d_cost"]) for h in held}) == 3
    state = {k: v for k, v in addresses.items() if not k.startswith("metric")}
    seeded = None
    for it in (3, 4):  # the port's own noise: seeds through their device-base form
        d, g = _host_batches(40 + it)
        ts, m = tr.step(ts, d, g, it, seed=it)
        m_ref = _host_float_cycle(ref_tr, ref, d, g, it, it)
        seeded = seeded or _addresses(tr, ts)  # a new layout (no noise): a new block
        assert _addresses(tr, ts) == seeded and all(seeded[k] == v for k, v in state.items())
        assert_states_bit_equal(to_jax_train_state(ts), to_jax_train_state(ref), f"{alg} {it}")
        assert all(torch.equal(m[k], m_ref[k]) for k in m_ref)


def test_cycle_row_packs_todays_host_scalars():
    """The host part of a cycle: Adam's rows are the lr, the float32 bias
    corrections of each update's count and their reciprocals (the G step's, the C step's at the
    confusion lr, each critic step's), the seeds' bases and the
    dequantisation seeds are the cycle's, and the counts advance by the
    cycle's updates; at iteration 0 the G and C rows stay 0 and their counts
    do not move."""
    cfg, acfg, tcfg, *_ = _configs("rcgan-u")
    tr = CifarTrainer(cfg, acfg, tcfg, build_confusion(0.6)[0], device="cpu")
    ts = tr.init(0)
    d, g = _host_batches(1)
    for it, seed in ((0, 5), (7, 11), (60000, 3)):
        before = {k: st.count for k, st in ts.opt_states.items()}
        row = tr._cycle_row(ts, d, g, it, seed, None)
        decay = float(lr_decay(it, tcfg.decay))
        lr = tcfg.lr * decay
        rows = [("gen", lr), ("confusion", tcfg.lr * tcfg.confuse_multiplier)] if it else []
        def scalars(g_lr, n):
            bc = [_bias_correction(tcfg.beta1, n), _bias_correction(tcfg.beta2, n)]
            return [np.float32(g_lr), *bc, *(np.float32(1.0 / v) for v in bc)]

        for i, (name, g_lr) in enumerate(rows):
            assert row["adam"][i].tolist() == scalars(g_lr, before[name] + 1), (it, name)
        if not it:
            assert not row["adam"][:2].any()
        for k in range(N_CRITIC):
            assert row["adam"][2 + k].tolist() == scalars(lr, before["disc"] + 1 + k)
        assert row["adam"].dtype == np.float32
        assert float(torch.from_numpy(row["adam"])[2, 0]) == float(torch.full((), lr))
        seeds = rng.cycle_seeds(seed, N_CRITIC, B)
        assert row["z_base"].tolist() == [rng.seed_base(s) for s in [seeds.g_z, *seeds.d_z]]
        assert np.array_equal(row["q_seeds"], seeds.dequant)
        assert np.array_equal(row["g_labels"], np.stack([g["random"], g["biased"]]))
        step = int(it > 0)
        assert {k: st.count for k, st in ts.opt_states.items()} == {
            "gen": before["gen"] + step, "confusion": before["confusion"] + step,
            "disc": before["disc"] + N_CRITIC}


def test_step_scan_block_matches_jax_scan_and_k_steps():
    """A block of three cycles from iteration 0 (the first without its G
    step) over a resident dataset, each cycle's noise JAX's for
    ``fold_in(key, step)``, as JAX's ``step_scan`` keys it: the port's block
    is bit-equal to three ``step`` calls with that noise, and each of its
    cycles, run from JAX's state at that cycle, is within JAX's tolerances
    of JAX's (``test_torch_train.py``'s, each cycle from one state, as
    ``chip_smoke.py`` compares: chained, Adam's sign-like first steps carry
    float32 rounding on); JAX's block equals JAX's three steps.  Then with
    the port's own noise, the block is bit-equal to three ``step`` calls
    keyed ``fold_in(seed, step)``."""
    cfg, acfg, tcfg, jcfg, jacfg, jtcfg = _configs("rcgan-u")
    c, _ = build_confusion(0.6)
    n, k = 24, 3
    rs = np.random.RandomState(0)
    ds_np = {"images": rs.randint(0, 256, (n, 3072)).astype(np.uint8),
             "labels": rs.randint(0, 10, n).astype(np.int32),
             "labels_random": rs.randint(0, 10, n).astype(np.int32),
             "labels_biased": rs.randint(0, 10, n).astype(np.int32),
             "labels_inv_weights": rs.uniform(-0.5, 1.5, (n, 10)).astype(np.float32)}
    idx = rs.randint(0, n, (k, N_CRITIC, B))
    g_random = rs.randint(0, 10, (k, GEN_MULT * B))
    g_biased = rs.randint(0, 10, (k, GEN_MULT * B))
    tr = CifarTrainer(cfg, acfg, tcfg, c, device="cpu",
                      device_dataset=device_dataset_of(ds_np, "cpu"))
    ts = tr.init(seed=3)
    perturbed_trees(ts.gan, 3)
    jtr = jloop.CifarTrainer(jcfg, jacfg, jtcfg, c, device_dataset=ds_np)
    key = jax.random.key(7)
    copy = lambda t: jax.tree_util.tree_map(np.array, t)  # noqa: E731 (JAX donates its states)
    j_scan, jms = jtr.step_scan(_jax_state(to_jax_train_state(ts)), idx, g_random, g_biased,
                                key)
    j_scan, jms = copy(j_scan), copy(jms)
    jts = _jax_state(to_jax_train_state(ts))
    j_states = [copy(jts)]
    for j in range(k):
        jts, jm = jtr.step(jts, {"index": jnp.asarray(idx[j], jnp.int32)},
                           {"random": jnp.asarray(g_random[j]), "biased": jnp.asarray(g_biased[j])},
                           j, jax.random.fold_in(key, j))
        j_states.append(copy(jts))
        for name, v in jm.items():
            np.testing.assert_allclose(np.asarray(v), jms[name][j], rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(j_scan), jax.tree_util.tree_leaves(j_states[-1])):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)

    noises = [_jax_noise(jax.random.fold_in(key, j)) for j in range(k)]
    noise = {name: np.stack([x[name] for x in noises]) for name in noises[0]}
    block, steps = tr.init(seed=3), tr.init(seed=3)
    perturbed_trees(block.gan, 3)
    perturbed_trees(steps.gan, 3)
    block, ms = tr.step_scan(block, idx, g_random, g_biased, 0, noise=noise)
    assert ms["d_cost"].shape == (k,) and tr.block.capacity == k
    for j in range(k):
        steps, m = tr.step(steps, {"index": idx[j]}, {"random": g_random[j],
                                                      "biased": g_biased[j]}, j, 0, noises[j])
        for name in ms:
            assert torch.equal(ms[name][j], m[name]), (j, name)
        one = train_state_from_jax(j_states[j], cfg, acfg, tcfg, "cpu")
        one, m = tr.step(one, {"index": idx[j]}, {"random": g_random[j],
                                                  "biased": g_biased[j]}, j, 0, noises[j])
        _assert_like_jax(to_jax_train_state(one), j_states[j + 1],
                         {name: v[j] for name, v in jms.items()}, m, j + 1, f"cycle {j + 1}")
    assert_states_bit_equal(to_jax_train_state(block), to_jax_train_state(steps), "noise")

    a, b = tr.init(seed=4), tr.init(seed=4)
    a, ms = tr.step_scan(a, idx, g_random, g_biased, 9)
    for j in range(k):
        b, m = tr.step(b, {"index": idx[j]}, {"random": g_random[j], "biased": g_biased[j]},
                       b.step, rng.fold_in(9, b.step))
        assert all(torch.equal(ms[name][j], m[name]) for name in ms), j
    assert_states_bit_equal(to_jax_train_state(a), to_jax_train_state(b), "seeded")


def test_restore_writes_into_the_live_tensors(tmp_path):
    """A checkpoint restored into a trained state: every parameter, moment
    and SN ``u`` keeps its address and takes the saved bits, and the
    restored state steps on as the saved one did."""
    cfg, acfg, tcfg, *_ = _configs("rcgan-u")
    tr = CifarTrainer(cfg, acfg, tcfg, build_confusion(0.6)[0], device="cpu")
    ts = tr.init(0)
    d, g = _host_batches(2)
    ts, _ = tr.step(ts, d, g, 1, seed=1)
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, ts, wait=True)
    saved = to_jax_train_state(ts)
    ts, _ = tr.step(ts, d, g, 2, seed=2)
    addresses = _addresses(tr, ts)
    assert ck.restore(ts) is ts
    assert _addresses(tr, ts) == addresses and ts.step == 1
    assert_states_bit_equal(to_jax_train_state(ts), saved, "restored")
    other = tr.init(0)
    other, _ = tr.step(other, d, g, 1, seed=1)
    ts, m = tr.step(ts, d, g, 2, seed=2)
    other, m2 = tr.step(other, d, g, 2, seed=2)
    assert_states_bit_equal(to_jax_train_state(ts), to_jax_train_state(other), "stepped")
    assert torch.equal(m["d_cost"], m2["d_cost"])
