"""The MNIST iteration's one body (``MnistTrainer._iteration``), which the
card captures into a CUDA graph, on the CPU at ``TINY_MNIST`` widths:
every parameter, Adam moment, SN ``u``, BN statistic and metric output
keeps its address across iterations, and the iterations chain to the same
bits as the host-float form and within JAX's tolerances of JAX's ``step``
from the same state; ``step_scan``'s block against JAX's ``step_scan``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from rcgan_tpu.train.state import TrainState as JaxTrainState
from rcgan_tpu_torch.algorithms.mnist import mnist_losses
from rcgan_tpu_torch.bridge import to_jax_train_state
from rcgan_tpu_torch.core import rng
from rcgan_tpu_torch.train.mnist_loop import BATCH_KEYS
from rcgan_tpu_torch.train.state import (apply_constraints, constraints_of, grads_of,
                                         state_buffers, trainable)
from test_torch_compiled_graphs import _adam_with_host_floats
from test_torch_mnist_train import B, _assert_like_jax, _jax_z, _setup
from torch_parity import assert_states_bit_equal, mnist_batch

torch.set_num_threads(min(2, torch.get_num_threads()))


def _host_float_iteration(tr, ts, batch, seed, z=None):
    """The iteration written with host floats for Adam's scalars, ``z`` from
    the seed's int form, and the state rebound by each layer and left
    there: the reference the one body is held to."""
    cfg, tcfg = tr.cfg, tr.tcfg
    batch = tr.batch_to_device(batch)
    b = batch["images"].shape[0]
    z = rng.example_uniform(rng.fold_in(seed, 0), b, cfg.z_dim, "cpu", -1.0, 1.0) \
        if z is None else torch.from_numpy(np.asarray(z, np.float32))
    params = ts.group_params("disc")
    with trainable(ts, ["disc"]):
        d_out = mnist_losses(ts.gan, batch, z, tr.confusion_actual)
        grads = grads_of(d_out["d_loss"] + 1.0 * d_out["class_loss_real"], params)
    _adam_with_host_floats(tr.optimizers["disc"], params, grads, ts.opt_states["disc"],
                           tcfg.learning_rate)
    apply_constraints(ts.groups["disc"], constraints_of(ts.gan))
    names = [g for g in ("gen", "confusion") if g in ts.groups]
    params = [p for g in names for p in ts.group_params(g)]
    for _ in range(tcfg.g_steps):
        with trainable(ts, names):
            g_out = mnist_losses(ts.gan, batch, z, tr.confusion_actual, g_step_only=True)
            grads = grads_of(g_out["g_loss"] + tcfg.perm_multiplier * g_out["class_loss_fake"],
                             params)
        n = 0
        for g in names:
            ps = ts.group_params(g)
            lr = tcfg.learning_rate * (1.0 if g == "gen" else tcfg.confuse_multiplier)
            _adam_with_host_floats(tr.optimizers[g], ps, grads[n:n + len(ps)],
                                   ts.opt_states[g], lr)
            n += len(ps)
    ts.step += 1
    out = {k: d_out[k].detach() for k in ("d_loss", "d_loss_real", "d_loss_fake",
                                          "class_loss_real")}
    out.update({k: g_out[k].detach() for k in ("g_loss", "class_loss_fake", "confusion")})
    out["prob_real"], out["prob_fake"] = d_out["D"].detach(), g_out["D_"].detach()
    return out


def _addresses(tr, ts):
    out = {f"{g}/{k}": p.data_ptr() for g, ps in ts.groups.items() for k, p in ps.items()}
    for g, st in ts.opt_states.items():
        out.update({f"{g} {m} {i}": t.data_ptr() for m in ("mu", "nu")
                    for i, t in enumerate(getattr(st, m))})
    out.update({f"state {i}": t.data_ptr() for i, t in enumerate(state_buffers(ts.gan))})
    out.update({f"metric {k}": t.data_ptr() for k, t in tr.block.outputs.items()})
    return out


def test_iteration_keeps_every_address_and_chains():
    """Three iterations of rcgan-u with the perm classifier, JAX's ``z``,
    then two with the port's own: state (BN moving statistics and SN ``u``
    among it) and metric outputs keep their addresses; the state and the
    metrics are bit-equal to the host-float iteration's; each iteration is
    within JAX's tolerances of JAX's ``step`` from the same state."""
    jtr, _, tr, ts = _setup("rcgan-u")
    _, _, _, ref = _setup("rcgan-u")
    assert any("moving_mean" in k for k in to_jax_train_state(ts).state["g_bn0"])
    addresses = None
    for it in range(5):
        batch, _, _ = mnist_batch(B, 20 + it)
        key = jax.random.key(200 + it)
        z = _jax_z(key) if it < 3 else None
        if z is not None:
            jts, jm = jtr.step(_jax_state_of(ts), {k: jnp.asarray(v) for k, v in batch.items()},
                               key)
        ts, m = tr.step(ts, batch, seed=it, z=z)
        m_ref = _host_float_iteration(tr, ref, batch, it, z)
        addresses = addresses or _addresses(tr, ts)
        if it == 3:  # the port's own z: another block layout
            addresses = {**addresses, **{k: v for k, v in _addresses(tr, ts).items()
                                         if k.startswith("metric")}}
        assert _addresses(tr, ts) == addresses, it
        assert_states_bit_equal(to_jax_train_state(ts), to_jax_train_state(ref), f"it {it}")
        for k, v in m_ref.items():
            assert torch.equal(m[k], v.float()), (it, k)
        if z is not None:
            _assert_like_jax(to_jax_train_state(ts), jts, jm, m, it + 1, f"iteration {it + 1}")


def _jax_state_of(ts):
    """The port's state as JAX's ``TrainState`` (the bridge's layout)."""
    np_ts = to_jax_train_state(ts)
    opt = {g: (optax.ScaleByAdamState(count=jnp.asarray(a.count), mu=a.mu, nu=a.nu),
               optax.EmptyState()) for g, (a, _) in np_ts.opt_states.items()}
    return JaxTrainState(groups=np_ts.groups, state=np_ts.state, opt_states=opt,
                         step=jnp.asarray(np_ts.step))


def test_step_scan_block_matches_jax_scan():
    """A block of three iterations gathered from a resident dataset, each
    with JAX's ``z`` for ``fold_in(key, step)`` as JAX's ``step_scan`` keys
    it: the block is bit-equal to three ``step`` calls on the gathered rows
    (so each iteration is the ``step`` that ``test_torch_mnist_train.py``
    holds to JAX), its first iteration is within JAX's tolerances of the
    first of JAX's block, and both blocks end at the same step and counts.
    Later iterations are not held to JAX here: within an iteration the
    second G step reads the first one's Adam update, whose sign-like steps
    on gradients zero but for rounding (``_assert_like_jax``) put a few
    iterations over those tolerances even from JAX's own state (2 of 18
    over six keys, the port's arithmetic unchanged)."""
    jtr, _, tr, ts = _setup("rcgan-u")
    n, k = 30, 3
    rs = np.random.RandomState(1)
    batch, _, _ = mnist_batch(n, 7)
    ds = tr.batch_to_device(batch)
    idx = np.stack([rs.permutation(n)[:B] for _ in range(k)])
    key = jax.random.key(11)
    start = _jax_state_of(ts)
    first, _ = jtr.step(_jax_state_of(ts), {kk: jnp.asarray(np.asarray(v)[idx[0]])
                                            for kk, v in batch.items()},
                        jax.random.fold_in(key, 0))
    j_scan, jms = jtr.step_scan(start, {kk: jnp.asarray(v) for kk, v in batch.items()}, idx, key)

    zs = np.stack([_jax_z(jax.random.fold_in(key, j)) for j in range(k)])
    _, _, _, steps = _setup("rcgan-u")
    block, ms = tr.step_scan(ts, ds, idx, 0, z=zs)
    assert ms["prob_real"].shape == (k, B) and tr.block.capacity == k
    for j in range(k):
        rows = {kk: np.asarray(batch[kk])[idx[j]] for kk in BATCH_KEYS}
        steps, m = tr.step(steps, rows, 0, z=zs[j])
        for name in ms:
            assert torch.equal(ms[name][j], m[name]), (j, name)
        if j == 0:
            _assert_like_jax(to_jax_train_state(steps), first,
                             {name: v[0] for name, v in jms.items()}, m, 1, "iteration 1")
    assert_states_bit_equal(to_jax_train_state(block), to_jax_train_state(steps), "block")
    np_block = to_jax_train_state(block)
    assert int(np_block.step) == int(j_scan.step) == k
    assert {g: int(a.count) for g, (a, _) in np_block.opt_states.items()} == {
        g: int(a.count) for g, (a, _) in j_scan.opt_states.items()}
