"""PGGAN's step as a host row and one body (``PGGANTrainer._iteration``),
which the card captures per phase, on the CPU at ``test_torch_pggan_train``'s
tiny widths: the body run eagerly equals the step written with host floats
and rebound state bit for bit, and JAX's ``step`` within that file's
tolerances, at a stabilization and a transition phase, every piece of
state keeping its address; the fade-in with ``alpha`` a float32 device
scalar equals the host-float form and JAX's float32 arithmetic at every
``alpha`` of a 600-iteration transition; the host row packs today's
scalars; ``sample``'s pass per stage and batch equals the generator's.
CUDA graphs exist only on the card (``chip_smoke.py`` phase 14)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcgan_tpu.core.rng import example_normal
from rcgan_tpu_torch.algorithms.losses import get_loss
from rcgan_tpu_torch.bridge import to_jax_train_state
from rcgan_tpu_torch.core import rng
from rcgan_tpu_torch.core.module import sn_updates
from rcgan_tpu_torch.models import pggan as tp
from rcgan_tpu_torch.train import pggan_loop as tloop
from rcgan_tpu_torch.train.state import (_bias_correction, grads_of, state_buffers,
                                         trainable)
from test_torch_compiled_graphs import _adam_with_host_floats
from test_torch_pggan_train import B, FULL, LR, Z, _assert_like_jax, _jax_setup, _np, _port, data_fn
from torch_parity import assert_states_bit_equal

torch.set_num_threads(min(2, torch.get_num_threads()))

PHASES = [(1, False, 1.0), (2, True, 0.5), (2, False, 1.0)]


def _host_float_step(tr, ts, images, alpha, stage, trans, z):
    """The step written with ``alpha`` and Adam's lr and bias corrections as
    host floats and the state rebound by each layer and left there: the
    reference the one body is held to."""
    cfg, tcfg, gan = tr.cfg, tr.tcfg, ts.gan
    x = tloop.pool_to_stage(torch.as_tensor(images["x"]).float(), cfg, stage)
    x = x.to(tr.compute_dtype)
    labels = torch.as_tensor(images["labels"]).long()
    z = torch.as_tensor(z).float()
    params = ts.group_params("disc")
    with trainable(ts, ["disc"]):
        fake = gan.G(z, labels, stage, trans, alpha)
        _, d_fake = gan.D(fake, stage, trans, alpha, labels)
        _, d_real = gan.D(x, stage, trans, alpha, labels)
        _, d_cost = get_loss(d_real, d_fake, tcfg.loss_type)
        grads = grads_of(d_cost, params)
    _adam_with_host_floats(tr.optimizers["disc"], params, grads, ts.opt_states["disc"], tcfg.lr)
    params = ts.group_params("gen")
    with trainable(ts, ["gen"]), sn_updates(gan.D, False):
        fake = gan.G(z, labels, stage, trans, alpha)
        _, d_fake = gan.D(fake, stage, trans, alpha, labels)
        g_cost, _ = get_loss(torch.zeros_like(d_fake), d_fake, tcfg.loss_type)
        grads = grads_of(g_cost, params)
    _adam_with_host_floats(tr.optimizers["gen"], params, grads, ts.opt_states["gen"], tcfg.lr)
    ts.step += 1
    return {"d_cost": d_cost.detach(), "g_cost": g_cost.detach()}


def _addresses(ts):
    out = {f"{g}/{k}": p.data_ptr() for g, ps in ts.groups.items() for k, p in ps.items()}
    for g, st in ts.opt_states.items():
        out.update({f"{g} mu {i}": t.data_ptr() for i, t in enumerate(st.mu)})
        out.update({f"{g} nu {i}": t.data_ptr() for i, t in enumerate(st.nu)})
    out.update({f"state {i}": t.data_ptr() for i, t in enumerate(state_buffers(ts.gan))})
    return out


@pytest.mark.parametrize("stage,trans,alpha", PHASES)
def test_iteration_body_equals_the_host_float_step_and_jax(stage, trans, alpha):
    """Two chained iterations of the phase from JAX's state with JAX's
    latents: the port's step (the host row and the body) is bit-equal to the
    host-float step from the same start (state and costs), keeps every
    parameter, moment, SN ``u`` and BN statistic at its address, and is
    within JAX's tolerances of JAX's ``step`` (the costs within 1e-5
    relative); ``alpha`` moves between the two iterations of a transition,
    read from the block.  Then one iteration with the port's own seeded
    ``z`` (its device-base form), bit-equal to the host-float step with
    ``example_normal`` of the same seed."""
    jtr, jts = _jax_setup()
    tr, ts = _port(jts)
    ref_tr, ref = _port(jts)
    addresses = _addresses(ts)
    for it in range(2):
        a = alpha * (it + 1) / 2 if trans else alpha
        images = data_fn(it)
        key = jax.random.key(50 + it)
        jts, jm = jtr.step(jts, {k: jnp.asarray(v) for k, v in images.items()}, key, a, stage,
                           trans)
        z = np.asarray(example_normal(jax.random.fold_in(key, 0), B, Z))
        ts, m = tr.step(ts, images, 0, a, stage, trans, z=z)
        m_ref = _host_float_step(ref_tr, ref, images, a, stage, trans, z)
        assert _addresses(ts) == addresses, it
        assert_states_bit_equal(to_jax_train_state(ts), to_jax_train_state(ref), f"it {it}")
        assert all(torch.equal(m[k], m_ref[k]) for k in m_ref), it
        _assert_like_jax(to_jax_train_state(ts), _np(jts), f"({stage}, {trans}) it {it}")
        for k in ("d_cost", "g_cost"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    seed = rng.fold_in(11, ts.step)
    ts, m = tr.step(ts, data_fn(5), seed, alpha, stage, trans)
    m_ref = _host_float_step(ref_tr, ref, data_fn(5), alpha, stage, trans,
                             rng.example_normal(rng.fold_in(seed, 0), B, Z, "cpu"))
    assert_states_bit_equal(to_jax_train_state(ts), to_jax_train_state(ref), "seeded")
    assert all(torch.equal(m[k], m_ref[k]) for k in m_ref)
    assert ts.step == ref.step == 3 and _addresses(ts) == addresses


def test_blend_with_a_device_alpha_is_bit_equal_at_every_alpha_of_a_transition():
    """``_blend`` with ``alpha`` a float32 scalar tensor gives the host-float
    form's bits, and those of JAX's float32 arithmetic (``a * new + (1 - a)
    * low``, each operation rounded to float32), for every ``alpha`` =
    (i + 1) / 600 of a 600-iteration transition, on float32 and bf16 maps."""
    rs = np.random.RandomState(0)
    new32 = rs.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    low32 = rs.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    maps = [(torch.from_numpy(new32), torch.from_numpy(low32)),
            (torch.from_numpy(new32).bfloat16(), torch.from_numpy(low32).bfloat16())]
    n = tloop.PGGANTrainConfig().trans_iters
    assert n == 600
    for i in range(n):
        alpha = (i + 1) / n
        a = np.float32(alpha)
        for new, low in maps:
            host = tp._blend(alpha, new, low)
            dev = tp._blend(torch.tensor(a), new, low)
            assert dev.dtype == torch.float32 and torch.equal(dev, host), (i, new.dtype)
            nf, lf = new.float().numpy(), low.float().numpy()
            want = a * nf + (np.float32(1.0) - a) * lf
            assert want.dtype == np.float32 and np.array_equal(dev.numpy(), want), i


def test_iteration_row_packs_todays_host_scalars():
    """The host part of an iteration: ``adam`` rows are the D step's and the
    G step's ``scalars`` at their next counts and the lr, both counts
    advance by one, ``alpha`` is float32, ``z_base`` is the seed base of
    ``fold_in(seed, 0)`` (or ``z`` when given), and the batch passes
    through as given."""
    _, jts = _jax_setup()
    tr, ts = _port(jts)
    images = data_fn(0)
    for seed, alpha in ((3, 1 / 600), (2 ** 40 + 5, 1.0)):
        before = {g: st.count for g, st in ts.opt_states.items()}
        row = tr._iteration_row(ts, images, seed, alpha)
        for i, g in enumerate(("disc", "gen")):
            n = before[g] + 1
            bc = [_bias_correction(tr.tcfg.beta1, n), _bias_correction(tr.tcfg.beta2, n)]
            assert row["adam"][i].tolist() == [np.float32(LR), *bc,
                                               *(np.float32(1.0 / v) for v in bc)], (seed, g)
        assert {g: st.count for g, st in ts.opt_states.items()} == {
            g: c + 1 for g, c in before.items()}
        assert row["alpha"].dtype == np.float32 and row["alpha"] == np.float32(alpha)
        assert int(row["z_base"]) == rng.seed_base(rng.fold_in(seed, 0))
        assert row["x"] is images["x"] and row["labels"] is images["labels"]
    z = np.zeros((B, Z), np.float32)
    row = tr._iteration_row(ts, images, 0, 1.0, z)
    assert "z_base" not in row and row["z"] is z


def test_sample_passes_equal_the_generator_and_are_their_own_tensors():
    """``sample`` at each stage and two batch sizes, from host arrays and
    from tensors, equals ``models.pggan.sample`` on the same inputs bit for
    bit; one pass per (stage, batch); each result is a tensor of its own,
    untouched by the next call."""
    _, jts = _jax_setup()
    tr, ts = _port(jts)
    rs = np.random.RandomState(3)
    first = None
    for stage in (1, 2):
        for b in (3, 5):
            z = rs.randn(b, Z).astype(np.float32)
            labels = rs.randint(0, 10, b)
            for zz, ll in ((z, labels), (torch.from_numpy(z), torch.from_numpy(labels))):
                got = tr.sample(ts, zz, ll, stage)
                want = tp.sample(ts.gan.G, torch.from_numpy(z), torch.from_numpy(labels).long(),
                                 stage)
                assert got.shape == (b, 4 * 2 ** stage, 4 * 2 ** stage, 3)
                assert torch.equal(got, want), (stage, b)
            if first is None:
                first, kept = got, got.clone()
    assert torch.equal(first, kept)
    assert sorted(tr._samples.programs) == sorted(
        ((s,), (("z", (b, Z)), ("labels", (b,)))) for s in (1, 2) for b in (3, 5))
    assert tr.sample(ts, np.zeros((2, Z), np.float32), np.arange(2)).shape == (2, FULL, FULL, 3)


def test_a_trainer_off_the_card_refuses_graphs():
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        tloop.PGGANTrainer(tp.PGGANConfig(z_dim=Z, dim=8, max_stage=2),
                           tloop.ResnetGANConfig(dim_g=8, dim_d=8, embedding_dim=12),
                           tloop.PGGANTrainConfig(), device="cpu", graphs=True)
    tr = tloop.PGGANTrainer(tp.PGGANConfig(z_dim=Z, dim=8, max_stage=2),
                            tloop.ResnetGANConfig(dim_g=8, dim_d=8, embedding_dim=12),
                            tloop.PGGANTrainConfig(), device="cpu")
    assert not tr.graphs and not tr.program.captured.capture and not tr._samples.capture
