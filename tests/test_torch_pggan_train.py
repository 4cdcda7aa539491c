"""The port's PGGAN trainer against the JAX package's, on the CPU, float32:
one iteration at a transition (the critic's BN statistics and
``local_step`` after its three D calls); ``train_progressive`` over the
three phases of ``max_stage`` 2 with JAX's own latents injected
(parameters, Adam moments and counts, SN ``u``, BN statistics, costs, at
the end of every phase); the layers of inactive stages left bit-equal
across a phase; a run crashed in phase 3 and resumed from its phase
checkpoint equal to the uninterrupted one bit for bit; and the train-state
bridge both ways.

Tiny widths as ``tests/test_pggan.py::tiny`` (dim 8, embedding 12, 3 + 3 +
3 iterations, batch 4); the JAX weights with biases, cond-BN tables and BN
affine moved off their inits.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from rcgan_tpu.core.rng import example_normal
from rcgan_tpu.models import pggan as jp
from rcgan_tpu.models import resnet_gan as jrg
from rcgan_tpu.train import pggan_loop as jloop
from rcgan_tpu.train.state import TrainState as JaxTrainState
from rcgan_tpu_torch.bridge import pggan_train_state_from_jax, to_jax_train_state
from rcgan_tpu_torch.core.module import state_tree
from rcgan_tpu_torch.models import pggan as tp
from rcgan_tpu_torch.models import resnet_gan as trg
from rcgan_tpu_torch.train import pggan_loop as tloop
from rcgan_tpu_torch.train.checkpoint import Checkpointer, state_payload

torch.set_num_threads(min(2, torch.get_num_threads()))

B, Z, FULL = 4, 8, 16
TINY = dict(z_dim=Z, dim=8, max_stage=2)
BASE = dict(dim_g=8, dim_d=8, embedding_dim=12)
SCHED = dict(trans_iters=3, stab_iters=3)
LR = 2e-4
SEED = 2  # train_progressive's seed (JAX: jax.random.key(2))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def data_fn(it):
    rs = np.random.RandomState(100 + it)
    return {"x": (rs.rand(B, FULL, FULL, 3) * 2 - 1).astype(np.float32),
            "labels": rs.randint(0, 10, B)}


def jax_z(it):
    """The latents JAX's ``train_progressive`` draws at iteration ``it``."""
    sub = jax.random.fold_in(jax.random.key(SEED), it)
    return np.asarray(example_normal(jax.random.fold_in(sub, 0), B, Z))


def _jax_setup():
    jtr = jloop.PGGANTrainer(jp.PGGANConfig(**TINY), jrg.ResnetGANConfig(**BASE),
                             jloop.PGGANTrainConfig(**SCHED))
    jts = jtr.init(jax.random.key(0), B)
    rs = np.random.RandomState(0)
    groups = _np(jts.groups)
    for g in groups.values():
        for d in g.values():
            for var, a in d.items():
                if var in ("scale", "offset", "Biases", "b", "gamma", "beta"):
                    d[var] = (a + 0.3 * rs.randn(*a.shape)).astype(np.float32)
    return jtr, jts.replace(groups=jax.tree_util.tree_map(jnp.asarray, groups))


def _port(jts):
    tr = tloop.PGGANTrainer(tp.PGGANConfig(**TINY), trg.ResnetGANConfig(**BASE),
                            tloop.PGGANTrainConfig(**SCHED), device="cpu")
    return tr, pggan_train_state_from_jax(_np(jts), tr.cfg, tr.base, tr.tcfg, device="cpu")


def _jax_phase_ends():
    """JAX's uninterrupted run: the state (numpy) and metrics at the end of
    each phase."""
    jtr, jts = _jax_setup()
    ends = []
    jtr.train_progressive(jts, lambda it: {k: jnp.asarray(v) for k, v in data_fn(it).items()},
                          jax.random.key(SEED),
                          log_fn=lambda s, t, it, m, ts: ends.append((s, t, it, m, _np(ts))))
    return ends


@pytest.fixture(scope="module")
def jax_run():
    return _jax_setup()[1], _jax_phase_ends()


def _with_jax_z(tr):
    """The trainer's ``step`` with JAX's latents of the iteration it runs."""
    step = tr.step

    def stepped(ts, images, seed, alpha, stage, trans, z=None):
        return step(ts, images, seed, alpha, stage, trans, z=jax_z(ts.step))

    tr.step = stepped
    return tr


def _close_frac(got, want, tol):
    return float(np.mean(np.abs(got - want) <= tol))


def _assert_like_jax(np_ts, jts, label):
    """With beta1 = 0 each Adam step is about ±lr whatever the gradient's
    size, so a gradient that is zero but for rounding (a conv bias that the
    next batch-norm takes out) gives a step of ±lr with either sign on
    either side.  Hence, as the MNIST trainer's parity test:

    - ``mu`` within 2e-4 of each tensor's own max plus 1e-5 of its group's
      largest, ``nu`` at 5e-4; counts exact;
    - parameters within lr/100 on at least 99.9% of the elements of the
      tensors whose gradient is not zero but for rounding, and every
      element within 2·lr per update;
    - SN ``u`` within 1e-5; BN moving variances within 1e-4 of their scale,
      moving and biased means also within the bias drift (2·lr per update);
      ``local_step`` exact."""
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
    assert set(np_ts.state) == set(jts.state)
    for layer, d in np_ts.state.items():
        for var, got in d.items():
            ref = jts.state[layer][var]
            if var == "local_step":
                np.testing.assert_array_equal(got, ref, err_msg=f"{label} {layer}")
                continue
            atol = {"u": 1e-5, "moving_variance": 1e-4 * np.abs(ref).max()}.get(
                var, 1e-4 * np.abs(ref).max() + drift)
            np.testing.assert_allclose(got, ref, rtol=0, atol=atol,
                                       err_msg=f"{label} {layer}/{var}")


def test_one_iteration_moves_the_critic_bn_as_jax():
    """One iteration at (2, trans, alpha 0.5) from the same state: the D
    step's two D passes and the G step's one move every active block's BN
    statistics three times (``local_step`` 3 after the first iteration),
    the state as JAX's; the costs within 1e-5 relative."""
    jtr, jts = _jax_setup()
    tr, ts = _port(jts)
    images = data_fn(0)
    key = jax.random.key(5)
    jts, jm = jtr.step(jts, {k: jnp.asarray(v) for k, v in images.items()}, key, 0.5, 2, True)
    z = np.asarray(example_normal(jax.random.fold_in(key, 0), B, Z))
    ts, m = tr.step(ts, images, 0, 0.5, 2, True, z=z)
    np_ts = to_jax_train_state(ts)
    for s in (1, 2):
        for n in (1, 2):
            assert float(np_ts.state[f"PG.D.Block.{s}.N{n}"]["local_step"][0]) == 3.0
    _assert_like_jax(np_ts, _np(jts), "one iteration")
    for k in ("d_cost", "g_cost"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)


def test_train_progressive_matches_jax_at_every_phase_end(jax_run):
    """The whole schedule (stage 1 stab, stage 2 trans, stage 2 stab; 9
    iterations) through the port's ``train_progressive`` with JAX's latents:
    at the end of each phase the iteration, the state as JAX's and the last
    costs within 1e-4 relative."""
    jts0, ends = jax_run
    tr, ts = _port(jts0)
    _with_jax_z(tr)
    mine = []
    ts = tr.train_progressive(ts, data_fn, SEED, log_fn=lambda s, t, it, m, live: mine.append(
        (s, t, it, m, to_jax_train_state(live))))
    assert [(s, t, it) for s, t, it, _, _ in mine] == [(s, t, it) for s, t, it, _, _ in ends] \
        == [(1, False, 3), (2, True, 6), (2, False, 9)]
    for (s, t, it, m, np_ts), (_, _, _, jm, jts) in zip(mine, ends):
        _assert_like_jax(np_ts, jts, f"phase ({s}, {t}) at {it}")
        for k in ("d_cost", "g_cost"):
            np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-4)
    assert ts.step == 9 and {g: st.count for g, st in ts.opt_states.items()} == \
        {"gen": 9, "disc": 9}


def _inactive(stage, trans):
    """A predicate on scopes: the layers that a phase does not call."""
    on = {f"Block.{s}" for s in range(1, stage + 1)} | {f"ToRGB.{stage}", f"FromRGB.{stage}"}
    if trans:
        on |= {f"ToRGB.{stage - 1}", f"FromRGB.{stage - 1}"}

    def off(scope):
        parts = scope.split(".")
        return parts[2] in ("Block", "ToRGB", "FromRGB") and ".".join(parts[2:4]) not in on

    return off


def test_inactive_stages_stay_bit_equal_across_a_phase(jax_run):
    """Across each phase the parameters, ``u`` and BN statistics of the
    layers it does not call (Block.2, ToRGB.2, FromRGB.2 in stage 1;
    ToRGB.1 and FromRGB.1 in stage 2's stabilization) keep their bits, in
    the port and in JAX; the Adam moments of a never-called layer stay 0."""
    jts0, ends = jax_run
    tr, ts = _port(jts0)
    starts = [to_jax_train_state(ts)]
    tr.train_progressive(ts, data_fn, SEED,
                         log_fn=lambda *a: starts.append(to_jax_train_state(a[-1])))
    jstarts = [_np(jts0)] + [e[-1] for e in ends]
    for i, (stage, trans) in enumerate([(1, False), (2, True), (2, False)]):
        off = _inactive(stage, trans)
        for a, b in ((starts[i], starts[i + 1]), (jstarts[i], jstarts[i + 1])):
            frozen = 0
            for g in ("gen", "disc"):
                for la, d in a.groups[g].items():
                    if off(la):
                        for v in d:
                            np.testing.assert_array_equal(b.groups[g][la][v], d[v], err_msg=la)
                            frozen += 1
            for la, d in a.state.items():
                if off(la):
                    for v in d:
                        np.testing.assert_array_equal(b.state[la][v], d[v], err_msg=la)
            # stage 1: G's Block.2 (10 vars) and ToRGB.2 (2), D's Block.2 (10) and
            # FromRGB.2 (2); stage 2's stabilization: ToRGB.1 and FromRGB.1
            assert frozen == {(1, False): 24, (2, True): 0, (2, False): 4}[(stage, trans)], \
                (stage, trans, frozen)
    adam = starts[1].opt_states["gen"][0]
    assert not np.any(adam.mu["PG.G.Block.2.Conv1"]["Filters"])
    assert not np.any(adam.nu["PG.G.Block.2.Conv1"]["Filters"])


class Boom(RuntimeError):
    pass


def test_crash_in_phase_three_and_resume_is_bit_equal(tmp_path):
    """A run whose ``data_fn`` raises at iteration 6 (phase 3) has saved
    checkpoints at 3 and 6; a fresh trainer restored from 6 and run to the
    end lands on the uninterrupted run's state bit for bit (parameters,
    moments, counts, ``u``, BN statistics, step)."""
    _, jts = _jax_setup()
    tr, ts_a = _port(jts)
    ts_a = tr.train_progressive(ts_a, data_fn, SEED)
    tr2, ts_b = _port(jts)
    ck = Checkpointer(str(tmp_path / "ck"))

    def crashing(it):
        if it >= 6:
            raise Boom()
        return data_fn(it)

    with pytest.raises(Boom):
        tr2.train_progressive(ts_b, crashing, SEED, ckpt=ck)
    assert ck.latest_step() == 6 and ck.steps() == [3, 6]
    tr3 = tloop.PGGANTrainer(tr.cfg, tr.base, tr.tcfg, device="cpu")
    ts_r = ck.restore(tr3.init(123))
    assert ts_r.step == 6
    ts_r = tr3.train_progressive(ts_r, data_fn, SEED, ckpt=ck)
    assert ts_r.step == 9 and ck.latest_step() == 9
    a, b = state_payload(ts_a), state_payload(ts_r)
    flat = [(f"{g}/{k}", a["groups"][g][k], b["groups"][g][k])
            for g in a["groups"] for k in a["groups"][g]]
    flat += [(f"state {k}", a["state"][k], b["state"][k]) for k in a["state"]]
    flat += [(f"{m} {g}/{k}", a["opt_states"][g][m][k], b["opt_states"][g][m][k])
             for g in a["opt_states"] for m in ("mu", "nu") for k in a["opt_states"][g][m]]
    assert [n for n, x, y in flat if not torch.equal(x, y)] == []
    assert a["step"] == b["step"] == 9
    assert all(a["opt_states"][g]["count"] == b["opt_states"][g]["count"] == 9
               for g in a["opt_states"])


def test_train_state_bridge_round_trip_is_bit_exact():
    """JAX's PGGAN TrainState (numpy) → port → JAX layout, after a port
    iteration so that nothing is at its init: every group, the state (``u``,
    the critic's four BN statistics), Adam count/mu/nu and step bit-equal;
    JAX's trainer steps from the bridged state; back into the port the
    same."""
    jtr, jts = _jax_setup()
    tr, ts = _port(jts)
    ts, _ = tr.step(ts, data_fn(0), 3, 1.0, 1, False)
    np_ts = to_jax_train_state(ts)
    assert set(np_ts.groups) == {"gen", "disc"} and int(np_ts.step) == 1
    assert {v for la, d in np_ts.state.items() if ".N" in la for v in d} == {
        "moving_mean", "moving_variance", "biased_mean", "local_step"}
    opt = {g: (optax.ScaleByAdamState(count=jnp.asarray(a.count), mu=a.mu, nu=a.nu),
               optax.EmptyState()) for g, (a, _) in np_ts.opt_states.items()}
    jax_ts = _np(JaxTrainState(groups=np_ts.groups, state=np_ts.state, opt_states=opt,
                               step=jnp.asarray(np_ts.step)))
    stepped, _ = jtr.step(jax.tree_util.tree_map(jnp.asarray, jax_ts),
                          {k: jnp.asarray(v) for k, v in data_fn(1).items()},
                          jax.random.key(1), 1.0, 1, False)
    assert int(stepped.step) == 2
    back = to_jax_train_state(pggan_train_state_from_jax(jax_ts, tr.cfg, tr.base, tr.tcfg,
                                                         device="cpu"))
    want, want_def = jax.tree_util.tree_flatten(np_ts)
    got, got_def = jax.tree_util.tree_flatten(back)
    assert got_def == want_def
    for a, b in zip(got, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_sample_leaves_the_state_and_pool_to_stage_matches_jax():
    """``sample`` runs G alone at the last stage by default (float32 NHWC,
    no state moves); ``pool_to_stage`` is JAX's average pool."""
    _, jts = _jax_setup()
    tr, ts = _port(jts)
    before = {la: {v: t.clone() for v, t in d.items()} for la, d in state_tree(ts.gan).items()}
    out = tr.sample(ts, np.zeros((3, Z), np.float32), np.arange(3))
    assert out.shape == (3, FULL, FULL, 3) and out.dtype == torch.float32
    assert all(torch.equal(t, before[la][v]) for la, d in state_tree(ts.gan).items()
               for v, t in d.items())
    x = data_fn(0)["x"]
    for stage in (1, 2):
        np.testing.assert_allclose(
            tloop.pool_to_stage(torch.from_numpy(x), tr.cfg, stage).numpy(),
            np.asarray(jloop.pool_to_stage(jnp.asarray(x), jp.PGGANConfig(**TINY), stage)),
            rtol=0, atol=1e-6)
