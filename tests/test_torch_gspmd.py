"""GSPMD in the port (``rcgan_tpu_torch/parallel/gspmd.py``) on the CPU, over
four gloo ranks as a 2×2 ``('data', 'model')`` mesh of DTensors, against the
JAX package's ``gspmd_cycle`` on ``make_dp_tp_mesh(2, 2)`` of its 8-device
virtual CPU mesh (``tests/conftest.py``) and against the port's one-process
cycle at the global batch.  The configuration is JAX's
``test_gspmd_dp_tp_cycle``'s: dim 8, embedding 12, batch 8, ``n_critic`` 2,
rcgan and rcgan-u with the perm classifier and ``confuse_init``.

- ``train_state_shardings`` gives, parameter by parameter, the placements
  JAX's ``PartitionSpec`` tree names, the low-rank guard included;
- each kernel op's DTensor rule on a 2×2 mesh: the op on sharded inputs
  has the placements of its rule and its ``full_tensor()`` equals the op
  on whole tensors; ``opcheck`` of ``rcgan::sn_group``,
  ``rcgan::projection_logits`` and ``rcgan::dequantize``; their CUDA
  implementations raise on a failed build or launch (no fallback);
- two cycles (iterations 1 and 2) on the 2×2 mesh, with JAX's noise
  injected, against JAX's ``gspmd_cycle`` and the port's one-process cycle
  from the same weights, and with the port's own noise (each rank draws its
  rows by global index) against the one-process cycle.  JAX's tolerances
  (``tests/test_parallel.py:95-117``): costs ``rtol 1e-4, atol 1e-5``,
  deltas ``rtol 1e-4, atol 2e-3`` of the update's scale, with the
  exemptions for Adam's sign-like first steps that
  ``tests/test_torch_parallel_cifar.py`` states (``assert_deltas_close``);
  the ranks' metrics are equal;
- ``Checkpointer.restore_sharded``: a state saved from the 2×2 mesh after
  one cycle restores onto 4×1 and 1×4 with the placements asked for, its
  whole tensors, counts and step bit-equal.

Rank functions are module-level and this module imports JAX only inside
its test functions (a spawned rank imports this module).  Each launch has
its own timeout, which kills its ranks.
"""

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
from rcgan_tpu_torch.bridge import AdamMoments, NumpyTrainState, to_jax_train_state
from rcgan_tpu_torch.data.cifar10 import DATASET_KEYS, device_dataset_of
from rcgan_tpu_torch.data.confusion import build_confusion
from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
from rcgan_tpu_torch.ops.kernels import (conv_kernel, dequant_kernel, norm_kernel,
                                         projection_kernel, runtime, sn_kernel)
from rcgan_tpu_torch.parallel import launch
from rcgan_tpu_torch.core import rng
from rcgan_tpu_torch.parallel.gspmd import (apply_shardings, data_rows, gspmd_cycle,
                                            make_dp_tp_mesh, train_state_shardings)
from rcgan_tpu_torch.train.checkpoint import Checkpointer, state_payload
from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer
from torch_parity import (assert_deltas_close, assert_states_bit_equal, bridge_of,
                          cuda_impls_on_cpu, deltas_off, jax_noise, out_bias)

torch.set_num_threads(min(2, torch.get_num_threads()))

B, N_CRITIC, GEN_MULT = 8, 2, 2
WIDTHS = dict(dim_g=8, dim_d=8, embedding_dim=12)
SEED = 3
TIMEOUT = 300.0
ALGS = ("rcgan", "rcgan-u")
OPS = ("conv3x3", "cond_batchnorm", "sn_group", "projection_logits", "dequantize")


def _trainer(alg, feeds=None):
    """The trainer on the CPU; with ``feeds``, their batches resident as
    its dataset (:func:`_index_feeds`)."""
    perm = alg == "rcgan-u"
    dataset = None
    if feeds is not None:
        dataset = device_dataset_of({k: np.concatenate([d[k].reshape(-1, *d[k].shape[2:])
                                                        for d, _ in feeds])
                                     for k in DATASET_KEYS}, "cpu")
    return CifarTrainer(ResnetGANConfig(**WIDTHS, algorithm=alg),
                        CifarAlgoConfig(algorithm=alg, perm_classifier=perm, confuse_init=perm),
                        CifarTrainConfig(n_critic=N_CRITIC, gen_bs_multiple=GEN_MULT),
                        build_confusion(0.6)[0], device="cpu", device_dataset=dataset)


def _index_feeds(feeds):
    """The feeds as index batches into their batches made resident, in
    order (``_trainer(alg, feeds)``)."""
    idx = np.arange(len(feeds) * N_CRITIC * B).reshape(len(feeds), N_CRITIC, B)
    return [({"index": i}, g) for i, (_, g) in zip(idx, feeds)]


def _feeds(seed, n=2):
    """``n`` cycles' global batches and labels, numpy."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        d = {"images": rs.randint(0, 256, (N_CRITIC, B, 3072)).astype(np.uint8),
             "labels": rs.randint(0, 10, (N_CRITIC, B)).astype(np.int32),
             "labels_random": rs.randint(0, 10, (N_CRITIC, B)).astype(np.int32),
             "labels_biased": rs.randint(0, 10, (N_CRITIC, B)).astype(np.int32),
             "labels_inv_weights": rs.uniform(-0.5, 1.5, (N_CRITIC, B, 10)).astype(np.float32)}
        g = {"random": rs.randint(0, 10, GEN_MULT * B).astype(np.int32),
             "biased": rs.randint(0, 10, GEN_MULT * B).astype(np.int32)}
        out.append((d, g))
    return out


def _np_state(payload) -> NumpyTrainState:
    """A checkpoint payload (``state_payload``) in the bridge's layout."""
    def tree(d):
        out = {}
        for key, t in d.items():
            layer, var = key.rsplit("/", 1)
            out.setdefault(layer, {})[var] = t.numpy()
        return out

    opt = {g: (AdamMoments(np.asarray(st["count"], np.int32), tree(st["mu"]), tree(st["nu"])), ())
           for g, st in payload["opt_states"].items()}
    return NumpyTrainState({g: tree(d) for g, d in payload["groups"].items()},
                           tree(payload["state"]), opt,
                           np.asarray(payload["step"], np.int32))


def _spec(placements, ndim):
    """Placements ``(on data, on model)`` as JAX's ``PartitionSpec``
    entries, trailing ``None`` dropped."""
    entries = [None] * ndim
    for name, p in zip(("data", "model"), placements):
        if isinstance(p, Shard):
            entries[p.dim] = name
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


# ------------------------------------------------------------ rank functions
def _one_process(alg, feeds, noises):
    """Two cycles of the port's one-process trainer from the seed's
    weights; each cycle's metrics and bridge state, the initial state first."""
    tr = _trainer(alg)
    ts = tr.init(SEED)
    out = [(None, to_jax_train_state(ts))]
    for i, ((d, g), noise) in enumerate(zip(feeds, noises)):
        ts, m = tr.step(ts, d, g, i + 1, SEED + i, noise=noise)
        out.append(({k: float(v) for k, v in m.items()}, to_jax_train_state(ts)))
    return out


def _gspmd_rank(group, alg, feeds, noises):
    """On the 2×2 mesh, two cycles from the seed's weights with ``noises``
    injected, then two with the port's own noise on index batches into the
    feeds made resident; every rank returns the metrics, rank 0 also the
    gathered states."""
    mesh = make_dp_tp_mesh(2, 2, "cpu")
    runs = []
    for noises, resident in ((noises, False), ([None] * len(feeds), True)):
        tr = _trainer(alg, feeds if resident else None)
        ts = tr.init(SEED)
        ts = apply_shardings(ts, train_state_shardings(mesh, ts))
        step = gspmd_cycle(tr, mesh)
        out = []
        for i, ((d, g), noise) in enumerate(zip(_index_feeds(feeds) if resident else feeds,
                                                noises)):
            ts, m = step(ts, d, g, i + 1, SEED + i, noise=noise)
            payload = state_payload(ts)  # a collective: every rank gathers
            out.append(({k: float(v) for k, v in m.items()},
                        payload if group.rank == 0 else None))
        runs.append(out)
    return runs


def _refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _rules_rank(group, directory):
    """On the 2×2 mesh: the train-state placements of both algorithms and
    of rules that ask too much of a bias; each op on sharded inputs against
    the op on whole tensors; the refusals of an unplaced state."""
    mesh = make_dp_tp_mesh(2, 2, "cpu")
    out = {"shardings": {}}
    for alg in ALGS:
        ts = _trainer(alg).init(SEED)
        sh = train_state_shardings(mesh, ts)
        out["shardings"][alg] = {(g, *k): _spec(pl, ts.groups[g][k].dim())
                                 for g, ps in sh.groups.items() for k, pl in ps.items()}
        assert set(sh.state.values()) == {(Replicate(), Replicate())}
        assert all(set(d.values()) == {(Replicate(), Replicate())}
                   for d in sh.opt_states.values())
    ts = _trainer("rcgan").init(SEED)
    guard = train_state_shardings(mesh, ts, {"D.Output": {"b": (Shard(0), Shard(1))},
                                             "G.Input": {"W": (Replicate(), Shard(1))}})
    out["guard"] = {(g, *k): _spec(pl, ts.groups[g][k].dim())
                    for g, ps in guard.groups.items() for k, pl in ps.items()}
    plain_step = gspmd_cycle(_trainer("rcgan"), mesh)
    d, g = _feeds(1, 1)[0]
    out["refusals"] = [_refusal(lambda: plain_step(ts, d, g, 1, 0)),
                       _refusal(lambda: Checkpointer(directory).restore_sharded(
                           apply_shardings(ts, train_state_shardings(mesh, ts)),
                           train_state_shardings(mesh, ts)))]

    base = torch.tensor(rng.seed_base(11))
    drawn = data_rows(mesh, 16, lambda n, start: rng.example_normal_from(base, n, 128, start))
    out["draws"] = (drawn.full_tensor(), rng.example_normal_from(base, 16, 128))

    gen = torch.Generator().manual_seed(0)

    def put(t, *pl):
        return distribute_tensor(t, mesh, pl)

    rows, repl = (Shard(0), Replicate()), (Replicate(), Replicate())
    x = torch.randn(4, 6, 6, 8, generator=gen)
    w = torch.randn(3, 3, 8, 16, generator=gen)
    xs, labels = torch.randn(4, 9, 16, generator=gen), torch.tensor([0, 3, 9, 3])
    scale, offset = torch.randn(10, 16, generator=gen), torch.randn(10, 16, generator=gen)
    ws = [torch.randn(12, 8, generator=gen), torch.randn(8, 1, generator=gen),
          torch.randn(27, 8, generator=gen)]
    us = [torch.randn(1, w_.shape[1], generator=gen) for w_ in ws]
    feat, emb = torch.randn(4, 16, generator=gen), torch.randn(10, 16, generator=gen)
    wgan = torch.randn(4, 1, generator=gen)
    img = torch.randint(0, 256, (4, 3072), generator=gen, dtype=torch.uint8)
    seeds = torch.randint(-2**31, 2**31 - 1, (4,), generator=gen, dtype=torch.int32)
    calls = {
        "conv3x3": (conv_kernel.conv3x3_op, (x, w), (put(x, *rows), put(w, *repl))),
        "cond_batchnorm": (norm_kernel.cond_batchnorm_op,
                           (xs, labels, scale, offset, 1e-5, True),
                           (put(xs, *rows), put(labels, *rows), put(scale, *repl),
                            put(offset, *repl), 1e-5, True)),
        # two weights sharded on model, as D.Embedding_y's and D.Output's
        "sn_group": (sn_kernel.sn_group_op, (ws, us),
                     ([put(ws[0], Replicate(), Shard(1)), put(ws[1], Replicate(), Shard(0)),
                       put(ws[2], *repl)], [put(u, *repl) for u in us])),
        "projection_logits": (projection_kernel.projection_logits_op, (feat, emb, wgan),
                              (put(feat, *rows), put(emb, *repl), put(wgan, *rows))),
        "dequantize": (dequant_kernel.dequantize_op, (img, seeds, 32, 3),
                       (put(img, *rows), put(seeds, *rows), 32, 3)),
    }
    out["ops"] = {}
    for name, (op, whole, placed) in calls.items():
        want, got = op(*whole), op(*placed)
        want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
        out["ops"][name] = [(tuple(g_.placements), g_.full_tensor(), w_)
                            for g_, w_ in zip(got, want)]
    # the all-replicated rule of the projection
    got = projection_kernel.projection_logits_op(put(feat, *repl), put(emb, *repl),
                                                  put(wgan, *repl))
    out["ops"]["projection_logits replicated"] = [
        (tuple(got.placements), got.full_tensor(), calls["projection_logits"][0](feat, emb, wgan))]
    return out if group.rank == 0 else None


def _restore_rank(group, directory):
    """One cycle on the 2×2 mesh, saved; then restored onto 4×1 and 1×4:
    rank 0 returns the saved whole state, and for each layout whether every
    leaf has the placements asked for and the restored whole state."""
    mesh = make_dp_tp_mesh(2, 2, "cpu")
    tr = _trainer("rcgan")
    ts = tr.init(SEED)
    ts = apply_shardings(ts, train_state_shardings(mesh, ts))
    d, g = _feeds(5, 1)[0]
    ts, _ = gspmd_cycle(tr, mesh)(ts, d, g, 1, SEED)
    ck = Checkpointer(directory)
    ck.save(ts.step, ts, wait=True)
    out = {"saved": state_payload(ts)}
    for shape in ((4, 1), (1, 4)):
        mesh_b = make_dp_tp_mesh(*shape, "cpu")
        template = tr.init(SEED + 1)
        want = train_state_shardings(mesh_b, template)
        got = ck.restore_sharded(template, want, step=ts.step)
        placed = all(isinstance(p, DTensor) and p.device_mesh == mesh_b
                     and tuple(p.placements) == want.groups[gr][k]
                     for gr, ps in got.groups.items() for k, p in ps.items())
        placed &= all(isinstance(t, DTensor) and tuple(t.placements) == (Replicate(),) * 2
                      for st in got.opt_states.values() for t in st.mu + st.nu)
        placed &= all(isinstance(b, DTensor) for b in got.gan.buffers())
        sharded = {(gr, *k): tuple(p.placements) for gr, ps in got.groups.items()
                   for k, p in ps.items() if any(isinstance(x, Shard) for x in p.placements)}
        out[shape] = (placed, sharded, state_payload(got))
    ck.close()
    return out if group.rank == 0 else None


# -------------------------------------------------------------- the rules
@pytest.fixture(scope="module")
def rules(tmp_path_factory):
    """One launch of four ranks for every rule check."""
    return launch(_rules_rank, 4, backend="gloo", args=(str(tmp_path_factory.mktemp("ck")),),
                  timeout=TIMEOUT)[0]


@pytest.mark.parametrize("alg", ALGS)
def test_train_state_shardings_match_jax(rules, alg):
    """Parameter by parameter, the placements of ``train_state_shardings``
    name JAX's ``PartitionSpec`` (trailing ``None`` dropped) for the same
    state, with the default rules and with rules that give a 1-D bias two
    sharded dimensions (JAX's low-rank guard replicates it)."""
    import jax

    from rcgan_tpu.parallel.gspmd import make_dp_tp_mesh as jax_mesh
    from rcgan_tpu.parallel.gspmd import train_state_shardings as jax_shardings
    from rcgan_tpu.train import cifar_loop as jloop
    from rcgan_tpu.algorithms import cifar as jcifar
    from rcgan_tpu.models import resnet_gan as jrg

    perm = alg == "rcgan-u"
    jtr = jloop.CifarTrainer(jrg.ResnetGANConfig(**WIDTHS, algorithm=alg),
                             jcifar.CifarAlgoConfig(algorithm=alg, perm_classifier=perm,
                                                    confuse_init=perm),
                             jloop.CifarTrainConfig(n_critic=N_CRITIC), build_confusion(0.6)[0])
    jts = jtr.init(jax.random.key(0), B)
    P = jax.sharding.PartitionSpec

    def specs(sh):
        out = {}
        for g, grp in sh.groups.items():
            for layer, d in grp.items():
                for var, s in d.items():
                    spec = list(s.spec)
                    while spec and spec[-1] is None:
                        spec.pop()
                    out[(g, layer, var)] = tuple(spec)
        return out

    mesh = jax_mesh(2, 2)
    want = specs(jax_shardings(mesh, jts))
    assert rules["shardings"][alg] == want
    assert sum(1 for s in want.values() if s) == 5  # G.Input W, b; D.Output W; D.Embedding_y W, b
    if alg == "rcgan":
        guard = specs(jax_shardings(mesh, jts, {"D.Output": {"b": P("data", "model")},
                                                "G.Input": {"W": P(None, "model")}}))
        assert rules["guard"] == guard
        assert guard[("disc", "D.Output", "b")] == () and guard[("gen", "G.Input", "W")] \
            == (None, "model")


@pytest.mark.parametrize("name", list(OPS) + ["projection_logits replicated"])
def test_op_rules_on_a_2x2_mesh(rules, name):
    """Each op on DTensor inputs has its rule's placements (conv3x3, the
    projection and the dequantisation keep the rows sharded on ``data``;
    cond-BN and sn replicate) and its whole result equals the op on whole
    tensors: bit for bit where the rule replicates or the rows are
    independent, to float32 rounding for the sharded products."""
    sharded = {"conv3x3", "projection_logits", "dequantize"}
    for placements, got, want in rules["ops"][name]:
        assert placements == ((Shard(0), Replicate()) if name in sharded
                              else (Replicate(), Replicate())), name
        if name in ("conv3x3", "projection_logits"):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(got, want), name


def test_gspmd_cycle_refuses_an_unplaced_state(rules):
    """A step on a state that ``apply_shardings`` did not place, and
    ``restore_sharded`` into a placed template, raise."""
    step_msg, restore_msg = rules["refusals"]
    assert "not placed as the rules ask" in step_msg
    assert "unplaced template" in restore_msg


# ---------------------------------------------------------------- the ops
def test_new_ops_pass_opcheck():
    """Schema and fake implementation of ``rcgan::sn_group``,
    ``rcgan::projection_logits`` (float32 and bf16 inputs) and
    ``rcgan::dequantize`` on the CPU; each op equals its plain version."""
    gen = torch.Generator().manual_seed(1)
    utils = ("test_schema", "test_faketensor")
    ws = [torch.randn(12, 8, generator=gen), torch.randn(5, 3, generator=gen)]
    us = [torch.randn(1, 8, generator=gen), torch.randn(1, 3, generator=gen)]
    torch.library.opcheck(sn_kernel.sn_group_op, (ws, us), test_utils=utils)
    got = sn_kernel._group_views(ws, *sn_kernel.sn_group_op(ws, us))
    want = [t for w, u in zip(ws, us) for t in sn_kernel.sn_plain(w, u)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for dt in (torch.float32, torch.bfloat16):
        args = (torch.randn(4, 16, generator=gen).to(dt), torch.randn(10, 16, generator=gen).to(dt),
                torch.randn(4, 1, generator=gen).to(dt))
        torch.library.opcheck(projection_kernel.projection_logits_op, args, test_utils=utils)
        assert torch.equal(projection_kernel.projection_logits_op(*args),
                           projection_kernel.projection_plain(*args))
    x = torch.randint(0, 256, (3, 3072), generator=gen, dtype=torch.uint8)
    seeds = torch.tensor([5, -7, 2**30], dtype=torch.int32)
    torch.library.opcheck(dequant_kernel.dequantize_op, (x, seeds, 32, 3), test_utils=utils)
    assert torch.equal(dequant_kernel.dequantize_op(x, seeds, 32, 3),
                       dequant_kernel.dequantize_plain(x, dequant_kernel.row_noise(seeds, 3072)))


class _FailingLibrary:
    """A kernel library whose every entry point returns error ``code``."""

    def __init__(self, code):
        self.code = code

    def __getattr__(self, name):
        if name.endswith("error_string"):
            return lambda code: b"an illegal memory access was encountered"
        if name == "sn_group_bytes":
            return lambda: __import__("ctypes").sizeof(sn_kernel._SnGroup)
        if name == "sn_max_weights":
            return lambda: sn_kernel.MAX_WEIGHTS
        fn = lambda *a: self.code  # noqa: E731
        fn.argtypes = fn.restype = None
        return fn


@pytest.mark.parametrize("op", ["sn_group", "projection_logits", "dequantize"])
def test_new_ops_raise_with_no_fallback(monkeypatch, op):
    """The op's CUDA implementation, reached with ``on_cuda`` mocked true,
    raises on a failed launch and on a failed build; the plain version is
    never called and nothing is counted."""
    monkeypatch.setattr(runtime, "on_cuda", lambda *ts: True)
    monkeypatch.setattr(runtime, "on_device", lambda t, f, *args: f(*args, 7))
    cuda_impls_on_cpu(monkeypatch, op)
    refuse = lambda *a, **k: (_ for _ in ()).throw(AssertionError("fell back"))  # noqa: E731
    for mod, plain in ((sn_kernel, "sn_plain"), (projection_kernel, "projection_plain"),
                       (dequant_kernel, "dequantize_plain"), (dequant_kernel, "row_noise")):
        monkeypatch.setattr(mod, plain, refuse)
    calls = {"sn_group": lambda: sn_kernel.spectral_norm(torch.randn(12, 8), torch.randn(1, 8)),
             "projection_logits": lambda: projection_kernel.all_label_projection_logits(
                 torch.randn(8, 16), torch.randn(10, 16), torch.randn(8, 1)),
             "dequantize": lambda: dequant_kernel.dequantize(
                 torch.zeros(2, 3072, dtype=torch.uint8), torch.zeros(2, dtype=torch.int32))}
    runtime.reset_launch_counts()
    monkeypatch.setattr(runtime, "cuda_library", lambda name: _FailingLibrary(700))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        calls[op]()

    def broken_build(name):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(runtime, "cuda_library", broken_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        calls[op]()
    assert runtime.launch_counts()[{"sn_group": "sn", "projection_logits": "projection",
                                    "dequantize": "dequant"}[op]] == 0


# -------------------------------------------------------------- the cycle
def _jax_run(alg, feeds, init_np, gspmd):
    """Two cycles of JAX's ``gspmd_cycle`` on ``make_dp_tp_mesh(2, 2)``
    (``gspmd``) or of its one-device ``CifarTrainer.step``, from the port's
    initial state; returns the keys and, the initial state first, each
    cycle's metrics and state in the bridge's layout."""
    import jax
    import jax.numpy as jnp
    import optax

    from rcgan_tpu.algorithms import cifar as jcifar
    from rcgan_tpu.models import resnet_gan as jrg
    from rcgan_tpu.parallel import gspmd as jgspmd
    from rcgan_tpu.train import cifar_loop as jloop
    from rcgan_tpu.train.state import TrainState

    perm = alg == "rcgan-u"
    jtr = jloop.CifarTrainer(jrg.ResnetGANConfig(**WIDTHS, algorithm=alg),
                             jcifar.CifarAlgoConfig(algorithm=alg, perm_classifier=perm,
                                                    confuse_init=perm),
                             jloop.CifarTrainConfig(n_critic=N_CRITIC, gen_bs_multiple=GEN_MULT),
                             build_confusion(0.6)[0], mesh=None)
    opt = {g: (optax.ScaleByAdamState(count=jnp.asarray(a.count), mu=a.mu, nu=a.nu),
               optax.EmptyState()) for g, (a, _) in init_np.opt_states.items()}
    jts = TrainState(groups=init_np.groups, state=init_np.state, opt_states=opt,
                     step=jnp.asarray(init_np.step))
    if gspmd:
        mesh = jgspmd.make_dp_tp_mesh(2, 2)
        jts = jgspmd.apply_shardings(jts, jgspmd.train_state_shardings(mesh, jts))
        step = jgspmd.gspmd_cycle(jtr, mesh)
    else:
        step = jtr.step
    keys, out = [], [(None, init_np)]
    for i, (d, g) in enumerate(feeds):
        key = jax.random.key(100 + i)
        jts, m = step(jts, {k: jnp.asarray(v) for k, v in d.items()},
                      {k: jnp.asarray(v) for k, v in g.items()},
                      jnp.asarray(i + 1, jnp.int32) if gspmd else i + 1, key)
        keys.append(key)
        out.append(({k: float(v) for k, v in m.items()},
                    bridge_of(jax.tree_util.tree_map(np.asarray, jts))))
    return keys, out


def _assert_costs(m, want, prev, want_prev, label):
    """Costs under JAX's tolerances; ``g_cost`` with ``D.Output/b`` taken out
    (its rounding-driven ±lr walk, ``tests/test_torch_parallel_cifar.py``)."""
    for k in ("d_cost", "d_cost_mean"):
        np.testing.assert_allclose(m[k], want[k], rtol=1e-4, atol=1e-5, err_msg=f"{label} {k}")
    np.testing.assert_allclose(m["g_cost"] + out_bias(prev), want["g_cost"] + out_bias(want_prev),
                               rtol=1e-4, atol=1e-5, err_msg=f"{label} g_cost")
    np.testing.assert_allclose(m["lr"], want["lr"], rtol=1e-6)


@pytest.mark.parametrize("alg", ALGS)
def test_gspmd_dp_tp_cycle_matches_jax_and_one_process(alg):
    """Two cycles on the 2×2 mesh, every rank reading the same metrics.

    With JAX's noise injected: against the port's one-process cycle from
    the same weights, costs and deltas (and Adam's moments) under JAX's
    tolerances at both cycles; against JAX's ``gspmd_cycle``, costs at both
    cycles and deltas at cycle 1 (every element within 2·lr per update).  At
    cycle 2 the deltas are held to JAX's own spread: no more elements past
    JAX's tolerance of its ``gspmd_cycle`` than JAX's one-device cycle has
    there (in rcgan's D it has some), plus 0.1%.  With the port's own noise
    (each rank draws its rows by global index) and index batches into the
    same batches made resident (each rank gathers its rows): against the
    one-process cycle on the arrays, costs at both cycles and deltas at
    cycle 1; at cycle 2 the one-process cycle alone leaves JAX's tolerance
    of itself in rcgan-u's G between one and two CPU threads (G's gradients
    lose digits to cancellation and Adam's sign-like early steps turn that
    into updates), so the layout is held there to the costs."""
    feeds = _feeds(7)
    init = _one_process(alg, [], [])[0][1]
    keys, jax_gspmd = _jax_run(alg, feeds, init, gspmd=True)
    _, jax_one = _jax_run(alg, feeds, init, gspmd=False)
    noises = [jax_noise(k, B, N_CRITIC, GEN_MULT) for k in keys]
    one = _one_process(alg, feeds, noises)
    own = _one_process(alg, feeds, [None, None])
    ranks = launch(_gspmd_rank, 4, backend="gloo", args=(alg, feeds, noises), timeout=TIMEOUT)
    for r in range(1, 4):
        assert [[m for m, _ in run] for run in ranks[r]] == \
            [[m for m, _ in run] for run in ranks[0]], f"rank {r}"
    # each run: (metrics, state) after every cycle, the initial state first
    injected = [(None, init)] + [(m, _np_state(p)) for m, p in ranks[0][0]]
    own_noise = [(None, init)] + [(m, _np_state(p)) for m, p in ranks[0][1]]
    for i in range(1, 3):
        (m, st), prev = injected[i], injected[i - 1][1]
        assert st.step == i
        label = f"{alg} against one process, cycle {i}"
        _assert_costs(m, one[i][0], prev, one[i - 1][1], label)
        assert_deltas_close(st, one[i][1], init, label, i)
        label = f"{alg} against JAX's gspmd_cycle, cycle {i}"
        _assert_costs(m, jax_gspmd[i][0], prev, jax_gspmd[i - 1][1], label)
        if i == 1:
            assert_deltas_close(st, jax_gspmd[i][1], init, label, moments=False)
        else:
            spread = deltas_off(jax_one[i][1], jax_gspmd[i][1], init)
            for g, (n_off, n_live) in deltas_off(st, jax_gspmd[i][1], init).items():
                assert n_off <= spread[g][0] + 1e-3 * n_live, (label, g, n_off, spread[g])
        (m, st), prev = own_noise[i], own_noise[i - 1][1]
        label = f"{alg} own noise against one process, cycle {i}"
        _assert_costs(m, own[i][0], prev, own[i - 1][1], label)
        if i == 1:
            assert_deltas_close(st, own[i][1], init, label, i)


def test_data_rows_are_the_whole_draw_by_global_row(rules):
    """Each rank's rows of ``z`` drawn on the 2×2 mesh (``data_rows``),
    gathered, are the one-process draw bit for bit (the dequantisation of
    sharded rows is ``test_op_rules_on_a_2x2_mesh[dequantize]``)."""
    got, want = rules["draws"]
    assert torch.equal(got, want)


# --------------------------------------------------------- restore_sharded
def test_restore_sharded_across_layouts(tmp_path):
    """A state saved from the 2×2 mesh after one cycle restores onto 4×1
    and 1×4 with every leaf placed as asked (the five tensor-parallel
    leaves sharded on ``model``), and its whole tensors, counts and step
    bit-equal to what was saved."""
    out = launch(_restore_rank, 4, backend="gloo", args=(str(tmp_path / "ckpt"),),
                 timeout=TIMEOUT)[0]
    saved = _np_state(out["saved"])
    assert saved.step == 1
    for shape in ((4, 1), (1, 4)):
        placed, sharded, payload = out[shape]
        assert placed, shape
        assert sharded == {("gen", "G.Input", "W"): (Replicate(), Shard(1)),
                           ("gen", "G.Input", "b"): (Replicate(), Shard(0)),
                           ("disc", "D.Output", "W"): (Replicate(), Shard(0)),
                           ("disc", "D.Embedding_y", "W"): (Replicate(), Shard(1)),
                           ("disc", "D.Embedding_y", "b"): (Replicate(), Shard(0))}, shape
        assert_states_bit_equal(_np_state(payload), saved, f"restored onto {shape}")
