"""The port's multi-process programs under capture (``train/graphs.py``), on
the CPU at tiny widths: which groups and meshes capture by default and
which refuse to; a grouped trainer's ``bytes_reduced`` and launch counts
after N replays of a stand-in capture (the few ``torch.cuda`` calls faked,
``tests/torch_parity.py``) equal N eager cycles'; and the GSPMD cycle's
block path on a 2×2 gloo mesh against the path it replaced, which built
each cycle's DTensors from the host.

CUDA graphs and NCCL exist only on the card (``chip_smoke.py`` phases 12
and 16 hold the captured programs bit-equal to their eager bodies there).
Rank functions are module-level (a spawned rank imports this module)."""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
from rcgan_tpu_torch.algorithms.mnist import MnistAlgoConfig
from rcgan_tpu_torch.data.cifar10 import DATASET_KEYS, device_dataset_of
from rcgan_tpu_torch.data.confusion import build_confusion
from rcgan_tpu_torch.models.dcgan import DCGANConfig
from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
from rcgan_tpu_torch.ops.kernels import runtime
from rcgan_tpu_torch.parallel import launch
from rcgan_tpu_torch.parallel.gspmd import (_local_rows, _on_mesh, _ROWS_DIM, apply_shardings,
                                            gspmd_cycle, make_dp_tp_mesh, train_state_shardings)
from rcgan_tpu_torch.parallel.mesh import DataGroup, free_port
from rcgan_tpu_torch.train import graphs
from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer
from rcgan_tpu_torch.train.mnist_loop import MnistTrainConfig, MnistTrainer
from rcgan_tpu_torch.train.state import train_state_tensors
from torch_parity import TINY_MNIST, StandIn, install_stand_in, mnist_batch

torch.set_num_threads(min(2, torch.get_num_threads()))

B, N_CRITIC, GEN_MULT = 8, 2, 2
WIDTHS = dict(dim_g=8, dim_d=8, embedding_dim=12)
SEED = 3
TIMEOUT = 300.0
CPU = torch.device("cpu")


def _group(backend, device=CPU):
    return DataGroup(rank=0, world_size=1, device=device, backend=backend)


def _cifar(alg="rcgan-u", device="cpu", group=None, graphs_=None, dataset=None):
    perm = alg == "rcgan-u"
    return CifarTrainer(ResnetGANConfig(**WIDTHS, algorithm=alg),
                        CifarAlgoConfig(algorithm=alg, perm_classifier=perm, confuse_init=perm),
                        CifarTrainConfig(n_critic=N_CRITIC, gen_bs_multiple=GEN_MULT),
                        build_confusion(0.6)[0], device=device, group=group, graphs=graphs_,
                        device_dataset=dataset)


def _mnist(device="cpu", group=None, graphs_=None):
    cfg = DCGANConfig(batch_size=B, disc_type="projection", spectral_norm=True, max_norm=True,
                      **TINY_MNIST)
    acfg = MnistAlgoConfig(algorithm="rcgan", estimate_confuse=True, perm_regularizer=True,
                           loss_fn="hinge")
    return MnistTrainer(cfg, acfg, MnistTrainConfig(), build_confusion(0.3)[0], group=group,
                        device=device, graphs=graphs_)


# ------------------------------------------------------ defaults, refusals
@pytest.mark.parametrize("device, graphs_, backend, want", [
    ("cuda", None, None, True), ("cuda", None, "nccl", True), ("cuda", None, "gloo", False),
    ("cuda", False, "nccl", False), ("cuda", True, "nccl", True), ("cpu", None, None, False),
    ("cpu", None, "gloo", False), ("cpu", False, "gloo", False)])
def test_capture_defaults_per_backend(device, graphs_, backend, want):
    """A card captures by default, alone or in an NCCL group; a gloo group
    (its collectives staged through the host) and the CPU run eagerly."""
    group = None if backend is None else _group(backend, torch.device(device))
    assert graphs.capture_on(torch.device(device), graphs_, group) is want
    assert (group is None or group.capturable) is (backend != "gloo")


@pytest.mark.parametrize("make", [_cifar, _mnist], ids=["cifar", "mnist"])
def test_graphs_true_with_gloo_or_the_cpu_raises(make):
    """``graphs=True`` with a gloo group on a card raises with the reason,
    before any tensor is made on the card, and so does the CPU; a gloo group
    on the CPU runs the trainer eagerly (no silent capture either way)."""
    with pytest.raises(ValueError, match="cannot capture a gloo group's collectives"):
        make(device="cuda", group=_group("gloo", torch.device("cuda", 0)), graphs_=True)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        make(group=_group("gloo"), graphs_=True)
    tr = make(group=_group("gloo"))
    assert tr.graphs is False and tr.program.captured.capture is False
    assert tr.program.captured.group is tr.group


@pytest.fixture
def world1():
    """A gloo group of one rank in this process: the collectives run."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        yield _group("gloo")
    finally:
        dist.destroy_process_group()


def test_a_cpu_mesh_never_captures(world1):
    """``gspmd_cycle`` captures by default on a CUDA mesh only: on a CPU
    mesh it runs eagerly, and ``graphs=True`` raises."""
    mesh = make_dp_tp_mesh(1, 1, "cpu")
    tr = _cifar("rcgan")
    assert gspmd_cycle(tr, mesh).program.captured.capture is False
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        gspmd_cycle(tr, mesh, graphs=True)


# ----------------------------------------- counters under a stand-in capture
def _cifar_feed(it):
    """Cycle ``it``'s global critic batches and generator labels, numpy."""
    rs = np.random.RandomState(100 + it)
    d = {"images": rs.randint(0, 256, (N_CRITIC, B, 3072)).astype(np.uint8),
         "labels": rs.randint(0, 10, (N_CRITIC, B)),
         "labels_random": rs.randint(0, 10, (N_CRITIC, B)),
         "labels_biased": rs.randint(0, 10, (N_CRITIC, B)),
         "labels_inv_weights": rs.uniform(-0.5, 1.5, (N_CRITIC, B, 10)).astype(np.float32)}
    return d, {"random": rs.randint(0, 10, GEN_MULT * B), "biased": rs.randint(0, 10, GEN_MULT * B)}


def _counted(prog, body, standin):
    """``body`` with one "launch" of each kernel of the path counted where
    the body runs (on the CPU the wrappers launch nothing).  The stand-in's
    capture runs the body (a card's records it): it first steps the
    program's block's row counter back over the warm-up's row, where a
    card's capture finds it."""
    def run():
        if standin.capturing is not None:
            prog.block.counter.sub_(1)
        for name in ("sn", "cond_bn"):
            runtime.count_launch(name)
        runtime.count_launch("conv3x3", "wgmma")
        return body()
    return run


@pytest.mark.parametrize("kind", ["cifar", "mnist"])
def test_grouped_capture_counts_once_per_replay(monkeypatch, world1, kind):
    """A grouped trainer whose step is captured (the stand-in) and one that
    runs it eagerly, over five steps (the CIFAR cycle at iteration 0 eager,
    then warm-up, capture, three replays): after every step the group's
    ``bytes_reduced`` and the launch counts of the captured trainer equal
    the eager trainer's; a capture itself adds nothing; a replay adds one
    step's record."""
    standin = StandIn([])
    install_stand_in(monkeypatch, standin)
    eager_group = _group("gloo")
    make = _cifar if kind == "cifar" else _mnist
    got, want = make(group=world1), make(group=eager_group)
    for tr, capture in ((got, True), (want, False)):
        prog = tr.program
        prog.captured = graphs.CapturedStep(_counted(prog, prog.captured.body, standin),
                                            "cuda" if capture else "cpu", capture, tr.group)
    states = {id(tr): tr.init(SEED) for tr in (got, want)}
    for it in range(5):
        readings = []
        for tr in (got, want):
            runtime.reset_launch_counts()
            tr.group.reset_counts()
            if kind == "cifar":
                d, g = _cifar_feed(it)
                tr.step(states[id(tr)], d, g, it, SEED + it)
            else:
                tr.step(states[id(tr)], mnist_batch(B, 20 + it)[0], seed=it)
            readings.append((tr.group.bytes_reduced, runtime.launch_counts()))
        assert readings[0] == readings[1], (kind, it, readings)
        assert readings[1][0] > 0 and readings[1][1]["sn"] == 1
    first_replay = 2 if kind == "cifar" else 1  # the CIFAR cycle at iteration 0 runs eagerly
    captured = got.program.captured
    assert captured.captures == 1 and captured.replays == 5 - first_replay
    assert captured.bytes_reduced == readings[1][0]


# ------------------------------------------------------ GSPMD's block path
class _HostRow:
    """The cycle's row as the GSPMD step built it before its block: each
    field made on the host every cycle, the batch's fields as DTensors
    sharded on ``data`` (index batches gathered by each rank), the metrics
    gathered whole."""

    def __init__(self, row, trainer, mesh):
        self.mesh, self.device, self.dtypes = mesh, trainer.device, trainer._DTYPES
        self.fields = {}
        for k, v in row.items():
            dim = _ROWS_DIM.get("images" if k == "index" else k)
            if dim is None:
                self.fields[k] = torch.as_tensor(v).to(self.device, self.dtypes[k])
                continue
            lo, hi = _local_rows(mesh, v.shape[dim])
            local = torch.as_tensor(np.take(v, np.arange(lo, hi), axis=dim))
            if k == "index":
                for key in DATASET_KEYS:
                    self._place(key, trainer.device_dataset[key][local], dim)
            else:
                self._place(k, local, dim)
        self.metrics = {}

    def _place(self, k, local, dim):
        local = local.to(self.device, self.dtypes[k]).contiguous()
        self.fields[k] = DTensor.from_local(local, self.mesh, (Shard(dim), Replicate()))

    def row(self, k):
        return self.fields[k]

    def write(self, name, value):
        self.metrics[name] = value.full_tensor() if isinstance(value, DTensor) else value

    def advance(self):
        pass


def _host_row_step(trainer, mesh, ts, d, g, iteration, seed):
    row = trainer._cycle_row(ts, d, g, iteration, seed, None)
    blk = _HostRow(row, trainer, mesh)
    with _on_mesh(trainer, mesh):
        trainer._cycle(blk, ts, g_step=iteration > 0)
    ts.step += 1
    return ts, blk.metrics


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _gspmd_block_rank(group, algs):
    """On the 2×2 mesh, for each of ``algs``, two cycles (iterations 1 and
    2) from the seed's weights on index batches into a resident dataset,
    through the block path and through the host-row path: whether every
    local tensor of the state and the metrics are bit-equal after each
    cycle, and whether the state's and the block's addresses stay put."""
    mesh = make_dp_tp_mesh(2, 2, "cpu")
    feeds = [_cifar_feed(it) for it in range(2)]
    data = {k: np.concatenate([d[k].reshape(-1, *d[k].shape[2:]) for d, _ in feeds])
            for k in DATASET_KEYS}
    out = {}
    for alg in algs:
        runs = []
        for path in ("block", "host"):
            tr = _cifar(alg, dataset=device_dataset_of(data, "cpu"))
            ts = tr.init(SEED)
            ts = apply_shardings(ts, train_state_shardings(mesh, ts))
            step = gspmd_cycle(tr, mesh)
            cycles = []
            for it, (_, g) in enumerate(feeds):
                idx = {"index": np.arange(N_CRITIC * B).reshape(N_CRITIC, B) + it * N_CRITIC * B}
                if path == "block":
                    ts, m = step(ts, idx, g, it + 1, SEED + it)
                else:
                    ts, m = _host_row_step(tr, mesh, ts, idx, g, it + 1, SEED + it)
                addresses = [_local(t).data_ptr() for t in train_state_tensors(ts)]
                if path == "block":
                    addresses.append(step.program.block._buffer.data_ptr())
                cycles.append(([_local(t).clone() for t in train_state_tensors(ts)],
                               {k: v.clone() for k, v in m.items()}, addresses))
            runs.append(cycles)
        block, host = runs
        out[alg] = [{"equal": all(torch.equal(a, b) for a, b in zip(sa, sb)),
                     "metrics": {k: (float(ma[k]), float(mb[k])) for k in ma},
                     "addresses": addresses == block[0][2]}
                    for (sa, ma, addresses), (sb, mb, _) in zip(block, host)]
    return out


@pytest.fixture(scope="module")
def block_paths():
    return launch(_gspmd_block_rank, 4, backend="gloo", args=(("rcgan", "rcgan-u"),),
                  timeout=TIMEOUT)


@pytest.mark.parametrize("alg", ["rcgan", "rcgan-u"])
def test_gspmd_block_path_equals_the_host_row_path(block_paths, alg):
    """Run eagerly on the CPU, the block path (this rank's rows loaded into
    the step's block, the DTensors made and the index batch gathered inside
    the body) gives the bits of the path that made each cycle's DTensors on
    the host, over two chained cycles on every rank of the 2×2 mesh, and
    keeps every local state tensor and its block where they were."""
    for r, ranks in enumerate(block_paths):
        for it, c in enumerate(ranks[alg]):
            assert c["equal"], (alg, r, it)
            assert all(a == b for a, b in c["metrics"].values()), (alg, r, it, c["metrics"])
            assert c["addresses"], (alg, r, it)
