"""The pieces under the port's compiled programs (``train/graphs.py``), on
the CPU: the step block's fixed buffers, a stand-in capture's launch
counts (added once per replay), ``Program.run``'s eager leading rows and
its group's byte record, the seeds' device-base forms, Adam with
device scalars against its host-float form, the state kept at its
addresses, and the sampler's bucket path against the eager pass.

CUDA graphs exist only on the card (``chip_smoke.py`` phase 13 holds
captured against eager there); here the stand-in replaces the few
``torch.cuda`` calls of a capture, so that what the module does around
them runs."""

import contextlib

import numpy as np
import pytest
import torch

from rcgan_tpu_torch.core import rng
from rcgan_tpu_torch.models import dcgan, pggan
from rcgan_tpu_torch.models.resnet_gan import Generator, ResnetGANConfig, sample
from rcgan_tpu_torch.ops.kernels import runtime
from rcgan_tpu_torch.ops.norm import BatchNorm
from rcgan_tpu_torch.parallel.mesh import DataGroup
from rcgan_tpu_torch.serving import Sampler
from rcgan_tpu_torch.train import graphs
from rcgan_tpu_torch.train.state import ScalelessAdam, state_in_place
from torch_parity import TINY_MNIST, StandIn, install_stand_in

torch.set_num_threads(min(2, torch.get_num_threads()))


# ------------------------------------------------------------------ block
def test_step_block_rows_outputs_and_counter():
    """Fields of four dtypes, scalar and shaped rows, packed into one
    buffer: each row reads back what was loaded, at the counter; outputs go
    to the counter's row; ``read`` returns copies; a short load leaves the
    rows beyond it alone and sets the counter to 0."""
    fields = {"a": (torch.float32, (2, 3)), "i": (torch.int64, ()), "s": (torch.int32, (5,)),
              "u": (torch.uint8, (7,))}
    blk = graphs.StepBlock(fields, 4, "cpu", outputs={"m": (torch.float32, ()),
                                                      "v": (torch.float32, (3,))})
    rs = np.random.RandomState(0)
    rows = {"a": rs.randn(4, 2, 3).astype(np.float32), "i": np.array([-(2 ** 62), 5, 2 ** 62, -1]),
            "s": rs.randint(-100, 100, (4, 5)), "u": rs.randint(0, 256, (4, 7))}
    assert blk.load(rows) == 4
    for j in range(4):
        assert int(blk.counter) == j
        assert np.array_equal(blk.row("a").numpy(), rows["a"][j])
        assert int(blk.row("i")) == rows["i"][j] and blk.row("i").dtype == torch.int64
        assert np.array_equal(blk.row("s").numpy(), rows["s"][j].astype(np.int32))
        assert np.array_equal(blk.row("u").numpy(), rows["u"][j].astype(np.uint8))
        blk.write("m", torch.tensor(float(j)))
        blk.write("v", torch.full((3,), 10.0 + j))
        blk.advance()
    out = blk.read(4)
    assert out["m"].tolist() == [0.0, 1.0, 2.0, 3.0] and out["v"][:, 0].tolist() == [10, 11, 12, 13]
    assert out["m"].data_ptr() != blk.outputs["m"].data_ptr()
    assert blk.load({k: v[:2] + 1 for k, v in rows.items()}) == 2 and int(blk.counter) == 0
    blk.advance()
    blk.advance()
    assert np.array_equal(blk.row("a").numpy(), rows["a"][2])  # row 2 untouched
    with pytest.raises(ValueError, match="rows for a block"):
        blk.load({k: np.concatenate([v, v[:1]]) for k, v in rows.items()})
    with pytest.raises(ValueError, match="block fields"):
        blk.load({"a": rows["a"]})
    with pytest.raises(ValueError, match="expected"):
        blk.load(dict(rows, a=rows["a"][:, :1]))


# ------------------------------------------------------- stand-in capture
def test_a_stand_in_capture_counts_once_per_replay(monkeypatch):
    """The first call of a key is the warm-up (counted as an eager step) and
    the capture (whose wrapper calls go to the record, not to the totals,
    also those made on another thread, as autograd's backward is); each
    replay adds the record once, so the totals read after N calls as after
    N eager steps; a new key captures again; ``capture=False`` runs the body
    every call."""
    import threading

    device_log = []
    standin = StandIn(device_log)
    install_stand_in(monkeypatch, standin)

    def launch(name, variant):
        runtime.count_launch(name, variant)
        device_log.append(name)

    def body():  # one step: two "kernels", each counted where it launches
        launch("sn", None)
        t = threading.Thread(target=launch, args=("conv3x3", "wgmma"))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        return "out"

    step = graphs.CapturedStep(body, "cuda", capture=True)
    runtime.reset_launch_counts()
    assert step(key=1) == "out" and device_log == ["sn", "conv3x3"]  # the warm-up ran
    assert step.captures == 1 and step.launches.counts["sn"] == 1
    assert runtime.launch_counts()["sn"] == 1  # the capture added nothing
    for n in range(2, 5):
        step(key=1)
        assert runtime.launch_counts()["sn"] == n
        assert runtime.variant_counts("conv3x3")["wgmma"] == n
        assert device_log == ["sn", "conv3x3"] * n
    assert step.replays == 3 and step.captures == 1
    step(key=2)  # another key: warm-up and capture again
    assert step.captures == 2 and runtime.launch_counts()["sn"] == 5
    eager = graphs.CapturedStep(body, "cpu", capture=False)
    eager()
    eager()
    assert runtime.launch_counts()["sn"] == 7 and eager.captures == 0
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        graphs.CapturedStep(body, "cpu", capture=True)


def test_a_capture_collects_before_it_begins(monkeypatch):
    """Each capture runs a full ``gc.collect()`` after the warm-up and
    before the capture begins, so that the collector cannot free a graph
    (held by a dropped owner's reference cycle) during the capture, which
    would invalidate it; the step's stats time each part."""
    order = []
    standin = StandIn([])
    install_stand_in(monkeypatch, standin)
    enter = standin.graph

    @contextlib.contextmanager
    def graph(g, **kw):
        order.append("capture")
        with enter(g, **kw):
            yield

    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(graphs.gc, "collect", lambda: order.append("gc"))
    step = graphs.CapturedStep(lambda: order.append("body"), "cuda", capture=True)
    step(key=1)
    assert order == ["body", "gc", "capture", "body"]
    step(key=1)
    assert order == ["body", "gc", "capture", "body"]  # a replay collects nothing
    st = step.stats()
    assert all(st[k] >= 0.0 for k in ("warm_up_s", "gc_s", "empty_cache_s", "capture_s"))


def test_program_runs_its_leading_rows_eagerly_and_records_its_groups_bytes(monkeypatch):
    """``Program.run`` of four rows with one eager leading row, under the
    stand-in capture, in a group (its ``all_reduce`` a no-op here): the
    first row runs the body eagerly (``eager_row``), the second is the
    warm-up and the capture, the last two replay; the body receives the
    state bound for the call, which the graph holds and the program does not
    after the call; the group's bytes are recorded at the capture and added
    once per replay, so that ``bytes_reduced`` reads as after four eager
    steps; a second run of the key replays from its first row; the host
    spans ``key``, ``load``, ``launch`` and ``read`` count the rows."""
    standin = StandIn([])
    install_stand_in(monkeypatch, standin)
    monkeypatch.setattr(torch.distributed, "all_reduce", lambda t, op=None: None)
    group = DataGroup(rank=0, world_size=1, device=torch.device("cpu"), backend="nccl")
    state, seen = object(), []

    def body(blk, st):
        if standin.capturing is not None:  # a card's capture finds the warm-up's row
            blk.counter.sub_(1)
        seen.append((prog.eager_row, st))
        x = blk.row("x")
        group.mean_([x])
        blk.write("y", x * 2)
        blk.advance()

    prog = graphs.Program(body, {"x": torch.float32}, "cpu", False,
                          {"y": (torch.float32, (3,))}, group)
    prog.captured.capture, prog.captured.device = True, torch.device("cuda")
    assert prog.captured.group is group
    rows = [{"x": np.full(3, float(i), np.float32)} for i in range(4)]
    prog.run(rows, state, lambda: "key", eager=1)
    assert seen == [(True, state), (False, state), (False, state)]
    assert (prog.captured.captures, prog.captured.replays) == (1, 2)
    assert group.bytes_reduced == 4 * 12 and prog.captured.bytes_reduced == 12
    assert prog.captured._held is state and prog._state is None and not prog.eager_row
    prog.run(rows[:2], state, lambda: "key")
    assert len(seen) == 3 and prog.captured.replays == 4 and group.bytes_reduced == 6 * 12
    assert prog.read(2)["y"].shape == (2, 3)
    st = prog.captured.stats()
    assert [st[f"host_steps.{n}"] for n in ("key", "load", "launch", "read")] == [6, 6, 6, 2]


def test_recorded_launches_go_to_the_capture_streams_record(monkeypatch):
    """A launch counted while its stream is captured goes to that stream's
    record, from any thread; one counted on another stream, or with no
    capture, goes to the totals; a stream is recorded once at a time."""
    capturing = {"stream": None}
    monkeypatch.setattr(runtime, "_capturing_stream", lambda: capturing["stream"])
    runtime.reset_launch_counts()
    with runtime.recorded_launches(7) as rec:
        capturing["stream"] = 7
        runtime.count_launch("cond_bn")
        runtime.count_launch("conv3x3", "cudnn")
        capturing["stream"] = 8  # another stream, not captured by this record
        runtime.count_launch("dequant")
        capturing["stream"] = None
        runtime.count_launch("dequant")
        with pytest.raises(RuntimeError, match="already being recorded"):
            with runtime.recorded_launches(7):
                pass
    assert rec.counts["cond_bn"] == 1 and rec.counts["conv3x3"] == 0
    assert rec.variants["conv3x3"]["cudnn"] == 1 and rec.counts["dequant"] == 0
    assert runtime.launch_counts() == {**dict.fromkeys(runtime.KERNELS, 0), "dequant": 2}
    runtime.add_launches(rec, times=3)
    assert runtime.launch_counts()["cond_bn"] == 3
    assert runtime.variant_counts("conv3x3")["cudnn"] == 3


# ------------------------------------------------------------------ seeds
@pytest.mark.parametrize("seed", [0, 7, 2 ** 62 + 3, 123456789123])
def test_seed_base_forms_are_bit_equal(seed):
    """``example_normal_from`` and ``example_uniform_from`` with the seed's
    ``seed_base`` as an int64 scalar (shape ``()`` or ``[1]``) give the int
    form's bits, at any first index."""
    for base in (torch.tensor(rng.seed_base(seed)), torch.tensor([rng.seed_base(seed)])):
        assert base.dtype == torch.int64
        for n, dim, first in ((1, 3, 0), (5, 128, 17), (9, 100, 0)):
            assert torch.equal(rng.example_normal(seed, n, dim, "cpu", first),
                               rng.example_normal_from(base, n, dim, first))
            assert torch.equal(rng.example_uniform(seed, n, dim, "cpu", -1.0, 1.0, first),
                               rng.example_uniform_from(base, n, dim, -1.0, 1.0, first))


# ------------------------------------------------------------------- Adam
def _adam_with_host_floats(adam, params, grads, state, lr):
    """The update with lr and the bias corrections as host floats
    (``_foreach_div`` by a float, ``alpha=-lr``)."""
    from rcgan_tpu_torch.train.state import _bias_correction

    with torch.no_grad():
        _host_float_update(adam, params, [g.float() for g in grads], state, lr,
                           _bias_correction)


def _host_float_update(adam, params, grads, state, lr, _bias_correction):
    state.count += 1
    narrow = adam.moment_dtype != torch.float32
    mu = [m.float() for m in state.mu] if narrow else state.mu
    nu = [v.float() for v in state.nu] if narrow else state.nu
    torch._foreach_mul_(mu, adam.b1)
    torch._foreach_add_(mu, grads, alpha=1.0 - adam.b1)
    torch._foreach_mul_(nu, adam.b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - adam.b2)
    denom = torch._foreach_div(nu, _bias_correction(adam.b2, state.count))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, adam.eps)
    step = torch._foreach_div(mu, _bias_correction(adam.b1, state.count))
    torch._foreach_div_(step, denom)
    torch._foreach_add_(params, step, alpha=-lr)
    if narrow:
        torch._foreach_copy_(state.mu, mu)
        torch._foreach_copy_(state.nu, nu)


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_adam_device_scalars_equal_the_host_float_form(moment_dtype):
    """``apply_`` with ``scalars(count, lr)`` in a float32 tensor, and
    ``update_`` (which packs them), are bit-equal on the CPU to the update
    with host floats, over five steps with the lr changing, at sizes with
    and without a vector tail; ``apply_`` leaves the count alone."""
    rs = np.random.RandomState(0)
    p0 = [rs.randn(*s).astype(np.float32) for s in ((33, 7), (5,), (1,), (64, 64))]
    for b1, b2 in ((0.0, 0.9), (0.5, 0.999)):
        adam = ScalelessAdam(b1, b2, moment_dtype=moment_dtype)
        ps = {k: [torch.from_numpy(p.copy()) for p in p0] for k in ("ref", "update", "apply")}
        sts = {k: adam.init(v) for k, v in ps.items()}
        for t, lr in enumerate((2e-4, 1.7e-4, 3e-1, 1e-5, 2e-4)):
            g = [torch.from_numpy(rs.randn(*p.shape).astype(np.float32) * 10.0 ** (t - 2))
                 for p in p0]
            _adam_with_host_floats(adam, ps["ref"], g, sts["ref"], lr)
            adam.update_(ps["update"], g, sts["update"], lr)
            scalars = torch.from_numpy(adam.scalars(sts["apply"].count + 1, lr))
            adam.apply_(ps["apply"], g, sts["apply"], scalars)
            assert sts["apply"].count == t
            sts["apply"].count += 1
            for k in ("update", "apply"):
                for a, b in zip(ps[k] + sts[k].mu + sts[k].nu,
                                ps["ref"] + sts["ref"].mu + sts["ref"].nu):
                    assert torch.equal(a, b), (b1, b2, t, k)


def test_scalars_are_lr_the_float32_bias_corrections_and_their_reciprocals():
    adam = ScalelessAdam(0.5, 0.999)
    s = adam.scalars(3, 2e-4)
    assert s.dtype == np.float32 and s.shape == (5,) and s[0] == np.float32(2e-4)
    one = np.float32(1.0)
    assert s[1] == one - np.power(np.float32(0.5), np.float32(3), dtype=np.float32)
    assert s[2] == one - np.power(np.float32(0.999), np.float32(3), dtype=np.float32)
    assert s[3] == np.float32(1.0 / float(s[1])) and s[4] == np.float32(1.0 / float(s[2]))


# ------------------------------------------------------------------ state
def test_state_in_place_keeps_addresses_and_chains():
    """Two chained BN calls inside ``state_in_place`` leave the moving
    statistics in the buffers they started in, holding what the calls
    wrote; a block that raises rebinds the old buffers unwritten."""
    bn, ref = BatchNorm(6, "bn", zero_debias=True), BatchNorm(6, "bn", zero_debias=True)
    ptrs = {n: b.data_ptr() for n, b in bn.named_buffers()}
    rs = np.random.RandomState(0)
    for _ in range(2):
        xs = [torch.from_numpy(rs.randn(4, 3, 6).astype(np.float32)) for _ in range(2)]
        with state_in_place(bn):
            for x in xs:
                bn(x)
            assert any(b.data_ptr() != ptrs[n] for n, b in bn.named_buffers())
        for x in xs:
            ref(x)
        for n, b in bn.named_buffers():
            assert b.data_ptr() == ptrs[n] and torch.equal(b, getattr(ref, n)), n
    before = {n: b.clone() for n, b in bn.named_buffers()}
    with pytest.raises(RuntimeError, match="boom"):
        with state_in_place(bn):
            bn(xs[0])
            raise RuntimeError("boom")
    for n, b in bn.named_buffers():
        assert b.data_ptr() == ptrs[n] and torch.equal(b, before[n]), n


# ---------------------------------------------------------------- sampler
def _generators():
    pg_cfg = pggan.PGGANConfig(z_dim=8, dim=8, max_stage=2)
    return {"cifar": Generator(ResnetGANConfig(dim_g=8, dim_d=8, embedding_dim=12), 0, "cpu"),
            "mnist": dcgan.Generator(dcgan.DCGANConfig(**TINY_MNIST), 0),
            "pggan": pggan.Generator(pg_cfg, ResnetGANConfig(dim_g=8, dim_d=8,
                                                             embedding_dim=12), 0)}


@pytest.mark.parametrize("model", ["cifar", "mnist", "pggan"])
def test_sampler_bucket_path_equals_the_eager_pass(model):
    """Each bucket's pass through its fixed buffers equals the generator's
    own pass on the same padded inputs, bit for bit, at every bucket and
    for a request that streams through the largest; the buffers are made
    once per bucket."""
    gen = _generators()[model]
    sampler = Sampler(gen, buckets=(1, 3, 8))
    assert not sampler.graphs and sampler.model == model
    rs = np.random.RandomState(1)
    for n in (1, 2, 3, 5, 8, 11):
        z = rs.uniform(-1, 1, (n, sampler.z_dim)).astype(np.float32)
        labels = rs.randint(0, 10, n)
        got = sampler.sample_with_z(z, labels)
        want = []
        for i in range(0, n, 8):
            zc, lc = z[i:i + 8], labels[i:i + 8]
            bucket = next(b for b in (1, 3, 8) if b >= len(lc))
            zp = torch.from_numpy(np.concatenate([zc, np.zeros((bucket - len(lc),
                                                                sampler.z_dim), np.float32)]))
            lp = torch.from_numpy(np.concatenate([lc, np.zeros(bucket - len(lc), np.int64)]))
            if model == "mnist":
                out = dcgan.sample(gen, zp, torch.nn.functional.one_hot(lp, 10).float())
            elif model == "pggan":
                out = pggan.sample(gen, zp, lp)
            else:
                out = sample(gen, zp, lp).reshape(-1, 32, 32, 3)
            want.append(out.numpy()[:len(lc)])
        assert np.array_equal(got, np.concatenate(want)), (model, n)
    assert sorted(dict(shapes)["labels"][0] for _, shapes in sampler._passes.programs) == [1, 3, 8]
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        Sampler(gen, buckets=(1,), graphs=True)
