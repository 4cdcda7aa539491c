"""The programs' spans (``utils/profiling.py::Spans``) on the CPU at tiny
widths: the CIFAR block (``CifarTrainer.step_scan``) and the PGGAN
iteration (``PGGANTrainer.step``) report every host and device span in
their ``program.captured.stats()``; the device spans fit inside the call;
the marks change no output and no launch count under the stand-in
capture, where a replay runs the marks its capture recorded; under the
profiler the host spans of those and of the MNIST block
(``MnistTrainer.step_scan``) are named regions in the one order of every
program, and without one nothing enters a region; a start of the profiler
falls in no device span."""

import time

import numpy as np
import pytest
import torch

from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
from rcgan_tpu_torch.algorithms.mnist import MnistAlgoConfig
from rcgan_tpu_torch.data.cifar10 import device_dataset_of
from rcgan_tpu_torch.data.confusion import build_confusion
from rcgan_tpu_torch.models.dcgan import DCGANConfig
from rcgan_tpu_torch.models.pggan import PGGANConfig
from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
from rcgan_tpu_torch.ops.kernels import runtime
from rcgan_tpu_torch.train import graphs
from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer
from rcgan_tpu_torch.train.mnist_loop import MnistTrainConfig, MnistTrainer
from rcgan_tpu_torch.train.pggan_loop import PGGANTrainConfig, PGGANTrainer
from rcgan_tpu_torch.utils import profiling
from torch_parity import TINY, TINY_MNIST, StandIn, install_stand_in, mnist_batch

torch.set_num_threads(min(2, torch.get_num_threads()))

B, N_CRITIC, GEN_MULT, K = 4, 2, 2, 3
HOST = ("rows", "key", "load", "launch", "read")
DEVICE = {"cifar": ("d.input", "g.input", "g.forward", "g.backward", "g.update", "d.forward",
                    "d.backward", "d.update", "between"),
          "pggan": ("d.input", "d.forward", "d.backward", "d.update", "g.forward",
                    "g.backward", "g.update", "between")}
# the host spans of one call of every program, in order (train/graphs.py::Program.run)
ORDER = ("rows", "key", "load", "launch", "read")


def _cifar():
    """A tiny rcgan-u trainer over a resident dataset, and a state; ``run(k)``
    steps one block of ``k`` cycles and returns its metrics."""
    cfg = ResnetGANConfig(**TINY, algorithm="rcgan-u")
    acfg = CifarAlgoConfig(algorithm="rcgan-u", perm_classifier=True, confuse_init=True)
    tcfg = CifarTrainConfig(n_critic=N_CRITIC, gen_bs_multiple=GEN_MULT)
    rs = np.random.RandomState(0)
    n = 16
    ds = {"images": rs.randint(0, 256, (n, 3072)).astype(np.uint8),
          "labels": rs.randint(0, 10, n).astype(np.int32),
          "labels_random": rs.randint(0, 10, n).astype(np.int32),
          "labels_biased": rs.randint(0, 10, n).astype(np.int32),
          "labels_inv_weights": rs.uniform(-0.5, 1.5, (n, 10)).astype(np.float32)}
    tr = CifarTrainer(cfg, acfg, tcfg, build_confusion(0.6)[0], device="cpu",
                      device_dataset=device_dataset_of(ds, "cpu"))
    ts = tr.init(seed=3)

    def run(k=K):
        _, ms = tr.step_scan(ts, rs.randint(0, n, (k, N_CRITIC, B)),
                             rs.randint(0, 10, (k, GEN_MULT * B)),
                             rs.randint(0, 10, (k, GEN_MULT * B)), seed=5)
        return ms

    return tr, tr.program.captured, run


def _pggan():
    """A tiny PGGAN trainer and a state; ``run()`` steps one iteration at
    stage 2 and returns its costs (``k`` is 1)."""
    tr = PGGANTrainer(PGGANConfig(z_dim=8, dim=8, max_stage=2),
                      ResnetGANConfig(dim_g=8, dim_d=8, embedding_dim=12),
                      PGGANTrainConfig(), device="cpu")
    ts = tr.init(seed=3)
    rs = np.random.RandomState(0)

    def run(k=1):
        images = {"x": (rs.rand(B, 16, 16, 3) * 2 - 1).astype(np.float32),
                  "labels": rs.randint(0, 10, B)}
        return tr.step(ts, images, seed=int(rs.randint(1 << 30)), alpha=1.0, stage=2,
                       trans=False)[1]

    return tr, tr.program.captured, run


def _mnist():
    """A tiny MNIST trainer over a resident dataset, and a state; ``run(k)``
    steps one block of ``k`` iterations and returns its metrics."""
    cfg = DCGANConfig(batch_size=B, disc_type="projection", spectral_norm=True, max_norm=True,
                      **TINY_MNIST)
    acfg = MnistAlgoConfig(algorithm="rcgan", estimate_confuse=True, perm_regularizer=True)
    tr = MnistTrainer(cfg, acfg, MnistTrainConfig(), build_confusion(0.3)[0], device="cpu")
    ts = tr.init(seed=3)
    n = 16
    ds = tr.batch_to_device(mnist_batch(n, 5)[0])
    rs = np.random.RandomState(0)

    def run(k=K):
        return tr.step_scan(ts, ds, rs.randint(0, n, (k, B)), seed=5)[1]

    return tr, tr.program.captured, run


MAKE = {"cifar": _cifar, "pggan": _pggan, "mnist": _mnist}


@pytest.mark.parametrize("kind", ["cifar", "pggan"])
def test_every_span_is_in_the_stats_and_the_device_spans_fit_in_the_call(kind):
    """One call (a block of K cycles, or one iteration): each host span and
    each device span is in ``captured.stats()``; ``rows`` covers the
    call's steps, as ``device_steps`` does; the device spans add up to a
    positive time no longer than the call."""
    _, captured, run = MAKE[kind]()
    t = time.perf_counter()
    run()
    wall = time.perf_counter() - t
    st = captured.stats()
    steps = K if kind == "cifar" else 1
    for name in HOST:
        assert st[f"host_steps.{name}"] == steps and st[f"host_s.{name}"] >= 0.0, name
    assert {k[len("device_s."):] for k in st if k.startswith("device_s.")} == set(DEVICE[kind])
    assert st["device_steps"] == steps
    total = sum(st[f"device_s.{name}"] for name in DEVICE[kind])
    assert 0.0 < total <= wall
    assert all(st[f"device_s.{name}"] > 0.0 for name in DEVICE[kind] if name != "between")


def _counted(body, prog, standin):
    """``body`` with one launch of two kernels counted where the body runs
    (on the CPU the wrappers launch nothing) and logged as the stand-in's
    device work; the stand-in's capture, which runs the body where a
    card's records it, first steps the program's block's row back."""
    def run():
        if standin.capturing is not None:
            prog.block.counter.sub_(1)
        for name in ("sn", "cond_bn"):
            runtime.count_launch(name)
            standin.log.append(name)
        return body()

    return run


@pytest.mark.parametrize("kind", ["cifar", "pggan"])
def test_marks_change_no_output_and_no_count_under_the_stand_in_capture(monkeypatch, kind):
    """The same steps under the stand-in capture with the marks on and off:
    bit-equal metrics and launch counts; with the marks on, each replay
    runs the stamps its capture recorded (the stand-in's device log) and
    the device totals cover the replays alone."""
    standin = StandIn([])
    install_stand_in(monkeypatch, standin)
    monkeypatch.setattr(profiling.Spans, "_stamp",
                        lambda self, closing: standin.log.append(("stamp", closing)))
    readings = {}
    for on in (True, False):
        monkeypatch.setattr(profiling, "device_marks", on)
        tr, old, run = MAKE[kind]()
        captured = graphs.CapturedStep(_counted(old.body, tr.program, standin), "cuda",
                                       capture=True)
        tr.program.captured = captured
        runtime.reset_launch_counts()
        del standin.log[:]
        metrics = [run() for _ in range(2 if kind == "cifar" else 4)]
        stamps = [e for e in standin.log if isinstance(e, tuple)]
        readings[on] = (metrics, runtime.launch_counts(), stamps, captured.stats())
    (m_on, c_on, s_on, st_on), (m_off, c_off, s_off, st_off) = readings[True], readings[False]
    for a, b in zip(m_on, m_off):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert c_on == c_off and c_on["sn"] > 0
    # a CIFAR cycle: d.input, the G step's four, each critic step's four, between
    marks = 6 + 4 * N_CRITIC if kind == "cifar" else len(DEVICE[kind])
    replays = st_on["replays"]
    # the warm-up; CIFAR's iteration 0 before it (eager, with no G step)
    eager = marks + (2 + 4 * N_CRITIC if kind == "cifar" else 0)
    assert replays > 0 and len(s_on) == eager + replays * marks and s_off == []
    assert st_on["device_steps"] == replays and "device_steps" not in st_off


@pytest.mark.parametrize("kind", ["cifar", "pggan", "mnist"])
def test_host_spans_are_regions_in_order_inside_the_call_under_the_profiler(kind):
    """Under ``torch.profiler.profile`` a call's host spans are the regions
    ``rcgan.<name>``, in the call's order, each inside the caller's region
    and none overlapping the next."""
    _, _, run = MAKE[kind]()
    run(1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("caller"):
            run(1)
    events = prof.events()
    call = next(e for e in events if e.name == "caller")
    spans = sorted((e for e in events if e.name.startswith(profiling.SPAN_PREFIX)),
                   key=lambda e: e.time_range.start)
    assert [e.name for e in spans] == [profiling.SPAN_PREFIX + n for n in ORDER]
    for a, b in zip(spans, spans[1:]):
        assert a.time_range.end <= b.time_range.start
    for e in spans:
        assert call.time_range.start <= e.time_range.start <= e.time_range.end \
            <= call.time_range.end


def test_no_region_is_entered_without_a_profiler(monkeypatch):
    """With no profiler running, neither ``annotate`` nor a host span nor a
    trainer's call enters a ``record_function``, and the host spans still
    count."""
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: entered.append(name))
    _, captured, run = _pggan()
    run()
    with profiling.annotate("rcgan.region"):
        pass
    spans = profiling.Spans("cpu")
    with spans.host("rows", steps=3):
        pass
    assert entered == []
    assert spans.stats()["host_steps.rows"] == 3 and captured.stats()["host_steps.rows"] == 1


def test_a_start_of_the_profiler_falls_in_no_device_span(monkeypatch):
    """A device span open when the profiler starts is dropped at the next
    host span, so that the wait for the profiler is in no span; the next
    marks time as before."""
    clock = iter(range(10 ** 9, 10 ** 10, 10 ** 6))  # 1 ms a reading
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: next(clock))
    spans = profiling.Spans("cpu")
    with spans.active():
        profiling.mark("a")   # closes nothing (no stamp yet)
        profiling.mark(profiling.BETWEEN)
        profiling.mark("a")   # between: 1 ms
        profiling.mark(profiling.BETWEEN)
    monkeypatch.setattr(profiling, "_profiling", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: _Null())
    next(clock)  # the profiler's start: a reading that no span may take
    with spans.host("rows"):
        pass      # the restart
    with spans.active():
        profiling.mark("a")   # between: 1 ms since the restart
        profiling.mark(profiling.BETWEEN)
    st = spans.stats()
    assert st["device_s.a"] == pytest.approx(3e-3) and st["device_s.between"] == pytest.approx(2e-3)
    profiling.mark("a")  # outside a body: nothing
    assert spans.stats()["device_s.a"] == st["device_s.a"]


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


class _Clock:
    """A host clock that moves only when the test moves it."""

    def __init__(self):
        self.ns = 1_000

    def perf_counter_ns(self):
        return self.ns

    def perf_counter(self):
        return self.ns * 1e-9


def _phases(monkeypatch, nested: bool, thread: bool = False):
    """The device totals of one body of three phases on the fake clock,
    with or without a nested span of 7 ns in ``d.backward`` (from another
    thread with ``thread``, as autograd runs a card's backward)."""
    import threading

    clock = _Clock()
    monkeypatch.setattr(profiling, "time", clock)
    spans = profiling.Spans("cpu")

    def attention():
        with profiling.span("attn.bwd"):
            clock.ns += 7

    with spans.active():
        profiling.mark("d.forward")
        clock.ns += 5
        profiling.mark("d.backward")
        clock.ns += 3
        if nested and thread:
            t = threading.Thread(target=attention)
            t.start()
            t.join()
        elif nested:
            attention()
        else:
            clock.ns += 7
        clock.ns += 4
        profiling.mark("d.update")
        clock.ns += 2
        profiling.mark("between")
    spans.steps = 1
    return {k[len("device_s."):]: round(v * 1e9) for k, v in spans.stats().items()
            if k.startswith("device_s.")}


@pytest.mark.parametrize("thread", [False, True])
def test_nested_spans_split_their_phase(monkeypatch, thread):
    """A nested span takes its own time out of the phase open around it and
    the phase resumes after it: the phase's total plus the nested one's is
    the phase's total without nested marks, every other phase reads the
    same, and a body without nested marks reads what a body of plain
    marks reads; a thread outside the body (autograd's) marks into the
    body's spans."""
    plain = _phases(monkeypatch, nested=False)
    assert plain == {"between": 0, "d.forward": 5, "d.backward": 14, "d.update": 2}
    got = _phases(monkeypatch, nested=True, thread=thread)
    assert got["attn.bwd"] == 7 and got["d.backward"] + got["attn.bwd"] == plain["d.backward"]
    assert {k: v for k, v in got.items() if k not in ("attn.bwd", "d.backward")} == \
        {k: v for k, v in plain.items() if k != "d.backward"}


def test_a_nested_span_outside_a_body_marks_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "_process", None)
    with profiling.span("attn.fwd"):
        pass
    spans = profiling.Spans("cpu")
    assert spans.stats() == {}
