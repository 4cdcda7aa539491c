"""The readers of the program's spans (``benchmark/spans.py`` and the
metrics that use it) on made-up counters: each value from the keys it
reads, and ``None`` where the program reports none of them, as a program
without spans does."""

import pytest

from benchmark import manifest
from benchmark.harness import Context

# a CIFAR-like program: 4 steps since its capture, the host spans over 6
STATS = {"captures": 2, "replays": 5, "warm_up_s": 1.0, "gc_s": 0.1, "capture_s": 0.2,
         "device_steps": 4,
         "device_s.d.input": 0.004, "device_s.g.input": 0.001, "device_s.g.forward": 0.010,
         "device_s.d.forward": 0.020, "device_s.g.backward": 0.030, "device_s.d.backward": 0.050,
         "device_s.g.update": 0.002, "device_s.d.update": 0.006, "device_s.between": 0.008,
         "host_s.rows": 0.012, "host_steps.rows": 6, "host_s.key": 0.003, "host_steps.key": 6,
         "host_s.load": 0.0006, "host_steps.load": 3, "host_s.launch": 0.3,
         "host_steps.launch": 6}
WANT = {"forward_device_ms.train": 1e3 * (0.004 + 0.001 + 0.010 + 0.020) / 4,
        "backward_device_ms.train": 1e3 * (0.030 + 0.050) / 4,
        "update_device_ms.train": 1e3 * (0.002 + 0.006) / 4,
        "step_gap_ms.train": 1e3 * 0.008 / 4,
        "host_prep_ms.train": 1e3 * (0.012 / 6 + 0.003 / 6 + 0.0006 / 3)}
# the capture counters alone: the parent's program, which has no spans
BARE = {k: v for k, v in STATS.items() if "." not in k and k != "device_steps"}


def _ctx(stats):
    return Context(config={}, traffic={}, work=None, steps=10, window_s=1.0, stats=stats,
                   trace=None)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_its_spans_and_nothing_without_them(name):
    read = manifest.metric(name).read
    assert read(_ctx(STATS)) == pytest.approx(WANT[name], rel=1e-12)
    assert read(_ctx(BARE)) is None
    assert read(_ctx({})) is None


def test_a_phase_the_program_does_not_mark_counts_zero():
    """PGGAN's iteration has no ``g.input``: the forward reads the rest;
    a program that marked steps but no forward reads nothing."""
    stats = {k: v for k, v in STATS.items() if k != "device_s.g.input"}
    assert manifest.metric("forward_device_ms.train").read(_ctx(stats)) == pytest.approx(
        1e3 * (0.004 + 0.010 + 0.020) / 4)
    assert manifest.metric("forward_device_ms.train").read(
        _ctx({"device_steps": 4, "device_s.between": 0.1})) is None
    assert manifest.metric("step_gap_ms.train").read(
        _ctx(dict(STATS, device_steps=0))) is None


def test_host_prep_needs_every_span():
    stats = {k: v for k, v in STATS.items() if not k.endswith(".key")}
    assert manifest.metric("host_prep_ms.train").read(_ctx(stats)) is None


def test_a_tiny_program_reports_every_span():
    """The trainers' counters, as a tiny CIFAR block on the CPU leaves them,
    give every reader a value."""
    import numpy as np
    import torch

    from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
    from rcgan_tpu_torch.data.cifar10 import device_dataset_of
    from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
    from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer

    torch.set_num_threads(min(2, torch.get_num_threads()))
    rs = np.random.RandomState(0)
    n, b, nc = 8, 2, 2
    ds = {"images": rs.randint(0, 256, (n, 3072)).astype(np.uint8),
          "labels": rs.randint(0, 10, n).astype(np.int32),
          "labels_random": rs.randint(0, 10, n).astype(np.int32),
          "labels_biased": rs.randint(0, 10, n).astype(np.int32),
          "labels_inv_weights": rs.uniform(-0.5, 1.5, (n, 10)).astype(np.float32)}
    tr = CifarTrainer(ResnetGANConfig(dim_g=8, dim_d=16, embedding_dim=24),
                      CifarAlgoConfig(algorithm="rcgan"),
                      CifarTrainConfig(n_critic=nc), np.eye(10), device="cpu",
                      device_dataset=device_dataset_of(ds, "cpu"))
    ts = tr.init(seed=1)
    tr.step_scan(ts, rs.randint(0, n, (2, nc, b)), rs.randint(0, 10, (2, 2 * b)),
                 rs.randint(0, 10, (2, 2 * b)), seed=3)
    ctx = _ctx(tr.captured.stats())
    for name in WANT:
        assert manifest.metric(name).read(ctx) > 0.0, name
