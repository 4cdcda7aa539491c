"""``benchmark/work/`` against ``torch.utils.flop_counter.FlopCounterMode``
over the plain reference, at tiny widths: every convolution and matrix
product that a step's forward and backward run is counted once."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import manifest
from benchmark.reference.layers import Precision
from benchmark.tests import tiny
from benchmark.weights import draw

CIFAR = [("rcgan", False), ("rcgan-u", True), ("rcgan-u", False)]


def _cifar(algorithm, perm):
    cfg = manifest.config("cifar_sngan")
    traffic = dict(manifest.workload("cifar_sngan.train_rcgan")["traffic"], algorithm=algorithm,
                   perm_classifier=perm)
    tiny.overrides()(cfg, traffic)
    return cfg, traffic


def _feed(cfg, iteration, gen):
    m, b, t = cfg["model"], cfg["batch_size"], cfg["train"]
    dim = m["img_size"] ** 2 * m["img_dim"]

    def labels(n):
        return torch.randint(0, m["vocab_size"], (n,), generator=gen)

    batches = [{"images": torch.randint(0, 256, (b, dim), generator=gen, dtype=torch.uint8),
                "labels": labels(b), "labels_random": labels(b), "labels_biased": labels(b)}
               for _ in range(t["n_critic"])]
    gb = t["gen_bs_multiple"] * b
    return {"iteration": iteration, "seed": 99, "batches": batches, "random": labels(gb),
            "biased": labels(gb)}


@pytest.mark.parametrize("iteration", [0, 1])
@pytest.mark.parametrize("algorithm,perm", CIFAR)
def test_cifar_cycle_work(algorithm, perm, iteration):
    cfg, traffic = _cifar(algorithm, perm)
    ref, work = manifest.reference("cifar_sngan"), manifest.work("cifar_sngan")
    params, u = draw(ref.param_specs(cfg["model"], traffic), ref.sn_scopes(cfg["model"], traffic),
                     3, "cpu")
    gen = torch.Generator().manual_seed(0)
    c = torch.full((10, 10), 0.04) + 0.6 * torch.eye(10)
    with FlopCounterMode(display=False) as counter:
        ref.run(cfg, traffic, params, u, [_feed(cfg, iteration, gen)], c, Precision())
    want = sum(w.flops for w in work.step_work(cfg, traffic, iteration))
    assert counter.get_total_flops() == want


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_pggan_iteration_work(stage):
    cfg = manifest.config("pggan64")
    traffic = {"stage": stage}
    tiny.overrides()(cfg, traffic)
    ref, work = manifest.reference("pggan64"), manifest.work("pggan64")
    params, u = draw(ref.param_specs(cfg["model"], traffic), ref.sn_scopes(cfg["model"], traffic),
                     3, "cpu")
    m, b = cfg["model"], cfg["batch_size"]
    r = ref.resolution(m, m["max_stage"])
    gen = torch.Generator().manual_seed(1)
    feed = {"x": torch.rand((b, r, r, m["img_dim"]), generator=gen) * 2 - 1,
            "labels": torch.randint(0, m["vocab_size"], (b,), generator=gen), "seed": 5}
    with FlopCounterMode(display=False) as counter:
        ref.run(cfg, traffic, params, u, [feed], Precision())
    assert counter.get_total_flops() == sum(w.flops for w in work.step_work(cfg, traffic))


def test_full_size_passes():
    """At the configuration's own sizes a generator pass is 3.62 GFLOP an
    image (its 256-channel 3x3 convs at 32x32 are 1.21 GFLOP each) and a
    critic pass 0.620 GFLOP, so an rcgan cycle is 3.89 TFLOP."""
    cfg = manifest.config("cifar_sngan")
    traffic = manifest.workload("cifar_sngan.train_rcgan")["traffic"]
    work = manifest.work("cifar_sngan")
    g = sum(w.flops for w in work._generator(cfg["model"], 1, False, 2))
    d = sum(w.flops for w in work._critic(cfg["model"], 1, False, False, 2) if w.phase == "fwd")
    assert g == pytest.approx(3.617e9, rel=1e-3) and d == pytest.approx(0.6196e9, rel=1e-3)
    total = sum(w.flops for w in work.step_work(cfg, traffic))
    assert total == pytest.approx(3.890e12, rel=1e-3)


@pytest.mark.parametrize("stage,tflop", [(2, 0.15327), (3, 0.64327), (4, 2.60329)])
def test_full_size_pggan_iterations(stage, tflop):
    """At the configuration's own sizes a PGGAN iteration at 16x16 is 0.153
    TFLOP, at 32x32 0.643 and at 64x64 2.60: the 3x3 convs at 128 channels
    grow with the pixels."""
    cfg = manifest.config("pggan64")
    total = sum(w.flops for w in manifest.work("pggan64").step_work(cfg, {"stage": stage}))
    assert total == pytest.approx(tflop * 1e12, rel=1e-4)
