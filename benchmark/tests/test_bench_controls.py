"""The comparison that decides ``correct`` fails what it must, at tiny sizes
on the CPU, against each cell's own limits:

- the control: the reference at the float8 precision below the cells'
  bfloat16, in the program's place, and the reference with half of every
  batch left out of both steps, or of the generator's step alone;
- a whole run (set-up, window, comparison) with the program broken
  underneath: a step that leaves its state unchanged, both steps' losses
  taking the mean over half of the batch, leaving out the rest, and the
  generator's alone doing so.

The program itself runs in float32 here, which reads inside every limit.
The same readings at the cells' own sizes are ``test_bench_card.py``'s."""

import time

import pytest

from benchmark import calibrate, harness, manifest
from benchmark.tests import tiny

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


def _limits(cell):
    return manifest.workload(cell)["limits"]


def _fails(numbers, limits):
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_the_limits(cell):
    r = calibrate.readings(manifest.workload(cell), 2**31 + 5, device="cpu",
                           overrides=tiny.overrides("float32"))
    limits = _limits(cell)
    assert not _fails(r["program"], limits), r["program"]
    for kind in ("fp8", *calibrate.FAULTS):
        assert _fails(r[kind], limits), (kind, r[kind])


def _unchanged(monkeypatch):
    from rcgan_tpu_torch.train.state import ScalelessAdam
    monkeypatch.setattr(ScalelessAdam, "apply_", lambda self, *a, **k: None)


def _half_batch(monkeypatch, steps=("critic", "generator")):
    """The losses of ``steps`` take the mean over the first half of the
    batch.  PGGAN's critic step is the one whose real logits need a
    gradient (its generator step passes zeros in their place)."""
    from rcgan_tpu_torch.algorithms.cifar import CifarGAN
    from rcgan_tpu_torch.train import pggan_loop

    disc, gen, get_loss = CifarGAN.disc_loss, CifarGAN.gen_loss, pggan_loop.get_loss

    def disc_half(self, batch, z, c=None):
        n = z.shape[0] // 2
        return disc(self, {k: v[:n] for k, v in batch.items()}, z[:n], c)

    def gen_half(self, random, biased, z, c=None):
        n = z.shape[0] // 2
        return gen(self, random[:n], biased[:n], z[:n], c)

    def half(real, fake, lt):
        if ("critic" if real.requires_grad else "generator") not in steps:
            return get_loss(real, fake, lt)
        return get_loss(real[:len(real) // 2], fake[:len(fake) // 2], lt)

    if "critic" in steps:
        monkeypatch.setattr(CifarGAN, "disc_loss", disc_half)
    if "generator" in steps:
        monkeypatch.setattr(CifarGAN, "gen_loss", gen_half)
    monkeypatch.setattr(pggan_loop, "get_loss", half)


def _half_gen(monkeypatch):
    _half_batch(monkeypatch, ("generator",))


def _run(cell):
    return harness.run_cell(cell, 2**31 + 9, 0.05, False, time.perf_counter(), device="cpu",
                            overrides=tiny.overrides("float32"), log=lambda s: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"]


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _half_gen],
                         ids=["unchanged", "half_batch", "half_gen"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_program_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(cell)
    assert not out["correct"], out["compared"]
