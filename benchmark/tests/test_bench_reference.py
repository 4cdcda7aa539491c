"""The plain references against ``rcgan_tpu_torch`` at tiny widths on the
CPU, both in float32: each cell's first cycles or iterations from the same
weights on the same rows read the same losses, first gradients and
changes, and the generator's first gradient followed from the program's
critic reads the program's.

The tolerances are float32's: the two sides sum in other orders.  The
later steps' losses and the change of a leaf after Adam's steps are the
loosest, as Adam's first steps move every element by about ``lr``
whatever its gradient's size, so a small gradient's rounding can flip an
element's step, and the critic's next losses follow.  At these widths a
ReLU whose input lies within rounding of zero can flip too, which moves a
whole gradient by up to a few thousandths (a CIFAR seed below)."""

import pytest

from benchmark import calibrate, manifest
from benchmark.tests import tiny

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


@pytest.mark.parametrize("seed", [11, 2**31 + 77])
@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program(cell, seed):
    r = calibrate.readings(manifest.workload(cell), seed, device="cpu",
                           overrides=tiny.overrides("float32"), faults=False)
    got = r["program"]
    gaps = [abs(p - q) / max(abs(q), 1.0)
            for row_p, row_q in zip(r["losses"]["program"], r["losses"]["reference"])
            for p, q in zip(row_p, row_q)]
    assert max(gaps[:2]) < 1e-4 and max(gaps) < 1e-3, r["losses"]
    assert all(v < 1e-2 for k, v in got.items() if k.startswith(("grad_diff.", "norm_gap."))), got
    assert got["change_gap"] < 3e-2, got
