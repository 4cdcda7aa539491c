"""On the card, at each cell's own sizes: the program's first steps read
inside the cell's limits, and the control (the reference at float8 in the
program's place) and the half-batch faults (both steps, and the
generator's alone) each fail one of them, on three seeds.  Run on a machine with a card:

    python -m pytest benchmark/tests/test_bench_card.py -q -m card
"""

import pytest

from benchmark import calibrate, manifest

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_limits_separate_sound_runs_from_the_control_and_the_fault(cell):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits = manifest.workload(cell)["limits"]
    for seed in SEEDS:
        r = calibrate.readings(manifest.workload(cell), seed)
        assert all(r["program"][k] <= v for k, v in limits.items()), (seed, r["program"])
        for kind in ("fp8", *calibrate.FAULTS):
            assert any(r[kind][k] > v for k, v in limits.items()), (seed, kind, r[kind])
