"""The readings that a cell's limits are set from, all in one process.

For each seed: the program's first steps against the reference (the sound
runs, the lower readings), and, in the program's place, the reference at
the control's precision (float8 operands: the step below the cell's
bfloat16) and two faults: the reference with half of every batch left out
of both steps (``half_batch``), and of the generator's step alone
(``half_gen``).  A state left unchanged reads 1 in ``change_gap`` and
needs no run.  No window is measured: a training cell's readings need
none.  Beside every number of ``benchmark/check.py`` each side reads two
numbers tried, not compared: ``change_diff.<group>``, ``‖Δp_side −
Δp_reference‖ / ‖Δp_reference‖`` of the group's change after the last
step, and ``grad_gap.<group>``, the worst leaf's gap of first-gradient
norms over the larger of its and the median leaf's reference norm.
``bf16`` puts the reference at bfloat16 in the program's place: a
witness of what the cells' own precision costs.

    python3 -m benchmark.calibrate --workload pggan64.train_stage3_stab \\
        --seeds 11,12,13 --out chiprun_out/calibrate.json
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time
from typing import Mapping

from benchmark import check, manifest
from benchmark.reference.layers import Precision

FAULTS = {"half_batch": ("disc", "gen"), "half_gen": ("gen",)}


def _tried(side, want, followed, before, groups) -> dict:
    out = {}
    g_s, g_r = check.norms(side["grads"]), check.norms({**want["grads"], **followed["grads"]})
    for group, keys in groups.items():
        keys = [k for k in keys if g_r.get(k, 0.0) > 0.0]
        if keys:
            med = statistics.median(g_r[k] for k in keys)
            out[f"grad_gap.{group}"] = max(abs(g_s[k] - g_r[k]) / max(g_r[k], med)
                                           for k in keys)
    for group, keys in groups.items():
        diff = check.changes({k: side["params"][k] for k in keys},
                             {k: want["params"][k] for k in keys})
        d_r = check.changes({k: want["params"][k] for k in keys}, {k: before[k] for k in keys})
        ref = math.sqrt(sum(v ** 2 for v in d_r.values()))
        if ref > 0.0:
            out[f"change_diff.{group}"] = math.sqrt(sum(v ** 2 for v in diff.values())) / ref
    return out


def readings(wl: Mapping, seed: int, device="cuda", overrides=None, faults=True) -> dict:
    """``{"program": numbers, "fp8": numbers, "half_batch": numbers,
    "half_gen": numbers, "bf16": numbers, "worst": leaf, "losses": both
    sides'}`` of one
    seed of the workload ``wl`` (a workload file's contents)."""
    import torch

    cfg = manifest.config(wl["config"])
    traffic = dict(wl["traffic"])
    if overrides is not None:
        overrides(cfg, traffic)
    ref = manifest.reference(wl["config"])
    sess = manifest.driver(wl["driver"]).build(cfg, traffic, seed, device, ref)
    sess.first_steps()
    program = sess.first
    sess.release()
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    f32 = Precision("float32")
    try:
        want = sess.reference(f32)
        groups = ref.groups(sess.before)

        def read(side, worst=None):
            followed = sess.follow(side["mid"], f32)
            got = check.numbers(side, want, followed, sess.before, groups, check.names(groups),
                                worst)
            return {**got, **_tried(side, want, followed, sess.before, groups)}

        worst: dict = {}
        out = {"program": read(program, worst)}
        out["worst"] = list(worst["change_gap"])
        out["losses"] = {"program": program["losses"], "reference": want["losses"]}
        if faults:
            out["fp8"] = read(sess.reference(Precision("fp8")))
            out["bf16"] = read(sess.reference(Precision("bf16")))
            for name, half in FAULTS.items():
                out[name] = read(sess.reference(f32, half=half))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    rows = {}
    for s in (int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        rows[s] = readings(manifest.workload(args.workload), s)
        print(s, f"{time.perf_counter() - t:.1f} s", json.dumps(rows[s]), flush=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    for kind in ("program", "fp8", "bf16", *FAULTS):
        for k in next(iter(rows.values()))[kind]:
            vals = sorted(r[kind][k] for r in rows.values())
            print(f"{kind} {k}: min {vals[0]:.4g} max {vals[-1]:.4g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
