"""One run of one cell: set-up, the measured window, an optional traced
segment, the comparison that decides ``correct``, and the result line.

- Set-up (``setup_s``, from the process's first line to the window): the
  imports, the card, the inputs drawn from the seed, the program built with
  the benchmark's weights, the first ``check_steps`` steps through the
  window's own call (the steps the reference follows), and a warm-up of the
  window's shapes (its graph captured).
- The window: whole units (a block of cycles, or an iteration) until
  ``seconds`` have passed, then a synchronise.  ``train_imgs_per_s`` is the
  real images the critic consumed over the window's host time.
- With ``trace``, after the window, ``trace_units`` units under the
  profiler (``benchmark/trace.py``); the per-layer metrics read it, the
  window's rate and the program's counters.
- Then the program is freed, and the reference runs the same first steps
  from the same weights on the same rows, and the generator's first step
  again from the critic that the program reached (``benchmark/check.py``).

The result line ends with ``compared``: each number compared, with its
value and its limit, as the benchmark's contract asks of every run (the
same lines close standard error).
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Dict, List, Mapping, NamedTuple, Optional

from benchmark import check, manifest
from benchmark.trace import Trace, traced

BANNED = ("jax", "jaxlib", "flax", "rcgan_tpu")


def banned_modules() -> List[str]:
    """The top-level names in ``sys.modules`` that the run may not hold,
    compared whole (``rcgan_tpu_torch`` is not ``rcgan_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


class Context(NamedTuple):
    """What a per-layer metric's reader reads."""
    config: Mapping
    traffic: Mapping
    work: object             # the configuration's work module
    steps: int               # steps of the window
    window_s: float          # the window's host seconds
    stats: Mapping           # the program's capture counters
    trace: Optional[Trace]   # the traced segment, when there was one


def _power() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(cell: str, seed: int, seconds: float, trace: bool, t0: float, device="cuda",
             overrides=None, log=print) -> Dict:
    """The result line of one run (a dict).  ``overrides(config, traffic)``
    changes the configuration and traffic in place (the tests' tiny sizes)."""
    import torch

    bench = manifest.benchmark()
    entry = manifest.cell_entry(bench, cell)
    wl = manifest.workload(cell)
    cfg = manifest.config(wl["config"])
    traffic = dict(wl["traffic"])
    if overrides is not None:
        overrides(cfg, traffic)
    limits = wl["limits"]
    ref = manifest.reference(wl["config"])
    work = manifest.work(wl["config"])
    drv = manifest.driver(wl["driver"])
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sess = drv.build(cfg, traffic, seed, device, ref)
    sess.first_steps()
    sess.warm()
    sync()
    setup_s = time.perf_counter() - t0

    steps = images = 0
    start = time.perf_counter()
    while True:
        sess.unit()
        steps += sess.unit_steps
        images += sess.unit_images
        if time.perf_counter() - start >= seconds:
            break
    sync()
    window_s = time.perf_counter() - start

    tr = None
    if trace:
        def segment():
            n = 0
            for _ in range(traffic["trace_units"]):
                sess.unit()
                n += sess.unit_steps
            return n
        tr = traced(segment, sync)

    failed = sess.failed()
    memory = torch.cuda.max_memory_allocated() if cuda else 0
    stats = sess.stats()
    if trace:
        ctx = Context(cfg, traffic, work, steps, window_s, stats, tr)
        metrics = {}
        for m in manifest.cell_metrics(bench, cell, "per_layer"):
            value = manifest.metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        measured = {"setup_s": setup_s, "train_imgs_per_s": images / window_s}
        metrics = {m["name"]: {"value": float(measured[m["name"]]), "unit": m["unit"]}
                   for m in manifest.cell_metrics(bench, cell, "end_to_end")}
    program = sess.first
    sess.release()

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    from benchmark.reference.layers import Precision
    f32 = Precision("float32")
    want = sess.reference(f32)
    worst: dict = {}
    numbers = check.numbers(program, want, sess.follow(program["mid"], f32), sess.before,
                            ref.groups(sess.before), list(limits), worst)
    correct = failed == 0 and all(numbers[k] <= v for k, v in limits.items())

    found = banned_modules()
    if found:
        raise SystemExit(f"the run holds {found} in sys.modules")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": entry["chips"], "memory_peak_bytes": int(memory)}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    out = {"correct": bool(correct), "attempted": steps, "failed": failed, "metrics": metrics,
           "device": dev}
    if tr is not None:
        out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.gaps}
    out["compared"] = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    log(f"card: {_power() if cuda else 'cpu'}; setup_s {setup_s:.3f}; window "
        f"{window_s:.3f} s, {steps} steps; capture {stats}")
    if tr is not None:
        log(f"traced: {tr.steps} steps, {tr.window_s:.3f} s, busy {tr.busy_s:.3f} s")
    log(f"losses: program {program['losses']}, reference {want['losses']}")
    if worst:
        log(f"worst leaf of change_gap: {worst['change_gap']}")
    for k, v in limits.items():
        log(f"compared {k}: {numbers[k]:.6g} (limit {v:.6g})")
    return out
