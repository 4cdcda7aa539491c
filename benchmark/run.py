"""Runs one cell of the port's benchmark once and prints its result line.

    python3 -m benchmark.run --workload pggan64.train_stage3_stab --seed 7 \\
        --seconds 30 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` (and with ``--trace
1`` ``breakdown``), then ``compared``: each number that decides ``correct``
beside its limit, which are also the last lines of standard error.  The run
needs as many CUDA devices as the cell asks for, and fails without a
result line where they are missing.  Kernel builds and caches stay inside
the checkout (``rcgan_tpu_torch/_build``, ``.bench_cache/``).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _cache_dirs() -> None:
    """Fixed cache directories inside the checkout, before torch loads."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    from benchmark import harness, manifest

    chips = manifest.cell_entry(manifest.benchmark(), args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T0,
                           log=lambda s: print(s, file=sys.stderr, flush=True))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
