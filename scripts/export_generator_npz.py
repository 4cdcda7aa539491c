"""Export a JAX CIFAR-10 checkpoint's generator for the PyTorch port.

Restores an orbax checkpoint through ``rcgan_tpu.serving.Sampler.from_checkpoint``
(which reads the run's archived ``config.json``) and writes, into
``out_dir``:

- ``generator.npz``: every ``G.*`` parameter, keyed ``"<layer>/<var>"``
  (``G.Block.1.Conv1/Filters``), in the JAX layouts (HWIO filters,
  ``W [in, out]``) — the format ``rcgan_tpu_torch/bridge.py::load_npz`` reads;
- ``config.json``: the run's ``ResnetGANConfig`` fields.

Runs where JAX and orbax run; the port's side needs neither.  Serve the
result with ``python -m rcgan_tpu_torch.serving --model cifar
--checkpoint_dir <out_dir> --serve``.

Usage: python scripts/export_generator_npz.py --checkpoint_dir <run>/checkpoint \\
           --out_dir <dir>
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def export(checkpoint_dir: str, out_dir: str) -> str:
    """Write ``generator.npz`` and ``config.json`` into ``out_dir``; returns
    the ``.npz`` path."""
    from rcgan_tpu.serving import Sampler

    # the restore template's batch size does not shape any parameter
    sampler = Sampler.from_checkpoint("cifar", checkpoint_dir, buckets=(1,))
    flat = {f"{layer}/{var}": np.asarray(a)
            for layer, d in sampler.ts.params.items() if layer.startswith("G.")
            for var, a in d.items()}
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "generator.npz")
    with open(path, "wb") as f:
        np.savez(f, **flat)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(sampler.trainer.cfg), f, indent=1, sort_keys=True)
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint_dir", required=True, help="orbax checkpoint of a CIFAR run")
    p.add_argument("--out_dir", required=True)
    args = p.parse_args(argv)
    path = export(args.checkpoint_dir, args.out_dir)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
