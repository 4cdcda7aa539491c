"""Run-directory layout and reproducibility archiving, copied from
``rcgan_tpu/utils/run_dir.py``: timestamped run dirs that encode
algorithm and alpha (``mnist/main.py:78-84``, ``cifar10/gan_resnet.py:117``),
and the package's
sources plus the command line archived into the run dir
(``cifar10/common/misc.py:18-26``)."""

from __future__ import annotations

import json
import os
import shutil
import sys
from datetime import datetime


def timestamp() -> str:
    return datetime.now().strftime("%Y%m%d-%H%M%S")


def mnist_run_dir(checkpoint_root: str, prefix: str, algorithm: str, alpha: float,
                  disc_type: str) -> str:
    return os.path.join(checkpoint_root, f"{prefix}{algorithm}_{alpha}_{disc_type}_{timestamp()}")


def cifar_run_dir(parent_dir: str, algorithm: str, alpha: float, run: str) -> str:
    return os.path.join(parent_dir, f"{algorithm}_alpha{alpha}_run-{run}_{timestamp()}")


def record_setting(out_dir: str, extra_config: dict | None = None,
                   script_file: str | None = None):
    """Copy this package's sources and the command line into ``out_dir`` so
    that every run is reproducible from its artifacts alone (build outputs
    left out).  ``script_file`` additionally archives the invoking shell
    script."""
    os.makedirs(out_dir, exist_ok=True)
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(out_dir, "scripts")
    if not os.path.exists(dst):
        shutil.copytree(
            pkg_root, os.path.join(dst, os.path.basename(pkg_root)),
            ignore=shutil.ignore_patterns("__pycache__", "*.pyc", "_build"),
        )
    if script_file is not None:
        if not os.path.exists(script_file):
            raise FileNotFoundError(
                f"--script_file {script_file!r} does not exist; refusing to "
                "record an unreproducible run")
        os.makedirs(dst, exist_ok=True)
        shutil.copy2(script_file, dst)
    with open(os.path.join(out_dir, "command.txt"), "w") as f:
        f.write(" ".join(sys.argv) + "\n")
    if extra_config is not None:
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            json.dump(extra_config, f, indent=2, default=str)
