"""Nothing under ``benchmark/`` imports JAX or the JAX package, compared by
whole top-level name (``rcgan_tpu_torch`` begins with ``rcgan_tpu``), and
the references import nothing of the program."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness, manifest

BENCH_DIR = manifest.BENCH_DIR
SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_in_sources(path):
    assert not set(_top_level_imports(path)) & set(harness.BANNED)


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert "rcgan_tpu_torch" not in set(_top_level_imports(path))


def test_banned_names_are_whole():
    sys.modules.setdefault("rcgan_tpu_torch_probe_", sys)
    try:
        assert "rcgan_tpu" not in harness.banned_modules()
    finally:
        del sys.modules["rcgan_tpu_torch_probe_"]


def test_a_run_loads_no_jax():
    """A whole run, at tiny sizes on the CPU, with every module of the
    benchmark imported: ``sys.modules`` holds none of the banned names, and
    none of the references loads the program."""
    code = """
import json, sys, time
from benchmark import manifest, harness, calibrate
from benchmark.tests import tiny
for c in manifest.benchmark()["configs"]:
    manifest.reference(c["name"]); manifest.work(c["name"])
clean = [m for m in sys.modules if m.split(".")[0] == "rcgan_tpu_torch"]
for m in manifest.benchmark()["per_layer"]:
    manifest.metric(m["name"])
out = harness.run_cell("pggan64.train_stage3_stab", 3, 0.1, False, time.perf_counter(),
                       device="cpu", overrides=tiny.overrides(), log=lambda s: None)
print(json.dumps({"banned": harness.banned_modules(), "program_before": clean,
                  "correct": out["correct"]}))
"""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"banned": [], "program_before": [], "correct": True}
