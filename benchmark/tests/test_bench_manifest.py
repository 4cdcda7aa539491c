"""``BENCHMARK.json`` against the benchmark's contract, and every name in it
resolved to its file; a new cell taken by adding files alone."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import check, manifest

ROOT = manifest.ROOT
BENCH = manifest.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert os.path.getsize(ROOT / "BENCHMARK.json") <= 64 * 1024
    n = len(BENCH["workloads"])
    # a full check: 2 + 14 runs a cell, each run_seconds + 60, 180 s a cell, 1200 spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert n <= 24


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_resolves(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["source"]) and _line(entry["why"])
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    cfg = manifest.config(entry["name"])
    assert cfg["name"] == entry["name"]
    assert hasattr(manifest.reference(entry["name"]), "run")
    assert hasattr(manifest.work(entry["name"]), "step_work")
    assert entry["reduced"] == [] or all(NAME.match(k) for k in entry["reduced"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_resolves(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["name"] == f"{entry['config']}.{entry['traffic']}"
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"]) and _line(entry["why"])
    assert entry["chips"] == 1
    wl = manifest.workload(entry["name"])
    assert wl["config"] == entry["config"]
    assert {e["name"] for e in BENCH["configs"]} >= {wl["config"]}
    assert hasattr(manifest.driver(wl["driver"]), "build")
    ref = manifest.reference(wl["config"])
    groups = ref.groups(ref.param_specs(manifest.config(wl["config"])["model"], wl["traffic"]))
    assert wl["limits"] and set(wl["limits"]) <= set(check.names(groups))


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_resolves(entry):
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher") and entry["source"] in SOURCES
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(entry.get("workloads", cells)) <= cells
    if entry in BENCH["per_layer"]:
        assert set(entry) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(entry["layer"])
        assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert callable(manifest.metric(entry["name"]).read)
    else:
        assert set(entry) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25


def test_setup_and_one_more_metric_every_cell():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    for w in BENCH["workloads"]:
        assert len(manifest.cell_metrics(BENCH, w["name"], "end_to_end")) >= 2
        assert manifest.cell_metrics(BENCH, w["name"], "per_layer")


def test_a_new_cell_is_taken_by_adding_files(tmp_path):
    """A copy of the benchmark with one more cell (a workload file and its
    entry, no other file touched) runs that cell, at tiny sizes on the CPU."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = json.loads((ROOT / "benchmark/workloads/pggan64.train_stage3_stab.json").read_text())
    wl["traffic"]["stage"] = 1
    (tmp_path / "benchmark/workloads/pggan64.train_stage1_stab.json").write_text(json.dumps(wl))
    bench["workloads"].append({"name": "pggan64.train_stage1_stab", "config": "pggan64",
                               "traffic": "train_stage1_stab", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, time, json; from benchmark import harness, manifest; "
            "from benchmark.tests import tiny; "
            "assert manifest.ROOT == __import__('pathlib').Path.cwd(); "
            "out = harness.run_cell('pggan64.train_stage1_stab', 5, 0.1, False, "
            "time.perf_counter(), device='cpu', overrides=tiny.overrides(), log=lambda s: None); "
            "print(json.dumps(out))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["attempted"] >= 1
    assert set(out["metrics"]) == {"setup_s", "train_imgs_per_s"}
