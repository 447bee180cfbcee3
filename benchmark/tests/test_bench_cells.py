"""A cell added by files alone is found and run by the harness: in a
temporary copy of the benchmark, a new configuration file, a new traffic
file and their entries in BENCHMARK.json, nothing else, run end to end on
the CPU at a small size (the harness's look for a card skipped), with no
module of JAX or the JAX package loaded."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

SCRIPT = r"""
import json, sys
from benchmark import harness
cell = harness.Cell(sys.argv[2], root=sys.argv[1])
res = harness.drive(cell, 2**31 + 11, 0.01, False, "cpu",
                    log=lambda *a, **k: None)
res["loaded"] = harness.forbidden_modules()
print(json.dumps(res))
"""


def copy_benchmark(tmp_path) -> str:
    root = str(tmp_path)
    shutil.copy(harness.MANIFEST, root)
    dst = os.path.join(root, "benchmark")
    shutil.copytree(harness.HERE, dst, ignore=shutil.ignore_patterns(
        "tests", "reference", "__pycache__"))
    return root


def add_cell(root: str, name: str, config: dict, params: dict) -> None:
    """A configuration and a cell, as a later change adds them: files and
    entries only."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        m = json.load(f)
    cfile = f"benchmark/configs/{config['name']}.json"
    with open(os.path.join(root, cfile), "w") as f:
        json.dump(config, f)
    with open(os.path.join(root, "benchmark", "workloads", name + ".json"),
              "w") as f:
        json.dump(params, f)
    m["configs"].append({"name": config["name"], "source": "test",
                         "file": cfile, "reduced": [], "why": "test"})
    m["workloads"].append({"name": name, "config": config["name"],
                           "traffic": name.split(".")[1], "chips": 1,
                           "why": "test"})
    m["end_to_end"][0]["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)


def tiny_config():
    with open(os.path.join(harness.HERE, "configs", "t30l8.json")) as f:
        c = json.load(f)
    c["name"] = "t21l5"
    c["model"].update(trunc=21, ix=64, il=32, kx=5)
    return c


def run_cell(root: str, name: str) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, root, name], cwd=harness.ROOT,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_added_cell_is_found_and_runs(tmp_path):
    root = copy_benchmark(tmp_path)
    with open(os.path.join(harness.HERE, "workloads",
                           "t30l8.single.json")) as f:
        params = json.load(f)
    params["chunk_days"] = 1
    add_cell(root, "t21l5.short", tiny_config(), params)
    cell = harness.Cell("t21l5.short", root=root)
    assert cell.model_config["trunc"] == 21
    assert [m["name"] for m in cell.end_to_end] == ["sim_days_per_min",
                                                    "setup_s"]
    res = run_cell(root, "t21l5.short")
    assert res.pop("loaded") == []
    assert set(res["metrics"]) == {"sim_days_per_min", "setup_s"}
    assert res["attempted"] == 2 and res["failed"] == 0
    assert set(res["checks"]) == set(params["check"])
    assert list(res)[-1] == "checks"
