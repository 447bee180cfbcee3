"""The cell over several cards (drivers/ensemble_dp.py) on the CPU: in a
temporary copy of the benchmark, the dp cell's traffic at a small size
(T21L5, 4 members, 1-day calls) over 2 Gloo ranks, the harness's process
rank 0 and one further process, the harness's look for a card skipped.

A clean run is correct with every member of both ranks compared and no
module of JAX or the JAX package loaded. A rank killed during the window
ends the run with a failed call, in well under two minutes, and no
process is left. Each fault that the cell can have comes out not correct:
rank 1's steps returning their state unchanged, or with an answer
altered; half of each rank's members the mean of the others'; the
exchange between the ranks (the guard's all-reduce) left out, which the
check's trip of the guard sees."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest

from benchmark import harness
from benchmark.tests.test_bench_cells import (add_cell, copy_benchmark,
                                              tiny_config)

CELL = "t21l5.dp2"
SCRIPT = r"""
import json, sys
from benchmark import harness
from benchmark.tests import dp_faulty_rank as faulty
root, name, fault = sys.argv[1:4]
made = []
make = harness.make_driver


def make_driver(run):
    d = make(run)
    d.worker = [sys.executable, "-m", "benchmark.tests.dp_faulty_rank",
                fault]
    made.append(d)
    return d


harness.make_driver = make_driver
faulty.apply(fault, 0)
cell = harness.Cell(name, root=root)
res = harness.drive(cell, 2**31 + 11, 0.01, False, "cpu", log=print)
res["loaded"] = harness.forbidden_modules()
res["pids"] = [p.pid for p in made[0].procs]
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = copy_benchmark(tmp_path_factory.mktemp("dp"))
    with open(os.path.join(harness.HERE, "workloads",
                           "t30l8.ens64.dp4.json")) as f:
        params = json.load(f)
    params.update(chunk_days=1, members=4)
    add_cell(root, CELL, tiny_config(), params)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        m = json.load(f)
    m["workloads"][-1]["chips"] = 2
    with open(path, "w") as f:
        json.dump(m, f)
    return root


def run_cell(root: str, fault: str):
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, root, CELL, fault],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    return res, out.stderr, time.perf_counter() - t0


def alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_clean_run_over_two_ranks(root):
    res, err, _ = run_cell(root, "none")
    assert res.pop("loaded") == []
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["device"]["count"] == 2
    assert len(res["pids"]) == 1 and not any(map(alive, res["pids"]))
    assert "trip 0.0 limit 0" in err
    # rank 1 holds members 2 and 3: the trip's planted member
    assert "member 2" in err


def test_killed_rank_fails_the_call(root):
    res, err, seconds = run_cell(root, "killed")
    assert res["failed"] >= 1 and not res["correct"]
    assert seconds < 120
    assert not any(map(alive, res["pids"]))
    assert "rank 1" in err


@pytest.mark.parametrize("fault", ["unchanged", "altered", "half",
                                   "exchange"])
def test_fault_is_not_correct(root, fault):
    res, err, _ = run_cell(root, fault)
    assert not res["correct"], res["checks"]
    if fault == "exchange":
        assert "trip 0.5 limit 0" in err and res["failed"] == 1
