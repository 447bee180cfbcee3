"""The sp axis of the port's mesh at T85 and T170 on the CPU, fp64 (the
T30 cases and the rest: tests/test_torch_mesh_sp.py, whose docstring
says how). Ranks are torchrun processes over Gloo with one thread each
(tests/torch_mesh_worker.py); each sharded run is held against the
port's unsharded Ensemble in this process, per field and member, in the
JAX package's cases (tests/test_state_mgmt.py):

* T85 dp=1 x sp=4, boot + one step, within 1e-12 (its :158 case, there
  over dp=2);
* ``python -m speedy_tpu_torch.bench_scaling`` on the CPU (dp, 2
  members, counts 1 and 3): one JSON line per count, count 3 skipped
  because 2 members do not divide over 3 ranks;
* marked slow, as the JAX package marks them: the T85 day over dp=2 x
  sp=4 (:167, within 1e-11), the T170 step over dp=2 x sp=4 (:236,
  within 1e-12) and the T170 SW triple, three steps, the shortwave on the
  first (:246, within 1e-11).
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from speedy_tpu_torch.config import from_preset
from speedy_tpu_torch.models.model import Model, one_step
from speedy_tpu_torch.parallel.ensemble import Ensemble
from speedy_tpu_torch.utils.synthetic_bc import synthetic_boundaries

from torch_mesh_checks import (REPO, START, assert_matches,
                               assert_spec_equal_across_sp, gathered,
                               torchrun)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    default = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(default)


def unsharded_steps(preset, members, n):
    """The unsharded Ensemble's boot and n steps of the first day (SPPT
    off, base seed 5), as the worker's ``--steps`` runs them."""
    model = Model(from_preset(preset, precision="fp64"), device="cpu",
                  bc_arrays=synthetic_boundaries(0))
    ens = Ensemble(model, members, base_seed=5)
    estate = ens.initialize(START)
    daily = model.daily_forcing(estate, START, START)
    for i in range(n):
        estate, _ = one_step(model.cfg, model.pp, model.lsp, model.mc,
                             estate, daily,
                             compute_sw=(i % model.cfg.nstrad == 0))
    return estate


def sharded_steps(tmp_path, preset, dp, n_sp, n, bound, timeout=300):
    r = torchrun(dp * n_sp, "--grid", preset, "--sp", str(n_sp),
                 "--members", str(dp), "--no-sppt", "--steps", str(n),
                 "--no-trip", cwd=tmp_path, timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert_matches(gathered(tmp_path), unsharded_steps(preset, dp, n), dp,
                   bound)
    assert_spec_equal_across_sp(tmp_path, dp, n_sp)


def test_t85_step_sp4(tmp_path):
    sharded_steps(tmp_path, "t85", 1, 4, 1, 1e-12)


def test_bench_scaling_prints_a_line_per_count(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "speedy_tpu_torch.bench_scaling", "--device",
         "cpu", "--mode", "dp", "--members", "2", "--counts", "1,3",
         "--reps", "1"], cwd=tmp_path, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    lines = [json.loads(x) for x in r.stdout.splitlines()
             if x.startswith("{")]
    assert len(lines) == 2, r.stdout
    one, three = lines
    assert one["metric"] == "scaling_dp_t30" and one["ranks"] == 1
    assert one["efficiency_vs_first"] == 1.0
    assert one["grid_point_steps_per_s"] > 0 and one["backend"] == "gloo"
    assert one["captured"] is False and one["rows_per_rank"] == 48
    assert three == {"metric": "scaling_dp_t30", "skipped_ranks": 3,
                     "reason": "members 2 % dp 3 != 0"}


@pytest.mark.slow
def test_t85_day_dp2_sp4(tmp_path):
    r = torchrun(8, "--grid", "t85", "--sp", "4", "--members", "2",
                 "--no-sppt", "--no-trip", cwd=tmp_path, timeout=1800)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    model = Model(from_preset("t85", precision="fp64"), device="cpu",
                  bc_arrays=synthetic_boundaries(0))
    ens = Ensemble(model, 2, base_seed=5)
    estate, _ = ens.run_days(ens.initialize(START), START, 1)
    assert_matches(gathered(tmp_path), estate, 2, 1e-11)
    assert_spec_equal_across_sp(tmp_path, 2, 4)


@pytest.mark.slow
def test_t170_step_dp2_sp4(tmp_path):
    sharded_steps(tmp_path, "t170", 2, 4, 1, 1e-12, timeout=1800)


@pytest.mark.slow
def test_t170_sw_triple_dp2_sp4(tmp_path):
    sharded_steps(tmp_path, "t170", 2, 4, 3, 1e-11, timeout=1800)
