"""The dp axis of the port's mesh (speedy_tpu_torch/parallel/mesh.py) and
the sharded Ensemble, on the CPU: ranks are processes started by torchrun
(python -m torch.distributed.run) over Gloo.

* The members a dp rank holds equal the block that the JAX package's
  ensemble_state_sharding(make_mesh(dp, 1), ...) places on the dp shard,
  for 8 members over dp = 1, 2, 4 (read through devices_indices_map on
  the conftest's 8 virtual CPU devices).
* ``ensemble`` over two ranks (T30, fp64, 4 members, one day): every
  member's final file (float32) equal to the writer's rounding of an
  unsharded in-process Ensemble of the rank's two members and seeds. The
  unsharded Ensemble is held against the JAX Ensemble by
  tests/test_torch_ensemble.py.
* tests/torch_mesh_worker.py over two ranks (T21 kx=5, fp64, 4 members):
  the gathered state after a day within 1e-12 per field and member of an
  unsharded Ensemble's; a member pushed out of the guard's range on rank
  1 makes both ranks raise, naming the same global member and day, and
  exit non-zero within the subprocess timeout.
* ``ensemble`` over two ranks with 3 members raises.
* In one process: the mesh's refusals, the guard's (day, member) coding
  and member_fields on a rank that does not hold the member.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from speedy_tpu.parallel import mesh as jmesh
from speedy_tpu_torch.config import t30
from speedy_tpu_torch.models.model import Model
from speedy_tpu_torch.parallel.ensemble import Ensemble
from speedy_tpu_torch.parallel.mesh import Mesh, make_mesh, member_range
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils import diagnostics
from speedy_tpu_torch.utils.diagnostics import InstabilityError, bad_days
from speedy_tpu_torch.utils.synthetic_bc import synthetic_boundaries

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = 1e-12
START = cal.Datetime(1982, 1, 1)
SMALL = dict(precision="fp64", trunc=21, ix=64, il=32, kx=5, sppt_on=True)
TIMEOUT = 300


def torchrun(args, cwd):
    """``python -m torch.distributed.run --standalone --nproc-per-node 2
    args`` in ``cwd``, with this checkout on the path."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=TIMEOUT)


def rel_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def bc():
    return synthetic_boundaries(0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The ranks run with one thread each (OMP_NUM_THREADS=1); so do the
    in-process runs they are held against."""
    default = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(default)


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_member_blocks_match_jax_sharding(dp):
    members = 8
    jm = jmesh.make_mesh(dp, 1, devices=jax.devices()[:dp])
    leaves = {"spec": np.zeros((members, 2, 5, 22, 23, 2)),
              "grid": np.zeros((members, 5, 32, 64)),
              "scalar": np.zeros((members,))}
    shardings = jmesh.ensemble_state_sharding(jm, leaves)
    for name, x in leaves.items():
        where = shardings[name].devices_indices_map(x.shape)
        for r in range(dp):
            sl = where[jm.devices[r, 0]][0]
            assert range(*sl.indices(members)) == member_range(members, dp,
                                                               r), name


def test_mesh_refusals():
    # an sp axis is ported (tests/test_torch_mesh_sp.py): without a
    # process group it needs the ranks as any mesh does
    with pytest.raises(ValueError, match="1 x 2 needs 2 ranks"):
        make_mesh(1, 2, device="cpu")
    with pytest.raises(ValueError, match="2 ranks"):
        make_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="do not divide"):
        member_range(3, 2, 0)
    mesh = make_mesh(1, 1, device="cpu")
    assert (mesh.dp, mesh.sp) == (1, 1) and mesh.members(4) == range(4)
    assert mesh.backend is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(1, 1)


def test_guard_codes_first_day_and_global_member(bc, monkeypatch):
    rows = np.zeros((3, 4, 2, 5))
    rows[:, 2:] = 250.0                    # tmean in range
    assert not bad_days(rows).any()
    rows[2, 0, 0, 3] = 600.0               # reke, day 2, local member 0
    rows[1, 3, 1, 0] = 400.0               # tmean max, day 1, local member 1
    rows[2, 1, 1, 0] = np.nan
    assert bad_days(rows).tolist() == [[False, False], [False, True],
                                       [True, True]]
    model = Model(t30(**SMALL), device="cpu", bc_arrays=bc)
    mesh = Mesh(dp=2, sp=1, rank=1, device=torch.device("cpu"),
                backend=None)
    ens = Ensemble(model, 4, mesh=mesh)
    assert ens.members == range(2, 4) and ens.n_local == 2
    with pytest.raises(InstabilityError, match="day 11, member 3"):
        ens.guard(rows, 10)
    # the unsharded ensemble takes the same guard, with the ranges read
    # from diagnostics when it runs
    whole = Ensemble(model, 2)
    with pytest.raises(InstabilityError, match="day 11, member 1: reke="):
        whole.guard(rows, 10)
    rows[1, 3, 1, 0] = 250.0
    monkeypatch.setattr(diagnostics, "EKE_MAX", 700.0)
    with pytest.raises(InstabilityError, match="day 12, member 1"):
        whole.guard(rows, 10)
    rows[2, 1, 1, 0] = 0.0
    whole.guard(rows, 10)
    estate = ens.initialize(START)
    assert estate.prog.vor.shape[0] == 2
    assert ens.member_fields(estate, 3)["u"].shape == (5, 32, 64)
    with pytest.raises(ValueError, match="holds 2..3"):
        ens.member_fields(estate, 1)
    with pytest.raises(ValueError, match="mesh device"):
        Ensemble(model, 4, mesh=dataclasses.replace(
            mesh, device=torch.device("meta")))


def test_cli_two_ranks_match_unsharded(bc, tmp_path):
    """The files are float32, so they are held bit for bit against
    unsharded 2-member Ensembles with the ranks' seeds (the ranks' own
    batch); test_worker_gather_and_guard_trip holds a gathered fp64 state
    against the whole unsharded ensemble."""
    r = torchrun(["-m", "speedy_tpu_torch", "ensemble", "--device", "cpu",
                  "--precision", "fp64", "--members", "4", "--days", "1",
                  "--synthetic-bc", "0", "--output-dir", "out"],
                 str(tmp_path))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "4 members, 1 days, T30, 2-process dp mesh" in r.stdout
    model = Model(t30(precision="fp64", sppt_on=True), device="cpu",
                  bc_arrays=bc)

    def fields(n, seed):
        ens = Ensemble(model, n, base_seed=seed)
        estate, _ = ens.run_days(ens.initialize(START), START, 1)
        return [{k: v.numpy() for k, v in ens.member_fields(estate, m).items()}
                for m in range(n)]

    blocks = fields(2, 0) + fields(2, 2)
    for m in range(4):
        path = tmp_path / "out" / f"member{m:03d}" / "198201020000.nc"
        with netcdf_file(str(path), mmap=False) as f:
            for k, v in blocks[m].items():
                np.testing.assert_array_equal(
                    f.variables[k][0], v.astype(np.float32), err_msg=k)


def test_worker_gather_and_guard_trip(bc, tmp_path):
    r = torchrun([os.path.join(REPO, "tests", "torch_mesh_worker.py"),
                  str(tmp_path)], str(tmp_path))
    assert r.returncode != 0
    said = [(tmp_path / f"rank{k}.txt").read_text() for k in (0, 1)]
    # the rank that holds the member adds its extrema
    for text in said:
        assert text.startswith("Model variables out of accepted range at "
                               "day 0, member 2"), said
    assert said[0] == said[1].split(":")[0]
    got = np.load(tmp_path / "gathered.npz")
    model = Model(t30(**SMALL), device="cpu", bc_arrays=bc)
    ens = Ensemble(model, 4, base_seed=5)
    estate, _ = ens.run_days(ens.initialize(START), START, 1)
    for group in ("prog", "surf", "rad"):
        for f, v in getattr(estate, group)._asdict().items():
            g = got[f"{group}.{f}"]
            assert g.shape == tuple(v.shape), (group, f)
            for m in range(4):
                assert rel_err(g[m], v[m].numpy()) <= BOUND, (group, f, m)
    assert rel_err(got["sppt.spec"], estate.sppt.spec.numpy()) <= BOUND


def test_cli_refuses_members_that_do_not_divide(tmp_path):
    r = torchrun(["-m", "speedy_tpu_torch", "ensemble", "--device", "cpu",
                  "--members", "3", "--days", "1", "--synthetic-bc", "0"],
                 str(tmp_path))
    assert r.returncode != 0
    assert "3 members do not divide over 2 processes" in r.stderr
