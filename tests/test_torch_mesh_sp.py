"""The sp axis of the port's mesh (speedy_tpu_torch/parallel/mesh.py) on
the CPU, fp64: latitude bands over ranks, the spectral state replicated
on a dp row's sp ranks, each Legendre analysis a band's partial sum plus
one all-reduce over the row's sp group. Ranks are torchrun processes over
Gloo with one thread each (tests/torch_mesh_worker.py); the sharded runs
are held against the port's unsharded Ensemble, and one step against the
JAX package's unsharded ``one_step`` (the JAX package's own sharded tests,
tests/test_state_mgmt.py:119-290, need boundary files the repo does not
hold). The presets' cases are in test_torch_mesh_sp_presets.py.

* The bands against the JAX package's ensemble_state_sharding on the
  conftest's 8 virtual CPU devices: for meshes (2, 4) and (2, 3) at T30
  and (2, 4) at T85, the latitude rows of each (dp, sp) shard of a grid
  leaf are the port's ``Mesh.rows`` and its members ``Mesh.members``.
  Spectral leaves are replicated on a dp row's sp ranks in the port; the
  JAX package splits them by total wavenumber n where nx divides sp (T30
  nx=32 over sp=4) and replicates them otherwise.
* In one process, no process group: the bands' grid_to_spec and vdspec
  partials sum to the full transform (<= 1e-14) and each band's
  synthesis is the full synthesis's rows (<= 1e-15), for sp = 2, 3, 4 at
  T30 and sp = 4 at T85.
* T30 dp=2 x sp=3, boot + one step (the JAX package's :149 case); T30
  dp=2 x sp=4, one day with SPPT on and a seed per member (its :199
  case): the gathered state within 1e-12 per field and member of an
  unsharded Ensemble's, the spectral leaves equal across each dp row's
  sp ranks, and a member pushed out of the guard's range on one sp rank
  raising on all 8 ranks, naming the same member and day.
* T30 dp=1 x sp=2 from the JAX package's booted state, one step,
  gathered, within 1e-12 per field of the JAX package's one_step.
* Ensemble.run_days with writers at dp=1 x sp=2: every member's files
  equal an unsharded run's to one float32 ulp (the files round fp64
  fields that agree to ~1e-13), and member_fields gathers the whole grid
  (<= 1e-12).
* make_mesh's refusals and latitude_band's warning.
"""
import os

import numpy as np
import pytest
import torch
import jax
from scipy.io import netcdf_file

from speedy_tpu.config import t30 as jt30
from speedy_tpu.models import coupling as jcoupling
from speedy_tpu.models.model import Model as JModel
from speedy_tpu.parallel import mesh as jmesh
from speedy_tpu.utils import calendar as jcal
from speedy_tpu_torch.config import from_preset, t30
from speedy_tpu_torch.geometry import build_geometry_np
from speedy_tpu_torch.models.model import Model, one_step
from speedy_tpu_torch.ops import spectral as sp
from speedy_tpu_torch.parallel.ensemble import Ensemble
from speedy_tpu_torch.parallel.mesh import (Mesh, latitude_band, make_mesh,
                                            member_range)
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils.output import NetCDFWriter
from speedy_tpu_torch.utils.synthetic_bc import (synthetic_boundaries,
                                                 write_boundary_files)

from torch_mesh_checks import (BOUND, START, assert_matches,
                               assert_spec_equal_across_sp, gathered,
                               rel_err, torchrun)

SMALL = dict(trunc=21, ix=64, il=32, kx=5)


@pytest.fixture(scope="module")
def bc():
    return synthetic_boundaries(0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The ranks run with one thread each; so do the in-process runs they
    are held against."""
    default = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(default)


@pytest.mark.parametrize("preset,dp,n_sp", [("t30", 2, 4), ("t30", 2, 3),
                                            ("t85", 2, 4)])
def test_bands_match_jax_sharding(preset, dp, n_sp):
    cfg = from_preset(preset)
    members = 4
    jm = jmesh.make_mesh(dp, n_sp, devices=jax.devices()[:dp * n_sp])
    leaves = {"grid": np.zeros((members, cfg.kx, cfg.il, cfg.ix)),
              "sfc": np.zeros((members, cfg.il, cfg.ix))}
    shardings = jmesh.ensemble_state_sharding(jm, leaves)
    for name, x in leaves.items():
        where = shardings[name].devices_indices_map(x.shape)
        for d in range(dp):
            for k in range(n_sp):
                mesh = Mesh(dp=dp, sp=n_sp, rank=d * n_sp + k,
                            device=torch.device("cpu"), backend=None)
                idx = where[jm.devices[d, k]]
                assert range(*idx[0].indices(members)) \
                    == member_range(members, dp, d) == mesh.members(members)
                assert range(*idx[-2].indices(cfg.il)) \
                    == range(cfg.il)[mesh.rows(cfg.il)], (name, d, k)


@pytest.mark.parametrize("preset,n_sp", [("t30", 2), ("t30", 3), ("t30", 4),
                                         ("t85", 4)])
def test_band_partials_sum_to_full(preset, n_sp):
    cfg = from_preset(preset, precision="fp64")
    sc = sp.build_spectral(cfg, build_geometry_np(cfg), "cpu")
    rng = np.random.default_rng(0)
    grid = torch.from_numpy(rng.normal(size=(3, cfg.il, cfg.ix)))
    vgrid = torch.from_numpy(rng.normal(size=(3, cfg.il, cfg.ix)))
    full = spec = sp.grid_to_spec(sc, grid)
    full_vd = sp.vdspec(sc, grid, vgrid, True)
    full_syn = sp.spec_to_grid(sc, spec)
    full_wind = sp.spec_to_grid(sc, spec, scale_by_inv_cos=True)
    part, part_vd = 0.0, (0.0, 0.0)
    for k in range(n_sp):
        rows = latitude_band(cfg.il, n_sp, k)
        band = sp.band_spectral(sc, rows, None, "cpu")
        part = part + sp.grid_to_spec(band, grid[:, rows])
        vor, div = sp.vdspec(band, grid[:, rows], vgrid[:, rows], True)
        part_vd = (part_vd[0] + vor, part_vd[1] + div)
        assert rel_err(sp.spec_to_grid(band, spec).numpy(),
                       full_syn[:, rows].numpy()) <= 1e-15
        assert rel_err(sp.spec_to_grid(band, spec, True).numpy(),
                       full_wind[:, rows].numpy()) <= 1e-15
    assert rel_err(part.numpy(), full.numpy()) <= 1e-14
    for p, f in zip(part_vd, full_vd):
        assert rel_err(p.numpy(), f.numpy()) <= 1e-14


def test_mesh_sp_refusals():
    with pytest.raises(ValueError, match="4 ranks"):
        make_mesh(2, 2, device="cpu")
    with pytest.raises(ValueError, match="mesh 1 x 0"):
        make_mesh(1, 0, device="cpu")
    with pytest.warns(UserWarning, match="does not divide il=32"):
        assert latitude_band(32, 3, 1) == slice(0, 32)
    assert latitude_band(48, 3, 2) == slice(32, 48)
    with pytest.raises(ValueError, match="sp rank 3 of 3"):
        latitude_band(48, 3, 3)


def test_one_step_dp2_sp3(bc, tmp_path):
    """Boot + one step over 6 ranks (nx=32 does not divide sp=3: the JAX
    package's tensor-parallel fallback, tests/test_state_mgmt.py:149)."""
    r = torchrun(6, "--grid", "t30", "--sp", "3", "--members", "2",
                 "--no-sppt", "--steps", "1", "--no-trip", cwd=tmp_path)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    model = Model(t30(precision="fp64"), device="cpu", bc_arrays=bc)
    ens = Ensemble(model, 2, base_seed=5)
    estate = ens.initialize(START)
    daily = model.daily_forcing(estate, START, START)
    estate, _ = one_step(model.cfg, model.pp, model.lsp, model.mc, estate,
                         daily, compute_sw=True)
    assert_matches(gathered(tmp_path), estate, 2)
    assert_spec_equal_across_sp(tmp_path, 2, 3)


def test_day_dp2_sp4_and_guard_trip(bc, tmp_path):
    """One SPPT day over 8 ranks (the JAX package's :199 case, with a
    seed per member), then a member pushed out of the guard's range on sp
    rank 1 of the second dp row only."""
    r = torchrun(8, "--grid", "t30", "--sp", "4", "--members", "2",
                 "--seed", "5", "--trip-rank", "5", cwd=tmp_path)
    assert r.returncode != 0
    said = [(tmp_path / f"rank{k}.txt").read_text() for k in range(8)]
    for text in said:
        assert text.startswith("Model variables out of accepted range at "
                               "day 0, member 1"), said
    model = Model(t30(precision="fp64", sppt_on=True), device="cpu",
                  bc_arrays=bc)
    ens = Ensemble(model, 2, base_seed=5)
    estate, _ = ens.run_days(ens.initialize(START), START, 1)
    assert_matches(gathered(tmp_path), estate, 2)
    assert_spec_equal_across_sp(tmp_path, 2, 4)


def test_step_matches_jax_one_step(bc, tmp_path):
    """The sharded step against the JAX package's unsharded one_step on
    the JAX package's booted state (the JAX model built from HDF5 copies
    of the stand-in set, as tests/torch_parity.py builds it)."""
    write_boundary_files(str(tmp_path), bc)
    jm = JModel(jt30(precision="fp64"), bc_search=[str(tmp_path)])
    jstart = jcal.Datetime(1982, 1, 1)
    jboot = jm.initialize(jstart)
    np.savez(tmp_path / "boot.npz", **{
        f"{g}.{f}": np.asarray(v) for g in ("prog", "surf", "rad")
        for f, v in getattr(jboot, g)._asdict().items()})
    im, tmo, ty = jcal.season_vars(jstart, jm.cfg.iseasc, 1)
    imn, tmn, _ = jcal.season_vars(jcal.next_day(jstart), jm.cfg.iseasc, 1)
    ds = jcoupling.make_date_scalars(jm.cfg, jm.geom_np, im, tmo, ty,
                                     year=1982, imont1_next=imn,
                                     tmonth_next=tmn)
    daily = jcoupling.daily_update(jm.cfg, jm.pp, jm.lsp, jm.mc.dyn.sc,
                                   jm.mc.clim, ds, jboot.surf)
    ref, _ = jax.jit(jm.raw_fns["one_step"], static_argnums=(3,))(
        jm.mc, jboot, daily, True)
    r = torchrun(2, "--grid", "t30", "--sp", "2", "--members", "1",
                 "--no-sppt", "--state", str(tmp_path / "boot.npz"),
                 "--steps", "1", "--no-trip", cwd=tmp_path)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    got = gathered(tmp_path)
    errs = {f"{g}.{f}": rel_err(got[f"{g}.{f}"][0], np.asarray(v))
            for g in ("prog", "surf", "rad")
            for f, v in getattr(ref, g)._asdict().items()}
    assert not {k: e for k, e in errs.items() if not e <= BOUND}, errs
    assert_spec_equal_across_sp(tmp_path, 1, 2)


def test_writers_sp2_match_unsharded(bc, tmp_path):
    """run_days with a NetCDF writer per member over dp=1 x sp=2 (T21
    kx=5, SPPT on, 2 members): the bands gathered once a day, written by
    sp rank 0; every file equal to an unsharded run's to one float32 ulp;
    member_fields gathers member 0's whole grid."""
    r = torchrun(2, "--sp", "2", "--members", "2", "--writers", "--no-trip",
                 cwd=tmp_path)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    model = Model(t30(precision="fp64", sppt_on=True, **SMALL), device="cpu",
                  bc_arrays=bc)
    ens = Ensemble(model, 2, base_seed=5)
    ref = tmp_path / "ref"
    writers = [NetCDFWriter(model.cfg, str(ref / f"member{m:03d}"))
               for m in range(2)]
    estate, _ = ens.run_days(ens.initialize(START), START, 1,
                             output_writers=writers)
    for m in range(2):
        names = sorted(os.listdir(tmp_path / "ref" / f"member{m:03d}"))
        assert names == sorted(os.listdir(tmp_path / f"member{m:03d}"))
        assert len(names) == model.cfg.nsteps + 1
        for name in names:
            with netcdf_file(str(tmp_path / "ref" / f"member{m:03d}" / name),
                             mmap=False) as a, \
                    netcdf_file(str(tmp_path / f"member{m:03d}" / name),
                                mmap=False) as b:
                # float32 roundings of fp64 fields that agree to ~1e-13:
                # where a value sits at a rounding boundary, the bands'
                # sum order may round it one ulp the other way
                for k, v in a.variables.items():
                    np.testing.assert_array_max_ulp(b.variables[k][:], v[:],
                                                    maxulp=1)
    fields = np.load(tmp_path / "fields0.npz")
    for k, v in ens.member_fields(estate, 0).items():
        assert fields[k].shape == tuple(v.shape)
        assert rel_err(fields[k], v.numpy()) <= BOUND, k
