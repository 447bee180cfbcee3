"""The port's ensembles against the JAX package, fp64 on the CPU (the
column physics with a member axis: tests/test_torch_ensemble_physics.py).

* ``parallel.Ensemble`` against ``speedy_tpu.parallel.ensemble.Ensemble``,
  T30, SPPT on, 3 members, base seed 7, the port fed each member's JAX key
  chain (member i's innovations are jax_noise(PRNGKey(7 + i)), then its
  state key's chain, as tests/test_torch_sppt.py feeds one model): after
  initialize, after 6 steps and after one day, every field and the SPPT
  spectral state <= 1e-10 per member.
* Invariances of the port: with SPPT off every member equals the single
  model (<= 1e-12); with SPPT on the members differ; members 0 and 1 of a
  2- and a 4-member ensemble with one base seed are equal.
* Per-member output: run_days with two NetCDF writers writes nsteps + 1
  files per memberNNN/ directory, each holding member_fields of its member
  at its step.
* convert carries the JAX ensemble state over and back exactly;
  check_supported accepts n_ensemble > 1.
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from scipy.io import netcdf_file

from speedy_tpu.config import t30 as jt30
from speedy_tpu.models import coupling as jcoupling
from speedy_tpu.models.model import Model as JModel
from speedy_tpu.parallel.ensemble import Ensemble as JEnsemble
from speedy_tpu.utils import calendar as jcal
from speedy_tpu_torch import convert
from speedy_tpu_torch.config import check_supported, t30
from speedy_tpu_torch.models.model import Model, one_step
from speedy_tpu_torch.parallel.ensemble import Ensemble
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils.output import NetCDFWriter
from speedy_tpu_torch.utils.synthetic_bc import (synthetic_boundaries,
                                                 write_boundary_files)

PHYSICS_BOUND = 1e-12
MODEL_BOUND = 1e-10
SMALL = dict(precision="fp64", trunc=21, ix=64, il=32, kx=5)
START = (1982, 1, 1)
M = 3


def rel_err(port, ref):
    port = port.cpu().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def jax_noise(key):
    """Innovations as the JAX key chain from ``key`` draws them: split,
    then a standard normal from the sub-key, per update."""
    chain = {"key": key}

    def noise(shape):
        chain["key"], sub = jax.random.split(chain["key"])
        return np.asarray(jax.random.normal(sub, shape, jnp.float64))
    return noise


@pytest.fixture(scope="module")
def bc():
    return synthetic_boundaries(0)


@pytest.fixture(scope="module")
def bc_dir(bc, tmp_path_factory):
    d = tmp_path_factory.mktemp("bc")
    write_boundary_files(str(d), bc)
    return str(d)


@pytest.fixture(scope="module")
def jmodel(bc_dir):
    """The JAX T30 model with SPPT on (its own SPPT seed 3)."""
    return JModel(jt30(precision="fp64", sppt_on=True), bc_search=[bc_dir],
                  sppt_seed=3)


# ---------------------------------------------------------------------------
# the ensemble against the JAX Ensemble
# ---------------------------------------------------------------------------

def member_errors(jstate, tstate):
    """Per field and member: max |port - jax| / max |jax| of the member."""
    pairs = {f"{g}.{f}": (getattr(getattr(tstate, g), f),
                          getattr(getattr(jstate, g), f))
             for g in ("prog", "surf", "rad")
             for f in getattr(tstate, g)._fields}
    pairs["sppt.spec"] = (tstate.sppt.spec, jstate.sppt.spec)
    return {(k, m): rel_err(t[m], np.asarray(j)[m])
            for k, (t, j) in pairs.items() for m in range(M)}


@pytest.fixture(scope="module")
def ensembles(bc, jmodel):
    """Both packages' 3-member SPPT ensembles (base seed 7, the models'
    own SPPT seed 3): initialize, 6 steps, one day."""
    jm, jcfg = jmodel, jmodel.cfg
    tm = Model(t30(precision="fp64", sppt_on=True), device="cpu",
               bc_arrays=bc, sppt_noise=jax_noise(jax.random.PRNGKey(3)))
    jens = JEnsemble(jm, M, base_seed=7)
    tens = Ensemble(tm, M, base_seed=7, noise=[
        jax_noise(jax.random.PRNGKey(7 + i)) for i in range(M)])
    jstart, start = jcal.Datetime(*START), cal.Datetime(*START)
    jinit, tinit = jens.initialize(jstart), tens.initialize(start)

    im, tmo, ty = jcal.season_vars(jstart, 1, 1)
    ds = jcoupling.make_date_scalars(jcfg, jm.geom_np, im, tmo, ty,
                                     year=jstart.year)
    jdaily = jax.vmap(lambda surf: jcoupling.daily_update(
        jcfg, jm.pp, jm.lsp, jm.mc.dyn.sc, jm.mc.clim, ds, surf))(jinit.surf)
    steps = {sw: jax.jit(jax.vmap(functools.partial(
        lambda sw, s, d: jm.raw_fns["one_step"](jm.mc, s, d, sw)[0], sw)))
        for sw in (True, False)}
    js, ts = jinit, tinit
    tdaily = tm.daily_forcing(ts, start, start)
    for i in range(6):
        sw = i % jcfg.nstrad == 0
        js = steps[sw](js, jdaily)
        ts, _ = one_step(tm.cfg, tm.pp, tm.lsp, tm.mc, ts, tdaily, sw,
                         noise=tens.noise)

    jday, jend = jens.run_days(jinit, jstart, 1)
    tens.noise = [jax_noise(k) for k in jinit.sppt.key]
    tday, tend = tens.run_days(tinit, start, 1)
    assert (tend.year, tend.month, tend.day) == (jend.year, jend.month,
                                                 jend.day)
    return dict(initialize=(jinit, tinit), steps=(js, ts), day=(jday, tday))


@pytest.mark.parametrize("stage", ["initialize", "steps", "day"])
def test_ensemble_matches_jax(ensembles, stage):
    jstate, tstate = ensembles[stage]
    assert tstate.prog.vor.shape[0] == M
    errs = member_errors(jstate, tstate)
    bad = {k: v for k, v in errs.items() if not v <= MODEL_BOUND}
    assert not bad, bad


def test_convert_round_trip(ensembles):
    """The JAX ensemble state carries over to the port and back exactly,
    each member's SPPT state with its own generator."""
    jstate = jax.tree.map(np.asarray, ensembles["steps"][0])
    tstate = convert.model_state_from_numpy(jstate, "cpu", torch.float64)
    assert isinstance(tstate.sppt.generator, tuple)
    assert len(tstate.sppt.generator) == M
    back = convert.model_state_to_numpy(tstate)
    for g in ("prog", "surf", "rad"):
        for f, a in back[g].items():
            np.testing.assert_array_equal(a, getattr(getattr(jstate, g), f))
    np.testing.assert_array_equal(back["sppt"]["spec"], jstate.sppt.spec)


# ---------------------------------------------------------------------------
# invariances and output (port only)
# ---------------------------------------------------------------------------

def _steps(model, state, n, noise=None):
    start = cal.Datetime(*START)
    daily = model.daily_forcing(state, start, start)
    for i in range(n):
        state, _ = one_step(model.cfg, model.pp, model.lsp, model.mc, state,
                            daily, i % model.cfg.nstrad == 0, noise=noise)
    return state


def test_members_equal_the_single_model_without_sppt(bc):
    m = Model(t30(**SMALL), device="cpu", bc_arrays=bc)
    start = cal.Datetime(*START)
    single = _steps(m, m.initialize(start), 6)
    ens = _steps(m, Ensemble(m, 2).initialize(start), 6)
    for g in ("prog", "surf", "rad"):
        for f in getattr(single, g)._fields:
            a = getattr(getattr(single, g), f)
            b = getattr(getattr(ens, g), f)
            assert b.shape == (2,) + a.shape, (g, f)
            for k in range(2):
                assert rel_err(b[k], a.numpy()) <= PHYSICS_BOUND, (g, f, k)


def test_members_share_seeds_whatever_the_count(bc):
    """Member i's draws depend on base_seed + i alone: members 0 and 1 of
    a 2- and a 4-member ensemble are equal, and they differ from each
    other."""
    m = Model(t30(sppt_on=True, **SMALL), device="cpu", bc_arrays=bc)
    start = cal.Datetime(*START)
    two, four = (_steps(m, Ensemble(m, n, base_seed=5).initialize(start), 3)
                 for n in (2, 4))
    for f in two.prog._fields:
        a, b = getattr(two.prog, f), getattr(four.prog, f)
        assert torch.equal(a, b[:2]), f
    assert torch.equal(two.sppt.spec, four.sppt.spec[:2])
    assert not torch.equal(two.prog.vor[0], two.prog.vor[1])


def test_single_member_state_has_the_axis(bc):
    m = Model(t30(sppt_on=True, **SMALL), device="cpu", bc_arrays=bc)
    state = Ensemble(m, 1).initialize(cal.Datetime(*START))
    for g in ("prog", "surf", "rad"):
        for x in getattr(state, g):
            assert x.shape[0] == 1
    assert state.sppt.spec.shape[0] == 1 and len(state.sppt.generator) == 1


@pytest.fixture(scope="module")
def output_run(bc, tmp_path_factory):
    """A 2-member SPPT ensemble's day at T21 kx=5 with a NetCDF writer per
    member, and the states of the same day stepped one by one."""
    cfg = t30(sppt_on=True, **SMALL)
    m = Model(cfg, device="cpu", bc_arrays=bc)
    ens = Ensemble(m, 2, base_seed=3)
    start = cal.Datetime(*START)
    init = ens.initialize(start)
    out = tmp_path_factory.mktemp("ens")
    writers = [NetCDFWriter(cfg, str(out / f"member{i:03d}"))
               for i in range(2)]
    end_state, end = ens.run_days(init, start, 1, output_writers=writers)
    # the same day step by step (the members' generators are values, so
    # stepping a state again draws the same innovations)
    states, s = [init], init
    daily = m.daily_forcing(init, start, start)
    for i in range(cfg.nsteps):
        s, _ = one_step(cfg, m.pp, m.lsp, m.mc, s, daily,
                        i % cfg.nstrad == 0,
                        couple_next=(i == cfg.nsteps - 1))
        states.append(s)
    return dict(cfg=cfg, ens=ens, out=out, end=end, end_state=end_state,
                states=states)


def test_run_days_writes_every_member(output_run):
    cfg, out = output_run["cfg"], output_run["out"]
    assert output_run["end"] == cal.Datetime(1982, 1, 2)
    for i in range(2):
        files = sorted((out / f"member{i:03d}").glob("*.nc"))
        assert len(files) == cfg.nsteps + 1, (i, len(files))
        assert files[0].name == "198201010000.nc"
        assert files[-1].name == "198201020000.nc"
    for f in output_run["end_state"].prog._fields:
        assert torch.equal(getattr(output_run["end_state"].prog, f),
                           getattr(output_run["states"][-1].prog, f)), f


def test_members_differ_with_sppt(output_run):
    out = output_run["out"]
    with netcdf_file(str(out / "member000" / "198201020000.nc"),
                     mmap=False) as a, \
            netcdf_file(str(out / "member001" / "198201020000.nc"),
                        mmap=False) as b:
        assert np.abs(a.variables["t"][:] - b.variables["t"][:]).max() > 0.0
    vor = output_run["end_state"].prog.vor
    assert (vor[0] - vor[1]).abs().max() > 1e-8
    assert bool(torch.isfinite(vor).all())


@pytest.mark.parametrize("member", [0, 1])
def test_files_hold_member_fields(output_run, member):
    """Each file holds member_fields of its member at its step."""
    ens, out = output_run["ens"], output_run["out"]
    files = sorted((out / f"member{member:03d}").glob("*.nc"))
    for step in (0, 1, len(files) // 2, len(files) - 1):
        want = ens.member_fields(output_run["states"][step], member)
        with netcdf_file(str(files[step]), mmap=False) as f:
            for k, v in want.items():
                got = f.variables[k][:].copy()
                np.testing.assert_array_equal(
                    got[0], v.numpy().astype(np.float32), err_msg=(step, k))


@pytest.mark.parametrize("option", [dict(sea_coupling_flag=1)])
def test_check_supported_still_refuses(option):
    with pytest.raises(NotImplementedError):
        check_supported(t30(n_ensemble=8, **option))


def test_check_supported_accepts_ensembles():
    check_supported(t30(n_ensemble=64))
