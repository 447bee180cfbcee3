"""The day's flux outputs, the accumulating captured day and
speedy_tpu_torch.run_multiyear against the JAX package, fp64 on the CPU,
at T21 kx=5 on the stand-in boundary set (the JAX model from HDF5 copies
of it, the port from the same arrays in memory):

* the port's run_day(collect_fluxes=True) against the JAX run_day(...,
  collect_fluxes=True) over one day from the JAX booted state: every
  step's precnv, precls, olr, tsr, ssr (and the state) <= 1e-10;
* the accumulating day's monthly means over a 2-day span (run_month)
  against the JAX script's build_month_span (scripts/run_multiyear.py,
  imported by path) from the same state, <= 1e-10;
* the accumulators over 3 days across a month end (two "months": Jan
  30-31 and Feb 1) against the means of Model.run's per-step output at
  the day ends (u, t) and of the eager run_day's per-step fluxes,
  <= 1e-12;
* season_mean and the summary against the JAX script's season_mean and
  its summary formulas on seeded months, <= 1e-12;
* the El Nino anomaly reaches the model's window south -> north: equal to
  2 K times the domain mask on sea points, its weighted centre in the
  tropical Pacific, with the rest of the set given in memory and as
  files.
Bounds are max |port - jax| / max |jax| per field.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from speedy_tpu.config import t30 as jt30
from speedy_tpu.models.model import Model as JModel
from speedy_tpu.utils import calendar as jcal
from speedy_tpu_torch import run_multiyear as rm
from speedy_tpu_torch.config import t30
from speedy_tpu_torch.models.captured import ACC_FLUXES
from speedy_tpu_torch.models.model import Model, run_day
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils.synthetic_bc import (synthetic_boundaries,
                                                 write_boundary_files)
from torch_parity import (SMALL, START, STEP_BOUND, assert_close, jax_steps,
                          rel_err, to_port)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACC_BOUND = 1e-12


def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's runs with one intra-op thread, as in
    tests/test_torch_cli.py: the Tier-1 run puts 6 workers on the
    machine's cores, and 6 full thread teams oversubscribe them."""
    default = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(default)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    bc = synthetic_boundaries(0)
    d = tmp_path_factory.mktemp("bc")
    write_boundary_files(str(d), bc)
    jm = JModel(jt30(**SMALL), bc_search=[str(d)])
    tm = Model(t30(**SMALL), device="cpu", bc_arrays=bc)
    jboot, _, ds = jax_steps(jm, jcal.Datetime(*START), n=0)
    return bc, jm, tm, jboot, ds, str(d)


def test_day_fluxes_match_jax(models):
    _, jm, tm, jboot, ds, _ = models
    start = cal.Datetime(*START)
    jstate, outs = jm._run_day(jm.mc, jboot, ds, collect_output=False,
                               collect_fluxes=True)
    tstate, diags, grids, fl = run_day(
        tm.cfg, tm.pp, tm.lsp, tm.mc, to_port(jboot),
        tm.date_scalars(start, start), collect_fluxes=True)
    assert grids is None and len(diags) == tm.cfg.nsteps
    assert fl.sfc is None and outs.fluxes.sfc is None
    for name in fl._fields[:-1]:
        want = np.asarray(getattr(outs.fluxes, name))
        got = getattr(fl, name)
        assert tuple(got.shape) == want.shape == (tm.cfg.nsteps, 32, 64)
        assert rel_err(got, want) <= STEP_BOUND, name
    assert_close(jstate, tstate)


def test_month_span_matches_jax(models):
    _, jm, tm, jboot, _, _ = models
    start = cal.Datetime(*START)
    month_span = jax_script("run_multiyear").build_month_span(jm)
    ds_days, _ = jm.make_ds_days(jcal.Datetime(*START),
                                 jcal.Datetime(*START), 2)
    jstate, acc, _ = month_span(jm.mc, jboot, ds_days)
    acc = {k: np.asarray(v) for k, v in acc.items()}
    steps = 2 * tm.cfg.nsteps
    want = dict(u=acc["u"] / 2, t=acc["t"] / 2,
                precip=(acc["precnv"] + acc["precls"]) / steps,
                **{k: acc[k] / steps for k in ("olr", "tsr", "ssr")})
    state = to_port(jboot)
    cd = tm.captured_day(state, accumulate=True)
    cd.load(state)
    month, end = rm.run_month(tm, cd, start, start, 2)
    assert end == cal.Datetime(1982, 1, 3) and cd.host_copies == 1
    assert (month["year"], month["month"]) == (1982, 1)
    for k, v in want.items():
        assert month[k].shape == v.shape, k
        assert rel_err(month[k], v) <= STEP_BOUND, k
    assert_close(jstate, cd.result())


def test_accumulators_equal_run_output_means(models):
    """Two months of the accumulating day (Jan 30-31, then Feb 1) against
    Model.run's day-end fields and the eager days' step fluxes."""
    _, _, tm, _, _, _ = models
    first, feb = cal.Datetime(1982, 1, 30), cal.Datetime(1982, 2, 1)
    end = cal.Datetime(1982, 2, 2)
    ends = {}

    def writer(step, date, start, fields):
        if step and step % tm.cfg.nsteps == 0:
            ends[step // tm.cfg.nsteps] = fields

    tm.run(first, end, output_writer=writer, verbose=False)
    state = tm.initialize(first)
    fluxes, date = [], first
    for _ in range(3):
        state, _, _, fl = run_day(tm.cfg, tm.pp, tm.lsp, tm.mc, state,
                                  tm.date_scalars(date, first),
                                  collect_fluxes=True)
        fluxes.append(fl)
        date = cal.next_day(date)
    state = tm.initialize(first)
    cd = tm.captured_day(state, accumulate=True)
    cd.load(state)
    jan, date = rm.run_month(tm, cd, first, first, 2)
    assert date == feb
    febm, date = rm.run_month(tm, cd, feb, first, 1, first_day=2)
    assert date == end and (febm["year"], febm["month"]) == (1982, 2)
    for month, days in ((jan, (1, 2)), (febm, (3,))):
        steps = len(days) * tm.cfg.nsteps
        for k in ("u", "t"):
            want = np.mean([ends[d][k] for d in days], axis=0)
            assert rel_err(month[k], want) <= ACC_BOUND, k
        sums = {k: sum(getattr(fluxes[d - 1], k).sum(dim=0) for d in days)
                for k in ACC_FLUXES}
        want = dict(precip=(sums["precnv"] + sums["precls"]) / steps,
                    **{k: sums[k] / steps for k in ("olr", "tsr", "ssr")})
        for k, v in want.items():
            assert rel_err(month[k], v) <= ACC_BOUND, k


def seeded_months(seed=0, years=3, kx=5, il=32, ix=64):
    rng = np.random.default_rng(seed)
    return [dict(year=1982 + y, month=m,
                 u=rng.normal(10.0, 8.0, (kx, il, ix)),
                 t=rng.normal(260.0, 15.0, (kx, il, ix)),
                 precip=rng.uniform(0.0, 1e-4, (il, ix)),
                 olr=rng.uniform(150.0, 300.0, (il, ix)),
                 tsr=rng.uniform(0.0, 400.0, (il, ix)),
                 ssr=rng.uniform(0.0, 300.0, (il, ix)))
            for y in range(years) for m in range(1, 13)]


@pytest.mark.parametrize("years", [1, 3])
def test_season_mean_and_summary_match_jax(models, years):
    _, jm, tm, _, _, _ = models
    months = seeded_months(years=years)
    jsm = jax_script("run_multiyear").season_mean
    for season in ("DJF", "JJA"):
        a, b = rm.season_mean(months, season), jsm(months, season)
        assert a.keys() == b.keys()
        for k in a:
            assert rel_err(a[k], b[k]) <= ACC_BOUND, (season, k)
    # the JAX script's summary formulas (scripts/run_multiyear.py:193-215)
    # without its rounding
    geom = jm.geom_np
    kjet = int(np.argmin(np.abs(geom["fsg"] - 0.2)))
    wt = jm.sp_np["wt"]
    wfull = np.concatenate([wt, wt[::-1]])
    wfull = wfull / wfull.sum()
    lats = np.degrees(geom["radang"])
    gm = lambda f: float((f.mean(axis=-1) * wfull).sum())
    got = rm.summary(tm, months)
    for season in ("DJF", "JJA"):
        s = jsm(months, season)
        jet = s["u"].mean(axis=-1)[kjet]
        want = dict(jet_max_ms=float(jet.max()),
                    jet_max_lat=float(lats[int(jet.argmax())]),
                    precip_global_mmday=gm(s["precip"]) * 86.4,
                    olr_global_Wm2=gm(s["olr"]),
                    olr_min_Wm2=float(s["olr"].min()),
                    olr_max_Wm2=float(s["olr"].max()),
                    t_sfc_global_K=gm(s["t"][4]))
        assert got[season].keys() == want.keys()
        for k, v in want.items():
            assert abs(got[season][k] - v) <= ACC_BOUND * max(abs(v), 1.0), \
                (season, k)


@pytest.mark.parametrize("source", ["arrays", "files"])
def test_elnino_anomaly_orientation(models, source):
    """From the stand-in set in memory and from its HDF5 copies (the
    files read into memory for --bc-path)."""
    bc, _, tm, _, _, bc_dir = models
    cfg = t30(**SMALL, sst_anomaly_forcing=True)
    wmask = rm.elnino_mask(cfg, tm.geom_np)
    given = dict(bc_arrays=bc) if source == "arrays" \
        else dict(bc_search=[bc_dir])
    m = Model(cfg, device="cpu",
              **rm.with_anomaly(given, rm.ELNINO_K * wmask))
    m.set_anomaly_window(rm.START)
    sea = m._bmask_s > 0.0
    window = m.mc.clim.sstan3.numpy()
    for month in window:
        np.testing.assert_array_equal(month, np.where(sea, 2.0 * wmask,
                                                      0.0))
    w = window[1]
    assert w.sum() > 0.0
    lat = np.degrees(m.geom_np["radang"])[:, None]
    lon = (np.arange(cfg.ix) * 360.0 / cfg.ix)[None, :]
    clat, clon = (w * lat).sum() / w.sum(), (w * lon).sum() / w.sum()
    # the mask reaches further east south of the equator
    assert -15.0 < clat < 0.0 and 180.0 < clon < 280.0, (clat, clon)
