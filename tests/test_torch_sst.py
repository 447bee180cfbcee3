"""SST-anomaly forcing (``sst_anomaly_forcing=True``) of the port against
the JAX package, fp64 on the CPU, at T21 kx=5, on the stand-in boundary
set with its seeded anomaly file (synthetic_boundaries(anomaly=True); the
JAX model reads HDF5 copies of it, the port the same arrays in memory):

* boot + 6 steps (<= 1e-10), and the initial window equal to the JAX
  package's;
* a run from 1982-01-30 over 4 days, across the 1982-02-01 window shift:
  the staged run_fast ``torch.equal`` to the eager run_day day by day
  (the window shifted by hand), both <= 1e-10 from the JAX run_fast, the
  window shifted as the JAX package shifts it;
* a checkpoint a day of Model.run: each holds the window of its date, and
  the one before the shift, restored with Model.restore and run across
  it, equals the straight run;
* without the forcing no window is written; without the file, a warning
  and zeros;
* the JAX Ensemble's quirk, copied: run_days never shifts the window.
"""
import os

import numpy as np
import pytest
import torch

from speedy_tpu.config import t30 as jt30
from speedy_tpu.models.model import Model as JModel
from speedy_tpu.utils import calendar as jcal
from speedy_tpu_torch.config import t30
from speedy_tpu_torch.models.captured import leaves
from speedy_tpu_torch.models.model import Model
from speedy_tpu_torch.parallel.ensemble import Ensemble
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils.synthetic_bc import (synthetic_boundaries,
                                                 write_boundary_files)
from torch_parity import (SMALL, START, STEP_BOUND, assert_close,
                          assert_states_equal, jax_steps, port_steps,
                          rel_err)

SST_START = (1982, 1, 30)   # 4 days across the 1982-02-01 window shift
SST_DAYS = 4


@pytest.fixture(scope="module")
def bc():
    return synthetic_boundaries(0)


SST = dict(sst_anomaly_forcing=True, **SMALL)


@pytest.fixture(scope="module")
def sst_bc(tmp_path_factory):
    """The stand-in set with its anomaly file, in memory and as files."""
    bc = synthetic_boundaries(0, anomaly=True)
    d = tmp_path_factory.mktemp("bc_sst")
    write_boundary_files(str(d), bc)
    return bc, str(d)


@pytest.fixture(scope="module")
def sst_models(sst_bc):
    bc, d = sst_bc
    return (JModel(jt30(**SST), bc_search=[d]),
            Model(t30(**SST), device="cpu", bc_arrays=bc))


@pytest.fixture(scope="module")
def sst_steps(sst_models):
    """Both models' boot and 6 steps from 1982-01-01, and their windows."""
    jm, tm = sst_models
    jboot, js, _ = jax_steps(jm, jcal.Datetime(*START))
    tboot, ts = port_steps(tm, cal.Datetime(*START))
    return dict(boot=(jboot, tboot), steps=(js, ts),
                windows=(np.asarray(jm.mc.clim.sstan3),
                         tm.mc.clim.sstan3.clone()))


@pytest.mark.parametrize("stage", ["boot", "steps"])
def test_sst_anomaly_steps_match_jax(sst_steps, stage):
    assert_close(*sst_steps[stage])


def test_sst_initial_window_matches_jax(sst_steps, sst_bc):
    """The window around January 1982 is the JAX package's, and its
    anomaly reaches the sea surface the atmosphere sees."""
    jwindow, window = sst_steps["windows"]
    assert np.abs(jwindow).max() > 0.5
    np.testing.assert_array_equal(window.numpy(), jwindow)
    start = cal.Datetime(*START)
    with_anomaly = Model(t30(**SST), device="cpu", bc_arrays=sst_bc[0])
    without = Model(t30(**SMALL), device="cpu", bc_arrays=sst_bc[0])
    diff = (with_anomaly.initial_state(start).surf.sst_am
            - without.initial_state(start).surf.sst_am).abs().max()
    assert float(diff) > 0.1


@pytest.fixture(scope="module")
def sst_runs(sst_models):
    """From 1982-01-30, SST_DAYS days across the window shift: the JAX
    run_fast, the port's staged run_fast, and the port's eager run_day day
    by day with the window shifted by hand at 1982-02-01; the windows
    after initialize and after each run."""
    jm, tm = sst_models
    jstart, start = jcal.Datetime(*SST_START), cal.Datetime(*SST_START)
    jout = jm.run_fast(jstart, SST_DAYS)
    jwindow = np.asarray(jm.mc.clim.sstan3)

    booted = tm.initialize(start)
    window0 = tm.mc.clim.sstan3.clone()
    staged = tm.run_fast(start, SST_DAYS, state=booted)
    window1 = tm.mc.clim.sstan3.clone()

    tm.set_anomaly_window(start)
    state, date = booted, start
    for _ in range(SST_DAYS):
        if date.day == 1 and date != start:
            tm.advance_anomaly_window(start, date)
        state, _ = tm.run_day(state, date, start)
        for _ in range(tm.cfg.nsteps):
            date = cal.newdate(date, tm.cfg.nsteps)
    return dict(jax=jout, staged=staged, eager=state, jwindow=jwindow,
                window0=window0, window1=window1,
                window_eager=tm.mc.clim.sstan3.clone(), booted=booted)


def test_sst_run_staged_equals_eager(sst_runs):
    assert_states_equal(sst_runs["staged"], sst_runs["eager"])


def test_sst_run_matches_jax_run_fast(sst_runs):
    assert_close(sst_runs["jax"], sst_runs["staged"])


def test_sst_window_shifts_at_month_start(sst_runs):
    """After 1982-02-01 the window holds Jan, Feb, Mar 1982 where it held
    Dec 1981, Jan, Feb: its first two months are the old last two."""
    w0, w1 = sst_runs["window0"], sst_runs["window1"]
    assert not torch.equal(w0, w1)
    assert torch.equal(w1[:2], w0[1:])
    assert torch.equal(w1, sst_runs["window_eager"])
    np.testing.assert_array_equal(w1.numpy(), sst_runs["jwindow"])


def test_sst_checkpoint_resume_across_month_start(sst_models, tmp_path):
    """Model.run from 1982-01-30 with a checkpoint a day; the one at
    1982-01-31 restored (Model.restore) and run across the window shift
    equals the straight run; each checkpoint holds the window of its
    date."""
    from speedy_tpu_torch.utils.checkpoint import load_checkpoint
    _, tm = sst_models
    start = cal.Datetime(*SST_START)
    end = cal.Datetime(1982, 2, 3)
    booted = tm.initialize(start)
    jan = tm.mc.clim.sstan3.clone()
    straight = tm.run(start, end, state=booted, verbose=False,
                      checkpoint_every=1, checkpoint_dir=str(tmp_path))
    feb = tm.mc.clim.sstan3.clone()
    assert not torch.equal(jan, feb)
    names = sorted(os.listdir(tmp_path))
    assert names == ["ckpt_198201310000.npz", "ckpt_198202010000.npz",
                     "ckpt_198202020000.npz", "ckpt_198202030000.npz"]
    for name, want in zip(names, (jan, jan, feb, feb)):
        _, _, _, extras = load_checkpoint(str(tmp_path / name), booted,
                                          cfg=tm.cfg)
        assert np.array_equal(extras["sstan3"], want.numpy()), name

    state, date, step, _ = tm.restore(str(tmp_path / names[0]), start)
    assert torch.equal(tm.mc.clim.sstan3, jan)
    resumed = tm.run(start, end, state=state, resume_date=date,
                     model_step=step, verbose=False)
    assert_states_equal(straight, resumed)
    assert torch.equal(tm.mc.clim.sstan3, feb)


def test_no_window_without_the_forcing(bc, tmp_path):
    """Without the forcing, a checkpoint holds no window and the model's
    stays zero."""
    from speedy_tpu_torch.utils.checkpoint import load_checkpoint
    tm = Model(t30(**SMALL), device="cpu", bc_arrays=bc)
    start = cal.Datetime(*START)
    tm.run(start, cal.Datetime(1982, 1, 2), verbose=False,
           checkpoint_every=1, checkpoint_dir=str(tmp_path))
    _, _, _, extras = load_checkpoint(
        str(tmp_path / "ckpt_198201020000.npz"), tm.initialize(start))
    assert "sstan3" not in extras
    assert not bool(tm.mc.clim.sstan3.any())


def test_missing_anomaly_file_warns_and_reads_zeros(bc):
    tm = Model(t30(**SST), device="cpu", bc_arrays=bc)
    with pytest.warns(UserWarning, match="anomaly"):
        tm.initialize(cal.Datetime(*START))
    assert not bool(tm.mc.clim.sstan3.any())


def test_ensemble_never_shifts_the_window(sst_models, sst_runs):
    """The JAX Ensemble's quirk, copied: initialize sets the window through
    Model.initialize, run_days keeps it over the month start, so its
    members (SPPT off: the single model, to rounding) end where run_day
    with the window never shifted ends, not where run_fast ends."""
    _, tm = sst_models
    start = cal.Datetime(*SST_START)
    ens = Ensemble(tm, 2)
    estate = ens.initialize(start)
    window = tm.mc.clim.sstan3.clone()
    assert torch.equal(window, sst_runs["window0"])
    out, end = ens.run_days(estate, start, SST_DAYS)
    assert end == cal.Datetime(1982, 2, 3)
    assert torch.equal(tm.mc.clim.sstan3, window)

    state, date = sst_runs["booted"], start
    for _ in range(SST_DAYS):
        state, _ = tm.run_day(state, date, start)
        for _ in range(tm.cfg.nsteps):
            date = cal.newdate(date, tm.cfg.nsteps)
    for m in range(2):
        for i, (a, b) in enumerate(zip(leaves(out), leaves(state))):
            assert rel_err(a[m], b.numpy()) <= STEP_BOUND, (m, i)
        shifted = sst_runs["staged"].surf.sst_am.numpy()
        assert rel_err(out.surf.sst_am[m], shifted) > 1e-6, m
