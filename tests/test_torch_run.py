"""The port's run path on the CPU: gridded output fields, the NetCDF
writer, Model.run and checkpoints.

* gridded_fields against the JAX package's, fp64: <= 1e-12 relative per
  field;
* the NetCDF files of the port's writer against the JAX writer's for the
  same fields: the same file names, dimensions, variables, attributes and
  values;
* Model.run's output and diagnostics cadence;
* the port's counterparts of tests/test_state_mgmt.py: checkpoint round
  trip, resume continues identically (with SPPT), a config mismatch and
  resume past the end raise, and an SPPT state is not dropped silently;
* the .npz layout is the JAX package's: each package loads the other's
  checkpoint of a state without SPPT.
"""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from scipy.io import netcdf_file

from speedy_tpu.config import t30 as jt30
from speedy_tpu.models.model import Model as JModel
from speedy_tpu.utils import calendar as jcal
from speedy_tpu.utils import checkpoint as jckpt
from speedy_tpu.utils.output import NetCDFWriter as JWriter
from speedy_tpu_torch import convert
from speedy_tpu_torch.config import t30
from speedy_tpu_torch.models import model as model_module
from speedy_tpu_torch.models.model import Model
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils import tracing
from speedy_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from speedy_tpu_torch.utils.diagnostics import InstabilityError, first_bad
from speedy_tpu_torch.utils.output import NetCDFWriter
from speedy_tpu_torch.utils.synthetic_bc import (synthetic_boundaries,
                                                 write_boundary_files)
from torch_run_checks import expected_calls, fetch_bytes, run_against_buffer

SMALL = dict(precision="fp64", trunc=21, ix=64, il=32, kx=5)
START = cal.Datetime(1982, 1, 1)
FIELDS = ("u", "v", "t", "q", "phi", "ps")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: parallel test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bc():
    return synthetic_boundaries(0)


@pytest.fixture(scope="module")
def model(bc):
    return Model(t30(sppt_on=True, **SMALL), device="cpu", bc_arrays=bc)


@pytest.fixture(scope="module")
def booted(model):
    return model.initialize(START)


@pytest.fixture(scope="module")
def jax_pair(bc, tmp_path_factory):
    """The JAX model and the port's model without SPPT, fp64, on the same
    boundary set, and the port's state 3 steps after boot (at boot, time
    level 0 is still the rest state)."""
    d = tmp_path_factory.mktemp("bc")
    write_boundary_files(str(d), bc)
    jm = JModel(jt30(**SMALL), bc_search=[str(d)])
    tm = Model(t30(**SMALL), device="cpu", bc_arrays=bc)
    state = tm.initialize(START)
    daily = tm.daily_forcing(state, START, START)
    for i in range(3):
        state, _ = tm.one_step(state, daily, i == 0)
    return jm, tm, state


def to_jax(state):
    """The port's state as the JAX package's ModelState (no SPPT)."""
    from speedy_tpu.models.model import ModelState
    from speedy_tpu.models.physics import SurfaceState
    from speedy_tpu.models.physics.shortwave import RadiationState
    from speedy_tpu.models.state import PrognosticState
    tree = convert.model_state_to_numpy(state)
    return ModelState(
        prog=PrognosticState(**{k: jnp.asarray(v)
                                for k, v in tree["prog"].items()}),
        surf=SurfaceState(**{k: jnp.asarray(v)
                             for k, v in tree["surf"].items()}),
        rad=RadiationState(**{k: jnp.asarray(v)
                              for k, v in tree["rad"].items()}),
        sppt=None)


@pytest.mark.parametrize("level", [0, 1])
def test_gridded_fields_match_jax(jax_pair, level):
    jm, tm, state = jax_pair
    jg = jm._gridded(jm.mc, to_jax(state).prog, level=level)
    tg = tm.gridded_fields(state.prog, level)
    assert set(tg) == set(jg) == set(FIELDS)
    for k in FIELDS:
        ref = np.asarray(jg[k])
        err = np.abs(tg[k].numpy() - ref).max() / np.abs(ref).max()
        assert err <= 1e-12, (k, err)


def test_netcdf_files_match_jax_writer(jax_pair, tmp_path):
    _, tm, state = jax_pair
    fields = {k: v.numpy() for k, v in tm.gridded_fields(state.prog).items()}
    date = cal.Datetime(1982, 1, 1, 2, 40)
    port = NetCDFWriter(tm.cfg, str(tmp_path / "port"))(
        4, date, START, fields)
    ref = JWriter(jt30(**SMALL), str(tmp_path / "jax"))(
        4, jcal.Datetime(1982, 1, 1, 2, 40), jcal.Datetime(1982, 1, 1),
        fields)
    assert os.path.basename(port) == os.path.basename(ref) \
        == "198201010240.nc"
    with netcdf_file(port, mmap=False) as a, netcdf_file(ref, mmap=False) as b:
        assert a.dimensions == b.dimensions
        assert set(a.variables) == set(b.variables) \
            == set(FIELDS) | {"time", "lon", "lat", "lev"}
        for name, va in a.variables.items():
            vb = b.variables[name]
            assert va.dimensions == vb.dimensions, name
            assert va.typecode() == vb.typecode() == "f", name
            assert va._attributes == vb._attributes, name
            np.testing.assert_array_equal(va[:], vb[:])


def test_run_output_and_diagnostics_cadence(bc, tmp_path, capsys):
    cfg = t30(nsteps_out=9, nstdia=12, **SMALL)
    m = Model(cfg, device="cpu", bc_arrays=bc)
    calls = []
    writer = NetCDFWriter(cfg, str(tmp_path))

    def record(step, date, start, fields):
        calls.append((step, date))
        assert set(fields) == set(FIELDS)
        assert all(isinstance(v, np.ndarray) for v in fields.values())
        return writer(step, date, start, fields)

    end = m.run(START, cal.next_day(START), output_writer=record)
    assert [s for s, _ in calls] == [0, 9, 18, 27, 36]
    assert calls[-1][1] == cal.Datetime(1982, 1, 2)
    assert sorted(os.listdir(tmp_path)) == [
        "198201010000.nc", "198201010600.nc", "198201011200.nc",
        "198201011800.nc", "198201020000.nc"]
    printed = capsys.readouterr().out
    assert [int(line.split()[2]) for line in printed.splitlines()
            if line.startswith(" step =")] == [12, 24, 36]
    assert bool(torch.isfinite(end.prog.t).all())


DAY1, DAY2, DAY3 = (cal.Datetime(1982, 1, d) for d in (2, 3, 4))
# nsteps_out, then the run's start date, end, model_step and days
WRITE_CASES = {
    "every_step": (1, START, DAY1, 0, 1),
    "every_9": (9, START, DAY1, 0, 1),
    "daily": (36, START, DAY1, 0, 1),
    "daily_3_days": (36, START, DAY3, 0, 3),
    "every_2_days": (72, START, DAY2, 0, 2),
    "every_7": (7, START, DAY1, 0, 1),
    "resumed_every_2_days": (72, DAY1, DAY2, 36, 1),
    "end_inside_a_day": (4, START, cal.Datetime(1982, 1, 1, 10, 10), 0, 1),
}


@pytest.mark.parametrize("case", list(WRITE_CASES))
def test_run_writes_the_buffered_fields(bc, case):
    """Model.run brings to the host every step's diagnostics and only the
    written steps' fields: each writer call receives exactly that step's
    fields in the day's full buffer, at the cadence's steps and dates, and
    output.grid_steps and d2h.bytes count the written steps."""
    nsteps_out, date, end, step, days = WRITE_CASES[case]
    m = Model(t30(sppt_on=True, nsteps_out=nsteps_out, **SMALL),
              device="cpu", bc_arrays=bc)
    assert m.cfg.nsteps == 36
    calls, bad, counted = run_against_buffer(
        m, m.initialize(START), START, end, date=date, model_step=step)
    assert not bad
    assert calls == expected_calls(m.cfg, date, end, step)
    grid_steps = sum(s > 0 for s, _ in calls)
    assert counted == {"output.grid_steps": grid_steps,
                       "d2h.bytes": fetch_bytes(m.cfg, days, grid_steps)}


@pytest.mark.parametrize("days", [1, 3])
def test_run_leaves_every_steps_fields_in_the_day_buffer(bc, days):
    """After ``days`` days of Model.run with a writer at nsteps_out 36, the
    output day's buffer still holds the last day's every step's fields and
    diagnostics (what a caller reads through
    ``captured_day(...).outputs()``), equal to the same day run eagerly by
    ``checked_day``."""
    m = Model(t30(sppt_on=True, nsteps_out=36, **SMALL), device="cpu",
              bc_arrays=bc)
    booted = m.initialize(START)
    last = cal.Datetime(1982, 1, days)
    before = m.run_fast(START, days - 1, state=booted) if days > 1 \
        else booted
    m.run(START, cal.next_day(last), output_writer=lambda *a: None,
          verbose=False, state=booted)
    day = m.captured_day(booted, collect_output=True, grids=True).outputs()
    _, ref = m.checked_day(before, last, START, (days - 1) * m.cfg.nsteps,
                           True)
    assert set(day) == set(ref)
    for k, v in ref.items():
        assert v.shape[0] == m.cfg.nsteps
        np.testing.assert_array_equal(day[k], v, err_msg=k)


@pytest.mark.parametrize("days", [1, 3])
def test_run_equals_run_day(model, booted, days):
    """Model.run over ``days`` days, each day from the second on enqueued
    before the day before is checked, is that many run_days from the
    booted state."""
    day, date = booted, START
    for _ in range(days):
        day, _ = model.run_day(day, date, START)
        date = cal.next_day(date)
    run = model.run(START, date, state=booted, verbose=False)
    for f in day.prog._fields:
        assert torch.equal(getattr(day.prog, f), getattr(run.prog, f)), f
    assert torch.equal(day.sppt.spec, run.sppt.spec)


@pytest.mark.parametrize("checkpoint_every, ahead", [(0, 2), (1, 0)])
def test_run_enqueues_a_day_before_checking_the_one_before(
        model, booted, tmp_path, monkeypatch, checkpoint_every, ahead):
    """In a 3-day Model.run without checkpoints, days 2 and 3 are enqueued
    while the day before still has its guard to run (``run.days_ahead``
    counts 2); with a checkpoint every day, each day is checked before the
    next is enqueued (0). The day's device work is left out: the order is
    what is held here."""
    order, checked = [], []
    cd = model.captured_day(booted, collect_output=True)
    monkeypatch.setattr(cd, "_body", lambda: order.append("day"))

    def check(rows):   # the day's check, recorded by its last step
        checked.append(len(rows))
        order.append(sum(checked))

    monkeypatch.setattr(model_module, "first_bad", check)
    counted = tracing.counters["run.days_ahead"]
    model.run(START, DAY3, state=booted, verbose=False,
              checkpoint_every=checkpoint_every,
              checkpoint_dir=str(tmp_path))
    assert tracing.counters["run.days_ahead"] - counted == ahead
    assert order == (["day", "day", 36, "day", 72, 108] if ahead else
                     ["day", 36, "day", 72, "day", 108])


@pytest.mark.parametrize("checkpoint_every", [1, 3])
def test_run_raises_at_the_step_out_of_range(bc, booted, tmp_path,
                                             monkeypatch, checkpoint_every):
    """Step 47, in day 2 of a 3-day Model.run at nsteps_out 9, out of
    range: the run raises InstabilityError naming step 47 after the writer
    calls for exactly the steps before it, with no checkpoint of day 2,
    whether day 3 was enqueued already (a checkpoint every 3 days) or not
    (every day). The day's device work is left out; its zeros are out of
    range, and of each day's single check only step 47's row counts."""
    m = Model(t30(sppt_on=True, nsteps_out=9, **SMALL), device="cpu",
              bc_arrays=bc)
    cd = m.captured_day(booted, collect_output=True, grids=True)
    monkeypatch.setattr(cd, "_body", lambda: None)
    checked = []

    def check(rows):   # step 47's row alone, in the day that holds it
        first = sum(checked)
        checked.append(len(rows))
        i = 47 - first - 1
        if not 0 <= i < len(rows) or first_bad(rows[i:i + 1]) is None:
            return None
        return (i,)

    monkeypatch.setattr(model_module, "first_bad", check)
    calls = []
    with pytest.raises(InstabilityError, match="at step 47:"):
        m.run(START, DAY3, output_writer=lambda step, *a: calls.append(step),
              verbose=False, state=booted,
              checkpoint_every=checkpoint_every,
              checkpoint_dir=str(tmp_path))
    assert calls == [0, 9, 18, 27, 36, 45]
    assert os.listdir(tmp_path) == \
        (["ckpt_198201020000.npz"] if checkpoint_every == 1 else [])


def test_checkpoint_roundtrip(tmp_path, model, booted):
    path = str(tmp_path / "ckpt.npz")
    date = cal.Datetime(1982, 1, 5, 12, 0)
    save_checkpoint(path, booted, date, model_step=162, start=START,
                    cfg=model.cfg)
    restored, rdate, rstep, extras = load_checkpoint(path, booted,
                                                     cfg=model.cfg)
    assert rdate == date and rstep == 162
    assert extras["start"] == START
    for g in ("prog", "surf", "rad"):
        for f in getattr(booted, g)._fields:
            a, b = getattr(getattr(booted, g), f), getattr(getattr(restored,
                                                                   g), f)
            assert a.dtype == b.dtype and torch.equal(a, b), (g, f)
    assert torch.equal(booted.sppt.spec, restored.sppt.spec)
    assert torch.equal(booted.sppt.generator.get_state(),
                       restored.sppt.generator.get_state())


def test_checkpoint_config_mismatch_raises(tmp_path, model, booted):
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, booted, cal.Datetime(1982, 1, 2), cfg=model.cfg)
    bad = t30(increase_co2=True, sppt_on=True, **SMALL)
    with pytest.raises(ValueError, match="config mismatch"):
        load_checkpoint(path, booted, cfg=bad)


def test_checkpoint_sppt_state_not_silently_dropped(tmp_path, booted):
    path = str(tmp_path / "sppt_ck.npz")
    save_checkpoint(path, booted, START)
    with pytest.raises(ValueError, match="drop"):
        load_checkpoint(path, booted._replace(sppt=None))
    save_checkpoint(path, booted._replace(sppt=None), START)
    with pytest.raises(ValueError, match="missing"):
        load_checkpoint(path, booted)


def test_run_resume_past_end_raises(model, booted):
    with pytest.raises(ValueError, match="not before end"):
        model.run(START, cal.Datetime(1982, 1, 2), state=booted,
                  resume_date=cal.Datetime(1982, 1, 3), verbose=False)


def test_checkpoint_resume_continues_identically(model, booted, tmp_path):
    """A day from a restored checkpoint, SPPT generator included, is bit
    for bit the day from the state that was saved."""
    s1, _ = model.run_day(booted, START, START)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, booted, START)
    restored, _, _, _ = load_checkpoint(path, booted)
    s2, _ = model.run_day(restored, START, START)
    for f in s1.prog._fields:
        assert torch.equal(getattr(s1.prog, f), getattr(s2.prog, f)), f
    assert torch.equal(s1.sppt.spec, s2.sppt.spec)


def test_run_checkpoints_and_resume(model, tmp_path):
    """Model.run writes a checkpoint per day; resuming from day 1 ends where
    the straight 2-day run ends."""
    ck = str(tmp_path / "ck")
    day2 = cal.Datetime(1982, 1, 3)
    straight = model.run(START, day2, verbose=False, checkpoint_every=1,
                         checkpoint_dir=ck)
    assert sorted(os.listdir(ck)) == ["ckpt_198201020000.npz",
                                      "ckpt_198201030000.npz"]
    state, date, step, extras = load_checkpoint(
        os.path.join(ck, "ckpt_198201020000.npz"), model.initialize(START),
        cfg=model.cfg)
    assert (date, step, extras["start"]) == (cal.Datetime(1982, 1, 2),
                                             model.cfg.nsteps, START)
    resumed = model.run(START, day2, state=state, resume_date=date,
                        model_step=step, verbose=False)
    for f in straight.prog._fields:
        assert torch.equal(getattr(straight.prog, f),
                           getattr(resumed.prog, f)), f
    assert torch.equal(straight.sppt.spec, resumed.sppt.spec)


def test_checkpoint_layout_shared_with_jax(jax_pair, tmp_path):
    jm, tm, state = jax_pair
    date = cal.Datetime(1982, 1, 2)
    port_path = str(tmp_path / "port.npz")
    save_checkpoint(port_path, state, date, model_step=36, start=START,
                    cfg=tm.cfg)
    jstate = to_jax(state)
    back, jdate, jstep, _ = jckpt.load_checkpoint(port_path, jstate,
                                                  cfg=jm.cfg)
    assert (jdate.day, jstep) == (2, 36)
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    jax_path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(jax_path, jstate, jcal.Datetime(1982, 1, 2),
                          model_step=36, start=jcal.Datetime(1982, 1, 1),
                          sstan3=np.asarray(jm.mc.clim.sstan3), cfg=jm.cfg)
    restored, rdate, rstep, extras = load_checkpoint(jax_path, state,
                                                     cfg=tm.cfg)
    assert (rdate, rstep, extras["start"]) == (date, 36, START)
    assert "sstan3" in extras
    for g in ("prog", "surf", "rad"):
        for f in getattr(state, g)._fields:
            assert torch.equal(getattr(getattr(state, g), f),
                               getattr(getattr(restored, g), f)), (g, f)
