"""The staged day (speedy_tpu_torch/models/captured.py) on the CPU, fp64,
at a T21 kx=5 grid on the stand-in boundary set. On the CPU the staged day
runs eagerly what the card replays as one CUDA graph: the state copied
into static buffers, the date inputs packed into one row a day, the SPPT
innovations drawn ahead into a static buffer.

* One staged day equals the eager ``run_day`` (``torch.equal``, every
  state leaf and the guard's extrema), SPPT off and on (from the
  generators and from numpy noise sources), one model and 2 members; the
  output variants' every-step diagnostics and gridded fields equal
  ``run_day``'s.
* The packed date rows read back as ``make_date_scalars`` gives them.
* ``sppt.draw_day`` draws what the steps would draw, in the same order
  (``torch.equal``), and calls a noise source once per update (per member)
  with the step's shape.
* ``run_fast`` returns a new state: two calls from one state are equal,
  and the first result and the given state are unchanged by the second.
* The guard, checked once per chunk, names the first day out of range.
* ``max_chunk_days`` splits a span without changing its result.
* ``Model.run`` with a checkpoint a day, resumed from day 1, equals the
  straight 2-day run.
* A dropped model is freed at once (no reference cycle through its
  staged days).
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from speedy_tpu_torch.config import t30
from speedy_tpu_torch.models import coupling
from speedy_tpu_torch.models.captured import leaves
from speedy_tpu_torch.models.model import GRID_FIELDS, Model, run_day
from speedy_tpu_torch.models.physics import sppt as sppt_mod
from speedy_tpu_torch.parallel.ensemble import Ensemble
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils import diagnostics
from speedy_tpu_torch.utils.checkpoint import load_checkpoint
from speedy_tpu_torch.utils.synthetic_bc import synthetic_boundaries

SMALL = dict(precision="fp64", trunc=21, ix=64, il=32, kx=5)
START = cal.Datetime(1982, 1, 1)


def assert_states_equal(a, b):
    for i, (x, y) in enumerate(zip(leaves(a), leaves(b), strict=True)):
        assert torch.equal(x, y), i


def generators(state):
    g = state.sppt.generator
    return g if isinstance(g, tuple) else (g,)


def numpy_noise(seed):
    rng = np.random.default_rng(seed)
    return lambda shape: rng.standard_normal(shape)


@pytest.fixture(scope="module")
def bc():
    return synthetic_boundaries(0)


@pytest.fixture(scope="module")
def models(bc):
    return {sppt: Model(t30(sppt_on=sppt, **SMALL), device="cpu",
                        bc_arrays=bc) for sppt in (False, True)}


def start_state(model, members, source):
    """The booted state of one model or of a ``members``-member ensemble,
    and a factory of its innovation sources (None: the generators)."""
    if source == "noise":
        make = (lambda: numpy_noise(5)) if members is None else \
            (lambda: [numpy_noise(6 + i) for i in range(members)])
    else:
        make = lambda: None
    if members is None:
        return model.initialize(START), make
    return Ensemble(model, members, base_seed=3).initialize(START), make


@pytest.mark.parametrize("members", [None, 2])
@pytest.mark.parametrize("sppt,source", [(False, None), (True, None),
                                         (True, "noise")])
def test_staged_day_equals_eager_run_day(models, members, sppt, source):
    m = models[sppt]
    state, make = start_state(m, members, source)
    eager, diags, _ = run_day(m.cfg, m.pp, m.lsp, m.mc, state,
                              m.date_scalars(START, START),
                              m.cfg.diag_every, make())
    cd = m.captured_day(state)
    cd.load(state)
    cd.set_days(m.make_ds_days(START, START, 1)[0])
    cd.advance(0, make())
    staged = cd.result()
    assert_states_equal(staged, eager)
    np.testing.assert_array_equal(cd.guard_rows(1)[0],
                                  diagnostics.guard_extrema(diags).numpy())
    if sppt and source is None:
        for a, b in zip(generators(staged), generators(eager), strict=True):
            assert torch.equal(a.get_state(), b.get_state())


@pytest.mark.parametrize("members", [None, 2])
@pytest.mark.parametrize("grids", [False, True])
def test_output_variant_equals_eager_run_day(models, members, grids):
    """Model.run's staged day (every step's diagnostics and, with a
    writer, gridded fields) against run_day with diagnostics every step."""
    m = models[True]
    state, _ = start_state(m, members, None)
    eager, diags, fields = run_day(m.cfg, m.pp, m.lsp, m.mc, state,
                                   m.date_scalars(START, START), 1,
                                   collect_output=grids)
    cd = m.captured_day(state, collect_output=True, grids=grids)
    cd.load(state)
    cd.set_days(m.make_ds_days(START, START, 1)[0])
    cd.advance(0)
    assert_states_equal(cd.result(), eager)
    ref = {f: torch.stack([getattr(d, f) for d in diags])
           for f in diagnostics.Diagnostics._fields}
    if grids:
        ref.update({k: torch.stack([g[k] for g in fields])
                    for k in GRID_FIELDS})
    out = cd.outputs()
    assert set(out) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(out[k], v.numpy(), err_msg=k)


def test_dropped_model_is_freed_at_once(bc):
    """A model and its staged days form no reference cycle, so a dropped
    model's captured graphs go with it, not at a later collection (which
    could fall inside another capture)."""
    m = Model(t30(**SMALL), device="cpu", bc_arrays=bc)
    m.run_fast(START, 1)
    assert m._captured
    ref = weakref.ref(m)
    gc.disable()
    try:
        del m
        assert ref() is None
    finally:
        gc.enable()


def test_date_rows_match_date_scalars(models):
    m = models[False]
    rows, end = m.make_ds_days(cal.Datetime(1982, 1, 30), START, 4)
    assert rows.shape == (4, coupling.date_row_size(m.cfg))
    assert end == cal.Datetime(1982, 2, 3)
    date = cal.Datetime(1982, 1, 30)
    for row in rows:
        view = coupling.date_scalars_view(m.cfg, torch.from_numpy(row))
        ref = m.date_scalars(date, START)
        for f, a, b in zip(coupling.DateScalars._fields, view, ref):
            assert a.shape == b.shape and torch.equal(a, b), f
        date = cal.next_day(date)


@pytest.mark.parametrize("members", [None, 3])
def test_draw_day_equals_per_step_draws(models, members):
    m = models[True]
    state, _ = start_state(m, members, None)
    nsteps = m.cfg.nsteps
    out = torch.empty((nsteps,) + tuple(state.sppt.spec.shape),
                      dtype=state.sppt.spec.dtype)
    gen = sppt_mod.draw_day(state.sppt.generator, None, out)
    g, steps = state.sppt.generator, []
    for _ in range(nsteps):
        eta, g = sppt_mod._innovations(state.sppt.spec.shape, state.sppt.spec,
                                       g, None)
        steps.append(eta)
    assert torch.equal(out, torch.stack(steps))
    gen = gen if isinstance(gen, tuple) else (gen,)
    g = g if isinstance(g, tuple) else (g,)
    for a, b in zip(gen, g, strict=True):
        assert torch.equal(a.get_state(), b.get_state())
    # the given generators were not advanced
    fresh = torch.empty_like(out)
    sppt_mod.draw_day(state.sppt.generator, None, fresh)
    assert torch.equal(fresh, out)


@pytest.mark.parametrize("members", [None, 2])
def test_draw_day_calls_noise_in_order(models, members):
    m = models[True]
    state, _ = start_state(m, members, None)
    spec = state.sppt.spec
    nsteps = m.cfg.nsteps
    calls = []

    def recording(tag, seed):
        src = numpy_noise(seed)

        def noise(shape):
            calls.append((tag, shape))
            return src(shape)
        return noise

    n = 1 if members is None else members
    if members is None:
        noise, again = recording(0, 11), numpy_noise(11)
    else:
        noise = [recording(i, 11 + i) for i in range(n)]
        again = [numpy_noise(11 + i) for i in range(n)]
    out = torch.empty((nsteps,) + tuple(spec.shape), dtype=spec.dtype)
    gen = sppt_mod.draw_day(state.sppt.generator, noise, out)
    assert gen is state.sppt.generator
    shape = tuple(spec.shape) if members is None else tuple(spec.shape[1:])
    assert calls == [(i, shape) for _ in range(nsteps) for i in range(n)]
    g, steps = state.sppt.generator, []
    for _ in range(nsteps):
        eta, g = sppt_mod._innovations(spec.shape, spec, g, again)
        steps.append(eta)
    assert torch.equal(out, torch.stack(steps))


def test_run_fast_returns_a_new_state(models):
    m = models[True]
    s0 = m.initialize(START)
    before = [x.clone() for x in leaves(s0)]
    first = m.run_fast(START, 1, state=s0)
    kept = [x.clone() for x in leaves(first)]
    second = m.run_fast(START, 1, state=s0)
    assert_states_equal(first, second)
    for x, y in zip(leaves(first), kept):
        assert torch.equal(x, y)
    for x, y in zip(leaves(s0), before):
        assert torch.equal(x, y)
    assert not any(x.data_ptr() == y.data_ptr()
                   for x, y in zip(leaves(first), leaves(second)))


def test_guard_names_the_failing_day_of_a_chunk(models, monkeypatch):
    """Day 1 of a 2-day chunk out of range, with a limit of the guard set
    between the two days' extrema where day 1 goes further than day 0,
    raises naming day 1; day 0 alone passes."""
    m = models[False]
    s0 = m.initialize(START)
    m.run_fast(START, 2, state=s0, check=False)
    rows = m.captured_day(s0).guard_rows(2)
    eke = [rows[d, :2].max() for d in (0, 1)]
    tmin = [rows[d, 2].min() for d in (0, 1)]
    tmax = [rows[d, 3].max() for d in (0, 1)]
    mid = lambda v: float(0.5 * (v[0] + v[1]))
    if eke[1] > eke[0]:
        monkeypatch.setattr(diagnostics, "EKE_MAX", mid(eke))
    elif tmax[1] > tmax[0]:
        monkeypatch.setattr(diagnostics, "TMEAN_MAX", mid(tmax))
    else:
        assert tmin[1] < tmin[0]
        monkeypatch.setattr(diagnostics, "TMEAN_MIN", mid(tmin))
    with pytest.raises(diagnostics.InstabilityError, match="at day 1:"):
        m.run_fast(START, 2, state=s0)
    m.run_fast(START, 1, state=s0)


@pytest.mark.parametrize("unit,bad", [("day", 0), ("day", 2), ("step", 10)],
                         ids=["0", "2", "step"])
def test_check_days_names_the_first_bad_day(unit, bad):
    """Rows of 3 days' extrema with the temperature's max not finite
    from day ``bad`` on: ``check_days`` names the first bad day. Or a
    day's 36 steps as the guard's rows (``step_rows``: each step's
    temperature as its min and max) with one step's temperature at one
    level not finite: ``first_bad`` finds that step's row alone and
    ``step_error`` names it by step."""
    if unit == "day":
        rows = np.zeros((3, 4, 5))
        rows[:, 2:] = 250.0
        rows[bad:, 3] = np.nan
        with pytest.raises(diagnostics.InstabilityError,
                           match=f"at day {10 + bad}:"):
            diagnostics.check_days(rows, first_day=10)
        diagnostics.check_days(rows[:bad], first_day=10)
        return
    tmean = np.full((36, 5), 250.0)
    tmean[bad, 3] = np.nan
    rows = diagnostics.step_rows({"reke": np.zeros((36, 5)),
                                  "deke": np.zeros((36, 5)),
                                  "tmean": tmean})
    assert diagnostics.first_bad(rows) == (bad,)
    assert diagnostics.first_bad(np.delete(rows, bad, axis=0)) is None
    err = diagnostics.step_error(10 + bad, rows[bad])
    assert str(err).startswith(
        f"Model variables out of accepted range at step {10 + bad}: "
        "reke=[0. 0. 0. 0. 0.], deke=[0. 0. 0. 0. 0.], temp=[250.")


@pytest.mark.parametrize("max_chunk_days", [1, 2])
def test_max_chunk_days_splits_without_changing_the_result(models,
                                                           max_chunk_days):
    m = models[True]
    s0 = m.initialize(START)
    whole = m.run_fast(START, 3, state=s0)
    split = m.run_fast(START, 3, state=s0, max_chunk_days=max_chunk_days)
    assert_states_equal(whole, split)
    for a, b in zip(generators(whole), generators(split)):
        assert torch.equal(a.get_state(), b.get_state())


def test_run_checkpoint_resume_equals_straight_run(models, tmp_path):
    m = models[True]
    day2 = cal.Datetime(1982, 1, 3)
    straight = m.run(START, day2, verbose=False, checkpoint_every=1,
                     checkpoint_dir=str(tmp_path))
    restored, date, step, _ = load_checkpoint(
        str(tmp_path / "ckpt_198201020000.npz"), m.initialize(START),
        cfg=m.cfg)
    assert date == cal.Datetime(1982, 1, 2) and step == m.cfg.nsteps
    resumed = m.run(START, day2, state=restored, resume_date=date,
                    model_step=step, verbose=False)
    assert_states_equal(straight, resumed)
