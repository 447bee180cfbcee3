"""Model.run's writer calls held against the output day's buffer of every
step's fields (tests/test_torch_run.py on the CPU, tests/test_torch_gpu.py
on the card; no JAX here): each call's fields equal that step's fields in
the full ``CapturedDay.outputs()`` of its day, at the steps and dates the
output cadence gives, and stay as they were after later days."""
import numpy as np
import torch

from speedy_tpu_torch.models.model import GRID_FIELDS
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils import tracing


def expected_calls(cfg, date, end, model_step=0):
    """(step, date) of every writer call of ``Model.run`` from ``date`` at
    ``model_step`` to ``end``: step 0 on a fresh start, then every
    ``nsteps_out``-th step up to the first step that reaches ``end``."""
    out = [(0, date)] if model_step == 0 else []
    while date < end:
        date = cal.newdate(date, cfg.nsteps)
        model_step += 1
        if model_step % cfg.nsteps_out == 0:
            out.append((model_step, date))
    return out


def fetch_bytes(cfg, days: int, grid_steps: int) -> int:
    """The bytes ``Model.run`` with a writer brings to the host over
    ``days`` days that fetch ``grid_steps`` steps' fields in all: every
    step's diagnostics (reke, deke, tmean [kx]) a day, and the fields (u,
    v, t, q, phi [kx, il, ix], ps [il, ix]) of each fetched step."""
    size = torch.empty(0, dtype=cfg.rdtype).element_size()
    diag = cfg.nsteps * 3 * cfg.kx
    grid = (5 * cfg.kx + 1) * cfg.il * cfg.ix
    return (days * diag + grid_steps * grid) * size


def run_against_buffer(model, state, start, end, date=None, model_step=0):
    """``model.run`` from ``state`` (at ``date``, ``start`` if None, and
    ``model_step``) to ``end``, with a writer that holds each call's fields
    against the day's full buffer, fetched once a day inside the writer
    (outside the counts returned). Returns the calls' (step, date), the
    fields that differ or changed after their call, and what ``Model.run``
    counted itself: ``output.grid_steps`` and ``d2h.bytes``."""
    nsteps = model.cfg.nsteps
    cd = model.captured_day(state, collect_output=True, grids=True)
    calls, bad, kept, buffers = [], [], [], {}
    own = 0

    def writer(step, date, start, fields):
        nonlocal own
        calls.append((step, date))
        kept.append((step, fields, {k: np.array(v)
                                    for k, v in fields.items()}))
        if step == 0:
            return
        day = (step - 1) // nsteps
        if day not in buffers:
            before = tracing.counters["d2h.bytes"]
            buffers[day] = cd.outputs()
            own += tracing.counters["d2h.bytes"] - before
        full = buffers[day]
        for k in GRID_FIELDS:
            if not np.array_equal(fields[k], full[k][(step - 1) % nsteps]):
                bad.append((step, k))

    counted = {k: tracing.counters[k]
               for k in ("output.grid_steps", "d2h.bytes")}
    model.run(start, end, output_writer=writer, verbose=False, state=state,
              resume_date=date, model_step=model_step)
    counted = {k: tracing.counters[k] - n for k, n in counted.items()}
    counted["d2h.bytes"] -= own
    for step, fields, copies in kept:
        for k in GRID_FIELDS:
            if not np.array_equal(fields[k], copies[k]):
                bad.append((step, k, "changed"))
    return calls, bad, counted
