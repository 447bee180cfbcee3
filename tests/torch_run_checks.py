"""Model.run's writer calls held against the output day's buffer of every
step's fields (tests/test_torch_run.py on the CPU, tests/test_torch_gpu.py
on the card; no JAX here): each call's fields equal that step's fields in
the full buffer of its day (``CapturedDay.out``, as it stood right after
that day's replay), at the steps and dates the output cadence gives, and
stay as they were after later days."""
import numpy as np
import torch

from speedy_tpu_torch.models.captured import host_sync
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
    ``model_step``) to ``end``, with a writer that keeps each call's fields
    and a copy of them; each replayed day's full buffer is cloned on the
    device right behind its replay (no host synchronisation, no count).
    After the run, each call's fields are held against their day's buffer
    and against their copy: a later day that overwrote them shows.
    Returns the calls' (step, date), the fields that differ or changed
    after their call, and what ``Model.run`` counted: ``output.grid_steps``
    and ``d2h.bytes``."""
    nsteps = model.cfg.nsteps
    cd = model.captured_day(state, collect_output=True, grids=True)
    calls, bad, kept, buffers = [], [], [], []
    advance = cd.advance

    def advance_and_keep(d, noise=None):
        advance(d, noise)
        buffers.append({k: v.clone() for k, v in cd.out.items()})

    def writer(step, date, start, fields):
        calls.append((step, date))
        kept.append((step, fields, {k: np.array(v)
                                    for k, v in fields.items()}))

    counted = {k: tracing.counters[k]
               for k in ("output.grid_steps", "d2h.bytes")}
    cd.advance = advance_and_keep
    try:
        model.run(start, end, output_writer=writer, verbose=False,
                  state=state, resume_date=date, model_step=model_step)
    finally:
        del cd.advance
    counted = {k: tracing.counters[k] - n for k, n in counted.items()}
    with host_sync():
        buffers = [{k: v.cpu().numpy() for k, v in day.items()}
                   for day in buffers]
    for step, fields, copies in kept:
        if step > 0:
            full = buffers[(step - 1 - model_step) // nsteps]
            for k in GRID_FIELDS:
                if not np.array_equal(fields[k],
                                      full[k][(step - 1) % nsteps]):
                    bad.append((step, k))
        for k in GRID_FIELDS:
            if not np.array_equal(fields[k], copies[k]):
                bad.append((step, k, "changed"))
    return calls, bad, counted
