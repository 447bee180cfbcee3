"""The cases of tests/test_torch_gpu.py that run a day or trace one: the
spectral update's inputs in the step's strided layouts, a booted state
and its captured day, a replayed day against the eager
run_day on a side stream, the SST-anomaly and accumulating variants
against theirs, K1's inputs cut to a latitude band, the kernels of a
call in a profiler trace, and a program of the port run through its
``python -m`` entry. Imports no JAX and touches no CUDA device until
a case is called, so it imports on a CPU-only machine, where the tests
that call it skip.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from speedy_tpu_torch.geometry import build_geometry_np
from speedy_tpu_torch.models.captured import (ACC_FLUXES, ACC_GRIDS, leaves,
                                              pool_bytes, step_sum)
from speedy_tpu_torch.models.model import GRID_FIELDS, gridded_fields, run_day
from speedy_tpu_torch.models.hdiffusion import (build_diffusion,
                                                build_diffusion_np)
from speedy_tpu_torch.models.implicit import build_implicit
from speedy_tpu_torch.models.physics import fused
from speedy_tpu_torch.models.state import PrognosticState
from speedy_tpu_torch.models.time_stepping import OrographicCorrection
from speedy_tpu_torch.ops import spectral as sp
from speedy_tpu_torch.parallel.ensemble import Ensemble
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils.diagnostics import Diagnostics

TRANSFORM_BOUND = {torch.float64: 1e-12, torch.float32: 1e-5}  # field-normalised
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def program(module, *args):
    """``python -m module args`` from the checkout's root, as a user types
    it, the checkout first on PYTHONPATH (for a script that torchrun
    starts), its output captured: the CompletedProcess."""
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=900)


def json_lines(text):
    """The JSON objects a program printed, one a line, in order."""
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def trace(fn):
    """One call of ``fn`` under torch.profiler, ending in a synchronise:
    (wall seconds, (name, device µs) of each CUDA kernel it ran, the count
    of its ``aten::`` operator events, nested ones included)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = [(e.name, e.time_range.elapsed_us()) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    n_ops = sum(1 for e in events
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith("aten::"))
    return wall, kernels, n_ops


def update_case(cfg, members, device, seed=0):
    """The spectral update's inputs for ``cfg`` (``members`` leading, or
    one model for None) on ``device``: (sc, dc, ic for 2 dt, state,
    tendencies, corrections). The state and the corrections are seeded
    normals; the tables are the model's. The tendencies lie as the step
    leaves them: vordt and tdt slices of one buffer, divdt with the level
    axis inside (m, n) and the members innermost (the implicit solve's
    output), psdt with re/im before n, trdt whole; qcorh per member with
    re/im before n, tcorh shared."""
    geom = build_geometry_np(cfg)
    sc = sp.build_spectral(cfg, geom, device)
    dc = build_diffusion(cfg, geom, device)
    ic = build_implicit(cfg, geom, build_diffusion_np(cfg, geom),
                        2 * cfg.delt, device)
    rng = np.random.default_rng(seed)
    lead = () if members is None else (members,)
    m1 = 1 if members is None else members
    kx, mx, nx, ntr = cfg.kx, cfg.mx, cfg.nx, cfg.ntr

    def normal(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=cfg.rdtype,
                               device=device)

    def lead_view(x):               # [M, ...] -> lead + [...]
        return x if members is not None else x[0]

    level = (*lead, 2, kx, mx, nx, 2)
    state = PrognosticState(vor=normal(*level), div=normal(*level),
                            t=normal(*level), ps=normal(*lead, 2, mx, nx, 2),
                            tr=normal(*lead, 2, ntr, kx, mx, nx, 2))
    both = normal(m1, 2, kx, mx, nx, 2)
    tend = (lead_view(both[:, 0]),
            lead_view(normal(mx, nx, m1, kx, 2).permute(2, 3, 0, 1, 4)),
            lead_view(both[:, 1]),
            lead_view(normal(mx, 2, nx, m1).permute(3, 0, 2, 1)),
            normal(*lead, ntr, kx, mx, nx, 2))
    corr = OrographicCorrection(
        tcorh=normal(mx, nx, 2),
        qcorh=lead_view(normal(mx, 2, nx, m1).permute(3, 0, 2, 1)))
    return sc, dc, ic, state, tend, corr


def booted(model, start, members=None):
    """The booted state of one model, or the initial state of a
    ``members``-member ensemble (base seed 0), its innovation sources, and
    its replayed day as the run paths run it: (state, noise, a call of
    ``run_fast``, or ``run_days`` for an ensemble, over one day)."""
    if members is None:
        state = model.initialize(start)
        return (state, model.sppt_noise,
                lambda: model.run_fast(start, 1, state=state))
    ens = Ensemble(model, members)
    state = ens.initialize(start)
    return state, ens.noise, lambda: ens.run_days(state, start, 1)


def capture_day(model, state, start, **variant):
    """The model's captured day for ``state`` (the fast variant, or the
    one ``variant`` names: ``collect_output``, ``grids``), loaded with it
    and the first day staged, captured. Returns (captured day, seconds of
    the warm-up day and the capture, bytes of the model's graph memory
    pool after it)."""
    cd = model.captured_day(state, **variant)
    cd.load(state)
    cd.set_days(model.make_ds_days(start, start, 1)[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cd.capture()
    torch.cuda.synchronize()
    return cd, time.perf_counter() - t0, pool_bytes(model.graph_pool)


def sppt_noise(seed):
    """A source of standard-normal innovations from a numpy seed."""
    rng = np.random.default_rng(seed)
    return lambda shape: rng.standard_normal(shape)


@contextlib.contextmanager
def sync_error():
    """Any host synchronisation not marked deliberate
    (models/captured.py ``host_sync``) raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def side_eager_day(model, state, start, noise, collect_output=False,
                   grids=False, date=None):
    """One day of the module-level run_day (eager) from ``date`` (default
    ``start``, the run's start), on a side stream, as the captured day
    runs on one, with diagnostics every ``cfg.diag_every`` steps or, with
    ``collect_output``, every step, and with ``grids`` every step's
    gridded fields: run_day's (state, diagnostics, grids)."""
    cfg = model.cfg
    cur, side = torch.cuda.current_stream(), torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = run_day(cfg, model.pp, model.lsp, model.mc, state,
                      model.date_scalars(date or start, start),
                      1 if collect_output else cfg.diag_every, noise,
                      grids)
    cur.wait_stream(side)
    torch.cuda.synchronize()
    return out


def replay_vs_eager(model, start, members=None, collect_output=False,
                    grids=False):
    """One day from the booted state replayed (under the sync debug mode
    "error", after its capture) and run eagerly, in the fast variant or,
    with ``collect_output``, the output variant (every step's diagnostics
    and, with ``grids``, gridded fields, against run_day's with
    diagnostics every step): (equal in every state leaf and output, what
    differs, capture seconds)."""
    state, noise, _ = booted(model, start, members)
    cd, capture_s, _ = capture_day(model, state, start,
                                   collect_output=collect_output, grids=grids)
    with sync_error():
        cd.advance(0, noise)
    replayed = cd.result()
    eager, diags, fields = side_eager_day(model, state, start, noise,
                                          collect_output, grids)
    differ = [f"leaf {i}" for i, (a, b) in enumerate(zip(leaves(replayed),
                                                         leaves(eager)))
              if not torch.equal(a, b)]
    if collect_output:
        ref = {f: torch.stack([getattr(d, f) for d in diags])
               for f in Diagnostics._fields}
        if grids:
            ref.update({k: torch.stack([g[k] for g in fields])
                        for k in GRID_FIELDS})
        out = cd.outputs()
        differ += [k for k, v in ref.items()
                   if not np.array_equal(out.pop(k), v.cpu().numpy())]
        differ += [f"{k} unexpected" for k in out]
    return not differ, differ, capture_s


K1_SW = re.compile(r"column_physics_kernel(<[^,]+, ?\d+, ?true"
                   r"|I[fd]Li\d+ELb1)")


def k1_in_trace(fn):
    """The kernels of one call of ``fn`` in a profiler trace: (K1 kernels,
    K1 SW kernels, all kernels)."""
    names = [n for n, _ in trace(fn)[1]]
    k1 = [n for n in names if "column_physics" in n]
    return len(k1), sum(1 for n in k1 if K1_SW.search(n)), len(names)


def sst_replay_vs_eager(model, first, days):
    """``days`` days of an SST-anomaly ``model`` from ``first``: run_fast
    (replayed, under the sync debug mode "error", capture included)
    against the module-level run_day day by day on a side stream, with the
    window reset to ``first``'s and shifted by hand at each later month
    start. Returns (leaves that differ, whether the window shifted the same
    in both, end date, seconds of run_fast)."""
    state = model.initialize(first)
    window0 = model.mc.clim.sstan3.clone()
    t0 = time.perf_counter()
    with sync_error():
        replayed = model.run_fast(first, days, state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    window1 = model.mc.clim.sstan3.clone()
    model.set_anomaly_window(first)
    eager, date = state, first
    for _ in range(days):
        if date.day == 1 and date != first:
            model.advance_anomaly_window(first, date)
        eager, _, _ = side_eager_day(model, eager, first, None, date=date)
        for _ in range(model.cfg.nsteps):
            date = cal.newdate(date, model.cfg.nsteps)
    differ = [i for i, (a, b) in enumerate(zip(leaves(replayed),
                                               leaves(eager)))
              if not torch.equal(a, b)]
    shifted = (not torch.equal(window0, window1)
               and torch.equal(window1[:2], window0[1:])
               and torch.equal(window1, model.mc.clim.sstan3))
    return differ, shifted, date, wall


def accumulate_vs_eager(model, start, days=2):
    """The accumulating captured day (run_multiyear's) replayed over
    ``days`` days under the sync debug mode "error" against the same days
    of the eager module-level run_day with its fluxes, on a side stream,
    summed as the day sums them: (equal in every state leaf and sum, what
    differs)."""
    cfg = model.cfg
    state = model.initialize(start)
    cd = model.captured_day(state, accumulate=True)
    cd.load(state)
    cd.set_days(model.make_ds_days(start, start, days)[0])
    cd.reset_accumulators()
    cd.capture()
    with sync_error():
        for day in range(days):
            cd.advance(day)
    acc, _ = cd.accumulated(days)
    replayed = cd.result()
    cur, side = torch.cuda.current_stream(), torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        sums = {k: torch.zeros_like(v) for k, v in cd.acc.items()}
        date, s = start, state
        for _ in range(days):
            s, _, _, fl = run_day(cfg, model.pp, model.lsp, model.mc, s,
                                  model.date_scalars(date, start),
                                  cfg.diag_every, collect_fluxes=True)
            g = gridded_fields(cfg, model.mc, s.prog)
            for k in ACC_GRIDS:
                sums[k].add_(g[k])
            for k in ACC_FLUXES:
                sums[k].add_(step_sum(list(getattr(fl, k))))
            date = cal.next_day(date)
    cur.wait_stream(side)
    torch.cuda.synchronize()
    differ = [f"leaf {i}" for i, (a, b) in enumerate(zip(leaves(replayed),
                                                         leaves(s)))
              if not torch.equal(a, b)]
    differ += [k for k, v in sums.items()
               if not np.array_equal(acc[k], v.cpu().numpy())]
    return not differ, differ


def band_inputs(ins, rows):
    """K1's inputs (fused.kernel_inputs order) cut to the latitude rows
    ``rows``: the [il] fields sliced, ablco2 as it is, the others on
    their latitude axis, contiguous."""
    return [x if i == 22 else x[rows].contiguous()
            if i in fused.LAT_INPUTS
            else x[..., rows, :].contiguous() for i, x in enumerate(ins)]
