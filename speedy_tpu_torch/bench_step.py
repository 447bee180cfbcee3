"""One day on the card, eager and replayed: the numbers to hold two
checkouts to.

    python speedy_tpu_torch/bench_step.py

Builds the T30 fp32 model on CUDA from the stand-in boundary set, with
SPPT off and on, and measures its day with ``day_times``: the warm-up day
and the capture timed, then the eager day and the replayed day in turns,
REPEATS times each, each reported as the median and range, with one
profiled day of each (device time, kernel launches and PyTorch operators
per step). Then it times the column-physics wrapper's eager call on the
booted state's physics inputs, SW and non-SW: the whole wrapper
(``fused_grid_physics``, inputs gathered and checked, kernel launched)
and ``launch_kernel`` alone, over EAGER_CALLS calls each. Prints one JSON
line per SPPT setting beside the card's name and power limit. Needs a
CUDA device.

``day_times`` is also how ``profile_day`` and ``chip_smoke.py`` [10] time
the day. This file reads only what the package has had since its day was
captured (``Model.captured_day``, ``run_day``, ``parallel.Ensemble``,
``diagnostics.check_days``, ``sppt.draw_day``, ``fused``'s counters), so
run as a file with another such checkout's package first on
``PYTHONPATH`` it measures that checkout.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

REPEATS = 20
EAGER_CALLS = 200


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


def device_profile(fn, nsteps: int) -> dict:
    """One call of ``fn`` (a day) traced: wall ms/step, device kernel
    ms/step, busy share, launches and ``aten::`` operators per step, the
    column-physics kernel's µs/step and share, and the top kernels by
    device time."""
    wall, kernels, n_ops = trace(fn)
    dev_us = sum(t for _, t in kernels)
    by_name = {}
    for name, t in kernels:
        n, total = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, total + t)
    k1 = sum(t for name, (_, t) in by_name.items() if "column_physics" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return dict(ms_per_step_profiled=wall / nsteps * 1e3,
                device_ms_per_step=dev_us / nsteps / 1e3,
                busy_share=dev_us * 1e-6 / wall if kernels else None,
                launches_per_step=len(kernels) / nsteps,
                aten_ops_per_step=n_ops / nsteps,
                column_physics_us_per_step=k1 / nsteps,
                column_physics_share=k1 / dev_us if kernels else None,
                top=[(name, n / nsteps, t / nsteps)
                     for name, (n, t) in top])


def booted(model, start, members=None):
    """The booted state of one model, or the initial state of a
    ``members``-member ensemble (base seed 0), its innovation sources, and
    its replayed day as the run paths run it: (state, noise, a call of
    ``run_fast``, or ``run_days`` for an ensemble, over one day)."""
    if members is None:
        state = model.initialize(start)
        return (state, model.sppt_noise,
                lambda: model.run_fast(start, 1, state=state))
    from speedy_tpu_torch.parallel.ensemble import Ensemble
    ens = Ensemble(model, members)
    state = ens.initialize(start)
    return state, ens.noise, lambda: ens.run_days(state, start, 1)


def capture_day(model, state, start, **variant):
    """The model's captured day for ``state`` (the fast variant, or the
    one ``variant`` names: ``collect_output``, ``grids``), loaded with it
    and the first day staged, captured. Returns (captured day, seconds of
    the warm-up day and the capture, bytes of the model's graph memory
    pool after it)."""
    from speedy_tpu_torch.models.captured import pool_bytes
    cd = model.captured_day(state, **variant)
    cd.load(state)
    cd.set_days(model.make_ds_days(start, start, 1)[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cd.capture()
    torch.cuda.synchronize()
    return cd, time.perf_counter() - t0, pool_bytes(model.graph_pool)


def eager_day(model, state, start, noise) -> None:
    """One eager day as an eager ``run_fast`` ran it: the module-level
    ``run_day`` with the day's date inputs made, then the stability guard
    on its extrema (one host synchronisation)."""
    from speedy_tpu_torch.models.model import run_day
    from speedy_tpu_torch.utils.diagnostics import check_days, guard_extrema
    cfg = model.cfg
    _, diags, _ = run_day(cfg, model.pp, model.lsp, model.mc, state,
                          model.date_scalars(start, start), cfg.diag_every,
                          noise)
    check_days(guard_extrema(diags).cpu().numpy()[None])


def day_times(model, start, members=None) -> dict:
    """The day of one model, or of a ``members``-member ensemble, from its
    booted state: captured first (timed), then the eager day
    (``eager_day``) and the replayed day (``booted``'s call, one replay)
    in turns, REPEATS times each, on the host clock ending in a
    synchronise; then one profiled day of each (``device_profile``).
    Returns the seconds of each day (``eager``, ``replayed``), the
    capture's seconds, the model's graph pool and all reserved bytes, the
    column-physics launches of one replayed day by the wrapper's counters
    (all, SW), the profiles and, with SPPT, the pre-draw of a day's
    innovations: its host time (median of REPEATS) and its kernels' device
    time (a profiler trace)."""
    from speedy_tpu_torch.models.physics.sppt import draw_day
    from speedy_tpu_torch.utils import tracing
    cfg = model.cfg
    state, noise, replay = booted(model, start, members)
    cd, capture_s, pool = capture_day(model, state, start)
    eager = lambda: eager_day(model, state, start, noise)
    times = {"eager": [], "replayed": []}
    for _ in range(REPEATS):
        for name, fn in (("eager", eager), ("replayed", replay)):
            torch.cuda.synchronize()
            tracing.reset()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    # the last replay's
    k1_launches = (tracing.counters["k1.launches"],
                   tracing.counters["k1.launches_sw"])
    rec = dict(times, capture_s=capture_s, pool_bytes=pool,
               reserved_bytes=torch.cuda.memory_reserved(),
               k1_launches=k1_launches,
               profiles={"eager": device_profile(eager, cfg.nsteps),
                         "replayed": device_profile(replay, cfg.nsteps)})
    if cfg.sppt_on:
        draw = lambda: draw_day(state.sppt.generator, noise, cd.eta)
        host = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            draw()
            host.append(time.perf_counter() - t0)
        rec.update(predraw_host_s=float(np.median(host)),
                   predraw_device_s=sum(t for _, t in trace(draw)[1]) * 1e-6)
    return rec


def physics_call(model, start):
    """The physics call's arguments at the booted state:
    (daily, surf, rad, pg)."""
    from speedy_tpu_torch.models import tendencies as tend
    from speedy_tpu_torch.models.geopotential import get_geopotential
    state = model.initialize(start)
    daily = model.daily_forcing(state, start, start)
    mc, cfg = model.mc, model.cfg
    phi0 = get_geopotential(mc.dyn.gc, state.prog.t[0], mc.dyn.phis)
    pg = tend.grid_dynamics_tendencies(cfg, mc.dyn, mc.ic_2dt, state.prog,
                                       1, phi0)[1]
    return daily, state.surf, state.rad, pg


def measure(sppt: bool, bc, start) -> dict:
    from speedy_tpu_torch.bench_transform import time_ms
    from speedy_tpu_torch.config import t30
    from speedy_tpu_torch.models.model import Model
    from speedy_tpu_torch.models.physics import fused

    model = Model(t30(sppt_on=sppt), device="cuda", bc_arrays=bc)
    cfg, nsteps = model.cfg, model.cfg.nsteps
    rec = day_times(model, start)
    daily, surf, rad, pg = physics_call(model, start)
    eager = {}
    for sw in (True, False):
        v = "sw" if sw else "nosw"
        wrapper = lambda: fused.fused_grid_physics(cfg, model.pp, sw, daily,
                                                   surf, rad, pg)
        ins = fused.kernel_inputs(cfg, model.pp, sw, daily, surf, rad, pg)
        launch = lambda: fused.launch_kernel(cfg, sw, ins,
                                             model.pp.kernel_block)
        eager[f"wrapper_{v}_us"] = time_ms(wrapper, EAGER_CALLS) * 1e3
        eager[f"launch_{v}_us"] = time_ms(launch, EAGER_CALLS) * 1e3
    spread = lambda v: dict(median=float(np.median(v)), min=min(v),
                            max=max(v))
    rate = {k: [60.0 / t for t in rec[k]] for k in ("eager", "replayed")}
    return dict(sppt=sppt, sim_days_per_min=spread(rate["replayed"]),
                ms_per_step=spread([t / nsteps * 1e3
                                    for t in rec["replayed"]]),
                eager_day_sim_days_per_min=spread(rate["eager"]),
                k1_launches_day=rec["k1_launches"][0],
                capture_s=rec["capture_s"], pool_bytes=rec["pool_bytes"],
                **{f"{k}_{f}": v for k, p in rec["profiles"].items()
                   for f, v in p.items() if f != "top"},
                **eager)


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_step: CUDA is not available", file=sys.stderr)
        return 2
    import speedy_tpu_torch
    from speedy_tpu_torch.bench_transform import card_line
    from speedy_tpu_torch.utils import calendar as cal
    from speedy_tpu_torch.utils.synthetic_bc import synthetic_boundaries
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card)
    bc = synthetic_boundaries(0)
    start = cal.Datetime(1982, 1, 1)
    for sppt in (False, True):
        rec = measure(sppt, bc, start)
        rec.update(package=speedy_tpu_torch.__path__[0], device=card)
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
