"""One model's step on the card: the numbers to hold two checkouts to.

    python speedy_tpu_torch/bench_step.py

Builds the T30 fp32 model on CUDA from the stand-in boundary set, with
SPPT off and on. For each it warms up one day, then REPEATS times
initialises and times 2 days of ``run_fast`` on the host clock (ending in
a synchronise; ``chip_smoke.py`` [5] and [7] time the same), counting the
column-physics kernel's launches, and traces one more day with
torch.profiler for the device time, the kernel launches and the PyTorch
operators (``aten::`` events, nested ones included) per step.
Then it times the column-physics wrapper's eager call on the booted
state's physics inputs, SW and non-SW: the whole wrapper
(``fused_grid_physics``, inputs gathered and checked, kernel launched)
and ``launch_kernel`` alone, over EAGER_CALLS calls each. Prints one JSON
line per SPPT setting beside the card's name and power limit. Needs a
CUDA device.

It reads only what every version of the package has (``Model``,
``run_fast``, ``fused.fused_grid_physics``, ``kernel_inputs``,
``launch_kernel``), so run as a file with another checkout's package
first on ``PYTHONPATH`` it measures that checkout.
"""
from __future__ import annotations

import json
import sys
import time

import torch

REPEATS = 3
EAGER_CALLS = 200


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
    model.run_fast(start, 1)                       # warm-up day
    days_per_min, ms_per_step = [], []
    for _ in range(REPEATS):
        state = model.initialize(start)
        fused.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = model.run_fast(start, 2, state=state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        days_per_min.append(2 / (wall / 60.0))
        ms_per_step.append(wall / (2 * nsteps) * 1e3)
    k1_launches = fused.launches

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        model.run_fast(start, 1, state=state)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in kernels)
    n_ops = sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith("aten::"))

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
    return dict(sppt=sppt, sim_days_per_min=days_per_min,
                ms_per_step=ms_per_step, k1_launches_2_days=k1_launches,
                device_ms_per_step=dev_us / nsteps / 1e3,
                launches_per_step=len(kernels) / nsteps,
                aten_ops_per_step=n_ops / nsteps, **eager)


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
