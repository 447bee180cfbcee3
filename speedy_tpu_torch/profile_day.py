"""Where one simulated day's time goes on the card.

    python -m speedy_tpu_torch.profile_day [--precision fp32] [--sppt]
        [--members N]

Builds the T30 model on CUDA from the stand-in boundary set, runs one warm
day, then times one more day on the host clock (ending in a
synchronise) and traces a third with torch.profiler. Prints the wall time
per step, the device time summed over CUDA kernels, the device's busy
share, the number of kernel launches per step, and the kernels that take
the most device time, with the column-physics kernel's share. ``--sppt``
runs the model with SPPT on. ``--members N`` (N > 1) runs an ensemble of N
members (parallel.Ensemble.run_days, each member with its own SPPT seed)
instead of one model, and adds member-days/min. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--precision", default="fp32", choices=("fp32", "fp64"))
    ap.add_argument("--sppt", action="store_true", help="SPPT on")
    ap.add_argument("--members", type=int, default=1,
                    help="ensemble members (1: one model)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_day: CUDA is not available", file=sys.stderr)
        return 2

    from .config import t30
    from .models.model import Model
    from .utils import calendar as cal
    from .utils.synthetic_bc import synthetic_boundaries

    model = Model(t30(precision=args.precision, sppt_on=args.sppt),
                  device="cuda",
                  bc_arrays=synthetic_boundaries(0))
    start = cal.Datetime(1982, 1, 1)
    nsteps, members = model.cfg.nsteps, args.members
    if members > 1:
        from .parallel.ensemble import Ensemble
        ens = Ensemble(model, members)
        day = lambda s: ens.run_days(s, start, 1)[0]
        state = day(ens.initialize(start))    # warm-up day
    else:
        day = lambda s: model.run_fast(start, 1, state=s)
        state = model.run_fast(start, 1)      # warm-up day

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = day(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        day(state)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t1

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    k1 = sum(t for name, (n, t) in by_name.items()
             if "column_physics" in name)
    from .bench_transform import card_line
    card = card_line()   # name and power limit
    print(f"{card}: {args.precision} T30{' SPPT' if args.sppt else ''}, "
          f"{members} member{'s' if members > 1 else ''}, 1 day, "
          f"{wall / nsteps * 1e3:.3f} ms/step wall "
          f"({60.0 / wall:.1f} sim-days/min, "
          f"{members * 60.0 / wall:.1f} member-days/min); profiled "
          f"{wall_prof / nsteps * 1e3:.3f} ms/step")
    if not kernels:
        print("device time: not measured (the profiler saw no CUDA kernels)")
        return 0
    busy = dev_us * 1e-6 / wall_prof
    print(f"device kernel time {dev_us / nsteps / 1e3:.3f} ms/step, busy "
          f"share {busy:.3f}, {len(kernels) / nsteps:.1f} kernel launches "
          f"per step; column_physics {k1 / nsteps:.2f} us/step "
          f"({k1 / dev_us:.4f} of device time)")
    for name, (n, t) in top:
        print(f"  {t / nsteps:9.2f} us/step {n / nsteps:6.1f}/step  "
              f"{name[:90]}")
    print(json.dumps({"ms_per_step_wall": wall / nsteps * 1e3,
                      "device_ms_per_step": dev_us / nsteps / 1e3,
                      "busy_share": busy,
                      "launches_per_step": len(kernels) / nsteps,
                      "column_physics_us_per_step": k1 / nsteps,
                      "column_physics_share": k1 / dev_us,
                      "members": members,
                      "member_days_per_min": members * 60.0 / wall,
                      "sppt": args.sppt, "device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
