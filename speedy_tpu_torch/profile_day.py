"""Where one simulated day's time goes on the card, replayed and eager.

    python -m speedy_tpu_torch.profile_day [--precision fp32] [--sppt]
        [--members N]

Builds the T30 model on CUDA from the stand-in boundary set and measures
its day with ``bench_step.day_times``: the warm-up day and the capture
timed, then the eager day (the module-level ``run_day``, with the day's
date inputs made and the guard checked, as the eager ``run_fast`` ran a
day) and the replayed day (``Model.run_fast`` of one day, each day one
replay of the captured graph) in turns, ``bench_step.REPEATS`` times each,
from the same booted state. Prints the median and range of sim-days/min of
each, then, from one traced day of each with torch.profiler, the wall time
per step, the device time summed over CUDA kernels, the device's busy
share, the kernel launches per step and the kernels that take the most
device time, with the column-physics kernel's share. ``--sppt`` runs the
model with SPPT on. ``--members N`` (N > 1) runs an ensemble of N members
(parallel.Ensemble.run_days for the replayed day, each member with its own
SPPT seed) instead of one model, and reports member-days/min. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
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

    from .bench_step import REPEATS, day_times
    from .bench_transform import card_line
    from .config import t30
    from .models.model import Model
    from .utils import calendar as cal
    from .utils.synthetic_bc import synthetic_boundaries

    torch.backends.cuda.matmul.allow_tf32 = False
    model = Model(t30(precision=args.precision, sppt_on=args.sppt),
                  device="cuda", bc_arrays=synthetic_boundaries(0))
    nsteps, members = model.cfg.nsteps, args.members
    rec = day_times(model, cal.Datetime(1982, 1, 1),
                    members if members > 1 else None)
    rate = {k: [members * 60.0 / t for t in rec[k]]
            for k in ("eager", "replayed")}

    card = card_line()   # name and power limit
    unit = "sim-days/min" if members == 1 else "member-days/min"
    print(f"{card}: {args.precision} T30{' SPPT' if args.sppt else ''}, "
          f"{members} member{'s' if members > 1 else ''}; warm-up day and "
          f"capture {rec['capture_s']:.3f} s, graph pool "
          f"{rec['pool_bytes'] / 2**20:.1f} MiB")
    for name in ("eager", "replayed"):
        r, p = rate[name], rec["profiles"][name]
        print(f"{name}: {unit} median {np.median(r):.1f} (range "
              f"{min(r):.1f}-{max(r):.1f}, {REPEATS} days), "
              f"{np.median(rec[name]) / nsteps * 1e3:.3f} ms/step")
        if p["busy_share"] is None:
            print("  device time: not measured (the profiler saw no CUDA "
                  "kernels)")
            continue
        p["busy_share_unprofiled"] = (p["device_ms_per_step"] * nsteps
                                      * 1e-3 / float(np.median(rec[name])))
        print(f"  profiled day {p['ms_per_step_profiled']:.3f} ms/step; "
              f"device kernel time {p['device_ms_per_step']:.3f} ms/step, "
              f"busy share {p['busy_share']:.3f} of the profiled day, "
              f"{p['busy_share_unprofiled']:.3f} of the median day, "
              f"{p['launches_per_step']:.1f} kernel launches per step; "
              f"column_physics {p['column_physics_us_per_step']:.2f} "
              f"us/step ({p['column_physics_share']:.4f} of device time)")
        for kname, n, t in p["top"]:
            print(f"  {t:9.2f} us/step {n:6.1f}/step  {kname[:90]}")
    if "predraw_host_s" in rec:
        print(f"SPPT pre-draw of a day: {rec['predraw_host_s'] * 1e3:.2f} ms "
              f"host, {rec['predraw_device_s'] * 1e3:.2f} ms device")
    print(json.dumps({
        "members": members, "sppt": args.sppt, "precision": args.precision,
        "repeats": REPEATS, "unit": unit,
        **{k: v for k, v in rec.items()
           if k not in ("eager", "replayed", "profiles")},
        **{f"{k}_rate": v for k, v in rate.items()},
        **{f"{k}_{f}": v for k, p in rec["profiles"].items()
           for f, v in p.items() if f != "top"},
        "device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
