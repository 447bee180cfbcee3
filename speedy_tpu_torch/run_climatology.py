"""Climatology validation run (the JAX package's scripts/run_climatology.py,
BASELINE config 2: 1-year T30L8).

    python -m speedy_tpu_torch.run_climatology --days 365 --synthetic-bc 0

Runs N simulated days with ``Model.run_fast`` (each day one replay of the
captured day on CUDA), then prints one JSON line of climate sanity
statistics with the JAX script's keys: the wall time of ``run_fast`` and
sim-days/min, the global-mean lowest-level temperature at the end, the
zonal-mean zonal wind extrema at the jet level (sigma nearest 0.2; a
healthy SPEEDY climate has ~20-60 m/s westerly subtropical jets, Molteni
2003), the surface-pressure extrema and finiteness. The initialisation
and the warm-up day and capture are timed on an earlier line. Numbers are
printed unrounded. ``climate_stats`` is the one place these statistics are
computed (stability_gate.py and fp32_qualification.py use it too).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .cli import add_boundary_args, boundary_kwargs, synchronize
from .config import PRESETS, from_preset
from .utils import calendar as cal

START = cal.Datetime(1982, 1, 1)
JET_SIGMA = 0.2


def climate_stats(model, prog) -> dict:
    """End-of-run statistics of one model's prognostic state ``prog``
    (level 0), as the JAX scripts compute them
    (scripts/stability_gate.py:62-70, scripts/run_climatology.py:56-74):
    the Gaussian-weighted global mean of the lowest level's temperature
    (K), the level nearest sigma = 0.2 and the extrema of the zonal-mean
    zonal wind there (m/s), the extrema of surface pressure (Pa), and
    whether every gridded field is finite."""
    g = {k: v.cpu().numpy() for k, v in model.gridded_fields(prog).items()}
    fsg = model.geom_np["fsg"]
    kjet = int(np.argmin(np.abs(fsg - JET_SIGMA)))
    ubar = g["u"][kjet].mean(axis=-1)
    wt = model.sp_np["wt"]
    wfull = np.concatenate([wt, wt[::-1]])
    wfull = wfull / wfull.sum()
    t_sfc = float((g["t"][model.cfg.kx - 1].mean(axis=-1) * wfull).sum())
    return dict(t_sfc_global_K=t_sfc, jet_sigma=float(fsg[kjet]),
                jet_max_ms=float(ubar.max()), jet_min_ms=float(ubar.min()),
                ps_min_Pa=float(g["ps"].min()),
                ps_max_Pa=float(g["ps"].max()),
                finite=bool(all(np.isfinite(v).all() for v in g.values())))


def main(argv=None) -> int:
    from .models.model import Model
    ap = argparse.ArgumentParser(prog="python -m speedy_tpu_torch."
                                      "run_climatology")
    ap.add_argument("--days", type=int, default=365)
    ap.add_argument("--preset", default="t30", choices=sorted(PRESETS))
    ap.add_argument("--precision", default="fp32", choices=["fp32", "fp64"])
    add_boundary_args(ap)
    args = ap.parse_args(argv)

    cfg = from_preset(args.preset, precision=args.precision)
    model = Model(cfg, device=args.device, **boundary_kwargs(args))

    t0 = time.time()
    state = model.initialize(START)
    synchronize(model)
    t_init = time.time() - t0
    # the warm-up day and the capture, once, before the timed run
    t0 = time.time()
    cd = model.captured_day(state)
    cd.load(state)
    cd.set_days(model.make_ds_days(START, START, 1)[0])
    cd.capture()
    synchronize(model)
    print(f"initialize {t_init:.3f} s; warm-up day and capture "
          f"{time.time() - t0:.3f} s on {model.device}")

    t0 = time.time()
    state = model.run_fast(START, args.days, state=state)
    synchronize(model)
    wall = time.time() - t0

    s = climate_stats(model, state.prog)
    print(json.dumps({
        "metric": f"climatology_{args.preset}_{args.days}d",
        "days": args.days,
        "wall_s": wall,
        "sim_days_per_min": args.days / wall * 60.0,
        "init_compile_s": t_init,
        "t_sfc_global_mean_K": s["t_sfc_global_K"],
        "u_jet_level_sigma": s["jet_sigma"],
        "u_jet_max_ms": s["jet_max_ms"],
        "u_jet_min_ms": s["jet_min_ms"],
        "ps_minmax_hPa": [s["ps_min_Pa"] / 100, s["ps_max_Pa"] / 100],
        "finite": s["finite"],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
