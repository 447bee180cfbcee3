"""Multi-year climatology with the monthly means accumulated on the device
(the JAX package's scripts/run_multiyear.py; BASELINE config 2 at full
depth).

    python -m speedy_tpu_torch.run_multiyear --years 6 --synthetic-bc 0
    python -m speedy_tpu_torch.run_multiyear --years 2 --elnino \\
        --synthetic-bc 0

Runs N years (default 6: one spin-up year, then the climatology) month by
month. A month is one chunk of replays of the accumulating captured day
(models/captured.py, ``accumulate``): each replay adds the day-end
gridded u and T and the step-summed precnv, precls, olr, tsr and ssr into
static buffers, which are zeroed at the month's start and reach the host
with the month's guard rows in one copy. The guard is checked on every
day of the month. With SST-anomaly forcing the anomaly window shifts at
each month start, as the JAX script's run_years does.

The months are saved (``--out``, an object array of per-month dicts)
before the summary: one JSON line ``climatology_{preset}_{years}y`` with
the JAX script's DJF/JJA table (jet maximum and its latitude at sigma
nearest 0.2, global precipitation in mm/day, OLR mean and extrema, the
lowest level's global-mean temperature), numbers unrounded, with the
wall of the whole run (``wall_s``, as the JAX script's) and the
sim-days/min of the months after the first (whose wall, printed on a
line of its own, holds the initialize, the warm-up day and the capture).
``--elnino``
repeats the run with a constant +2 K anomaly weighted by the El Nino
domain mask (sea_model.f90:499-519), given to the model in memory as the
anomaly file, and prints ``elnino_response_DJF``. A last line gives the
months run, the host copies of the accumulating days and the
column-physics kernel launches.
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
ELNINO_K = 2.0


def run_month(model, cd, date: cal.Datetime, start: cal.Datetime,
              n_days: int, first_day: int = 0):
    """One month of ``n_days`` days from ``date`` (run began at ``start``)
    on the accumulating captured day ``cd``, which holds the state: its
    sums zeroed, the days replayed as one chunk, then the sums and the
    guard rows in one host copy and the guard checked on every day (days
    named from ``first_day``). Returns (the month's means: year, month, u
    and t [..., kx, il, ix] from the day ends, precip (precnv + precls),
    olr, tsr, ssr [..., il, ix] from every step; the next date)."""
    from .utils.diagnostics import check_days
    cd.reset_accumulators()
    next_date = model.run_staged(cd, date, start, n_days, model.sppt_noise,
                                 check=False, max_chunk_days=n_days)
    acc, rows = cd.accumulated(n_days)
    check_days(rows, first_day)
    steps = n_days * model.cfg.nsteps
    return dict(year=date.year, month=date.month,
                u=acc["u"] / n_days, t=acc["t"] / n_days,
                precip=(acc["precnv"] + acc["precls"]) / steps,
                olr=acc["olr"] / steps, tsr=acc["tsr"] / steps,
                ssr=acc["ssr"] / steps), next_date


def run_years(model, start: cal.Datetime, n_years: int, say=print):
    """``n_years`` from ``start`` month by month (``run_month``) ->
    (the months' means, the final state, the accumulating captured
    day). With SST-anomaly forcing the window shifts before each month
    after the first."""
    state = model.initialize(start)
    cd = model.captured_day(state, accumulate=True)
    cd.load(state)
    date, day, months = start, 0, []
    for im in range(12 * n_years):
        if model.cfg.sst_anomaly_forcing and im > 0:
            # the JAX script's monthly shift; the month read follows the
            # run's start year (the reference's quirk)
            model.advance_anomaly_window(start, date)
        nd = cal.NDAYCAL[date.month - 1]
        month, next_date = run_month(model, cd, date, start, nd, day)
        months.append(month)
        say(f"  {date.year}-{date.month:02d} done "
            f"(olr mean {month['olr'].mean():.1f})", flush=True)
        date, day = next_date, day + nd
    return months, cd.result(), cd


def season_mean(months, season, skip_years=None):
    if skip_years is None:  # single-year runs have no spin-up year to drop
        n_years = len({m["year"] for m in months})
        skip_years = 1 if n_years > 1 else 0
    sel = {"DJF": (12, 1, 2), "JJA": (6, 7, 8)}[season]
    first_year = min(m["year"] for m in months)
    picked = [m for m in months
              if m["month"] in sel and m["year"] >= first_year + skip_years]
    return {k: np.mean([m[k] for m in picked], axis=0)
            for k in ("u", "t", "precip", "olr")}


def area_weights(model) -> np.ndarray:
    """Gaussian weights of the il latitudes, normalised to sum 1."""
    wt = model.sp_np["wt"]
    wfull = np.concatenate([wt, wt[::-1]])
    return wfull / wfull.sum()


def summary(model, months) -> dict:
    """The JAX script's DJF/JJA table (scripts/run_multiyear.py:193-215),
    unrounded."""
    geom = model.geom_np
    kjet = int(np.argmin(np.abs(geom["fsg"] - JET_SIGMA)))
    wfull = area_weights(model)
    lats = np.degrees(geom["radang"])
    gm = lambda f: float((f.mean(axis=-1) * wfull).sum())
    out = {}
    for season in ("DJF", "JJA"):
        s = season_mean(months, season)
        jet = s["u"].mean(axis=-1)[kjet]
        out[season] = dict(
            jet_max_ms=float(jet.max()),
            jet_max_lat=float(lats[int(jet.argmax())]),
            precip_global_mmday=gm(s["precip"]) * 86.4,
            olr_global_Wm2=gm(s["olr"]),
            olr_min_Wm2=float(s["olr"].min()),
            olr_max_Wm2=float(s["olr"].max()),
            t_sfc_global_K=gm(s["t"][model.cfg.kx - 1]))
    return out


def elnino_mask(cfg, geom) -> np.ndarray:
    """The El Nino domain's weight mask [il, ix], south -> north."""
    from .models.coupling import sea_domain
    wmask = np.zeros((cfg.il, cfg.ix))
    sea_domain("elnino", np.degrees(geom["radang"]), cfg.ix, wmask)
    return wmask


class _BoundaryFiles(dict):
    """The boundary files on ``search`` as ``{file: {var: array}}``, each
    file read on first use (the form ``Model(bc_arrays=...)`` takes)."""

    def __init__(self, search):
        super().__init__()
        self.search = search

    def __missing__(self, name):
        import h5py
        from .utils.io import find_boundary_file
        with h5py.File(find_boundary_file(name, self.search), "r") as f:
            self[name] = {k: f[k][()] for k in f}
        return self[name]


def with_anomaly(bc: dict, ssta: np.ndarray) -> dict:
    """Model keyword arguments ``bc`` (cli.boundary_kwargs) with the
    SST-anomaly file replaced by the constant monthly field ``ssta``
    [il, ix] (south -> north); the file, as the loader reads it, runs
    north -> south."""
    from .utils.io import ANOMALY_FILE, ANOMALY_MONTHS
    arrays = bc.get("bc_arrays")
    arrays = dict(arrays) if arrays is not None \
        else _BoundaryFiles(bc.get("bc_search"))
    arrays[ANOMALY_FILE] = dict(ssta=np.broadcast_to(
        ssta[::-1], (ANOMALY_MONTHS,) + ssta.shape))
    return dict(bc_arrays=arrays)


def main(argv=None) -> int:
    from .models.model import Model
    from .utils import tracing
    ap = argparse.ArgumentParser(prog="python -m speedy_tpu_torch."
                                      "run_multiyear")
    ap.add_argument("--years", type=int, default=6)
    ap.add_argument("--preset", default="t30", choices=sorted(PRESETS))
    ap.add_argument("--elnino", action="store_true")
    ap.add_argument("--out", default="speedy_climatology.npz")
    add_boundary_args(ap)
    args = ap.parse_args(argv)

    bc = boundary_kwargs(args)
    cfg = from_preset(args.preset, precision="fp32")
    model = Model(cfg, device=args.device, **bc)
    tracing.reset()
    t0 = time.time()
    print(f"control run: {args.years} years {args.preset}L{cfg.kx}")
    ends = []       # the host clock at each month's end (after its copy)

    def say(*a, **k):
        ends.append(time.time())
        print(*a, **k)

    months, _, cd = run_years(model, START, args.years, say)
    synchronize(model)
    wall = time.time() - t0
    copies = cd.host_copies
    # the first month's wall holds the initialize, the warm-up day and the
    # capture; the rate is over the months after it
    rest_days = sum(cal.NDAYCAL[m["month"] - 1] for m in months[1:])
    print(f"first month {ends[0] - t0:.3f} s (initialize, warm-up day and "
          f"capture included)")

    # saved before the summary, so that a fault there cannot lose the run
    np.savez(args.out, months=np.array(months, dtype=object))
    print(json.dumps({"metric": f"climatology_{args.preset}_{args.years}y",
                      "wall_s": wall,
                      "sim_days_per_min":
                          rest_days / (ends[-1] - ends[0]) * 60.0,
                      **summary(model, months)}))

    n_months = len(months)
    if args.elnino:
        print(f"El Nino experiment: +{ELNINO_K:g} K weighted anomaly via the "
              "anomaly file (in memory)")
        wmask = elnino_mask(cfg, model.geom_np)
        cfg_en = from_preset(args.preset, precision="fp32",
                             sst_anomaly_forcing=True)
        model_en = Model(cfg_en, device=args.device,
                         **with_anomaly(bc, ELNINO_K * wmask))
        t0 = time.time()
        months_en, _, cd_en = run_years(model_en, START, args.years)
        synchronize(model_en)
        copies += cd_en.host_copies
        n_months += len(months_en)
        c = season_mean(months, "DJF")
        e = season_mean(months_en, "DJF")
        dprec = (e["precip"] - c["precip"]) * 86.4
        w = wmask / max(wmask.sum(), 1)
        wfull = area_weights(model)
        kx = cfg.kx
        print(json.dumps({
            "metric": "elnino_response_DJF",
            "wall_s": time.time() - t0,
            "dprecip_nino_region_mmday": float((dprec * w).sum()),
            "dprecip_global_mmday":
                float((dprec.mean(axis=-1) * wfull).sum()),
            "dt_sfc_nino_K": float(((e["t"][kx - 1] - c["t"][kx - 1])
                                    * w).sum())}))
    print(f"{n_months} months, {copies} host copies of the accumulating "
          f"days, column-physics kernel launches "
          f"{tracing.counters['k1.launches']} "
          f"(sw {tracing.counters['k1.launches_sw']}) on {model.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
