"""fp32 accuracy qualification (the JAX package's
scripts/fp32_qualification.py).

    python -m speedy_tpu_torch.fp32_qualification --synthetic-bc 0

Parity is certified in fp64, the runs that users time are fp32. This
measures how fast precision-induced trajectory divergence grows against
the physically meaningful uncertainty at the same lead time, the spread of
an SPPT ensemble. Three divergence curves over a DAYS-day run (identical
initial state and forcing), all on ``--device``:

  1. fp64 against fp32                        (part ``precision``)
  2. fp32 with TF32 matmuls against full fp32 matmuls
     (torch.set_float32_matmul_precision "high" against "highest";
     on the CPU the two are the same)          (part ``matmul``)
  3. the spread of a MEMBERS-member fp32 SPPT ensemble, base seed 7
                                              (part ``ensemble``)

Metric: the global RMS of the sigma = 0.51 (k = 4) temperature and of
surface pressure, per day: rms(a - b) and the ensemble spread rms(member
std), then the lead day at which each precision signal crosses 10% / 50%
/ 100% of the spread (part ``report``). Each part saves its daily fields
into ``--out`` (fp32_qual_<part>_<preset>.npz) and prints each run's
end-of-run climate statistics (run_climatology.climate_stats); ``all``
runs the three parts and the report.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .cli import add_boundary_args, boundary_kwargs
from .config import from_preset
from .run_climatology import START, climate_stats
from .utils import calendar as cal

K_MID = 4   # sigma = 0.51
PARTS = ("precision", "matmul", "ensemble")


def _path(out: str, part: str, preset: str) -> str:
    return os.path.join(out, f"fp32_qual_{part}_{preset}.npz")


def run_daily(model, start, n_days, state=None):
    """Day-by-day run keeping (T at K_MID, ps) after each day; returns
    (t [day, il, ix], ps [day, il, ix], the last state). Each day is a
    ``run_fast`` of one day from the day's date, as in the JAX script."""
    snaps = []
    if state is None:
        state = model.initialize(start)
    date = start
    for _ in range(n_days):
        state = model.run_fast(date, 1, state=state, check=False)
        date = cal.next_day(date)
        g = model.gridded_fields(state.prog)
        snaps.append((g["t"][K_MID].cpu().numpy(), g["ps"].cpu().numpy()))
    return (np.stack([s[0] for s in snaps]), np.stack([s[1] for s in snaps]),
            state)


def _report_run(label, model, prog) -> None:
    """One run's end-of-run climate statistics, as a JSON line."""
    print(json.dumps(dict(run=label, **climate_stats(model, prog))))


def part_precision(preset, days, out, device=None, **bc):
    """Curve 1: fp64 and fp32 runs from the same start."""
    from .models.model import Model
    res = {}
    for prec in ("fp64", "fp32"):
        m = Model(from_preset(preset, precision=prec), device=device, **bc)
        t, ps, state = run_daily(m, START, days)
        res[f"t_{prec}"], res[f"ps_{prec}"] = t, ps
        _report_run(prec, m, state.prog)
    np.savez(_path(out, "precision", preset), **res)


def part_matmul(preset, days, out, device=None, **bc):
    """Curve 2: fp32 with TF32 matmuls ("high") and with full fp32
    matmuls ("highest"). Model() turns TF32 off, so the precision is set
    after it is built and before its day is captured; "highest" is left
    set."""
    from .models.model import Model
    res = {}
    try:
        for label, mp in (("tf32", "high"), ("f32mm", "highest")):
            m = Model(from_preset(preset, precision="fp32"), device=device,
                      **bc)
            torch.set_float32_matmul_precision(mp)
            t, ps, state = run_daily(m, START, days)
            res[f"t_{label}"], res[f"ps_{label}"] = t, ps
            _report_run(label, m, state.prog)
    finally:
        torch.set_float32_matmul_precision("highest")
    np.savez(_path(out, "matmul", preset), **res)


def part_ensemble(preset, days, out, members, device=None, **bc):
    """Curve 3: a ``members``-member fp32 SPPT ensemble, base seed 7, its
    members' daily fields [day, member, il, ix]."""
    from .models.model import Model
    from .parallel.ensemble import Ensemble
    m = Model(from_preset(preset, precision="fp32", sppt_on=True),
              device=device, **bc)
    ens = Ensemble(m, members, base_seed=7)
    estate = ens.initialize(START)
    date = START
    t_days, ps_days = [], []
    for _ in range(days):
        estate, date = ens.run_days(estate, date, 1)
        g = m.gridded_fields(estate.prog)
        t_days.append(g["t"][:, K_MID].cpu().numpy())
        ps_days.append(g["ps"].cpu().numpy())
    _report_run(f"ensemble member 0 of {members}", m,
                type(estate.prog)(*(x[0] for x in estate.prog)))
    np.savez(_path(out, "ensemble", preset), t_ens=np.stack(t_days),
             ps_ens=np.stack(ps_days))


def rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a))))


def report(prec, mm, ens, days) -> tuple:
    """Print the JAX script's table (T at K_MID: the fp32 drift, the TF32
    drift, the spread and their ratios, per day) and each drift's crossing
    day at 10 / 50 / 100% of the spread; returns (rows as (day, drift,
    matmul drift, spread), {fraction: (fp32 day, TF32 day)})."""
    print(f"{'day':>4} {'fp32drift(K)':>13} {'tf32drift(K)':>13} "
          f"{'spread(K)':>10} {'fp32/spread':>12} {'tf32/spread':>12}")
    rows = []
    for d in range(min(days, len(prec["t_fp64"]), len(mm["t_tf32"]))):
        drift = rms(prec["t_fp64"][d] - prec["t_fp32"][d])
        mdrift = rms(mm["t_tf32"][d] - mm["t_f32mm"][d])
        spread = rms(ens["t_ens"][d].std(axis=0))
        rows.append((d + 1, drift, mdrift, spread))
        print(f"{d+1:>4} {drift:>13.4f} {mdrift:>13.4f} {spread:>10.4f} "
              f"{drift/spread:>12.3f} {mdrift/spread:>12.3f}")
    crossings = {}
    for frac in (0.1, 0.5, 1.0):
        c1 = next((r[0] for r in rows if r[1] >= frac * r[3]), None)
        c2 = next((r[0] for r in rows if r[2] >= frac * r[3]), None)
        crossings[frac] = (c1, c2)
        print(f"fp32 drift reaches {frac:4.0%} of ensemble spread at day "
              f"{c1}; tf32-matmul drift at day {c2}")
    return rows, crossings


def part_report(preset, days, out):
    with np.load(_path(out, "precision", preset)) as p, \
            np.load(_path(out, "matmul", preset)) as m, \
            np.load(_path(out, "ensemble", preset)) as e:
        return report(dict(p), dict(m), dict(e), days)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m speedy_tpu_torch."
                                      "fp32_qualification")
    ap.add_argument("--part", default="all",
                    choices=("all",) + PARTS + ("report",))
    ap.add_argument("--preset", default="t30")
    ap.add_argument("--days", type=int, default=30)
    ap.add_argument("--members", type=int, default=64)
    ap.add_argument("--out", default="fp32_qual",
                    help="directory of the parts' .npz files")
    add_boundary_args(ap)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    kw = dict(device=args.device, **boundary_kwargs(args))
    parts = {"all": PARTS, "report": ()}.get(args.part, (args.part,))
    for part in parts:
        if part == "precision":
            part_precision(args.preset, args.days, args.out, **kw)
        elif part == "matmul":
            part_matmul(args.preset, args.days, args.out, **kw)
        else:
            part_ensemble(args.preset, args.days, args.out, args.members,
                          **kw)
        print(f"{part}: done ({args.days} days)", flush=True)
    if args.part in ("all", "report"):
        part_report(args.preset, args.days, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
