"""Long-horizon fp32 stability diagnostics (the JAX package's
scripts/stability_diag.py).

    python -m speedy_tpu_torch.stability_diag --preset t85 --days 90 \\
        --synthetic-bc 0 --out stab_t85.npz

The tool that names the mechanism of an fp32 blowup: it runs a preset in
N-day chunks through (and past) a blowup without raising, and after each
chunk records the level- and total-wavenumber-resolved rotational and
divergent kinetic energy and temperature variance of the spectral state
(``spectra``), so that growth can be placed in (l, level) space, and each
day's guard extrema (reke, deke, tmean; ``CapturedDay.guard_rows``). It
stops when the state is no longer finite (``nan``) or reke or deke
exceeds 5000 (``blowup``), else ends ``clean``. Each chunk is one chunk
of replays of the captured day (``Model.run_staged(check=False)``).

A/B knobs, as the JAX script's:
  --lwvec / --no-lwvec : lw_band_vectorized on / off (the reference order)
  --rob --wil --thd --thdd --thds --nsteps : the configuration's values
  --tf32 : TF32 matmuls (torch's "high" float32 matmul precision) in
           place of the port's full float32 ones (Model() turns TF32
           off): the reduced-precision side of the A/B that the JAX
           script's --f32-matmul made on the TPU, where bfloat16 passes
           were the default; the JSON's f32_matmul is false with it

The npz holds the JAX script's arrays (days, ke_rot, ke_div, t_var
[chunks + 1, nell, kx], vor_max, guard [days, 5]); one JSON line per
chunk and a final one with its keys, numbers unrounded, then a line with
the column-physics kernel launches.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .cli import add_boundary_args, boundary_kwargs
from .config import PRESETS, from_preset
from .utils import calendar as cal

START = cal.Datetime(1982, 1, 1)
BLOWUP_EKE = 5000.0


def spectra(model, prog) -> dict:
    """Per-(total wavenumber, level) spectra of one model's prognostic
    state ``prog`` at time level 1 (scripts/stability_diag.py:40-72).

    Packed-real layout [kx, mx, nx, 2]; entry (m, j) has total wavenumber
    l = m + j; m=0 counts once, m>0 twice (conjugate symmetry). Rotational
    KE(l, k) = sum_m |vor|^2 / (l(l+1)/a^2) (x0.5), divergent likewise
    from div; T variance is the plain power spectrum.
    """
    from .models.state import time_level
    cfg = model.cfg
    elm2 = model.sp_np["elm2"]              # [mx, nx]
    m0 = np.arange(cfg.mx)[:, None]
    j0 = np.arange(cfg.nx)[None, :]
    ell = (m0 + j0).astype(int)             # [mx, nx]
    cnt = np.where(m0 == 0, 1.0, 2.0)       # conjugate-symmetry weight
    nell = int(ell.max()) + 1

    def per_l(power):                        # power: [kx, mx, nx]
        out = np.zeros((nell, power.shape[0]))
        flat = (power * cnt[None]).reshape(power.shape[0], -1)
        np.add.at(out, ell.reshape(-1), flat.T)
        return out                           # [nell, kx]

    now = time_level(prog, 1)
    host = lambda x: x.detach().cpu().numpy().astype(np.float64)
    vor, div, t = host(now.vor), host(now.div), host(now.t)
    p2 = lambda a: a[..., 0]**2 + a[..., 1]**2
    return dict(
        ke_rot=per_l(0.5 * p2(vor) * elm2[None]),
        ke_div=per_l(0.5 * p2(div) * elm2[None]),
        t_var=per_l(p2(t)),
        vor_max=float(np.abs(vor).max()), div_max=float(np.abs(div).max()))


def main(argv=None) -> int:
    from .models.model import Model
    ap = argparse.ArgumentParser(prog="python -m speedy_tpu_torch."
                                      "stability_diag")
    ap.add_argument("--preset", default="t85", choices=sorted(PRESETS))
    ap.add_argument("--days", type=int, default=90)
    ap.add_argument("--chunk", type=int, default=3)
    ap.add_argument("--lwvec", action="store_true", default=None,
                    help="force LW band vectorization on (the default); "
                         "--no-lwvec forces the reference sweep order")
    ap.add_argument("--no-lwvec", dest="lwvec", action="store_false")
    ap.add_argument("--rob", type=float, default=None)
    ap.add_argument("--wil", type=float, default=None)
    ap.add_argument("--thd", type=float, default=None)
    ap.add_argument("--thdd", type=float, default=None)
    ap.add_argument("--thds", type=float, default=None)
    ap.add_argument("--nsteps", type=int, default=None)
    ap.add_argument("--tf32", action="store_true",
                    help="TF32 matmuls in place of full float32 ones")
    ap.add_argument("--out", default="stability_diag.npz")
    add_boundary_args(ap)
    args = ap.parse_args(argv)

    kw = dict(precision="fp32")
    if args.lwvec is not None:
        kw["lw_band_vectorized"] = args.lwvec
    for f in ("rob", "wil", "thd", "thdd", "thds", "nsteps"):
        v = getattr(args, f)
        if v is not None:
            kw[f] = v
    cfg = from_preset(args.preset, **kw)
    model = Model(cfg, device=args.device, **boundary_kwargs(args))
    before = torch.get_float32_matmul_precision()
    if args.tf32:
        torch.set_float32_matmul_precision("high")
    try:
        return _diagnose(args, cfg, model)
    finally:
        torch.set_float32_matmul_precision(before)


def _diagnose(args, cfg, model) -> int:
    """The chunks of days of ``main`` with their spectra and guard rows,
    the npz and the JSON lines."""
    from .utils import tracing
    tracing.reset()
    state = model.initialize(START)
    cd = model.captured_day(state)
    cd.load(state)
    date = START

    snaps, guards = [dict(day=0, **spectra(model, state.prog))], []
    t0 = time.time()
    day = 0
    status = "clean"
    while day < args.days:
        chunk = min(args.chunk, args.days - day)
        date = model.run_staged(cd, date, START, chunk, model.sppt_noise,
                                check=False, max_chunk_days=chunk)
        rows = cd.guard_rows(chunk)          # [chunk, 4, kx]
        day += chunk
        for di, (reke, deke, tmin, tmax) in enumerate(rows):
            guards.append(dict(day=day - chunk + di + 1,
                               reke=float(reke.max()),
                               deke=float(deke.max()),
                               tmin=float(tmin.min()),
                               tmax=float(tmax.max())))
        s = spectra(model, cd.state.prog)
        snaps.append(dict(day=day, **s))
        g = guards[-1]
        print(json.dumps(dict(day=day, reke=g["reke"], deke=g["deke"],
                              tmin=g["tmin"], tmax=g["tmax"],
                              vor_max=s["vor_max"])), flush=True)
        if not np.isfinite(rows[:, 0]).all() or \
                not np.isfinite(s["vor_max"]):
            status = "nan"
            break
        if g["reke"] > BLOWUP_EKE or g["deke"] > BLOWUP_EKE:
            status = "blowup"
            break

    np.savez(args.out,
             days=np.array([s["day"] for s in snaps]),
             ke_rot=np.stack([s["ke_rot"] for s in snaps]),
             ke_div=np.stack([s["ke_div"] for s in snaps]),
             t_var=np.stack([s["t_var"] for s in snaps]),
             vor_max=np.array([s["vor_max"] for s in snaps]),
             guard=np.array([[g["day"], g["reke"], g["deke"],
                              g["tmin"], g["tmax"]] for g in guards]))
    first_bad = next((g["day"] for g in guards
                      if g["reke"] > 500 or g["deke"] > 500
                      or not (180 < g["tmin"] and g["tmax"] < 320)), None)
    print(json.dumps(dict(
        metric="stability_diag", preset=args.preset, days_run=day,
        status=status, first_guard_trip_day=first_bad,
        lwvec=cfg.lw_band_vectorized, f32_matmul=not args.tf32,
        rob=cfg.rob, thd=cfg.thd, thdd=cfg.thdd,
        thds=cfg.thds, nsteps=cfg.nsteps, out=args.out,
        wall_s=time.time() - t0)))
    print(f"column-physics kernel launches {tracing.counters['k1.launches']} "
          f"(sw {tracing.counters['k1.launches_sw']}) on {model.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
