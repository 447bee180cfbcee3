"""Long-horizon stability gate (the JAX package's scripts/stability_gate.py).

    python -m speedy_tpu_torch.stability_gate --synthetic-bc 0
    python -m speedy_tpu_torch.stability_gate --presets t85,t170 --days 30

The required check before a change to compiled numerics becomes a
default: every preset runs fp32 to the 90-day standard with the stability
guard on every step's diagnostics (``diag_every=1``, the reference's
cadence, checked once per chunk of days by ``Model.run_fast``), then the
end-of-run climate sanity checks (run_climatology.climate_stats). One JSON
line per preset with the JAX script's keys (and ``finite``, every gridded
field finite at the end), numbers unrounded, then a summary line.

Pass criteria per preset:
  * guard clean every step of every day (reke/deke < 500, 180 < T < 320)
  * day-N global-mean lowest-level air T in [270, 300] K
  * day-N zonal-mean jet max at sigma=0.2 in [15, 90] m/s
The process exits 1 when a preset fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from .cli import add_boundary_args, boundary_kwargs
from .config import from_preset
from .run_climatology import START, climate_stats

DEFAULT_PRESETS = "t30,t42,t63,t85,t170"
T_SFC_RANGE = (270.0, 300.0)   # K
JET_RANGE = (15.0, 90.0)       # m/s


def gate_preset(name: str, n_days: int, fused: bool = False, device=None,
                bc_search=None, bc_arrays=None) -> dict:
    """One preset's gate: fp32, ``n_days`` of ``run_fast(check=True)``
    from 1982-01-01, then the climate sanity checks. ``fused`` is recorded
    (the port always runs the column physics as its CUDA kernel on CUDA).
    A guard trip is recorded as ``error`` with the failing day."""
    from .models.model import Model
    from .utils.diagnostics import InstabilityError

    cfg = from_preset(name, precision="fp32", fuse_physics=fused)
    model = Model(cfg, device=device, bc_search=bc_search,
                  bc_arrays=bc_arrays)
    t0 = time.time()
    result = dict(preset=name, days=n_days, diag_every=cfg.diag_every,
                  dt_s=cfg.delt, fused=fused, guard_clean=False)
    try:
        state = model.run_fast(START, n_days, check=True)
    except InstabilityError as e:   # names the failing day
        result["error"] = f"{type(e).__name__}: {e}"[:300]
        result["wall_s"] = time.time() - t0
        result["pass"] = False
        return result
    result["guard_clean"] = True
    s = climate_stats(model, state.prog)
    result.update(
        t_sfc_global_K=s["t_sfc_global_K"], jet_max_ms=s["jet_max_ms"],
        t_sfc_ok=bool(T_SFC_RANGE[0] <= s["t_sfc_global_K"]
                      <= T_SFC_RANGE[1]),
        jet_ok=bool(JET_RANGE[0] <= s["jet_max_ms"] <= JET_RANGE[1]),
        finite=s["finite"], wall_s=time.time() - t0)
    result["pass"] = bool(result["guard_clean"] and result["t_sfc_ok"]
                          and result["jet_ok"])
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m speedy_tpu_torch."
                                      "stability_gate")
    ap.add_argument("--presets", default=DEFAULT_PRESETS)
    ap.add_argument("--days", type=int, default=90)
    ap.add_argument("--fused", action="store_true")
    add_boundary_args(ap)
    args = ap.parse_args(argv)

    bc = boundary_kwargs(args)
    ok = True
    for name in args.presets.split(","):
        r = gate_preset(name.strip(), args.days, args.fused,
                        device=args.device, **bc)
        ok = ok and r["pass"]
        print(json.dumps(r), flush=True)
    print(json.dumps({"metric": "stability_gate",
                      "presets": args.presets, "days": args.days,
                      "pass": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
