"""Rest-state initial conditions (prognostics.f90:34-127): a reference
atmosphere at rest, log(ps) balanced with the orography, humidity from a
fixed relative humidity and scale-height profile."""
from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig
from ..constants import GAMMA, GRAV, HSCALE, HSHUM, REFRH1, RGAS
from .boundaries import Boundaries, grid_to_spec_np
from .state import PrognosticState, zeros_state


def rest_state(cfg: ModelConfig, geom_np: dict, sp_tables: dict,
               bounds: Boundaries) -> PrognosticState:
    """Initial state with time level 0 populated (level 1 is filled by the
    leapfrog bootstrap)."""
    mx, nx, kx = cfg.mx, cfg.nx, cfg.kx
    fsg = geom_np["fsg"]
    phis = bounds.phis.cpu().double().numpy()
    phis0 = bounds.phis0.cpu().double().numpy()

    gam1 = GAMMA / (1000.0 * GRAV)
    tref, ttop = 288.0, 216.0
    gam2 = gam1 / tref
    rgam = RGAS * gam1
    rgamr = 1.0 / rgam

    # temperature (prognostics.f90:62-83)
    t = np.zeros((kx, mx, nx, 2))
    surfs = -gam1 * phis
    t[0, 0, 0, 0] = np.sqrt(2.0) * ttop
    t[1, 0, 0, 0] = np.sqrt(2.0) * ttop
    surfs[0, 0, 0] = np.sqrt(2.0) * tref - gam1 * phis[0, 0, 0]
    surfs[0, 0, 1] = -gam1 * phis[0, 0, 1]
    for k in range(2, kx):
        t[k] = surfs * fsg[k] ** rgam

    # log(ps) balanced with orography (prognostics.f90:85-96)
    surfg = np.log(1.013) + rgamr * np.log(1.0 - gam2 * phis0)
    ps = grid_to_spec_np(sp_tables, surfg)
    trunc_mask = (np.arange(mx)[:, None, None]
                  + np.arange(nx)[None, :, None]) <= cfg.trunc
    if cfg.ix == 4 * cfg.iy:
        ps = ps * trunc_mask

    # humidity (prognostics.f90:98-117): q g/kg from RH=0.7
    qref = REFRH1 * 0.622 * 17.0
    qexp = HSCALE / HSHUM
    qsurf = grid_to_spec_np(sp_tables, qref * np.exp(qexp * surfg))
    if cfg.ix == 4 * cfg.iy:
        qsurf = qsurf * trunc_mask
    tr = np.zeros((cfg.ntr, kx, mx, nx, 2))
    for k in range(2, kx):
        tr[0, k] = qsurf * fsg[k] ** qexp

    device = bounds.phis.device
    state = zeros_state(cfg, device)
    dev = lambda a: torch.as_tensor(a, dtype=cfg.rdtype, device=device)
    state.t[0] = dev(t)
    state.ps[0] = dev(ps)
    state.tr[0] = dev(tr)
    return state
