"""Semi-implicit gravity-wave solver (source/implicit.f90).

The per-total-wavenumber kx-by-kx systems are inverted at setup into a
[mx, nx, kx, kx] tensor, so the per-step correction is one batched
contraction. One ImplicitConsts is built per step length (dt/2, dt, 2dt
for the leapfrog bootstrap, time_stepping.f90:12-24).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..constants import AKAP, GAMMA, GRAV, REARTH, RGAS


class ImplicitConsts(NamedTuple):
    tref: torch.Tensor    # [kx] reference T profile
    tref1: torch.Tensor   # [kx] rgas * tref
    tref2: torch.Tensor   # [kx] akap * tref
    tref3: torch.Tensor   # [kx] fsgr * tref
    xd: torch.Tensor      # [kx, kx] hydrostatic operator
    xc: torch.Tensor      # [kx, kx] T-from-divergence operator, scaled by xi
    xj: torch.Tensor      # [mx, nx, kx, kx] inverse implicit matrices
    dhsx: torch.Tensor    # [kx] xi * dhs
    elz: torch.Tensor     # [mx, nx] l(l+1) * xi / a^2
    dmp1: torch.Tensor    # [mx, nx] implicit del^8 factor, T/vorticity
    dmp1d: torch.Tensor   # [mx, nx] implicit del^8 factor, divergence
    dmp1s: torch.Tensor   # [mx, nx] implicit del^2 stratospheric factor


def build_implicit_np(cfg: ModelConfig, geom_np: dict, diff_np: dict,
                      dt: float) -> dict:
    """Float64 setup (implicit.f90:36-165)."""
    kx, mx, nx = cfg.kx, cfg.mx, cfg.nx
    hsg, dhs, fsg, fsgr = (geom_np[k] for k in ("hsg", "dhs", "fsg", "fsgr"))

    dmp1 = 1.0 / (1.0 + diff_np["dmp"] * dt)
    dmp1d = 1.0 / (1.0 + diff_np["dmpd"] * dt)
    dmp1s = 1.0 / (1.0 + diff_np["dmps"] * dt)

    rgam = RGAS * GAMMA / (1000.0 * GRAV)
    tref = 288.0 * np.maximum(0.2, fsg) ** rgam
    tref1 = RGAS * tref
    tref2 = AKAP * tref
    tref3 = fsgr * tref

    xi = dt * cfg.alph
    xxi = xi / REARTH**2
    dhsx = xi * dhs

    ell = (np.arange(mx, dtype=np.float64)[:, None]
           + np.arange(nx, dtype=np.float64)[None, :])
    elz = ell * (ell + 1.0) * xxi

    ya = -AKAP * np.outer(tref, dhs)
    xa = np.zeros((kx, kx))
    for k in range(1, kx):
        xa[k, k - 1] = 0.5 * (AKAP * tref[k] / fsg[k]
                              - (tref[k] - tref[k - 1]) / dhs[k])
    for k in range(kx - 1):
        xa[k, k] = 0.5 * (AKAP * tref[k] / fsg[k]
                          - (tref[k + 1] - tref[k]) / dhs[k])

    dsum = np.cumsum(dhs)
    xb = np.zeros((kx, kx))
    for k in range(kx - 1):
        for k1 in range(kx):
            xb[k, k1] = dhs[k1] * dsum[k]
            if k1 <= k:
                xb[k, k1] -= dhs[k1]

    xc = ya + xa @ xb

    xd = np.zeros((kx, kx))
    for k in range(kx):
        for k1 in range(k + 1, kx):
            xd[k, k1] = RGAS * np.log(hsg[k1 + 1] / hsg[k1])
        xd[k, k] = RGAS * np.log(hsg[k + 1] / fsg[k])

    xe = xd @ xc
    core = np.outer(tref1, dhs) - xe
    lam = (xi**2) * (ell * (ell + 1.0)) / REARTH**2
    xf = np.eye(kx)[None, None] + lam[:, :, None, None] * core[None, None]
    xj = np.linalg.inv(xf)
    xj[0, 0] = 0.0  # l = 0: divergence correction zeroed (implicit.f90:200)

    return dict(tref=tref, tref1=tref1, tref2=tref2, tref3=tref3, xd=xd,
                xc=xc * xi, xj=xj, dhsx=dhsx, elz=elz,
                dmp1=dmp1, dmp1d=dmp1d, dmp1s=dmp1s)


def build_implicit(cfg: ModelConfig, geom_np: dict, diff_np: dict,
                   dt: float, device) -> ImplicitConsts:
    return ImplicitConsts(**{
        k: torch.as_tensor(v, dtype=cfg.rdtype, device=device)
        for k, v in build_implicit_np(cfg, geom_np, diff_np, dt).items()})


def implicit_terms(ic: ImplicitConsts, divdt: torch.Tensor, tdt: torch.Tensor,
                   psdt: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Semi-implicit correction of (divdt, tdt, psdt) (implicit.f90:168-217).
    divdt/tdt [..., kx, mx, nx, 2], psdt [..., mx, nx, 2]."""
    ye = torch.einsum("kq,...qmnr->...kmnr", ic.xd, tdt) \
        + ic.tref1[:, None, None, None] * psdt.unsqueeze(-4)
    yf = divdt + ic.elz[None, :, :, None] * ye
    divdt_new = torch.einsum("mnkq,...qmnr->...kmnr", ic.xj, yf)
    psdt_new = psdt - torch.einsum("...kmnr,k->...mnr", divdt_new, ic.dhsx)
    tdt_new = tdt + torch.einsum("kq,...qmnr->...kmnr", ic.xc, divdt_new)
    return divdt_new, tdt_new, psdt_new
