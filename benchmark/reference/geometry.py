"""Model geometry: sigma levels and the Gaussian latitude grid
(source/geometry.f90). Latitude j=0 is southernmost.

Two quirks of the reference are kept because the spectral tables depend on
them: ``sia_half`` holds the asymptotic Gauss-node seed, not the
Newton-iterated nodes (geometry.f90:68), and the seed uses the literal
``PI_F``. Tables are built in float64 numpy, then moved to the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import ModelConfig
from .constants import AKAP, OMEGA, PI_F

# Half-level sigma tables for the supported level counts (geometry.f90:42-48).
_HSG_TABLES = {
    5: [0.000, 0.150, 0.350, 0.650, 0.900, 1.000],
    7: [0.020, 0.140, 0.260, 0.420, 0.600, 0.770, 0.900, 1.000],
    8: [0.000, 0.050, 0.140, 0.260, 0.420, 0.600, 0.770, 0.900, 1.000],
}


class Geometry(NamedTuple):
    hsg: torch.Tensor     # [kx+1] half-level sigma
    dhs: torch.Tensor     # [kx] layer thickness
    fsg: torch.Tensor     # [kx] full-level sigma
    dhsr: torch.Tensor    # [kx] 1/(2*dhs)
    fsgr: torch.Tensor    # [kx] akap/(2*fsg)
    radang: torch.Tensor  # [il] latitude (radians), south -> north
    coriol: torch.Tensor  # [il] 2*Omega*sin(lat)
    sia: torch.Tensor     # [il] sin(lat)
    coa: torch.Tensor     # [il] cos(lat)
    sia_half: torch.Tensor  # [iy]
    coa_half: torch.Tensor  # [iy]
    cosg: torch.Tensor    # [il]
    cosgr: torch.Tensor   # [il] 1/cos(lat)
    cosgr2: torch.Tensor  # [il] 1/cos^2(lat)


def build_geometry_np(cfg: ModelConfig) -> dict:
    """Float64 numpy geometry tables."""
    il, iy = cfg.il, cfg.iy
    hsg = np.asarray(_HSG_TABLES[cfg.kx], dtype=np.float64)
    dhs = hsg[1:] - hsg[:-1]
    fsg = 0.5 * (hsg[1:] + hsg[:-1])
    dhsr = 0.5 / dhs
    fsgr = AKAP / (2.0 * fsg)

    # Approximate Gauss node seed, pole -> equator (geometry.f90:66-76).
    j = np.arange(1, iy + 1, dtype=np.float64)
    sia_half = np.cos(PI_F * (j - 0.25) / (il + 0.5))
    coa_half = np.sqrt(1.0 - sia_half**2)

    sia = np.concatenate([-sia_half, sia_half[::-1]])
    coa = np.concatenate([coa_half, coa_half[::-1]])
    radang = np.concatenate([-np.arcsin(sia_half), np.arcsin(sia_half)[::-1]])
    return dict(
        hsg=hsg, dhs=dhs, fsg=fsg, dhsr=dhsr, fsgr=fsgr,
        radang=radang, coriol=2.0 * OMEGA * sia, sia=sia, coa=coa,
        sia_half=sia_half, coa_half=coa_half,
        cosg=coa.copy(), cosgr=1.0 / coa, cosgr2=1.0 / coa**2,
    )


def to_device(tables: dict, dtype: torch.dtype, device) -> dict:
    """numpy tables -> tensors of ``dtype`` on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in tables.items()}


def build_geometry(cfg: ModelConfig, device) -> Geometry:
    return Geometry(**to_device(build_geometry_np(cfg), cfg.rdtype, device))
