"""Time-invariant boundary conditions: orography, land-sea mask, albedo
(source/boundaries.f90). Host-side numpy setup; the spectrally filtered
orography feeds the rest state and the geopotential."""
from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..constants import GRAV
from ..utils.io import load_boundary_file


class Boundaries(NamedTuple):
    fmask: torch.Tensor   # [il, ix] fractional land-sea mask
    phi0: torch.Tensor    # [il, ix] unfiltered surface geopotential
    phis0: torch.Tensor   # [il, ix] spectrally-filtered surface geopotential
    phis: torch.Tensor    # [mx, nx, 2] spectral surface geopotential
    alb0: torch.Tensor    # [il, ix] bare-land annual-mean albedo


def spectral_truncation_np(cfg: ModelConfig, tables: dict,
                           fg: np.ndarray) -> np.ndarray:
    """Grid -> spectral -> truncate l <= trunc -> grid
    (boundaries.f90:75-94), float64 numpy."""
    fm = np.einsum("ji,mri->jmr", fg, tables["dft_ana"])
    spec = np.einsum("jmr,mnj->mnr", fm, tables["cpol_dir"])
    m0 = np.arange(cfg.mx)[:, None, None]
    n0 = np.arange(cfg.nx)[None, :, None]
    spec = spec * ((m0 + n0) <= cfg.trunc)
    fm2 = np.einsum("mnr,mnj->jmr", spec, tables["cpol_inv"])
    return np.einsum("jmr,mri->ji", fm2, tables["dft_syn"])


def grid_to_spec_np(tables: dict, fg: np.ndarray) -> np.ndarray:
    fm = np.einsum("...ji,mri->...jmr", fg, tables["dft_ana"])
    return np.einsum("...jmr,mnj->...mnr", fm, tables["cpol_dir"])


def forchk(fmask: np.ndarray, fmin: float, fmax: float, fset: float,
           field: np.ndarray, name: str = "field") -> np.ndarray:
    """Range-check a surface field where the mask is set and set the other
    points to ``fset`` (boundaries.f90:47-72); out-of-range points are
    logged, as the reference counts them."""
    field = field.copy()
    masked = fmask > 0.0
    vals = field[..., masked]
    nfault = int(((vals < fmin) | (vals > fmax)).sum())
    if nfault:
        logging.getLogger(__name__).warning(
            "forchk: %d out-of-range point(s) in %r (allowed [%g, %g])",
            nfault, name, fmin, fmax)
    field[..., ~masked] = fset
    return field


def fillsf(sf: np.ndarray, fmis: float) -> np.ndarray:
    """Replace values < fmis by zonal fill, equator -> poles
    (boundaries.f90:96-142). [il, ix], latitude south -> north."""
    sf = sf.copy()
    il, ix = sf.shape
    order = list(range(il // 2 - 1, -1, -1)) + list(range(il // 2, il))
    fmean = 0.0
    for j in order:
        row = sf[j]
        miss = row < fmis
        if not miss.any():
            continue
        nmis = int(miss.sum())
        work = np.where(miss, 0.0, row)
        if nmis < ix:
            fmean = work.sum() / (ix - nmis)
        work = np.where(miss, fmean, row)
        left = np.roll(work, 1)
        right = np.roll(work, -1)
        sf[j] = np.where(miss, 0.5 * (left + right), row)
    return sf


def build_boundaries(cfg: ModelConfig, sp_tables: dict, device,
                     search: Optional[list] = None,
                     arrays: Optional[dict] = None) -> Boundaries:
    """Read surface.nc and build the boundary constants
    (boundaries.f90:28-43)."""
    tgt = (cfg.il, cfg.ix)
    load = lambda var: load_boundary_file("surface.nc", var, search=search,
                                          target_shape=tgt, arrays=arrays)
    phi0 = GRAV * load("orog")
    phis0 = spectral_truncation_np(cfg, sp_tables, phi0)
    phis = grid_to_spec_np(sp_tables, phis0)
    dev = lambda a: torch.as_tensor(a, dtype=cfg.rdtype, device=device)
    return Boundaries(fmask=dev(load("lsm")), phi0=dev(phi0),
                      phis0=dev(phis0), phis=dev(phis), alb0=dev(load("alb")))
