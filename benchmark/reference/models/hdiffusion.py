"""Horizontal (hyper)diffusion coefficients and their application
(source/horizontal_diffusion.f90): del^8 damping for T/vorticity and
divergence, del^2 stratospheric diffusion, and the orographic-correction
vertical profiles. The implicit factors live in ImplicitConsts."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import ModelConfig
from ..constants import GAMMA, GRAV, HSCALE, HSHUM, RGAS


class DiffusionConsts(NamedTuple):
    dmp: torch.Tensor    # [mx, nx] explicit del^8 damping, T and vorticity
    dmpd: torch.Tensor   # [mx, nx] explicit del^8 damping, divergence
    dmps: torch.Tensor   # [mx, nx] explicit del^2 stratospheric damping
    tcorv: torch.Tensor  # [kx] orographic T-correction vertical profile
    qcorv: torch.Tensor  # [kx] orographic q-correction vertical profile


def build_diffusion_np(cfg: ModelConfig, geom_np: dict) -> dict:
    """Float64 tables (horizontal_diffusion.f90:36-82)."""
    if cfg.nsteps % 2:
        raise ValueError("Invalid no. of time steps")
    npowhd = 4
    hdiff = 1.0 / (cfg.thd * 3600.0)
    hdifd = 1.0 / (cfg.thdd * 3600.0)
    hdifs = 1.0 / (cfg.thds * 3600.0)
    rlap = 1.0 / (cfg.trunc * (cfg.trunc + 1))

    twn = (np.arange(cfg.mx, dtype=np.float64)[:, None]
           + np.arange(cfg.nx, dtype=np.float64)[None, :])
    elap = twn * (twn + 1.0) * rlap

    rgam = RGAS * GAMMA / (1000.0 * GRAV)
    qexp = HSCALE / HSHUM
    fsg = geom_np["fsg"]
    tcorv = np.zeros(cfg.kx)
    qcorv = np.zeros(cfg.kx)
    tcorv[1:] = fsg[1:] ** rgam
    qcorv[2:] = fsg[2:] ** qexp
    return dict(dmp=hdiff * elap**npowhd, dmpd=hdifd * elap**npowhd,
                dmps=hdifs * elap, tcorv=tcorv, qcorv=qcorv)


def build_diffusion(cfg: ModelConfig, geom_np: dict, device) -> DiffusionConsts:
    return DiffusionConsts(**{
        k: torch.as_tensor(v, dtype=cfg.rdtype, device=device)
        for k, v in build_diffusion_np(cfg, geom_np).items()})


def apply_diffusion(field: torch.Tensor, fdt: torch.Tensor,
                    dmp: torch.Tensor, dmp1: torch.Tensor) -> torch.Tensor:
    """(fdt - dmp*field) * dmp1 (horizontal_diffusion.f90:86-105)."""
    return (fdt - dmp[..., None] * field) * dmp1[..., None]
