"""Model diagnostics and the numerical-stability guard
(source/diagnostics.f90)."""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import spectral as sp


class Diagnostics(NamedTuple):
    reke: torch.Tensor   # [..., kx] rotational eddy kinetic energy
    deke: torch.Tensor   # [..., kx] divergent eddy kinetic energy
    tmean: torch.Tensor  # [..., kx] global-mean temperature (K)


class InstabilityError(RuntimeError):
    pass


def compute_diagnostics(sc: sp.SpectralConsts, vor: torch.Tensor,
                        div: torch.Tensor, t: torch.Tensor) -> Diagnostics:
    """vor/div/t are spectral [..., kx, mx, nx, 2] at one time level
    (diagnostics.f90:29-50); an ensemble's members get their own."""
    def eke(x):
        inv = sp.inverse_laplacian(sc, x)
        return -torch.sum(inv[..., 1:, :, :] * x[..., 1:, :, :],
                          dim=(-3, -2, -1))

    tmean = math.sqrt(0.5) * t[..., 0, 0, 0]
    return Diagnostics(reke=eke(vor), deke=eke(div), tmean=tmean)


def check_diagnostics(diag: Diagnostics, istep: int) -> None:
    """Host-side guard: abort on instability (diagnostics.f90:59-69)."""
    reke, deke, tmean = (np.asarray(torch.as_tensor(a).cpu())
                         for a in diag)
    bad = (np.any(reke > 500.0) or np.any(deke > 500.0)
           or np.any(tmean < 180.0) or np.any(tmean > 320.0)
           or not (np.all(np.isfinite(reke)) and np.all(np.isfinite(deke))
                   and np.all(np.isfinite(tmean))))
    if bad:
        raise InstabilityError(
            f"Model variables out of accepted range at step {istep}: "
            f"reke={reke}, deke={deke}, temp={tmean}")


def format_diagnostics(diag: Diagnostics, istep: int) -> str:
    """The diagnostics printout, every ``nstdia`` steps of a run."""
    fmt = lambda a: "".join(f"{x:8.2f}" for x in np.asarray(a))
    return (f" step ={istep:6d} reke ={fmt(diag.reke)}\n"
            f"{'':13s} deke ={fmt(diag.deke)}\n"
            f"{'':13s} temp ={fmt(diag.tmean)}")
