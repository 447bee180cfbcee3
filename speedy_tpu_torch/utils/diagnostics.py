"""Model diagnostics and the numerical-stability guard
(source/diagnostics.f90)."""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import spectral as sp


class Diagnostics(NamedTuple):
    reke: torch.Tensor   # [..., kx] rotational eddy kinetic energy
    deke: torch.Tensor   # [..., kx] divergent eddy kinetic energy
    tmean: torch.Tensor  # [..., kx] global-mean temperature (K)


class InstabilityError(RuntimeError):
    pass


# the guard's accepted range (diagnostics.f90:59-69)
EKE_MAX = 500.0
TMEAN_MIN, TMEAN_MAX = 180.0, 320.0


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


def guard_extrema(diags: Sequence[Diagnostics]) -> torch.Tensor:
    """A day's extrema for the guard, [4, ..., kx] on the diagnostics'
    device: max reke, max deke, min tmean, max tmean over the day's
    diagnostics (per member of an ensemble)."""
    stack = lambda f: torch.stack([getattr(d, f) for d in diags])
    tm = stack("tmean")
    return torch.stack([stack("reke").amax(dim=0), stack("deke").amax(dim=0),
                        tm.amin(dim=0), tm.amax(dim=0)])


def bad_days(guard: np.ndarray) -> np.ndarray:
    """The guard (diagnostics.f90:59-69): which rows it rejects, from rows
    [n, 4, ..., kx] of max reke, max deke, min tmean and max tmean, on the
    host: consecutive days' extrema (``guard_extrema`` of each day) or a
    day's steps (each step's tmean as both min and max). Bool [n, ...],
    true where a level is out of the accepted range or not finite (per
    member of an ensemble)."""
    reke, deke, tmin, tmax = (guard[:, i] for i in range(4))
    bad = ((reke > EKE_MAX) | (deke > EKE_MAX) | (tmin < TMEAN_MIN)
           | (tmax > TMEAN_MAX) | ~np.isfinite(guard).all(axis=1))
    return bad.any(axis=-1)


def first_bad(guard: np.ndarray) -> Optional[Tuple[int, ...]]:
    """The index of the first row ``bad_days`` rejects: (row,), or (row,
    member) for an ensemble's rows; None if it rejects none."""
    hits = np.argwhere(bad_days(guard))
    return tuple(int(i) for i in hits[0]) if len(hits) else None


def step_rows(diags) -> np.ndarray:
    """A day's steps as the guard's rows [n, 4, kx], from every step's
    diagnostics on the host (``diags[f]`` [n, kx] for each field of
    Diagnostics): reke, deke, tmean, tmean."""
    return np.stack([diags[f] for f in ("reke", "deke", "tmean", "tmean")],
                    axis=1)


def check_days(guard: np.ndarray, first_day: int = 0) -> None:
    """The guard on consecutive days' extrema [days, 4, ..., kx]
    (``bad_days``), naming the first day out of range, counted from
    ``first_day``."""
    bad = first_bad(guard)
    if bad is not None:
        g = guard[bad[0]]
        raise InstabilityError(
            f"Model variables out of accepted range at day "
            f"{first_day + bad[0]}: reke={g[0]}, deke={g[1]}, "
            f"temp min={g[2]}, max={g[3]}")


def step_error(step: int, g: np.ndarray) -> InstabilityError:
    """The guard's error for step ``step``, whose row (``step_rows``)
    ``g`` it rejected."""
    return InstabilityError(
        f"Model variables out of accepted range at step {step}: "
        f"reke={g[0]}, deke={g[1]}, temp={g[2]}")


def format_diagnostics(diag: Diagnostics, istep: int) -> str:
    """The diagnostics printout, every ``nstdia`` steps of a run."""
    fmt = lambda a: "".join(f"{x:8.2f}" for x in np.asarray(a))
    return (f" step ={istep:6d} reke ={fmt(diag.reke)}\n"
            f"{'':13s} deke ={fmt(diag.deke)}\n"
            f"{'':13s} temp ={fmt(diag.tmean)}")
