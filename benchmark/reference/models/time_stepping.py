"""Leapfrog time stepping with Robert-Williams filtering
(source/time_stepping.f90). The three-step bootstrap (first_step) uses
ImplicitConsts built for dt/2 and dt; the run continues with 2dt."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import ModelConfig
from ..constants import TDRS
from ..ops import spectral as sp
from .axes import SPEC, per_level
from .hdiffusion import DiffusionConsts, apply_diffusion
from .implicit import ImplicitConsts
from .state import TIME_AXIS, PrognosticState, time_level
from .tendencies import DynConsts, get_tendencies


class OrographicCorrection(NamedTuple):
    """Daily horizontal orographic-correction fields (forcing.f90:73-99)."""
    tcorh: torch.Tensor  # [mx, nx, 2]
    qcorh: torch.Tensor  # [..., mx, nx, 2] (per member: it reads the surface)


def _step_field(cfg: ModelConfig, sc, j1: int, dt: float, eps: float,
                field2: torch.Tensor, fdt: torch.Tensor,
                axis: int) -> torch.Tensor:
    """Robert-Williams filtered leapfrog update of one two-time-level field
    (time_stepping.f90:142-167); ``field2`` has the time axis at ``axis``
    (counted from the right)."""
    if cfg.ix == 4 * (cfg.il // 2):
        fdt = sp.trunct(sc, fdt)
    fold = field2.select(axis, j1 - 1)
    fnow = field2.select(axis, 0)
    fnew = fnow + dt * fdt
    f1 = fold + cfg.wil * eps * (fnow - 2.0 * fold + fnew)
    f2 = fnew - (1.0 - cfg.wil) * eps * (f1 - 2.0 * fold + fnew)
    return torch.stack([f1, f2], dim=axis)


def step(cfg: ModelConfig, dyn: DynConsts, dc: DiffusionConsts,
         ic: ImplicitConsts, state: PrognosticState,
         j1: int, j2: int, dt: float,
         corr: OrographicCorrection,
         physics_fn=None, sppt_spec=None) -> Tuple[PrognosticState, object]:
    """One time step (time_stepping.f90:35-122). j1=1, j2=1: forward step;
    j1=1, j2=2: first leapfrog; j1=2, j2=2: filtered leapfrog.
    ``sppt_spec``: the updated SPPT spectral state, synthesized in the
    step's merged batch for the physics."""
    sc = dyn.sc
    vordt, divdt, tdt, psdt, trdt, aux = get_tendencies(
        cfg, dyn, ic, state, j2 - 1, physics_fn, sppt_spec)
    s0 = time_level(state, 0)

    # horizontal diffusion (time_stepping.f90:62-102)
    vordt = apply_diffusion(s0.vor, vordt, dc.dmp, ic.dmp1)
    divdt = apply_diffusion(s0.div, divdt, dc.dmpd, ic.dmp1d)
    # a [..., mx, nx, 2] field times a [kx] profile -> [..., kx, mx, nx, 2]
    ctmp = s0.t + per_level(corr.tcorh, SPEC) * dc.tcorv[:, None, None, None]
    tdt = apply_diffusion(ctmp, tdt, dc.dmp, ic.dmp1)

    # stratospheric zonal-mean wind drag at the top level (:77-81)
    sdrag = 1.0 / (TDRS * 3600.0)
    vordt[..., 0, 0, :, :] += -sdrag * s0.vor[..., 0, 0, :, :]
    divdt[..., 0, 0, :, :] += -sdrag * s0.div[..., 0, 0, :, :]

    vordt = apply_diffusion(s0.vor, vordt, dc.dmps, ic.dmp1s)
    divdt = apply_diffusion(s0.div, divdt, dc.dmps, ic.dmp1s)
    tdt = apply_diffusion(ctmp, tdt, dc.dmps, ic.dmp1s)

    # humidity diffusion with orographic correction; the reference uses
    # the divergence coefficients here (time_stepping.f90:96)
    qtmp = s0.tr.select(-5, 0) \
        + per_level(corr.qcorh, SPEC) * dc.qcorv[:, None, None, None]
    trdt = trdt.clone()
    trdt[..., 0, :, :, :, :] = apply_diffusion(
        qtmp, trdt.select(-5, 0), dc.dmpd, ic.dmp1d)

    # Robert-Williams leapfrog (time_stepping.f90:104-121)
    eps = 0.0 if j1 == 1 else cfg.rob
    stepf = lambda f, fdt, axis: _step_field(cfg, sc, j1, dt, eps, f, fdt,
                                             axis)
    tr = torch.stack([stepf(state.tr.select(-5, i), trdt.select(-5, i),
                            TIME_AXIS["vor"])
                      for i in range(cfg.ntr)], dim=-5)
    return PrognosticState(vor=stepf(state.vor, vordt, TIME_AXIS["vor"]),
                           div=stepf(state.div, divdt, TIME_AXIS["div"]),
                           t=stepf(state.t, tdt, TIME_AXIS["t"]),
                           ps=stepf(state.ps, psdt, TIME_AXIS["ps"]),
                           tr=tr), aux


def first_step(cfg: ModelConfig, dyn: DynConsts, dc: DiffusionConsts,
               ic_half: ImplicitConsts, ic_full: ImplicitConsts,
               state: PrognosticState, corr: OrographicCorrection,
               physics_fn=None) -> Tuple[PrognosticState, object]:
    """Leapfrog bootstrap (time_stepping.f90:12-24): a forward half step,
    then a first leapfrog step."""
    state, aux = step(cfg, dyn, dc, ic_half, state, 1, 1, 0.5 * cfg.delt,
                      corr, physics_fn)
    return step(cfg, dyn, dc, ic_full, state, 1, 2, cfg.delt, corr,
                physics_fn)
