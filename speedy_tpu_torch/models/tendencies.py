"""Dynamical-core tendency assembly (source/tendencies.f90).

Per-level loops become batched tensor ops over the leading level axis, and
the per-step transforms of each direction are batched into a few
contractions: one synthesis of the merged stack of every scalar field,
level and time level (the physics time level rides along), one of the
winds, and one analysis each of the u/v-type and scalar tendencies.

Grid-point fields use [kx, il, ix]; spectral fields [kx, mx, nx, 2].
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..config import ModelConfig
from ..constants import AKAP, RGAS
from ..geometry import Geometry
from ..ops import spectral as sp
from .geopotential import GeopotentialConsts, get_geopotential
from .implicit import ImplicitConsts, implicit_terms
from .state import PrognosticState


class DynConsts(NamedTuple):
    sc: sp.SpectralConsts
    geom: Geometry
    gc: GeopotentialConsts
    phis: torch.Tensor  # [mx, nx, 2] spectral surface geopotential


class GridState(NamedTuple):
    vorg: torch.Tensor  # [kx, il, ix] absolute vorticity
    divg: torch.Tensor
    tg: torch.Tensor
    trg: torch.Tensor   # [ntr, kx, il, ix]
    ug: torch.Tensor    # true zonal wind
    vg: torch.Tensor    # true meridional wind


class PhysicsGridState(NamedTuple):
    """Level-0 (physics time level) grid fields, synthesized in the same
    batches as the dynamics (physics.f90:95-104 merged)."""
    ug: torch.Tensor    # [kx, il, ix]
    vg: torch.Tensor
    tg: torch.Tensor
    qg: torch.Tensor    # unclamped; physics clamps >= 0
    phig: torch.Tensor
    pslg: torch.Tensor  # [il, ix] log surface pressure
    sppt: Optional[torch.Tensor] = None  # [kx, il, ix] unclipped SPPT pattern


PhysicsFn = Callable[[PhysicsGridState], Tuple]


def _half_level_advection(shd: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """sigdt_half[i] * (f[i] - f[i-1]) on interior half levels, zero at the
    top and bottom -> [kx+1, il, ix]."""
    interior = shd[1:-1] * (f[1:] - f[:-1])
    zero = torch.zeros_like(interior[:1])
    return torch.cat([zero, interior, zero], dim=0)


def grid_dynamics_tendencies(cfg: ModelConfig, dyn: DynConsts,
                             ic: ImplicitConsts, state: PrognosticState,
                             j2: int,
                             phi0_spec: Optional[torch.Tensor] = None,
                             sppt_spec: Optional[torch.Tensor] = None
                             ) -> Tuple:
    """Nonlinear grid-point dynamics tendencies (tendencies.f90:49-197).

    Returns (gs, pg, psdt_g, utend, vtend, ttend, trtend, tgg); ``pg`` is
    the level-0 PhysicsGridState, or None when ``phi0_spec`` is None (the
    adiabatic core). ``sppt_spec`` [kx, mx, nx, 2], the updated SPPT state,
    rides the merged synthesis and comes out as ``pg.sppt``.
    """
    sc, geom = dyn.sc, dyn.geom
    dhs = geom.dhs[:, None, None]
    dhsr = geom.dhsr[:, None, None]
    fsgr = geom.fsgr[:, None, None]
    kx, ntr = cfg.kx, cfg.ntr
    with_phys = phi0_spec is not None

    # spectral -> grid of every field, level and time level at once
    vor_s, div_s = state.vor[j2], state.div[j2]
    fields = [vor_s, div_s, state.t[j2],
              state.tr[j2].reshape((-1,) + vor_s.shape[1:])]
    if with_phys:
        fields += [state.t[0], state.tr[0, 0], phi0_spec, state.ps[0][None]]
    if sppt_spec is not None:
        fields.append(sppt_spec)
    plain_g = sp.spec_to_grid(sc, torch.cat(fields, dim=0))
    vorg = plain_g[0:kx]
    divg = plain_g[kx:2 * kx]
    tg = plain_g[2 * kx:3 * kx]
    base = (3 + ntr) * kx
    trg = plain_g[3 * kx:base].reshape((ntr, kx) + vorg.shape[1:])

    if with_phys:
        vor_uv = torch.cat([vor_s, state.vor[0]], dim=0)
        div_uv = torch.cat([div_s, state.div[0]], dim=0)
    else:
        vor_uv, div_uv = vor_s, div_s
    ucos, vcos = sp.uvspec(sc, vor_uv, div_uv)
    px_s, py_s = sp.grad(sc, state.ps[j2])
    nuv = ucos.shape[0]
    wind = torch.cat([ucos, vcos, px_s[None], py_s[None]], dim=0)
    wind_g = sp.spec_to_grid(sc, wind, scale_by_inv_cos=True)
    ug, vg = wind_g[:kx], wind_g[nuv:nuv + kx]
    px, py = wind_g[2 * nuv], wind_g[2 * nuv + 1]

    pg = None
    if with_phys:
        pg = PhysicsGridState(
            ug=wind_g[kx:nuv], vg=wind_g[nuv + kx:2 * nuv],
            tg=plain_g[base:base + kx],
            qg=plain_g[base + kx:base + 2 * kx],
            phig=plain_g[base + 2 * kx:base + 3 * kx],
            pslg=plain_g[base + 3 * kx],
            sppt=(plain_g[base + 3 * kx + 1:base + 4 * kx + 1]
                  if sppt_spec is not None else None))

    vorg = vorg + geom.coriol[None, :, None]

    # vertical-mean winds and log-ps tendency (tendencies.f90:109-126)
    umean = torch.sum(ug * dhs, dim=0)
    vmean = torch.sum(vg * dhs, dim=0)
    dmean = torch.sum(divg * dhs, dim=0)
    psdt_g = -umean * px - vmean * py

    # sigma-dot vertical velocity (tendencies.f90:128-143)
    puv = (ug - umean) * px + (vg - vmean) * py
    zero2 = torch.zeros_like(puv[:1])
    shd = torch.cat(
        [zero2, -torch.cumsum(dhs * (puv + divg - dmean), dim=0)], dim=0)
    shm = torch.cat([zero2, -torch.cumsum(dhs * puv, dim=0)], dim=0)

    tgg = tg - ic.tref[:, None, None]

    # wind tendencies (tendencies.f90:151-172)
    tmp_u = _half_level_advection(shd, ug)
    utend = vg * vorg - tgg * RGAS * px - (tmp_u[1:] + tmp_u[:-1]) * dhsr
    tmp_v = _half_level_advection(shd, vg)
    vtend = -ug * vorg - tgg * RGAS * py - (tmp_v[1:] + tmp_v[:-1]) * dhsr

    # temperature tendency (tendencies.f90:174-184)
    dtref = (ic.tref[1:] - ic.tref[:-1])[:, None, None]
    tmp_t = _half_level_advection(shd, tgg) \
        + torch.cat([zero2, shm[1:-1] * dtref, zero2], dim=0)
    ttend = (tgg * divg - (tmp_t[1:] + tmp_t[:-1]) * dhsr
             + fsgr * tgg * (shd[1:] + shd[:-1])
             + ic.tref3[:, None, None] * (shm[1:] + shm[:-1])
             + AKAP * (tg * puv - tgg * dmean))

    # tracer tendency (tendencies.f90:186-197)
    def tracer_tend(q):
        tmp_q = _half_level_advection(shd, q)
        # reference quirk: vertical advection zeroed on half levels 2-3
        # (1-based temp(:,:,2:3)=0, tendencies.f90:192)
        tmp_q[1:3] = 0.0
        return q * divg - (tmp_q[1:] + tmp_q[:-1]) * dhsr
    trtend = torch.stack([tracer_tend(trg[i]) for i in range(ntr)], dim=0)

    gs = GridState(vorg=vorg, divg=divg, tg=tg, trg=trg, ug=ug, vg=vg)
    return gs, pg, psdt_g, utend, vtend, ttend, trtend, tgg


def grid_to_spectral_tendencies(cfg: ModelConfig, dyn: DynConsts,
                                gs: GridState, tgg: torch.Tensor,
                                psdt_g: torch.Tensor,
                                utend, vtend, ttend, trtend) -> Tuple:
    """Grid-point tendencies -> spectral (tendencies.f90:208-234), with one
    vdspec call for the u/v-type pairs and one analysis of the scalars."""
    sc = dyn.sc
    kx, ntr = cfg.kx, cfg.ntr
    u_stack = torch.cat([utend, -gs.ug * tgg]
                        + [-gs.ug * gs.trg[i] for i in range(ntr)], dim=0)
    v_stack = torch.cat([vtend, -gs.vg * tgg]
                        + [-gs.vg * gs.trg[i] for i in range(ntr)], dim=0)
    vor_out, div_out = sp.vdspec(sc, u_stack, v_stack, half_cos_scaling=True)
    vordt = vor_out[:kx]
    tdt_adv = div_out[kx:2 * kx]
    trdt_adv = div_out[2 * kx:].reshape((ntr, kx) + div_out.shape[1:])

    ke = 0.5 * (gs.ug**2 + gs.vg**2)
    scal = torch.cat([ke, ttend, trtend.reshape((-1,) + ttend.shape[1:]),
                      psdt_g[None]], dim=0)
    scal_s = sp.grid_to_spec(sc, scal)
    divdt = div_out[:kx] - sp.laplacian(sc, scal_s[:kx])
    tdt = tdt_adv + scal_s[kx:2 * kx]
    trdt = trdt_adv + scal_s[2 * kx:-1].reshape(trdt_adv.shape)
    psdt = scal_s[-1].clone()
    psdt[0, 0] = 0.0
    return vordt, divdt, tdt, trdt, psdt


def spectral_tendencies(cfg: ModelConfig, dyn: DynConsts, ic: ImplicitConsts,
                        state: PrognosticState, j: int,
                        divdt, tdt, psdt) -> Tuple:
    """Linear spectral tendencies at time level ``j``
    (tendencies.f90:242-293)."""
    sc, geom = dyn.sc, dyn.geom
    dhs = geom.dhs[:, None, None, None]
    dhsr = geom.dhsr[:, None, None, None]
    div_s = state.div[j]

    dmeanc = torch.sum(div_s * dhs, dim=0)
    psdt = psdt - dmeanc
    psdt[0, 0] = 0.0

    # sigma-dot on half levels; the bottom half level stays exactly zero
    # (tendencies.f90:270-272)
    zero = torch.zeros_like(div_s[:1])
    sigdtc = torch.cat(
        [zero, -torch.cumsum(dhs[:-1] * (div_s[:-1] - dmeanc), dim=0), zero],
        dim=0)
    dtref = (ic.tref[1:] - ic.tref[:-1])[:, None, None, None]
    dumk = torch.cat([zero, sigdtc[1:-1] * dtref, zero], dim=0)

    tdt = (tdt - (dumk[1:] + dumk[:-1]) * dhsr
           + ic.tref3[:, None, None, None] * (sigdtc[1:] + sigdtc[:-1])
           - ic.tref2[:, None, None, None] * dmeanc)

    phi = get_geopotential(dyn.gc, state.t[j], dyn.phis)
    divdt = divdt - sp.laplacian(
        sc, phi + RGAS * ic.tref[:, None, None, None] * state.ps[j][None])
    return divdt, tdt, psdt


def get_tendencies(cfg: ModelConfig, dyn: DynConsts, ic: ImplicitConsts,
                   state: PrognosticState, j2: int,
                   physics_fn: Optional[PhysicsFn] = None,
                   sppt_spec: Optional[torch.Tensor] = None) -> Tuple:
    """Full tendencies (tendencies.f90:11-37): grid-point dynamics (+
    physics at level 0) -> spectral -> spectral tendencies -> semi-implicit
    correction. Returns (vordt, divdt, tdt, psdt, trdt, physics_aux)."""
    phi0 = get_geopotential(dyn.gc, state.t[0], dyn.phis) \
        if physics_fn is not None else None
    gs, pg, psdt_g, utend, vtend, ttend, trtend, tgg = \
        grid_dynamics_tendencies(cfg, dyn, ic, state, j2, phi0, sppt_spec)

    aux = None
    if physics_fn is not None:
        du, dv, dt_, dq, aux = physics_fn(pg)
        utend = utend + du
        vtend = vtend + dv
        ttend = ttend + dt_
        trtend = trtend.clone()
        trtend[0] += dq

    vordt, divdt, tdt, trdt, psdt = grid_to_spectral_tendencies(
        cfg, dyn, gs, tgg, psdt_g, utend, vtend, ttend, trtend)

    if cfg.alph < 0.5:
        divdt, tdt, psdt = spectral_tendencies(
            cfg, dyn, ic, state, j2, divdt, tdt, psdt)
    else:
        divdt, tdt, psdt = spectral_tendencies(
            cfg, dyn, ic, state, 0, divdt, tdt, psdt)
        divdt, tdt, psdt = implicit_terms(ic, divdt, tdt, psdt)
    return vordt, divdt, tdt, psdt, trdt, aux
