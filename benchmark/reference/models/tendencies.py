"""Dynamical-core tendency assembly (source/tendencies.f90).

Per-level loops become batched tensor ops over the leading level axis, and
the per-step transforms of each direction are batched into a few
contractions: one synthesis of the merged stack of every scalar field,
level and time level (the physics time level rides along), one of the
winds, and one analysis each of the u/v-type and scalar tendencies.

Grid-point fields use [..., kx, il, ix]; spectral fields
[..., kx, mx, nx, 2]. The leading dimensions, an ensemble's members, batch
through every function: the field and level axes are counted from the
right, and the stacks of each transform are concatenated on the field axis,
so that all members share one contraction.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..config import ModelConfig
from ..constants import AKAP, RGAS
from ..geometry import Geometry
from ..ops import spectral as sp
from .axes import SPEC, level, level_sums, levels, per_level
from .geopotential import GeopotentialConsts, get_geopotential
from .implicit import ImplicitConsts, implicit_terms
from .state import PrognosticState, time_level


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
    top and bottom -> [..., kx+1, il, ix]."""
    kx = f.shape[-3]
    interior = levels(shd, 1, kx) * (levels(f, 1, kx) - levels(f, 0, kx - 1))
    zero = torch.zeros_like(levels(interior, 0, 1))
    return torch.cat([zero, interior, zero], dim=-3)


def grid_dynamics_tendencies(cfg: ModelConfig, dyn: DynConsts,
                             ic: ImplicitConsts, state: PrognosticState,
                             j2: int,
                             phi0_spec: Optional[torch.Tensor] = None,
                             sppt_spec: Optional[torch.Tensor] = None
                             ) -> Tuple:
    """Nonlinear grid-point dynamics tendencies (tendencies.f90:49-197).

    Returns (gs, pg, psdt_g, utend, vtend, ttend, trtend, tgg); ``pg`` is
    the level-0 PhysicsGridState, or None when ``phi0_spec`` is None (the
    adiabatic core). ``sppt_spec`` [..., kx, mx, nx, 2], the updated SPPT
    state, rides the merged synthesis and comes out as ``pg.sppt``. Any
    leading dimensions (an ensemble's members) batch through.
    """
    sc, geom = dyn.sc, dyn.geom
    dhs = geom.dhs[:, None, None]
    dhsr = geom.dhsr[:, None, None]
    fsgr = geom.fsgr[:, None, None]
    kx, ntr = cfg.kx, cfg.ntr
    with_phys = phi0_spec is not None
    s2, s0 = time_level(state, j2), time_level(state, 0)

    # spectral -> grid of every field, level and time level at once
    vor_s, div_s = s2.vor, s2.div
    fields = [vor_s, div_s, s2.t, s2.tr.flatten(-5, -4)]
    if with_phys:
        fields += [s0.t, s0.tr.select(-5, 0), phi0_spec, s0.ps.unsqueeze(-4)]
    if sppt_spec is not None:
        fields.append(sppt_spec)
    plain_g = sp.spec_to_grid(sc, torch.cat(fields, dim=-4))
    vorg = levels(plain_g, 0, kx)
    divg = levels(plain_g, kx, 2 * kx)
    tg = levels(plain_g, 2 * kx, 3 * kx)
    base = (3 + ntr) * kx
    trg = levels(plain_g, 3 * kx, base).unflatten(-3, (ntr, kx))

    if with_phys:
        vor_uv = torch.cat([vor_s, s0.vor], dim=-4)
        div_uv = torch.cat([div_s, s0.div], dim=-4)
    else:
        vor_uv, div_uv = vor_s, div_s
    ucos, vcos = sp.uvspec(sc, vor_uv, div_uv)
    px_s, py_s = sp.grad(sc, s2.ps)
    nuv = ucos.shape[-4]
    wind = torch.cat([ucos, vcos, px_s.unsqueeze(-4), py_s.unsqueeze(-4)],
                     dim=-4)
    wind_g = sp.spec_to_grid(sc, wind, scale_by_inv_cos=True)
    ug, vg = levels(wind_g, 0, kx), levels(wind_g, nuv, nuv + kx)
    px, py = level(wind_g, 2 * nuv), level(wind_g, 2 * nuv + 1)

    pg = None
    if with_phys:
        pg = PhysicsGridState(
            ug=levels(wind_g, kx, nuv), vg=levels(wind_g, nuv + kx, 2 * nuv),
            tg=levels(plain_g, base, base + kx),
            qg=levels(plain_g, base + kx, base + 2 * kx),
            phig=levels(plain_g, base + 2 * kx, base + 3 * kx),
            pslg=level(plain_g, base + 3 * kx),
            sppt=(levels(plain_g, base + 3 * kx + 1, base + 4 * kx + 1)
                  if sppt_spec is not None else None))

    vorg = vorg + geom.coriol[None, :, None]
    # per-column fields [..., il, ix] meet per-level ones [..., kx, il, ix]
    # through per_level

    # vertical-mean winds and log-ps tendency (tendencies.f90:109-126)
    umean = torch.sum(ug * dhs, dim=-3)
    vmean = torch.sum(vg * dhs, dim=-3)
    dmean = torch.sum(divg * dhs, dim=-3)
    psdt_g = -umean * px - vmean * py

    # sigma-dot vertical velocity (tendencies.f90:128-143)
    puv = ((ug - per_level(umean)) * per_level(px)
           + (vg - per_level(vmean)) * per_level(py))
    zero2 = torch.zeros_like(levels(puv, 0, 1))
    shd = torch.cat(
        [zero2, -torch.cumsum(dhs * (puv + divg - per_level(dmean)), dim=-3)],
        dim=-3)
    shm = torch.cat([zero2, -torch.cumsum(dhs * puv, dim=-3)], dim=-3)

    tgg = tg - ic.tref[:, None, None]

    # wind tendencies (tendencies.f90:151-172)
    tmp_u = _half_level_advection(shd, ug)
    utend = vg * vorg - tgg * RGAS * per_level(px) - level_sums(tmp_u) * dhsr
    tmp_v = _half_level_advection(shd, vg)
    vtend = -ug * vorg - tgg * RGAS * per_level(py) - level_sums(tmp_v) * dhsr

    # temperature tendency (tendencies.f90:174-184)
    dtref = (ic.tref[1:] - ic.tref[:-1])[:, None, None]
    tmp_t = _half_level_advection(shd, tgg) \
        + torch.cat([zero2, levels(shm, 1, kx) * dtref, zero2], dim=-3)
    ttend = (tgg * divg - level_sums(tmp_t) * dhsr
             + fsgr * tgg * level_sums(shd)
             + ic.tref3[:, None, None] * level_sums(shm)
             + AKAP * (tg * puv - tgg * per_level(dmean)))

    # tracer tendency (tendencies.f90:186-197)
    def tracer_tend(q):
        tmp_q = _half_level_advection(shd, q)
        # reference quirk: vertical advection zeroed on half levels 2-3
        # (1-based temp(:,:,2:3)=0, tendencies.f90:192)
        tmp_q[..., 1:3, :, :] = 0.0
        return q * divg - level_sums(tmp_q) * dhsr
    trtend = torch.stack([tracer_tend(trg.select(-4, i)) for i in range(ntr)],
                         dim=-4)

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
    trg = [gs.trg.select(-4, i) for i in range(ntr)]
    u_stack = torch.cat([utend, -gs.ug * tgg] + [-gs.ug * q for q in trg],
                        dim=-3)
    v_stack = torch.cat([vtend, -gs.vg * tgg] + [-gs.vg * q for q in trg],
                        dim=-3)
    vor_out, div_out = sp.vdspec(sc, u_stack, v_stack, half_cos_scaling=True)
    nf = div_out.shape[-4]
    vordt = levels(vor_out, 0, kx, SPEC)
    tdt_adv = levels(div_out, kx, 2 * kx, SPEC)
    trdt_adv = levels(div_out, 2 * kx, nf, SPEC).unflatten(-4, (ntr, kx))

    ke = 0.5 * (gs.ug**2 + gs.vg**2)
    scal = torch.cat([ke, ttend, trtend.flatten(-4, -3),
                      psdt_g.unsqueeze(-3)], dim=-3)
    scal_s = sp.grid_to_spec(sc, scal)
    ns = scal_s.shape[-4]
    divdt = levels(div_out, 0, kx, SPEC) \
        - sp.laplacian(sc, levels(scal_s, 0, kx, SPEC))
    tdt = tdt_adv + levels(scal_s, kx, 2 * kx, SPEC)
    trdt = trdt_adv \
        + levels(scal_s, 2 * kx, ns - 1, SPEC).reshape(trdt_adv.shape)
    psdt = level(scal_s, ns - 1, SPEC).clone()
    psdt[..., 0, 0, :] = 0.0
    return vordt, divdt, tdt, trdt, psdt


def spectral_tendencies(cfg: ModelConfig, dyn: DynConsts, ic: ImplicitConsts,
                        state: PrognosticState, j: int,
                        divdt, tdt, psdt) -> Tuple:
    """Linear spectral tendencies at time level ``j``
    (tendencies.f90:242-293)."""
    sc, geom = dyn.sc, dyn.geom
    dhs = geom.dhs[:, None, None, None]
    dhsr = geom.dhsr[:, None, None, None]
    sj = time_level(state, j)
    div_s = sj.div
    kx = div_s.shape[-4]

    dmeanc = torch.sum(div_s * dhs, dim=-4)
    psdt = psdt - dmeanc
    psdt[..., 0, 0, :] = 0.0

    # sigma-dot on half levels; the bottom half level stays exactly zero
    # (tendencies.f90:270-272)
    zero = torch.zeros_like(levels(div_s, 0, 1, SPEC))
    sigdtc = torch.cat(
        [zero, -torch.cumsum(dhs[:-1] * (levels(div_s, 0, kx - 1, SPEC)
                                         - dmeanc.unsqueeze(-4)), dim=-4),
         zero], dim=-4)
    dtref = (ic.tref[1:] - ic.tref[:-1])[:, None, None, None]
    dumk = torch.cat([zero, levels(sigdtc, 1, kx, SPEC) * dtref, zero],
                     dim=-4)

    tdt = (tdt - level_sums(dumk, SPEC) * dhsr
           + ic.tref3[:, None, None, None] * level_sums(sigdtc, SPEC)
           - ic.tref2[:, None, None, None] * dmeanc.unsqueeze(-4))

    phi = get_geopotential(dyn.gc, sj.t, dyn.phis)
    divdt = divdt - sp.laplacian(
        sc, phi + RGAS * ic.tref[:, None, None, None] * sj.ps.unsqueeze(-4))
    return divdt, tdt, psdt


def get_tendencies(cfg: ModelConfig, dyn: DynConsts, ic: ImplicitConsts,
                   state: PrognosticState, j2: int,
                   physics_fn: Optional[PhysicsFn] = None,
                   sppt_spec: Optional[torch.Tensor] = None) -> Tuple:
    """Full tendencies (tendencies.f90:11-37): grid-point dynamics (+
    physics at level 0) -> spectral -> spectral tendencies -> semi-implicit
    correction. Returns (vordt, divdt, tdt, psdt, trdt, physics_aux)."""
    phi0 = get_geopotential(dyn.gc, time_level(state, 0).t, dyn.phis) \
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
        trtend[..., 0, :, :, :] += dq

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
