"""Physics suite (source/physics.f90): convection -> large-scale
condensation -> shortwave radiation (every nstrad steps) -> longwave down
-> surface fluxes -> longwave up -> vertical diffusion with the surface
fluxes injected at the lowest level -> SPPT (multiplicative noise on the
tendencies, with ``sppt_on``).

``grid_physics_core`` is the plain PyTorch version of the column chain and
the reference of the CUDA kernel in ``fused.py``, whose wrapper
``fused_grid_physics`` runs the kernel on CUDA tensors and this chain on
CPU tensors. The small vertical tables live as numpy arrays of the run
dtype in PhysicsParams; the [il, ix] fields as tensors on the device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...config import ModelConfig
from ...constants import CP, GRAV, P0
from . import condensation, convection, longwave, shortwave
from . import sppt as sppt_mod
from . import surface as surface_mod
from . import vertical_diffusion as vdif_mod
from ..axes import level, per_level
from .humidity import spec_hum_to_rel_hum
from .shortwave import RadiationState


@dataclasses.dataclass(frozen=True)
class PhysicsParams:
    """Vertical tables (physics.f90:12-39), numpy in the run dtype, the
    time-invariant [il, ix] fields as device tensors, and the
    column-physics kernel's float64 argument block built from them."""
    fsg: np.ndarray       # [kx]
    dhs: np.ndarray       # [kx]
    sigh: np.ndarray      # [kx+1] half-level sigma (= hsg)
    sigl: np.ndarray      # [kx] log(fsg)
    wvi2: np.ndarray      # [kx] half-level interpolation weights wvi(:,2)
    grdsig: np.ndarray    # [kx] g/(dsigma p0)
    grdscp: np.ndarray    # [kx] g/(dsigma p0 cp)
    forog: torch.Tensor   # [il, ix] orographic drag factor
    coa: torch.Tensor     # [il] cos(lat)
    fmask_l: torch.Tensor  # [il, ix]
    fmask_s: torch.Tensor  # [il, ix]
    phis0: torch.Tensor   # [il, ix] filtered surface geopotential
    sppt_sigma: torch.Tensor  # [mx, nx] SPPT noise amplitude
    sppt_mu: torch.Tensor  # [kx] SPPT vertical taper (sppt.f90:20)


def build_physics_params(cfg: ModelConfig, geom_np: dict, sp_np: dict,
                         fmask_l: np.ndarray, fmask_s: np.ndarray,
                         phis0: np.ndarray, device) -> PhysicsParams:
    hsg, dhs, fsg = geom_np["hsg"], geom_np["dhs"], geom_np["fsg"]
    kx = cfg.kx
    sigl = np.log(fsg)
    sigh = hsg.copy()
    wvi1 = np.zeros(kx)
    wvi2 = np.zeros(kx)
    wvi1[: kx - 1] = 1.0 / (sigl[1:] - sigl[:-1])
    wvi2[: kx - 1] = (np.log(sigh[1:kx]) - sigl[: kx - 1]) * wvi1[: kx - 1]
    wvi2[kx - 1] = (np.log(0.99) - sigl[kx - 1]) * wvi1[kx - 2]
    grdsig = GRAV / (dhs * P0)
    grdscp = grdsig / CP

    t = np.float64 if cfg.precision == "fp64" else np.float32
    cast = lambda a: np.asarray(a, dtype=t)
    dev = lambda a: torch.as_tensor(cast(a), device=device)
    pp = PhysicsParams(
        fsg=cast(fsg), dhs=cast(dhs), sigh=cast(sigh), sigl=cast(sigl),
        wvi2=cast(wvi2), grdsig=cast(grdsig), grdscp=cast(grdscp),
        # the reference passes the spectrally FILTERED surface geopotential
        # here (forcing.f90:43)
        forog=dev(surface_mod.orographic_drag_factor(phis0)),
        coa=dev(geom_np["coa"]), fmask_l=dev(fmask_l), fmask_s=dev(fmask_s),
        phis0=dev(phis0),
        sppt_sigma=dev(sppt_mod.sppt_sigma(cfg, sp_np["el2"])),
        sppt_mu=dev(np.ones(kx)))
    return pp


class DailyForcing(NamedTuple):
    """Daily forcing fields (forcing.f90:15-100 + climatology
    interpolation of the land/sea models)."""
    fsol: torch.Tensor    # [il, 1] TOA insolation
    ozupp: torch.Tensor   # [il, 1]
    ozone: torch.Tensor   # [il, 1]
    zenit: torch.Tensor   # [il, 1]
    stratz: torch.Tensor  # [il, 1]
    ablco2: torch.Tensor  # [] CO2 LW absorptivity
    alb_l: torch.Tensor   # [il, ix]
    alb_s: torch.Tensor
    albsfc: torch.Tensor
    snowc: torch.Tensor
    tcorh: torch.Tensor   # [mx, nx, 2]
    qcorh: torch.Tensor   # [mx, nx, 2]
    stlcl_ob: torch.Tensor
    snowd_am: torch.Tensor
    soilw_am: torch.Tensor
    sstcl_ob: torch.Tensor
    sicecl_ob: torch.Tensor
    ticecl_ob: torch.Tensor
    sstan_ob: torch.Tensor
    # next-day interpolations, used by the day's last coupling step (the
    # reference couples after newdate, speedy.f90:47-53)
    stlcl_nx: torch.Tensor
    sstcl_nx: torch.Tensor
    sicecl_nx: torch.Tensor
    ticecl_nx: torch.Tensor
    sstan_nx: torch.Tensor


class SurfaceState(NamedTuple):
    """Prognostic and derived surface fields (land_model.f90:26-31,
    sea_model.f90:45-55)."""
    stl_lm: torch.Tensor
    stl_am: torch.Tensor
    sst_om: torch.Tensor
    tice_om: torch.Tensor
    sice_om: torch.Tensor
    sst_am: torch.Tensor
    sice_am: torch.Tensor
    tice_am: torch.Tensor
    ssti_om: torch.Tensor


class Fluxes(NamedTuple):
    """Per-step physics flux diagnostics (auxiliaries.f90:15-33)."""
    precnv: torch.Tensor
    precls: torch.Tensor
    cbmf: torch.Tensor
    tsr: torch.Tensor
    ssrd: torch.Tensor
    ssr: torch.Tensor
    slrd: torch.Tensor
    slr: torch.Tensor
    olr: torch.Tensor
    sfc: surface_mod.SurfaceFluxes


class PhysicsAux(NamedTuple):
    fluxes: Fluxes
    rad: RadiationState


def grid_physics_core(cfg: ModelConfig, pp: PhysicsParams,
                      compute_sw: bool,
                      ug, vg, tg, qg, phig, pslg,
                      fsol, ozupp, ozone, zenit, stratz, albsfc, ablco2,
                      alb_l, alb_s, snowc, soilw_am, stl_am, sst_am,
                      forog, coa, phis0, fmask_l,
                      tau2_in=None, stratc_in=None, tt_rsw_in=None,
                      ssrd_in=None):
    """The column-local physics chain (physics.f90:43-205): humidity ->
    convection -> LSC -> [SW clouds + fluxes] -> LW down -> surface fluxes
    -> LW up -> vertical diffusion + flux injection. Inputs are
    [..., kx, il, ix], [..., il, ix], [il, 1] or [il]; the leading
    dimensions (an ensemble's members) batch through, and inputs without
    them are shared by all members. On non-SW steps pass the carried
    RadiationState fields (tau2_in..ssrd_in).

    Returns (utend, vtend, ttend, qtend, precnv, precls, cbmf, slrd, slr,
    olr, sfc[, tau2, stratc, tt_rsw, ssrd, ssr, tsr if compute_sw]).
    """
    kx = cfg.kx
    fsg, dhs, sigh = pp.fsg, pp.dhs, pp.sigh
    lev = lambda a: torch.as_tensor(a, dtype=tg.dtype,
                                    device=tg.device)[:, None, None]
    grdsig, grdscp = lev(pp.grdsig), lev(pp.grdscp)

    psg = torch.exp(pslg)
    rps = 1.0 / psg
    qg = torch.clamp(qg, min=0.0)
    se = CP * tg + phig
    rh, qsat = spec_hum_to_rel_hum(tg, per_level(psg), lev(fsg), qg)

    # precipitation (physics.f90:124-138)
    itop, cbmf, precnv, dfse, dfqa = convection.convection(
        fsg, dhs, pp.wvi2, psg, se, qg, qsat)
    tt_cnv = dfse * per_level(rps) * grdscp
    qt_cnv = dfqa * per_level(rps) * grdsig
    icnv = kx - itop

    itop, precls, tt_lsc, qt_lsc = condensation.large_scale_condensation(
        fsg, dhs, psg, qg, qsat, itop)

    ttend = tt_cnv + tt_lsc
    qtend = qt_cnv + qt_lsc

    # radiation (physics.f90:144-186)
    if compute_sw:
        gse = ((level(se, kx - 2) - level(se, kx - 1))
               / (level(phig, kx - 2) - level(phig, kx - 1)))
        icltop, cloudc, clstr, qcloud = shortwave.clouds(
            qg, rh, precnv, precls, itop, gse, fmask_l)
        (ssrd, ssr, tsr, dfabs_sw, tau2,
         stratc) = shortwave.shortwave_rad_fluxes(
            fsg, dhs, fsol, ozupp, ozone, zenit, stratz, albsfc, psg, qg,
            icltop, cloudc, clstr, qcloud, ablco2)
        tt_rsw = dfabs_sw * per_level(rps) * grdscp
    else:
        tau2, stratc, tt_rsw, ssrd = tau2_in, stratc_in, tt_rsw_in, ssrd_in

    if cfg.lw_band_vectorized:
        dlw, ulw = longwave.downward_longwave_vec, longwave.upward_longwave_vec
    else:
        dlw, ulw = longwave.downward_longwave, longwave.upward_longwave
    slrd, dfabs_lw, st4a1, st4a2, lwflux = dlw(pp.wvi2, tau2, tg)

    # surface fluxes + land skin temperature (physics.f90:168-176)
    sfc = surface_mod.surface_fluxes(
        float(pp.wvi2[kx - 1]), float(pp.sigl[kx - 1]), forog, coa,
        stl_am, soilw_am, alb_l, alb_s, snowc,
        psg, ug, vg, tg, qg, rh, phig, phis0, fmask_l, sst_am, ssrd, slrd)

    slr, olr, dfabs_lw = ulw(
        dhs, tau2, stratc, tg, sfc.tsfc, slrd, level(sfc.slru, 2), st4a1,
        st4a2, lwflux, dfabs_lw)
    tt_rlw = dfabs_lw * per_level(rps) * grdscp
    ttend = ttend + tt_rsw + tt_rlw

    # PBL: vertical diffusion + surface-flux injection (physics.f90:192-205)
    tt_pbl, qt_pbl = vdif_mod.vertical_diffusion(
        fsg, dhs, sigh, se, rh, qg, qsat, phig, icnv)
    g_k, c_k = float(pp.grdsig[kx - 1]), float(pp.grdscp[kx - 1])
    utend = torch.zeros_like(ttend)
    vtend = torch.zeros_like(ttend)
    utend[..., kx - 1, :, :] = level(sfc.ustr, 2) * rps * g_k
    vtend[..., kx - 1, :, :] = level(sfc.vstr, 2) * rps * g_k
    tt_pbl[..., kx - 1, :, :] += level(sfc.shf, 2) * rps * c_k
    qt_pbl[..., kx - 1, :, :] += level(sfc.evap, 2) * rps * g_k
    ttend = ttend + tt_pbl
    qtend = qtend + qt_pbl

    base = (utend, vtend, ttend, qtend, precnv, precls, cbmf, slrd, slr,
            olr, sfc)
    if compute_sw:
        return base + (tau2, stratc, tt_rsw, ssrd, ssr, tsr)
    return base


def get_physical_tendencies(cfg: ModelConfig, pp: PhysicsParams,
                            daily: DailyForcing, surf: SurfaceState,
                            rad: RadiationState, compute_sw: bool, pg,
                            sppt_pattern: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor,
                                       PhysicsAux]:
    """Physics tendencies at time level 0 (physics.f90:43-223) from the
    level-0 grid fields ``pg``. Returns the grid-point tendency increments
    (utend, vtend, ttend, qtend) and PhysicsAux; ``compute_sw`` is the
    shortwave cadence (speedy.f90:35). With ``sppt_on`` the increments are
    multiplied by 1 + the SPPT pattern: ``sppt_pattern`` (clipped, from
    sppt.gen_sppt) where given, else ``pg.sppt`` clipped to [-1, 1]."""
    from .fused import fused_grid_physics
    outs = fused_grid_physics(cfg, pp, compute_sw, daily, surf, rad, pg)
    (utend, vtend, ttend, qtend, precnv, precls, cbmf, slrd, slr, olr,
     sfc) = outs[:11]
    if compute_sw:
        rad = RadiationState(*outs[11:])

    # SPPT multiplicative noise on the physics increments
    # (physics.f90:207-222); the column kernel's outputs are unchanged
    if cfg.sppt_on:
        pattern = sppt_pattern if sppt_pattern is not None \
            else torch.clamp(pg.sppt, -1.0, 1.0)
        fac = 1.0 + pattern * pp.sppt_mu[:, None, None]
        utend, vtend = fac * utend, fac * vtend
        ttend, qtend = fac * ttend, fac * qtend
    fluxes = Fluxes(precnv=precnv, precls=precls, cbmf=cbmf, tsr=rad.tsr,
                    ssrd=rad.ssrd, ssr=rad.ssr, slrd=slrd, slr=slr, olr=olr,
                    sfc=sfc)
    return utend, vtend, ttend, qtend, PhysicsAux(fluxes=fluxes, rad=rad)
