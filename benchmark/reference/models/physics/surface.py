"""Surface fluxes of momentum, energy and moisture, with the implicit land
skin-temperature update (source/surface_fluxes.f90). The land/sea/blend
triples are stacked [..., 3, il, ix] in that order."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...constants import ALHC, CP, GRAV, P0, RGAS, SBC
from ..axes import level as L
from .shortwave import EMISFC
from .humidity import get_qsat

FWIND0 = 0.95
FTEMP0 = 1.0
CDL = 2.4e-3
CDS = 1.0e-3
CHL = 1.2e-3
CHS = 0.9e-3
VGUST = 5.0
CTDAY = 1.0e-2
DTHETA = 3.0
FSTAB = 0.67
HDRAG = 2000.0
CLAMBDA = 7.0
CLAMBSN = 7.0


class SurfaceFluxes(NamedTuple):
    """_l = land, _s = sea, _w = blend (auxiliaries.f90:15-33); an
    ensemble's with a leading member axis."""
    ustr: torch.Tensor   # [3, il, ix]
    vstr: torch.Tensor   # [3, il, ix]
    shf: torch.Tensor    # [3, il, ix]
    evap: torch.Tensor   # [3, il, ix]
    slru: torch.Tensor   # [3, il, ix]
    hfluxn: torch.Tensor  # [2, il, ix] net downward heat flux (land, sea)
    tsfc: torch.Tensor
    tskin: torch.Tensor
    u0: torch.Tensor
    v0: torch.Tensor
    t0: torch.Tensor


def orographic_drag_factor(phi0: np.ndarray) -> np.ndarray:
    """forog (surface_fluxes.f90:300-309), host-side setup."""
    rhdrag = 1.0 / (GRAV * HDRAG)
    return 1.0 + rhdrag * (1.0 - np.exp(-np.maximum(phi0, 0.0) * rhdrag))


def surface_fluxes(wvi2_kx: float, sigl_kx: float, forog, coa,
                   stl_am, soilw_am, alb_l, alb_s, snowc,
                   psa, ua, va, ta, qa, rh, phi, phi0, fmask_l, tsea,
                   ssrd, slrd) -> SurfaceFluxes:
    """Full land+sea pass (surface_fluxes.f90:42-296). ua..phi are
    [..., kx, il, ix], coa is [il], the others [..., il, ix]."""
    kx = ta.shape[-3]
    nl1 = kx - 1
    esbc = EMISFC * SBC
    coa2 = coa[:, None]

    # 1. near-surface extrapolation
    u0 = FWIND0 * L(ua, kx - 1)
    v0 = FWIND0 * L(va, kx - 1)

    dt1 = wvi2_kx * (L(ta, kx - 1) - L(ta, nl1 - 1))
    t1_l = L(ta, kx - 1) + dt1
    t1_s = t1_l - phi0 * dt1 / (RGAS * 288.0 * sigl_kx)
    t2_s = L(ta, kx - 1) + L(phi, kx - 1) / CP
    t2_l = t2_s - phi0 / CP

    lapse_neg = L(ta, kx - 1) > L(ta, nl1 - 1)
    gtemp0 = 1.0 - FTEMP0
    t1_l = torch.where(lapse_neg, FTEMP0 * t1_l + gtemp0 * t2_l, L(ta, kx - 1))
    t1_s = torch.where(lapse_neg, FTEMP0 * t1_s + gtemp0 * t2_s, L(ta, kx - 1))
    t0 = t1_s + fmask_l * (t1_l - t1_s)

    denvvs0 = (P0 * psa / (RGAS * t0)) * torch.sqrt(
        u0 ** 2 + v0 ** 2 + VGUST ** 2)

    # 2. land fluxes with prescribed skin temperature
    tskin = stl_am + CTDAY * torch.sqrt(coa2) * ssrd * (1.0 - alb_l) * psa

    rdth = FSTAB / DTHETA
    astab = 0.5
    dthl = torch.where(tskin > t2_l,
                       torch.clamp(tskin - t2_l, max=DTHETA),
                       torch.clamp(astab * (tskin - t2_l), min=-DTHETA))
    denvvs1 = denvvs0 * (1.0 + dthl * rdth)

    cdldv = CDL * denvvs0 * forog
    ustr_l = -cdldv * L(ua, kx - 1)
    vstr_l = -cdldv * L(va, kx - 1)

    chlcp = CHL * CP
    shf_l = chlcp * denvvs1 * (tskin - t1_l)

    q1_l = L(qa, kx - 1)
    qsat_skin = get_qsat(tskin, psa, 1.0)
    evap_l = CHL * denvvs1 * torch.clamp(soilw_am * qsat_skin - q1_l,
                                         min=0.0)

    # 3. land energy balance: implicit skin-temperature update
    tsk3 = tskin ** 3
    dslr = 4.0 * esbc * tsk3
    slru_l = esbc * tsk3 * tskin
    hfluxn_l = ssrd * (1.0 - alb_l) + slrd - (slru_l + shf_l + ALHC * evap_l)

    clamb = CLAMBDA + snowc * (CLAMBSN - CLAMBDA)
    hfluxn_l = hfluxn_l - clamb * (tskin - stl_am)
    qsat_skin1 = get_qsat(tskin + 1.0, psa, 1.0)
    dqsat = torch.where(evap_l > 0.0, soilw_am * (qsat_skin1 - qsat_skin),
                        torch.zeros_like(evap_l))
    dtskin = hfluxn_l / (clamb + dslr + CHL * denvvs1 * (CP + ALHC * dqsat))
    tskin = tskin + dtskin
    shf_l = shf_l + chlcp * denvvs1 * dtskin
    evap_l = evap_l + CHL * denvvs1 * dqsat * dtskin
    slru_l = slru_l + dslr * dtskin
    hfluxn_l = clamb * (tskin - stl_am)

    # 4. sea fluxes (the reference ADDS shf and evap in hfluxn, :278)
    dths = torch.where(tsea > t2_s,
                       torch.clamp(tsea - t2_s, max=DTHETA),
                       torch.clamp(astab * (tsea - t2_s), min=-DTHETA))
    denvvs2 = denvvs0 * (1.0 + dths * rdth)
    q1_s = L(qa, kx - 1)

    cdsdv = CDS * denvvs2
    ustr_s = -cdsdv * L(ua, kx - 1)
    vstr_s = -cdsdv * L(va, kx - 1)

    shf_s = CHS * CP * denvvs2 * (tsea - t1_s)
    evap_s = CHS * denvvs2 * (get_qsat(tsea, psa, 1.0) - q1_s)
    slru_s = esbc * tsea ** 4
    hfluxn_s = (ssrd * (1.0 - alb_s) + slrd - slru_s + shf_s
                + ALHC * evap_s)

    # 5. land/sea blend (surface_fluxes.f90:285-295)
    def trio(a_l, a_s):
        return torch.stack([a_l, a_s, a_s + fmask_l * (a_l - a_s)], dim=-3)

    return SurfaceFluxes(
        ustr=trio(ustr_l, ustr_s), vstr=trio(vstr_l, vstr_s),
        shf=trio(shf_l, shf_s), evap=trio(evap_l, evap_s),
        slru=trio(slru_l, slru_s),
        hfluxn=torch.stack([hfluxn_l, hfluxn_s], dim=-3),
        tsfc=tsea + fmask_l * (stl_am - tsea),
        tskin=tsea + fmask_l * (tskin - tsea),
        u0=u0, v0=v0, t0=t0)
