"""Shortwave radiation, cloud diagnosis and solar forcing
(source/shortwave_radiation.f90).

``shortwave_rad_fluxes`` also initializes the 4-band longwave
transmissivities and the stratospheric correction, as the reference does
(:190-233); they are carried in RadiationState across the steps that skip
the shortwave. Level indices (icltop) are 1-based, kx+1 = "no cloud".
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..axes import level as L, levels, per_level

SOLC = 342.0
RHCL1, RHCL2 = 0.30, 1.00
QACL = 0.20
WPCL = 0.2
PMAXCL = 10.0
CLSMAX = 0.60
CLSMINL = 0.15
GSE_S0, GSE_S1 = 0.25, 0.40
ALBCL, ALBCLS = 0.43, 0.50
EPSSW = 0.020

ABSDRY = 0.033
ABSAER = 0.033
ABSWV1 = 0.022
ABSWV2 = 15.000
ABSCL1 = 0.015
ABSCL2 = 0.15

ABLWIN = 0.3
ABLCO2 = 6.0
ABLWV1 = 0.7
ABLWV2 = 50.0
ABLCL1 = 12.0
ABLCL2 = 0.6

EPSLW = 0.05   # mod_radcon.f90:26
EMISFC = 0.98  # mod_radcon.f90:27


class RadiationState(NamedTuple):
    """Radiation fields carried between steps (an ensemble's with a
    leading member axis)."""
    tau2: torch.Tensor    # [4, kx, il, ix] LW transmissivities
    stratc: torch.Tensor  # [2, il, ix] stratospheric correction
    tt_rsw: torch.Tensor  # [kx, il, ix] SW heating (scaled)
    ssrd: torch.Tensor    # [il, ix] downward SW at surface
    ssr: torch.Tensor     # [il, ix] net downward SW at surface
    tsr: torch.Tensor     # [il, ix] net downward SW at TOA


def init_radiation_state(cfg, device, il=None) -> RadiationState:
    """The radiation state before the first SW step, on ``il`` latitude
    rows (a band's; all ``cfg.il`` by default)."""
    kx, ix = cfg.kx, cfg.ix
    il = cfg.il if il is None else il
    z = lambda *s: torch.zeros(s, dtype=cfg.rdtype, device=device)
    return RadiationState(
        tau2=torch.ones((4, kx, il, ix), dtype=cfg.rdtype, device=device),
        stratc=z(2, il, ix), tt_rsw=z(kx, il, ix), ssrd=z(il, ix),
        ssr=z(il, ix), tsr=z(il, ix))


def solar(sia: np.ndarray, coa: np.ndarray, tyear: float, csol: float
          ) -> np.ndarray:
    """Daily-average TOA insolation per latitude
    (shortwave_radiation.f90:287-329). Host-side numpy."""
    pigr = 2.0 * np.arcsin(1.0)
    alpha = 2.0 * pigr * tyear
    ca1, sa1 = np.cos(alpha), np.sin(alpha)
    ca2, sa2 = ca1 * ca1 - sa1 * sa1, 2.0 * sa1 * ca1
    ca3, sa3 = ca1 * ca2 - sa1 * sa2, sa1 * ca2 + sa2 * ca1
    decl = (0.006918 - 0.399912 * ca1 + 0.070257 * sa1 - 0.006758 * ca2
            + 0.000907 * sa2 - 0.002697 * ca3 + 0.001480 * sa3)
    fdis = (1.000110 + 0.034221 * ca1 + 0.001280 * sa1 + 0.000719 * ca2
            + 0.000077 * sa2)
    cdecl, sdecl = np.cos(decl), np.sin(decl)
    tdecl = sdecl / cdecl
    csolp = csol / pigr
    ch0 = np.clip(-tdecl * sia / coa, -1.0, 1.0)
    h0 = np.arccos(ch0)
    return csolp * fdis * (h0 * sia * sdecl + np.sin(h0) * coa * cdecl)


def zonal_average_fields(sia: np.ndarray, coa: np.ndarray, tyear: float
                         ) -> dict:
    """Daily zonally averaged solar forcing fields, [il] each
    (shortwave_radiation.f90:238-284). Host-side numpy."""
    alpha = 4.0 * np.arcsin(1.0) * (tyear + 10.0 / 365.0)
    coz1 = np.maximum(0.0, np.cos(alpha))
    coz2 = 1.8
    azen, nzen = 1.0, 2
    rzen = -np.cos(alpha) * 23.45 * np.arcsin(1.0) / 90.0
    fs0 = 6.0

    fsol = solar(sia, coa, tyear, 4.0 * SOLC)
    flat2 = 1.5 * sia**2 - 0.5
    ozupp = 0.5 * EPSSW * np.ones_like(sia)
    ozone = 0.4 * EPSSW * (1.0 + coz1 * sia + coz2 * flat2)
    zenit = 1.0 + azen * (1.0 - (coa * np.cos(rzen)
                                 + sia * np.sin(rzen)))**nzen
    return dict(fsol=fsol, ozupp=fsol * ozupp * zenit,
                ozone=fsol * ozone * zenit, zenit=zenit,
                stratz=np.maximum(fs0 - fsol, 0.0))


def clouds(qa, rh, precnv, precls, iptop, gse, fmask_l
           ) -> Tuple[torch.Tensor, ...]:
    """-> (icltop [..., il, ix] 1-based int32, cloudc, clstr, qcloud)
    (shortwave_radiation.f90:332-410)."""
    kx = qa.shape[-3]
    nl1 = kx - 1
    rrcl = 1.0 / (RHCL2 - RHCL1)
    zero = torch.zeros_like(precnv)

    above = L(rh, nl1 - 1) > RHCL1
    cloudc = torch.where(above, L(rh, nl1 - 1) - RHCL1, zero)
    icltop = torch.where(above, float(nl1), float(kx + 1)).to(qa.dtype)

    for k in range(3, kx - 1):  # 1-based k = 3..kx-2
        k0 = k - 1
        drh = L(rh, k0) - RHCL1
        take = (drh > cloudc) & (L(qa, k0) > QACL)
        cloudc = torch.where(take, drh, cloudc)
        icltop = torch.where(take, float(k), icltop)

    pr1 = torch.clamp(86.4 * (precnv + precls), max=PMAXCL)
    cloudc = torch.clamp(
        WPCL * torch.sqrt(pr1)
        + torch.clamp(cloudc * rrcl, max=1.0) ** 2, max=1.0)
    icltop = torch.minimum(iptop.to(cloudc.dtype), icltop)

    qcloud = L(qa, nl1 - 1)

    clfact = 1.2
    rgse = 1.0 / (GSE_S1 - GSE_S0)
    fstab = torch.clamp(rgse * (gse - GSE_S0), 0.0, 1.0)
    clstr = fstab * torch.clamp(CLSMAX - clfact * cloudc, min=0.0)
    clstrl = torch.clamp(clstr, min=CLSMINL) * L(rh, kx - 1)
    clstr = clstr + fmask_l * (clstrl - clstr)
    return icltop.to(torch.int32), cloudc, clstr, qcloud


def shortwave_rad_fluxes(fsg: np.ndarray, dhs: np.ndarray,
                         fsol, ozupp, ozone, zenit, stratz, albsfc,
                         psa, qa, icltop, cloudc, clstr, qcloud,
                         ablco2) -> Tuple[torch.Tensor, ...]:
    """-> (ssrd, ssr, tsr, dfabs, tau2, stratc)
    (shortwave_radiation.f90:74-234); tau2 holds the LONGWAVE
    transmissivities for the following LW computations."""
    kx = qa.shape[-3]
    nl1 = kx - 1
    fband2 = 0.05
    fband1 = 1.0 - fband2
    lev = lambda a: torch.as_tensor(a, dtype=qa.dtype,
                                    device=qa.device)[:, None, None]
    k1b = torch.arange(1, kx + 1, dtype=torch.int32,
                       device=qa.device)[:, None, None]
    zero = torch.zeros_like(psa)

    # SW transmissivity (bands 1-2) and cloud reflection (band 3)
    psaz = psa * zenit
    acloud = cloudc * torch.clamp(ABSCL1 * qcloud, max=ABSCL2)

    abs1 = ABSDRY + ABSAER * fsg**2
    in_cloud = k1b >= per_level(icltop)
    tau_1 = torch.exp(-per_level(psaz) * lev(dhs)
                      * (lev(abs1) + ABSWV1 * qa
                         + torch.where(in_cloud, per_level(acloud),
                                       torch.zeros_like(qa))))
    # k=1: dry only; k=kx: no cloud term
    tau_1[..., 0, :, :] = torch.exp(-psaz * float(dhs[0]) * ABSDRY)
    tau_1[..., kx - 1, :, :] = torch.exp(
        -psaz * float(dhs[kx - 1])
        * (float(abs1[kx - 1]) + ABSWV1 * L(qa, kx - 1)))
    tau_2 = torch.exp(-per_level(psaz) * lev(dhs) * ABSWV2 * qa)

    # cloud reflection (tau2 band 3)
    refl = torch.where(k1b == per_level(icltop), ALBCL * per_level(cloudc),
                       torch.zeros_like(qa))
    refl[..., kx - 1, :, :] += ALBCLS * clstr
    # if icltop == kx the reference overwrites with the stratiform term
    refl[..., kx - 1, :, :] = torch.where(
        icltop == kx, ALBCL * cloudc * 0.0 + ALBCLS * clstr, L(refl, kx - 1))

    # downward pass
    dfabs = [None] * kx
    tsr = fsol
    flux1 = fsol * fband1
    flux2 = fsol * fband2

    d = flux1
    flux1 = L(tau_1, 0) * (flux1 - ozupp * psa)
    dfabs[0] = d - flux1
    d = flux1
    flux1 = L(tau_1, 1) * (flux1 - ozone * psa)
    dfabs[1] = d - flux1

    refl_flux = [zero, zero]
    for k0 in range(2, kx):
        rk = flux1 * L(refl, k0)
        refl_flux.append(rk)
        flux1 = flux1 - rk
        d = flux1
        flux1 = L(tau_1, k0) * flux1
        dfabs[k0] = d - flux1

    for k0 in range(1, kx):
        dfabs[k0] = dfabs[k0] + flux2
        flux2 = L(tau_2, k0) * flux2
        dfabs[k0] = dfabs[k0] - flux2

    # surface and upward pass
    ssrd = flux1 + flux2
    flux1 = flux1 * albsfc
    ssr = ssrd - flux1

    for k0 in range(kx - 1, -1, -1):
        dfabs[k0] = dfabs[k0] + flux1
        flux1 = L(tau_1, k0) * flux1
        dfabs[k0] = dfabs[k0] - flux1
        flux1 = flux1 + refl_flux[k0]

    tsr = tsr - flux1
    dfabs = torch.stack(dfabs, dim=-3)

    # LW transmissivity initialization (shortwave_radiation.f90:190-228)
    dp = per_level(psa) * lev(dhs)
    lw1 = torch.exp(-dp * ABLWIN)
    lw2 = torch.exp(-dp * ablco2)
    lw3 = torch.exp(-dp * ABLWV1 * qa)
    lw4 = torch.exp(-dp * ABLWV2 * qa)
    lw3[..., 0, :, :] = 1.0   # stratosphere: no water vapour bands
    lw4[..., 0, :, :] = 1.0
    # cloudy free troposphere (1-based k = 3..kx-1)
    aclw = per_level(cloudc * ABLCL2)
    acl1 = torch.where(k1b < per_level(icltop), aclw,
                       ABLCL1 * per_level(cloudc))
    mid = lambda x: levels(x, 2, nl1)
    lw1[..., 2:nl1, :, :] = torch.exp(-mid(dp) * (ABLWIN + mid(acl1)))
    lw3[..., 2:nl1, :, :] = torch.exp(
        -mid(dp) * torch.maximum(ABLWV1 * mid(qa), aclw))
    lw4[..., 2:nl1, :, :] = torch.exp(
        -mid(dp) * torch.maximum(ABLWV2 * mid(qa), aclw))
    tau2 = torch.stack([lw1, lw2, lw3, lw4], dim=-4)

    eps1 = float(EPSLW / (dhs[0] + dhs[1]))
    stratc = torch.stack([stratz * psa, eps1 * psa], dim=-3)
    return ssrd, ssr, tsr, dfabs, tau2, stratc
