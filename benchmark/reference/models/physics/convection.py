"""Simplified Tiedtke mass-flux convection (source/convection.f90).

The per-column loops with a variable top become masked static level
sweeps over the whole grid. Level indices (itop) are 1-based as in the
reference; itop = kx+1 means "no convection".
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...constants import ALHC, GRAV, P0
from ..axes import level as L

PSMIN = 0.8    # minimum normalized ps for convection
TRCNV = 6.0    # relaxation time (h)
RHBL = 0.9     # boundary-layer RH threshold
RHIL = 0.7     # intermediate-layer RH threshold (secondary flux)
ENTMAX = 0.5   # max entrainment (fraction of cloud-base mass flux)
SMF = 0.8      # secondary/primary mass flux ratio
FQMAX = 5.0


def entrainment_profile(fsg: np.ndarray) -> np.ndarray:
    """Entrainment for 1-based levels k = 2..kx-1, index k-2
    (convection.f90:62-70), in the table's dtype."""
    entr = np.maximum(0.0, fsg[1:-1] - fsg.dtype.type(0.5)) ** 2
    return entr * (fsg.dtype.type(ENTMAX) / np.sum(entr))


def cloud_base_mass_flux_scale(dhs: np.ndarray) -> float:
    """fm0 (convection.f90:52)."""
    return P0 * float(dhs[-1]) / (GRAV * TRCNV * 3600.0)


def diagnose_convection(wvi2: np.ndarray, psa, se, qa, qsat
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (itop [..., il, ix] 1-based int32, qdif) (convection.f90:170-245)."""
    kx = se.shape[-3]
    nl1 = kx - 1

    mss = se + ALHC * qsat
    mse0 = L(se, kx - 1) + ALHC * L(qa, kx - 1)
    mse1 = torch.minimum(mse0, L(se, nl1 - 1) + ALHC * L(qa, nl1 - 1))
    mss0 = torch.maximum(mse0, L(mss, kx - 1))

    ktop1 = torch.full_like(psa, float(kx))
    ktop2 = torch.full_like(psa, float(kx))
    msthr = torch.zeros_like(psa)
    # upward from the smallest candidate level, so the minimum qualifying
    # level and its mss2 win (the reference's downward loop keeps the last)
    for k in range(3, kx - 2):
        k0 = k - 1
        mss2 = L(mss, k0) + float(wvi2[k0]) * (L(mss, k0 + 1) - L(mss, k0))
        ktop1 = torch.where((mss0 > mss2) & (ktop1 > k),
                            torch.full_like(ktop1, float(k)), ktop1)
        take = (mse1 > mss2) & (ktop2 > k)
        msthr = torch.where(take, mss2, msthr)
        ktop2 = torch.where(take, torch.full_like(ktop2, float(k)), ktop2)

    qthr0 = RHBL * L(qsat, kx - 1)
    qthr1 = RHBL * L(qsat, nl1 - 1)
    lqthr = (L(qa, kx - 1) > qthr0) & (L(qa, nl1 - 1) > qthr1)

    base_ok = (psa > PSMIN) & (ktop1 < kx)
    conv_deep = base_ok & (ktop2 < kx)
    conv_rh = base_ok & (ktop2 >= kx) & lqthr
    conv = conv_deep | conv_rh

    itop = torch.where(conv, ktop1, float(kx + 1)).to(torch.int32)
    zero = torch.zeros_like(psa)
    qdif = torch.where(
        conv_deep,
        torch.maximum(L(qa, kx - 1) - qthr0, (mse0 - msthr) / ALHC),
        torch.where(conv_rh, L(qa, kx - 1) - qthr0, zero))
    return itop, qdif


def convection(fsg: np.ndarray, dhs: np.ndarray, wvi2: np.ndarray,
               psa, se, qa, qsat) -> Tuple[torch.Tensor, ...]:
    """-> (itop, cbmf, precnv, dfse, dfqa) (convection.f90:27-158).

    dfse/dfqa are net fluxes per layer, unscaled (the caller applies
    rps*grdscp / rps*grdsig, physics.f90:127-130).
    """
    kx = se.shape[-3]
    nl1 = kx - 1
    fm0 = cloud_base_mass_flux_scale(dhs)
    rdps = 2.0 / (1.0 - PSMIN)
    entr = entrainment_profile(fsg)

    itop, qdif = diagnose_convection(wvi2, psa, se, qa, qsat)
    conv = itop <= kx
    zero = torch.zeros_like(psa)

    dfse = torch.zeros_like(se)
    dfqa = torch.zeros_like(se)

    # 3.1 boundary layer / cloud base (1-based k = kx)
    qmax = torch.maximum(1.01 * L(qa, kx - 1), L(qsat, kx - 1))
    w = float(wvi2[nl1 - 1])
    sb = L(se, nl1 - 1) + w * (L(se, kx - 1) - L(se, nl1 - 1))
    qb = L(qa, nl1 - 1) + w * (L(qa, kx - 1) - L(qa, nl1 - 1))
    qb = torch.minimum(qb, L(qa, kx - 1))
    fpsa = psa * torch.clamp((psa - PSMIN) * rdps, max=1.0)
    fmass0 = fm0 * fpsa * torch.clamp(
        qdif / torch.clamp(qmax - qb, min=1e-30), max=FQMAX)
    cbmf = torch.where(conv, fmass0, zero)

    fmass = cbmf
    fus = cbmf * L(se, kx - 1)
    fuq = cbmf * qmax
    fds = cbmf * sb
    fdq = cbmf * qb
    dfse[..., kx - 1, :, :] = torch.where(conv, fds - fus, zero)
    dfqa[..., kx - 1, :, :] = torch.where(conv, fdq - fuq, zero)

    # 3.2 intermediate layers, downward k = kx-1 .. 2 (1-based)
    precnv = zero
    for k in range(kx - 1, 1, -1):
        k0 = k - 1
        mid = conv & (k >= itop + 1)
        top = conv & (k == itop)

        dfse[..., k0, :, :] += torch.where(mid, fus - fds, zero)
        dfqa[..., k0, :, :] += torch.where(mid, fuq - fdq, zero)

        enmass = float(entr[k - 2]) * psa * cbmf
        fmass_n = fmass + enmass
        fus_n = fus + enmass * L(se, k0)
        fuq_n = fuq + enmass * L(qa, k0)
        wk = float(wvi2[k0 - 1])
        sb_k = L(se, k0 - 1) + wk * (L(se, k0) - L(se, k0 - 1))
        qb_k = L(qa, k0 - 1) + wk * (L(qa, k0) - L(qa, k0 - 1))
        fds_n = fmass_n * sb_k
        fdq_n = fmass_n * qb_k

        dfse[..., k0, :, :] += torch.where(mid, fds_n - fus_n, zero)
        dfqa[..., k0, :, :] += torch.where(mid, fdq_n - fuq_n, zero)

        # secondary moisture flux (convection.f90:136-142)
        delq = RHIL * L(qsat, k0) - L(qa, k0)
        fsq = torch.where(mid & (delq > 0.0), SMF * cbmf * delq, zero)
        dfqa[..., k0, :, :] += fsq
        dfqa[..., kx - 1, :, :] += -fsq

        # 3.3 top layer: condensation and detrainment
        qsatb = L(qsat, k0) + float(wvi2[k0]) * (L(qsat, k0 + 1)
                                                 - L(qsat, k0))
        prec_k = torch.clamp(fuq - fmass * qsatb, min=0.0)
        precnv = torch.where(top, prec_k, precnv)
        dfse[..., k0, :, :] += torch.where(top, fus - fds + ALHC * prec_k,
                                           zero)
        dfqa[..., k0, :, :] += torch.where(top, fuq - fdq - prec_k, zero)

        fmass = torch.where(mid, fmass_n, fmass)
        fus = torch.where(mid, fus_n, fus)
        fuq = torch.where(mid, fuq_n, fuq)
        fds = torch.where(mid, fds_n, fds)
        fdq = torch.where(mid, fdq_n, fdq)

    return itop, cbmf, precnv, dfse, dfqa
