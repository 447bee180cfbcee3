"""Vertical diffusion and shallow convection
(source/vertical_diffusion.f90): shallow convection between the lowest two
layers, moisture diffusion in stable conditions, and dry-static-energy
redistribution under super-adiabatic lapse rates."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...constants import ALHC, CP
from ..axes import level as L, per_level

TRSHC = 6.0    # shallow-convection relaxation time (h)
TRVDI = 24.0   # moisture-diffusion relaxation time (h)
TRVDS = 6.0    # super-adiabatic relaxation time (h)
REDSHC = 0.5   # shallow-convection reduction in deep-convection areas
RHGRAD = 0.5   # max d(RH)/d(sigma)
SEGRAD = 0.1   # min d(DSE)/d(phi)


def vdif_coefficients(dhs: np.ndarray, sigh: np.ndarray) -> dict:
    """Rate coefficients (vertical_diffusion.f90:55-70), in the tables'
    dtype; sigh is the 0..kx half-level array."""
    kx = dhs.shape[0]
    nl1 = kx - 1
    cshc = dhs[kx - 1] / 3600.0
    cvdi = (sigh[nl1] - sigh[1]) / ((nl1 - 1) * 3600.0)
    return dict(fshcq=cshc / TRSHC, fshcse=cshc / (TRSHC * CP),
                fvdiq=cvdi / TRVDI, fvdise=cvdi / (TRVDS * CP),
                rsig=1.0 / dhs, rsig1=1.0 / (1.0 - sigh[1:kx]))


def vertical_diffusion(fsg: np.ndarray, dhs: np.ndarray, sigh: np.ndarray,
                       se, rh, qa, qsat, phi, icnv
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (ttenvd, qtenvd) [..., kx, il, ix] (vertical_diffusion.f90:30-143);
    the wind tendencies of the scheme are zero."""
    kx = se.shape[-3]
    nl1 = kx - 1
    c = vdif_coefficients(dhs, sigh)
    rsig, rsig1, fvdiq = c["rsig"], c["rsig1"], c["fvdiq"]
    zero = torch.zeros_like(L(se, 0))

    ttenvd = torch.zeros_like(se)
    qtenvd = torch.zeros_like(se)

    # 2. shallow convection (lowest two layers)
    drh0 = RHGRAD * float(fsg[kx - 1] - fsg[nl1 - 1])
    fvdiq2 = float(fvdiq * sigh[nl1])
    dmse = L(se, kx - 1) - L(se, nl1 - 1) \
        + ALHC * (L(qa, kx - 1) - L(qsat, nl1 - 1))
    drh = L(rh, kx - 1) - L(rh, nl1 - 1)
    fcnv = torch.where(icnv > 0, REDSHC, 1.0).to(se.dtype)

    unstable = dmse >= 0.0
    fluxse = torch.where(unstable, fcnv * float(c["fshcse"]) * dmse, zero)
    ttenvd[..., nl1 - 1, :, :] += fluxse * float(rsig[nl1 - 1])
    ttenvd[..., kx - 1, :, :] += -fluxse * float(rsig[kx - 1])

    fluxq_sc = torch.where(unstable & (drh >= 0.0),
                           fcnv * float(c["fshcq"]) * L(qsat, kx - 1) * drh,
                           zero)
    fluxq_st = torch.where((~unstable) & (drh > drh0),
                           fvdiq2 * L(qsat, nl1 - 1) * drh, zero)
    fluxq = fluxq_sc + fluxq_st
    qtenvd[..., nl1 - 1, :, :] += fluxq * float(rsig[nl1 - 1])
    qtenvd[..., kx - 1, :, :] += -fluxq * float(rsig[kx - 1])

    # 3. moisture diffusion above the PBL (1-based k = 3..kx-2 where
    # sigh(k) > 0.5)
    for k in range(3, kx - 1):
        if float(sigh[k]) <= 0.5:
            continue
        k0 = k - 1
        drh0_k = RHGRAD * float(fsg[k0 + 1] - fsg[k0])
        fvdiq2_k = float(fvdiq * sigh[k])
        drh_k = L(rh, k0 + 1) - L(rh, k0)
        fq = torch.where(drh_k >= drh0_k, fvdiq2_k * L(qsat, k0) * drh_k,
                         zero)
        qtenvd[..., k0, :, :] += fq * float(rsig[k0])
        qtenvd[..., k0 + 1, :, :] += -fq * float(rsig[k0 + 1])

    # 4. super-adiabatic lapse-rate damping (1-based k = 1..kx-1): the
    # energy is taken from all layers below k
    fvdise = float(c["fvdise"])
    for k0 in range(kx - 1):
        se0 = L(se, k0 + 1) + SEGRAD * (L(phi, k0) - L(phi, k0 + 1))
        fse = torch.where(L(se, k0) < se0, fvdise * (se0 - L(se, k0)), zero)
        ttenvd[..., k0, :, :] += fse * float(rsig[k0])
        ttenvd[..., k0 + 1:, :, :] += -per_level(fse * float(rsig1[k0]))
    return ttenvd, qtenvd
