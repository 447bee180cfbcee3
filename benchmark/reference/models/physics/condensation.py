"""Large-scale condensation: relaxation of q towards a sigma-dependent RH
threshold, with latent heating and diagnosed precipitation
(source/large_scale_condensation.f90)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...constants import ALHC, CP, GRAV, P0
from ..axes import per_level

TRLSC = 4.0    # relaxation time (h)
RHLSC = 0.9    # RH threshold at sigma=1
DRHLSC = 0.1   # vertical range of RH threshold
RHBLSC = 0.95  # boundary-layer RH threshold
QSMAX = 10.0
RTLSC = 1.0 / (TRLSC * 3600.0)


def lsc_profiles(fsg: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(rhref, dqmax) level profiles (lsc f90:40-50), in fsg's dtype."""
    sig2 = fsg**2
    rhref = RHLSC + DRHLSC * (sig2 - 1.0)
    rhref[-1] = max(float(rhref[-1]), RHBLSC)
    return rhref, QSMAX * sig2 * RTLSC


def large_scale_condensation(fsg: np.ndarray, dhs: np.ndarray,
                             psa: torch.Tensor, qa: torch.Tensor,
                             qsat: torch.Tensor, itop: torch.Tensor
                             ) -> Tuple[torch.Tensor, ...]:
    """-> (itop, precls, dtlsc, dqlsc) (lsc f90:33-95)."""
    kx = qa.shape[-3]
    tfact = ALHC / CP
    prg = P0 / GRAV
    psa2 = psa * psa
    lev = lambda a: torch.as_tensor(a, dtype=qa.dtype,
                                    device=qa.device)[:, None, None]
    rhref, dqmax = lsc_profiles(fsg)

    dqa = lev(rhref) * qsat - qa
    cond = dqa < 0.0
    cond[..., 0, :, :] = False  # level 1 excluded (loops start at k=2)
    zero = torch.zeros_like(qa)
    dqlsc = torch.where(cond, dqa * RTLSC, zero)
    dtlsc = torch.where(
        cond, tfact * torch.minimum(-dqlsc, lev(dqmax) * per_level(psa2)),
        zero)

    # cloud top: min(lowest condensing level, itop), 1-based
    k1b = torch.arange(1, kx + 1, dtype=torch.int32,
                       device=qa.device)[:, None, None]
    ktop = torch.where(cond, k1b, kx + 1).amin(dim=-3)
    itop = torch.minimum(ktop, itop)

    precls = -torch.sum(lev(dhs[1:] * prg) * dqlsc[..., 1:, :, :],
                        dim=-3) * psa
    return itop, precls, dtlsc, dqlsc
