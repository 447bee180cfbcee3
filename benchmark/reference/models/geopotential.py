"""Hydrostatic geopotential in spectral space (source/geopotential.f90):
bottom-up accumulation over the levels plus the reference's lapse-rate
correction on the zonal-mean (m=0) coefficients."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import ModelConfig
from ..constants import RGAS
from .axes import SPEC, level


class GeopotentialConsts(NamedTuple):
    xgeop1: torch.Tensor  # [kx]
    xgeop2: torch.Tensor  # [kx] (index k holds the reference's xgeop2(k+1))
    corf: torch.Tensor    # [kx] lapse-rate correction (0 at k=0, kx-1)


def build_geopotential(cfg: ModelConfig, geom_np: dict,
                       device) -> GeopotentialConsts:
    hsg, fsg = geom_np["hsg"], geom_np["fsg"]
    kx = cfg.kx
    xgeop1 = RGAS * np.log(hsg[1:] / fsg)
    xgeop2 = np.zeros(kx)
    xgeop2[1:] = RGAS * np.log(fsg[1:] / hsg[1:-1])
    corf = np.zeros(kx)
    for k in range(1, kx - 1):
        corf[k] = xgeop1[k] * 0.5 * np.log(hsg[k + 1] / fsg[k]) \
            / np.log(fsg[k + 1] / fsg[k - 1])
    dev = lambda a: torch.as_tensor(a, dtype=cfg.rdtype, device=device)
    return GeopotentialConsts(xgeop1=dev(xgeop1), xgeop2=dev(xgeop2),
                              corf=dev(corf))


def get_geopotential(gc: GeopotentialConsts, t: torch.Tensor,
                     phis: torch.Tensor) -> torch.Tensor:
    """Spectral T [..., kx, mx, nx, 2] + phis [mx, nx, 2] -> phi
    [..., kx, mx, nx, 2] (geopotential.f90:33-57)."""
    kx = t.shape[-4]
    phi = [None] * kx
    phi[kx - 1] = phis + gc.xgeop1[kx - 1] * level(t, kx - 1, SPEC)
    for k in range(kx - 2, -1, -1):
        phi[k] = phi[k + 1] + gc.xgeop2[k + 1] * level(t, k + 1, SPEC) \
            + gc.xgeop1[k] * level(t, k, SPEC)
    phi = torch.stack(phi, dim=-4)
    corr = gc.corf[1: kx - 1, None, None] * (t[..., 2:kx, 0, :, :]
                                             - t[..., 0: kx - 2, 0, :, :])
    phi[..., 1: kx - 1, 0, :, :] += corr
    return phi
