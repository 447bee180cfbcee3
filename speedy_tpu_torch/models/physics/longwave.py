"""Longwave radiation: 4-band emission/absorption sweeps
(source/longwave_radiation.f90), in the band-vectorized order of the JAX
package's ``*_vec`` sweeps. The reference-order sweeps are not ported yet
(``lw_band_vectorized=False`` is refused)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...constants import SBC
from .shortwave import EPSLW, EMISFC


def _fband_at(ta: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Band energy fractions for nint(ta), stacked on ``dim`` (4 bands):
    the clamped quadratics of the reference's table
    (longwave_radiation.f90:197-220) evaluated on floor(ta + 0.5), the
    nint of the positive temperatures involved, clamped to 200..320 K."""
    tq = torch.clamp(torch.floor(ta + 0.5), 200.0, 320.0)
    eps1 = 1.0 - EPSLW
    f1 = (0.148 - 3.0e-6 * (tq - 247.0) ** 2) * eps1
    f2 = (0.356 - 5.2e-6 * (tq - 282.0) ** 2) * eps1
    f3 = (0.314 + 1.0e-5 * (tq - 315.0) ** 2) * eps1
    f0 = eps1 - f1 - f2 - f3
    return torch.stack([f0, f1, f2, f3], dim=dim)


def _band_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading band axis, in band order."""
    out = x[0]
    for b in range(1, x.shape[0]):
        out = out + x[b]
    return out


def downward_longwave_vec(wvi2: np.ndarray, tau2: torch.Tensor,
                          ta: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """-> (slrd, dfabs, st4a1, st4a2, flux) (longwave_radiation.f90:16-117);
    st4a1/st4a2 and the 4 band fluxes feed the upward sweep."""
    kx = ta.shape[0]
    nl1 = kx - 1
    w = torch.as_tensor(wvi2[: kx - 1], dtype=ta.dtype,
                        device=ta.device)[:, None, None]
    thalf = ta[:-1] + w * (ta[1:] - ta[:-1])

    st4a2 = [None] * kx
    st4a2[0] = 0.75 * ta[0] + 0.25 * thalf[0]
    st4a2[1] = 0.50 * ta[1] + 0.25 * (thalf[0] + thalf[1])
    for k in range(2, nl1):
        st4a2[k] = 0.5 * torch.clamp(thalf[k] - thalf[k - 1], min=0.0)
    st4a2[kx - 1] = torch.clamp(ta[kx - 1] - thalf[nl1 - 1], min=0.0)

    st4a1 = [None] * kx
    for k in range(2):
        st4a1[k] = SBC * st4a2[k] ** 4
        st4a2[k] = torch.zeros_like(ta[k])
    for k in range(2, kx):
        st3a = SBC * ta[k] ** 3
        st4a1[k] = st3a * ta[k]
        st4a2[k] = 4.0 * st3a * st4a2[k]
    st4a1 = torch.stack(st4a1, dim=0)
    st4a2 = torch.stack(st4a2, dim=0)

    fb = _fband_at(ta, dim=1)  # [kx, 4, il, ix]

    # 3.1 stratosphere, bands 1-2, k=1
    emis0 = 1.0 - tau2[:2, 0]
    brad0 = fb[0, :2] * (st4a1[0] + emis0 * st4a2[0])
    flux = torch.cat([emis0 * brad0, torch.zeros_like(tau2[2:, 0])], dim=0)
    dfabs_levels = [-_band_sum(flux[:2])]

    # 3.2 troposphere, all 4 bands at once
    for k in range(1, kx):
        emis = 1.0 - tau2[:, k]
        brad = fb[k] * (st4a1[k] + emis * st4a2[k])
        dfa = _band_sum(flux)
        flux = tau2[:, k] * flux + emis * brad
        dfabs_levels.append(dfa - _band_sum(flux))

    slrd = EMISFC * _band_sum(flux)

    # 3.4 "black" band correction
    corlw = EPSLW * EMISFC * st4a1[kx - 1]
    dfabs_levels[kx - 1] = dfabs_levels[kx - 1] - corlw
    slrd = slrd + corlw
    return slrd, torch.stack(dfabs_levels, dim=0), st4a1, st4a2, flux


def upward_longwave_vec(dhs: np.ndarray, tau2: torch.Tensor,
                        stratc: torch.Tensor, ta: torch.Tensor,
                        ts: torch.Tensor, fsfcd: torch.Tensor,
                        fsfcu: torch.Tensor, st4a1: torch.Tensor,
                        st4a2: torch.Tensor, flux: torch.Tensor,
                        dfabs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """-> (slr, olr, dfabs) (longwave_radiation.f90:120-194)."""
    kx = ta.shape[0]
    refsfc = 1.0 - EMISFC
    slr = fsfcu - fsfcd

    fb_ts = _fband_at(ts, dim=0)   # [4, il, ix]
    fb = _fband_at(ta, dim=1)      # [kx, 4, il, ix]
    fluxes = fb_ts * fsfcu + refsfc * flux

    dfa_add = [torch.zeros_like(ta[0]) for _ in range(kx)]
    dfa_add[kx - 1] = EPSLW * fsfcu

    for k in range(kx - 1, 0, -1):
        emis = 1.0 - tau2[:, k]
        brad = fb[k] * (st4a1[k] - emis * st4a2[k])
        pre = _band_sum(fluxes)
        fluxes = tau2[:, k] * fluxes + emis * brad
        dfa_add[k] = dfa_add[k] + pre - _band_sum(fluxes)

    # stratosphere k=1, bands 1-2
    emis0 = 1.0 - tau2[:2, 0]
    brad0 = fb[0, :2] * (st4a1[0] - emis0 * st4a2[0])
    pre = _band_sum(fluxes[:2])
    fluxes = torch.cat([tau2[:2, 0] * fluxes[:2] + emis0 * brad0,
                        fluxes[2:]], dim=0)
    dfa_add[0] = dfa_add[0] + pre - _band_sum(fluxes[:2])

    corlw1 = float(dhs[0]) * stratc[1] * st4a1[0] + stratc[0]
    corlw2 = float(dhs[1]) * stratc[1] * st4a1[1]
    dfa_add[0] = dfa_add[0] - corlw1
    dfa_add[1] = dfa_add[1] - corlw2
    olr = corlw1 + corlw2 + _band_sum(fluxes)
    return slr, olr, dfabs + torch.stack(dfa_add, dim=0)
