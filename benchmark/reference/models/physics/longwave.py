"""Longwave radiation: 4-band emission/absorption sweeps
(source/longwave_radiation.f90), in the two orders of the JAX package,
picked by ``cfg.lw_band_vectorized``: the ``*_vec`` pair (the default)
sums each level's four band terms first and adds the sum, while
``downward_longwave``/``upward_longwave`` (``lw_band_vectorized=False``)
add them into each level's absorbed flux band by band, in the reference's
order. The two differ only by rounding, which the JAX package found to
change the 90-day stability at T85."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...constants import SBC
from ..axes import level as L, levels, per_level
from .shortwave import EPSLW, EMISFC


def _fband_at(ta: torch.Tensor) -> torch.Tensor:
    """Band energy fractions for nint(ta), stacked on a new axis third from
    the right (4 bands): [..., il, ix] -> [..., 4, il, ix]. The clamped
    quadratics of the reference's table (longwave_radiation.f90:197-220)
    evaluated on floor(ta + 0.5), the nint of the positive temperatures
    involved, clamped to 200..320 K."""
    tq = torch.clamp(torch.floor(ta + 0.5), 200.0, 320.0)
    eps1 = 1.0 - EPSLW
    f1 = (0.148 - 3.0e-6 * (tq - 247.0) ** 2) * eps1
    f2 = (0.356 - 5.2e-6 * (tq - 282.0) ** 2) * eps1
    f3 = (0.314 + 1.0e-5 * (tq - 315.0) ** 2) * eps1
    f0 = eps1 - f1 - f2 - f3
    return torch.stack([f0, f1, f2, f3], dim=-3)


def _band_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the band axis [..., nb, il, ix], in band order."""
    out = L(x, 0)
    for b in range(1, x.shape[-3]):
        out = out + L(x, b)
    return out


def _st4a(wvi2: np.ndarray, ta: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The levels' blackbody emission and its gradient term (st4a1, st4a2),
    [..., kx, il, ix] (longwave_radiation.f90:26-58)."""
    kx = ta.shape[-3]
    nl1 = kx - 1
    w = torch.as_tensor(wvi2[: kx - 1], dtype=ta.dtype,
                        device=ta.device)[:, None, None]
    thalf = levels(ta, 0, kx - 1) + w * (levels(ta, 1, kx)
                                         - levels(ta, 0, kx - 1))

    st4a2 = [None] * kx
    st4a2[0] = 0.75 * L(ta, 0) + 0.25 * L(thalf, 0)
    st4a2[1] = 0.50 * L(ta, 1) + 0.25 * (L(thalf, 0) + L(thalf, 1))
    for k in range(2, nl1):
        st4a2[k] = 0.5 * torch.clamp(L(thalf, k) - L(thalf, k - 1), min=0.0)
    st4a2[kx - 1] = torch.clamp(L(ta, kx - 1) - L(thalf, nl1 - 1), min=0.0)

    st4a1 = [None] * kx
    for k in range(2):
        st4a1[k] = SBC * st4a2[k] ** 4
        st4a2[k] = torch.zeros_like(L(ta, k))
    for k in range(2, kx):
        st3a = SBC * L(ta, k) ** 3
        st4a1[k] = st3a * L(ta, k)
        st4a2[k] = 4.0 * st3a * st4a2[k]
    return torch.stack(st4a1, dim=-3), torch.stack(st4a2, dim=-3)


def _tau(tau2: torch.Tensor, b: int, k: int) -> torch.Tensor:
    """Band b's transmissivity at level k: tau2 is [..., 4, kx, il, ix]."""
    return L(L(tau2, b, -4), k)


def _fb(fb: torch.Tensor, k: int, b: int) -> torch.Tensor:
    """Level k's fraction of band b: fb is [..., kx, 4, il, ix]."""
    return L(L(fb, k, -4), b)


def downward_longwave(wvi2: np.ndarray, tau2: torch.Tensor,
                      ta: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """-> (slrd, dfabs, st4a1, st4a2, flux) (longwave_radiation.f90:16-117)
    in the reference's order: each level's dfabs starts at zero and takes
    +f and -f_new band after band (bands 0..3 outer, levels 1..kx-1
    inner), after the stratospheric -flux of bands 0-1 at level 0."""
    kx = ta.shape[-3]
    st4a1, st4a2 = _st4a(wvi2, ta)
    fb = _fband_at(ta)

    # 3.1 stratosphere, bands 1-2, k=1
    dfabs = [torch.zeros_like(L(ta, k)) for k in range(kx)]
    flux = [None] * 4
    for b in range(2):
        emis = 1.0 - _tau(tau2, b, 0)
        brad = _fb(fb, 0, b) * (L(st4a1, 0) + emis * L(st4a2, 0))
        flux[b] = emis * brad
        dfabs[0] = dfabs[0] - flux[b]
    for b in range(2, 4):
        flux[b] = torch.zeros_like(L(ta, 0))

    # 3.2 troposphere, band by band
    for b in range(4):
        f = flux[b]
        for k in range(1, kx):
            tau = _tau(tau2, b, k)
            emis = 1.0 - tau
            brad = _fb(fb, k, b) * (L(st4a1, k) + emis * L(st4a2, k))
            dfabs[k] = dfabs[k] + f
            f = tau * f + emis * brad
            dfabs[k] = dfabs[k] - f
        flux[b] = f

    slrd = EMISFC * (flux[0] + flux[1] + flux[2] + flux[3])

    # 3.4 "black" band correction
    corlw = EPSLW * EMISFC * L(st4a1, kx - 1)
    dfabs[kx - 1] = dfabs[kx - 1] - corlw
    slrd = slrd + corlw
    return (slrd, torch.stack(dfabs, dim=-3), st4a1, st4a2,
            torch.stack(flux, dim=-3))


def upward_longwave(dhs: np.ndarray, tau2: torch.Tensor,
                    stratc: torch.Tensor, ta: torch.Tensor,
                    ts: torch.Tensor, fsfcd: torch.Tensor,
                    fsfcu: torch.Tensor, st4a1: torch.Tensor,
                    st4a2: torch.Tensor, flux: torch.Tensor,
                    dfabs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """-> (slr, olr, dfabs) (longwave_radiation.f90:120-194) in the
    reference's order: each level's dfabs continues from the downward
    sweep's, with EPSLW * fsfcu at the lowest level first, then +f and
    -f_new band after band (levels kx-1..1), the two stratospheric bands
    at level 0, and the corrections -corlw1, -corlw2; olr is summed left
    to right."""
    kx = ta.shape[-3]
    refsfc = 1.0 - EMISFC
    slr = fsfcu - fsfcd

    fb_ts = _fband_at(ts)   # [..., 4, il, ix]
    fb = _fband_at(ta)
    fluxes = [L(fb_ts, b) * fsfcu + refsfc * L(flux, b) for b in range(4)]

    dfa = [L(dfabs, k) for k in range(kx)]
    dfa[kx - 1] = dfa[kx - 1] + EPSLW * fsfcu

    for b in range(4):
        f = fluxes[b]
        for k in range(kx - 1, 0, -1):
            tau = _tau(tau2, b, k)
            emis = 1.0 - tau
            brad = _fb(fb, k, b) * (L(st4a1, k) - emis * L(st4a2, k))
            dfa[k] = dfa[k] + f
            f = tau * f + emis * brad
            dfa[k] = dfa[k] - f
        fluxes[b] = f

    # stratosphere k=1, bands 1-2
    for b in range(2):
        tau = _tau(tau2, b, 0)
        emis = 1.0 - tau
        brad = _fb(fb, 0, b) * (L(st4a1, 0) - emis * L(st4a2, 0))
        dfa[0] = dfa[0] + fluxes[b]
        fluxes[b] = tau * fluxes[b] + emis * brad
        dfa[0] = dfa[0] - fluxes[b]

    corlw1 = float(dhs[0]) * L(stratc, 1) * L(st4a1, 0) + L(stratc, 0)
    corlw2 = float(dhs[1]) * L(stratc, 1) * L(st4a1, 1)
    dfa[0] = dfa[0] - corlw1
    dfa[1] = dfa[1] - corlw2
    olr = corlw1 + corlw2 + fluxes[0] + fluxes[1] + fluxes[2] + fluxes[3]
    return slr, olr, torch.stack(dfa, dim=-3)


def downward_longwave_vec(wvi2: np.ndarray, tau2: torch.Tensor,
                          ta: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """-> (slrd, dfabs, st4a1, st4a2, flux) (longwave_radiation.f90:16-117)
    with each level's four band terms summed first; st4a1/st4a2 and the 4
    band fluxes feed the upward sweep."""
    kx = ta.shape[-3]
    st4a1, st4a2 = _st4a(wvi2, ta)
    # level k's st4a terms against its 4 (or 2) band fluxes
    s4 = lambda x, k: levels(x, k, k + 1)

    fb = _fband_at(ta)  # [..., kx, 4, il, ix]: level k's bands L(fb, k, -4)

    # 3.1 stratosphere, bands 1-2, k=1
    emis0 = 1.0 - tau2[..., :2, 0, :, :]
    brad0 = L(fb, 0, -4)[..., :2, :, :] * (s4(st4a1, 0) + emis0 * s4(st4a2, 0))
    flux = torch.cat([emis0 * brad0,
                      torch.zeros_like(tau2[..., 2:, 0, :, :])], dim=-3)
    dfabs_levels = [-_band_sum(levels(flux, 0, 2))]

    # 3.2 troposphere, all 4 bands at once
    for k in range(1, kx):
        tau = tau2[..., :, k, :, :]
        emis = 1.0 - tau
        brad = L(fb, k, -4) * (s4(st4a1, k) + emis * s4(st4a2, k))
        dfa = _band_sum(flux)
        flux = tau * flux + emis * brad
        dfabs_levels.append(dfa - _band_sum(flux))

    slrd = EMISFC * _band_sum(flux)

    # 3.4 "black" band correction
    corlw = EPSLW * EMISFC * L(st4a1, kx - 1)
    dfabs_levels[kx - 1] = dfabs_levels[kx - 1] - corlw
    slrd = slrd + corlw
    return slrd, torch.stack(dfabs_levels, dim=-3), st4a1, st4a2, flux


def upward_longwave_vec(dhs: np.ndarray, tau2: torch.Tensor,
                        stratc: torch.Tensor, ta: torch.Tensor,
                        ts: torch.Tensor, fsfcd: torch.Tensor,
                        fsfcu: torch.Tensor, st4a1: torch.Tensor,
                        st4a2: torch.Tensor, flux: torch.Tensor,
                        dfabs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """-> (slr, olr, dfabs) (longwave_radiation.f90:120-194) with each
    level's four band terms summed first."""
    kx = ta.shape[-3]
    refsfc = 1.0 - EMISFC
    slr = fsfcu - fsfcd
    s4 = lambda x, k: levels(x, k, k + 1)

    fb_ts = _fband_at(ts)   # [..., 4, il, ix]
    fb = _fband_at(ta)      # [..., kx, 4, il, ix]
    fluxes = fb_ts * per_level(fsfcu) + refsfc * flux

    dfa_add = [torch.zeros_like(L(ta, 0)) for _ in range(kx)]
    dfa_add[kx - 1] = EPSLW * fsfcu

    for k in range(kx - 1, 0, -1):
        tau = tau2[..., :, k, :, :]
        emis = 1.0 - tau
        brad = L(fb, k, -4) * (s4(st4a1, k) - emis * s4(st4a2, k))
        pre = _band_sum(fluxes)
        fluxes = tau * fluxes + emis * brad
        dfa_add[k] = dfa_add[k] + pre - _band_sum(fluxes)

    # stratosphere k=1, bands 1-2
    tau0 = tau2[..., :2, 0, :, :]
    emis0 = 1.0 - tau0
    brad0 = L(fb, 0, -4)[..., :2, :, :] * (s4(st4a1, 0) - emis0 * s4(st4a2, 0))
    low = levels(fluxes, 0, 2)
    pre = _band_sum(low)
    fluxes = torch.cat([tau0 * low + emis0 * brad0, levels(fluxes, 2, 4)],
                       dim=-3)
    dfa_add[0] = dfa_add[0] + pre - _band_sum(levels(fluxes, 0, 2))

    corlw1 = float(dhs[0]) * L(stratc, 1) * L(st4a1, 0) + L(stratc, 0)
    corlw2 = float(dhs[1]) * L(stratc, 1) * L(st4a1, 1)
    dfa_add[0] = dfa_add[0] - corlw1
    dfa_add[1] = dfa_add[1] - corlw2
    olr = corlw1 + corlw2 + _band_sum(fluxes)
    return slr, olr, dfabs + torch.stack(dfa_add, dim=-3)
