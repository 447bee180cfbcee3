"""Saturation specific humidity and conversions (source/humidity.f90)."""
from __future__ import annotations

import torch


def get_qsat(ta: torch.Tensor, psa, sig) -> torch.Tensor:
    """Saturation specific humidity in g/kg (humidity.f90:44-78).

    ``psa`` is the normalized surface pressure p/p0 (broadcastable to ta);
    ``sig`` a sigma level (float or broadcastable tensor), or a float <= 0
    for the constant-pressure variant that uses psa itself as pressure.
    """
    e0, c1, c2 = 6.108e-3, 17.269, 21.875
    t0, t1, t2 = 273.16, 35.86, 7.66
    es = torch.where(ta >= t0,
                     e0 * torch.exp(c1 * (ta - t0) / (ta - t1)),
                     e0 * torch.exp(c2 * (ta - t0) / (ta - t2)))
    if isinstance(sig, (int, float)) and sig <= 0.0:
        return 622.0 * es / (psa - 0.378 * es)
    return 622.0 * es / (sig * psa - 0.378 * es)


def spec_hum_to_rel_hum(ta, psa, sig, qa):
    """-> (rh, qsat) (humidity.f90:17-27)."""
    qsat = get_qsat(ta, psa, sig)
    return qa / qsat, qsat
