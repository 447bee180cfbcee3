"""Prognostic model state (prognostics.f90:16-24).

Spectral fields use the packed real layout [..., mx, nx, 2]; the leapfrog's
two time levels are a leading axis of size 2 (level 0 = F(1), level 1 =
F(2) in the reference's notation).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class PrognosticState(NamedTuple):
    """vor, div, t: [2, kx, mx, nx, 2]; ps: [2, mx, nx, 2] log(p_s/p0);
    tr: [2, ntr, kx, mx, nx, 2] (tracer 0 = specific humidity, g/kg)."""
    vor: torch.Tensor
    div: torch.Tensor
    t: torch.Tensor
    ps: torch.Tensor
    tr: torch.Tensor


def zeros_state(cfg, device) -> PrognosticState:
    kx, mx, nx, ntr = cfg.kx, cfg.mx, cfg.nx, cfg.ntr
    z = lambda *s: torch.zeros(s, dtype=cfg.rdtype, device=device)
    return PrognosticState(vor=z(2, kx, mx, nx, 2), div=z(2, kx, mx, nx, 2),
                           t=z(2, kx, mx, nx, 2), ps=z(2, mx, nx, 2),
                           tr=z(2, ntr, kx, mx, nx, 2))
