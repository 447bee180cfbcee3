"""Prognostic model state (prognostics.f90:16-24).

Spectral fields use the packed real layout [..., mx, nx, 2]; the leapfrog's
two time levels are an axis of size 2 (level 0 = F(1), level 1 = F(2) in
the reference's notation). An ensemble's state carries a leading member
axis in front of it, so the step counts the time-level, field and level
axes from the right (``TIME_AXIS``, ``time_level``).
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


# the time-level axis of each field, counted from the right
TIME_AXIS = dict(vor=-5, div=-5, t=-5, ps=-4, tr=-6)


def time_level(state: PrognosticState, j: int) -> PrognosticState:
    """Every field at time level ``j``: vor, div, t [..., kx, mx, nx, 2],
    ps [..., mx, nx, 2], tr [..., ntr, kx, mx, nx, 2]."""
    return PrognosticState(**{f: x.select(TIME_AXIS[f], j)
                              for f, x in state._asdict().items()})


def zeros_state(cfg, device) -> PrognosticState:
    kx, mx, nx, ntr = cfg.kx, cfg.mx, cfg.nx, cfg.ntr
    z = lambda *s: torch.zeros(s, dtype=cfg.rdtype, device=device)
    return PrognosticState(vor=z(2, kx, mx, nx, 2), div=z(2, kx, mx, nx, 2),
                           t=z(2, kx, mx, nx, 2), ps=z(2, mx, nx, 2),
                           tr=z(2, ntr, kx, mx, nx, 2))
