"""Axes counted from the right. A grid-point field is [..., kx, il, ix]
with the level (or field) axis third from the right (GRID), a spectral one
[..., kx, mx, nx, 2] with it fourth (SPEC), a column field [..., il, ix].
In the column physics the stacked land/sea/blend trios, the two
stratospheric corrections and the four band fluxes take the level axis's
place, and the transmissivities are [..., 4, kx, il, ix]. Any leading
dimensions (an ensemble's members) batch through, and fields that all
members share ([il, ix], or [il, 1] from the date) broadcast against
them."""
from __future__ import annotations

import torch

GRID, SPEC = -3, -4


def level(x: torch.Tensor, k: int, axis: int = GRID) -> torch.Tensor:
    """Row k of the level (or field) axis."""
    return x.select(axis, k)


def levels(x: torch.Tensor, a: int, b: int, axis: int = GRID
           ) -> torch.Tensor:
    """Rows a..b-1 of the level (or field) axis, kept as an axis."""
    return x[(..., slice(a, b)) + (slice(None),) * (-1 - axis)]


def per_level(x: torch.Tensor, axis: int = GRID) -> torch.Tensor:
    """A field without the level axis ([..., il, ix] or [..., mx, nx, 2])
    with a one-row level axis, to broadcast over the levels of its own
    member."""
    return x.unsqueeze(axis)


def level_sums(x: torch.Tensor, axis: int = GRID) -> torch.Tensor:
    """x[k+1] + x[k] over the levels: a half-level field summed onto the
    full levels between its rows."""
    n = x.shape[axis]
    return levels(x, 1, n, axis) + levels(x, 0, n - 1, axis)
