"""The inputs the benchmark makes and hands to both the program and the
reference: the stand-in boundary set (reference/utils/synthetic_bc.py, a
frozen copy of the program's, fixed at the configuration's seed), the
start date, and the seeded perturbation of the booted state.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Tuple


@lru_cache(maxsize=2)
def boundaries(seed: int):
    """The stand-in boundary arrays ``{file: {var: array}}`` of ``seed``
    (the same set every check and gate of the repository uses at seed 0)."""
    from .reference.utils.synthetic_bc import synthetic_boundaries
    return synthetic_boundaries(seed)


def date_tuple(text: str) -> Tuple[int, int, int, int, int]:
    """``YYYY-MM-DD`` as (year, month, day, hour, minute)."""
    y, m, d = (int(x) for x in text.split("-"))
    return (y, m, d, 0, 0)


def as_tuple(date) -> Tuple[int, ...]:
    return dataclasses.astuple(date)


def perturb_temperature(t, seed: int, amplitude: float,
                        max_wavenumber: int) -> None:
    """Add to the spectral temperature ``t`` [..., kx, mx, nx, 2], in
    place and alike at every time level and member, seeded normal noise of
    ``amplitude`` on each coefficient of total wavenumber up to
    ``max_wavenumber`` (0.1 gives about 1 K rms on the grid at any
    truncation), drawn in float32 on ``t``'s device by a generator of
    ``seed`` (the same numbers whatever ``t``'s type), so that seeds start
    from different weather and convection runs from the first day."""
    import torch
    kx, mx, nx = t.shape[-4:-1]
    m = torch.arange(mx, device=t.device)[:, None]
    n = torch.arange(nx, device=t.device)[None, :]
    mask = ((m + n) <= max_wavenumber).to(t.dtype)
    mask = torch.stack([mask, mask * (m > 0)], dim=-1)   # m = 0 is real
    gen = torch.Generator(device=t.device).manual_seed(int(seed))
    noise = torch.randn((kx, mx, nx, 2), generator=gen, dtype=torch.float32,
                        device=t.device).to(t.dtype)
    t.add_(amplitude * noise * mask)
