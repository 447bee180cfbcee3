"""SPPT: stochastically perturbed parametrization tendencies
(source/sppt.f90; ECMWF SPPT, Palmer et al. 2009). Spectral AR(1)
multiplicative noise on the physics tendencies.

As in the JAX package, the AR(1) state starts from its stationary
distribution (sppt.f90:74-86 does the equivalent (1-phi^2)^(-1/2) draw on
first use) and each update draws one set of innovations, clipped to
+-10. ``torch`` cannot reproduce ``jax.random``'s numbers, so the state
carries an explicit ``torch.Generator`` on the model's device instead of a
key. Each draw copies the generator before using it, so a state is a value
like the JAX key: advancing from one state twice gives the same pattern.
A caller may instead pass ``noise``, a callable ``noise(shape)`` returning
standard-normal draws (any array type), which then supplies every
innovation in order: the parity tests feed the JAX key chain's draws
through it, chip_smoke.py a numpy seed.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...constants import REARTH
from ...ops import spectral as sp

TIME_DECORR = 6.0        # decorrelation time (h)
LEN_DECORR = 500000.0    # decorrelation length (m)
STDDEV = 0.33            # grid-point standard deviation

Noise = Optional[Callable[[tuple], object]]


class SpptState(NamedTuple):
    spec: torch.Tensor           # [kx, mx, nx, 2] AR(1) spectral state
    generator: torch.Generator   # draws the next innovations


def sppt_sigma(cfg, el2: np.ndarray) -> np.ndarray:
    """Wavenumber-dependent noise amplitude sigma[mx, nx]
    (sppt.f90:74-84)."""
    phi = np.exp(-(24.0 / cfg.nsteps) / TIME_DECORR)
    n = np.arange(1, cfg.trunc + 1, dtype=np.float64)
    f0 = np.sum((2 * n + 1) * np.exp(-0.5 * (LEN_DECORR / REARTH)**2
                                     * n * (n + 1)))
    f0 = np.sqrt((STDDEV**2 * (1 - phi**2)) / (2 * f0))
    return f0 * np.exp(-0.25 * LEN_DECORR**2 * el2)


def sppt_phi(cfg) -> float:
    return float(np.exp(-(24.0 / cfg.nsteps) / TIME_DECORR))


def _innovations(shape, like: torch.Tensor, generator: torch.Generator,
                 noise: Noise) -> Tuple[torch.Tensor, torch.Generator]:
    """Clipped standard-normal draws of ``shape`` in ``like``'s dtype and
    device, and the generator to carry on with (a copy advanced past the
    draws; the given one is left as it was)."""
    if noise is not None:
        eta = torch.as_tensor(np.array(noise(tuple(shape))),
                              dtype=like.dtype, device=like.device)
    else:
        generator = _copy(generator)
        eta = torch.randn(shape, generator=generator, dtype=like.dtype,
                          device=like.device)
    return torch.clamp(eta, -10.0, 10.0), generator


def _copy(generator: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=generator.device)
    out.set_state(generator.get_state())
    return out


def init_sppt_state(cfg, sigma: torch.Tensor, seed: int = 0,
                    noise: Noise = None) -> SpptState:
    """Stationary-distribution initialization of the AR(1) state on
    ``sigma``'s device."""
    generator = torch.Generator(device=sigma.device).manual_seed(seed)
    shape = (cfg.kx, cfg.mx, cfg.nx, 2)
    eta, generator = _innovations(shape, sigma, generator, noise)
    phi = sppt_phi(cfg)
    spec = (1 - phi**2) ** (-0.5) * sigma[:, :, None] * eta
    return SpptState(spec=spec, generator=generator)


def sppt_ar1(cfg, sigma: torch.Tensor, state: SpptState,
             noise: Noise = None) -> Tuple[torch.Tensor, SpptState]:
    """AR(1) spectral update (sppt.f90:84-90). The synthesis of the
    returned spec rides the step's merged synthesis batch
    (tendencies.grid_dynamics_tendencies)."""
    eta, generator = _innovations(state.spec.shape, state.spec,
                                  state.generator, noise)
    spec = sppt_phi(cfg) * state.spec + sigma[:, :, None] * eta
    return spec, SpptState(spec=spec, generator=generator)


def gen_sppt(cfg, sc: sp.SpectralConsts, sigma: torch.Tensor,
             state: SpptState, noise: Noise = None
             ) -> Tuple[torch.Tensor, SpptState]:
    """AR(1) update and its grid pattern clipped to [-1, 1]
    (sppt.f90:45-99): ([kx, il, ix] pattern, new state). Used by the
    leapfrog bootstrap, with a transform of its own."""
    spec, state = sppt_ar1(cfg, sigma, state, noise)
    grid = torch.clamp(sp.spec_to_grid(sc, spec), -1.0, 1.0)
    return grid, state
