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

A staged day (models/captured.py) draws all of its updates' innovations
ahead into a static buffer (``draw_day``), with the same calls in the same
order as the steps would make them, since neither a generator's copy nor a
host array can live inside a captured graph; ``sppt_ar1`` then takes each
step's slice (``eta``).

An ensemble's state (``stack_states``) has a member axis in front of
``spec`` and one generator per member: member i is seeded on its own and
its draws depend only on its seed, never on the number of members, at the
cost of one small ``randn`` per member and update. Its ``noise`` is either
one source for the whole [M, ...] draw or a sequence of M sources, one per
member.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...constants import REARTH
from ...ops import spectral as sp
from ...utils import tracing

TIME_DECORR = 6.0        # decorrelation time (h)
LEN_DECORR = 500000.0    # decorrelation length (m)
STDDEV = 0.33            # grid-point standard deviation

Source = Callable[[tuple], object]
Noise = Optional[Union[Source, Sequence[Source]]]


class SpptState(NamedTuple):
    spec: torch.Tensor    # [..., kx, mx, nx, 2] AR(1) spectral state
    # draws the next innovations: a torch.Generator, or a tuple of one per
    # member in an ensemble
    generator: Union[torch.Generator, Tuple[torch.Generator, ...]]


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


def _draw(shape, like: torch.Tensor, generator: torch.Generator,
          noise: Optional[Source]) -> Tuple[torch.Tensor, torch.Generator]:
    """Standard-normal draws of ``shape`` from ``noise`` where given, else
    from a copy of ``generator``, returned advanced past the draws."""
    if noise is not None:
        return torch.as_tensor(np.array(noise(tuple(shape))),
                               dtype=like.dtype, device=like.device), generator
    generator = _copy(generator)
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device), generator


def _innovations(shape, like: torch.Tensor, generator, noise: Noise
                 ) -> Tuple[torch.Tensor, object]:
    """Clipped standard-normal draws of ``shape`` in ``like``'s dtype and
    device, and the generator(s) to carry on with (copies advanced past
    the draws; the given ones are left as they were). With a tuple of
    generators (an ensemble) ``shape`` leads with the member axis and each
    member draws its own slice."""
    if isinstance(generator, tuple) and not callable(noise):
        sources = noise if noise is not None else [None] * len(generator)
        if len(sources) != len(generator):
            raise ValueError(f"{len(sources)} noise sources for "
                             f"{len(generator)} members")
        draws = [_draw(shape[1:], like, g, n)
                 for g, n in zip(generator, sources)]
        eta = torch.stack([d for d, _ in draws])
        generator = tuple(g for _, g in draws)
    else:
        eta, generator = _draw(shape, like, generator, noise)
    return torch.clamp(eta, -10.0, 10.0), generator


def _copy(generator: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=generator.device)
    out.set_state(generator.get_state())
    return out


def init_sppt_state(cfg, sigma: torch.Tensor, seed: int = 0,
                    noise: Optional[Source] = None) -> SpptState:
    """Stationary-distribution initialization of the AR(1) state on
    ``sigma``'s device."""
    generator = torch.Generator(device=sigma.device).manual_seed(seed)
    shape = (cfg.kx, cfg.mx, cfg.nx, 2)
    eta, generator = _innovations(shape, sigma, generator, noise)
    phi = sppt_phi(cfg)
    spec = (1 - phi**2) ** (-0.5) * sigma[:, :, None] * eta
    return SpptState(spec=spec, generator=generator)


def stack_states(states: Sequence[SpptState]) -> SpptState:
    """An ensemble's SPPT state from its members' states."""
    return SpptState(spec=torch.stack([s.spec for s in states]),
                     generator=tuple(s.generator for s in states))


def draw_day(generator, noise: Noise, out: torch.Tensor):
    """A day's innovations drawn ahead into ``out`` [nsteps, ..., kx, mx,
    nx, 2] (the state's spec shape behind the update axis), clipped: update
    i's draws are those ``sppt_ar1`` would make at the i-th step from the
    same generator(s) or ``noise``, in the same order (per update, per
    member), so a staged day is bit-equal to the eager one. Returns the
    generator(s) advanced past the whole day (copies; the given ones are
    left as they were). The draws are enqueued on the current stream;
    ``noise`` sources' values reach the device in one copy from pinned
    memory, without a host synchronisation. The ``normal_`` calls count
    as ``sppt.draw_launches`` (utils/tracing.py), one event a step, so a
    reader can tell the host's own time a step from a step it spent
    blocked behind earlier work on a full launch queue."""
    shape = tuple(out.shape[1:])
    per_member = isinstance(generator, tuple) and not callable(noise)
    if noise is None:
        gens = tuple(map(_copy, generator)) if per_member \
            else _copy(generator)
        for i in range(out.shape[0]):
            if per_member:
                for m, g in enumerate(gens):
                    out[i, m].normal_(generator=g)
            else:
                out[i].normal_(generator=gens)
            tracing.count("sppt.draw_launches",
                          len(gens) if per_member else 1)
        generator = gens
    else:
        if per_member and len(noise) != len(generator):
            raise ValueError(f"{len(noise)} noise sources for "
                             f"{len(generator)} members")
        host = np.empty(out.shape, np.float64)
        for i in range(out.shape[0]):
            if per_member:
                for m, src in enumerate(noise):
                    host[i, m] = np.array(src(shape[1:]))
            else:
                host[i] = np.array(noise(shape))
        host = torch.from_numpy(host).to(out.dtype)
        if out.device.type == "cuda":
            host = host.pin_memory()
        out.copy_(host, non_blocking=True)
    out.clamp_(-10.0, 10.0)
    return generator


def sppt_ar1(cfg, sigma: torch.Tensor, state: SpptState,
             noise: Noise = None, eta: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, SpptState]:
    """AR(1) spectral update (sppt.f90:84-90). The synthesis of the
    returned spec rides the step's merged synthesis batch
    (tendencies.grid_dynamics_tendencies). ``eta``: this update's clipped
    innovations drawn ahead (``draw_day``), which leave the generator as
    it is; else they are drawn here."""
    if eta is None:
        eta, generator = _innovations(state.spec.shape, state.spec,
                                      state.generator, noise)
    else:
        generator = state.generator
    spec = sppt_phi(cfg) * state.spec + sigma[:, :, None] * eta
    return spec, SpptState(spec=spec, generator=generator)


def gen_sppt(cfg, sc: sp.SpectralConsts, sigma: torch.Tensor,
             state: SpptState, noise: Noise = None
             ) -> Tuple[torch.Tensor, SpptState]:
    """AR(1) update and its grid pattern clipped to [-1, 1]
    (sppt.f90:45-99): ([..., kx, il, ix] pattern, new state). Used by the
    leapfrog bootstrap, with a transform of its own."""
    spec, state = sppt_ar1(cfg, sigma, state, noise)
    grid = torch.clamp(sp.spec_to_grid(sc, spec), -1.0, 1.0)
    return grid, state
