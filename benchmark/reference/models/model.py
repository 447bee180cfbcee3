"""The plain reference model: build, boot and run days step by step
(initialization.f90 + speedy.f90). Frozen copy of the functions of
speedy_tpu_torch/models/model.py at commit 8f72ba0 that a day is made of,
without the captured day, the run drivers and the latitude-band view.

A simulated day is ``run_day``: the day's steps as triples with the
shortwave on the first step of each and the next day's climatology on the
last coupling, run eagerly, step by step.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig, check_supported
from ..constants import GRAV, P0
from ..geometry import build_geometry, build_geometry_np
from ..ops import spectral as sp
from ..utils import calendar as cal
from ..utils.diagnostics import Diagnostics, compute_diagnostics
from . import boundaries as bnd
from . import coupling
from .axes import level as L, levels
from .geopotential import build_geopotential, get_geopotential
from .hdiffusion import build_diffusion, build_diffusion_np, DiffusionConsts
from .implicit import build_implicit, ImplicitConsts
from .physics import (DailyForcing, Fluxes, PhysicsParams, SurfaceState,
                      build_physics_params, get_physical_tendencies)
from .physics.shortwave import init_radiation_state, RadiationState
from .physics.sppt import (Noise, SpptState, gen_sppt, init_sppt_state,
                           sppt_ar1)
from .prognostics import rest_state
from .state import PrognosticState, time_level
from .tendencies import DynConsts
from .time_stepping import OrographicCorrection, first_step, step


GRID_FIELDS = ("u", "v", "t", "q", "phi", "ps")   # gridded_fields' keys


class ModelConsts(NamedTuple):
    """Time-invariant device constants."""
    dyn: DynConsts
    dc: DiffusionConsts
    ic_half: ImplicitConsts
    ic_full: ImplicitConsts
    ic_2dt: ImplicitConsts
    clim: coupling.Climatology


class ModelState(NamedTuple):
    """Full model state advanced by the step loop; ``sppt`` is None unless
    the configuration has ``sppt_on``."""
    prog: PrognosticState
    surf: SurfaceState
    rad: RadiationState
    sppt: Optional[SpptState] = None


def resolve_device(device=None) -> torch.device:
    """The device to run on: ``cuda`` unless the caller names another. No
    silent fall-back to the CPU: CUDA, named or by default, raises where
    it is not available."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def _physics_fn(cfg, pp, daily, state, compute_sw, sppt_pattern=None):
    def physics_fn(pg):
        return get_physical_tendencies(cfg, pp, daily, state.surf,
                                       state.rad, compute_sw, pg,
                                       sppt_pattern)
    return physics_fn


class StepOutputs(NamedTuple):
    """What a step gives besides the state: the stability diagnostics
    (None on a step without them) and, where asked for, the physics flux
    diagnostics with the surface fluxes dropped (``Fluxes`` with ``sfc``
    None; the JAX package's StepOutputs)."""
    diag: Optional[Diagnostics]
    fluxes: Optional[Fluxes] = None


def one_step(cfg: ModelConfig, pp: PhysicsParams,
             lsp: coupling.LandSeaParams, mc: ModelConsts, state: ModelState,
             daily: DailyForcing, compute_sw: bool, couple_next: bool = False,
             with_diag: bool = True, noise: Noise = None,
             eta: Optional[torch.Tensor] = None, with_fluxes: bool = False
             ) -> Tuple[ModelState, StepOutputs]:
    """One leapfrog step with physics, then the slab coupling. On the
    day's last step ``couple_next`` couples with the next day's
    climatology (speedy.f90:47-53). With ``sppt_on`` the SPPT state takes
    its AR(1) update first and its pattern rides the step's synthesis;
    ``eta`` holds the update's innovations drawn ahead, else ``noise``
    supplies them (physics/sppt.py). With ``with_fluxes`` the outputs
    carry the step's precipitation and radiation fluxes [..., il, ix]."""
    corr = OrographicCorrection(tcorh=daily.tcorh, qcorh=daily.qcorh)
    sppt_spec, sppt_state = None, state.sppt
    if cfg.sppt_on:
        sppt_spec, sppt_state = sppt_ar1(cfg, pp.sppt_sigma, state.sppt,
                                         noise, eta)
    phys = _physics_fn(cfg, pp, daily, state, compute_sw)
    prog, aux = step(cfg, mc.dyn, mc.dc, mc.ic_2dt, state.prog,
                     2, 2, 2 * cfg.delt, corr, phys, sppt_spec)
    surf = coupling.couple_step(
        cfg, lsp, coupling.select_couple_daily(daily, couple_next),
        state.surf, aux.fluxes)
    now = time_level(prog, 1)
    diag = compute_diagnostics(mc.dyn.sc, now.vor, now.div,
                               now.t) if with_diag else None
    fluxes = aux.fluxes._replace(sfc=None) if with_fluxes else None
    return ModelState(prog=prog, surf=surf, rad=aux.rad,
                      sppt=sppt_state), StepOutputs(diag, fluxes)


def gridded_fields(cfg: ModelConfig, mc: ModelConsts, prog: PrognosticState,
                   level: int = 0) -> Dict[str, torch.Tensor]:
    """Physical-space output fields u, v, t, q, phi [..., kx, il, ix] and
    ps [..., il, ix] at time level ``level`` (input_output.f90:183-206),
    for every member of an ensemble state at once."""
    kx, sc = cfg.kx, mc.dyn.sc
    lv = time_level(prog, level)
    ucos, vcos = sp.uvspec(sc, lv.vor, lv.div)
    wind = sp.spec_to_grid(sc, torch.cat([ucos, vcos], dim=-4),
                           scale_by_inv_cos=True)
    phi = get_geopotential(mc.dyn.gc, lv.t, mc.dyn.phis)
    scal = torch.cat([lv.t, lv.tr.select(-5, 0), phi, lv.ps.unsqueeze(-4)],
                     dim=-4)
    g = sp.spec_to_grid(sc, scal)
    return dict(u=levels(wind, 0, kx), v=levels(wind, kx, 2 * kx),
                t=levels(g, 0, kx), q=levels(g, kx, 2 * kx) * 1.0e-3,
                phi=levels(g, 2 * kx, 3 * kx) / GRAV,
                ps=P0 * torch.exp(L(g, 3 * kx)))


def day_steps(cfg: ModelConfig, pp: PhysicsParams,
              lsp: coupling.LandSeaParams, mc: ModelConsts,
              state: ModelState, ds: coupling.DateScalars,
              diag_every: int = 1, noise: Noise = None,
              eta: Optional[torch.Tensor] = None, with_fluxes: bool = False):
    """The day's steps: nsteps steps as triples of nstrad steps with the
    shortwave on the first of each (speedy.f90:35), after the daily update
    from ``ds`` and the day-start surface. Yields (state, StepOutputs)
    after each step, with diagnostics every ``diag_every`` steps (must
    divide nstrad) and, with ``with_fluxes``, the step's fluxes. With
    SPPT, ``eta`` [nsteps, ...] holds the day's innovations drawn ahead
    (sppt.draw_day), else ``noise`` or the state's generator supplies them
    step by step."""
    if cfg.nstrad % diag_every:
        raise ValueError(f"diag_every={diag_every} must divide "
                         f"nstrad={cfg.nstrad}")
    daily = coupling.daily_update(cfg, pp, lsp, mc.dyn.sc, mc.clim, ds,
                                  state.surf)
    for istep in range(cfg.nsteps):
        i = istep % cfg.nstrad
        state, outs = one_step(cfg, pp, lsp, mc, state, daily,
                               compute_sw=(i == 0),
                               couple_next=(istep == cfg.nsteps - 1),
                               with_diag=((i + 1) % diag_every == 0),
                               noise=noise,
                               eta=None if eta is None else eta[istep],
                               with_fluxes=with_fluxes)
        yield state, outs


def run_day(cfg: ModelConfig, pp: PhysicsParams, lsp: coupling.LandSeaParams,
            mc: ModelConsts, state: ModelState, ds: coupling.DateScalars,
            diag_every: int = 1, noise: Noise = None,
            collect_output: bool = False, collect_fluxes: bool = False):
    """One simulated day run eagerly, step by step (model.py run_day of
    the JAX package; ``day_steps``): (state, diagnostics every
    ``diag_every`` steps, grids), where grids are the gridded fields after
    every step (on the device) with ``collect_output``, else None. With
    ``collect_fluxes`` a fourth item follows: every step's precipitation
    and radiation fluxes, ``Fluxes`` of [nsteps, ..., il, ix] with
    ``sfc`` None (the JAX run_day's ``outs.fluxes``)."""
    diags, fluxes = [], []
    grids = [] if collect_output else None
    for state, outs in day_steps(cfg, pp, lsp, mc, state, ds, diag_every,
                                 noise, with_fluxes=collect_fluxes):
        if outs.diag is not None:
            diags.append(outs.diag)
        if collect_fluxes:
            fluxes.append(outs.fluxes)
        if collect_output:
            grids.append(gridded_fields(cfg, mc, state.prog))
    if collect_fluxes:
        return state, diags, grids, Fluxes(
            *[None if xs[0] is None else torch.stack(xs)
              for xs in zip(*fluxes)])
    return state, diags, grids


def boot(cfg: ModelConfig, pp: PhysicsParams, lsp: coupling.LandSeaParams,
         mc: ModelConsts, state: ModelState,
         ds: coupling.DateScalars, noise: Noise = None) -> ModelState:
    """Leapfrog bootstrap with physics (time_stepping.f90:12-24). With
    ``sppt_on``, both sub-steps use the pattern of one AR(1) update of the
    initial SPPT state, made with a transform of its own, and the updated
    state is kept: the JAX package's physics closure draws from the initial
    state in each sub-step (model.py:155-163 there), so both draw the same
    pattern."""
    daily = coupling.daily_update(cfg, pp, lsp, mc.dyn.sc, mc.clim, ds,
                                  state.surf)
    corr = OrographicCorrection(tcorh=daily.tcorh, qcorh=daily.qcorh)
    pattern, sppt_state = None, state.sppt
    if cfg.sppt_on:
        pattern, sppt_state = gen_sppt(cfg, mc.dyn.sc, pp.sppt_sigma,
                                       state.sppt, noise)
    phys = _physics_fn(cfg, pp, daily, state, True, pattern)
    prog, aux = first_step(cfg, mc.dyn, mc.dc, mc.ic_half, mc.ic_full,
                           state.prog, corr, phys)
    return state._replace(prog=prog, rad=aux.rad, sppt=sppt_state)


class ReferenceModel:
    """The model's constants built from the configuration and the boundary
    arrays on ``device`` (initialization.f90:12-82), and its boot and days
    run eagerly, step by step. Only the default options: no SST-anomaly
    forcing, no latitude band."""

    def __init__(self, cfg: ModelConfig, device, bc_arrays,
                 sppt_seed: int = 0):
        check_supported(cfg)
        if cfg.sst_anomaly_forcing:
            raise NotImplementedError("the reference has no SST anomalies")
        self.cfg, self.device, self.sppt_seed = cfg, torch.device(device), \
            sppt_seed
        dev = self.device
        self.geom_np = build_geometry_np(cfg)
        self.sp_np = sp.build_spectral_np(cfg, self.geom_np)
        sc = sp.build_spectral(cfg, self.geom_np, dev)
        self.bounds = bnd.build_boundaries(cfg, self.sp_np, dev,
                                           arrays=bc_arrays)
        dyn = DynConsts(sc=sc, geom=build_geometry(cfg, dev),
                        gc=build_geopotential(cfg, self.geom_np, dev),
                        phis=self.bounds.phis)
        self.diff_np = build_diffusion_np(cfg, self.geom_np)
        host = lambda a: a.cpu().double().numpy()
        self.lsp, clim = coupling.build_land_sea(
            cfg, host(self.bounds.fmask), host(self.bounds.alb0),
            self.geom_np["radang"], dev, arrays=bc_arrays)
        self.pp = build_physics_params(
            cfg, self.geom_np, self.sp_np, host(self.lsp.fmask_l),
            host(self.lsp.fmask_s), host(self.bounds.phis0), dev)
        implicit = lambda dt: build_implicit(cfg, self.geom_np, self.diff_np,
                                             dt, dev)
        self.mc = ModelConsts(
            dyn=dyn, dc=build_diffusion(cfg, self.geom_np, dev),
            ic_half=implicit(0.5 * cfg.delt), ic_full=implicit(cfg.delt),
            ic_2dt=implicit(2 * cfg.delt), clim=clim)

    def date_scalars(self, date: cal.Datetime,
                     start: cal.Datetime) -> coupling.DateScalars:
        """Date inputs of the day starting at ``date`` (run began at
        ``start``), with the next day's weights for the last coupling."""
        cfg = self.cfg
        imont1, tmonth, tyear = cal.season_vars(date, cfg.iseasc,
                                                start.month)
        im_n, tm_n, _ = cal.season_vars(cal.next_day(date), cfg.iseasc,
                                        start.month)
        return coupling.make_date_scalars(
            cfg, self.geom_np, imont1, tmonth, tyear, self.device,
            year=date.year, imont1_next=im_n, tmonth_next=tm_n)

    def initial_state(self, start: cal.Datetime) -> ModelState:
        """Rest state, day-0 surface and radiation and, with SPPT, the
        stationary SPPT state, before the bootstrap."""
        cfg = self.cfg
        ds = self.date_scalars(start, start)
        prog = rest_state(cfg, self.geom_np, self.sp_np, self.bounds)
        surf = coupling.init_surface_state(cfg, self.pp, self.lsp,
                                           self.mc.dyn.sc, self.mc.clim, ds)
        sppt = init_sppt_state(cfg, self.pp.sppt_sigma, self.sppt_seed) \
            if cfg.sppt_on else None
        return ModelState(prog=prog, surf=surf,
                          rad=init_radiation_state(
                              cfg, self.device, self.lsp.fmask_l.shape[0]),
                          sppt=sppt)

    def initialize(self, start: cal.Datetime) -> ModelState:
        """Initial state after the leapfrog bootstrap."""
        return boot(self.cfg, self.pp, self.lsp, self.mc,
                    self.initial_state(start), self.date_scalars(start, start))

    def run_day(self, state: ModelState, date: cal.Datetime,
                start: cal.Datetime, steps: int = 1
                ) -> Tuple[List[ModelState], ModelState]:
        """One day from ``date`` (run began at ``start``), step by step,
        SPPT drawing from the state's generators: (the states after its
        first ``steps`` steps, the state at its end)."""
        firsts = []
        for state, _ in day_steps(self.cfg, self.pp, self.lsp, self.mc,
                                  state, self.date_scalars(date, start),
                                  self.cfg.diag_every):
            if len(firsts) < steps:
                firsts.append(state)
        return firsts, state

    def gridded_fields(self, prog: PrognosticState
                       ) -> Dict[str, torch.Tensor]:
        return gridded_fields(self.cfg, self.mc, prog)
