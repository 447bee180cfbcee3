"""Top-level model: build, initialize, run (initialization.f90 +
speedy.f90).

The state advances one step at a time in Python loops on the device
(``run_day``: the day's steps as triples with the shortwave on the first
step of each, ``run_fast``: whole days with the stability guard checked
once per day). The host computes the date-derived scalars once a day.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig, check_supported
from ..geometry import build_geometry, build_geometry_np
from ..ops import spectral as sp
from ..utils import calendar as cal
from ..utils.diagnostics import (Diagnostics, compute_diagnostics,
                                 check_diagnostics)
from . import boundaries as bnd
from . import coupling
from .geopotential import build_geopotential
from .hdiffusion import build_diffusion, build_diffusion_np, DiffusionConsts
from .implicit import build_implicit, ImplicitConsts
from .physics import (DailyForcing, PhysicsParams, SurfaceState,
                      build_physics_params, get_physical_tendencies)
from .physics.shortwave import init_radiation_state, RadiationState
from .prognostics import rest_state
from .state import PrognosticState
from .tendencies import DynConsts
from .time_stepping import OrographicCorrection, first_step, step


class ModelConsts(NamedTuple):
    """Time-invariant device constants."""
    dyn: DynConsts
    dc: DiffusionConsts
    ic_half: ImplicitConsts
    ic_full: ImplicitConsts
    ic_2dt: ImplicitConsts
    clim: coupling.Climatology


class ModelState(NamedTuple):
    """Full model state advanced by the step loop."""
    prog: PrognosticState
    surf: SurfaceState
    rad: RadiationState


def resolve_device(device=None) -> torch.device:
    """The device to run on: ``cuda`` unless the caller names another. No
    silent fall-back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def _physics_fn(cfg, pp, daily, state, compute_sw):
    def physics_fn(pg):
        return get_physical_tendencies(cfg, pp, daily, state.surf,
                                       state.rad, compute_sw, pg)
    return physics_fn


def one_step(cfg: ModelConfig, pp: PhysicsParams,
             lsp: coupling.LandSeaParams, mc: ModelConsts, state: ModelState,
             daily: DailyForcing, compute_sw: bool, couple_next: bool = False,
             with_diag: bool = True
             ) -> Tuple[ModelState, Optional[Diagnostics]]:
    """One leapfrog step with physics, then the slab coupling. On the
    day's last step ``couple_next`` couples with the next day's
    climatology (speedy.f90:47-53)."""
    corr = OrographicCorrection(tcorh=daily.tcorh, qcorh=daily.qcorh)
    phys = _physics_fn(cfg, pp, daily, state, compute_sw)
    prog, aux = step(cfg, mc.dyn, mc.dc, mc.ic_2dt, state.prog,
                     2, 2, 2 * cfg.delt, corr, phys)
    surf = coupling.couple_step(
        cfg, lsp, coupling.select_couple_daily(daily, couple_next),
        state.surf, aux.fluxes)
    diag = compute_diagnostics(mc.dyn.sc, prog.vor[1], prog.div[1],
                               prog.t[1]) if with_diag else None
    return ModelState(prog=prog, surf=surf, rad=aux.rad), diag


def run_day(cfg: ModelConfig, pp: PhysicsParams, lsp: coupling.LandSeaParams,
            mc: ModelConsts, state: ModelState, ds: coupling.DateScalars,
            diag_every: int = 1) -> Tuple[ModelState, List[Diagnostics]]:
    """One simulated day: nsteps steps as triples of nstrad steps with the
    shortwave on the first of each (model.py run_day of the JAX package,
    speedy.f90:35). Diagnostics every ``diag_every`` steps (must divide
    nstrad)."""
    if cfg.nstrad % diag_every:
        raise ValueError(f"diag_every={diag_every} must divide "
                         f"nstrad={cfg.nstrad}")
    daily = coupling.daily_update(cfg, pp, lsp, mc.dyn.sc, mc.clim, ds,
                                  state.surf)
    diags = []
    for istep in range(cfg.nsteps):
        i = istep % cfg.nstrad
        state, diag = one_step(cfg, pp, lsp, mc, state, daily,
                               compute_sw=(i == 0),
                               couple_next=(istep == cfg.nsteps - 1),
                               with_diag=((i + 1) % diag_every == 0))
        if diag is not None:
            diags.append(diag)
    return state, diags


def boot(cfg: ModelConfig, pp: PhysicsParams, lsp: coupling.LandSeaParams,
         mc: ModelConsts, state: ModelState,
         ds: coupling.DateScalars) -> ModelState:
    """Leapfrog bootstrap with physics (time_stepping.f90:12-24)."""
    daily = coupling.daily_update(cfg, pp, lsp, mc.dyn.sc, mc.clim, ds,
                                  state.surf)
    corr = OrographicCorrection(tcorh=daily.tcorh, qcorh=daily.qcorh)
    phys = _physics_fn(cfg, pp, daily, state, compute_sw=True)
    prog, aux = first_step(cfg, mc.dyn, mc.dc, mc.ic_half, mc.ic_full,
                           state.prog, corr, phys)
    return state._replace(prog=prog, rad=aux.rad)


class Model:
    """Build-once, run-many model (initialization.f90:12-82).

    ``device`` defaults to ``cuda`` and never falls back to the CPU.
    Boundary fields come from ``bc_arrays`` (``{file: {var: array}}``, see
    utils/synthetic_bc.py) when given, else from the files on
    ``bc_search``.
    """

    def __init__(self, cfg: ModelConfig, device=None, bc_search=None,
                 bc_arrays=None):
        check_supported(cfg)
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        dev = self.device
        self.geom_np = build_geometry_np(cfg)
        self.sp_np = sp.build_spectral_np(cfg, self.geom_np)
        sc = sp.build_spectral(cfg, self.geom_np, dev)
        self.bounds = bnd.build_boundaries(cfg, self.sp_np, dev,
                                           search=bc_search, arrays=bc_arrays)
        dyn = DynConsts(sc=sc, geom=build_geometry(cfg, dev),
                        gc=build_geopotential(cfg, self.geom_np, dev),
                        phis=self.bounds.phis)
        self.diff_np = build_diffusion_np(cfg, self.geom_np)

        host = lambda a: a.cpu().double().numpy()
        self.lsp, clim = coupling.build_land_sea(
            cfg, host(self.bounds.fmask), host(self.bounds.alb0),
            self.geom_np["radang"], dev, search=bc_search, arrays=bc_arrays)
        self.pp = build_physics_params(
            cfg, self.geom_np, host(self.lsp.fmask_l), host(self.lsp.fmask_s),
            host(self.bounds.phis0), dev)
        implicit = lambda dt: build_implicit(cfg, self.geom_np, self.diff_np,
                                             dt, dev)
        self.mc = ModelConsts(
            dyn=dyn, dc=build_diffusion(cfg, self.geom_np, dev),
            ic_half=implicit(0.5 * cfg.delt), ic_full=implicit(cfg.delt),
            ic_2dt=implicit(2 * cfg.delt), clim=clim)

    # ------------------------------------------------------------------
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
        """Rest state, day-0 surface and radiation, before the bootstrap."""
        cfg = self.cfg
        ds = self.date_scalars(start, start)
        prog = rest_state(cfg, self.geom_np, self.sp_np, self.bounds)
        surf = coupling.init_surface_state(cfg, self.pp, self.lsp,
                                           self.mc.dyn.sc, self.mc.clim, ds)
        return ModelState(prog=prog, surf=surf,
                          rad=init_radiation_state(cfg, self.device))

    def initialize(self, start: cal.Datetime) -> ModelState:
        """Initial state after the leapfrog bootstrap."""
        return boot(self.cfg, self.pp, self.lsp, self.mc,
                    self.initial_state(start), self.date_scalars(start, start))

    def one_step(self, state: ModelState, daily: DailyForcing,
                 compute_sw: bool, couple_next: bool = False):
        return one_step(self.cfg, self.pp, self.lsp, self.mc, state, daily,
                        compute_sw, couple_next)

    def daily_forcing(self, state: ModelState, date: cal.Datetime,
                      start: cal.Datetime) -> DailyForcing:
        return coupling.daily_update(self.cfg, self.pp, self.lsp,
                                     self.mc.dyn.sc, self.mc.clim,
                                     self.date_scalars(date, start),
                                     state.surf)

    def make_ds_days(self, date: cal.Datetime, start: cal.Datetime,
                     n_days: int):
        """Date inputs for ``n_days`` days from ``date`` (run began at
        ``start``); returns (list of DateScalars, end date)."""
        ds_days = []
        for _ in range(n_days):
            ds_days.append(self.date_scalars(date, start))
            for _ in range(self.cfg.nsteps):
                date = cal.newdate(date, self.cfg.nsteps)
        return ds_days, date

    def run_day(self, state: ModelState, date: cal.Datetime,
                start: cal.Datetime, diag_every: int = 1):
        return run_day(self.cfg, self.pp, self.lsp, self.mc, state,
                       self.date_scalars(date, start), diag_every)

    # ------------------------------------------------------------------
    def run_fast(self, start: cal.Datetime, n_days: int,
                 state: Optional[ModelState] = None,
                 check: bool = True) -> ModelState:
        """Run ``n_days`` from ``start`` with no output; the stability
        guard is checked once per day on the day's extrema (one host
        synchronisation per day)."""
        cfg = self.cfg
        if state is None:
            state = self.initialize(start)
        ds_days, _ = self.make_ds_days(start, start, n_days)
        for day, ds in enumerate(ds_days):
            state, diags = run_day(cfg, self.pp, self.lsp, self.mc, state,
                                   ds, cfg.diag_every)
            if check:
                reke = torch.stack([d.reke for d in diags]).amax(dim=0)
                deke = torch.stack([d.deke for d in diags]).amax(dim=0)
                tm = torch.stack([d.tmean for d in diags])
                tmin, tmax = tm.amin(dim=0), tm.amax(dim=0)
                guard = torch.stack([reke, deke, tmin, tmax]).cpu().numpy()
                check_diagnostics(Diagnostics(
                    reke=guard[0], deke=guard[1],
                    tmean=np.where(guard[2] < 180.0, guard[2], guard[3])),
                    day)
        return state
