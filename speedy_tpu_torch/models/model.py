"""Top-level model: build, initialize, run (initialization.f90 +
speedy.f90).

A simulated day is ``run_day``: the day's steps as triples with the
shortwave on the first step of each and the next day's climatology on the
last coupling (the JAX package's ``run_day``). Called directly it runs
eagerly, step by step. ``run_fast`` (whole days, the stability guard
checked once per chunk of days), ``run`` (the guard and the diagnostics
per step, gridded output, checkpoints) and ``Ensemble.run_days`` stage
each day instead (models/captured.py): the state, the date inputs and the
SPPT innovations go into static buffers, and on CUDA the day is one
replay of a captured graph, as the JAX package runs one compiled day;
on the CPU the same staged day runs eagerly.

With ``sst_anomaly_forcing`` the model keeps the 3-month SST-anomaly
window (``mc.clim.sstan3``) as the JAX package does: ``initialize`` sets
it for the start month, ``run_fast`` ends its chunks at month ends and
shifts it before the first day of each later month, ``run`` shifts it
before a month's first day once past step 0, and ``Ensemble.run_days``
never shifts it (the JAX package's quirk). Each shift copies into the
window in place, on the stream the days run on.

A model's band view (``Model.for_band``, the 'sp' axis of
parallel/mesh.py) runs the same step on one latitude band of the grid:
its grid-space constants hold the band's rows of the full model's, its
spectral tables sum each analysis over the band ranks' group, and every
grid shape of the step follows from its tensors.
"""
from __future__ import annotations

import copy
import dataclasses
import os
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig, check_supported
from ..constants import GRAV, P0
from ..geometry import Geometry, build_geometry, build_geometry_np
from ..ops import spectral as sp
from ..utils import calendar as cal
from ..utils import tracing
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.diagnostics import (Diagnostics, check_days,
                                 compute_diagnostics, check_diagnostics,
                                 format_diagnostics)
from . import boundaries as bnd
from . import coupling
from .axes import level as L, levels
from .captured import CapturedDay, host_sync, members_of
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


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Bring a dict of same-dtype tensors to the host in one copy."""
    flat = torch.cat([t.reshape(-1) for t in tensors.values()])
    with host_sync():
        flat = flat.cpu().numpy()
    out, off = {}, 0
    for k, t in tensors.items():
        out[k] = flat[off:off + t.numel()].reshape(t.shape)
        off += t.numel()
    return out


class Model:
    """Build-once, run-many model (initialization.f90:12-82).

    ``device`` defaults to ``cuda`` and never falls back to the CPU.
    Boundary fields come from ``bc_arrays`` (``{file: {var: array}}``, see
    utils/synthetic_bc.py) when given, else from the files on
    ``bc_search``. ``rows`` are the latitude rows the model's grid holds
    (all of them, but for a band view, ``for_band``), ``sp_group`` the
    process group its analyses sum over (None: no collective) and
    ``collectives`` that group's backend.

    Spans (utils/tracing.py): ``setup.tables`` (building the model),
    ``setup.boot`` (``initialize``), ``call.run_fast`` and ``call.run``
    around a call; within a call ``day.dates`` (date inputs built and
    uploaded), ``day.guard`` (the stability guard), ``day.write`` (the
    writer) and ``day.checkpoint``; and the staged day's own
    (models/captured.py).
    """

    @tracing.span("setup.tables")
    def __init__(self, cfg: ModelConfig, device=None, bc_search=None,
                 bc_arrays=None, sppt_seed: int = 0,
                 sppt_noise: Noise = None):
        check_supported(cfg)
        self.sppt_seed = sppt_seed
        self.sppt_noise = sppt_noise
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
        # what the SST-anomaly window is read with, at each shift
        self._anomaly_source = dict(search=bc_search, arrays=bc_arrays)
        self._bmask_s = host(self.lsp.bmask_s)
        self.pp = build_physics_params(
            cfg, self.geom_np, self.sp_np, host(self.lsp.fmask_l),
            host(self.lsp.fmask_s), host(self.bounds.phis0), dev)
        implicit = lambda dt: build_implicit(cfg, self.geom_np, self.diff_np,
                                             dt, dev)
        self.mc = ModelConsts(
            dyn=dyn, dc=build_diffusion(cfg, self.geom_np, dev),
            ic_half=implicit(0.5 * cfg.delt), ic_full=implicit(cfg.delt),
            ic_2dt=implicit(2 * cfg.delt), clim=clim)
        self._captured: Dict[tuple, CapturedDay] = {}
        self.graph_pool = None    # shared by the model's captured days
        self.rows = slice(0, cfg.il)
        self.sp_group = self.collectives = None

    def for_band(self, mesh) -> "Model":
        """This model's view of the latitude band that ``mesh``'s rank
        holds (``mesh.rows``, parallel/mesh.py), on the model's device:
        the grid-space constants (the spectral tables' grid side, the
        geometry's latitude fields, the land-sea, climatology and physics
        fields) built at full size on the host, as this model builds
        them, and their band's rows copied to the device; the spectral
        constants and the boundaries as this model's. Its analyses sum
        over ``mesh.sp_group``; its days are captured on CUDA unless that
        group's backend is Gloo (models/captured.py). Returns the model
        itself where the band holds every row and there is no group (sp
        = 1, or sp does not divide il)."""
        cfg, dev = self.cfg, self.device
        rows = mesh.rows(cfg.il)
        group = mesh.sp_group if cfg.il % mesh.sp == 0 else None
        if group is None:
            return self
        host = Model(cfg, "cpu", self._anomaly_source["search"],
                     self._anomaly_source["arrays"])
        grid = lambda x: x[..., rows, :].contiguous().to(dev)  # [.., il, ix]
        lat = lambda x: x[rows].contiguous().to(dev)           # [il]
        to = lambda x: x.to(dev)
        band = copy.copy(self)
        band.rows, band.sp_group = rows, group
        band.collectives = mesh.backend
        band._captured, band.graph_pool = {}, None
        geom = host.mc.dyn.geom
        band.mc = ModelConsts(
            dyn=self.mc.dyn._replace(
                sc=sp.band_spectral(host.mc.dyn.sc, rows, group, dev),
                geom=Geometry(*[lat(x) if x.shape == (cfg.il,) else to(x)
                                for x in geom])),
            dc=self.mc.dc, ic_half=self.mc.ic_half, ic_full=self.mc.ic_full,
            ic_2dt=self.mc.ic_2dt,
            clim=coupling.Climatology(*map(grid, host.mc.clim)))
        band.lsp = dataclasses.replace(host.lsp, **{
            f.name: grid(getattr(host.lsp, f.name))
            for f in dataclasses.fields(host.lsp)
            if isinstance(getattr(host.lsp, f.name), torch.Tensor)})
        band.pp = dataclasses.replace(
            self.pp, forog=grid(host.pp.forog), coa=lat(host.pp.coa),
            fmask_l=grid(host.pp.fmask_l), fmask_s=grid(host.pp.fmask_s),
            phis0=grid(host.pp.phis0))
        return band

    # ------------------------------------------------------------------
    def _season(self, date: cal.Datetime, start: cal.Datetime) -> tuple:
        """make_date_scalars' date arguments for the day starting at
        ``date`` (run began at ``start``), with the next day's weights for
        the last coupling."""
        cfg = self.cfg
        imont1, tmonth, tyear = cal.season_vars(date, cfg.iseasc,
                                                start.month)
        im_n, tm_n, _ = cal.season_vars(cal.next_day(date), cfg.iseasc,
                                        start.month)
        return (imont1, tmonth, tyear), dict(year=date.year, imont1_next=im_n,
                                            tmonth_next=tm_n)

    def date_scalars(self, date: cal.Datetime,
                     start: cal.Datetime) -> coupling.DateScalars:
        """Date inputs of the day starting at ``date`` (run began at
        ``start``), on the device."""
        args, kw = self._season(date, start)
        return coupling.make_date_scalars(self.cfg, self.geom_np, *args,
                                          self.device, **kw, rows=self.rows)

    def set_anomaly_window(self, start: cal.Datetime) -> None:
        """The SST-anomaly window around ``start``'s month
        (sea_model.f90:172-182), in place."""
        cfg = self.cfg
        coupling.initial_anomaly_window(
            cfg, self._bmask_s, (start.year - cfg.issty0) * 12 + start.month,
            self.mc.clim.sstan3, **self._anomaly_source, rows=self.rows)

    def advance_anomaly_window(self, start: cal.Datetime,
                               date: cal.Datetime) -> None:
        """Shift the SST-anomaly window at the month start ``date`` of a run
        that began at ``start``, in place: the month read is the JAX
        package's ``(start.year - issty0) * 12 + date.month``."""
        cfg = self.cfg
        coupling.advance_anomaly_window(
            cfg, self._bmask_s, self.mc.clim.sstan3,
            (start.year - cfg.issty0) * 12 + date.month,
            **self._anomaly_source, rows=self.rows)

    def initial_state(self, start: cal.Datetime) -> ModelState:
        """Rest state, day-0 surface and radiation, and the stationary SPPT
        state where SPPT is on, before the bootstrap; with SST-anomaly
        forcing, the anomaly window is set for ``start`` first."""
        cfg = self.cfg
        if cfg.sst_anomaly_forcing:
            self.set_anomaly_window(start)
        ds = self.date_scalars(start, start)
        prog = rest_state(cfg, self.geom_np, self.sp_np, self.bounds)
        surf = coupling.init_surface_state(cfg, self.pp, self.lsp,
                                           self.mc.dyn.sc, self.mc.clim, ds)
        sppt = init_sppt_state(cfg, self.pp.sppt_sigma, self.sppt_seed,
                               self.sppt_noise) if cfg.sppt_on else None
        return ModelState(prog=prog, surf=surf,
                          rad=init_radiation_state(
                              cfg, self.device, self.lsp.fmask_l.shape[0]),
                          sppt=sppt)

    @tracing.span("setup.boot")
    def initialize(self, start: cal.Datetime) -> ModelState:
        """Initial state after the leapfrog bootstrap."""
        return boot(self.cfg, self.pp, self.lsp, self.mc,
                    self.initial_state(start), self.date_scalars(start, start),
                    self.sppt_noise)

    def one_step(self, state: ModelState, daily: DailyForcing,
                 compute_sw: bool, couple_next: bool = False):
        return one_step(self.cfg, self.pp, self.lsp, self.mc, state, daily,
                        compute_sw, couple_next, noise=self.sppt_noise)

    def gridded_fields(self, prog: PrognosticState, level: int = 0
                       ) -> Dict[str, torch.Tensor]:
        return gridded_fields(self.cfg, self.mc, prog, level)

    def daily_forcing(self, state: ModelState, date: cal.Datetime,
                      start: cal.Datetime) -> DailyForcing:
        return coupling.daily_update(self.cfg, self.pp, self.lsp,
                                     self.mc.dyn.sc, self.mc.clim,
                                     self.date_scalars(date, start),
                                     state.surf)

    def make_ds_days(self, date: cal.Datetime, start: cal.Datetime,
                     n_days: int) -> Tuple[np.ndarray, cal.Datetime]:
        """Date inputs of ``n_days`` days from ``date`` (run began at
        ``start``), built ahead on the host as one [n_days, F] array
        (coupling.pack_date_scalars); returns (rows, end date)."""
        days = []
        for _ in range(n_days):
            args, kw = self._season(date, start)
            days.append(coupling.date_scalars_np(self.cfg, self.geom_np,
                                                 *args, **kw, rows=self.rows))
            for _ in range(self.cfg.nsteps):
                date = cal.newdate(date, self.cfg.nsteps)
        return coupling.pack_date_scalars(self.cfg, days, self.rows), date

    def run_day(self, state: ModelState, date: cal.Datetime,
                start: cal.Datetime, diag_every: int = 1):
        """One day from ``date`` run eagerly: (state, diagnostics)."""
        state, diags, _ = run_day(self.cfg, self.pp, self.lsp, self.mc,
                                  state, self.date_scalars(date, start),
                                  diag_every, self.sppt_noise)
        return state, diags

    def captured_day(self, state: ModelState, collect_output: bool = False,
                     grids: bool = False, accumulate: bool = False
                     ) -> CapturedDay:
        """The staged day (models/captured.py) for ``state``'s member count
        and variant: without output, diagnostics every ``cfg.diag_every``
        steps for the guard; with ``collect_output``, every step's
        diagnostics and, with ``grids``, gridded fields; with
        ``accumulate``, the monthly sums of run_multiyear. One per
        (members, variant), made at first use and captured at its first
        day on CUDA; a model's graphs share one memory pool."""
        key = (members_of(state), collect_output, grids, accumulate)
        cd = self._captured.get(key)
        if cd is None:
            if self.device.type == "cuda" and self.graph_pool is None:
                self.graph_pool = torch.cuda.graph_pool_handle()
            cd = self._captured[key] = CapturedDay(
                self, state, 1 if collect_output else self.cfg.diag_every,
                collect_output, grids, self.graph_pool, accumulate)
        return cd

    def run_staged(self, cd: CapturedDay, date: cal.Datetime,
                   start: cal.Datetime, n_days: int, noise: Noise,
                   check: bool = True, max_chunk_days: int = 90,
                   after_day=None, anomaly_months: bool = False,
                   guard=check_days) -> cal.Datetime:
        """Advance the state loaded into ``cd`` ``n_days`` from ``date``
        (run began at ``start``), in chunks of at most ``max_chunk_days``:
        a chunk's date inputs reach the device in one copy, each day is
        one replay, and with ``check`` the guard is checked on every day's
        extrema once a chunk (one host synchronisation), naming the first
        day out of range (counted from ``date``): ``guard(rows,
        first_day)`` (``check_days`` by default; an ensemble over several
        ranks reduces it over them). ``after_day(i)`` runs
        after day i's replay. With ``anomaly_months`` and SST-anomaly
        forcing on, a chunk also ends at a month's end, and the anomaly
        window shifts before each month start after ``date`` (the JAX
        package's run_fast). Returns the end date."""
        if max_chunk_days < 1:
            raise ValueError(f"max_chunk_days={max_chunk_days}")
        first, done = date, 0
        while done < n_days:
            chunk = min(n_days - done, max_chunk_days)
            if anomaly_months and self.cfg.sst_anomaly_forcing:
                if date.day == 1 and date != first:
                    self.advance_anomaly_window(start, date)
                chunk = min(chunk,
                            cal.NDAYCAL[date.month - 1] - date.day + 1)
            with tracing.span("day.dates"):
                rows, date = self.make_ds_days(date, start, chunk)
                cd.set_days(rows)
            for d in range(chunk):
                cd.advance(d, noise)
                if after_day is not None:
                    after_day(done + d)
            if check:
                with tracing.span("day.guard"):
                    guard(cd.guard_rows(chunk), done)
            done += chunk
        return date

    # ------------------------------------------------------------------
    @tracing.span("call.run_fast")
    def run_fast(self, start: cal.Datetime, n_days: int,
                 state: Optional[ModelState] = None,
                 check: bool = True, max_chunk_days: int = 90
                 ) -> ModelState:
        """Run ``n_days`` from ``start`` with no output, each day one
        replay of the captured day (the JAX package's ``run_span``); the
        stability guard is checked on each day's extrema once per chunk
        of at most ``max_chunk_days`` days, and with SST-anomaly forcing
        the chunks end at month ends, where the window shifts
        (``run_staged``). Returns a new state; the given one is left as
        it was."""
        if state is None:
            state = self.initialize(start)
        cd = self.captured_day(state)
        cd.load(state)
        self.run_staged(cd, start, start, n_days, self.sppt_noise, check,
                        max_chunk_days, anomaly_months=True)
        return cd.result()

    @tracing.span("call.run")
    def run(self, start: cal.Datetime, end: cal.Datetime,
            output_writer=None, verbose: bool = True,
            state: Optional[ModelState] = None,
            resume_date: Optional[cal.Datetime] = None,
            model_step: int = 0,
            checkpoint_every: int = 0,
            checkpoint_dir: Optional[str] = None,
            debug_nans: bool = False) -> ModelState:
        """Main loop (speedy.f90:27-54), a day at a time, with the
        stability guard on every step's diagnostics, the diagnostics printed
        every ``nstdia`` steps (``verbose``), and
        ``output_writer(step, date, start, fields)`` called with the gridded
        fields (numpy) every ``nsteps_out`` steps and at step 0. The day's
        diagnostics, and with a writer its fields, come to the host in one
        copy per day; without a writer the replayed day makes no fields.

        ``state``/``resume_date``/``model_step`` resume from a checkpoint
        (``restore``); ``checkpoint_every`` > 0 writes a checkpoint every
        that many days into ``checkpoint_dir``, with the SST-anomaly window
        where that forcing is on. With it on, the window shifts before the
        first day of a month once past step 0.

        ``debug_nans`` (the counterpart of the JAX package's
        ``jax_debug_nans``, a debugging aid): the days run eagerly, step by
        step (``checked_day``), and the first step that leaves a value
        that is not finite raises FloatingPointError naming it.
        """
        cfg = self.cfg
        if state is None:
            state = self.initialize(start)
            date = start
        else:
            date = resume_date if resume_date is not None else start
        if not date < end:
            raise ValueError(
                f"run start/resume date {date} is not before end {end}")
        if output_writer is not None and model_step == 0:
            fields = _to_host(self.gridded_fields(state.prog))
            with tracing.span("day.write"):
                output_writer(0, date, start, fields)
        if checkpoint_every and checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)
        collect = output_writer is not None
        cd = None
        if not debug_nans:
            cd = self.captured_day(state, collect_output=True, grids=collect)
            cd.load(state)
        current = lambda: state if cd is None else cd.result()
        day_count = 0
        while date < end:
            if cfg.sst_anomaly_forcing and date.day == 1 and model_step > 0:
                self.advance_anomaly_window(start, date)
            if cd is None:
                state, day = self.checked_day(state, date, start, model_step,
                                              collect)
            else:
                with tracing.span("day.dates"):
                    cd.set_days(self.make_ds_days(date, start, 1)[0])
                cd.advance(0, self.sppt_noise)
                day = cd.outputs()
            with tracing.span("day.guard"):
                for i in range(cfg.nsteps):
                    model_step += 1
                    date = cal.newdate(date, cfg.nsteps)
                    diag_i = Diagnostics(*[day[f][i]
                                           for f in Diagnostics._fields])
                    if model_step % cfg.nstdia == 0 and verbose:
                        print(format_diagnostics(diag_i, model_step))
                    check_diagnostics(diag_i, model_step)
                    if collect and model_step % cfg.nsteps_out == 0:
                        with tracing.span("day.write"):
                            output_writer(model_step, date, start,
                                          {k: day[k][i] for k in GRID_FIELDS})
                    if not date < end:
                        break
            day_count += 1
            if checkpoint_every and checkpoint_dir and \
                    day_count % checkpoint_every == 0:
                name = (f"ckpt_{date.year:04d}{date.month:02d}"
                        f"{date.day:02d}{date.hour:02d}{date.minute:02d}.npz")
                with tracing.span("day.checkpoint"), host_sync():
                    save_checkpoint(
                        os.path.join(checkpoint_dir, name), current(),
                        date, model_step, start=start,
                        sstan3=(self.mc.clim.sstan3
                                if cfg.sst_anomaly_forcing else None),
                        cfg=cfg)
        return current()

    def checked_day(self, state: ModelState, date: cal.Datetime,
                    start: cal.Datetime, model_step: int, grids: bool
                    ) -> Tuple[ModelState, Dict[str, np.ndarray]]:
        """The day from ``date`` run eagerly, step by step, with every
        leaf of the state checked after each step: the first step (counted
        on from ``model_step``) that leaves a value that is not finite
        raises FloatingPointError naming the step and the field. Returns
        the state and the day's outputs as ``CapturedDay.outputs`` gives
        them (every step's diagnostics and, with ``grids``, gridded
        fields), on the host."""
        cfg, steps = self.cfg, []
        for i, (state, outs) in enumerate(day_steps(
                cfg, self.pp, self.lsp, self.mc, state,
                self.date_scalars(date, start), 1, self.sppt_noise)):
            for group, fields in zip(ModelState._fields, state[:3]):
                for name, x in zip(fields._fields, fields):
                    if not bool(torch.isfinite(x).all()):
                        raise FloatingPointError(
                            f"step {model_step + i + 1}: {group}.{name} "
                            "is not finite")
            out = outs.diag._asdict()
            if grids:
                out.update(gridded_fields(cfg, self.mc, state.prog))
            steps.append(out)
        return state, _to_host({k: torch.stack([s[k] for s in steps])
                                for k in steps[0]})

    def restore(self, path: str, start: cal.Datetime
                ) -> Tuple[ModelState, cal.Datetime, int, dict]:
        """Resume from the checkpoint ``path`` of a run that began at
        ``start``, as the JAX package's CLI does (speedy_tpu/cli.py:
        222-237): the state restored onto ``initialize(start)``'s, its
        configuration checked, and the SST-anomaly window saved with it
        put back into the model. Returns (state, date, model_step,
        extras) for ``run(state=..., resume_date=date,
        model_step=model_step)``."""
        state, date, model_step, extras = load_checkpoint(
            path, self.initialize(start), cfg=self.cfg)
        if "sstan3" in extras:
            coupling.copy_from_host(self.mc.clim.sstan3, extras["sstan3"])
        return state, date, model_step, extras
