"""Coupled surface layer: slab land, slab ocean + sea ice, climatological
forcing and the daily forcing update (source/land_model.f90,
sea_model.f90, coupler.f90, forcing.f90).

Host-side setup reads the monthly climatologies; the daily update and the
per-step slab integrations run on the device. The slab models step every
time step with per-delt relaxation coefficients (sea_model.f90:245-246).

With ``sst_anomaly_forcing`` the atmosphere sees the climatological SST
plus an observed anomaly, interpolated in a window of three months
(``Climatology.sstan3``) that the run drivers set at the start and shift
at each month start (sea_model.f90:172-182, 366-384). The window tensor
is updated in place, never rebound: a captured day reads it at the
address it had at capture.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..constants import ALHC, GAMMA, GRAV, RGAS, SBC, REFRH1
from ..ops import spectral as sp
from ..utils.io import ANOMALY_FILE, ANOMALY_MONTHS, load_boundary_file
from ..utils.calendar import forint_weights, forin5_weights
from .boundaries import fillsf, forchk
from .physics import DailyForcing, SurfaceState, Fluxes, PhysicsParams
from .axes import level
from .physics.shortwave import zonal_average_fields, EMISFC
from .physics.humidity import get_qsat

SD2SC = 60.0        # snow depth for full snow cover (land_model.f90:43)
ALBSEA = 0.07       # mod_radcon.f90:22-24
ALBICE = 0.60
ALBSN = 0.60
SSTFR = 273.2 - 1.8  # freezing-point SST (sea_model.f90:285)
ABLCO2_REF = 6.0     # reference CO2 LW absorptivity
DEL_CO2 = 0.005      # CO2 absorptivity trend per year (forcing.f90:66)
IYEAR_REF = 1950     # trend reference year (forcing.f90:65)


@dataclasses.dataclass(frozen=True)
class LandSeaParams:
    """Slab-model constants as device tensors [il, ix]."""
    fmask_l: torch.Tensor
    bmask_l: torch.Tensor
    fmask_s: torch.Tensor
    bmask_s: torch.Tensor
    rhcapl: torch.Tensor   # delt/heat-capacity (land)
    cdland: torch.Tensor   # damping factor (land)
    rhcaps: torch.Tensor   # delt/heat-capacity (sea)
    rhcapi: torch.Tensor   # delt/heat-capacity (ice)
    cdsea: torch.Tensor
    cdice: torch.Tensor
    alb0: torch.Tensor
    beta: float = 1.0      # heat-flux coefficient at the sea/ice interface


class Climatology(NamedTuple):
    """Monthly climatologies [12, il, ix] and the SST-anomaly window
    [3, il, ix] (zeros until a run with anomaly forcing sets it)."""
    stl12: torch.Tensor
    snowd12: torch.Tensor
    soilw12: torch.Tensor
    sst12: torch.Tensor
    sice12: torch.Tensor
    sstan3: torch.Tensor


def sea_domain(cdomain: str, deglat_s: np.ndarray, ix: int,
               dmask: np.ndarray) -> None:
    """Mark one named ocean domain in ``dmask`` in place
    (sea_model.f90:446-523)."""
    rlon = np.arange(ix) * (360.0 / ix)
    lat = deglat_s[:, None]
    if cdomain == "northe":
        dmask[(lat > 20.0) & np.ones(ix, bool)] = 1.0
    elif cdomain == "natlan":
        band = (lat > 20.0) & (lat < 80.0)
        dmask[band & ((rlon < 45.0) | (rlon > 260.0))] = 1.0
    elif cdomain == "npacif":
        band = (lat > 20.0) & (lat < 65.0)
        dmask[band & ((rlon > 120.0) & (rlon < 260.0))] = 1.0
    elif cdomain == "tropic":
        dmask[(lat > -30.0) & (lat < 30.0) & np.ones(ix, bool)] = 1.0
    elif cdomain == "indian":
        band = (lat > -30.0) & (lat < 30.0)
        dmask[band & ((rlon > 30.0) & (rlon < 120.0))] = 1.0
    elif cdomain == "elnino":
        arlat = np.abs(lat)
        wlat = np.where(arlat > 15.0, (0.1 * (25.0 - arlat)) ** 2, 1.0)
        rlonw = 300.0 - 2.0 * np.maximum(lat, 0.0)
        core = (rlon > 165.0) & (rlon < rlonw)
        ramp = (rlon > 155.0) & (rlon <= 165.0)
        sel = arlat < 25.0
        dmask[:] = np.where(sel & core, wlat, dmask)
        dmask[:] = np.where(sel & ramp, wlat * 0.1 * (rlon - 155.0), dmask)
    else:
        raise ValueError(f"unknown sea domain {cdomain!r}")


def build_sea_domain_mask(cfg: ModelConfig, radang: np.ndarray) -> np.ndarray:
    """Union of the enabled regional ocean domains (sea_model.f90:218-229)."""
    il, ix = cfg.il, cfg.ix
    if cfg.l_globe:
        return np.ones((il, ix))
    dmask = np.zeros((il, ix))
    deglat_s = np.degrees(radang)
    for on, name in ((cfg.l_northe, "northe"), (cfg.l_natlan, "natlan"),
                     (cfg.l_npacif, "npacif"), (cfg.l_tropic, "tropic"),
                     (cfg.l_indian, "indian"), (cfg.l_elnino, "elnino")):
        if on:
            sea_domain(name, deglat_s, ix, dmask)
    return dmask


def build_land_sea(cfg: ModelConfig, bounds_fmask: np.ndarray,
                   alb0: np.ndarray, radang: np.ndarray, device,
                   search=None, arrays=None
                   ) -> Tuple[LandSeaParams, Climatology]:
    """land_model_init + sea_model_init (land_model.f90:47-181,
    sea_model.f90:79-251)."""
    il, ix = cfg.il, cfg.ix
    thrsh = 0.1
    load = lambda f, v, months=None: load_boundary_file(
        f, v, months, search, (il, ix), arrays=arrays)

    # masks
    fmask_l = bounds_fmask.copy()
    bmask_l = np.where(fmask_l >= thrsh, 1.0, 0.0)
    fmask_l = np.where(fmask_l >= thrsh,
                       np.where(bounds_fmask > 1.0 - thrsh, 1.0, fmask_l), 0.0)
    fmask_s = 1.0 - bounds_fmask
    bmask_s = np.where(fmask_s >= thrsh, 1.0, 0.0)
    fmask_s = np.where(fmask_s >= thrsh,
                       np.where(fmask_s > 1.0 - thrsh, 1.0, fmask_s), 0.0)

    # land climatologies
    stl12 = np.stack([fillsf(f, 0.0) for f in load("land.nc", "stl", 12)])
    stl12 = forchk(bmask_l, 0.0, 400.0, 273.0, stl12, "stl")
    snowd12 = forchk(bmask_l, 0.0, 20000.0, 0.0,
                     load("snow.nc", "snowd", 12), "snowd")
    veg = np.maximum(0.0, load("surface.nc", "vegh")
                     + 0.8 * load("surface.nc", "vegl"))
    swcap, swwil, idep2 = 0.30, 0.17, 3
    swwil2 = idep2 * swwil
    rsw = 1.0 / (swcap + idep2 * (swcap - swwil))
    swl1 = load("soil.nc", "swl1", 12)
    swl2 = load("soil.nc", "swl2", 12)
    soilw12 = np.minimum(
        1.0, rsw * (swl1 + veg[None] * np.maximum(0.0, idep2 * swl2 - swwil2)))
    soilw12 = forchk(bmask_l, 0.0, 10.0, 0.0, soilw12, "soilw")

    # sea climatologies
    sst12 = np.stack([fillsf(f, 0.0) for f in
                      load("sea_surface_temperature.nc", "sst", 12)])
    sst12 = forchk(bmask_s, 100.0, 400.0, 273.0, sst12, "sst")
    sice12 = np.maximum(load("sea_ice.nc", "icec", 12), 0.0)
    sice12 = forchk(bmask_s, 0.0, 1.0, 0.0, sice12, "sice")

    # land heat capacities (land_model.f90:141-180)
    depth_soil, depth_lice, tdland = 1.0, 5.0, 40.0
    flandmin = 1.0 / 3.0
    hcapl = depth_soil * 2.50e6
    hcapli = depth_lice * 1.93e6
    dmask_l = np.where(fmask_l < flandmin, 0.0, 1.0)
    rhcapl = np.where(alb0 < 0.4, cfg.delt / hcapl, cfg.delt / hcapli)
    cdland = dmask_l * tdland / (1.0 + dmask_l * tdland)

    # sea heat capacities (sea_model.f90:101-250)
    depth_ml, dept0_ml = 60.0, 40.0
    depth_ice, dept0_ice = 2.5, 1.5
    tdsst, tdice = 90.0, 30.0
    fseamin = 1.0 / 3.0
    coslat = np.cos(radang)
    hcaps = 4.18e6 * (depth_ml + (dept0_ml - depth_ml) * coslat**3)
    hcapi = 1.93e6 * (depth_ice + (dept0_ice - depth_ice) * coslat**2)

    dmask_s = build_sea_domain_mask(cfg, radang)
    # smooth the latitudinal domain boundaries (sea_model.f90:231-234),
    # then blank out land points
    dmask_s[1:-1] = 0.25 * (dmask_s[:-2] + 2.0 * dmask_s[1:-1] + dmask_s[2:])
    dmask_s[fmask_s < fseamin] = 0.0
    rhcaps = np.broadcast_to((cfg.delt / hcaps)[:, None], (il, ix))
    rhcapi = np.broadcast_to((cfg.delt / hcapi)[:, None], (il, ix))
    cdsea = dmask_s * tdsst / (1.0 + dmask_s * tdsst)
    cdice = dmask_s * tdice / (1.0 + dmask_s * tdice)

    t = np.float64 if cfg.precision == "fp64" else np.float32
    dev = lambda a: torch.as_tensor(np.array(a, dtype=t), device=device)
    params = LandSeaParams(
        fmask_l=dev(fmask_l), bmask_l=dev(bmask_l), fmask_s=dev(fmask_s),
        bmask_s=dev(bmask_s), rhcapl=dev(rhcapl), cdland=dev(cdland),
        rhcaps=dev(rhcaps), rhcapi=dev(rhcapi), cdsea=dev(cdsea),
        cdice=dev(cdice), alb0=dev(alb0))
    clim = Climatology(stl12=dev(stl12), snowd12=dev(snowd12),
                       soilw12=dev(soilw12), sst12=dev(sst12),
                       sice12=dev(sice12), sstan3=dev(np.zeros((3, il, ix))))
    return params, clim


def _read_anomaly_month(cfg: ModelConfig, bmask_s: np.ndarray,
                        month_1b: int, search=None, arrays=None
                        ) -> np.ndarray:
    """Month ``month_1b`` (1-based, clamped to the file) of the anomaly
    file, range-checked (sea_model.f90:176-181, obs_ssta :366-384). Zeros
    with a warning when the file is absent (the reference ships a dangling
    symlink for it)."""
    idx = int(np.clip(month_1b - 1, 0, ANOMALY_MONTHS - 1))
    try:
        data = load_boundary_file(ANOMALY_FILE, "ssta", ANOMALY_MONTHS,
                                  search, bmask_s.shape, arrays=arrays,
                                  index=idx)
    except (FileNotFoundError, KeyError):
        warnings.warn(f"{ANOMALY_FILE} not found; SST anomaly set to zero")
        return np.zeros_like(bmask_s)
    return forchk(bmask_s, -50.0, 50.0, 0.0, data, "ssta")


def copy_from_host(dst: torch.Tensor, src) -> None:
    """Copy host values into ``dst`` in place, on the current stream,
    without a host synchronisation on CUDA."""
    host = torch.as_tensor(np.asarray(src)).to(dst.dtype)
    if dst.is_cuda:
        host = host.pin_memory()
    dst.copy_(host, non_blocking=True)


def initial_anomaly_window(cfg: ModelConfig, bmask_s: np.ndarray,
                           isst0: int, sstan3: torch.Tensor, search=None,
                           arrays=None, rows: slice = slice(None)) -> None:
    """The 3-month window around the start month into ``sstan3`` (the
    latitude rows ``rows`` of a band), in place (sea_model.f90:172-182):
    isst0 = (start_year - issty0) * 12 + start_month."""
    window = np.zeros((3,) + bmask_s.shape)
    for m in range(1, 4):
        if (isst0 <= 1 and m != 2) or isst0 > 1:
            window[m - 1] = _read_anomaly_month(cfg, bmask_s, isst0 - 2 + m,
                                                search, arrays)
    copy_from_host(sstan3, window[:, rows])


def advance_anomaly_window(cfg: ModelConfig, bmask_s: np.ndarray,
                           sstan3: torch.Tensor, next_month: int,
                           search=None, arrays=None,
                           rows: slice = slice(None)) -> None:
    """Month-start shift of the window (obs_ssta, sea_model.f90:366-384):
    ``sstan3`` (the rows ``rows`` of a band) drops its first month and
    takes month ``next_month`` of the file last, in place."""
    new = torch.empty_like(sstan3[0])
    copy_from_host(new, _read_anomaly_month(cfg, bmask_s, next_month,
                                             search, arrays)[rows])
    sstan3.copy_(torch.cat([sstan3[1:], new[None]]))


def _interp(w: torch.Tensor, clim: torch.Tensor) -> torch.Tensor:
    """Monthly interpolation as a weighted sum over the month axis."""
    return torch.einsum("m,mji->ji", w, clim)


class DateScalars(NamedTuple):
    """Small date-derived inputs of the daily update, on the device."""
    w5: torch.Tensor      # [12] forin5 weights
    w2: torch.Tensor      # [12] forint weights
    w2a: torch.Tensor     # [3] forint weights in the anomaly window
    fsol: torch.Tensor    # [il, 1] solar fields
    ozupp: torch.Tensor
    ozone: torch.Tensor
    zenit: torch.Tensor
    stratz: torch.Tensor
    ablco2: torch.Tensor  # [] CO2 LW absorptivity (forcing.f90:64-71)
    # next-day weights for the day's final coupling step
    w5n: torch.Tensor     # [12]
    w2n: torch.Tensor     # [12]
    w2an: torch.Tensor    # [3]


def date_scalars_np(cfg: ModelConfig, geom_np: dict, imont1: int,
                    tmonth: float, tyear: float, year: int = 0,
                    imont1_next: Optional[int] = None,
                    tmonth_next: Optional[float] = None,
                    rows: slice = slice(None)) -> DateScalars:
    """Date-derived inputs of the daily update as host arrays in the
    model's type, the [il, 1] fields at the latitude rows ``rows`` (a
    band's). ``imont1_next`` / ``tmonth_next`` are the season variables
    of the next calendar day, used for the day's final coupling step;
    they default to this day's."""
    t = np.float64 if cfg.precision == "fp64" else np.float32
    zon = zonal_average_fields(geom_np["sia"], geom_np["coa"], tyear)
    arr = lambda a: np.array(a, dtype=t)
    col = lambda a: arr(a)[rows, None]
    ablco2 = ABLCO2_REF
    if cfg.increase_co2:
        ablco2 = ABLCO2_REF * np.exp(DEL_CO2 * (year + tyear - IYEAR_REF))
    if imont1_next is None:
        imont1_next, tmonth_next = imont1, tmonth
    return DateScalars(
        w5=arr(forin5_weights(imont1, tmonth)),
        w2=arr(forint_weights(imont1, tmonth)),
        w2a=arr(forint_weights(2, tmonth, n=3)),
        fsol=col(zon["fsol"]), ozupp=col(zon["ozupp"]),
        ozone=col(zon["ozone"]), zenit=col(zon["zenit"]),
        stratz=col(zon["stratz"]), ablco2=arr(ablco2),
        w5n=arr(forin5_weights(imont1_next, tmonth_next)),
        w2n=arr(forint_weights(imont1_next, tmonth_next)),
        w2an=arr(forint_weights(2, tmonth_next, n=3)))


def make_date_scalars(cfg: ModelConfig, geom_np: dict, imont1: int,
                      tmonth: float, tyear: float, device,
                      year: int = 0,
                      imont1_next: Optional[int] = None,
                      tmonth_next: Optional[float] = None,
                      rows: slice = slice(None)) -> DateScalars:
    """``date_scalars_np`` on ``device``."""
    ds = date_scalars_np(cfg, geom_np, imont1, tmonth, tyear, year,
                         imont1_next, tmonth_next, rows)
    return DateScalars(*(torch.as_tensor(a, device=device) for a in ds))


# each field of a packed date row starts at a multiple of this many
# values (256 bytes in fp32): a view at an unaligned offset can send a
# library call (the climatology's einsum) down another path than a fresh
# tensor takes, with its sums in another order
DATE_ALIGN = 64


def _date_layout(cfg: ModelConfig, rows: slice):
    """(offset, shape) of each DateScalars field in a packed row whose
    [il, 1] fields hold the latitude rows ``rows``, and the row's length
    F."""
    n_rows = len(range(cfg.il)[rows])
    shapes = ([(12,), (12,), (3,)] + [(n_rows, 1)] * 5
              + [(), (12,), (12,), (3,)])
    layout, off = [], 0
    for s in shapes:
        layout.append((off, s))
        off += -(-math.prod(s) // DATE_ALIGN) * DATE_ALIGN
    return layout, off


def date_row_size(cfg: ModelConfig, rows: slice = slice(None)) -> int:
    """F, the length of one day's packed DateScalars (of a band's
    latitude rows ``rows``)."""
    return _date_layout(cfg, rows)[1]


def pack_date_scalars(cfg: ModelConfig, days,
                      rows: slice = slice(None)) -> np.ndarray:
    """Host DateScalars of several days (``date_scalars_np`` of the
    latitude rows ``rows``) as one [days, F] array, a row a day, each
    field at its aligned offset (``date_scalars_view`` reads a row
    back)."""
    layout, size = _date_layout(cfg, rows)
    out = np.zeros((len(days), size),
                   np.float64 if cfg.precision == "fp64" else np.float32)
    for row, ds in zip(out, days):
        for (off, s), a in zip(layout, ds):
            row[off:off + math.prod(s)] = np.reshape(a, -1)
    return out


def date_scalars_view(cfg: ModelConfig, flat: torch.Tensor,
                      rows: slice = slice(None)) -> DateScalars:
    """DateScalars as views of one [F] row laid out as
    ``pack_date_scalars`` lays it out for the latitude rows ``rows``."""
    layout, size = _date_layout(cfg, rows)
    if flat.numel() != size:
        raise ValueError(f"a date row of {flat.numel()} values, expected "
                         f"{size}")
    return DateScalars(*(flat[off:off + math.prod(s)].view(s)
                         for off, s in layout))


def _interp_sea_clim(cfg: ModelConfig, clim: Climatology, w5, w2, w2a):
    """Climatology interpolation + sea-ice freezing-point adjustment
    (couple_sea_atm, sea_model.f90:277-305) for one set of weights, and
    the SST anomaly interpolated in its window (zero without anomaly
    forcing)."""
    sstcl = _interp(w5, clim.sst12)
    sicecl = _interp(w2, clim.sice12)
    sstan = _interp(w2a, clim.sstan3) if cfg.sst_anomaly_forcing \
        else torch.zeros_like(sstcl)

    warm = sstcl > SSTFR
    sicecl_w = torch.clamp(sicecl, max=0.5)
    sstcl_w = torch.where(sicecl_w > 0.0,
                          SSTFR + (sstcl - SSTFR) / (1.0 - sicecl_w), sstcl)
    sicecl_c = torch.clamp(sicecl, min=0.5)
    ticecl_c = SSTFR + (sstcl - SSTFR) / sicecl_c
    sicecl = torch.where(warm, sicecl_w, sicecl_c)
    ticecl = torch.where(warm, torch.full_like(sstcl, SSTFR), ticecl_c)
    sstcl = torch.where(warm, sstcl_w, torch.full_like(sstcl, SSTFR))
    return sstcl, sicecl, ticecl, sstan


def daily_update(cfg: ModelConfig, pp: PhysicsParams, lsp: LandSeaParams,
                 sc: sp.SpectralConsts, clim: Climatology, ds: DateScalars,
                 surf: SurfaceState) -> DailyForcing:
    """Daily forcing update: climatology interpolation (couple_*_atm),
    sea-ice adjustment (sea_model.f90:283-305), albedo and orographic
    corrections (forcing.f90:49-99). For an ensemble state what depends
    only on the date is computed once and shared by all members (the solar
    fields, ablco2, the climatologies, alb_l, snowc, tcorh); what reads the
    surface state (alb_s, albsfc, qcorh) is per member."""
    stlcl = _interp(ds.w5, clim.stl12)
    snowdcl = _interp(ds.w2, clim.snowd12)
    soilwcl = _interp(ds.w2, clim.soilw12)
    sstcl, sicecl, ticecl, sstan = _interp_sea_clim(cfg, clim, ds.w5, ds.w2,
                                                    ds.w2a)
    stlcl_nx = _interp(ds.w5n, clim.stl12)
    sstcl_nx, sicecl_nx, ticecl_nx, sstan_nx = _interp_sea_clim(
        cfg, clim, ds.w5n, ds.w2n, ds.w2an)

    # surface albedo (forcing.f90:55-62); the sea albedo uses the sea-ice
    # state of the last coupling step, as the reference does
    snowc = torch.clamp(snowdcl / SD2SC, max=1.0)
    alb_l = lsp.alb0 + snowc * (ALBSN - lsp.alb0)
    alb_s = ALBSEA + surf.sice_am * (ALBICE - ALBSEA)
    albsfc = alb_s + lsp.fmask_l * (alb_l - alb_s)

    # orographic-correction spectral fields (forcing.f90:73-99)
    gamlat = GAMMA / (1000.0 * GRAV)
    corh = gamlat * pp.phis0
    tcorh = sp.grid_to_spec(sc, corh)

    pexp = 1.0 / (RGAS * gamlat)
    tsfc = lsp.fmask_l * surf.stl_am + lsp.fmask_s * surf.sst_am
    tref = tsfc + corh
    psfc = (tsfc / tref) ** pexp
    qref = get_qsat(tref, torch.ones_like(psfc), -1.0)
    qsfc = get_qsat(tsfc, psfc, 1.0)
    qcorh = sp.grid_to_spec(sc, REFRH1 * (qref - qsfc))

    return DailyForcing(
        fsol=ds.fsol, ozupp=ds.ozupp, ozone=ds.ozone, zenit=ds.zenit,
        stratz=ds.stratz, ablco2=ds.ablco2,
        alb_l=alb_l, alb_s=alb_s, albsfc=albsfc,
        snowc=snowc, tcorh=tcorh, qcorh=qcorh,
        stlcl_ob=stlcl, snowd_am=snowdcl, soilw_am=soilwcl,
        sstcl_ob=sstcl, sicecl_ob=sicecl, ticecl_ob=ticecl, sstan_ob=sstan,
        stlcl_nx=stlcl_nx, sstcl_nx=sstcl_nx, sicecl_nx=sicecl_nx,
        ticecl_nx=ticecl_nx, sstan_nx=sstan_nx)


def select_couple_daily(daily: DailyForcing, use_next: bool) -> DailyForcing:
    """The DailyForcing that couple_step sees: on the day's last step the
    climatology fields switch to the next day's interpolation (the
    reference couples after newdate, speedy.f90:47-53)."""
    if not use_next:
        return daily
    return daily._replace(
        stlcl_ob=daily.stlcl_nx, sstcl_ob=daily.sstcl_nx,
        sicecl_ob=daily.sicecl_nx, ticecl_ob=daily.ticecl_nx,
        sstan_ob=daily.sstan_nx)


def init_surface_state(cfg: ModelConfig, pp: PhysicsParams,
                       lsp: LandSeaParams, sc: sp.SpectralConsts,
                       clim: Climatology, ds: DateScalars) -> SurfaceState:
    """Day-0 initialization (land_model.f90:201-205,
    sea_model.f90:307-318)."""
    zero = torch.zeros_like(lsp.fmask_l)
    surf0 = SurfaceState(*([zero] * len(SurfaceState._fields)))
    daily = daily_update(cfg, pp, lsp, sc, clim, ds, surf0)
    surf = SurfaceState(
        stl_lm=daily.stlcl_ob, stl_am=daily.stlcl_ob,
        sst_om=zero, tice_om=daily.ticecl_ob, sice_om=daily.sicecl_ob,
        sst_am=zero, sice_am=zero, tice_am=zero, ssti_om=zero)
    return _update_am_fields(cfg, daily, surf)


def _update_am_fields(cfg: ModelConfig, daily: DailyForcing,
                      surf: SurfaceState) -> SurfaceState:
    """Sea-surface fields seen by the atmosphere (sea_model.f90:327-362),
    for sea_coupling_flag 0: the climatology plus the SST anomaly where the
    forcing is on."""
    sstan_am = daily.sstan_ob if cfg.sst_anomaly_forcing \
        else torch.zeros_like(daily.sstan_ob)
    sst_am = daily.sstcl_ob + sstan_am
    if cfg.ice_coupling_flag > 0:
        sice_am, tice_am = surf.sice_om, surf.tice_om
    else:
        sice_am, tice_am = daily.sicecl_ob, daily.ticecl_ob
    sst_am = sst_am + sice_am * (tice_am - sst_am)
    ssti_om = surf.sst_om + sice_am * (tice_am - surf.sst_om)
    return surf._replace(sst_am=sst_am, sice_am=sice_am, tice_am=tice_am,
                         ssti_om=ssti_om)


def couple_step(cfg: ModelConfig, lsp: LandSeaParams, daily: DailyForcing,
                surf: SurfaceState, fluxes: Fluxes) -> SurfaceState:
    """Per-step slab land + sea/ice integration (coupler.f90:30-38,
    land_model.f90:224-239, sea_model.f90:387-444)."""
    # land
    if cfg.land_coupling_flag == 1:
        tanom = surf.stl_lm - daily.stlcl_ob
        tanom = lsp.cdland * (tanom + lsp.rhcapl * level(fluxes.sfc.hfluxn, 0))
        stl_lm = tanom + daily.stlcl_ob
        stl_am = stl_lm
    else:
        stl_lm = surf.stl_lm
        stl_am = daily.stlcl_ob

    # sea + ice
    if cfg.sea_coupling_flag > 0 or cfg.ice_coupling_flag > 0:
        difice = ((ALBSEA - ALBICE) * fluxes.ssrd
                  + EMISFC * SBC * (SSTFR**4 - surf.tice_am**4)
                  + level(fluxes.sfc.shf, 1)
                  + level(fluxes.sfc.evap, 1) * ALHC)
        hflux_i = level(fluxes.sfc.hfluxn, 1) + difice * (1.0 - surf.sice_am)
        hflux = level(fluxes.sfc.hfluxn, 1) \
            - daily.sicecl_ob * (hflux_i + lsp.beta * (SSTFR - surf.tice_om))
        tanom = surf.sst_om - daily.sstcl_ob
        tanom = lsp.cdsea * (tanom + lsp.rhcaps * hflux)
        sst_om = tanom + daily.sstcl_ob

        hflux_ice = hflux_i + lsp.beta * (SSTFR - surf.tice_om)
        tanom_i = surf.tice_om - daily.ticecl_ob
        anom0 = 20.0
        cdis = lsp.cdice * (anom0 / (anom0 + torch.abs(tanom_i)))
        tanom_i = cdis * (tanom_i + lsp.rhcapi * hflux_ice)
        tice_om = tanom_i + daily.ticecl_ob
        sice_om = daily.sicecl_ob
    else:
        sst_om, tice_om, sice_om = surf.sst_om, surf.tice_om, surf.sice_om

    surf = surf._replace(stl_lm=stl_lm, stl_am=stl_am, sst_om=sst_om,
                         tice_om=tice_om, sice_om=sice_om)
    surf = _update_am_fields(cfg, daily, surf)
    # in an ensemble, a field set from the date alone (the climatology)
    # keeps the state's member axis, as a view that all members share
    shape = torch.broadcast_shapes(*(x.shape for x in surf))
    return SurfaceState(*(x if x.shape == shape else x.expand(shape)
                          for x in surf))
