"""Analytic, seeded stand-in for the T30 boundary files.

The model reads six boundary files (orography, land-sea mask, albedo,
vegetation, and monthly land temperature, snow, soil water, SST and sea
ice). Where the real files are not available, ``synthetic_boundaries``
builds smooth fields with the same layout: ``{file: {var: float32
[..., 48, 96]}}``, latitude north -> south as in the files, months in
front. Every value lies inside the range that ``forchk`` accepts for its
field. The fields are a stand-in for missing data, not a climatology: a
few smooth continents with orography, an Antarctic ice sheet, an
equator-to-pole SST with a seasonal shift, and polar sea ice.

``synthetic_boundaries(seed, anomaly=True)`` adds the SST-anomaly file
that ``sst_anomaly_forcing`` reads (``sea_surface_temperature_anomaly.nc``,
``ssta`` [420, 48, 96], 7.7 MB): smooth travelling patterns of a few
kelvin, different every month. It is drawn from a generator of its own, so
the other files are the same with and without it.
"""
from __future__ import annotations

import numpy as np

from .io import ANOMALY_FILE, ANOMALY_MONTHS, gaussian_seed_lats

FILES = {
    "surface.nc": ("orog", "lsm", "alb", "vegh", "vegl"),
    "land.nc": ("stl",),
    "snow.nc": ("snowd",),
    "soil.nc": ("swl1", "swl2"),
    "sea_surface_temperature.nc": ("sst",),
    "sea_ice.nc": ("icec",),
}


IL, IX = 48, 96   # the grid of the boundary files


def synthetic_anomalies(seed: int = 0) -> np.ndarray:
    """Stand-in monthly SST anomalies, float32 [420, 48, 96] (N -> S): two
    zonally travelling waves and an equatorial pattern, each with its own
    seeded period, amplitude and phase, so that every month differs from
    the next; within +-6 K, inside forchk's [-50, 50]."""
    rng = np.random.default_rng([seed, 1])
    lat = np.radians(np.degrees(gaussian_seed_lats(IL))[::-1])[:, None]
    lon = np.radians(np.arange(IX) * 360.0 / IX)[None, :]
    month = np.arange(ANOMALY_MONTHS)[:, None, None]
    ssta = np.zeros((ANOMALY_MONTHS, IL, IX))
    for wave in range(1, 3):
        amp, period = rng.uniform(0.8, 2.0), rng.uniform(5.0, 40.0)
        lat0, phase = rng.uniform(-40.0, 40.0), rng.uniform(0.0, 2 * np.pi)
        envelope = np.exp(-((lat - np.radians(lat0)) / 0.5) ** 2)
        ssta += amp * envelope * np.cos(
            wave * lon - 2 * np.pi * month / period + phase)
    amp, period = rng.uniform(1.0, 2.0), rng.uniform(30.0, 60.0)
    ssta += (amp * np.exp(-(lat / 0.2) ** 2) * np.cos(lon - np.pi)
             * np.sin(2 * np.pi * month / period))
    return ssta.astype(np.float32)


def synthetic_boundaries(seed: int = 0, anomaly: bool = False) -> dict:
    """Stand-in boundary set on the 48 x 96 Gaussian-seed grid; with
    ``anomaly``, also the SST-anomaly file (synthetic_anomalies)."""
    rng = np.random.default_rng(seed)
    lat = np.degrees(gaussian_seed_lats(IL))[::-1][:, None]   # N -> S
    lon = (np.arange(IX) * 360.0 / IX)[None, :]
    slat = np.sin(np.radians(lat))

    # continents: smooth super-Gaussian blobs at seeded positions
    land = np.zeros((IL, IX))
    hill = np.zeros((IL, IX))
    for _ in range(5):
        lat0 = rng.uniform(-45.0, 65.0)
        lon0 = rng.uniform(0.0, 360.0)
        r_lat, r_lon = rng.uniform(15.0, 30.0), rng.uniform(20.0, 45.0)
        dlon = (lon - lon0 + 180.0) % 360.0 - 180.0
        d2 = ((lat - lat0) / r_lat) ** 2 + (dlon / r_lon) ** 2
        land = np.maximum(land, np.exp(-d2 ** 2))
        hill = np.maximum(hill, rng.uniform(500.0, 2500.0) * np.exp(-2.0 * d2))
    antarctic = 1.0 / (1.0 + np.exp((lat + 68.0) / 2.0))
    land = np.maximum(land, antarctic)
    lsm = np.clip(1.6 * land - 0.3, 0.0, 1.0)
    orog = lsm * hill + 2500.0 * antarctic

    alb = np.where(lsm > 0.0, 0.17 + 0.08 * np.cos(np.radians(2.0 * lat)),
                   0.07)
    alb = alb + antarctic * (0.6 - alb)
    tropics = np.exp(-(lat / 25.0) ** 2)
    vegh = 0.7 * lsm * tropics * (1.0 - antarctic)
    vegl = 0.4 * lsm * (1.0 - antarctic)

    months = np.arange(1, 13)[:, None, None]
    season = np.cos(2.0 * np.pi * (months - 7.0) / 12.0)   # +1 in July
    stl = (300.0 - 45.0 * slat ** 2 + 15.0 * slat * season
           - 6.5e-3 * orog - 20.0 * antarctic)
    snowd = np.clip(4.0 * (271.0 - stl), 0.0, 400.0)
    wet = 0.15 + 0.15 * tropics + 0.05 * np.cos(np.radians(3.0 * lat))
    swl1 = wet * (1.0 + 0.1 * season * slat)
    swl2 = 0.9 * swl1
    sst = 271.5 + 30.0 * np.cos(np.radians(lat - 8.0 * season)) ** 2
    icec = np.clip((np.abs(lat) - 62.0) / 12.0
                   - 0.4 * season * np.sign(lat), 0.0, 1.0)
    icec = np.where(sst < 274.0, icec, 0.0)

    def f32(a, months=False):
        shape = ((12,) if months else ()) + (IL, IX)
        return np.ascontiguousarray(np.broadcast_to(a, shape),
                                    dtype=np.float32)

    out = {
        "surface.nc": dict(orog=f32(orog), lsm=f32(lsm), alb=f32(alb),
                           vegh=f32(vegh), vegl=f32(vegl)),
        "land.nc": dict(stl=f32(stl, True)),
        "snow.nc": dict(snowd=f32(snowd, True)),
        "soil.nc": dict(swl1=f32(swl1, True), swl2=f32(swl2, True)),
        "sea_surface_temperature.nc": dict(sst=f32(sst, True)),
        "sea_ice.nc": dict(icec=f32(icec, True)),
    }
    if anomaly:
        out[ANOMALY_FILE] = dict(ssta=synthetic_anomalies(seed))
    return out


def write_boundary_files(directory: str, arrays: dict) -> None:
    """Write a boundary set as HDF5 files (the layout of the NetCDF4 files
    the model reads) into ``directory``."""
    import os
    import h5py
    for name, fields in arrays.items():
        with h5py.File(os.path.join(directory, name), "w") as f:
            for var, a in fields.items():
                f.create_dataset(var, data=a)
