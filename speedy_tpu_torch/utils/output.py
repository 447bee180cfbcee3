"""NetCDF output writer matching the reference's file schema.

Reference: source/input_output.f90:95-217. One file per output step named
yyyymmddhhmm.nc with dims (time, lev, lat, lon) and float32 variables
u, v, t, q, phi, ps carrying the same long_name/units attributes. Written
with scipy's NetCDF3 writer (readable by any NetCDF tool). The same files,
names, dimensions, variables and attributes as the JAX package's
utils/output.py; the fields come in as numpy arrays (Model.run brings them
to the host).
"""
from __future__ import annotations

import os

import numpy as np

from ..config import ModelConfig
from ..geometry import build_geometry_np
from ..utils.calendar import Datetime


class NetCDFWriter:
    """Callable output writer: writer(step, date, start, fields)."""

    def __init__(self, cfg: ModelConfig, outdir: str = "."):
        self.cfg = cfg
        self.outdir = outdir
        os.makedirs(outdir, exist_ok=True)
        geom = build_geometry_np(cfg)
        self.lat = np.degrees(geom["radang"]).astype(np.float32)
        self.lon = (np.arange(cfg.ix) * 360.0 / cfg.ix).astype(np.float32)
        self.lev = geom["fsg"].astype(np.float32)

    def __call__(self, step: int, date: Datetime, start: Datetime,
                 fields: dict) -> str:
        from scipy.io import netcdf_file
        cfg = self.cfg
        name = f"{date.year:04d}{date.month:02d}{date.day:02d}" \
            f"{date.hour:02d}{date.minute:02d}.nc"
        path = os.path.join(self.outdir, name)
        f = netcdf_file(path, "w")
        f.createDimension("time", None)
        f.createDimension("lon", cfg.ix)
        f.createDimension("lat", cfg.il)
        f.createDimension("lev", cfg.kx)

        tv = f.createVariable("time", "f", ("time",))
        tv.units = (f"hours since {start.year:04d}-{start.month:02d}-"
                    f"{start.day:02d} {start.hour:02d}:{start.minute:02d}:0.0"
                    ).encode()
        tv[0] = np.float32(step * 24.0 / cfg.nsteps)
        lonv = f.createVariable("lon", "f", ("lon",))
        lonv.long_name = b"longitude"
        lonv[:] = self.lon
        latv = f.createVariable("lat", "f", ("lat",))
        latv.long_name = b"latitude"
        latv[:] = self.lat
        levv = f.createVariable("lev", "f", ("lev",))
        levv.long_name = b"atmosphere_sigma_coordinate"
        levv[:] = self.lev

        meta = {
            "u": (b"eastward_wind", b"m/s"),
            "v": (b"northward_wind", b"m/s"),
            "t": (b"air_temperature", b"K"),
            "q": (b"specific_humidity", b"1"),
            "phi": (b"geopotential_height", b"m"),
        }
        for var, (ln, un) in meta.items():
            v = f.createVariable(var, "f", ("time", "lev", "lat", "lon"))
            v.long_name = ln
            v.units = un
            v[0] = np.asarray(fields[var], np.float32)
        psv = f.createVariable("ps", "f", ("time", "lat", "lon"))
        psv.long_name = b"surface_air_pressure"
        psv.units = b"Pa"
        psv[0] = np.asarray(fields["ps"], np.float32)
        f.close()
        return path
