"""Boundary-field reading (input_output.f90:15-92).

Fields come either from NetCDF4/HDF5 files on a search path (``h5py`` is
imported only when a file is read) or from an in-memory dict
``{file: {var: array}}`` laid out as the files are. Either way the
reference's conventions apply: the source stores latitude north -> south
and the model grid runs south -> north, values <= -999 become zero, and
values are promoted to float64. A field on another grid is regridded
bilinearly.
"""
from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np

from ..constants import PI_F

# the SST-anomaly file that sst_anomaly_forcing reads: ssta, one field a
# month from January of cfg.issty0 (sea_model.f90:177)
ANOMALY_FILE = "sea_surface_temperature_anomaly.nc"
ANOMALY_MONTHS = 420

DEFAULT_BC_PATHS = [
    os.environ.get("SPEEDY_BC_PATH", ""),
    "data/bc/t30/clim",
]


def find_boundary_file(name: str, search: Optional[list] = None) -> str:
    for base in (search or DEFAULT_BC_PATHS):
        if not base:
            continue
        path = os.path.join(base, name)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        f"boundary file {name!r} not found in {search or DEFAULT_BC_PATHS}")


def gaussian_seed_lats(il: int) -> np.ndarray:
    """Latitudes (radians, south -> north) of the il-point grid at the
    asymptotic Gauss-node seed (geometry.f90:66-76)."""
    iy = il // 2
    j = np.arange(1, iy + 1, dtype=np.float64)
    lat_half = np.arcsin(np.cos(PI_F * (j - 0.25) / (il + 0.5)))
    return np.concatenate([-lat_half, lat_half[::-1]])


def regrid_latlon(field: np.ndarray, il_dst: int, ix_dst: int) -> np.ndarray:
    """Bilinear regrid of [..., il_src, ix_src] between Gaussian-seed grids:
    periodic in longitude, linear in latitude, clamped at the poles. Fill
    values (|x| >= 1e30) are excluded by validity weighting."""
    *lead, il_src, ix_src = field.shape
    if (il_src, ix_src) == (il_dst, ix_dst):
        return field
    flat = field.reshape(-1, il_src, ix_src)
    valid = (np.abs(flat) < 1.0e30).astype(np.float64)
    fill_mean = np.array([
        s[v > 0].mean() if (v > 0).any() else 0.0
        for s, v in zip(flat, valid)])
    num = flat * valid

    def interp(a):
        xl = np.arange(ix_dst) * (ix_src / ix_dst)
        i0 = np.floor(xl).astype(int) % ix_src
        i1 = (i0 + 1) % ix_src
        wx = (xl - np.floor(xl))[None, None, :]
        a = a[:, :, i0] * (1.0 - wx) + a[:, :, i1] * wx
        lat_src = gaussian_seed_lats(il_src)
        lat_dst = gaussian_seed_lats(il_dst)
        j1 = np.searchsorted(lat_src, lat_dst).clip(1, il_src - 1)
        j0 = j1 - 1
        wy = ((lat_dst - lat_src[j0]) / (lat_src[j1] - lat_src[j0]))
        wy = np.clip(wy, 0.0, 1.0)[None, :, None]
        return a[:, j0, :] * (1.0 - wy) + a[:, j1, :] * wy

    num_i, den_i = interp(num), interp(valid)
    out = np.where(den_i > 1.0e-12, num_i / np.maximum(den_i, 1.0e-12),
                   fill_mean[:, None, None])
    return out.reshape(*lead, il_dst, ix_dst)


def load_boundary_file(name: str, var: str,
                       months: Optional[int] = None,
                       search: Optional[list] = None,
                       target_shape: Optional[tuple] = None,
                       arrays: Optional[Mapping] = None,
                       index: Optional[int] = None) -> np.ndarray:
    """Read a 2-D field ([il, ix]) or a monthly climatology
    ([months, il, ix]) from ``arrays[name][var]`` when ``arrays`` is given,
    else from the file ``name`` on ``search``; with ``index``, only that
    month (0-based) of the climatology, as [il, ix] (each month is
    regridded on its own, so this equals the whole field's month
    ``index``)."""
    if arrays is not None:
        src = arrays[name][var]
    else:
        import h5py
        f = h5py.File(find_boundary_file(name, search), "r")
        src = f[var]
    try:
        shape = tuple(src.shape)
        want = 2 if months is None else 3
        if len(shape) != want or (months is not None
                                  and shape[0] != months):
            raise ValueError(
                f"{name}:{var} has shape {shape}, expected "
                f"{'[months, lat, lon]' if months else '[lat, lon]'}")
        data = np.array(src if index is None else src[index],
                        dtype=np.float64)
    finally:
        if arrays is None:
            f.close()
    data = data[..., ::-1, :].copy()
    data[data <= -999.0] = 0.0
    if target_shape is not None:
        data = regrid_latlon(data, *target_shape)
    return data
