"""ctypes bindings for the native asynchronous NetCDF writer.

The C++ worker (``csrc/ncwriter.cpp``, the JAX package's
``native/ncwriter.cpp``) encodes NetCDF-3 classic files and does the disk
I/O on a background thread: a submission deep-copies the fields and
returns, so output-every-step runs do not wait on the files. The library
is built with g++ at first use (utils/native.py, ``host=True``); when the
build fails, the exception carries g++'s error text. The same files as
utils/output.py's scipy writer, byte for byte as the JAX package's native
writer writes them.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..config import ModelConfig
from ..geometry import build_geometry_np
from . import native
from .calendar import Datetime

SOURCES = ["ncwriter.cpp"]
LINK = ("-lpthread",)
FIELDS = ("u", "v", "t", "q", "phi", "ps")


def _library() -> ctypes.CDLL:
    """The writer's library, built first if needed; raises RuntimeError
    with the compiler's message when it cannot be built."""
    lib = native.load("ncwriter", SOURCES, LINK, host=True)
    FP = ctypes.POINTER(ctypes.c_float)
    sig = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           FP, FP, FP, ctypes.c_float, ctypes.c_char_p,
           FP, FP, FP, FP, FP, FP]
    lib.ncw_write_file.argtypes = sig
    lib.ncw_write_file.restype = ctypes.c_int
    lib.ncw_submit.argtypes = sig
    lib.ncw_submit.restype = ctypes.c_int
    lib.ncw_drain.argtypes = []
    lib.ncw_drain.restype = ctypes.c_int
    lib.ncw_pending.argtypes = []
    lib.ncw_pending.restype = ctypes.c_int
    return lib


def native_available() -> bool:
    try:
        _library()
    except (RuntimeError, OSError):
        return False
    return True


class AsyncNetCDFWriter:
    """Drop-in replacement for utils.output.NetCDFWriter backed by the C++
    async worker: ``writer(step, date, start, fields)``. Call ``drain()``
    (or use it as a context manager) before reading the files back."""

    def __init__(self, cfg: ModelConfig, outdir: str = ".",
                 synchronous: bool = False):
        self._lib = _library()
        self.cfg = cfg
        self.outdir = outdir
        self.synchronous = synchronous
        os.makedirs(outdir, exist_ok=True)
        geom = build_geometry_np(cfg)
        self.lat = np.ascontiguousarray(np.degrees(geom["radang"]),
                                        np.float32)
        self.lon = np.ascontiguousarray(np.arange(cfg.ix) * 360.0 / cfg.ix,
                                        np.float32)
        self.lev = np.ascontiguousarray(geom["fsg"], np.float32)

    def __call__(self, step: int, date: Datetime, start: Datetime,
                 fields: dict) -> str:
        cfg = self.cfg
        name = f"{date.year:04d}{date.month:02d}{date.day:02d}" \
            f"{date.hour:02d}{date.minute:02d}.nc"
        path = os.path.join(self.outdir, name)
        units = (f"hours since {start.year:04d}-{start.month:02d}-"
                 f"{start.day:02d} {start.hour:02d}:{start.minute:02d}:0.0")
        grid = (cfg.kx, cfg.il, cfg.ix)
        arrs = {}
        for k in FIELDS:
            a = np.ascontiguousarray(fields[k], np.float32)
            shape = grid[1:] if k == "ps" else grid
            if a.shape != shape:
                raise ValueError(f"field {k!r} of shape {a.shape}, expected "
                                 f"{shape}")
            arrs[k] = a
        FP = ctypes.POINTER(ctypes.c_float)
        fn = self._lib.ncw_write_file if self.synchronous \
            else self._lib.ncw_submit
        rc = fn(path.encode(), cfg.ix, cfg.il, cfg.kx,
                self.lon.ctypes.data_as(FP), self.lat.ctypes.data_as(FP),
                self.lev.ctypes.data_as(FP),
                ctypes.c_float(step * 24.0 / cfg.nsteps), units.encode(),
                *[arrs[k].ctypes.data_as(FP) for k in FIELDS])
        if rc != 0:
            raise IOError(f"ncwriter failed for {path} (rc={rc})")
        return path

    def drain(self) -> None:
        """Wait until every submitted file is written; raises if any
        asynchronous write failed."""
        errors = self._lib.ncw_drain()
        if errors:
            raise IOError(f"ncwriter: {errors} async writes failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.drain()
