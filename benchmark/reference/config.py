"""Model configuration.

The same frozen dataclass and presets as the JAX package's ``config.py``,
without JAX: ``rdtype`` is a ``torch.dtype``. The knobs that only shaped
the TPU build (``synthesis_split``, ``tables_bf16``, ``scan_unroll``,
``fuse_physics``) are accepted and ignored; ``check_supported`` refuses
what the JAX package's ``Model`` refuses too.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model configuration (source/params.f90:19-50)."""

    # -- Geometry --
    trunc: int = 30     # spectral truncation total wavenumber
    ix: int = 96        # number of longitudes
    il: int = 48        # number of latitudes (full sphere)
    kx: int = 8         # number of vertical (sigma) levels
    ntr: int = 1        # number of tracers (q is tracer 0)

    # -- Time stepping --
    nsteps: int = 36    # steps per day
    rob: float = 0.05   # Robert filter coefficient
    wil: float = 0.53   # Williams filter parameter
    alph: float = 0.5   # semi-implicit off-centering

    # -- Physics cadence / flags --
    iseasc: int = 1       # seasonal cycle on
    nstrad: int = 3       # shortwave radiation every nstrad steps
    sppt_on: bool = False
    issty0: int = 1979    # first year in the SST anomaly file

    # -- Horizontal-diffusion damping times, hours --
    thd: float = 2.4
    thdd: float = 2.4
    thds: float = 12.0

    # -- Coupling flags (land_model.f90:41, sea_model.f90:60-75) --
    land_coupling_flag: int = 1
    sea_coupling_flag: int = 0
    ice_coupling_flag: int = 1
    sst_anomaly_forcing: bool = False
    increase_co2: bool = False

    # -- Regional ocean domains (sea_model.f90:126-131) --
    l_globe: bool = True
    l_northe: bool = False
    l_natlan: bool = False
    l_npacif: bool = False
    l_tropic: bool = False
    l_indian: bool = False
    l_elnino: bool = False

    # -- User/namelist knobs --
    nsteps_out: int = 1
    nstdia: int = 180

    # -- Build knobs --
    precision: str = "fp32"      # "fp32" | "fp64"
    # the type the SPPT innovations are drawn in ("fp32" | "fp64"; empty:
    # ``precision``): a generator gives the same numbers as the program's
    # only in the type the program draws them in
    sppt_draws: str = ""
    n_ensemble: int = 1
    check_interval: int = 36
    scan_unroll: int = 1         # ignored: TPU scan unrolling
    synthesis_split: bool = False  # ignored: TPU synthesis grouping
    tables_bf16: bool = False    # ignored: TPU table storage
    diag_every: int = 1          # stability-diagnostic cadence (steps)
    fuse_physics: Optional[bool] = None  # ignored: the CUDA kernel runs
    #                              for CUDA tensors, the plain chain for CPU
    lw_band_vectorized: bool = True
    allow_unstable: bool = False

    @property
    def iy(self) -> int:
        return self.il // 2

    @property
    def mx(self) -> int:
        return self.trunc + 1

    @property
    def nx(self) -> int:
        return self.trunc + 2

    @property
    def delt(self) -> float:
        """Time step in seconds (params.f90:31)."""
        return 86400.0 / self.nsteps

    @property
    def rdtype(self) -> torch.dtype:
        return torch.float64 if self.precision == "fp64" else torch.float32

    @property
    def draw_dtype(self) -> torch.dtype:
        p = self.sppt_draws or self.precision
        return torch.float64 if p == "fp64" else torch.float32

    def validate(self) -> "ModelConfig":
        if self.il % 2:
            raise ValueError("il must be even (two hemispheres)")
        if self.kx not in (5, 7, 8):
            raise ValueError("sigma-level tables exist for kx in {5,7,8}")
        if self.ix < 2 * self.mx:
            raise ValueError("longitudes must resolve all zonal modes")
        return self


def check_supported(cfg: ModelConfig) -> None:
    """Refuse ``sea_coupling_flag >= 1``, as the JAX package's ``Model``
    does (the reference stops there too, sea_model.f90:188-190); every
    other option is implemented. ``n_ensemble`` is accepted and, as in the
    JAX package, not read: parallel.Ensemble takes its member count."""
    if cfg.sea_coupling_flag >= 1:
        raise NotImplementedError(
            "sea_coupling_flag >= 1 not implemented (reference stops too)")


def t30(**kw) -> ModelConfig:
    """Default reference resolution: T30, 96x48, 8 levels."""
    return ModelConfig(**kw).validate()


def t85(**kw) -> ModelConfig:
    """T85, 256x128, 8 levels, dt=900 s, halved damping times."""
    kw.setdefault("trunc", 85)
    kw.setdefault("ix", 256)
    kw.setdefault("il", 128)
    kw.setdefault("nsteps", 96)
    kw.setdefault("thd", 1.2)
    kw.setdefault("thdd", 1.2)
    kw.setdefault("thds", 6.0)
    return ModelConfig(**kw).validate()


def t42(**kw) -> ModelConfig:
    """T42, 128x64, 8 levels (dt=1200 s)."""
    kw.setdefault("trunc", 42)
    kw.setdefault("ix", 128)
    kw.setdefault("il", 64)
    kw.setdefault("nsteps", 72)
    kw.setdefault("thd", 1.9)
    kw.setdefault("thdd", 1.9)
    kw.setdefault("thds", 9.5)
    return ModelConfig(**kw).validate()


def t63(**kw) -> ModelConfig:
    """T63, 192x96, 8 levels (dt=960 s)."""
    kw.setdefault("trunc", 63)
    kw.setdefault("ix", 192)
    kw.setdefault("il", 96)
    kw.setdefault("nsteps", 90)
    kw.setdefault("thd", 1.45)
    kw.setdefault("thdd", 1.45)
    kw.setdefault("thds", 7.25)
    return ModelConfig(**kw).validate()


def t170(**kw) -> ModelConfig:
    """T170, 512x256, 8 levels (dt=240 s), quartered damping, rob=0.1."""
    kw.setdefault("trunc", 170)
    kw.setdefault("ix", 512)
    kw.setdefault("il", 256)
    kw.setdefault("nsteps", 360)
    kw.setdefault("thd", 0.6)
    kw.setdefault("thdd", 0.6)
    kw.setdefault("thds", 3.0)
    kw.setdefault("rob", 0.1)
    return ModelConfig(**kw).validate()


PRESETS = {"t30": t30, "t42": t42, "t63": t63, "t85": t85, "t170": t170}


def from_preset(name: str, **kw) -> ModelConfig:
    return PRESETS[name.lower()](**kw)
