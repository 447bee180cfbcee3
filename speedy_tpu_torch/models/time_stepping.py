"""Leapfrog time stepping with Robert-Williams filtering
(source/time_stepping.f90). The three-step bootstrap (first_step) uses
ImplicitConsts built for dt/2 and dt; the run continues with 2dt.

After the tendencies, a step's spectral update (the horizontal diffusion,
the stratospheric drag, the humidity diffusion and the filtered leapfrog
of every prognostic field) is ``spectral_update``: on CPU tensors its
plain twin ``spectral_update_plain``; on CUDA tensors one launch of the
kernel in csrc/spectral_step.cu, bit-equal to the twin, or it raises. Each
launch is counted (utils/tracing.py): ``step.update_launches``.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..constants import TDRS
from ..ops import spectral as sp
from ..utils import tracing
from .axes import SPEC, per_level
from .hdiffusion import DiffusionConsts, apply_diffusion
from .implicit import ImplicitConsts
from .state import TIME_AXIS, PrognosticState, time_level
from .tendencies import DynConsts, get_tendencies

SOURCES = ("spectral_step.cu",)
# each multiply and add rounded on its own, as in the twin's separate
# PyTorch operations (the kernel also writes them as __*_rn intrinsics)
NVCC_FLAGS = ("-fmad=false",)


class OrographicCorrection(NamedTuple):
    """Daily horizontal orographic-correction fields (forcing.f90:73-99)."""
    tcorh: torch.Tensor  # [mx, nx, 2]
    qcorh: torch.Tensor  # [..., mx, nx, 2] (per member: it reads the surface)


def _step_field(cfg: ModelConfig, sc, j1: int, dt: float, eps: float,
                field2: torch.Tensor, fdt: torch.Tensor,
                axis: int) -> torch.Tensor:
    """Robert-Williams filtered leapfrog update of one two-time-level field
    (time_stepping.f90:142-167); ``field2`` has the time axis at ``axis``
    (counted from the right)."""
    if cfg.ix == 4 * (cfg.il // 2):
        fdt = sp.trunct(sc, fdt)
    fold = field2.select(axis, j1 - 1)
    fnow = field2.select(axis, 0)
    fnew = fnow + dt * fdt
    f1 = fold + cfg.wil * eps * (fnow - 2.0 * fold + fnew)
    f2 = fnew - (1.0 - cfg.wil) * eps * (f1 - 2.0 * fold + fnew)
    return torch.stack([f1, f2], dim=axis)


def spectral_update_plain(cfg: ModelConfig, sc, dc: DiffusionConsts,
                          ic: ImplicitConsts, state: PrognosticState,
                          tend: tuple, corr: OrographicCorrection, j1: int,
                          dt: float, eps: float) -> PrognosticState:
    """The step's update after the tendencies ``tend`` (vordt, divdt, tdt,
    psdt, trdt) in plain PyTorch (time_stepping.f90:62-121): the new
    two-time-level state."""
    vordt, divdt, tdt, psdt, trdt = tend
    s0 = time_level(state, 0)

    # horizontal diffusion (time_stepping.f90:62-102)
    vordt = apply_diffusion(s0.vor, vordt, dc.dmp, ic.dmp1)
    divdt = apply_diffusion(s0.div, divdt, dc.dmpd, ic.dmp1d)
    # a [..., mx, nx, 2] field times a [kx] profile -> [..., kx, mx, nx, 2]
    ctmp = s0.t + per_level(corr.tcorh, SPEC) * dc.tcorv[:, None, None, None]
    tdt = apply_diffusion(ctmp, tdt, dc.dmp, ic.dmp1)

    # stratospheric zonal-mean wind drag at the top level (:77-81)
    sdrag = 1.0 / (TDRS * 3600.0)
    vordt[..., 0, 0, :, :] += -sdrag * s0.vor[..., 0, 0, :, :]
    divdt[..., 0, 0, :, :] += -sdrag * s0.div[..., 0, 0, :, :]

    vordt = apply_diffusion(s0.vor, vordt, dc.dmps, ic.dmp1s)
    divdt = apply_diffusion(s0.div, divdt, dc.dmps, ic.dmp1s)
    tdt = apply_diffusion(ctmp, tdt, dc.dmps, ic.dmp1s)

    # humidity diffusion with orographic correction; the reference uses
    # the divergence coefficients here (time_stepping.f90:96)
    qtmp = s0.tr.select(-5, 0) \
        + per_level(corr.qcorh, SPEC) * dc.qcorv[:, None, None, None]
    trdt = trdt.clone()
    trdt[..., 0, :, :, :, :] = apply_diffusion(
        qtmp, trdt.select(-5, 0), dc.dmpd, ic.dmp1d)

    # Robert-Williams leapfrog (time_stepping.f90:104-121)
    stepf = lambda f, fdt, axis: _step_field(cfg, sc, j1, dt, eps, f, fdt,
                                             axis)
    tr = torch.stack([stepf(state.tr.select(-5, i), trdt.select(-5, i),
                            TIME_AXIS["vor"])
                      for i in range(cfg.ntr)], dim=-5)
    return PrognosticState(vor=stepf(state.vor, vordt, TIME_AXIS["vor"]),
                           div=stepf(state.div, divdt, TIME_AXIS["div"]),
                           t=stepf(state.t, tdt, TIME_AXIS["t"]),
                           ps=stepf(state.ps, psdt, TIME_AXIS["ps"]),
                           tr=tr)


_lib = None


def library() -> ctypes.CDLL:
    """The kernel library, built and bound at first use."""
    global _lib
    if _lib is None:
        from ..utils import native
        lib = native.load("spectral_step", SOURCES, NVCC_FLAGS)
        lib.spectral_step_launch.restype = ctypes.c_int
        lib.spectral_step_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5)
        _lib = lib
    return _lib


def _strides(x: torch.Tensor, name: str, lead: tuple, core: tuple, dtype,
             device, shared: bool = False) -> list:
    """The element strides of ``x`` read as [members, *core]: the member
    stride (0 for one model, or for a ``shared`` input without the member
    axis), then the core axes' (0 for an axis of one). ``lead`` is the
    state's member axis, or () for one model. Raises on a wrong type,
    device or shape."""
    if x.dtype != dtype or x.device != device:
        raise ValueError(f"{name}: {x.dtype} on {x.device}, expected "
                         f"{dtype} on {device}")
    if tuple(x.shape) == lead + core:
        ms = x.stride(0) if lead else 0
    elif shared and tuple(x.shape) == core:
        ms = 0
    else:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{lead + core}")
    inner = x.stride()[x.dim() - len(core):]
    return [ms] + [0 if n == 1 else s for n, s in zip(core, inner)]


def _table(x: torch.Tensor, name: str, shape: tuple, dtype, device) -> None:
    if x.dtype != dtype or x.device != device:
        raise ValueError(f"{name}: {x.dtype} on {x.device}, expected "
                         f"{dtype} on {device}")
    if tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"{name}: shape {tuple(x.shape)} (contiguous="
                         f"{x.is_contiguous()}), expected {shape}")


def kernel_layout(cfg: ModelConfig, sc, dc: DiffusionConsts,
                  ic: ImplicitConsts, state: PrognosticState, tend: tuple,
                  corr: OrographicCorrection) -> tuple:
    """What a launch reads, checked: (the state's member axes, the 73
    element strides of spectral_step_launch, the nine tables in its
    order). Raises ValueError on a type, device, shape or layout the
    kernel does not take."""
    dtype, device = state.vor.dtype, state.vor.device
    kx, ntr, spec = cfg.kx, cfg.ntr, (cfg.mx, cfg.nx, 2)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}")
    cores = dict(vor=(kx,) + spec, div=(kx,) + spec, t=(kx,) + spec,
                 ps=spec, tr=(ntr, kx) + spec)
    lead = tuple(state.vor.shape[:-5])
    if len(lead) > 1:
        raise ValueError(f"state of shape {tuple(state.vor.shape)}: the "
                         f"kernel takes one member axis at most")
    strides = []
    for (f, x), fdt in zip(state._asdict().items(), tend):
        core = cores[f]
        ns = _strides(x, f, lead, (2,) + core, dtype, device)
        ts = _strides(fdt, f + "dt", lead, core, dtype, device)
        pad = [0] * (5 - len(core))    # a tracer and a level axis of one
        strides += ns[:2] + pad + ns[2:] + ts[:1] + pad + ts[1:]
    strides += _strides(corr.tcorh, "tcorh", lead, spec, dtype, device, True)
    strides += _strides(corr.qcorh, "qcorh", lead, spec, dtype, device, True)
    tables = [dc.dmp, dc.dmpd, dc.dmps, ic.dmp1, ic.dmp1d, ic.dmp1s,
              sc.trfilt, dc.tcorv, dc.qcorv]
    for i, x in enumerate(tables):
        _table(x, f"table {i}", spec[:2] if i < 7 else (kx,), dtype, device)
    if math.prod(lead) * (3 * kx + 1 + ntr * kx) * math.prod(spec) \
            > 2**31 - 1:
        raise ValueError(f"{math.prod(lead)} members exceed the kernel's "
                         f"index")
    return lead, strides, tables


def launch_update(cfg: ModelConfig, sc, dc: DiffusionConsts,
                  ic: ImplicitConsts, state: PrognosticState, tend: tuple,
                  corr: OrographicCorrection, j1: int, dt: float,
                  eps: float) -> PrognosticState:
    """``spectral_update_plain`` as one kernel launch on CUDA tensors, on
    their device's current stream: every input read at its own strides
    (one model's, or an ensemble's with a leading member axis), the new
    state in fresh contiguous tensors. Raises on anything the kernel does
    not take."""
    lead, strides, tables = kernel_layout(cfg, sc, dc, ic, state, tend, corr)
    dtype, device = state.vor.dtype, state.vor.device
    if j1 not in (1, 2):
        raise ValueError(f"j1={j1}, expected 1 or 2")
    if device.type != "cuda":
        raise ValueError(f"the spectral-update kernel needs CUDA tensors, "
                         f"got {device}")

    outs = {f: torch.empty(x.shape, dtype=dtype, device=device)
            for f, x in state._asdict().items()}
    ptrs = np.array([x.data_ptr() for x in
                     [*state, *tend, *outs.values(), corr.tcorh, corr.qcorh,
                      *tables]], np.uint64)
    dims = np.array([math.prod(lead), cfg.kx, cfg.ntr, cfg.mx, cfg.nx, j1,
                     int(cfg.ix == 4 * (cfg.il // 2))], np.int32)
    strides = np.array(strides, np.int64)
    sdrag = 1.0 / (TDRS * 3600.0)
    scalars = np.array([dt, cfg.wil * eps, (1.0 - cfg.wil) * eps, -sdrag],
                       np.float64)
    fn = library().spectral_step_launch
    with torch.cuda.device(device):
        err = fn(int(dtype == torch.float64), dims.ctypes.data,
                 ptrs.ctypes.data, strides.ctypes.data, scalars.ctypes.data,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spectral_step kernel launch failed: CUDA "
                           f"error {err}")
    tracing.count("step.update_launches")
    return PrognosticState(**outs)


def spectral_update(cfg: ModelConfig, sc, dc: DiffusionConsts,
                    ic: ImplicitConsts, state: PrognosticState, tend: tuple,
                    corr: OrographicCorrection, j1: int, dt: float,
                    eps: float) -> PrognosticState:
    """The step's update after the tendencies: the plain twin for CPU
    tensors, else the kernel."""
    if state.vor.device.type == "cpu":
        return spectral_update_plain(cfg, sc, dc, ic, state, tend, corr, j1,
                                     dt, eps)
    return launch_update(cfg, sc, dc, ic, state, tend, corr, j1, dt, eps)


def step(cfg: ModelConfig, dyn: DynConsts, dc: DiffusionConsts,
         ic: ImplicitConsts, state: PrognosticState,
         j1: int, j2: int, dt: float,
         corr: OrographicCorrection,
         physics_fn=None, sppt_spec=None) -> Tuple[PrognosticState, object]:
    """One time step (time_stepping.f90:35-122). j1=1, j2=1: forward step;
    j1=1, j2=2: first leapfrog; j1=2, j2=2: filtered leapfrog.
    ``sppt_spec``: the updated SPPT spectral state, synthesized in the
    step's merged batch for the physics."""
    vordt, divdt, tdt, psdt, trdt, aux = get_tendencies(
        cfg, dyn, ic, state, j2 - 1, physics_fn, sppt_spec)
    eps = 0.0 if j1 == 1 else cfg.rob
    return spectral_update(cfg, dyn.sc, dc, ic, state,
                           (vordt, divdt, tdt, psdt, trdt), corr, j1, dt,
                           eps), aux


def first_step(cfg: ModelConfig, dyn: DynConsts, dc: DiffusionConsts,
               ic_half: ImplicitConsts, ic_full: ImplicitConsts,
               state: PrognosticState, corr: OrographicCorrection,
               physics_fn=None) -> Tuple[PrognosticState, object]:
    """Leapfrog bootstrap (time_stepping.f90:12-24): a forward half step,
    then a first leapfrog step."""
    state, aux = step(cfg, dyn, dc, ic_half, state, 1, 1, 0.5 * cfg.delt,
                      corr, physics_fn)
    return step(cfg, dyn, dc, ic_full, state, 1, 2, cfg.delt, corr,
                physics_fn)
