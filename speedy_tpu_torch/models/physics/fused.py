"""The column-physics kernel: the whole grid-point physics chain as one
CUDA kernel, one thread per (lat, lon) column (csrc/column_physics.cu).

It replaces the JAX package's Pallas kernel
``speedy_tpu/models/physics/fused.py::fused_grid_physics``.
``fused_grid_physics`` below takes the same arguments and returns the same
structure as ``grid_physics_core``. On CPU tensors it runs that plain
chain; on CUDA tensors it launches the kernel or raises. ``launches``
counts kernel launches (``launches_sw`` those of the shortwave variant).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...constants import GRAV, P0, RGAS
from . import convection, condensation, shortwave
from . import vertical_diffusion as vdif_mod
from .surface import SurfaceFluxes

SOURCES = ("column_physics.cu",)
N_IN_SW, N_IN = 23, 27      # kernel inputs on SW / non-SW steps
N_OUT, N_OUT_SW = 21, 27    # kernel outputs on non-SW / SW steps
MAXL = 9                    # slots per level table in the argument block
N_TABLES, N_SCALARS = 15, 16

launches = 0
launches_sw = 0


def reset_launches() -> None:
    global launches, launches_sw
    launches = launches_sw = 0


def kernel_inputs(cfg, pp, compute_sw, daily, surf, rad, pg) -> list:
    """The kernel's inputs in its order, contiguous: the lowest-level
    winds ug, vg as [il, ix] (the chain reads no other level of them),
    tg, qg, phig as [kx, il, ix], 11 x [il, ix], 6 x [il] (the [il, 1]
    fields and coa), ablco2 as [1]; on non-SW steps also tau2
    [4, kx, il, ix], stratc [2, il, ix], tt_rsw [kx, il, ix] and ssrd
    [il, ix]."""
    ins = [pg.ug[-1], pg.vg[-1], pg.tg, pg.qg, pg.phig,
           pg.pslg, daily.albsfc, daily.alb_l, daily.alb_s, daily.snowc,
           daily.soilw_am, surf.stl_am, surf.sst_am,
           pp.forog, pp.phis0, pp.fmask_l,
           daily.fsol, daily.ozupp, daily.ozone, daily.zenit, daily.stratz,
           pp.coa, daily.ablco2]
    if not compute_sw:
        ins += [rad.tau2, rad.stratc, rad.tt_rsw, rad.ssrd]
    return [(x.reshape(-1) if x.dim() == 0 or x.shape[-1] == 1 else x
             ).contiguous() for x in ins]


def output_shapes(kx: int, il: int, ix: int, compute_sw: bool) -> list:
    shapes = ([(kx, il, ix)] * 4          # utend vtend ttend qtend
              + [(il, ix)] * 6            # precnv precls cbmf slrd slr olr
              + [(3, il, ix)] * 5         # ustr vstr shf evap slru
              + [(2, il, ix)]             # hfluxn
              + [(il, ix)] * 5)           # tsfc tskin u0 v0 t0
    if compute_sw:
        shapes += [(4, kx, il, ix), (2, il, ix), (kx, il, ix),
                   (il, ix), (il, ix), (il, ix)]  # tau2 stratc tt_rsw ssrd ssr tsr
    return shapes


def _unflatten(outs, compute_sw):
    sfc = SurfaceFluxes(*outs[10:21])
    base = tuple(outs[:10]) + (sfc,)
    return base + tuple(outs[21:]) if compute_sw else base


def plain_outputs(cfg, pp, compute_sw: bool, ins: list) -> list:
    """The kernel's plain twin: grid_physics_core on the kernel's inputs
    (kernel_inputs order), returning the flat list of outputs. The
    lowest-level winds are broadcast over the levels: the chain reads only
    the lowest."""
    from . import grid_physics_core
    col = lambda x: x.reshape(cfg.il, 1)
    lev = lambda x: x.expand(cfg.kx, cfg.il, cfg.ix)
    a = ins
    outs = grid_physics_core(
        cfg, pp, compute_sw, lev(a[0]), lev(a[1]), a[2], a[3], a[4], a[5],
        col(a[16]), col(a[17]), col(a[18]), col(a[19]), col(a[20]), a[6],
        a[22].reshape(()), a[7], a[8], a[9], a[10], a[11], a[12],
        a[13], a[21], a[14], a[15],
        *((None,) * 4 if compute_sw else a[23:27]))
    return list(outs[:10]) + list(outs[10]) + list(outs[11:])


def argument_block(pp) -> np.ndarray:
    """The level tables and scalars the kernel reads, float64, laid out as
    ``ColumnTables`` in csrc/column_physics.cu: N_TABLES tables of MAXL
    slots, then N_SCALARS scalars. Every value is the one the plain chain
    uses, so the kernel sees the same constants."""
    kx = pp.fsg.shape[0]
    tab = np.zeros((N_TABLES, MAXL))
    put = lambda i, a: tab[i].__setitem__(slice(0, len(a)),
                                          np.asarray(a, np.float64))
    vd = vdif_mod.vdif_coefficients(pp.dhs, pp.sigh)
    rhref, dqmax = condensation.lsc_profiles(pp.fsg)
    fvdiq2_k = np.zeros(kx + 1)
    drh0_k = np.zeros(kx)
    for k0 in range(kx - 1):
        drh0_k[k0] = vdif_mod.RHGRAD * float(pp.fsg[k0 + 1] - pp.fsg[k0])
    for k in range(kx + 1):
        fvdiq2_k[k] = float(vd["fvdiq"] * pp.sigh[k])
    for i, a in enumerate((
            pp.fsg, pp.dhs, pp.sigh, pp.wvi2, pp.grdsig, pp.grdscp,
            convection.entrainment_profile(pp.fsg), rhref, dqmax,
            shortwave.ABSDRY + shortwave.ABSAER * pp.fsg**2,
            vd["rsig"], vd["rsig1"], pp.dhs[1:] * (P0 / GRAV),
            fvdiq2_k, drh0_k)):
        put(i, a)
    vdif_mask = sum(1 << k for k in range(3, kx - 1) if float(pp.sigh[k]) > 0.5)
    scal = np.zeros(N_SCALARS)
    scal[:9] = [convection.cloud_base_mass_flux_scale(pp.dhs),
                RGAS * 288.0 * float(pp.sigl[kx - 1]),
                float(shortwave.EPSLW / (pp.dhs[0] + pp.dhs[1])),
                float(vd["fshcq"]), float(vd["fshcse"]), float(vd["fvdise"]),
                float(vdif_mask), 0.0, 0.0]
    return np.concatenate([tab.ravel(), scal])


_launch_fn = None


def _launcher():
    """The C entry point of the kernel library, built and bound at first
    use."""
    global _launch_fn
    if _launch_fn is None:
        from ...utils import native
        fn = native.load("column_physics", SOURCES).column_physics_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _launch_fn = fn
    return _launch_fn


def _check(x: torch.Tensor, shape, dtype, device, i: int) -> None:
    if x.device != device or x.dtype != dtype:
        raise ValueError(f"input {i}: {x.dtype} on {x.device}, expected "
                         f"{dtype} on {device}")
    if x.numel() != int(np.prod(shape)) or not x.is_contiguous():
        raise ValueError(f"input {i}: shape {tuple(x.shape)} (contiguous="
                         f"{x.is_contiguous()}), expected {shape}")


def launch_kernel(cfg, compute_sw: bool, ins: list, block: np.ndarray):
    """Launch the kernel on CUDA tensors ``ins`` (kernel_inputs order)
    with the float64 argument block, on the tensors' device and its
    current stream; returns the flat list of outputs."""
    global launches, launches_sw
    kx, il, ix = cfg.kx, cfg.il, cfg.ix
    dtype, device = ins[2].dtype, ins[2].device
    if device.type != "cuda":
        raise ValueError(f"the column-physics kernel needs CUDA tensors, "
                         f"got {device}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}")
    if kx not in (5, 7, 8):
        raise ValueError(f"kx={kx} is not built (5, 7, 8)")
    n_in = N_IN_SW if compute_sw else N_IN
    if len(ins) != n_in:
        raise ValueError(f"{len(ins)} inputs, expected {n_in}")
    in_shapes = ([(il, ix)] * 2 + [(kx, il, ix)] * 3 + [(il, ix)] * 11
                 + [(il,)] * 6 + [(1,)]
                 + [(4, kx, il, ix), (2, il, ix), (kx, il, ix), (il, ix)])
    for i, (x, s) in enumerate(zip(ins, in_shapes)):
        _check(x, s, dtype, device, i)
    outs = [torch.empty(s, dtype=dtype, device=device)
            for s in output_shapes(kx, il, ix, compute_sw)]

    if block.dtype != np.float64 or not block.flags.c_contiguous:
        raise ValueError("the argument block must be contiguous float64")

    fn = _launcher()
    in_ptrs = (ctypes.c_void_p * N_IN)(*[x.data_ptr() for x in ins])
    out_ptrs = (ctypes.c_void_p * N_OUT_SW)(*[o.data_ptr() for o in outs])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(1 if dtype == torch.float64 else 0, kx, int(compute_sw), il,
                 ix, ctypes.cast(in_ptrs, ctypes.c_void_p),
                 ctypes.cast(out_ptrs, ctypes.c_void_p),
                 block.ctypes.data_as(ctypes.c_void_p),
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"column_physics kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    launches_sw += int(compute_sw)
    return outs


def fused_grid_physics(cfg, pp, compute_sw, daily, surf, rad, pg):
    """Same arguments and return structure as the grid_physics_core call
    in get_physical_tendencies. CPU tensors take the plain chain; CUDA
    tensors the kernel."""
    ins = kernel_inputs(cfg, pp, compute_sw, daily, surf, rad, pg)
    if pg.tg.device.type == "cpu":
        outs = plain_outputs(cfg, pp, compute_sw, ins)
    else:
        outs = launch_kernel(cfg, compute_sw, ins, pp.kernel_block)
    return _unflatten(outs, compute_sw)
