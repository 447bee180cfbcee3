"""The column-physics kernel: the whole grid-point physics chain as one
CUDA kernel (csrc/column_physics.cu), a block of COLS (lat, lon) columns x
LANES lanes: a team of lanes per column does the work local to a level
(one lane per level), one walker lane per column, 32 to a warp, the level
sweeps and column scalars in the plain chain's order, all staged through
shared memory (``block_plan``).

It replaces the JAX package's Pallas kernel
``speedy_tpu/models/physics/fused.py::fused_grid_physics``.
``fused_grid_physics`` below takes the same arguments and returns the same
structure as ``grid_physics_core``. On CPU tensors it runs that plain
chain; on CUDA tensors it launches the kernel or raises. The kernel is
built in both LW orders of the chain (``cfg.lw_band_vectorized``: the
band-vectorized sweeps, or with False the reference-order ones), and the
plain twin follows the same config. ``launches`` counts kernel launches
(``launches_sw`` those of the shortwave variant), ``launches_reflw`` and
``launches_reflw_sw`` those of the reference LW order among them.

An ensemble's inputs carry a leading member axis, and its members are
extra columns of the same launch: M x il x ix columns, a row of blocks
per member (the launch grid's second dimension). A per-member input is
read at its member stride (each member's slice contiguous, wherever it
lies); an input that all members share (the orography, masks, date
fields, or a view expanded over the members) is read at stride 0, not
copied M times. Every output is [M, ...] and contiguous.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ...constants import GRAV, P0, RGAS
from . import convection, condensation, shortwave
from . import vertical_diffusion as vdif_mod
from .surface import SurfaceFluxes

SOURCES = ("column_physics.cu",)
# each multiply and add rounded on its own, as in the plain chain's separate
# PyTorch operations: with contracted FMAs an fp32 threshold test can fall
# the other way in a column (one of T170's 131,072 on the perturbed inputs,
# its qtend off by 2.5% of the field's largest value)
NVCC_FLAGS = ("-fmad=false",)
N_IN_SW, N_IN = 23, 27      # kernel inputs on SW / non-SW steps
LAT_INPUTS = range(16, 23)  # the [il] fields and ablco2, always shared
N_OUT, N_OUT_SW = 21, 27    # kernel outputs on non-SW / SW steps
MAXL = 9                    # slots per level table in the argument block
N_TABLES, N_SCALARS = 15, 16
COLS, LANES = 32, 8         # a block: columns x lanes per column (kx <= 8)
THREADS = COLS * LANES

launches = 0
launches_sw = 0
launches_reflw = 0
launches_reflw_sw = 0
# the launch counters, read and restored together by a graph capture
COUNTERS = ("launches", "launches_sw", "launches_reflw", "launches_reflw_sw")


def reset_launches() -> None:
    global launches, launches_sw, launches_reflw, launches_reflw_sw
    launches = launches_sw = launches_reflw = launches_reflw_sw = 0


def _inner_contiguous(x: torch.Tensor, rank: int) -> bool:
    """Whether the last ``rank`` dimensions of x (a member's slice) are
    laid out contiguously."""
    if x.is_contiguous():
        return True
    want = 1
    for n, st in zip(reversed(x.shape[x.dim() - rank:]),
                     reversed(x.stride()[x.dim() - rank:])):
        if n > 1 and st != want:
            return False
        want *= n
    return True


def _rows_contiguous(x: torch.Tensor, rank: int) -> torch.Tensor:
    """x with its last ``rank`` dimensions contiguous, copied only where
    they are not."""
    return x if _inner_contiguous(x, rank) else x.contiguous()


def kernel_inputs(cfg, pp, compute_sw, daily, surf, rad, pg) -> list:
    """The kernel's inputs in its order: the lowest-level winds ug, vg as
    [..., il, ix] (the chain reads no other level of them), tg, qg, phig
    as [..., kx, il, ix], 11 x [..., il, ix], 6 x [il] (the [il, 1] fields
    and coa), ablco2 as [1]; on non-SW steps also tau2
    [..., 4, kx, il, ix], stratc [..., 2, il, ix], tt_rsw
    [..., kx, il, ix] and ssrd [..., il, ix]. The leading dimension, where
    a field has it, is an ensemble's member axis; each member's slice is
    contiguous."""
    ins = [pg.ug[..., -1, :, :], pg.vg[..., -1, :, :], pg.tg, pg.qg,
           pg.phig, pg.pslg, daily.albsfc, daily.alb_l, daily.alb_s,
           daily.snowc, daily.soilw_am, surf.stl_am, surf.sst_am,
           pp.forog, pp.phis0, pp.fmask_l,
           daily.fsol, daily.ozupp, daily.ozone, daily.zenit, daily.stratz,
           pp.coa, daily.ablco2]
    if not compute_sw:
        ins += [rad.tau2, rad.stratc, rad.tt_rsw, rad.ssrd]
    return [x.reshape(-1).contiguous() if i in LAT_INPUTS
            else _rows_contiguous(x, rank)
            for i, (x, rank) in enumerate(zip(ins, IN_RANKS))]


def output_shapes(kx: int, il: int, ix: int, compute_sw: bool,
                  members=None) -> list:
    """One model's output shapes, each led by ``members`` where given."""
    shapes = ([(kx, il, ix)] * 4          # utend vtend ttend qtend
              + [(il, ix)] * 6            # precnv precls cbmf slrd slr olr
              + [(3, il, ix)] * 5         # ustr vstr shf evap slru
              + [(2, il, ix)]             # hfluxn
              + [(il, ix)] * 5)           # tsfc tskin u0 v0 t0
    if compute_sw:
        shapes += [(4, kx, il, ix), (2, il, ix), (kx, il, ix),
                   (il, ix), (il, ix), (il, ix)]  # tau2 stratc tt_rsw ssrd ssr tsr
    return shapes if members is None else [(members,) + s for s in shapes]


def input_shapes(kx: int, il: int, ix: int, compute_sw: bool) -> list:
    """One model's input shapes (a member's, in an ensemble)."""
    shapes = ([(il, ix)] * 2 + [(kx, il, ix)] * 3 + [(il, ix)] * 11
              + [(il,)] * 6 + [(1,)])
    if not compute_sw:
        shapes += [(4, kx, il, ix), (2, il, ix), (kx, il, ix), (il, ix)]
    return shapes


IN_RANKS = tuple(len(s) for s in input_shapes(1, 1, 1, False))
NO_STRIDES = np.zeros(N_IN, np.int64)


class BlockPlan(NamedTuple):
    cols: int      # columns per block
    threads: int   # COLS x LANES
    blocks: int    # blocks in the launch
    smem: int      # dynamic shared memory per block, bytes


def block_plan(kx: int, il: int, ix: int, itemsize: int,
               compute_sw: bool, members: int = 1) -> BlockPlan:
    """The kernel's launch (``Layout`` in csrc/column_physics.cu) over
    ``members`` x il x ix columns, ``blocks`` counting every member's: one
    shared-memory row of COLS values plus 16 bytes per staged input row (a
    level of an [kx, il, ix] field, or an [il, ix] field), per output row
    and per work row (10 per level, 13 on SW steps; 8 per column; the 6
    [il] fields and ablco2 gathered at each column; one per level
    table)."""
    n_in = 13 + 3 * kx if compute_sw else 16 + 8 * kx
    n_out = 9 * kx + 33 if compute_sw else 4 * kx + 28
    n_work = (13 if compute_sw else 10) * kx + 8 + 7 + N_TABLES
    return BlockPlan(COLS, THREADS, members * -(-il * ix // COLS),
                     (n_in + n_out + n_work) * (COLS * itemsize + 16))


def _unflatten(outs, compute_sw):
    sfc = SurfaceFluxes(*outs[10:21])
    base = tuple(outs[:10]) + (sfc,)
    return base + tuple(outs[21:]) if compute_sw else base


def members_of(ins: list):
    """The member count of kernel inputs (tg's leading axis), or None for
    one model's."""
    tg = ins[2]
    return tg.shape[0] if tg.dim() == 4 else None


def plain_outputs(cfg, pp, compute_sw: bool, ins: list) -> list:
    """The kernel's plain twin: grid_physics_core on the kernel's inputs
    (kernel_inputs order, with or without the member axis) in the LW order
    ``cfg`` picks, returning the flat list of outputs in the kernel's
    shapes. The lowest-level winds are broadcast over the levels: the
    chain reads only the lowest."""
    from . import grid_physics_core
    col = lambda x: x.reshape(cfg.il, 1)
    lev = lambda x: x.unsqueeze(-3).expand(
        *x.shape[:-2], cfg.kx, cfg.il, cfg.ix)
    a = ins
    outs = grid_physics_core(
        cfg, pp, compute_sw, lev(a[0]), lev(a[1]), a[2], a[3], a[4], a[5],
        col(a[16]), col(a[17]), col(a[18]), col(a[19]), col(a[20]), a[6],
        a[22].reshape(()), a[7], a[8], a[9], a[10], a[11], a[12],
        a[13], a[21], a[14], a[15],
        *((None,) * 4 if compute_sw else a[23:27]))
    outs = list(outs[:10]) + list(outs[10]) + list(outs[11:])
    shapes = output_shapes(cfg.kx, cfg.il, cfg.ix, compute_sw,
                           members_of(ins))
    return [x if x.shape == s else x.expand(s) for x, s in zip(outs, shapes)]


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


_lib = None


def library() -> ctypes.CDLL:
    """The kernel library, built and bound at first use."""
    global _lib
    if _lib is None:
        from ...utils import native
        lib = native.load("column_physics", SOURCES, NVCC_FLAGS)
        lib.column_physics_launch.restype = ctypes.c_int
        lib.column_physics_launch.argtypes = (
            [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5)
        lib.column_physics_layout.restype = ctypes.c_int
        lib.column_physics_layout.argtypes = (
            [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 4)
        _lib = lib
    return _lib


def _check(x: torch.Tensor, shape, dtype, device, i: int) -> None:
    if x.device != device or x.dtype != dtype:
        raise ValueError(f"input {i}: {x.dtype} on {x.device}, expected "
                         f"{dtype} on {device}")
    if x.numel() != math.prod(shape) or not x.is_contiguous():
        raise ValueError(f"input {i}: shape {tuple(x.shape)} (contiguous="
                         f"{x.is_contiguous()}), expected {shape}")


class _Signature(NamedTuple):
    """What a launch of one (kx, il, ix, type, variant, members, LW order)
    needs, built once: the inputs' shapes and sizes (a member's), the
    outputs' shapes, sizes and places in one buffer, and the LW order."""
    reflw: bool                # the reference-order LW sweeps
    in_shapes: list
    in_numels: tuple
    out_shapes: list
    out_numels: list
    out_views: list            # (shape, stride, offset) in the buffer
    out_offsets: np.ndarray    # bytes, uint64


_signatures = {}


def _signature(kx, il, ix, dtype, compute_sw, members=None,
               reflw=False) -> _Signature:
    key = (kx, il, ix, dtype, compute_sw, members, reflw)
    sig = _signatures.get(key)
    if sig is None:
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"unsupported dtype {dtype}")
        if kx not in (5, 7, 8):
            raise ValueError(f"kx={kx} is not built (5, 7, 8)")
        in_shapes = input_shapes(kx, il, ix, compute_sw)
        out_shapes = output_shapes(kx, il, ix, compute_sw, members)
        out_numels = [math.prod(s) for s in out_shapes]
        itemsize = torch.empty((), dtype=dtype).element_size()
        offsets = np.cumsum([0] + out_numels[:-1], dtype=np.uint64)
        views = [(s, torch.empty(s, device="meta").stride(), int(o))
                 for s, o in zip(out_shapes, offsets)]
        sig = _signatures[key] = _Signature(
            bool(reflw), in_shapes, tuple(math.prod(s) for s in in_shapes),
            out_shapes, out_numels, views, offsets * itemsize)
    return sig


def _member_stride(x: torch.Tensor, shape, numel: int, members: int, dtype,
                   device, i: int) -> int:
    """The element stride between members of input i: 0 where every member
    reads the same values. Raises on a wrong type, device or shape, or a
    member's slice that is not contiguous."""
    if x.dtype != dtype or x.device != device:
        _check(x, shape, dtype, device, i)
    if x.dim() == len(shape) + 1:
        if x.shape[0] != members or x[0].numel() != numel:
            raise ValueError(f"input {i}: shape {tuple(x.shape)}, expected "
                             f"{(members,) + tuple(shape)}")
        if not _inner_contiguous(x, len(shape)):
            raise ValueError(f"input {i}: a member's slice is not "
                             f"contiguous (strides {x.stride()})")
        return x.stride(0) if members > 1 else 0
    if x.numel() != numel or not x.is_contiguous():
        _check(x, shape, dtype, device, i)
    return 0


def launch_kernel(cfg, compute_sw: bool, ins: list, block: np.ndarray):
    """Launch the kernel on CUDA tensors ``ins`` (kernel_inputs order, one
    model's or an ensemble's) with the float64 argument block, in the LW
    order ``cfg.lw_band_vectorized`` picks, on the tensors' device and its
    current stream; returns the flat list of outputs, views of one buffer
    ([M, ...] each for M members). An output
    that outlives the step keeps the whole buffer alive: the radiation
    state a SW step carries (tau2, stratc, tt_rsw, ssrd) holds all of that
    step's outputs until the next SW step, 105 rows of il x ix values per
    member at kx=8 (110 MB at T170 in fp64)."""
    global launches, launches_sw, launches_reflw, launches_reflw_sw
    dtype, device = ins[2].dtype, ins[2].device
    if device.type != "cuda":
        raise ValueError(f"the column-physics kernel needs CUDA tensors, "
                         f"got {device}")
    members = members_of(ins)
    sig = _signature(cfg.kx, cfg.il, cfg.ix, dtype, compute_sw, members,
                     not cfg.lw_band_vectorized)
    if len(ins) != len(sig.in_shapes):
        raise ValueError(f"{len(ins)} inputs, expected {len(sig.in_shapes)}")
    if members is None:
        for i, (x, n) in enumerate(zip(ins, sig.in_numels)):
            if (x.dtype != dtype or x.device != device or x.numel() != n
                    or not x.is_contiguous()):
                _check(x, sig.in_shapes[i], dtype, device, i)
        strides = NO_STRIDES
    else:
        strides = np.array([_member_stride(x, s, n, members, dtype, device,
                                           i)
                            for i, (x, s, n) in enumerate(zip(
                                ins, sig.in_shapes, sig.in_numels))],
                           np.int64)
    if block.dtype != np.float64 or not block.flags.c_contiguous:
        raise ValueError("the argument block must be contiguous float64")

    buf = torch.empty(sum(sig.out_numels), dtype=dtype, device=device)
    outs = [torch.as_strided(buf, *v) for v in sig.out_views]
    in_ptrs = np.array([x.data_ptr() for x in ins], np.uint64)
    out_ptrs = sig.out_offsets + np.uint64(buf.data_ptr())
    fn = library().column_physics_launch
    with torch.cuda.device(device):
        err = fn(int(dtype == torch.float64), cfg.kx, int(compute_sw),
                 members or 1, int(sig.reflw), cfg.il, cfg.ix,
                 in_ptrs.ctypes.data, strides.ctypes.data,
                 out_ptrs.ctypes.data, block.ctypes.data,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"column_physics kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    launches_sw += int(compute_sw)
    launches_reflw += int(sig.reflw)
    launches_reflw_sw += int(sig.reflw and compute_sw)
    return outs


def fused_grid_physics(cfg, pp, compute_sw, daily, surf, rad, pg):
    """Same arguments and return structure as the grid_physics_core call
    in get_physical_tendencies, for one model or all members of an
    ensemble in one call. CPU tensors take the plain chain; CUDA tensors
    the kernel."""
    ins = kernel_inputs(cfg, pp, compute_sw, daily, surf, rad, pg)
    if pg.tg.device.type == "cpu":
        outs = plain_outputs(cfg, pp, compute_sw, ins)
    else:
        outs = launch_kernel(cfg, compute_sw, ins, pp.kernel_block)
    return _unflatten(outs, compute_sw)
