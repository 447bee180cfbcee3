"""Spectral <-> grid transforms as one CUDA kernel per direction
(csrc/spectral_transforms.cu), with the Fourier-coefficient intermediate
held in shared memory.

This is the counterpart of the JAX package's Pallas module
``speedy_tpu/ops/pallas_transforms.py``: ``fused_spec_to_grid`` replaces
its ``fused_spec_to_grid`` (synthesis, ``[B, mx, nx, 2] -> [B, il, ix]``)
and ``fused_grid_to_spec`` its ``fused_grid_to_spec`` (analysis, the
reverse), with the same shapes and no ``scale_by_inv_cos``. Where the
Pallas kernels expand the Legendre tables into a dense block-diagonal
matrix (23.6 MB in fp32 at T30, ~1.3 GB at T85), these read the compact
``SpectralConsts`` tables ``cpol_inv``/``cpol_dir`` ``[mx, nx, il]`` and
``dft_syn``/``dft_ana`` ``[mx, 2, ix]``.

Both are two register-tiled GEMMs fused in one block, their operands
staged in shared memory in chunks, and both touch only the (m, n) pairs
the triangular truncation keeps (``truncation_extent``, derived once per
table). Synthesis takes FB fields x TJ latitudes x TI longitudes per
block and walks the zonal wavenumbers in chunks of mc (``SYN_TILES`` per
preset, type and batch; ``synthesis_plan``); it never reads the truncated
pairs of its input. Analysis takes FB fields x TM zonal wavenumbers
(``ANA_TILES`` per preset and type; ``analysis_plan``); the rest of its
output is zero.

On CPU tensors both functions run their plain twin, the einsum chain of
``ops/spectral.py`` (``spec_to_grid``/``grid_to_spec``); on CUDA tensors
they launch the kernel or raise. fp32 accumulates in fp32; fp64 in fp64
(the Pallas kernels' fp32 scratch is an artefact of a chip without fp64),
so the fp64 kernels agree with the einsum chain to rounding.
``launches_syn``/``launches_ana`` count kernel launches. The model step
keeps the einsum chain; ``speedy_tpu_torch.bench_transform`` runs these.
"""
from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple

import torch

from . import spectral as sp

SOURCES = ("spectral_transforms.cu",)
MAX_SMEM_BYTES = 232448  # 227 KB, the most an H100 block may opt in to
# two blocks fit one SM's 228 KB (1 KB reserved per block)
SMEM_TARGET = 115712
# as in the kernel source: threads per synthesis block
SYN_THREADS = 256
# zonal wavenumbers at most, as in the kernel source (both directions)
MAX_M = 256
# the (FB fields, TJ latitudes) per synthesis block the kernel is built
# for, by bytes per value: the tiles SYN_TILES picks
SYN_BUILT_TILES = {4: ((1, 8), (2, 8), (2, 16), (4, 16)),
                   8: ((2, 8), (2, 16))}
# the wrapper's pick, by mx (trunc + 1), bytes per value and batch: pairs
# (largest batch, tile), the first that holds the batch. The fastest tiles
# of `bench_transform --syn-tiles all` on the H100 at T30 (B=1-256) and
# T85 (B=25-256); T42 follows T30, T63 and T170 follow T85
_SYN_T30 = {4: ((8, (1, 8)), (40, (2, 8)), (128, (2, 16)), (None, (4, 16))),
            8: ((40, (2, 8)), (None, (2, 16)))}
_SYN_T85 = {4: ((30, (2, 8)), (64, (2, 16)), (None, (4, 16))),
            8: ((40, (2, 8)), (None, (2, 16)))}
SYN_TILES = {31: _SYN_T30, 43: _SYN_T30, 64: _SYN_T85, 86: _SYN_T85,
             171: _SYN_T85}
# as in the kernel source: threads per block, values of n per thread in
# stage 2
ANA_THREADS, ANA_RN = 256, 2
# the (FB fields, TM zonal wavenumbers) per block the kernel is built for
ANA_BUILT_TILES = ((1, 4), (2, 2), (2, 4), (4, 2), (4, 4), (1, 8), (2, 8),
                   (4, 8))
# the wrapper's pick, by mx (trunc + 1) and bytes per value: the fastest
# tiles of `bench_transform --ana-tiles all` on the H100 at T30 (the step's
# batches) and T85 (B=256); T42 follows T30, T63 and T170 follow T85
ANA_TILES = {
    31: {4: (2, 4), 8: (2, 4)},     # T30
    43: {4: (2, 4), 8: (2, 4)},     # T42
    64: {4: (2, 8), 8: (1, 8)},     # T63
    86: {4: (2, 8), 8: (1, 8)},     # T85
    171: {4: (2, 8), 8: (1, 8)},    # T170
}
ANA_DEFAULT_TILES = (2, 4)

launches_syn = 0
launches_ana = 0


def reset_launches() -> None:
    global launches_syn, launches_ana
    launches_syn = launches_ana = 0


class AnaPlan(NamedTuple):
    fb: int      # fields per block
    tm: int      # zonal wavenumbers per block
    jc: int      # latitudes per grid chunk (stage 1)
    nc: int      # values of n per cpol_dir chunk (stage 2)
    early: bool  # cpol_dir staged with stage 1's first chunk (one chunk)
    smem: int    # bytes of shared memory per block


def ana_max_rows(tm: int) -> int:
    """Most rows (field, latitude) of a grid chunk: one per thread and
    latitude row it holds (4, or 2 at TM >= 8), as in the kernel."""
    return ANA_THREADS * (2 if tm >= 8 else 4)


def _padded(n: int, vn: int) -> int:
    """Row stride in shared memory: an odd number of 16-byte vectors."""
    return n + vn if (n // vn) % 2 == 0 else n


def analysis_smem(fb: int, tm: int, il: int, ix: int, jc: int, nc: int,
                  early: bool, itemsize: int) -> int:
    """Shared memory of one analysis block, as the kernel lays it out: the
    intermediate fm [fb, 2 tm, il], stage 1's dft rows and grid chunk
    [2 tm + fb jc, ix] and stage 2's cpol_dir chunk [tm, nc, il] (or one
    set of its partial sums), rows padded; the two stages share their space
    unless ``early``."""
    vn = 16 // itemsize
    ilp, ixp = _padded(il, vn), _padded(ix, vn)
    items = tm * -(-nc // ANA_RN)
    stage1 = (2 * tm + fb * jc) * ixp
    stage2 = max(tm * nc * ilp, items * 2 * fb * ANA_RN)
    work = stage1 + stage2 if early else max(stage1, stage2)
    return itemsize * (fb * 2 * tm * ilp + work)


def analysis_plan(mx: int, nx: int, il: int, ix: int, itemsize: int,
                  tiles=None) -> AnaPlan:
    """The analysis launch: the tiles for the preset and type (or
    ``tiles``), the largest grid chunk (a divisor of il) and cpol_dir
    chunk that keep a block within SMEM_TARGET (two blocks per SM), or
    else within MAX_SMEM_BYTES; the whole cpol_dir slice staged early,
    beside stage 1's largest chunk, where that fits the target. Raises
    ValueError if nothing fits."""
    fb, tm = tiles or ANA_TILES.get(mx, {}).get(itemsize, ANA_DEFAULT_TILES)
    if (fb, tm) not in ANA_BUILT_TILES:
        raise ValueError(f"the analysis kernel is not built for FB={fb}, "
                         f"TM={tm} (built: {ANA_BUILT_TILES})")
    vn = 16 // itemsize
    if il % vn or ix % vn or ix < 2 * tm or mx > MAX_M:
        raise ValueError(f"mx={mx}, il={il}, ix={ix}: the analysis kernel "
                         f"needs rows of whole 16-byte vectors, ix >= "
                         f"{2 * tm} and mx <= {MAX_M}")
    jcs = [d for d in range(il, 0, -1)
           if il % d == 0 and fb * d <= ana_max_rows(tm)]
    ncs = range(min(nx, ANA_THREADS * ANA_RN // tm), 0, -1)
    for budget in (SMEM_TARGET, MAX_SMEM_BYTES):
        jc = next((d for d in jcs if analysis_smem(
            fb, tm, il, ix, d, 1, False, itemsize) <= budget), None)
        nc = next((n for n in ncs if analysis_smem(
            fb, tm, il, ix, 1, n, False, itemsize) <= budget), None)
        if jc and nc:
            early = (nc == nx and jc == jcs[0] and budget == SMEM_TARGET
                     and analysis_smem(fb, tm, il, ix, jc, nc, True,
                                       itemsize) <= budget)
            return AnaPlan(fb, tm, jc, nc, early, analysis_smem(
                fb, tm, il, ix, jc, nc, early, itemsize))
    raise ValueError(f"the analysis kernel does not fit {MAX_SMEM_BYTES} "
                     f"bytes of shared memory at il={il}, ix={ix}, "
                     f"{itemsize}-byte values, FB={fb}, TM={tm}")


class SynPlan(NamedTuple):
    fb: int      # fields per block
    tj: int      # latitudes per block
    ti: int      # longitudes per block (a divisor of ix)
    mc: int      # zonal wavenumbers per chunk
    smem: int    # bytes of shared memory per block


def syn_rj(r: int) -> int:
    """Output rows per thread in stage 2, of a block's r = FB * TJ rows."""
    return 8 if r > 32 else 4


def syn_tcn(r: int) -> int:
    """Threads that share a group of syn_rj(r) rows (a multiple of 32)."""
    return SYN_THREADS * syn_rj(r) // r


def syn_ri_max(itemsize: int, r: int) -> int:
    """Most longitudes per thread: 64 fp32 or 32 fp64 accumulators."""
    return (64 if itemsize == 4 else 32) // syn_rj(r)


def syn_ri(itemsize: int, r: int, ti: int) -> int:
    """Longitudes per thread for a block of ti longitudes: the fewest of
    1, 2, 3, 4, 8, 16 (the kernel's instantiations) that cover ti, or 0
    past syn_ri_max."""
    need = -(-ti // syn_tcn(r))
    ri = next((v for v in (1, 2, 3, 4, 8, 16) if v >= need), 0)
    return ri if ri <= syn_ri_max(itemsize, r) else 0


def _bank_stride(n: int, to: int, itemsize: int) -> int:
    """n rounded up to a count congruent to ``to`` modulo one cycle of the
    32 banks (128 bytes), so that rows read at one column fall in distinct
    banks."""
    return n + (to - n) % (128 // itemsize)


def synthesis_smem(fb: int, tj: int, ti: int, mc: int, nx: int,
                   itemsize: int) -> int:
    """Shared memory of one synthesis block, as the kernel lays it out: per
    zonal wavenumber of the chunk, the intermediate [2, FB TJ], the dft
    rows [2, ti padded to syn_ri longitudes per thread], the cpol_inv slice
    [nx, TJ] and the FB spectra [nx, FB, 2], the last two bank-spread."""
    r = fb * tj
    tip = syn_ri(itemsize, r, ti) * syn_tcn(r)
    cps = _bank_stride(nx * tj, tj, itemsize)
    sps = _bank_stride(2 * nx * fb, min(2 * fb, 16 // itemsize), itemsize)
    return itemsize * mc * (2 * r + 2 * tip + cps + sps)


def synthesis_tiles(mx: int, itemsize: int, batch: int):
    """The (FB, TJ) tile for the preset (T85's for another mx), type and
    batch."""
    picks = SYN_TILES.get(mx, _SYN_T85)[itemsize]
    return next(t for b, t in picks if b is None or batch <= b)


def synthesis_plan(mx: int, nx: int, il: int, ix: int, itemsize: int,
                   batch: int, tiles=None) -> SynPlan:
    """The synthesis launch: the tile for the preset, type and batch (or
    ``tiles``, (FB, TJ) or (FB, TJ, TI)); the widest TI (a divisor of ix)
    that the thread tile holds; the largest chunk of zonal wavenumbers that
    keeps a block within SMEM_TARGET (two blocks per SM), or else within
    MAX_SMEM_BYTES, evened out over the chunks. Raises ValueError if
    nothing fits."""
    fb, tj, *ti = tiles or synthesis_tiles(mx, itemsize, batch)
    if (fb, tj) not in SYN_BUILT_TILES[itemsize]:
        raise ValueError(f"the synthesis kernel is not built for FB={fb}, "
                         f"TJ={tj} in {itemsize}-byte values (built: "
                         f"{SYN_BUILT_TILES[itemsize]})")
    vn = 16 // itemsize
    if il % tj or ix % vn or mx > MAX_M:
        raise ValueError(f"mx={mx}, il={il}, ix={ix}: the synthesis kernel "
                         f"needs il a multiple of TJ={tj}, rows of whole "
                         f"16-byte vectors and mx <= {MAX_M}")
    r = fb * tj
    fits = [d for d in range(ix, 0, -1)
            if ix % d == 0 and d % vn == 0 and syn_ri(itemsize, r, d)]
    if ti:
        if ti[0] not in fits:
            raise ValueError(f"TI={ti[0]} is not a divisor of ix={ix} in "
                             f"whole 16-byte vectors that the thread tile "
                             f"holds ({fits})")
        fits = ti
    ti = fits[0]
    per_m = synthesis_smem(fb, tj, ti, 1, nx, itemsize)
    for budget in (SMEM_TARGET, MAX_SMEM_BYTES):
        mc = min(mx, budget // per_m)
        if mc:
            mc = -(-mx // -(-mx // mc))
            return SynPlan(fb, tj, ti, mc,
                           synthesis_smem(fb, tj, ti, mc, nx, itemsize))
    raise ValueError(f"the synthesis kernel does not fit {MAX_SMEM_BYTES} "
                     f"bytes of shared memory at nx={nx}, ix={ix}, "
                     f"{itemsize}-byte values, FB={fb}, TJ={tj}")


def smem_bytes(direction: str, mx: int, nx: int, il: int, ix: int,
               itemsize: int, batch: int) -> int:
    """Shared memory per block that the launch at ``batch`` fields asks
    for: the synthesis or analysis plan's."""
    if direction == "syn":
        return synthesis_plan(mx, nx, il, ix, itemsize, batch).smem
    if direction == "ana":
        return analysis_plan(mx, nx, il, ix, itemsize).smem
    raise ValueError(f"direction {direction!r} is 'syn' or 'ana'")


_extents = {}


def truncation_extent(table: torch.Tensor) -> torch.Tensor:
    """Per zonal wavenumber m, one past the last n whose row of a Legendre
    table [mx, nx, il] is nonzero (int32 [mx], on the CPU: the launch
    passes it by value). For cpol_inv it is min(nx, trunc + 2 - m): the
    synthesis kernel reads the spectra only below it. For cpol_dir it also
    drops n = trunc + 1 at m = 0: the analysis kernel computes the rows
    below it and writes zeros above. Computed once per table and kept
    while the table lives."""
    key = id(table)
    hit = _extents.get(key)
    if hit is None or hit[0]() is not table:
        nonzero = (table != 0).any(dim=-1)                    # [mx, nx]
        n1 = torch.arange(1, nonzero.shape[1] + 1, device=nonzero.device)
        extent = (nonzero * n1).amax(dim=-1).to(torch.int32).cpu()
        hit = _extents[key] = (weakref.ref(table), extent)
        weakref.finalize(table, _extents.pop, key, None)
    return hit[1]


_lib = None


def _library():
    """The transform library with its entry points bound, built at first
    use."""
    global _lib
    if _lib is None:
        from ..utils import native
        lib = native.load("spectral_transforms", SOURCES)
        lib.spectral_synthesis_launch.restype = ctypes.c_int
        lib.spectral_synthesis_launch.argtypes = (
            [ctypes.c_int] * 10 + [ctypes.c_void_p] * 6)
        lib.spectral_synthesis_smem_bytes.restype = ctypes.c_longlong
        lib.spectral_synthesis_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.spectral_analysis_launch.restype = ctypes.c_int
        lib.spectral_analysis_launch.argtypes = (
            [ctypes.c_int] * 11 + [ctypes.c_void_p] * 6)
        lib.spectral_analysis_smem_bytes.restype = ctypes.c_longlong
        lib.spectral_analysis_smem_bytes.argtypes = [ctypes.c_int] * 8
        _lib = lib
    return _lib


def _check(name: str, x: torch.Tensor, shape, dtype, device) -> None:
    if x.device != device or x.dtype != dtype:
        raise ValueError(f"{name}: {x.dtype} on {x.device}, expected {dtype} "
                         f"on {device}")
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{name}: shape {tuple(x.shape)} (contiguous="
                         f"{x.is_contiguous()}), expected {tuple(shape)}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: data not aligned to 16 bytes")


def _check_inputs(x: torch.Tensor, tables, table_shapes) -> None:
    """``x`` and its tables are contiguous CUDA tensors of one float type
    on one device, with the tables' shapes."""
    if x.device.type != "cuda":
        raise ValueError(f"the spectral-transform kernels need CUDA tensors, "
                         f"got {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {x.dtype}")
    _check("input", x, x.shape, x.dtype, x.device)
    for i, (t, s) in enumerate(zip(tables, table_shapes)):
        _check(f"table {i}", t, s, x.dtype, x.device)


def _raise_on(err: int, direction: str) -> None:
    if err != 0:
        raise RuntimeError(f"spectral {direction} kernel launch failed: CUDA "
                           f"error {err}")


def launch_synthesis(sc: sp.SpectralConsts, spec: torch.Tensor, tiles=None
                     ) -> torch.Tensor:
    """The synthesis kernel on the CUDA tensor spec [B, mx, nx, 2];
    ``tiles`` (FB, TJ) or (FB, TJ, TI) overrides the pick for the preset,
    type and batch (the benchmark's sweep)."""
    global launches_syn
    mx, nx, il = sc.cpol_inv.shape
    if spec.dim() != 4 or tuple(spec.shape[1:]) != (mx, nx, 2):
        raise ValueError(f"spec shape {tuple(spec.shape)}, expected "
                         f"[B, {mx}, {nx}, 2]")
    ix = sc.dft_syn.shape[-1]
    _check_inputs(spec, (sc.cpol_inv, sc.dft_syn), [(mx, nx, il), (mx, 2, ix)])
    b = spec.shape[0]
    plan = synthesis_plan(mx, nx, il, ix, spec.element_size(), b, tiles)
    out = torch.empty((b, il, ix), dtype=spec.dtype, device=spec.device)
    if b == 0:
        return out
    extent = truncation_extent(sc.cpol_inv)
    fn = _library().spectral_synthesis_launch
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        err = fn(int(spec.dtype == torch.float64), b, mx, nx, il, ix,
                 plan.fb, plan.tj, plan.ti, plan.mc, spec.data_ptr(),
                 sc.cpol_inv.data_ptr(), sc.dft_syn.data_ptr(),
                 extent.data_ptr(), out.data_ptr(), stream)
    _raise_on(err, "synthesis")
    launches_syn += 1
    return out


def launch_analysis(sc: sp.SpectralConsts, grid: torch.Tensor, tiles=None
                    ) -> torch.Tensor:
    """The analysis kernel on the CUDA tensor grid [B, il, ix]; ``tiles``
    (FB, TM) overrides the preset's pick (the benchmark's sweep)."""
    global launches_ana
    mx, nx, il = sc.cpol_dir.shape
    ix = sc.dft_ana.shape[-1]
    if grid.dim() != 3 or tuple(grid.shape[1:]) != (il, ix):
        raise ValueError(f"grid shape {tuple(grid.shape)}, expected "
                         f"[B, {il}, {ix}]")
    _check_inputs(grid, (sc.dft_ana, sc.cpol_dir), [(mx, 2, ix), (mx, nx, il)])
    plan = analysis_plan(mx, nx, il, ix, grid.element_size(), tiles)
    b = grid.shape[0]
    out = torch.empty((b, mx, nx, 2), dtype=grid.dtype, device=grid.device)
    if b == 0:
        return out
    extent = truncation_extent(sc.cpol_dir)
    fn = _library().spectral_analysis_launch
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream(grid.device).cuda_stream
        err = fn(int(grid.dtype == torch.float64), b, mx, nx, il, ix,
                 plan.fb, plan.tm, plan.jc, plan.nc, int(plan.early),
                 grid.data_ptr(),
                 sc.dft_ana.data_ptr(), sc.cpol_dir.data_ptr(),
                 extent.data_ptr(), out.data_ptr(), stream)
    _raise_on(err, "analysis")
    launches_ana += 1
    return out


def fused_spec_to_grid(sc: sp.SpectralConsts, spec: torch.Tensor
                       ) -> torch.Tensor:
    """[B, mx, nx, 2] -> [B, il, ix]: the einsum chain on CPU tensors, the
    synthesis kernel on CUDA tensors."""
    if spec.device.type == "cpu":
        return sp.spec_to_grid(sc, spec)
    return launch_synthesis(sc, spec)


def fused_grid_to_spec(sc: sp.SpectralConsts, grid: torch.Tensor
                       ) -> torch.Tensor:
    """[B, il, ix] -> [B, mx, nx, 2]: the einsum chain on CPU tensors, the
    analysis kernel on CUDA tensors."""
    if grid.device.type == "cpu":
        return sp.grid_to_spec(sc, grid)
    return launch_analysis(sc, grid)
