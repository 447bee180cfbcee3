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

import torch

from . import spectral as sp

SOURCES = ("spectral_transforms.cu",)
SYN_TILE_J = 8          # latitudes per synthesis block (a multiple of 4)
ANA_TILE_M = 4          # zonal wavenumbers per analysis block
MAX_SMEM_BYTES = 48 * 1024  # static launch limit without an opt-in

launches_syn = 0
launches_ana = 0


def reset_launches() -> None:
    global launches_syn, launches_ana
    launches_syn = launches_ana = 0


def smem_bytes(direction: str, mx: int, il: int, itemsize: int) -> int:
    """Shared memory per block that the launch asks for: the tile of the
    intermediate, tile_j x mx x 2 (synthesis) or il x tile_m x 2
    (analysis) values."""
    if direction == "syn":
        return SYN_TILE_J * mx * 2 * itemsize
    if direction == "ana":
        return il * ANA_TILE_M * 2 * itemsize
    raise ValueError(f"direction {direction!r} is 'syn' or 'ana'")


_fns = {}


def _launcher(direction: str):
    """The C entry point for ``direction``, built and bound at first use."""
    if direction not in _fns:
        from ..utils import native
        lib = native.load("spectral_transforms", SOURCES)
        fn = getattr(lib, "spectral_synthesis_launch" if direction == "syn"
                     else "spectral_analysis_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5
        _fns[direction] = fn
    return _fns[direction]


def _check(name: str, x: torch.Tensor, shape, dtype, device) -> None:
    if x.device != device or x.dtype != dtype:
        raise ValueError(f"{name}: {x.dtype} on {x.device}, expected {dtype} "
                         f"on {device}")
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{name}: shape {tuple(x.shape)} (contiguous="
                         f"{x.is_contiguous()}), expected {tuple(shape)}")


def _launch(direction: str, x: torch.Tensor, tables, dims, out_shape):
    """Launch one direction's kernel on the CUDA tensor ``x`` [B, ...] with
    ``tables`` (two tensors, in the kernel's order) and ``dims`` (mx, nx,
    il, ix) into a new tensor of ``out_shape``, on the tensors' device and
    its current stream."""
    global launches_syn, launches_ana
    if x.device.type != "cuda":
        raise ValueError(f"the spectral-transform kernels need CUDA tensors, "
                         f"got {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {x.dtype}")
    mx, nx, il, ix = dims
    nbytes = smem_bytes(direction, mx, il, x.element_size())
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(f"{nbytes} bytes of shared memory per block exceed "
                         f"{MAX_SMEM_BYTES}")
    table_shapes = ([(mx, nx, il), (mx, 2, ix)] if direction == "syn"
                    else [(mx, 2, ix), (mx, nx, il)])
    _check("input", x, x.shape, x.dtype, x.device)
    for i, (t, s) in enumerate(zip(tables, table_shapes)):
        _check(f"table {i}", t, s, x.dtype, x.device)
    b = x.shape[0]
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    fn = _launcher(direction)
    tile = SYN_TILE_J if direction == "syn" else ANA_TILE_M
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(int(x.dtype == torch.float64), b, mx, nx, il, ix, tile,
                 x.data_ptr(), tables[0].data_ptr(), tables[1].data_ptr(),
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"spectral {direction} kernel launch failed: CUDA "
                           f"error {err}")
    if direction == "syn":
        launches_syn += 1
    else:
        launches_ana += 1
    return out


def launch_synthesis(sc: sp.SpectralConsts, spec: torch.Tensor
                     ) -> torch.Tensor:
    """The synthesis kernel on the CUDA tensor spec [B, mx, nx, 2]."""
    mx, nx, il = sc.cpol_inv.shape
    if spec.dim() != 4 or tuple(spec.shape[1:]) != (mx, nx, 2):
        raise ValueError(f"spec shape {tuple(spec.shape)}, expected "
                         f"[B, {mx}, {nx}, 2]")
    ix = sc.dft_syn.shape[-1]
    return _launch("syn", spec, (sc.cpol_inv, sc.dft_syn), (mx, nx, il, ix),
                   (spec.shape[0], il, ix))


def launch_analysis(sc: sp.SpectralConsts, grid: torch.Tensor
                    ) -> torch.Tensor:
    """The analysis kernel on the CUDA tensor grid [B, il, ix]."""
    mx, nx, il = sc.cpol_dir.shape
    ix = sc.dft_ana.shape[-1]
    if grid.dim() != 3 or tuple(grid.shape[1:]) != (il, ix):
        raise ValueError(f"grid shape {tuple(grid.shape)}, expected "
                         f"[B, {il}, {ix}]")
    return _launch("ana", grid, (sc.dft_ana, sc.cpol_dir), (mx, nx, il, ix),
                   (grid.shape[0], mx, nx, 2))


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
