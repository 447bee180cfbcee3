"""Spectral transform core: spherical harmonics <-> Gaussian grid.

Layouts match the JAX package: spectral fields are packed real
``[..., mx, nx, 2]`` (zonal wavenumber m, n with total wavenumber l = m + n,
re/im), grid fields ``[..., il, ix]`` with latitude south -> north. The
Legendre transform and the zonal DFT are dense contractions against
precomputed tables (``torch.einsum``); the triangular truncation and the
hemispheric parity are folded into the tables.

Reference quirks kept for parity (legendre.f90, spectral.f90):

* the polynomials are evaluated at the asymptotic Gauss-node seeds while
  the weights use the Newton-iterated nodes, so the transform pair is not
  an exact quadrature (round-trip error ~4e-3 at T30);
* the meridional-coupling operators drop the i*m term on the last n row
  (spectral.f90:159-162, 185-188);
* ``uvdx`` on the n=0 row is -a/(m+1) even for m=0 (spectral.f90:68).

A band view (``band_spectral``, the 'sp' axis of parallel/mesh.py) holds
the rows of one latitude band of the grid-side tables and the group of
the ranks that hold the other bands: synthesis then writes the band's
rows, and each analysis sums the bands' partial contractions with one
all-reduce over that group.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import ModelConfig
from ..constants import REARTH, PI_F
from ..geometry import to_device
from ..utils import tracing


class SpectralConsts(NamedTuple):
    cpol_inv: torch.Tensor  # [mx, nx, il] synthesis table
    cpol_dir: torch.Tensor  # [mx, nx, il] analysis table (+ Gaussian weights)
    dft_syn: torch.Tensor   # [mx, 2, ix] zonal DFT synthesis matrix
    dft_ana: torch.Tensor   # [mx, 2, ix] zonal DFT analysis matrix
    el2: torch.Tensor       # [mx, nx] l(l+1)/a^2
    el4: torch.Tensor       # [mx, nx] el2^2
    elm2: torch.Tensor      # [mx, nx] 1/el2 (0 at l=0)
    trfilt: torch.Tensor    # [mx, nx] l <= trunc
    gradx: torch.Tensor     # [mx] m/a
    gradym: torch.Tensor    # [mx, nx]
    gradyp: torch.Tensor    # [mx, nx]
    uvdx: torch.Tensor      # [mx, nx]
    uvdym: torch.Tensor     # [mx, nx]
    uvdyp: torch.Tensor     # [mx, nx]
    vddym: torch.Tensor     # [mx, nx]
    vddyp: torch.Tensor     # [mx, nx]
    zrow_mask: torch.Tensor  # [nx] 1 on rows carrying the i*m term
    cosgr: torch.Tensor     # [il] 1/cos(lat)
    cosgr2: torch.Tensor    # [il] 1/cos^2(lat)
    wt: torch.Tensor        # [iy] Gaussian weights
    # a band view's process group, over which analyses sum (None: the
    # tables hold every row)
    group: Any = None


def cmul_i(x: torch.Tensor) -> torch.Tensor:
    """Multiply a packed-complex array by the imaginary unit i."""
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1)


# ---------------------------------------------------------------------------
# Host-side setup (float64 numpy)
# ---------------------------------------------------------------------------

def gauss_weights(iy: int) -> np.ndarray:
    """Gaussian weights of the 2*iy-point rule, pole -> equator, at the
    Newton-iterated nodes (legendre.f90:158-191)."""
    n = 2 * iy
    i = np.arange(1, iy + 1, dtype=np.float64)
    z = np.cos(PI_F * (i - 0.25) / (n + 0.5))
    eps = np.finfo(np.float64).eps
    for _ in range(100):
        p1 = np.ones_like(z)
        p2 = np.zeros_like(z)
        for jj in range(1, n + 1):
            p3 = p2
            p2 = p1
            p1 = ((2.0 * jj - 1.0) * z * p2 - (jj - 1.0) * p3) / jj
        pp = n * (z * p1 - p2) / (z**2 - 1.0)
        z_new = z - p1 / pp
        if np.all(np.abs(z_new - z) <= eps):
            z = z_new
            break
        z = z_new
    p1 = np.ones_like(z)
    p2 = np.zeros_like(z)
    for jj in range(1, n + 1):
        p3 = p2
        p2 = p1
        p1 = ((2.0 * jj - 1.0) * z * p2 - (jj - 1.0) * p3) / jj
    pp = n * (z * p1 - p2) / (z**2 - 1.0)
    return 2.0 / ((1.0 - z**2) * pp**2)


def epsilon_table(mx: int, nx: int) -> np.ndarray:
    """eps[m, n] = sqrt((l^2 - m^2)/(4 l^2 - 1)), l = m + n, [mx+1, nx+1];
    zero on the n = nx column and at (0, 0) (legendre.f90:43-57)."""
    m = np.arange(mx + 1, dtype=np.float64)[:, None]
    n = np.arange(nx + 1, dtype=np.float64)[None, :]
    ell = m + n
    with np.errstate(divide="ignore", invalid="ignore"):
        eps = np.sqrt((ell**2 - m**2) / (4.0 * ell**2 - 1.0))
    eps[np.isnan(eps)] = 0.0
    eps[:, nx] = 0.0
    eps[0, 0] = 0.0
    return eps


def legendre_polys(cfg: ModelConfig, sia_half: np.ndarray,
                   coa_half: np.ndarray, eps: np.ndarray) -> np.ndarray:
    """Normalized associated Legendre polynomials P[m, n, j] at the iy
    half-latitudes by the reference's recurrence with its 1e-30 flush
    (legendre.f90:194-237)."""
    mx, nx = cfg.mx, cfg.nx
    x = sia_half[None, :]
    y = coa_half[None, :]
    alp = np.zeros((mx + 1, nx, cfg.iy), dtype=np.float64)
    alp[0, 0] = np.sqrt(0.5)
    for m in range(1, mx + 1):
        consq = np.sqrt(0.5 * (2.0 * m + 1.0) / m)
        alp[m, 0] = consq * y[0] * alp[m - 1, 0]
    reps = np.where(eps > 0.0, 1.0 / np.where(eps > 0.0, eps, 1.0), 0.0)
    alp[:, 1] = x * alp[:, 0] * reps[: mx + 1, 1][:, None]
    for n in range(2, nx):
        alp[:, n] = (x * alp[:, n - 1]
                     - eps[: mx + 1, n - 1][:, None] * alp[:, n - 2]) \
            * reps[: mx + 1, n][:, None]
    alp[np.abs(alp) <= 1.0e-30] = 0.0
    return alp[:mx, :nx]


def dft_matrices(mx: int, ix: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real DFT synthesis/analysis matrices [mx, 2, ix] in FFTPACK's packing
    (fourier.f90:23-82); the m=0 imaginary rows are zero."""
    m = np.arange(mx, dtype=np.float64)[:, None]
    theta = 2.0 * np.pi * m * np.arange(ix, dtype=np.float64)[None, :] / ix
    cos, sin = np.cos(theta), np.sin(theta)
    w = np.where(m == 0, 1.0, 2.0)
    syn = np.stack([w * cos, -w * sin], axis=1)
    ana = np.stack([cos / ix, -sin / ix], axis=1)
    ana[0, 1, :] = 0.0
    return syn, ana


def build_spectral_np(cfg: ModelConfig, geom_np: dict) -> dict:
    """All spectral tables as float64 numpy arrays."""
    mx, nx, il, iy, trunc = cfg.mx, cfg.nx, cfg.il, cfg.iy, cfg.trunc

    wt = gauss_weights(iy)
    eps = epsilon_table(mx, nx)
    poly = legendre_polys(cfg, geom_np["sia_half"], geom_np["coa_half"], eps)
    dft_syn, dft_ana = dft_matrices(mx, cfg.ix)

    m0 = np.arange(mx, dtype=np.float64)[:, None]
    n0 = np.arange(nx, dtype=np.float64)[None, :]
    ell = m0 + n0

    # Eigenvalue tables (spectral.f90:41-57)
    el2 = ell * (ell + 1.0) / REARTH**2
    el4 = el2**2
    elm2 = np.zeros_like(el2)
    elm2[el2 > 0.0] = 1.0 / el2[el2 > 0.0]
    trfilt = (ell <= trunc).astype(np.float64)

    # Meridional-coupling coefficient tables (spectral.f90:61-81)
    epsm = eps[:mx, :nx]
    epsp = eps[:mx, 1: nx + 1]
    gradx = np.arange(mx, dtype=np.float64) / REARTH
    with np.errstate(divide="ignore", invalid="ignore"):
        gradym = np.where(n0 > 0, (ell - 1.0) * epsm / REARTH, 0.0)
        uvdx = np.where(n0 > 0, -REARTH * m0 / (ell * (ell + 1.0)),
                        -REARTH / (m0 + 1.0))
        uvdym = np.where(n0 > 0, -REARTH * epsm / np.where(ell > 0, ell, 1.0),
                         0.0)
        vddym = np.where(n0 > 0, (ell + 1.0) * epsm / REARTH, 0.0)
    gradyp = (ell + 2.0) * epsp / REARTH
    uvdyp = -REARTH * epsp / (ell + 1.0)
    vddyp = ell * epsp / REARTH

    zrow_mask = np.ones(nx, dtype=np.float64)
    zrow_mask[nx - 1] = 0.0

    # Full-latitude tables: half index j (0 = nearest the pole) maps to the
    # southern row j and the northern row il-1-j; southern rows take the
    # parity sign (-1)^n (legendre.f90:135-138).
    parity = np.where((np.arange(nx) % 2) == 0, 1.0, -1.0)[None, :]
    cpol_inv = np.zeros((mx, nx, il), dtype=np.float64)
    for j in range(iy):
        cpol_inv[:, :, j] = poly[:, :, j] * parity
        cpol_inv[:, :, il - 1 - j] = poly[:, :, j]

    # Triangular-shape masks (nsh2, legendre.f90:33-41, 142-154)
    if cfg.ix == 4 * iy:
        mask_inv = (m0 + n0 <= trunc + 1).astype(np.float64)
    else:
        mask_inv = np.ones((mx, nx), dtype=np.float64)
    mask_dir = mask_inv * (n0 <= trunc).astype(np.float64)

    wt_full = np.concatenate([wt, wt[::-1]])
    cpol_inv = cpol_inv * mask_inv[:, :, None]
    cpol_dir = cpol_inv * mask_dir[:, :, None] * wt_full[None, None, :]

    return dict(
        cpol_inv=cpol_inv, cpol_dir=cpol_dir, dft_syn=dft_syn, dft_ana=dft_ana,
        el2=el2, el4=el4, elm2=elm2,
        trfilt=trfilt, gradx=gradx, gradym=gradym, gradyp=gradyp, uvdx=uvdx,
        uvdym=uvdym, uvdyp=uvdyp, vddym=vddym, vddyp=vddyp,
        zrow_mask=zrow_mask, cosgr=geom_np["cosgr"], cosgr2=geom_np["cosgr2"],
        wt=wt,
    )


def build_spectral(cfg: ModelConfig, geom_np: dict, device) -> SpectralConsts:
    return SpectralConsts(**to_device(build_spectral_np(cfg, geom_np),
                                      cfg.rdtype, device))


def band_spectral(sc: SpectralConsts, rows: slice, group, device
                  ) -> SpectralConsts:
    """The band view of the full tables ``sc`` on ``device``: the latitude
    rows ``rows`` of cpol_inv, cpol_dir, cosgr and cosgr2 (copied, so
    that every band holds exactly the full tables' rows), the other
    tables as they are, and the process group ``group`` over which
    ``legendre_dir`` sums the bands (None: no collective)."""
    band = {"cpol_inv": sc.cpol_inv[..., rows],
            "cpol_dir": sc.cpol_dir[..., rows],
            "cosgr": sc.cosgr[rows], "cosgr2": sc.cosgr2[rows]}
    return SpectralConsts(**{
        f: band.get(f, getattr(sc, f)).contiguous().to(device)
        for f in SpectralConsts._fields if f != "group"}, group=group)


# ---------------------------------------------------------------------------
# Transforms (batched over any leading dims)
# ---------------------------------------------------------------------------

def legendre_inv(sc: SpectralConsts, spec: torch.Tensor) -> torch.Tensor:
    """[..., mx, nx, 2] -> [..., il, mx, 2] (legendre.f90:74-111)."""
    return torch.einsum("...mnr,mnj->...jmr", spec, sc.cpol_inv)


def legendre_dir(sc: SpectralConsts, fm: torch.Tensor) -> torch.Tensor:
    """[..., il, mx, 2] -> [..., mx, nx, 2] (legendre.f90:114-155); on a
    band view, the band's partial sum summed over ``sc.group``."""
    out = torch.einsum("...jmr,mnj->...mnr", fm, sc.cpol_dir)
    if sc.group is not None:
        out = sum_over(out, sc.group)
    return out


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the ranks of ``group`` (one all-reduce; every rank
    gets the same sum), made contiguous first. Under NCCL, or Gloo on CPU
    tensors, in place; Gloo with CUDA tensors (ranks that share a GPU,
    whose days run eagerly) stages the sum through a host copy, a marked
    synchronisation (models/captured.py ``host_sync``). Counted as
    ``spectral.allreduces`` (utils/tracing.py)."""
    tracing.count("spectral.allreduces")
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(group) != "nccl":
        from ..models.captured import host_sync
        with host_sync():
            host = x.cpu()
            dist.all_reduce(host, group=group)
            x.copy_(host)
    else:
        dist.all_reduce(x, group=group)
    return x


def fourier_inv(sc: SpectralConsts, fm: torch.Tensor) -> torch.Tensor:
    """[..., il, mx, 2] -> [..., il, ix] (fourier.f90:23-53)."""
    return torch.einsum("...jmr,mri->...ji", fm, sc.dft_syn)


def fourier_dir(sc: SpectralConsts, grid: torch.Tensor) -> torch.Tensor:
    """[..., il, ix] -> [..., il, mx, 2], 1/ix normalized
    (fourier.f90:56-82)."""
    return torch.einsum("...ji,mri->...jmr", grid, sc.dft_ana)


def spec_to_grid(sc: SpectralConsts, spec: torch.Tensor,
                 scale_by_inv_cos: bool = False) -> torch.Tensor:
    """Spherical harmonics -> grid (spectral.f90:98-110); with
    ``scale_by_inv_cos`` the result is divided by cos(lat) (kcos=2)."""
    grid = fourier_inv(sc, legendre_inv(sc, spec))
    if scale_by_inv_cos:
        grid = grid * sc.cosgr[:, None]
    return grid


def grid_to_spec(sc: SpectralConsts, grid: torch.Tensor) -> torch.Tensor:
    """Grid -> spherical harmonics (spectral.f90:112-122)."""
    return legendre_dir(sc, fourier_dir(sc, grid))


# ---- spectral-space operators ----

def _t(table: torch.Tensor) -> torch.Tensor:
    return table[..., None]


def _shift_down_n(x: torch.Tensor) -> torch.Tensor:
    """y[..., n, :] = x[..., n-1, :], zero at n=0."""
    return torch.cat([torch.zeros_like(x[..., :1, :]), x[..., :-1, :]], dim=-2)


def _shift_up_n(x: torch.Tensor) -> torch.Tensor:
    """y[..., n, :] = x[..., n+1, :], zero at n=nx-1."""
    return torch.cat([x[..., 1:, :], torch.zeros_like(x[..., :1, :])], dim=-2)


def laplacian(sc: SpectralConsts, spec: torch.Tensor) -> torch.Tensor:
    """del^2 (spectral.f90:84-89)."""
    return -spec * _t(sc.el2)


def inverse_laplacian(sc: SpectralConsts, spec: torch.Tensor) -> torch.Tensor:
    """del^-2 (spectral.f90:91-96)."""
    return -spec * _t(sc.elm2)


def grad(sc: SpectralConsts, psi: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zonal/meridional gradient operators (spectral.f90:124-144)."""
    psdx = cmul_i(psi) * sc.gradx[:, None, None]
    psdy = (-_t(sc.gradym) * _shift_down_n(psi)
            + _t(sc.gradyp) * _shift_up_n(psi))
    return psdx, psdy


def vds(sc: SpectralConsts, ucosm: torch.Tensor, vcosm: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u/cos, v/cos) spectral -> (vorticity, divergence)
    (spectral.f90:146-171)."""
    zmask = sc.zrow_mask[:, None]
    zp = cmul_i(ucosm) * sc.gradx[:, None, None]
    zc = cmul_i(vcosm) * sc.gradx[:, None, None]
    vorm = (_t(sc.vddym) * _shift_down_n(ucosm)
            - _t(sc.vddyp) * _shift_up_n(ucosm) + zc * zmask)
    divm = (-_t(sc.vddym) * _shift_down_n(vcosm)
            + _t(sc.vddyp) * _shift_up_n(vcosm) + zp * zmask)
    return vorm, divm


def uvspec(sc: SpectralConsts, vorm: torch.Tensor, divm: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vorticity, divergence) -> (U, V) = (u, v) cos(lat), spectral
    (spectral.f90:173-196)."""
    zmask = sc.zrow_mask[:, None]
    zp = cmul_i(vorm) * _t(sc.uvdx)
    zc = cmul_i(divm) * _t(sc.uvdx)
    ucosm = (_t(sc.uvdym) * _shift_down_n(vorm)
             - _t(sc.uvdyp) * _shift_up_n(vorm) + zc * zmask)
    vcosm = (-_t(sc.uvdym) * _shift_down_n(divm)
             + _t(sc.uvdyp) * _shift_up_n(divm) + zp * zmask)
    return ucosm, vcosm


def vdspec(sc: SpectralConsts, ug: torch.Tensor, vg: torch.Tensor,
           half_cos_scaling: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid (u, v)-like fields -> spectral (vorticity, divergence)-like
    tendencies (spectral.f90:198-227); ``half_cos_scaling`` is kcos=2."""
    scale = sc.cosgr if half_cos_scaling else sc.cosgr2
    uv = grid_to_spec(sc, torch.stack([ug * scale[:, None],
                                       vg * scale[:, None]], dim=0))
    return vds(sc, uv[0], uv[1])


def trunct(sc: SpectralConsts, spec: torch.Tensor) -> torch.Tensor:
    """Triangular truncation filter (spectral.f90:229-233)."""
    return spec * _t(sc.trfilt)
