"""Operations and bytes of the step's work, counted from the
configuration's shapes alone, so that they count the same work whatever
implements it.

Frozen from speedy_tpu_torch at commit 8f72ba0: ``transform_cost`` from
bench_transform.py (one multiply-add per nonzero table entry, per field and
per real/imaginary part for the Legendre sums, per latitude for the zonal
DFT), and the column-physics kernel's byte count (``unique_bytes`` over
``member_inputs`` in bench_physics.py: inputs read once and outputs written
once, an input all members share counted once) with its lower estimate of
100 operations per level per column (``bound_ms``). The tables are the
configuration's reference's own (its ``transform_tables``: for the default,
reference/ops/spectral.py), built from the configuration's shapes.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from .peaks import HBM_BYTES_PER_S, PEAK_FLOPS

K1_OPS_PER_LEVEL_COLUMN = 100.0


@lru_cache(maxsize=8)
def _nonzeros(package, trunc: int, ix: int, il: int, kx: int):
    """Nonzero entries of the synthesis and analysis tables (Legendre,
    DFT) of the spectral constants at this resolution, as the reference
    package ``package`` builds them (None: this benchmark's
    ``reference/``)."""
    if package is None:
        from . import reference as package
    tables = package.transform_tables(trunc, ix, il, kx)
    return {d: tuple(int(np.count_nonzero(a)) for a in tables[d])
            for d in ("syn", "ana")}


def transform_cost(direction: str, cfg, b: int, itemsize: int = 4):
    """(bytes, operations) of one ``direction`` ('syn' or 'ana') transform
    of ``b`` fields: input and output moved once, the tables' nonzero
    entries read once; two operations per multiply-add."""
    nnz_leg, nnz_dft = _nonzeros(cfg.get("reference"), cfg["trunc"],
                                 cfg["ix"], cfg["il"], cfg["kx"])[direction]
    mx, nx, il, ix = cfg["trunc"] + 1, cfg["trunc"] + 2, cfg["il"], cfg["ix"]
    nbytes = (b * (mx * nx * 2 + il * ix) + nnz_leg + nnz_dft) * itemsize
    return nbytes, 2 * b * (2 * nnz_leg + il * nnz_dft)


def step_batches(cfg, sppt: bool):
    """The fields one step synthesises and analyses (models/tendencies.py
    at commit 8f72ba0): synthesis of the merged plain stack (vor, div, t,
    the tracers, and the physics' t, q, phi, ps, with SPPT its pattern) and
    of the winds and the log-ps gradient; analysis of the u/v-type pairs
    (vdspec) and of the scalars."""
    kx, ntr = cfg["kx"], cfg.get("ntr", 1)
    syn = [(3 + ntr) * kx + 3 * kx + 1 + (kx if sppt else 0), 4 * kx + 2]
    ana = [2 * (2 + ntr) * kx, (2 + ntr) * kx + 1]
    return syn, ana


def step_operations(cfg, sppt: bool, members: int = 1) -> float:
    """Counted operations of one step of ``members`` models: the four
    transforms over nonzero table entries plus the column physics' lower
    estimate. A lower count: the dynamics' elementwise work, the implicit
    solve and the diffusion are not counted."""
    syn, ana = step_batches(cfg, sppt)
    ops = sum(transform_cost("syn", cfg, b)[1] for b in syn) \
        + sum(transform_cost("ana", cfg, b)[1] for b in ana)
    ops += K1_OPS_PER_LEVEL_COLUMN * cfg["kx"] * cfg["il"] * cfg["ix"]
    return float(ops * members)


def k1_bytes(cfg, compute_sw: bool, members: int = 1,
             itemsize: int = 4) -> int:
    """Bytes of one column-physics launch over ``members`` x il x ix
    columns: per-member inputs (the lowest-level winds, tg, qg, phig,
    pslg, albsfc, alb_s, stl_am, sst_am, and on non-SW steps tau2, stratc,
    tt_rsw, ssrd) read once a member, the shared ones (alb_l, snowc,
    soilw_am, forog, phis0, fmask_l, the six [il] fields and ablco2) once,
    every output written once a member."""
    kx, col, il = cfg["kx"], cfg["il"] * cfg["ix"], cfg["il"]
    per_member = (2 + 3 * kx + 5) * col
    if not compute_sw:
        per_member += (4 * kx + 2 + kx + 1) * col
    shared = 6 * col + 6 * il + 1
    outputs = (4 * kx + 28) * col
    if compute_sw:
        outputs += (5 * kx + 5) * col
    return (members * (per_member + outputs) + shared) * itemsize


def k1_least_s(cfg, compute_sw: bool, members: int = 1,
               precision: str = "fp32") -> float:
    """Least time of one launch on the H100: the larger of its bytes over
    the HBM rate and its counted operations over the peak rate."""
    itemsize = 8 if precision == "fp64" else 4
    t_bytes = k1_bytes(cfg, compute_sw, members, itemsize) / HBM_BYTES_PER_S
    t_ops = K1_OPS_PER_LEVEL_COLUMN * cfg["kx"] * cfg["il"] * cfg["ix"] \
        * members / PEAK_FLOPS[precision]
    return max(t_bytes, t_ops)
