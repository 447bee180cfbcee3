"""The spectral-transform kernels against the einsum chain on the card.

    python -m speedy_tpu_torch.bench_transform [--preset t30|t85|...]
        [--batches 25,34,48,57,256] [--reps 200] [--precision fp32|fp64]
        [--ana-tiles all|2x4,4x2,...] [--syn-tiles all|FBxTJ[xTI],...]

The counterpart of the JAX package's scripts/bench_pallas_transform.py. For
each batch B it times, in fp32 (or fp64), synthesis ([B, mx, nx, 2] ->
[B, il, ix]) and analysis (the reverse) on seeded random fields, through the
einsum chain of ops/spectral.py and through the kernels of
ops/fused_transforms.py, each with CUDA events over ``reps`` eager calls and
as one CUDA-graph replay of ``reps`` calls, and prints one JSON line per
batch with those
times (µs per call), the shared memory per block, the least time the card
could take (bound) and the card's name and power limit. The batches the
T30 step issues are 57/34 fields in synthesis and 48/25 in analysis. With
``--ana-tiles`` it also times the analysis kernel at each (FB fields, TM
wavenumbers) tile it is built for (``all``) or at those listed, with each
one's largest error against the einsum chain (``ana_tiles`` in the record);
``--syn-tiles`` does the same for the synthesis kernel's (FB fields, TJ
latitudes[, TI longitudes]) tiles, those built for the precision with
``all`` (``syn_tiles``), with the tile the
wrapper picks for the batch (``syn_pick``).
Needs a CUDA device and refuses to run without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# H100 SXM peaks: fp32 outside the tensor cores, fp64 on the tensor cores
# (DMMA, exact fp64 FMAs), the path cuBLAS's DGEMM takes
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def transform_cost(direction: str, sc, b: int):
    """(bytes, flops) of one call of ``direction`` ('syn' or 'ana') on B=b
    fields: the input and the output moved once and the nonzero entries of
    the two tables read once; one multiply-add (two operations) per nonzero
    table entry, per field and per real/imaginary part (Legendre) or per
    latitude (DFT). The triangular truncation's zero (m, n) pairs (465 of
    992 at T30) and the DFT's zero m=0 sine row are not counted."""
    leg, dft = ((sc.cpol_inv, sc.dft_syn) if direction == "syn"
                else (sc.cpol_dir, sc.dft_ana))
    mx, nx, il = leg.shape
    ix = dft.shape[-1]
    nnz_leg, nnz_dft = (int(torch.count_nonzero(t)) for t in (leg, dft))
    nbytes = (b * (mx * nx * 2 + il * ix) + nnz_leg + nnz_dft) \
        * leg.element_size()
    return nbytes, 2 * b * (2 * nnz_leg + il * nnz_dft)


def bound_ms(direction: str, sc, b: int):
    """Least time for one call on the H100: the larger of bytes over the
    memory rate and operations over the peak rate for the tables' type."""
    nbytes, flops = transform_cost(direction, sc, b)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[sc.cpol_inv.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, n: int) -> float:
    """Device time per call of fn over n eager calls, CUDA events, after
    warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_graph_ms(fn, n: int) -> float:
    """Per-call time of fn captured n times in one CUDA graph and replayed,
    so the host-side dispatch is not in the timing."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def run(preset: str, batches, reps: int, precision: str = "fp32",
        ana_tiles=(), syn_tiles=()):
    """Time both directions at each batch (and the analysis and synthesis
    kernels at each of ``ana_tiles`` and ``syn_tiles``); returns one record
    per batch."""
    from .config import from_preset
    from .geometry import build_geometry_np
    from .ops import fused_transforms as ft
    from .ops import spectral as sp

    cfg = from_preset(preset, precision=precision)
    dtype = cfg.rdtype
    sc = sp.build_spectral(cfg, build_geometry_np(cfg), "cuda")
    mx, nx, il, ix = cfg.mx, cfg.nx, cfg.il, cfg.ix
    card = card_line()
    rng = np.random.default_rng(0)
    records = []
    for b in batches:
        spec = torch.as_tensor(rng.standard_normal((b, mx, nx, 2)),
                               dtype=dtype, device="cuda")
        grid = torch.as_tensor(rng.standard_normal((b, il, ix)),
                               dtype=dtype, device="cuda")
        rec = {"preset": preset, "precision": precision, "batch": b}
        for d, x, chain, kernel in (
                ("syn", spec, sp.spec_to_grid, ft.fused_spec_to_grid),
                ("ana", grid, sp.grid_to_spec, ft.fused_grid_to_spec)):
            rec[f"{d}_einsum_us"] = time_ms(lambda: chain(sc, x), reps) * 1e3
            rec[f"{d}_einsum_graph_us"] = time_graph_ms(
                lambda: chain(sc, x), reps) * 1e3
            rec[f"{d}_kernel_us"] = time_ms(lambda: kernel(sc, x), reps) * 1e3
            rec[f"{d}_kernel_graph_us"] = time_graph_ms(
                lambda: kernel(sc, x), reps) * 1e3
            rec[f"{d}_smem_bytes"] = ft.smem_bytes(d, mx, nx, il, ix,
                                                   x.element_size(), b)
            b_ms, b_by = bound_ms(d, sc, b)
            rec[f"{d}_bound_us"] = b_ms * 1e3
            rec[f"{d}_bound_by"] = b_by
        ref = sp.grid_to_spec(sc, grid)
        for t in ana_tiles:
            out = ft.launch_analysis(sc, grid, tiles=t)
            plan = ft.analysis_plan(mx, nx, il, ix, grid.element_size(), t)
            rec.setdefault("ana_tiles", {})[f"{t[0]}x{t[1]}"] = dict(
                graph_us=time_graph_ms(
                    lambda: ft.launch_analysis(sc, grid, tiles=t), reps) * 1e3,
                error=((out - ref).abs().max() / ref.abs().max()).item(),
                jc=plan.jc, nc=plan.nc, smem_bytes=plan.smem)
        if syn_tiles:
            ref = sp.spec_to_grid(sc, spec)
            pick = ft.synthesis_plan(mx, nx, il, ix, spec.element_size(), b)
            rec["syn_pick"] = f"{pick.fb}x{pick.tj}x{pick.ti}"
        for t in syn_tiles:
            out = ft.launch_synthesis(sc, spec, tiles=t)
            plan = ft.synthesis_plan(mx, nx, il, ix, spec.element_size(), b,
                                     t)
            rec.setdefault("syn_tiles", {})["x".join(map(str, t))] = dict(
                graph_us=time_graph_ms(
                    lambda: ft.launch_synthesis(sc, spec, tiles=t), reps)
                * 1e3,
                error=((out - ref).abs().max() / ref.abs().max()).item(),
                ti=plan.ti, mc=plan.mc, smem_bytes=plan.smem)
        rec["card"] = card
        records.append(rec)
        print(json.dumps(rec), flush=True)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="t30",
                    choices=["t30", "t42", "t63", "t85", "t170"])
    ap.add_argument("--batches", default="25,34,48,57,256")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--precision", default="fp32", choices=["fp32", "fp64"])
    ap.add_argument("--ana-tiles", default="",
                    help="'all' or FBxTM,... (e.g. 2x4,4x2)")
    ap.add_argument("--syn-tiles", default="",
                    help="'all' or FBxTJ[xTI],... (e.g. 1x8,4x16x128)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_transform: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from .ops.fused_transforms import ANA_BUILT_TILES, SYN_BUILT_TILES

    def tiles(arg, built):
        return built if arg == "all" else [
            tuple(int(v) for v in t.split("x")) for t in arg.split(",") if t]

    run(args.preset, [int(x) for x in args.batches.split(",")], args.reps,
        args.precision, tiles(args.ana_tiles, ANA_BUILT_TILES),
        tiles(args.syn_tiles,
              SYN_BUILT_TILES[8 if args.precision == "fp64" else 4]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
