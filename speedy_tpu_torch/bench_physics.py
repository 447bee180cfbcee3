"""The column-physics kernel against its plain PyTorch chain on the card.

    python -m speedy_tpu_torch.bench_physics [--orders vec,ref]

For each preset of K1_PRESETS (kx=8) and each type it builds the model on
the card from the stand-in boundary set, takes the physics inputs of the
booted state and the same inputs with seeded noise (the booted rest state
does not convect), and for the SW and the non-SW variant, in each LW order
(ORDERS: ``vec`` the band-vectorized sweeps, the default; ``ref`` the
reference-order ones of ``lw_band_vectorized=False``), prints one JSON
line: the worst field-normalised error of the kernel against the plain
chain of the same order over both input sets, whether every output is
finite, the kernel's time per call as a CUDA-graph replay of REPS calls
and over REPS eager calls, the plain chain's eager time, the least time
the card could take for the call (bound, the same bytes in both orders)
and the kernel's share of it; for ``ref``, also whether its outputs on the
perturbed inputs differ from the ``vec`` kernel's (``differs_from_vec``:
the two orders round differently, so equal outputs would mean the order
never reached the kernel). It first prints the graph-replay time
of one trivial launch (a one-element in-place add), the floor against which
a kernel of a few microseconds is read, and the card's name and power
limit. Then, for an ensemble's members as extra columns of one launch
(MEMBER_COUNTS members at T30, each type and variant), one line each: the
worst error against the plain chain on the same member-batched inputs,
whether each member's outputs equal a one-member launch on that member's
inputs, and the graph-replay time per call and per member beside the
bound. Needs a CUDA device and refuses to run without one.

The script reads only what every version of the kernel's wrapper has
(``fused.kernel_inputs``, ``launch_kernel``, ``plain_outputs``), so run as a
file with another checkout's package first on ``PYTHONPATH`` it times that
checkout's kernel; ``--orders vec`` keeps to the order every version has
(the default kernel against a parent's, in turns).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

import numpy as np
import torch

from speedy_tpu_torch.bench_transform import (
    HBM_BYTES_PER_S, PEAK_FLOPS, card_line, time_graph_ms, time_ms)

FP64_BOUND = 1e-12        # field-normalised, kernel vs plain, fp64
FP32_BOUND = 1e-4         # field-normalised, kernel vs plain, fp32
K1_PRESETS = ("t30", "t85", "t170")
PRECISIONS = ("fp64", "fp32")
ORDERS = ("vec", "ref")   # the LW orders: lw_band_vectorized True, False
MEMBER_COUNTS = (1, 8, 64)
REPS = 100
PLAIN_REPS = 20           # the plain chain is host-bound: fewer calls do
# kernel inputs that carry the member axis in an ensemble: the grid
# fields, albsfc, alb_s, stl_am, sst_am and the carried radiation (the
# rest, as daily_update and the model give them: alb_l, snowc, soilw_am,
# the orography, masks and date fields, shared by all members)
PER_MEMBER = (0, 1, 2, 3, 4, 5, 6, 8, 11, 12, 23, 24, 25, 26)
OUTPUT_NAMES = ["utend", "vtend", "ttend", "qtend", "precnv", "precls",
                "cbmf", "slrd", "slr", "olr", "ustr", "vstr", "shf", "evap",
                "slru", "hfluxn", "tsfc", "tskin", "u0", "v0", "t0", "tau2",
                "stratc", "tt_rsw", "ssrd", "ssr", "tsr"]


def error_bound(dtype) -> float:
    return FP64_BOUND if dtype == torch.float64 else FP32_BOUND


def physics_case(model, compute_sw):
    """Kernel inputs of the physics call at the booted state, and the
    model's argument block."""
    from speedy_tpu_torch.models import tendencies as tend
    from speedy_tpu_torch.models.geopotential import get_geopotential
    from speedy_tpu_torch.models.physics import fused
    from speedy_tpu_torch.utils import calendar as cal
    start = cal.Datetime(1982, 1, 1)
    state = model.initialize(start)
    daily = model.daily_forcing(state, start, start)
    mc, cfg = model.mc, model.cfg
    phi0 = get_geopotential(mc.dyn.gc, state.prog.t[0], mc.dyn.phis)
    pg = tend.grid_dynamics_tendencies(cfg, mc.dyn, mc.ic_2dt, state.prog,
                                       1, phi0)[1]
    ins = fused.kernel_inputs(cfg, model.pp, compute_sw, daily, state.surf,
                              state.rad, pg)
    return ins, model.pp.kernel_block


def perturb(ins, seed=0):
    """The same inputs with seeded noise on the winds and temperature and
    extra moisture, so that convection and clouds are active (the booted
    rest state does not convect)."""
    rng = np.random.default_rng(seed)
    shape = tuple(ins[2].shape)
    dev = lambda a: torch.as_tensor(a, dtype=ins[2].dtype,
                                    device=ins[2].device)
    out = list(ins)
    # the winds are drawn at every level, as the model's fields would be,
    # and enter at the lowest
    out[0] = ins[0] + dev(rng.normal(0.0, 5.0, shape)[-1])
    out[1] = ins[1] + dev(rng.normal(0.0, 5.0, shape)[-1])
    out[2] = ins[2] + dev(rng.normal(0.0, 1.5, shape))
    out[3] = ins[3] * dev(1.0 + rng.uniform(0.0, 0.6, shape))
    return out


def member_inputs(ins, members):
    """Kernel inputs of ``members`` members from one model's (physics_case),
    laid out as an ensemble's step gives them: the winds, temperature and
    humidity perturbed by each member's own seed (tg and qg as slices of
    wider buffers, as the model's merged synthesis leaves them), the other
    per-member fields (PER_MEMBER) copied to each member, soilw_am
    expanded over the members (member stride 0, as the step's expanded
    surface fields are), the shared ones as they are."""
    per = [perturb(ins, seed=m) for m in range(members)]
    out = list(ins)
    for i in (0, 1, 2, 3):
        x = torch.stack([p[i] for p in per])
        if i in (2, 3):
            wide = torch.zeros((members, x.shape[1] + 2) + x.shape[2:],
                               dtype=x.dtype, device=x.device)
            wide[:, 1:-1] = x
            x = wide[:, 1:-1]
        out[i] = x
    every = lambda x: x.expand((members,) + tuple(x.shape))
    for i in PER_MEMBER[4:]:
        if i < len(ins):
            out[i] = every(ins[i]).contiguous()
    out[10] = every(ins[10])
    return out


def unique_bytes(x: torch.Tensor) -> int:
    """Bytes of the distinct elements of x: a dimension of stride 0 (an
    input all members share) counts once."""
    return math.prod(n for n, st in zip(x.shape, x.stride()) if st != 0) \
        * x.element_size()


def field_errors(kernel_outs, plain_outs):
    """Per output: (max |k - p| / max |p|, max |k - p|)."""
    errs = []
    for k, p in zip(kernel_outs, plain_outs):
        k, p = k.double(), p.double()
        diff = (k - p).abs().max().item()
        scale = p.abs().max().item()
        errs.append((diff / scale if scale > 0 else diff, diff))
    return errs


def worst_columns(kernel_outs, plain_outs, bound, il, ix):
    """Columns (lat, lon) where some output's error exceeds bound x the
    output's scale, with the worst field-normalised error there and the
    output it is in."""
    bad = {}
    for name, k, p in zip(OUTPUT_NAMES, kernel_outs, plain_outs):
        scale = p.double().abs().max().item() or 1.0
        e = ((k.double() - p.double()).abs() / scale).reshape(-1, il * ix)
        e = e.amax(dim=0)
        for c in torch.nonzero(e > bound).flatten().tolist():
            if e[c].item() > bad.get(c, (0.0, ""))[0]:
                bad[c] = (e[c].item(), name)
    return sorted(((v, name, divmod(c, ix)) for c, (v, name) in bad.items()),
                  reverse=True)[:10]


def bound_ms(ins, outs, dtype, kx, ncol):
    """Least time for the call: bytes (inputs read once, outputs written
    once; the winds are passed at the lowest level only, the one the chain
    reads; an input all members share counts once) over HBM bandwidth vs
    operations over the peak rate. Operations are a lower estimate of 100
    per level per column; ``ncol`` counts every member's columns."""
    nbytes = sum(unique_bytes(x) for x in ins + outs)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 100.0 * kx * ncol / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def floor_ms(reps: int) -> float:
    """Graph-replay time per call of a one-element in-place add."""
    x = torch.zeros(1, device="cuda")
    return time_graph_ms(lambda: x.add_(1.0), reps)


def with_order(cfg, order: str):
    """``cfg`` in LW order ``order`` (ORDERS)."""
    return dataclasses.replace(cfg, lw_band_vectorized=(order == "vec"))


def check_case(model, compute_sw, cfg=None):
    """The kernel against the plain chain on the booted and the perturbed
    inputs, both in the LW order of ``cfg`` (default: the model's).
    Returns (perturbed inputs, argument block, rows): one row per input set
    with the worst field-normalised error, the largest absolute error, the
    per-output errors, whether every output is finite and the number of
    convecting columns."""
    from speedy_tpu_torch.models.physics import fused
    cfg = cfg or model.cfg
    booted, block = physics_case(model, compute_sw)
    rows = []
    for case, ins in (("booted", booted), ("perturbed", perturb(booted))):
        kout = fused.launch_kernel(cfg, compute_sw, ins, block)
        pout = fused.plain_outputs(cfg, model.pp, compute_sw, ins)
        torch.cuda.synchronize()
        errs = field_errors(kout, pout)
        bound = error_bound(cfg.rdtype)
        over = {n: e[0] for n, e in zip(OUTPUT_NAMES, errs) if e[0] > bound}
        rows.append(dict(over=over, columns=worst_columns(
            kout, pout, bound, cfg.il, cfg.ix) if over else [],
            case=case, worst=max(e[0] for e in errs),
            max_abs_err=max(e[1] for e in errs), errors=errs,
            finite=all(bool(torch.isfinite(k).all()) for k in kout),
            convecting=int((pout[6] > 0).sum())))
    return ins, block, rows


def time_case(model, compute_sw, ins, block, reps, cfg=None):
    """(graph ms, eager ms, plain ms, bound ms, bound by) of one call in
    the LW order of ``cfg`` (default: the model's)."""
    from speedy_tpu_torch.models.physics import fused
    cfg = cfg or model.cfg
    call = lambda: fused.launch_kernel(cfg, compute_sw, ins, block)
    ms = time_graph_ms(call, reps)
    eager_ms = time_ms(call, reps)
    plain_ms = time_ms(
        lambda: fused.plain_outputs(cfg, model.pp, compute_sw, ins),
        min(reps, PLAIN_REPS))
    members = fused.members_of(ins) or 1
    b_ms, b_by = bound_ms(ins, call(), cfg.rdtype, cfg.kx,
                          members * cfg.il * cfg.ix)
    return ms, eager_ms, plain_ms, b_ms, b_by


def run(orders=ORDERS):
    """One record per (preset, precision, variant, LW order) of K1_PRESETS x
    PRECISIONS x (SW, non-SW) x ``orders``, with the check of each input
    set (``checks``, check_case's rows)."""
    from speedy_tpu_torch.config import from_preset
    from speedy_tpu_torch.models.model import Model
    from speedy_tpu_torch.models.physics import fused
    from speedy_tpu_torch.utils.synthetic_bc import synthetic_boundaries
    bc = synthetic_boundaries(0)
    records = []
    for preset in K1_PRESETS:
        for prec in PRECISIONS:
            model = Model(from_preset(preset, precision=prec),
                          device="cuda", bc_arrays=bc)
            for sw, order in ((sw, o) for sw in (True, False)
                              for o in orders):
                cfg = with_order(model.cfg, order)
                ins, block, rows = check_case(model, sw, cfg)
                ms, eager_ms, plain_ms, b_ms, b_by = time_case(
                    model, sw, ins, block, REPS, cfg)
                differs = None
                if order != "vec":
                    vec = fused.launch_kernel(with_order(cfg, "vec"), sw,
                                              ins, block)
                    mine = fused.launch_kernel(cfg, sw, ins, block)
                    differs = any(not torch.equal(a, b)
                                  for a, b in zip(mine, vec))
                records.append(dict(
                    preset=preset, precision=prec, kx=model.cfg.kx,
                    variant="sw" if sw else "nosw", order=order,
                    differs_from_vec=differs,
                    worst=max(r["worst"] for r in rows),
                    bound=error_bound(model.cfg.rdtype),
                    max_abs_err=max(r["max_abs_err"] for r in rows),
                    finite=all(r["finite"] for r in rows),
                    convecting=rows[1]["convecting"],
                    over={r["case"]: r["over"] for r in rows if r["over"]},
                    columns={r["case"]: r["columns"] for r in rows
                             if r["columns"]},
                    kernel_graph_us=ms * 1e3, kernel_eager_us=eager_ms * 1e3,
                    plain_us=plain_ms * 1e3, bound_us=b_ms * 1e3,
                    bound_by=b_by, share=b_ms / ms, checks=rows))
    return records


def check_members(model, compute_sw, members, cfg=None):
    """The kernel over ``members`` members (member_inputs of the perturbed
    inputs) against the plain chain on the same inputs, and each member's
    outputs against a one-member launch on that member's inputs (equal:
    each column runs the same code), in the LW order of ``cfg`` (default:
    the model's). Returns (inputs, block, record)."""
    from speedy_tpu_torch.models.physics import fused
    cfg = cfg or model.cfg
    booted, block = physics_case(model, compute_sw)
    ins = member_inputs(booted, members)
    kout = fused.launch_kernel(cfg, compute_sw, ins, block)
    pout = fused.plain_outputs(cfg, model.pp, compute_sw, ins)
    shapes = fused.input_shapes(cfg.kx, cfg.il, cfg.ix, compute_sw)
    same = True
    for m in range(members):
        one = fused.launch_kernel(
            cfg, compute_sw, [x[m] if x.dim() > len(s) else x
                              for x, s in zip(ins, shapes)], block)
        same &= all(torch.equal(k[m], o) for k, o in zip(kout, one))
    torch.cuda.synchronize()
    errs = field_errors(kout, pout)
    return ins, block, dict(
        worst=max(e[0] for e in errs), max_abs_err=max(e[1] for e in errs),
        finite=all(bool(torch.isfinite(k).all()) for k in kout),
        shapes_ok=all(tuple(k.shape) == (members,) + tuple(o.shape[1:])
                      for k, o in zip(kout, pout)),
        members_equal_single=same)


def run_members(preset="t30"):
    """One record per (members, precision, variant) of MEMBER_COUNTS x
    PRECISIONS x (SW, non-SW) at ``preset``: the member-batched check
    (check_members) and the times."""
    from speedy_tpu_torch.config import from_preset
    from speedy_tpu_torch.models.model import Model
    from speedy_tpu_torch.utils.synthetic_bc import synthetic_boundaries
    bc = synthetic_boundaries(0)
    records = []
    for prec in PRECISIONS:
        model = Model(from_preset(preset, precision=prec), device="cuda",
                      bc_arrays=bc)
        for members in MEMBER_COUNTS:
            for sw in (True, False):
                ins, block, rec = check_members(model, sw, members)
                ms, eager_ms, plain_ms, b_ms, b_by = time_case(
                    model, sw, ins, block, REPS)
                rec.update(
                    preset=preset, precision=prec, members=members,
                    variant="sw" if sw else "nosw",
                    bound=error_bound(model.cfg.rdtype),
                    kernel_graph_us=ms * 1e3, kernel_eager_us=eager_ms * 1e3,
                    us_per_member=ms * 1e3 / members,
                    plain_us=plain_ms * 1e3, bound_us=b_ms * 1e3,
                    bound_by=b_by, share=b_ms / ms)
                records.append(rec)
    return records


def passed(rec) -> bool:
    """Within the bound and finite; members equal to one-member launches;
    a reference-order launch in fp32 differs from the default order's."""
    return (rec["worst"] <= rec["bound"] and rec["finite"]
            and rec.get("members_equal_single", True)
            and rec.get("shapes_ok", True)
            and not (rec.get("order") == "ref" and rec["precision"] == "fp32"
                     and not rec["differs_from_vec"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--orders", default=",".join(ORDERS),
                    help="LW orders to run, of " + ", ".join(ORDERS))
    orders = ap.parse_args(argv).orders.split(",")
    if not set(orders) <= set(ORDERS):
        ap.error(f"orders must be of {ORDERS}")
    if not torch.cuda.is_available():
        print("bench_physics: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from speedy_tpu_torch.utils import native
    print(json.dumps(dict(card=card_line(),
                          trivial_graph_us=floor_ms(REPS) * 1e3)))
    ok = True
    for rec in run(orders) + run_members():
        ok &= passed(rec)
        print(json.dumps({k: v for k, v in rec.items() if k != "checks"}))
    # the kernel was built at its first launch
    for line in native.build_log.get("column_physics", "").splitlines():
        if "Compiling" in line or "spill" in line or "registers" in line:
            print("ptxas:", line.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
