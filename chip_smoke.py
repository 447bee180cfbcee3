"""Smoke run of speedy_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line or more; any failure exits non-zero):
 1. the card's name and power limit (nvidia-smi); TF32 off;
 2. build the CUDA kernels from the sources in this checkout;
 3. the column-physics kernel against its plain PyTorch chain on the card,
    on the physics inputs of the booted T30 state and on the same inputs
    with seeded noise (the rest state does not convect), SW and non-SW
    variants, fp64 and fp32, then its time against the plain chain's and
    the bound;
 4. boot + 6 steps in fp64 on the CPU (plain physics) and on CUDA (kernel):
    every prognostic field must agree;
 5. the main path: Model(t30(), device="cuda") in fp32, initialize +
    run_fast for 2 days with the stability guard, counting kernel launches.
The last two lines are the kernel table and the result line. Runs on the
stand-in boundary set (speedy_tpu_torch/utils/synthetic_bc.py).
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

FP64_BOUND = 1e-12        # field-normalised, kernel vs plain, fp64
FP32_BOUND = 1e-4         # field-normalised, kernel vs plain, fp32
STEP_BOUND = 1e-10        # relative, CPU vs CUDA prognostics after 6 steps
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}  # non-tensor-core
N_TIMED = 100
OUTPUT_NAMES = ["utend", "vtend", "ttend", "qtend", "precnv", "precls",
                "cbmf", "slrd", "slr", "olr", "ustr", "vstr", "shf", "evap",
                "slru", "hfluxn", "tsfc", "tskin", "u0", "v0", "t0", "tau2",
                "stratc", "tt_rsw", "ssrd", "ssr", "tsr"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str):
    """One line per kernel instantiation from nvcc -Xptxas -v output."""
    lines, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*column_physics_kernelI"
                      r"([fd])Li(\d)ELb([01])E", line)
        if m:
            name = (f"{'fp32' if m.group(1) == 'f' else 'fp64'} kx={m.group(2)}"
                    f" {'sw' if m.group(3) == '1' else 'nosw'}")
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line)
            lines.append(f"{name}: {regs.group(1) if regs else '?'} "
                         f"registers, {spill}")
            name = None
    return lines


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
    output's scale, with the worst field-normalised error there."""
    bad = {}
    for i, (k, p) in enumerate(zip(kernel_outs, plain_outs)):
        scale = p.double().abs().max().item() or 1.0
        e = ((k.double() - p.double()).abs() / scale).reshape(-1, il * ix)
        e = e.amax(dim=0)
        for c in torch.nonzero(e > bound).flatten().tolist():
            bad[c] = max(bad.get(c, 0.0), e[c].item())
    return sorted(((v, divmod(c, ix), ) for c, v in bad.items()),
                  reverse=True)[:10]


def physics_case(model, compute_sw):
    """Kernel inputs of the physics call at the booted state."""
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


def bound_ms(ins, outs, dtype, kx, ncol):
    """Least time for the call: bytes (inputs read once, outputs written
    once; the winds are passed at the lowest level only, the one the chain
    reads) over HBM bandwidth vs operations over the peak rate. Operations
    are a lower estimate of 100 per level per column."""
    nbytes = sum(x.numel() * x.element_size() for x in ins + outs)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 100.0 * kx * ncol / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, n):
    """Device time per call of fn over n calls, CUDA events, after warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_graph_ms(fn, n):
    """Per-call time of fn captured n times in one CUDA graph, so the
    host-side argument handling of the wrapper is not in the timing."""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    card = card_line()
    print(f"[1] card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from speedy_tpu_torch.config import t30
    from speedy_tpu_torch.models.model import Model
    from speedy_tpu_torch.models.physics import fused
    from speedy_tpu_torch.utils import calendar as cal, native
    from speedy_tpu_torch.utils.synthetic_bc import synthetic_boundaries

    # [2] build
    t0 = time.perf_counter()
    native.load("column_physics", fused.SOURCES)
    print(f"[2] built column_physics in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {native.build_seconds.get('column_physics', 0.0):.1f} s)")
    for line in ptxas_summary(native.build_log.get("column_physics", "")):
        print("    ptxas:", line)

    bc = synthetic_boundaries(0)
    models = {p: Model(t30(precision=p), device="cuda", bc_arrays=bc)
              for p in ("fp64", "fp32")}

    # [3] kernel vs plain on the card
    rows = {}
    ok = True
    for prec, model in models.items():
        cfg = model.cfg
        dtype = cfg.rdtype
        bound = FP64_BOUND if prec == "fp64" else FP32_BOUND
        for sw in (True, False):
            variant = "sw" if sw else "nosw"
            booted, block = physics_case(model, sw)
            for case, ins in (("booted", booted), ("perturbed",
                                                   perturb(booted))):
                kout = fused.launch_kernel(cfg, sw, ins, block)
                pout = fused.plain_outputs(cfg, model.pp, sw, ins)
                torch.cuda.synchronize()
                errs = field_errors(kout, pout)
                worst = max(e[0] for e in errs)
                finite = all(bool(torch.isfinite(k).all()) for k in kout)
                per = " ".join(f"{n}={e[0]:.1e}"
                               for n, e in zip(OUTPUT_NAMES, errs))
                n_conv = int((pout[6] > 0).sum())
                print(f"[3] {prec} {variant} {case} ({n_conv} convecting "
                      f"columns): worst {worst:.3e} (bound {bound:.0e}) "
                      f"finite={finite} | {per}")
                if worst > bound or not finite:
                    ok = False
                    for v, (j, i) in worst_columns(kout, pout, bound,
                                                   cfg.il, cfg.ix):
                        print(f"    column lat={j} lon={i}: {v:.3e}")
            # timed on the perturbed (convecting) inputs
            ms = time_graph_ms(lambda: fused.launch_kernel(cfg, sw, ins,
                                                           block), N_TIMED)
            ms_eager = time_ms(lambda: fused.launch_kernel(cfg, sw, ins,
                                                           block), N_TIMED)
            plain_ms = time_ms(
                lambda: fused.plain_outputs(cfg, model.pp, sw, ins), N_TIMED)
            b_ms, b_by = bound_ms(ins, kout, dtype, cfg.kx, cfg.il * cfg.ix)
            print(f"[3] {prec} {variant}: kernel {ms:.4f} ms/call (graph), "
                  f"{ms_eager:.4f} ms/call (eager), plain {plain_ms:.4f} "
                  f"ms/call, bound {b_ms:.5f} ms ({b_by})")
            rows[(prec, variant)] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=max(e[1] for e in errs))
    if not ok:
        print("[3] FAILED: kernel disagrees with the plain chain")
        return 1

    # [4] CPU vs CUDA, boot + 6 steps, fp64
    start = cal.Datetime(1982, 1, 1)
    cpu = Model(t30(precision="fp64"), device="cpu", bc_arrays=bc)
    worst = {}
    states = {}
    for name, m in (("cpu", cpu), ("cuda", models["fp64"])):
        s = m.initialize(start)
        daily = m.daily_forcing(s, start, start)
        for i in range(6):
            s, _ = m.one_step(s, daily, i % m.cfg.nstrad == 0)
        states[name] = s.prog
    for f in states["cpu"]._fields:
        a = getattr(states["cpu"], f)
        b = getattr(states["cuda"], f).cpu()
        worst[f] = ((a - b).abs().max() / a.abs().max()).item()
    step_ok = max(worst.values()) <= STEP_BOUND
    print(f"[4] fp64 boot+6 steps CPU vs CUDA: "
          + " ".join(f"{k}={v:.2e}" for k, v in worst.items())
          + f" (bound {STEP_BOUND:.0e}) {'ok' if step_ok else 'FAILED'}")
    if not step_ok:
        return 1

    # [5] the main path: fp32 T30, initialize + 2 days with the guard
    model = Model(t30(), device="cuda", bc_arrays=bc)
    fused.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = model.initialize(start)
    t1 = time.perf_counter()
    state = model.run_fast(start, 2, state=state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n_launch, n_launch_sw = fused.launches, fused.launches_sw
    expect = 2 + 2 * model.cfg.nsteps
    finite = all(bool(torch.isfinite(x).all()) for x in state.prog)
    days_per_min = 2 / ((t2 - t1) / 60.0)
    print(f"[5] fp32 T30 2 days: {days_per_min:.1f} sim-days/min "
          f"(run_fast {t2 - t1:.3f} s, initialize {t1 - t0:.3f} s) on "
          f"{card}; kernel launches {n_launch} (sw {n_launch_sw}), "
          f"expected {expect}; finite={finite}")
    if n_launch != expect or not finite:
        print("[5] FAILED")
        return 1

    kernels = []
    for variant, launches in (("sw", n_launch_sw),
                              ("nosw", n_launch - n_launch_sw)):
        r = rows[("fp32", variant)]
        kernels.append(dict(
            name=f"column_physics_{variant}", route="cuda",
            source="speedy_tpu_torch/csrc/column_physics.cu",
            replaces="speedy_tpu/models/physics/fused.py:87",
            launches=launches, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
