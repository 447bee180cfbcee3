"""Smoke run of speedy_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line or more; any failure exits non-zero):
 1. the card's name and power limit (nvidia-smi); TF32 off;
 2. build the CUDA kernels from the sources in this checkout, one nvcc
    process per source, all started together (the column-physics library
    holds 48 kernels: 2 types x 3 kx x SW/non-SW x one model/members x the
    2 LW orders);
 3. the column-physics kernel's registers and spills per instantiation
    (ptxas); the graph-replay time of one trivial launch (the floor a kernel
    of a few microseconds is read against); then the column-physics kernel
    against its plain PyTorch chain on the card, on the physics inputs of
    the booted state and on the same inputs with seeded noise (the rest
    state does not convect), SW and non-SW variants, in both LW orders
    (``vec``, the default, and ``ref``, lw_band_vectorized=False), fp64 and
    fp32, at T30, T85 and T170 (kx=8): the worst field-normalised error
    against its bound, whether the ``ref`` kernel's outputs differ from the
    ``vec`` kernel's (they must in fp32), then the kernel's time (graph
    replay and eager) against the plain chain's and the bound, and the
    kernel's share of the bound; then the ``ref`` kernel with 8 members at
    T30, each member bit-equal to a one-member launch;
 4. boot + 6 steps in fp64 on the CPU (plain physics) and on CUDA (kernel):
    every prognostic field must agree;
 5. the main path: Model(t30(), device="cuda") in fp32, the day captured
    as a CUDA graph (warm-up day and capture timed on their own), then
    initialize + run_fast for 2 days with the stability guard (each day one
    replay), counting kernel launches (2 in the boot, nsteps per replayed
    day, as the captured day adds its graph's K1 launches at each replay);
 6. the transform benchmark's path (speedy_tpu_torch.bench_transform at
    T30, fp32), counting kernel launches; then the spectral-transform
    kernels (synthesis, analysis), through their public wrappers, against
    their plain einsum chain on the card (TRANSFORM_CASES: every T30 batch
    of that path and the ragged batches 1 and 7, in fp64 and fp32; T85 at
    B=25, 48, 57 and 256 in fp32 and B=256 in fp64), with their times (the
    benchmark's for T30 fp32), the einsum chain's, the bound and the
    kernel's share of it, and the synthesis tile picked; the analysis
    kernel's output at the pairs the truncation drops must be exactly 0;
 7. SPPT: boot + 6 fp64 steps with SPPT on, CPU against CUDA, fed the same
    innovations from a numpy seed; then 2 fp32 days with SPPT on the card,
    captured first as in [5];
 8. the run path: Model.run over one day with the NetCDF writer, and a
    checkpoint at day 1 resumed to day 2 against a straight 2-day run
    (SPPT on); then Model.run without output over 2 days, timed (its day
    keeps every step's diagnostics and makes no gridded fields), and that
    day's replay and host copy in turns with the day that makes them;
 9. ensembles: (a) the column-physics kernel with an ensemble's members as
    extra columns (bench_physics.run_members: 1, 8 and 64 members at T30,
    fp64 and fp32, SW and non-SW) against its plain chain on the same
    inputs, each member's outputs equal to a one-member launch on its
    inputs, with the graph-replay time per call and per member, the bytes
    bound and the share of it; (b) a 2-member SPPT ensemble, boot + 6 fp64
    steps on the CPU and on CUDA with the same per-member innovations;
    (c) the ensemble path: fp32 T30 with SPPT on, Ensemble.initialize, the
    M-member day captured (timed on its own), then run_days over 2 days at
    8 and at 64 members with the stability guard per member (member-days/
    min, ms/step), every field finite, the members apart, and 2 x nsteps
    kernel launches whatever the member count;
10. the captured day: (a) a replayed day (under
    torch.cuda.set_sync_debug_mode("error"), after its capture) against the
    eager module-level run_day on a side stream from the same booted
    state, torch.equal in every state leaf: the fast variant in fp64 and
    fp32, SPPT off and on, one model and 8 members, and the output variant
    (Model.run's and run_days' with writers) in fp64 and fp32, SPPT on,
    one model and 8 members, with every step's diagnostics and gridded
    fields equal too; run_fast over 2 days, capture included, under the
    same mode (only the marked syncs: the capture and the guard once a
    chunk); (b) the K1 kernels in a profiler trace of one replayed T30
    day: nsteps, nsteps / nstrad of them SW; (c) bench_step.day_times: the
    eager day and the replayed day (run_fast / run_days of one day) in
    turns, bench_step.REPEATS times each, fp32 T30: sim-days/min of one
    model with SPPT off and on and member-days/min at 8 and 64 members
    (SPPT on), each as the median and range, with the replayed day's
    device time and busy share, the capture's time and its graph pool's
    size, and at 64 members the SPPT pre-draw's host and device time;
11. the configuration surface: (a) boot + 6 fp64 steps on the CPU and on
    CUDA with lw_band_vectorized=False and with sst_anomaly_forcing=True
    (the stand-in set with its anomaly file); (b) fp32 SST-anomaly forcing
    from 1982-01-30 over SST_DAYS days, run_fast (replayed, under the sync
    debug mode "error") against the eager run_day day by day on a side
    stream, torch.equal in every state leaf, with the anomaly window
    shifted at 1982-02-01 in both; (c) the main path in the reference LW
    order: fp32 T30, the day captured first, initialize + run_fast over 2
    days in the guard, counting the reference-order kernel's launches;
12. the presets: T85 boot + 6 fp64 steps on the CPU and on CUDA; then fp32
    runs of PRESET_DAYS replayed days each (T85 2, T42, T63 and T170 1) in
    the guard, captured first: sim-days/min, wall and device ms/step (CUDA
    events around the run), K1 launches (days x nsteps), capture seconds
    and the graph pool's size;
13. the command line and the native NetCDF writer, each command a process
    of its own as a user types it (python -m speedy_tpu_torch): (a) ``run``
    over one day with output (rc 0, the native writer taken, 37 files),
    each file against the file of an in-process Model.run with the scipy
    writer (bit for bit, else the largest difference and why, at most 1e-6
    field-normalised), then s/day of Model.run with each writer in turns;
    (b) (a) with --checkpoint-every 1, then --auto-resume to the second
    day, whose last file must equal a straight two-day ``run``'s, made in
    this process (cli.main) with its K1 launches counted; (c) ``ensemble``
    with 8 members over 2 days (8 member files) and with 2 members over a
    day with --output-every-step (2 x 37 files);
14. the validation programs through their python -m entries on the
    stand-in set: the stability gate (GATE_RUNS: 90 days at T30, T42, T63
    and T85, 10 at T170), each preset guard-clean with finite fields, its
    t_sfc_global_K, jet_max_ms and pass printed; run_climatology over 365
    days at T30; fp32_qualification at T30 over 30 days with 64 members
    (every part, then the report);
15. the dp axis (parallel/mesh.py), each rank a process started by
    torchrun: (a) ``ensemble`` (fp32 T30 SPPT, 8 members, 2 days) over 2
    ranks on cuda:0 with Gloo, each member's file equal to that of an
    unsharded 4-member Ensemble with the rank's seeds made in this
    process, the K1 launches of each rank (2 + 3 x 36), then the
    aggregate member-days/min over 30 days beside one process's (that of
    (c)), over the replayed days after the first and over the whole
    wall; (b)
    tests/torch_mesh_worker.py at fp64 over a day on 2 ranks on cuda:0:
    the gathered state within 1e-12 of the unsharded 8-member Ensemble
    per field and member, and a member pushed out of the guard's range on
    the last rank raising on both; (c) one rank under NCCL against one
    plain process over 30 days, file for file (the plain process's
    member-days/min are (a)'s one process);
16. the accumulating captured day replayed over 2 days against the eager
    days (torch.equal in every state leaf and sum), then run_multiyear
    over 2 years with the El Nino run: rc 0, both JSON lines, 48 finite
    months, one host copy a month, the K1 launches, the wall and the
    sim-days/min;
17. stability_diag at T85 over 9 days in chunks of 3: status clean, the
    npz arrays with the JAX script's shapes, the K1 launches;
18. the sp axis (parallel/mesh.py: latitude bands over ranks, the
    spectral state replicated, each Legendre analysis a band's partial
    sum plus one all-reduce over the dp row's sp group): (a) two ranks
    sharing the card over Gloo (tests/torch_mesh_worker.py, dp=1 x
    sp=2, each day eager, as a Gloo collective cannot be captured): a
    T30 fp64 SPPT day of 2 members, the gathered state within 1e-12 per
    field and member of an unsharded in-process CUDA Ensemble's, the
    ranks' spectral leaves equal; boot + one step at T85 and at T170
    (fp64) within 1e-12 of the unsharded step; the K1 launches and the
    eager day's member-days/min per rank, for the record; (b) one rank
    under NCCL in this process, an sp group of one rank (the band holds
    every row and each analysis makes its all-reduce): the T30 day
    captured with its all-reduces inside the graph, fp64 SPPT, its
    replay torch.equal to the band's eager day and to the unsharded
    run's replayed and eager days; the all-reduces and K1 launches a
    day, and the NCCL and K1 kernels in a profiler trace of one
    replayed day; fp32, 8 members, SPPT on, 30 days, member-days/min of
    the band's replayed days against the unsharded ensemble's, in turns;
    (c) K1 at band shapes (T30 rows 24 and 12, T170 rows 64; the
    northernmost band of the perturbed booted inputs) against its plain
    chain on the card, fp64 and fp32, SW and non-SW, bounds 1e-12 /
    1e-4, with the kernel's graph-replay time; (d) python -m
    speedy_tpu_torch.bench_scaling --mode sp --counts 1,2 --reps 1
    (T30), its JSON lines: count 2 is two Gloo ranks time-slicing one
    card and measures nothing of NVLink.
The last three lines are the kernel table, the card and the result line.
Runs on the stand-in boundary set (speedy_tpu_torch/utils/synthetic_bc.py).
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch

from speedy_tpu_torch import bench_physics
from speedy_tpu_torch.bench_physics import OUTPUT_NAMES, field_errors
from speedy_tpu_torch.bench_step import (REPEATS, booted, capture_day,
                                         day_times, trace)
from speedy_tpu_torch.bench_transform import card_line, time_graph_ms, time_ms
from speedy_tpu_torch.utils.tracing import counters, reset

STEP_BOUND = 1e-10        # relative, CPU vs CUDA prognostics after 6 steps
TRANSFORM_BOUND = {torch.float64: 1e-12, torch.float32: 1e-5}  # field-normalised
# the batches the T30 step issues (57/34 synthesis, 48/25 analysis) and 256
BENCH_BATCHES = [25, 34, 48, 57, 256]
# (preset, precisions, batches): every batch the transform benchmark's path
# runs at T30 and the ragged 1 and 7; T85 at the step-like batches and 256
TRANSFORM_CASES = (("t30", ("fp64", "fp32"), (1, 7) + tuple(BENCH_BATCHES)),
                   ("t85", ("fp32",), (25, 48, 57, 256)),
                   ("t85", ("fp64",), (256,)))
SPPT_NOISE_SEED = 12345
N_TIMED = 100
ENSEMBLE_SIZES = (8, 64)   # [9] (c), [10] (c)
REFLW_MEMBERS = 8          # [3] the reference-order kernel with members
SST_START = (1982, 1, 30)  # [11] (b): SST_DAYS days across a month start
SST_DAYS = 4
# [12] replayed fp32 days per preset
PRESET_DAYS = (("t85", 2), ("t42", 1), ("t63", 1), ("t170", 1))
RUN_REPEATS = 5            # [8] Model.run without output
# [10] (a): (precision, SPPT, members, output variant) of the
# replay-against-eager cases
CAPTURE_CASES = ([(p, sppt, m, False) for p in ("fp64", "fp32")
                  for sppt in (False, True) for m in (None, 8)]
                 + [(p, True, m, True) for p in ("fp64", "fp32")
                    for m in (None, 8)])


def ptxas_summary(log: str):
    """One line per kernel instantiation from nvcc -Xptxas -v output."""
    lines, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*column_physics_kernelI"
                      r"([fd])Li(\d)ELb([01])ELb([01])ELb([01])E", line)
        t = re.search(r"Function properties for \S*(synthesis|analysis)"
                      r"_kernelI([fd])Li(\d+)ELi(\d+)E(?:Li(\d+)E)?E", line)
        if m:
            name = (f"{'fp32' if m.group(1) == 'f' else 'fp64'} kx={m.group(2)}"
                    f" {'sw' if m.group(3) == '1' else 'nosw'}"
                    f"{' members' if m.group(4) == '1' else ''}"
                    f"{' reflw' if m.group(5) == '1' else ''}")
        elif t:
            name = f"{t.group(1)} {'fp32' if t.group(2) == 'f' else 'fp64'}"
            second = "TJ" if t.group(1) == "synthesis" else "TM"
            name += f" FB={t.group(3)} {second}={t.group(4)}"
            if t.group(5):
                name += f" RI={t.group(5)}"
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line)
            lines.append(f"{name}: {regs.group(1) if regs else '?'} "
                         f"registers, {spill}")
            name = None
    return lines


def bench_path(reps):
    """[6] The transform benchmark's path, as a user runs it, with the
    launch counts set to 0 just before and read just after. Returns (ok,
    records keyed by batch, synthesis launches, analysis launches)."""
    from speedy_tpu_torch import bench_transform
    reset()
    records = bench_transform.run("t30", BENCH_BATCHES, reps)
    n_syn, n_ana = counters["k2.launches_syn"], counters["k2.launches_ana"]
    # per batch and direction: warm-up + reps eager, warm-up + reps captured
    expect = len(records) * 2 * (reps + 1)
    print(f"[6] bench_transform t30 ({len(records)} batches, {reps} reps): "
          f"launches synthesis {n_syn}, analysis {n_ana}, expected {expect}")
    ok = n_syn == expect and n_ana == expect
    return ok, {r["batch"]: r for r in records}, n_syn, n_ana


def transform_phase(bench):
    """[6] The spectral-transform kernels, through their public wrappers,
    against their plain einsum chain on the card, at every case of
    TRANSFORM_CASES; the analysis output is exactly 0 where the truncation
    drops the pair. The T30 fp32 times at the benchmark's batches are those
    of its path (``bench``, its records by batch); the others are timed
    here. Returns (ok, rows by (name, preset, precision, batch))."""
    from speedy_tpu_torch.bench_transform import bound_ms as transform_bound
    from speedy_tpu_torch.config import from_preset
    from speedy_tpu_torch.geometry import build_geometry_np
    from speedy_tpu_torch.ops import fused_transforms as ft
    from speedy_tpu_torch.ops import spectral as sp

    ok, rows = True, {}
    rng = np.random.default_rng(1)
    consts = {}

    def spectral(preset, prec):
        if (preset, prec) not in consts:
            c = from_preset(preset, precision=prec)
            consts[(preset, prec)] = sp.build_spectral(
                c, build_geometry_np(c), "cuda")
        return consts[(preset, prec)]

    for preset, precisions, batches in TRANSFORM_CASES:
        for prec in precisions:
            cfg = from_preset(preset, precision=prec)
            dtype = cfg.rdtype
            sc, sc64 = spectral(preset, prec), spectral(preset, "fp64")
            dims = (cfg.mx, cfg.nx, cfg.il, cfg.ix)
            # [mx, nx]: the pairs the truncation drops
            dropped = (torch.arange(cfg.nx, device="cuda")
                       >= ft.truncation_extent(sc.cpol_dir).cuda()[:, None])
            for b in batches:
                spec = torch.as_tensor(rng.standard_normal((b,) + dims[:2]
                                                           + (2,)),
                                       dtype=dtype, device="cuda")
                grid = torch.as_tensor(rng.standard_normal((b,) + dims[2:]),
                                       dtype=dtype, device="cuda")
                for name, d, x, wrapper, plain in (
                        ("spectral_synthesis", "syn", spec,
                         ft.fused_spec_to_grid, sp.spec_to_grid),
                        ("spectral_analysis", "ana", grid,
                         ft.fused_grid_to_spec, sp.grid_to_spec)):
                    k, p = wrapper(sc, x), plain(sc, x)
                    # the fp64 chain on the same values: both the kernel and
                    # its twin carry the working type's rounding
                    p64 = plain(sc64, x.double())
                    torch.cuda.synchronize()
                    (err, abs_err), = field_errors([k], [p])
                    (err64, _), = field_errors([k], [p64])
                    (twin64, _), = field_errors([p], [p64])
                    finite = bool(torch.isfinite(k).all())
                    bound = TRANSFORM_BOUND[dtype]
                    rec = bench.get(b) if (preset, prec) == ("t30", "fp32") \
                        else None
                    if rec is not None:
                        ms, plain_ms, lib_ms = (rec[f"{d}_{t}_us"] * 1e-3
                                                for t in ("kernel_graph",
                                                          "einsum",
                                                          "einsum_graph"))
                    else:
                        ms = time_graph_ms(lambda: wrapper(sc, x), N_TIMED)
                        plain_ms = time_ms(lambda: plain(sc, x), N_TIMED)
                        lib_ms = time_graph_ms(lambda: plain(sc, x), N_TIMED)
                    b_ms, b_by = transform_bound(d, sc, b)
                    smem = ft.smem_bytes(d, *dims, x.element_size(), b)
                    good = err <= bound and finite
                    note = ""
                    if d == "syn":
                        plan = ft.synthesis_plan(*dims, x.element_size(), b)
                        note = (f", tile FB={plan.fb} TJ={plan.tj} "
                                 f"TI={plan.ti} mc={plan.mc}")
                    if d == "ana":
                        exact = bool((k[:, dropped] == 0).all())
                        good &= exact
                        note = f", truncated pairs exactly 0: {exact}"
                    ok &= good
                    print(f"[6] {name} {preset} {prec} B={b}: error "
                          f"{err:.3e} (bound {bound:.0e}) finite={finite}"
                          f"{note}, against the fp64 chain kernel "
                          f"{err64:.2e} twin {twin64:.2e}; kernel "
                          f"{ms * 1e3:.3f} us (graph), bound "
                          f"{b_ms * 1e3:.4f} us ({b_by}), share of the bound "
                          f"{b_ms / ms:.1%}; einsum chain "
                          f"{lib_ms * 1e3:.3f} us (graph) "
                          f"{plain_ms * 1e3:.3f} us (eager); {smem} B shared "
                          f"memory/block {'ok' if good else 'FAILED'}")
                    rows[(name, preset, prec, b)] = dict(
                        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=b_ms, bound_by=b_by, max_abs_err=abs_err)
    return ok, rows


def sppt_noise(seed):
    """A source of standard-normal innovations from a numpy seed."""
    rng = np.random.default_rng(seed)
    return lambda shape: rng.standard_normal(shape)


def sppt_phase(bc, start, card):
    """[7] SPPT: CPU vs CUDA in fp64 with the same innovations, then two
    fp32 days on the card."""
    from speedy_tpu_torch.config import t30
    from speedy_tpu_torch.models.model import Model
    states = {}
    for dev in ("cpu", "cuda"):
        m = Model(t30(precision="fp64", sppt_on=True), device=dev,
                  bc_arrays=bc, sppt_noise=sppt_noise(SPPT_NOISE_SEED))
        s = m.initialize(start)
        daily = m.daily_forcing(s, start, start)
        for i in range(6):
            s, _ = m.one_step(s, daily, i % m.cfg.nstrad == 0)
        states[dev] = dict(s.prog._asdict(), sppt=s.sppt.spec)
    worst = {f: ((a - states["cuda"][f].cpu()).abs().max()
                 / a.abs().max()).item() for f, a in states["cpu"].items()}
    ok = max(worst.values()) <= STEP_BOUND
    print("[7] SPPT fp64 boot+6 steps CPU vs CUDA: "
          + " ".join(f"{k}={v:.2e}" for k, v in worst.items())
          + f" (bound {STEP_BOUND:.0e}) {'ok' if ok else 'FAILED'}")

    model = Model(t30(sppt_on=True), device="cuda", bc_arrays=bc)
    _, capture_s, _ = capture_day(model, model.initialize(start), start)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = model.initialize(start)
    t1 = time.perf_counter()
    state = model.run_fast(start, 2, state=state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n_launch, expect = counters["k1.launches"], 2 + 2 * model.cfg.nsteps
    finite = all(bool(torch.isfinite(x).all()) for x in state.prog)
    print(f"[7] SPPT fp32 T30 2 days: {2 / ((t2 - t1) / 60.0):.1f} "
          f"sim-days/min (run_fast {t2 - t1:.3f} s, initialize "
          f"{t1 - t0:.3f} s; capture before them {capture_s:.3f} s) on "
          f"{card}; K1 launches {n_launch} "
          f"(sw {counters['k1.launches_sw']}), "
          f"expected {expect}; finite={finite}")
    return ok and finite and n_launch == expect


def run_phase(bc, start):
    """[8] Model.run with the NetCDF writer over one day; a checkpoint at
    day 1 resumed to day 2 equals a straight 2-day run (SPPT on)."""
    from scipy.io import netcdf_file
    from speedy_tpu_torch.config import t30
    from speedy_tpu_torch.models.model import Model
    from speedy_tpu_torch.utils import calendar as cal
    from speedy_tpu_torch.utils.checkpoint import load_checkpoint
    from speedy_tpu_torch.utils.output import NetCDFWriter

    model = Model(t30(sppt_on=True), device="cuda", bc_arrays=bc)
    day1, day2 = cal.next_day(start), cal.next_day(cal.next_day(start))
    expect_vars = {"time", "lon", "lat", "lev", "u", "v", "t", "q", "phi",
                   "ps"}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        model.run(start, day1, output_writer=NetCDFWriter(model.cfg, out),
                  verbose=False)
        t_out = time.perf_counter() - t0
        files = sorted(os.listdir(out))
        with netcdf_file(os.path.join(out, files[-1]), mmap=False) as f:
            names = set(f.variables)
            t_last = f.variables["t"][:].copy()
        files_ok = (len(files) == model.cfg.nsteps + 1
                    and files[0] == "198201010000.nc"
                    and files[-1] == "198201020000.nc"
                    and names == expect_vars
                    and bool(np.isfinite(t_last).all()))
        print(f"[8] Model.run 1 day with output: {len(files)} files "
              f"({files[0]} .. {files[-1]}), variables {sorted(names)}, "
              f"{t_out:.2f} s {'ok' if files_ok else 'FAILED'}")

        ck = os.path.join(tmp, "ck")
        straight = model.run(start, day2, verbose=False, checkpoint_every=1,
                             checkpoint_dir=ck)
        restored, date, step, _ = load_checkpoint(
            os.path.join(ck, "ckpt_198201020000.npz"),
            model.initialize(start), cfg=model.cfg)
        resumed = model.run(start, day2, state=restored, resume_date=date,
                            model_step=step, verbose=False)
    same = all(torch.equal(a, b) for a, b in zip(straight.prog,
                                                 resumed.prog))
    same &= torch.equal(straight.sppt.spec, resumed.sppt.spec)
    print(f"[8] checkpoint at {date} (step {step}) resumed to {day2}: "
          f"equal to the straight run: {same}")
    # Model.run without output, then its day (diagnostics only) and the
    # day with grids (a writer's) in turns: replay and host copy
    walls, days = [], {False: [], True: []}
    state = model.initialize(start)
    rows = model.make_ds_days(start, start, 1)[0]
    for _ in range(RUN_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.run(start, day2, state=state, verbose=False)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / 2)
        for grids in (False, True):
            cd = model.captured_day(state, collect_output=True, grids=grids)
            cd.load(state)
            cd.set_days(rows)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cd.advance(0, model.sppt_noise)
            cd.outputs()
            days[grids].append(time.perf_counter() - t0)
    med = {k: float(np.median(v)) for k, v in days.items()}
    print(f"[8] Model.run 2 days without output (captured before): "
          f"{np.median(walls):.4f} s/day, median of {RUN_REPEATS} "
          f"({min(walls):.4f}-{max(walls):.4f}); its day (replay and host "
          f"copy) {med[False]:.4f} s, with grids {med[True]:.4f} s")
    return files_ok and same


def ensemble_phase(bc, start, card):
    """[9] Ensembles: (a) K1 with members, (b) CPU vs CUDA, (c) the ensemble
    path. Returns (ok, K1 rows at 64 members by variant, K1 launches of the
    64-member run as (all, sw))."""
    from speedy_tpu_torch.config import t30
    from speedy_tpu_torch.models.model import Model, one_step
    from speedy_tpu_torch.parallel.ensemble import Ensemble

    t_phase = time.perf_counter()
    ok, rows = True, {}
    for rec in bench_physics.run_members():
        good = bench_physics.passed(rec)
        ok &= good
        print(f"[9] K1 {rec['members']} members {rec['preset']} "
              f"{rec['precision']} {rec['variant']}: worst "
              f"{rec['worst']:.3e} (bound {rec['bound']:.0e}) finite="
              f"{rec['finite']} members equal one-member launches="
              f"{rec['members_equal_single']}; kernel "
              f"{rec['kernel_graph_us']:.3f} us/call (graph), "
              f"{rec['us_per_member']:.3f} us/member, eager "
              f"{rec['kernel_eager_us']:.1f} us, plain "
              f"{rec['plain_us'] * 1e-3:.3f} ms, bound "
              f"{rec['bound_us']:.3f} us ({rec['bound_by']}), share of the "
              f"bound {rec['share']:.1%} {'ok' if good else 'FAILED'}")
        if rec["members"] == 64 and rec["precision"] == "fp32":
            rows[rec["variant"]] = dict(
                ms=rec["kernel_graph_us"] * 1e-3,
                plain_ms=rec["plain_us"] * 1e-3,
                bound_ms=rec["bound_us"] * 1e-3, bound_by=rec["bound_by"],
                max_abs_err=rec["max_abs_err"])

    # (b) CPU vs CUDA, 2 members, SPPT on, the same innovations
    states = {}
    for dev in ("cpu", "cuda"):
        m = Model(t30(precision="fp64", sppt_on=True), device=dev,
                  bc_arrays=bc, sppt_noise=sppt_noise(SPPT_NOISE_SEED))
        ens = Ensemble(m, 2, noise=[sppt_noise(SPPT_NOISE_SEED + 1 + i)
                                    for i in range(2)])
        s = ens.initialize(start)
        daily = m.daily_forcing(s, start, start)
        for i in range(6):
            s, _ = one_step(m.cfg, m.pp, m.lsp, m.mc, s, daily,
                            i % m.cfg.nstrad == 0, noise=ens.noise)
        states[dev] = dict(s.prog._asdict(), sppt=s.sppt.spec)
    worst = {f: max(((a[k] - states["cuda"][f][k].cpu()).abs().max()
                     / a[k].abs().max()).item() for k in range(2))
             for f, a in states["cpu"].items()}
    good = max(worst.values()) <= STEP_BOUND
    ok &= good
    print("[9] 2-member SPPT ensemble fp64 boot+6 steps CPU vs CUDA, worst "
          "member: " + " ".join(f"{k}={v:.2e}" for k, v in worst.items())
          + f" (bound {STEP_BOUND:.0e}) {'ok' if good else 'FAILED'}")

    # (c) the ensemble path, fp32 SPPT, the day captured first, 2 days
    model = Model(t30(sppt_on=True), device="cuda", bc_arrays=bc)
    nsteps = model.cfg.nsteps
    launches = None
    for members in ENSEMBLE_SIZES:
        ens = Ensemble(model, members, base_seed=0)
        estate = ens.initialize(start)
        _, capture_s, pool = capture_day(model, estate, start)
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        estate, _ = ens.run_days(estate, start, 2)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 2
        n_launch = counters["k1.launches"]
        n_sw = counters["k1.launches_sw"]
        finite = all(bool(torch.isfinite(x).all())
                     for g in estate[:3] for x in g)
        spread = min(float((estate.prog.vor[k] - estate.prog.vor[0]).abs()
                           .max()) for k in range(1, members))
        good = finite and spread > 0.0 and n_launch == 2 * nsteps
        ok &= good
        print(f"[9] ensemble fp32 T30 SPPT {members} members, 2 days "
              f"(guard per member each day): {wall:.3f} s a day, "
              f"{members / (wall / 60.0):.1f} member-days/min, "
              f"{wall / nsteps * 1e3:.3f} ms/step on {card} (capture "
              f"before them {capture_s:.3f} s, the model's graph pool "
              f"{pool / 2**20:.1f} MiB); K1 launches {n_launch} (sw "
              f"{n_sw}), expected {2 * nsteps}; finite={finite}, smallest "
              f"member spread (vor) {spread:.3e} {'ok' if good else 'FAILED'}")
        if members == 64:
            launches = (n_launch, n_sw)
    print(f"[9] phase time {time.perf_counter() - t_phase:.1f} s")
    return ok, rows, launches


@contextlib.contextmanager
def sync_error():
    """Any host synchronisation not marked deliberate
    (models/captured.py ``host_sync``) raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def side_eager_day(model, state, start, noise, collect_output=False,
                   grids=False, date=None):
    """One day of the module-level run_day (eager) from ``date`` (default
    ``start``, the run's start), on a side stream, as the captured day
    runs on one, with diagnostics every ``cfg.diag_every`` steps or, with
    ``collect_output``, every step, and with ``grids`` every step's
    gridded fields: run_day's (state, diagnostics, grids)."""
    from speedy_tpu_torch.models.model import run_day
    cfg = model.cfg
    cur, side = torch.cuda.current_stream(), torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = run_day(cfg, model.pp, model.lsp, model.mc, state,
                      model.date_scalars(date or start, start),
                      1 if collect_output else cfg.diag_every, noise,
                      grids)
    cur.wait_stream(side)
    torch.cuda.synchronize()
    return out


def replay_vs_eager(model, start, members=None, collect_output=False,
                    grids=False):
    """[10] (a) One day from the booted state replayed (under the sync
    debug mode "error", after its capture) and run eagerly, in the fast
    variant or, with ``collect_output``, the output variant (every step's
    diagnostics and, with ``grids``, gridded fields, against run_day's
    with diagnostics every step): (equal in every state leaf and output,
    what differs, capture seconds)."""
    from speedy_tpu_torch.models.captured import leaves
    from speedy_tpu_torch.models.model import GRID_FIELDS
    from speedy_tpu_torch.utils.diagnostics import Diagnostics
    state, noise, _ = booted(model, start, members)
    cd, capture_s, _ = capture_day(model, state, start,
                                   collect_output=collect_output, grids=grids)
    with sync_error():
        cd.advance(0, noise)
    replayed = cd.result()
    eager, diags, fields = side_eager_day(model, state, start, noise,
                                          collect_output, grids)
    differ = [f"leaf {i}" for i, (a, b) in enumerate(zip(leaves(replayed),
                                                         leaves(eager)))
              if not torch.equal(a, b)]
    if collect_output:
        ref = {f: torch.stack([getattr(d, f) for d in diags])
               for f in Diagnostics._fields}
        if grids:
            ref.update({k: torch.stack([g[k] for g in fields])
                        for k in GRID_FIELDS})
        out = cd.outputs()
        differ += [k for k, v in ref.items()
                   if not np.array_equal(out.pop(k), v.cpu().numpy())]
        differ += [f"{k} unexpected" for k in out]
    return not differ, differ, capture_s


K1_SW = re.compile(r"column_physics_kernel(<[^,]+, ?\d+, ?true"
                   r"|I[fd]Li\d+ELb1)")


def k1_in_trace(fn):
    """The kernels of one call of ``fn`` in a profiler trace: (K1 kernels,
    K1 SW kernels, all kernels)."""
    names = [n for n, _ in trace(fn)[1]]
    k1 = [n for n in names if "column_physics" in n]
    return len(k1), sum(1 for n in k1 if K1_SW.search(n)), len(names)


def capture_phase(bc, start, card):
    """[10] The captured day: replay against eager, no hidden sync, the
    K1 nodes of a replayed day, and the eager and replayed rates."""
    from speedy_tpu_torch.config import t30
    from speedy_tpu_torch.models.model import Model

    ok = True
    models = {}
    for prec, sppt, members, collect in CAPTURE_CASES:
        if (prec, sppt) not in models:
            models[(prec, sppt)] = Model(t30(precision=prec, sppt_on=sppt),
                                         device="cuda", bc_arrays=bc)
        model = models[(prec, sppt)]
        equal, differ, capture_s = replay_vs_eager(
            model, start, members, collect_output=collect, grids=collect)
        differ = f" ({', '.join(differ)} differ)" if differ else ""
        ok &= equal
        variant = ("output variant (diagnostics and grids every step)"
                   if collect else "fast variant")
        print(f"[10] replayed day vs eager day, {variant}, {prec} T30 SPPT "
              f"{'on' if sppt else 'off'}, "
              f"{members or 1} member{'s' if members else ''}: "
              f"torch.equal {equal}{differ}"
              f", replay under sync debug mode error; capture "
              f"{capture_s:.2f} s {'ok' if equal else 'FAILED'}")

    model = Model(t30(), device="cuda", bc_arrays=bc)
    state = model.initialize(start)
    t0 = time.perf_counter()
    with sync_error():
        model.run_fast(start, 2, state=state)
    torch.cuda.synchronize()
    print(f"[10] run_fast fp32 T30 2 days, capture included, under sync "
          f"debug mode error: {time.perf_counter() - t0:.2f} s ok")

    cd = model.captured_day(state)
    cd.load(state)
    cd.set_days(model.make_ds_days(start, start, 1)[0])
    n_k1, n_sw, n_all = k1_in_trace(lambda: cd.advance(0))
    nsteps, nstrad = model.cfg.nsteps, model.cfg.nstrad
    good = n_k1 == nsteps and n_sw == nsteps // nstrad
    ok &= good
    print(f"[10] profiler trace of one replayed fp32 T30 day: {n_k1} K1 "
          f"kernels ({n_sw} SW), expected {nsteps} ({nsteps // nstrad}); "
          f"{n_all} kernels in all {'ok' if good else 'FAILED'}")

    for label, sppt, members in (("1 model SPPT off", False, None),
                                 ("1 model SPPT on", True, None),
                                 ("8 members SPPT on", True, 8),
                                 ("64 members SPPT on", True, 64)):
        fresh = Model(t30(sppt_on=sppt), device="cuda", bc_arrays=bc)
        rec = day_times(fresh, start, members)
        n = members or 1
        rate = {k: [n * 60.0 / t for t in rec[k]]
                for k in ("eager", "replayed")}
        med = {k: float(np.median(v)) for k, v in rate.items()}
        unit = "sim-days/min" if members is None else "member-days/min"
        prof = rec["profiles"]["replayed"]
        extra = ""
        if members == 64:
            extra = (f"; SPPT pre-draw ({nsteps} x {members} randn) "
                     f"{rec['predraw_host_s'] * 1e3:.2f} ms host, "
                     f"{rec['predraw_device_s'] * 1e3:.2f} ms device")
        print(f"[10] {label}, fp32 T30, {REPEATS} pairs in turns: "
              f"{unit} eager {med['eager']:.1f} "
              f"({min(rate['eager']):.1f}-{max(rate['eager']):.1f}), "
              f"replayed {med['replayed']:.1f} "
              f"({min(rate['replayed']):.1f}-{max(rate['replayed']):.1f}), "
              f"{med['replayed'] / med['eager']:.2f}x; replayed day "
              f"{float(np.median(rec['replayed'])) / nsteps * 1e3:.3f} "
              f"ms/step, device {prof['device_ms_per_step']:.3f} ms/step "
              f"(busy {prof['busy_share']:.2f} of a profiled day); capture "
              f"{rec['capture_s']:.2f} s, the model's "
              f"graph pool {rec['pool_bytes'] / 2**20:.1f} MiB after it "
              f"(all reserved {rec['reserved_bytes'] / 2**20:.1f} MiB)"
              f"{extra} on {card}")
    return ok


def steps_cpu_vs_cuda(cfg, bc, start):
    """Boot + 6 steps of ``cfg`` (fp64) on the CPU and on CUDA: the
    worst relative difference per prognostic field."""
    from speedy_tpu_torch.models.model import Model
    states = {}
    for dev in ("cpu", "cuda"):
        m = Model(cfg, device=dev, bc_arrays=bc)
        st = m.initialize(start)
        daily = m.daily_forcing(st, start, start)
        for i in range(6):
            st, _ = m.one_step(st, daily, i % m.cfg.nstrad == 0)
        states[dev] = st.prog
    return {f: ((a - getattr(states["cuda"], f).cpu()).abs().max()
                / a.abs().max()).item()
            for f, a in states["cpu"]._asdict().items()}


def sst_replay_vs_eager(model, first, days):
    """``days`` days of an SST-anomaly ``model`` from ``first``: run_fast
    (replayed, under the sync debug mode "error", capture included)
    against the module-level run_day day by day on a side stream, with the
    window reset to ``first``'s and shifted by hand at each later month
    start. Returns (leaves that differ, whether the window shifted the same
    in both, end date, seconds of run_fast)."""
    from speedy_tpu_torch.models.captured import leaves
    from speedy_tpu_torch.utils import calendar as cal
    state = model.initialize(first)
    window0 = model.mc.clim.sstan3.clone()
    t0 = time.perf_counter()
    with sync_error():
        replayed = model.run_fast(first, days, state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    window1 = model.mc.clim.sstan3.clone()
    model.set_anomaly_window(first)
    eager, date = state, first
    for _ in range(days):
        if date.day == 1 and date != first:
            model.advance_anomaly_window(first, date)
        eager, _, _ = side_eager_day(model, eager, first, None, date=date)
        for _ in range(model.cfg.nsteps):
            date = cal.newdate(date, model.cfg.nsteps)
    differ = [i for i, (a, b) in enumerate(zip(leaves(replayed),
                                               leaves(eager)))
              if not torch.equal(a, b)]
    shifted = (not torch.equal(window0, window1)
               and torch.equal(window1[:2], window0[1:])
               and torch.equal(window1, model.mc.clim.sstan3))
    return differ, shifted, date, wall


def configuration_phase(bc, card):
    """[11] The reference LW order and SST-anomaly forcing: CPU vs CUDA,
    the SST run replayed against eager across a month start, and the main
    path in the reference order. Returns (ok, the reference-order kernel's
    launches on that path as (all, sw))."""
    from speedy_tpu_torch.config import t30
    from speedy_tpu_torch.models.model import Model
    from speedy_tpu_torch.utils import calendar as cal
    from speedy_tpu_torch.utils.synthetic_bc import synthetic_boundaries

    t_phase = time.perf_counter()
    ok = True
    start = cal.Datetime(1982, 1, 1)
    bc_sst = synthetic_boundaries(0, anomaly=True)
    for label, kw, arrays in (
            ("lw_band_vectorized=False", dict(lw_band_vectorized=False), bc),
            ("sst_anomaly_forcing=True", dict(sst_anomaly_forcing=True),
             bc_sst)):
        worst = steps_cpu_vs_cuda(t30(precision="fp64", **kw), arrays,
                                  start)
        good = max(worst.values()) <= STEP_BOUND
        ok &= good
        print(f"[11] {label} fp64 boot+6 steps CPU vs CUDA: "
              + " ".join(f"{k}={v:.2e}" for k, v in worst.items())
              + f" (bound {STEP_BOUND:.0e}) {'ok' if good else 'FAILED'}")

    # (b) SST anomalies across 1982-02-01: replayed against eager
    model = Model(t30(sst_anomaly_forcing=True), device="cuda",
                  bc_arrays=bc_sst)
    first = cal.Datetime(*SST_START)
    differ, shifted, date, wall = sst_replay_vs_eager(model, first,
                                                      SST_DAYS)
    good = not differ and shifted and date == cal.Datetime(1982, 2, 3)
    ok &= good
    print(f"[11] SST anomalies fp32 T30 from {first.year}-{first.month:02d}-"
          f"{first.day:02d}, {SST_DAYS} days "
          f"(run_fast under sync debug mode error, capture included, "
          f"{wall:.2f} s): replayed vs eager day by day torch.equal "
          f"{not differ}{f' (leaves {differ} differ)' if differ else ''}; "
          f"window shifted at 1982-02-01 in both: {shifted} "
          f"{'ok' if good else 'FAILED'}")

    # (c) the main path in the reference LW order
    model = Model(t30(lw_band_vectorized=False), device="cuda",
                  bc_arrays=bc)
    _, capture_s, pool = capture_day(model, model.initialize(start), start)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = model.initialize(start)
    t1 = time.perf_counter()
    state = model.run_fast(start, 2, state=state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n = counters["k1.launches_reflw"]
    n_sw = counters["k1.launches_reflw_sw"]
    nsteps, nstrad = model.cfg.nsteps, model.cfg.nstrad
    expect = (2 + 2 * nsteps, 2 + 2 * nsteps // nstrad)
    finite = all(bool(torch.isfinite(x).all()) for x in state.prog)
    good = (n, n_sw) == expect and counters["k1.launches"] == n and finite
    ok &= good
    print(f"[11] reference LW order fp32 T30 2 days: "
          f"{2 / ((t2 - t1) / 60.0):.1f} sim-days/min (run_fast "
          f"{t2 - t1:.3f} s, initialize {t1 - t0:.3f} s; capture before "
          f"them {capture_s:.3f} s, graph pool {pool / 2**20:.1f} MiB) on "
          f"{card}; reference-order K1 launches {n} (sw {n_sw}), expected "
          f"{expect[0]} ({expect[1]}), of {counters['k1.launches']} K1 "
          "launches; "
          f"finite={finite} {'ok' if good else 'FAILED'}")
    print(f"[11] phase time {time.perf_counter() - t_phase:.1f} s")
    return ok, (n, n_sw)


def presets_phase(bc, card):
    """[12] T85 CPU vs CUDA in fp64, then PRESET_DAYS replayed fp32 days at
    T85, T42, T63 and T170 in the guard."""
    from speedy_tpu_torch.config import from_preset, t85
    from speedy_tpu_torch.models.model import Model
    from speedy_tpu_torch.utils import calendar as cal

    t_phase = time.perf_counter()
    start = cal.Datetime(1982, 1, 1)
    worst = steps_cpu_vs_cuda(t85(precision="fp64"), bc, start)
    ok = max(worst.values()) <= STEP_BOUND
    print(f"[12] T85 fp64 boot+6 steps CPU vs CUDA: "
          + " ".join(f"{k}={v:.2e}" for k, v in worst.items())
          + f" (bound {STEP_BOUND:.0e}) {'ok' if ok else 'FAILED'} "
          f"({time.perf_counter() - t_phase:.1f} s)")
    for preset, days in PRESET_DAYS:
        t_preset = time.perf_counter()
        model = Model(from_preset(preset), device="cuda", bc_arrays=bc)
        cfg = model.cfg
        state = model.initialize(start)
        _, capture_s, pool = capture_day(model, state, start)
        reset()
        begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        begin.record()
        out = model.run_fast(start, days, state=state)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = days * cfg.nsteps
        finite = all(bool(torch.isfinite(x).all()) for x in out.prog)
        good = counters["k1.launches"] == steps and finite
        ok &= good
        print(f"[12] {preset} fp32 ({cfg.ix}x{cfg.il}x{cfg.kx}, "
              f"{cfg.nsteps} steps a day), {days} replayed day"
              f"{'s' if days > 1 else ''} in the guard: "
              f"{days / (wall / 60.0):.2f} sim-days/min, "
              f"{wall / steps * 1e3:.3f} ms/step, device "
              f"{begin.elapsed_time(end) / steps:.3f} ms/step (CUDA events "
              f"around run_fast); K1 launches {counters['k1.launches']} "
              f"(sw {counters['k1.launches_sw']}), expected {steps}; "
              "warm-up day and "
              f"capture {capture_s:.2f} s, graph pool {pool / 2**20:.1f} "
              f"MiB; finite={finite} on {card} "
              f"({time.perf_counter() - t_preset:.1f} s) "
              f"{'ok' if good else 'FAILED'}")
        del model, state, out
    print(f"[12] phase time {time.perf_counter() - t_phase:.1f} s")
    return ok


CLI_DAYS = 2               # [13] (b): a checkpointed day, then one more
WRITER_TURNS = 2           # [13] (a): in-process days per output writer
GATE_RUNS = (("t30,t42,t63,t85", 90), ("t170", 10))   # [14] (presets, days)
CLIMATE_DAYS = 365         # [14] run_climatology at T30
QUAL_DAYS, QUAL_MEMBERS = 30, 64   # [14] fp32_qualification at T30
DEVICE = "cuda"            # [13], [14]: the programs' device
COMMON = ("--synthetic-bc", "0", "--device", DEVICE)   # and boundary set


def program(label, module, *args):
    """``python -m module args`` from this checkout's root, as a user
    types it; prints its wall time and, on a failure, its output's end.
    Returns the CompletedProcess."""
    import subprocess
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", module, *args],
                       cwd=os.path.dirname(os.path.abspath(__file__)),
                       capture_output=True, text=True, timeout=900)
    print(f"{label} python -m {module} {' '.join(args)}: rc {r.returncode} "
          f"in {time.perf_counter() - t0:.1f} s")
    if r.returncode not in (0, 1) or "Traceback" in r.stderr:
        print(r.stdout[-3000:] + r.stderr[-3000:])
    return r


def in_process_cli(argv):
    """speedy_tpu_torch.cli.main(argv) in this process, its printed lines
    kept; returns (rc, output)."""
    import io
    from speedy_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def nc_diff(a_dir, b_dir, names=None):
    """The files of two output directories variable by variable: (the same
    file names, variables and attributes, the largest field-normalised
    difference over every variable of the files ``names`` (default: all),
    where it is)."""
    from scipy.io import netcdf_file
    la, lb = sorted(os.listdir(a_dir)), sorted(os.listdir(b_dir))
    same = la == lb
    worst, where = 0.0, None
    for n in (names or la):
        with netcdf_file(os.path.join(a_dir, n), mmap=False) as fa, \
                netcdf_file(os.path.join(b_dir, n), mmap=False) as fb:
            same &= set(fa.variables) == set(fb.variables)
            for k, va in fa.variables.items():
                vb = fb.variables[k]
                same &= all(getattr(va, att, None) == getattr(vb, att, None)
                            for att in ("long_name", "units"))
                x = np.asarray(va[:], np.float64)
                y = np.asarray(vb[:], np.float64)
                d = float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-300))
                if d > worst:
                    worst, where = d, f"{n} {k}"
    return same, worst, where


def cli_phase(bc, card):
    """[13] The command line and the native writer on the card, each step
    a process of its own as a user types it: (a) one checkpointed day of
    ``run`` with output, against an in-process Model.run with the scipy
    writer; s/day of Model.run with each writer; (b) --auto-resume from
    (a)'s checkpoint to the second day, against a straight two-day ``run``
    made in this process with its K1 launches counted; (c) ``ensemble``
    without and with --output-every-step."""
    from speedy_tpu_torch.config import t30
    from speedy_tpu_torch.models.model import Model
    from speedy_tpu_torch.utils import calendar as cal
    from speedy_tpu_torch.utils.native_output import AsyncNetCDFWriter
    from speedy_tpu_torch.utils.output import NetCDFWriter

    t_phase = time.perf_counter()
    start = cal.Datetime(1982, 1, 1)
    day1 = cal.next_day(start)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        d = lambda *p: os.path.join(tmp, *p)
        run = ("run",) + COMMON + ("--start", "1982-01-01")
        ck = ("--checkpoint-every", "1", "--checkpoint-dir", d("ck"))
        # (a) one day with output, checkpointed for (b)
        r = program("[13] (a)", "speedy_tpu_torch", *run, "--end",
                    "1982-01-02", *ck, "--output-dir", d("cli"))
        native_taken = "output writer: native" in r.stdout
        files = sorted(os.listdir(d("cli"))) if os.path.isdir(d("cli")) \
            else []
        wall = re.search(r"wall time: ([0-9.]+)s", r.stdout)
        model = Model(t30(), device=DEVICE, bc_arrays=bc)
        model.run(start, day1, output_writer=NetCDFWriter(model.cfg,
                                                          d("ref")),
                  verbose=False)
        same, worst, where = nc_diff(d("cli"), d("ref"))
        good = (r.returncode == 0 and native_taken and len(files) == 37
                and same and worst <= 1e-6)
        ok &= good
        print(f"[13] (a) run 1 day: {len(files)} files, native writer taken: "
              f"{native_taken}, the same files, variables and attributes as "
              f"Model.run with the scipy writer in this process: {same}, "
              f"largest difference {worst:.3e} field-normalised (bound 1e-6)"
              + ("" if worst == 0 else
                 f" at {where}: two processes, each with its own captured "
                 "day") + f"; the command's wall time "
              f"{wall.group(1) if wall else '?'} s (model build excluded, "
              f"warm-up day and capture included) {'ok' if good else 'FAILED'}")
        # s/day of Model.run with each writer, the day captured before
        walls = {"native": [], "scipy": []}
        for i in range(WRITER_TURNS):
            for kind in (("native", "scipy") if i % 2 == 0
                         else ("scipy", "native")):
                out = d(f"w{kind}{i}")
                w = AsyncNetCDFWriter(model.cfg, out) if kind == "native" \
                    else NetCDFWriter(model.cfg, out)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.run(start, day1, output_writer=w, verbose=False)
                if kind == "native":
                    w.drain()
                walls[kind].append(time.perf_counter() - t0)
        print("[13] (a) Model.run 1 day with output every step: "
              + ", ".join(f"{k} writer {' / '.join(f'{x:.3f}' for x in v)} "
                          f"s/day" for k, v in walls.items())
              + f" (in turns) on {card}")
        del model

        # (b) --auto-resume from (a)'s checkpoint to the second day
        r2 = program("[13] (b)", "speedy_tpu_torch", *run, "--end",
                     "1982-01-03", *ck, "--auto-resume", "--output-dir",
                     d("b2"))
        reset()
        rc, text = in_process_cli(list(run) + [
            "--end", "1982-01-03", "--output-dir", d("straight")])
        n_k1 = counters["k1.launches"]
        # the boot, the warm-up day before the capture, the replayed days
        expect = 2 + (CLI_DAYS + 1) * t30().nsteps
        last = "198201030000.nc"
        _, worst, _ = nc_diff(d("b2"), d("straight"), [last])
        resumed = "resuming from" in r2.stdout and \
            "ckpt_198201020000.npz" in r2.stdout
        good = (r2.returncode == 0 and rc == 0 and resumed
                and worst == 0.0 and n_k1 == expect)
        ok &= good
        print(f"[13] (b) --auto-resume from the day-1 checkpoint: "
              f"{resumed}; its {last} against the straight 2-day run's "
              f"(in this process): largest difference {worst:.3e}; the "
              f"straight run's K1 launches {n_k1} "
              f"(sw {counters['k1.launches_sw']}), "
              f"expected {expect} (2 in the boot, 36 in the warm-up day "
              f"before the capture, 36 a replayed day) "
              f"{'ok' if good else 'FAILED'}")
        for line in text.splitlines():
            print(f"    {line}")

        # (c) ensembles
        ens = ("ensemble",) + COMMON
        r1 = program("[13] (c)", "speedy_tpu_torch", *ens, "--members", "8",
                     "--days", "2", "--output-dir", d("e8"))
        members = sorted(os.listdir(d("e8"))) if os.path.isdir(d("e8")) \
            else []
        e8 = [os.listdir(d("e8", m)) for m in members]
        r2 = program("[13] (c)", "speedy_tpu_torch", *ens, "--members", "2",
                     "--days", "1", "--output-every-step", "--output-dir",
                     d("e2"))
        e2 = [len(os.listdir(d("e2", m))) for m in
              (sorted(os.listdir(d("e2"))) if os.path.isdir(d("e2"))
               else [])]
        good = (r1.returncode == 0 and r2.returncode == 0
                and len(members) == 8
                and all(f == ["198201030000.nc"] for f in e8)
                and e2 == [37, 37]
                and "output writer: native" in r2.stdout)
        ok &= good
        print(f"[13] (c) ensemble 8 members 2 days: {len(members)} member "
              f"files; 2 members 1 day every step: {e2} files, native "
              f"writer taken: {'output writer: native' in r2.stdout} "
              f"{'ok' if good else 'FAILED'}")
    print(f"[13] phase time {time.perf_counter() - t_phase:.1f} s")
    return ok


def json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def validation_phase(card):
    """[14] The validation programs on the card, each through its python -m
    entry: the stability gate (GATE_RUNS), the T30 climatology over
    CLIMATE_DAYS days and the fp32 qualification (QUAL_DAYS days,
    QUAL_MEMBERS members, all parts, then the report)."""
    t_phase = time.perf_counter()
    ok = True
    for presets, days in GATE_RUNS:
        r = program("[14]", "speedy_tpu_torch.stability_gate", "--presets",
                    presets, "--days", str(days), *COMMON)
        rows = json_lines(r.stdout)
        per = [x for x in rows if "preset" in x]
        good = (len(per) == len(presets.split(",")) and r.returncode ==
                (0 if all(x["pass"] for x in per) else 1)
                and all(x["guard_clean"] and x["finite"] for x in per))
        ok &= good
        for x in per:
            print(f"[14] stability gate {x['preset']} {x['days']} days: "
                  f"guard_clean={x['guard_clean']} finite="
                  f"{x.get('finite')} t_sfc_global_K="
                  f"{x.get('t_sfc_global_K')} jet_max_ms="
                  f"{x.get('jet_max_ms')} pass={x['pass']} wall "
                  f"{x['wall_s']:.1f} s" + (f" error: {x['error']}"
                                            if "error" in x else ""))
        print(f"[14] {json.dumps(rows[-1]) if rows else 'no summary'} "
              f"{'ok' if good else 'FAILED'}")
    r = program("[14]", "speedy_tpu_torch.run_climatology", "--days",
                str(CLIMATE_DAYS), *COMMON)
    rows = json_lines(r.stdout)
    good = r.returncode == 0 and len(rows) == 1 and rows[0]["finite"]
    ok &= good
    for line in r.stdout.splitlines():
        print(f"[14] {line}")
    print(f"[14] climatology on {card} {'ok' if good else 'FAILED'}")
    with tempfile.TemporaryDirectory() as tmp:
        r = program("[14]", "speedy_tpu_torch.fp32_qualification", "--days",
                    str(QUAL_DAYS), "--members", str(QUAL_MEMBERS), "--out",
                    tmp, *COMMON)
    runs = json_lines(r.stdout)
    table = [line for line in r.stdout.splitlines()
             if re.match(r"\s*\d+\s", line)]
    good = (r.returncode == 0 and len(runs) == 5
            and all(x["finite"] for x in runs) and len(table) == QUAL_DAYS)
    ok &= good
    for line in r.stdout.splitlines():
        print(f"[14] {line}")
    print(f"[14] fp32 qualification on {card} {'ok' if good else 'FAILED'}")
    print(f"[14] phase time {time.perf_counter() - t_phase:.1f} s")
    return ok


DP_MEMBERS, DP_DAYS = 8, 2          # [15] (a)
DP_TIMED_DAYS = 30                  # [15] (a), (c): member-days/min
MULTIYEAR_YEARS = 2                 # [16]
DIAG_PRESET, DIAG_DAYS, DIAG_CHUNK = "t85", 9, 3   # [17]
SP_MEMBERS = 2                      # [18] (a): the T30 day's members
SP_STEP_PRESETS = ("t85", "t170")   # [18] (a): boot + one step
SP_NCCL_MEMBERS, SP_NCCL_DAYS = 8, 30   # [18] (b): the timed fp32 days
SP_K1_BANDS = (("t30", (24, 12)), ("t170", (64,)))   # [18] (c): rows


def torchrun(label, nproc, *args, module=True):
    """``python -m torch.distributed.run --standalone --nproc-per-node
    nproc [-m] args`` from this checkout's root (``program``'s output and
    timing)."""
    import subprocess
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc)] + (["-m"] if module else []) \
        + list(args)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                       text=True, timeout=900)
    print(f"{label} torchrun --nproc-per-node {nproc} "
          f"{'-m ' if module else ''}{' '.join(args)}: rc {r.returncode} in "
          f"{time.perf_counter() - t0:.1f} s")
    return r


def member_rate(text, over="initialize"):
    """The ensemble command's member-days/min over the whole wall
    ("initialize") or over the replayed days after the first
    ("replayed")."""
    m = re.search(r"([0-9.]+) member-days/min[^\n]*" + over, text)
    return float(m.group(1)) if m else float("nan")


def rank_launches(text):
    """{rank: (K1 launches, SW launches)} from the ensemble command's
    lines (one process: rank 0)."""
    return {int(r or 0): (int(n), int(sw)) for r, n, sw in re.findall(
        r"(?:rank (\d+): )?column-physics kernel launches (\d+) "
        r"\(sw (\d+)\)", text)}


def write_members(model, ens, estate, out, days, start, end, first=0):
    """Every member's final fields as the ``ensemble`` command writes them
    (NetCDFWriter, memberNNN/ by global index ``first`` + i)."""
    from speedy_tpu_torch.utils.output import NetCDFWriter
    for i in range(ens.n):
        w = NetCDFWriter(model.cfg,
                         os.path.join(out, f"member{first + i:03d}"))
        fields = ens.member_fields(estate, i)
        w(days * model.cfg.nsteps, end, start,
          {k: v.cpu().numpy() for k, v in fields.items()})


def dp_phase(bc, card):
    """[15] The dp axis on the card: (a) ``ensemble`` over two ranks on one
    GPU (Gloo), each rank's member files against an unsharded 4-member
    Ensemble with the rank's seeds, made in this process, and the
    aggregate member-days/min beside one process's (over the replayed
    days after the first, and over the whole wall); (b) the same at fp64
    over a day through tests/torch_mesh_worker.py, the gathered fp64
    state against the unsharded 8-member Ensemble <= 1e-12 per field and
    member, and the guard trip on the last rank raised by both; (c) one
    rank under NCCL against one plain process over 30 days, file for file,
    the plain process's rate being (a)'s one process."""
    from speedy_tpu_torch.config import t30
    from speedy_tpu_torch.models.model import Model
    from speedy_tpu_torch.parallel.ensemble import Ensemble
    from speedy_tpu_torch.utils import calendar as cal

    t_phase = time.perf_counter()
    start = cal.Datetime(1982, 1, 1)
    ok = True
    nsteps = t30().nsteps
    with tempfile.TemporaryDirectory() as tmp:
        d = lambda *p: os.path.join(tmp, *p)
        ens = ("speedy_tpu_torch", "ensemble", "--synthetic-bc", "0",
               "--members", str(DP_MEMBERS))
        # every rank on the card [13]'s DEVICE names (cuda:0 for cuda)
        rank_dev = "cuda:0" if DEVICE == "cuda" else DEVICE
        two = ("--device", rank_dev)
        # (a) two ranks on one card against 4-member Ensembles in-process
        r = torchrun("[15] (a)", 2, *ens, *two, "--days", str(DP_DAYS),
                     "--output-dir", d("dp2"))
        launches = rank_launches(r.stdout)
        expect = 2 + (DP_DAYS + 1) * nsteps
        model = Model(t30(sppt_on=True), device=DEVICE, bc_arrays=bc)
        end = start
        per = DP_MEMBERS // 2
        for first in (0, per):
            e = Ensemble(model, per, base_seed=first)
            estate, end = e.run_days(e.initialize(start), start, DP_DAYS)
            write_members(model, e, estate, d("ref"), DP_DAYS, start, end,
                          first)
        worst = 0.0
        same = r.returncode == 0
        for m in range(DP_MEMBERS):
            name = f"member{m:03d}"
            if not os.path.isdir(d("dp2", name)):
                same = False
                continue
            s_, w_, _ = nc_diff(d("dp2", name), d("ref", name))
            same &= s_
            worst = max(worst, w_)
        good = (same and worst == 0.0 and "2-process dp mesh" in r.stdout
                and {k: v[0] for k, v in launches.items()}
                == {0: expect, 1: expect})
        ok &= good
        print(f"[15] (a) fp32 T30 SPPT {DP_MEMBERS} members {DP_DAYS} days "
              f"over 2 ranks on {rank_dev} (Gloo): each member's file against "
              f"the unsharded {per}-member Ensemble with the rank's seeds "
              f"(in this process): the same files {same}, largest "
              f"difference {worst:.3e}; K1 launches per rank {launches}, "
              f"expected {expect} each (2 in the boot, {nsteps} in the "
              f"warm-up day before the capture, {nsteps} a replayed day) "
              f"{'ok' if good else 'FAILED'}")
        if not good:
            print(r.stdout[-3000:] + r.stderr[-3000:])
        del model
        # member-days/min of two ranks on one card; one process's is (c)'s
        rates = {}
        rr = torchrun("[15] (a)", 2, *ens, *two, "--days",
                      str(DP_TIMED_DAYS), "--no-output")
        ok &= rr.returncode == 0
        rates["dp=2 (Gloo)"] = rr.stdout

        # (b) fp64, one day, the gathered state against 8 members unsharded
        os.makedirs(d("w"))
        worker = os.path.join("tests", "torch_mesh_worker.py")
        r = torchrun("[15] (b)", 2, worker, d("w"), "--device", rank_dev,
                     "--grid", "t30", "--precision", "fp64", "--members",
                     str(DP_MEMBERS), "--seed", "0", "--days", "1",
                     module=False)
        model = Model(t30(precision="fp64", sppt_on=True), device=DEVICE,
                      bc_arrays=bc)
        e = Ensemble(model, DP_MEMBERS)
        estate, _ = e.run_days(e.initialize(start), start, 1)
        worst, where = 0.0, None
        try:
            got = np.load(d("w", "gathered.npz"))
            for group in ("prog", "surf", "rad"):
                for f, v in getattr(estate, group)._asdict().items():
                    g = got[f"{group}.{f}"]
                    v = v.cpu().numpy()
                    for m in range(DP_MEMBERS):
                        err = float(np.abs(g[m] - v[m]).max()
                                    / max(np.abs(v[m]).max(), 1e-300))
                        if not err <= worst:
                            worst, where = err, f"{group}.{f} member {m}"
            said = [open(d("w", f"rank{k}.txt")).read() for k in (0, 1)]
            tripped = all(x.startswith(
                "Model variables out of accepted range at day 0, member "
                f"{DP_MEMBERS // 2}") for x in said)
        except OSError as exc:
            tripped, worst, where = False, float("inf"), str(exc)
        good = r.returncode != 0 and tripped and worst <= 1e-12
        ok &= good
        print(f"[15] (b) fp64 T30 SPPT {DP_MEMBERS} members 1 day over 2 "
              f"ranks on {rank_dev} (Gloo), the gathered state against the "
              f"unsharded {DP_MEMBERS}-member Ensemble: worst {worst:.3e} "
              f"field-normalised (bound 1e-12) at {where}; a member pushed "
              f"out of range on rank 1 raised on both ranks: {tripped} "
              f"{'ok' if good else 'FAILED'}")
        if not good:
            print(r.stdout[-3000:] + r.stderr[-3000:])
        del model

        # (c) one rank under NCCL against one plain process, whose
        # member-days/min are one process's beside (a)'s two ranks
        r1 = torchrun("[15] (c)", 1, *ens, "--device", DEVICE, "--days",
                      str(DP_TIMED_DAYS), "--output-dir", d("nccl"))
        r2 = program("[15] (c)", *ens, "--device", DEVICE, "--days",
                     str(DP_TIMED_DAYS), "--output-dir", d("plain"))
        same = r1.returncode == 0 and r2.returncode == 0
        worst = 0.0
        for m in range(DP_MEMBERS):
            name = f"member{m:03d}"
            if not (os.path.isdir(d("nccl", name))
                    and os.path.isdir(d("plain", name))):
                same = False
                continue
            s_, w_, _ = nc_diff(d("nccl", name), d("plain", name))
            same &= s_
            worst = max(worst, w_)
        expect = 2 + (DP_TIMED_DAYS + 1) * nsteps
        good = same and worst == 0.0 and "1-process dp mesh" in r1.stdout \
            and rank_launches(r1.stdout).get(0, (0,))[0] == expect
        ok &= good
        print(f"[15] (c) one rank under NCCL against one plain process, "
              f"{DP_MEMBERS} members {DP_TIMED_DAYS} days: the same files "
              f"{same}, largest difference {worst:.3e}; K1 launches "
              f"{rank_launches(r1.stdout)}, expected {expect} "
              f"{'ok' if good else 'FAILED'}")
        if not good:
            print(r1.stdout[-3000:] + r1.stderr[-3000:])
        rates["one rank (NCCL)"] = r1.stdout
        rates["one process"] = r2.stdout
        rates = {k: (member_rate(v), member_rate(v, "replayed"))
                 for k, v in rates.items()}
        ratio = rates["dp=2 (Gloo)"][1] / rates["one process"][1]
        print(f"[15] (a) aggregate member-days/min, {DP_MEMBERS} members "
              f"{DP_TIMED_DAYS} days, fp32 T30 SPPT, over the "
              f"{DP_TIMED_DAYS - 1} replayed days after the first (from the "
              "first rank to begin them to the last to end) and over the "
              "whole wall (initialize and capture included): " + "; ".join(
                  f"{k} {v[1]:.1f} replayed, {v[0]:.1f} whole"
                  for k, v in rates.items())
              + f"; dp=2 / one process, replayed: {ratio:.3f} on {card}")
    print(f"[15] phase time {time.perf_counter() - t_phase:.1f} s")
    return ok


def accumulate_vs_eager(model, start, days=2):
    """The accumulating captured day (run_multiyear's) replayed over
    ``days`` days under the sync debug mode "error" against the same days
    of the eager module-level run_day with its fluxes, on a side stream,
    summed as the day sums them: (equal in every state leaf and sum, what
    differs)."""
    from speedy_tpu_torch.models.captured import (ACC_FLUXES, ACC_GRIDS,
                                                  leaves, step_sum)
    from speedy_tpu_torch.models.model import gridded_fields, run_day
    from speedy_tpu_torch.utils import calendar as cal
    cfg = model.cfg
    state = model.initialize(start)
    cd = model.captured_day(state, accumulate=True)
    cd.load(state)
    cd.set_days(model.make_ds_days(start, start, days)[0])
    cd.reset_accumulators()
    cd.capture()
    with sync_error():
        for day in range(days):
            cd.advance(day)
    acc, _ = cd.accumulated(days)
    replayed = cd.result()
    cur, side = torch.cuda.current_stream(), torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        sums = {k: torch.zeros_like(v) for k, v in cd.acc.items()}
        date, s = start, state
        for _ in range(days):
            s, _, _, fl = run_day(cfg, model.pp, model.lsp, model.mc, s,
                                  model.date_scalars(date, start),
                                  cfg.diag_every, collect_fluxes=True)
            g = gridded_fields(cfg, model.mc, s.prog)
            for k in ACC_GRIDS:
                sums[k].add_(g[k])
            for k in ACC_FLUXES:
                sums[k].add_(step_sum(list(getattr(fl, k))))
            date = cal.next_day(date)
    cur.wait_stream(side)
    torch.cuda.synchronize()
    differ = [f"leaf {i}" for i, (a, b) in enumerate(zip(leaves(replayed),
                                                         leaves(s)))
              if not torch.equal(a, b)]
    differ += [k for k, v in sums.items()
               if not np.array_equal(acc[k], v.cpu().numpy())]
    return not differ, differ


def multiyear_phase(card):
    """[16] run_multiyear over MULTIYEAR_YEARS years with the El Nino run,
    as a user types it: rc 0, both JSON lines, every month finite, one
    host copy a month, the K1 launches, wall and sim-days/min; before it,
    the accumulating day replayed against the eager days (fp32 T30, in
    this process)."""
    from speedy_tpu_torch.config import t30
    from speedy_tpu_torch.models.model import Model
    from speedy_tpu_torch.utils import calendar as cal
    from speedy_tpu_torch.utils.synthetic_bc import synthetic_boundaries

    t_phase = time.perf_counter()
    model = Model(t30(), device=DEVICE, bc_arrays=synthetic_boundaries(0))
    equal, differ = accumulate_vs_eager(model, cal.Datetime(1982, 1, 1))
    print(f"[16] the accumulating day replayed 2 days against the eager "
          f"days (fp32 T30, torch.equal in every state leaf and sum): "
          f"{equal} {differ} {'ok' if equal else 'FAILED'}")
    del model
    ok = equal
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "clim.npz")
        r = program("[16]", "speedy_tpu_torch.run_multiyear", "--years",
                    str(MULTIYEAR_YEARS), "--elnino", "--out", out, *COMMON)
        rows = json_lines(r.stdout)
        olr = [float(x) for x in re.findall(r"done \(olr mean ([^)]+)\)",
                                            r.stdout)]
        n_months = 12 * MULTIYEAR_YEARS * 2
        tail = re.search(r"(\d+) months, (\d+) host copies of the "
                         r"accumulating days, column-physics kernel launches "
                         r"(\d+) \(sw (\d+)\)", r.stdout)
        days = 365 * MULTIYEAR_YEARS
        nsteps = t30().nsteps
        expect = 2 * (2 + (days + 1) * nsteps)
        finite = False
        if os.path.exists(out):
            months = np.load(out, allow_pickle=True)["months"]
            finite = len(months) == n_months // 2 and all(
                np.isfinite(m[k]).all() for m in months
                for k in ("u", "t", "precip", "olr", "tsr", "ssr"))
        good = (r.returncode == 0 and len(rows) == 2
                and rows[0].get("metric") == f"climatology_t30_"
                f"{MULTIYEAR_YEARS}y"
                and rows[1].get("metric") == "elnino_response_DJF"
                and len(olr) == n_months and np.isfinite(olr).all()
                and finite and tail is not None
                and int(tail.group(1)) == n_months
                and int(tail.group(2)) == n_months
                and int(tail.group(3)) == expect)
        ok &= good
        for line in r.stdout.splitlines():
            if not line.startswith("  "):
                print(f"[16] {line}")
        if rows:
            print(f"[16] control run: wall {rows[0].get('wall_s')} s, "
                  f"{rows[0].get('sim_days_per_min')} sim-days/min on {card}")
        print(f"[16] {len(olr)} months printed, finite: "
              f"{bool(olr) and bool(np.isfinite(olr).all())}; saved months "
              f"finite: {finite}; expected {n_months} months, {n_months} "
              f"host copies and {expect} K1 launches "
              f"{'ok' if good else 'FAILED'}")
        if not good:
            print(r.stdout[-3000:] + r.stderr[-3000:])
    print(f"[16] phase time {time.perf_counter() - t_phase:.1f} s")
    return ok


def diag_phase(card):
    """[17] stability_diag at DIAG_PRESET over DIAG_DAYS days in chunks of
    DIAG_CHUNK, as a user types it: rc 0, status clean, the npz arrays
    with the JAX script's shapes, the K1 launches."""
    from speedy_tpu_torch.config import from_preset
    t_phase = time.perf_counter()
    cfg = from_preset(DIAG_PRESET)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "stab.npz")
        r = program("[17]", "speedy_tpu_torch.stability_diag", "--preset",
                    DIAG_PRESET, "--days", str(DIAG_DAYS), "--chunk",
                    str(DIAG_CHUNK), "--out", out, *COMMON)
        rows = json_lines(r.stdout)
        chunks = -(-DIAG_DAYS // DIAG_CHUNK)
        nell = cfg.mx + cfg.nx - 1
        want = dict(days=(chunks + 1,), ke_rot=(chunks + 1, nell, cfg.kx),
                    ke_div=(chunks + 1, nell, cfg.kx),
                    t_var=(chunks + 1, nell, cfg.kx), vor_max=(chunks + 1,),
                    guard=(DIAG_DAYS, 5))
        shapes = {}
        if os.path.exists(out):
            with np.load(out) as f:
                shapes = {k: f[k].shape for k in f.files}
        m = re.search(r"column-physics kernel launches (\d+) \(sw (\d+)\)",
                      r.stdout)
        expect = 2 + (DIAG_DAYS + 1) * cfg.nsteps
        good = (r.returncode == 0 and rows and rows[-1].get("status") ==
                "clean" and shapes == want and m is not None
                and int(m.group(1)) == expect)
        ok = bool(good)
        for x in rows:
            print(f"[17] {json.dumps(x)}")
        print(f"[17] npz shapes {shapes} (the JAX script's {want}); K1 "
              f"launches {m.group(1) if m else '?'}, expected {expect} (2 in "
              f"the boot, {cfg.nsteps} in the warm-up day, {cfg.nsteps} a "
              f"replayed day) on {card} {'ok' if ok else 'FAILED'}")
        if not ok:
            print(r.stdout[-3000:] + r.stderr[-3000:])
    print(f"[17] phase time {time.perf_counter() - t_phase:.1f} s")
    return ok


def band_inputs(ins, rows):
    """K1's inputs (fused.kernel_inputs order) cut to the latitude rows
    ``rows``: the [il] fields sliced, ablco2 as it is, the others on
    their latitude axis, contiguous."""
    from speedy_tpu_torch.models.physics import fused
    return [x if i == 22 else x[rows].contiguous()
            if i in fused.LAT_INPUTS
            else x[..., rows, :].contiguous() for i, x in enumerate(ins)]


def k1_band_phase(bc):
    """[18] (c) K1 at band shapes against its plain chain on the card."""
    from speedy_tpu_torch.config import from_preset
    from speedy_tpu_torch.models.model import Model
    from speedy_tpu_torch.models.physics import fused
    ok = True
    for preset, band_rows in SP_K1_BANDS:
        for prec in ("fp64", "fp32"):
            m = Model(from_preset(preset, precision=prec), device="cuda",
                      bc_arrays=bc)
            cfg = m.cfg
            bound = bench_physics.error_bound(cfg.rdtype)
            for sw in (True, False):
                booted_ins, block = bench_physics.physics_case(m, sw)
                full = bench_physics.perturb(booted_ins)
                for n in band_rows:
                    rows = slice(cfg.il - n, cfg.il)
                    ins = band_inputs(full, rows)
                    kout = fused.launch_kernel(cfg, sw, ins, block)
                    pout = fused.plain_outputs(cfg, m.pp, sw, ins)
                    torch.cuda.synchronize()
                    errs = field_errors(kout, pout)
                    worst = max(e[0] for e in errs)
                    good = worst <= bound and all(
                        bool(torch.isfinite(k).all()) for k in kout) \
                        and tuple(kout[4].shape) == (n, cfg.ix)
                    ok &= good
                    us = time_graph_ms(lambda: fused.launch_kernel(
                        cfg, sw, ins, block), N_TIMED) * 1e3
                    print(f"[18] (c) K1 {preset} {prec} "
                          f"{'sw' if sw else 'nosw'} rows {rows.start}.."
                          f"{rows.stop - 1} ({n} x {cfg.ix} columns): worst "
                          f"{worst:.3e} (bound {bound:.0e}), max abs "
                          f"{max(e[1] for e in errs):.3e}, {us:.3f} us/call "
                          f"(graph) {'ok' if good else 'FAILED'}")
            del m
    return ok


def sp_gloo_phase(bc, d, card):
    """[18] (a) dp=1 x sp=2 over two ranks sharing cuda:0 (Gloo)."""
    from speedy_tpu_torch.config import from_preset, t30
    from speedy_tpu_torch.models.model import Model, one_step
    from speedy_tpu_torch.parallel.ensemble import Ensemble
    from speedy_tpu_torch.utils import calendar as cal
    start = cal.Datetime(1982, 1, 1)
    worker = os.path.join("tests", "torch_mesh_worker.py")
    ok = True

    def compare(out, estate, members):
        got = np.load(os.path.join(out, "gathered.npz"))
        worst, where = 0.0, None
        for group in ("prog", "surf", "rad"):
            for f, v in getattr(estate, group)._asdict().items():
                v = v.cpu().numpy()
                for m in range(members):
                    err = float(np.abs(got[f"{group}.{f}"][m] - v[m]).max()
                                / max(np.abs(v[m]).max(), 1e-300))
                    if not err <= worst:
                        worst, where = err, f"{group}.{f} member {m}"
        specs = [np.load(os.path.join(out, f"spec{k}.npz")) for k in (0, 1)]
        same = all(np.array_equal(specs[0][f], specs[1][f])
                   for f in specs[0].files)
        runs = [json.load(open(os.path.join(out, f"run{k}.json")))
                for k in (0, 1)]
        return worst, where, same, runs

    os.makedirs(d("day"))
    r = torchrun("[18] (a)", 2, worker, d("day"), "--device", "cuda:0",
                 "--grid", "t30", "--precision", "fp64", "--sp", "2",
                 "--members", str(SP_MEMBERS), "--seed", "0", "--no-trip",
                 module=False)
    model = Model(t30(precision="fp64", sppt_on=True), device="cuda",
                  bc_arrays=bc)
    e = Ensemble(model, SP_MEMBERS)
    estate, _ = e.run_days(e.initialize(start), start, 1)
    try:
        worst, where, same, runs = compare(d("day"), estate, SP_MEMBERS)
    except OSError as exc:
        worst, where, same, runs = float("inf"), str(exc), False, []
    good = r.returncode == 0 and worst <= 1e-12 and same \
        and len(runs) == 2 and not any(x["captured"] for x in runs)
    ok &= good
    nsteps = model.cfg.nsteps
    print(f"[18] (a) fp64 T30 SPPT {SP_MEMBERS} members 1 day, dp=1 x sp=2 "
          f"over 2 ranks on cuda:0 (Gloo), against the unsharded "
          f"{SP_MEMBERS}-member Ensemble in this process: worst {worst:.3e} "
          f"field-normalised (bound 1e-12) at {where}; spectral leaves "
          f"equal across the ranks {same}; day captured "
          f"{[x['captured'] for x in runs]} (Gloo: eager) "
          f"{'ok' if good else 'FAILED'}")
    for k, x in enumerate(runs):
        print(f"[18] (a) rank {k}: K1 launches {x['launches']} (sw "
              f"{x['launches_sw']}; 2 in the boot, {nsteps} a day), "
              f"all-reduces {x['allreduces']} ({2 * nsteps + 2} a day), "
              f"the eager day {x['seconds']:.3f} s: "
              f"{SP_MEMBERS * 60.0 / x['seconds']:.1f} member-days/min on "
              f"{card} (for the record: two processes time-slice the card)")
    if not good:
        print(r.stdout[-3000:] + r.stderr[-3000:])
    del model, e, estate
    # the presets' steps check values only: their launches run together
    from concurrent.futures import ThreadPoolExecutor
    for preset in SP_STEP_PRESETS:
        os.makedirs(d(preset))
    with ThreadPoolExecutor(len(SP_STEP_PRESETS)) as pool:
        launched = {preset: pool.submit(
            torchrun, "[18] (a)", 2, worker, d(preset), "--device", "cuda:0",
            "--grid", preset, "--precision", "fp64", "--sp", "2",
            "--members", "1", "--no-sppt", "--steps", "1", "--no-trip",
            module=False) for preset in SP_STEP_PRESETS}
    for preset in SP_STEP_PRESETS:
        out, r = d(preset), launched[preset].result()
        model = Model(from_preset(preset, precision="fp64"), device="cuda",
                      bc_arrays=bc)
        e = Ensemble(model, 1, base_seed=5)
        estate = e.initialize(start)
        daily = model.daily_forcing(estate, start, start)
        estate, _ = one_step(model.cfg, model.pp, model.lsp, model.mc,
                             estate, daily, compute_sw=True)
        try:
            worst, where, same, runs = compare(out, estate, 1)
        except OSError as exc:
            worst, where, same, runs = float("inf"), str(exc), False, []
        good = r.returncode == 0 and worst <= 1e-12 and same
        ok &= good
        print(f"[18] (a) fp64 {preset} boot + one step, dp=1 x sp=2 on "
              f"cuda:0 (Gloo) against the unsharded step: worst {worst:.3e} "
              f"(bound 1e-12) at {where}; spectral leaves equal {same}; K1 "
              f"launches per rank {[x['launches'] for x in runs]} "
              f"{'ok' if good else 'FAILED'}")
        if not good:
            print(r.stdout[-3000:] + r.stderr[-3000:])
        del model, e, estate
    return ok


def sp_nccl_phase(bc, card):
    """[18] (b) one rank under NCCL with an sp group of one rank, in this
    process: the band's day captured with its all-reduces."""
    import dataclasses
    import socket
    import torch.distributed as dist
    from speedy_tpu_torch.config import t30
    from speedy_tpu_torch.models.captured import leaves
    from speedy_tpu_torch.models.model import Model
    from speedy_tpu_torch.parallel.ensemble import Ensemble
    from speedy_tpu_torch.parallel.mesh import make_mesh, new_group
    from speedy_tpu_torch.utils import calendar as cal
    start = cal.Datetime(1982, 1, 1)
    with socket.socket() as s_:
        s_.bind(("localhost", 0))
        port = s_.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    ok = True
    try:
        mesh = make_mesh(1, 1, device="cuda:0")
        mesh = dataclasses.replace(mesh, sp_group=new_group([0],
                                                            mesh.device))
        model = Model(t30(precision="fp64", sppt_on=True),
                      device=mesh.device, bc_arrays=bc)
        band = model.for_band(mesh)
        state, noise, _ = booted(model, start)
        equal = lambda a, b: all(torch.equal(x, y) for x, y in
                                 zip(leaves(a), leaves(b), strict=True))
        cd, capture_s, _ = capture_day(band, state, start)
        reset()
        with sync_error():
            cd.advance(0, noise)
        torch.cuda.synchronize()
        per_day = (counters["spectral.allreduces"], counters["k1.launches"])
        replayed = cd.result()
        eager = side_eager_day(band, state, start, noise)[0]
        plain_cd, _, _ = capture_day(model, state, start)
        plain_cd.advance(0, noise)
        plain_replayed = plain_cd.result()
        plain_eager = side_eager_day(model, state, start, noise)[0]
        _, kernels, _ = trace(lambda: cd.advance(0, noise))
        names = [n for n, _ in kernels]
        n_nccl = sum(1 for n in names if "nccl" in n.lower())
        n_k1 = sum(1 for n in names if "column_physics" in n)
        eq = (equal(replayed, eager), equal(replayed, plain_replayed),
              equal(eager, plain_eager))
        nsteps = model.cfg.nsteps
        good = cd.captured and cd.graph is not None and all(eq) \
            and per_day == (2 * nsteps + 2, nsteps) \
            and cd.counts["spectral.allreduces"] == 2 * nsteps + 2 \
            and n_k1 == nsteps
        ok &= good
        print(f"[18] (b) fp64 T30 SPPT, one NCCL rank, an sp group of one "
              f"rank (rows 0..{model.cfg.il - 1}): the day captured "
              f"{cd.captured} ({capture_s:.3f} s, warm-up day included) with "
              f"{cd.counts['spectral.allreduces']} all-reduces in the graph; "
              "a replayed day "
              f"counts {per_day[0]} all-reduces and {per_day[1]} K1 "
              f"launches (expected {2 * nsteps + 2} and {nsteps}); replay "
              f"== the band's eager day {eq[0]}, == the unsharded replayed "
              f"day {eq[1]}; band eager == unsharded eager {eq[2]}; a "
              f"profiler trace of one replayed day: {n_nccl} NCCL kernels, "
              f"{n_k1} K1 kernels, {len(names)} kernels "
              f"{'ok' if good else 'FAILED'}")
        del model, band, cd, plain_cd
        # fp32, 8 members, SPPT on: member-days/min, band and unsharded
        model = Model(t30(sppt_on=True), device=mesh.device, bc_arrays=bc)
        ensembles = {"band (NCCL)": Ensemble(model, SP_NCCL_MEMBERS,
                                             mesh=mesh),
                     "unsharded": Ensemble(model, SP_NCCL_MEMBERS)}
        states = {k: e.initialize(start) for k, e in ensembles.items()}
        for k, e in ensembles.items():      # warm-up day and capture
            e.run_days(states[k], start, 1)
        rates = {k: [] for k in ensembles}
        launches = {}
        for k in list(ensembles) + list(ensembles)[::-1]:
            reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            final, _ = ensembles[k].run_days(states[k], start,
                                             SP_NCCL_DAYS)
            torch.cuda.synchronize()
            rates[k].append(SP_NCCL_MEMBERS * SP_NCCL_DAYS * 60.0
                            / (time.perf_counter() - t0))
            launches[k] = counters["k1.launches"]
            finite = all(bool(torch.isfinite(x).all()) for x in final.prog)
            ok &= finite and counters["k1.launches"] == SP_NCCL_DAYS * nsteps
        print(f"[18] (b) fp32 T30 SPPT {SP_NCCL_MEMBERS} members "
              f"{SP_NCCL_DAYS} replayed days (after a warm-up day and the "
              f"capture), in turns: member-days/min " + "; ".join(
                  f"{k} " + " / ".join(f"{v:.1f}" for v in rs)
                  for k, rs in rates.items())
              + f"; K1 launches {launches} (expected "
              f"{SP_NCCL_DAYS * nsteps} each) on {card}")
    finally:
        dist.destroy_process_group()
    return ok


def sp_phase(bc, card):
    """[18] The sp axis on one card: (c), (a), (b), (d)."""
    t_phase = time.perf_counter()
    ok = k1_band_phase(bc)
    with tempfile.TemporaryDirectory() as tmp:
        ok &= sp_gloo_phase(bc, lambda *p: os.path.join(tmp, *p), card)
    ok &= sp_nccl_phase(bc, card)
    r = program("[18] (d)", "speedy_tpu_torch.bench_scaling", "--mode",
                "sp", "--counts", "1,2", "--reps", "1")
    lines = json_lines(r.stdout)
    ok &= r.returncode == 0 and len(lines) == 2
    for rec in lines:
        print("[18] (d) " + json.dumps(rec))
    print("[18] (d) count 2 is two ranks over Gloo time-slicing one card "
          "(eager days, the all-reduces staged through host copies): it "
          f"measures nothing of NVLink; on {card}")
    print(f"[18] phase time {time.perf_counter() - t_phase:.1f} s")
    return ok


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
    from speedy_tpu_torch.ops import fused_transforms as ft
    from speedy_tpu_torch.utils import calendar as cal, native
    from speedy_tpu_torch.utils.synthetic_bc import synthetic_boundaries

    # [2] build, one nvcc per source, all at once
    libs = {"column_physics": (fused.SOURCES, fused.NVCC_FLAGS),
            "spectral_transforms": (ft.SOURCES, ())}
    t0 = time.perf_counter()
    native.build_all(libs)
    print(f"[2] built {', '.join(libs)} in {time.perf_counter() - t0:.1f} s "
          "(nvcc " + ", ".join(f"{n} {native.build_seconds.get(n, 0.0):.1f} s"
                               for n in libs)
          + "; column_physics with both LW orders, 48 kernels)")
    for line in ptxas_summary(native.build_log.get("spectral_transforms",
                                                    "")):
        print("    ptxas:", line)

    bc = synthetic_boundaries(0)

    # [3] kernel vs plain on the card at bench_physics.K1_PRESETS (kx=8)
    for line in ptxas_summary(native.build_log.get("column_physics", "")):
        print("[3] ptxas:", line)
    print(f"[3] one trivial launch (1-element add), graph replay: "
          f"{bench_physics.floor_ms(N_TIMED) * 1e3:.3f} us/call")
    rows = {}
    ok = True
    t_phase = time.perf_counter()
    for rec in bench_physics.run():
        preset, prec = rec["preset"], rec["precision"]
        variant, order = rec["variant"], rec["order"]
        for r in rec["checks"]:
            per = "" if preset != "t30" else " | " + " ".join(
                f"{n}={e[0]:.1e}" for n, e in zip(OUTPUT_NAMES, r["errors"]))
            print(f"[3] {preset} {prec} {variant} {order} {r['case']} "
                  f"({r['convecting']} convecting columns): worst "
                  f"{r['worst']:.3e} (bound {rec['bound']:.0e}) "
                  f"finite={r['finite']}{per}")
            for v, name, (j, i) in r["columns"]:
                print(f"    column lat={j} lon={i}: {name} {v:.3e}")
        ok &= bench_physics.passed(rec)
        differs = "" if order == "vec" else (
            f", differs from the vec kernel: {rec['differs_from_vec']}")
        print(f"[3] {preset} {prec} {variant} {order}{differs}: kernel "
              f"{rec['kernel_graph_us']:.3f} us/call (graph), "
              f"{rec['kernel_eager_us']:.1f} us/call (eager), plain "
              f"{rec['plain_us'] * 1e-3:.3f} ms/call, bound "
              f"{rec['bound_us']:.3f} us ({rec['bound_by']}), share of the "
              f"bound {rec['share']:.1%}")
        rows[(preset, prec, variant, order)] = dict(
            ms=rec["kernel_graph_us"] * 1e-3, plain_ms=rec["plain_us"] * 1e-3,
            bound_ms=rec["bound_us"] * 1e-3, bound_by=rec["bound_by"],
            max_abs_err=rec["max_abs_err"])
    # the reference-order kernel with members
    for prec in ("fp64", "fp32"):
        m = Model(t30(precision=prec), device="cuda", bc_arrays=bc)
        for sw in (True, False):
            _, _, rec = bench_physics.check_members(
                m, sw, REFLW_MEMBERS, bench_physics.with_order(m.cfg, "ref"))
            rec.update(bound=bench_physics.error_bound(m.cfg.rdtype),
                       precision=prec)
            good = bench_physics.passed(rec)
            ok &= good
            print(f"[3] t30 {prec} {'sw' if sw else 'nosw'} ref "
                  f"{REFLW_MEMBERS} members: worst {rec['worst']:.3e} (bound "
                  f"{rec['bound']:.0e}) finite={rec['finite']} members equal "
                  f"one-member launches={rec['members_equal_single']} "
                  f"{'ok' if good else 'FAILED'}")
    print(f"[3] phase time {time.perf_counter() - t_phase:.1f} s")
    if not ok:
        print("[3] FAILED: kernel disagrees with the plain chain")
        return 1

    # [4] CPU vs CUDA, boot + 6 steps, fp64
    start = cal.Datetime(1982, 1, 1)
    worst = steps_cpu_vs_cuda(t30(precision="fp64"), bc, start)
    step_ok = max(worst.values()) <= STEP_BOUND
    print(f"[4] fp64 boot+6 steps CPU vs CUDA: "
          + " ".join(f"{k}={v:.2e}" for k, v in worst.items())
          + f" (bound {STEP_BOUND:.0e}) {'ok' if step_ok else 'FAILED'}")
    if not step_ok:
        return 1

    # [5] the main path: fp32 T30, the day captured first, then
    # initialize + 2 days with the guard, each day one replay
    model = Model(t30(), device="cuda", bc_arrays=bc)
    _, capture_s, pool = capture_day(model, model.initialize(start), start)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = model.initialize(start)
    t1 = time.perf_counter()
    state = model.run_fast(start, 2, state=state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n_launch = counters["k1.launches"]
    n_launch_sw = counters["k1.launches_sw"]
    expect = 2 + 2 * model.cfg.nsteps
    finite = all(bool(torch.isfinite(x).all()) for x in state.prog)
    days_per_min = 2 / ((t2 - t1) / 60.0)
    print(f"[5] fp32 T30 2 days: {days_per_min:.1f} sim-days/min "
          f"(run_fast {t2 - t1:.3f} s, initialize {t1 - t0:.3f} s; warm-up "
          f"day and capture before them {capture_s:.3f} s, graph pool "
          f"{pool / 2**20:.1f} MiB) on {card}; kernel launches {n_launch} (sw "
          f"{n_launch_sw}), expected {expect} (2 in the boot, "
          f"{model.cfg.nsteps} a replayed day); finite={finite}")
    if n_launch != expect or not finite:
        print("[5] FAILED")
        return 1

    # [6] the transform benchmark's path, then the kernels against the
    # einsum chain at every shape it ran and more
    b_ok, bench, n_syn, n_ana = bench_path(reps=N_TIMED)
    t_ok, t_rows = transform_phase(bench)
    if not (t_ok and b_ok):
        print("[6] FAILED")
        return 1

    # [7] SPPT, [8] the run path
    if not sppt_phase(bc, start, card):
        print("[7] FAILED")
        return 1
    if not run_phase(bc, start):
        print("[8] FAILED")
        return 1
    e_ok, e_rows, (n_m64, n_m64_sw) = ensemble_phase(bc, start, card)
    if not e_ok:
        print("[9] FAILED")
        return 1
    if not capture_phase(bc, start, card):
        print("[10] FAILED")
        return 1
    c_ok, (n_ref, n_ref_sw) = configuration_phase(bc, card)
    if not c_ok:
        print("[11] FAILED")
        return 1
    if not presets_phase(bc, card):
        print("[12] FAILED")
        return 1
    if not cli_phase(bc, card):
        print("[13] FAILED")
        return 1
    if not validation_phase(card):
        print("[14] FAILED")
        return 1
    if not dp_phase(bc, card):
        print("[15] FAILED")
        return 1
    if not multiyear_phase(card):
        print("[16] FAILED")
        return 1
    if not diag_phase(card):
        print("[17] FAILED")
        return 1
    if not sp_phase(bc, card):
        print("[18] FAILED")
        return 1

    kernels = []
    for variant, order, launches in (
            ("sw", "vec", n_launch_sw),
            ("nosw", "vec", n_launch - n_launch_sw),
            ("sw", "ref", n_ref_sw), ("nosw", "ref", n_ref - n_ref_sw)):
        r = rows[("t30", "fp32", variant, order)]
        suffix = "_reflw" if order == "ref" else ""
        kernels.append(dict(
            name=f"column_physics_{variant}{suffix}", route="cuda",
            source="speedy_tpu_torch/csrc/column_physics.cu",
            replaces="speedy_tpu/models/physics/fused.py:87",
            launches=launches, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None))
    for variant, launches in (("sw", n_m64_sw), ("nosw", n_m64 - n_m64_sw)):
        r = e_rows[variant]
        kernels.append(dict(
            name=f"column_physics_{variant}_m64", route="cuda",
            source="speedy_tpu_torch/csrc/column_physics.cu",
            replaces="speedy_tpu/models/physics/fused.py:87",
            launches=launches, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None))
    for name, b, launches, line in (
            ("spectral_synthesis", 57, n_syn, 139),
            ("spectral_analysis", 48, n_ana, 155)):
        r = t_rows[(name, "t30", "fp32", b)]
        kernels.append(dict(
            name=name, route="cuda",
            source="speedy_tpu_torch/csrc/spectral_transforms.cu",
            replaces=f"speedy_tpu/ops/pallas_transforms.py:{line}",
            launches=launches, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
