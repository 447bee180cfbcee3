"""The port on the card (marked ``gpu``; every test skips without a CUDA
device): the one suite of checks that runs there. This file and its case
module (tests/torch_gpu_cases.py) import neither JAX nor speedy_tpu, so
it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

In order: the column-physics kernel K1 (both LW orders, every built level
count and preset, members as extra columns, band shapes) against its
plain PyTorch chain on the same CUDA tensors (field-normalised error,
fp64 <= 1e-12, fp32 <= 1e-4), its launch plan and its refusal of bad
inputs; the spectral-update kernel against its plain twin (torch.equal in
fp32 and fp64, strided tendencies, members), its refusal of bad inputs,
its one launch a replayed step and a boot and day through it equal to the
twin's; the spectral-transform kernels K2a/K2b against their einsum chain
(fp64 <= 1e-12, fp32 <= 1e-5) at every preset, batch class and built
tile; the CUDA model against the CPU model after boot + 6 fp64 steps
(<= 1e-10), and a replayed day's K1 launches at every preset and member
count; the captured day against the eager run_day (torch.equal), its
output variants, its kernels in a profiler trace, and the run paths
under the sync debug mode "error"; Model.run's writer, checkpoints and
debug_nans; the dp and sp axes (Gloo ranks sharing the card, one NCCL
rank with its all-reduces in the graph); and the programs' long runs
through their ``python -m`` entries (the stability gate at every preset,
a climatology year, the fp32 qualification, run_multiyear, stability_diag
at T85).
"""
import ctypes
import json
import os
import re

import numpy as np
import pytest
import torch

from speedy_tpu_torch import bench_physics as bp
from speedy_tpu_torch.config import from_preset, t30
from speedy_tpu_torch.geometry import build_geometry_np
from speedy_tpu_torch.models.captured import leaves
from speedy_tpu_torch.models import time_stepping as ts
from speedy_tpu_torch.models.model import Model, one_step
from speedy_tpu_torch.models.physics import fused
from speedy_tpu_torch.ops import fused_transforms as ft
from speedy_tpu_torch.ops import spectral as sp
from speedy_tpu_torch.parallel.ensemble import Ensemble
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils.synthetic_bc import synthetic_boundaries
from speedy_tpu_torch.utils.tracing import counters, reset
from torch_gpu_cases import (TRANSFORM_BOUND, accumulate_vs_eager,
                             band_inputs, booted, capture_day, json_lines,
                             k1_in_trace, program, replay_vs_eager,
                             side_eager_day, sppt_noise, sst_replay_vs_eager,
                             sync_error, trace, update_case)
from torch_run_checks import expected_calls, fetch_bytes, run_against_buffer

START = cal.Datetime(1982, 1, 1)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def bc():
    return synthetic_boundaries(0)


K1_GRIDS = [("t30", 5), ("t30", 7), ("t30", 8), ("t63", 8), ("t85", 8),
            ("t170", 8)]


@pytest.mark.parametrize("preset,kx", K1_GRIDS)
@pytest.mark.parametrize("precision", ["fp64", "fp32"])
def test_kernel_matches_plain_chain(cuda, bc, preset, kx, precision):
    bound = bp.FP64_BOUND if precision == "fp64" else bp.FP32_BOUND
    m = Model(from_preset(preset, precision=precision, kx=kx), device="cuda",
              bc_arrays=bc)
    for sw in (True, False):
        booted, block = bp.physics_case(m, sw)
        for ins in (booted, bp.perturb(booted)):
            kout = fused.launch_kernel(m.cfg, sw, ins, block)
            pout = fused.plain_outputs(m.cfg, m.pp, sw, ins)
            errs = bp.field_errors(kout, pout)
            for name, (e, _) in zip(bp.OUTPUT_NAMES, errs):
                assert e <= bound, (sw, name, e)


@pytest.mark.parametrize("preset,kx", K1_GRIDS[:3] + K1_GRIDS[4:])
@pytest.mark.parametrize("precision", ["fp64", "fp32"])
def test_reference_lw_kernel_matches_plain_chain(cuda, bc, preset, kx,
                                                 precision):
    """The reference-order kernel against its plain chain (the same LW
    order), and in fp32 not equal to the default order's kernel."""
    bound = bp.FP64_BOUND if precision == "fp64" else bp.FP32_BOUND
    m = Model(from_preset(preset, precision=precision, kx=kx,
                          lw_band_vectorized=False), device="cuda",
              bc_arrays=bc)
    vec = bp.with_order(m.cfg, "vec")
    for sw in (True, False):
        booted, block = bp.physics_case(m, sw)
        ins = bp.perturb(booted)
        kout = fused.launch_kernel(m.cfg, sw, ins, block)
        pout = fused.plain_outputs(m.cfg, m.pp, sw, ins)
        for name, (e, _) in zip(bp.OUTPUT_NAMES, bp.field_errors(kout, pout)):
            assert e <= bound, (sw, name, e)
        if precision == "fp32":
            vout = fused.launch_kernel(vec, sw, ins, block)
            assert any(not torch.equal(a, b) for a, b in zip(kout, vout))


@pytest.mark.parametrize("members", [1, 8])
@pytest.mark.parametrize("precision", ["fp64", "fp32"])
def test_reference_lw_kernel_with_members(cuda, bc, members, precision):
    m = Model(t30(precision=precision, lw_band_vectorized=False),
              device="cuda", bc_arrays=bc)
    for sw in (True, False):
        _, _, rec = bp.check_members(m, sw, members)
        rec["bound"] = bp.error_bound(m.cfg.rdtype)
        assert bp.passed(rec), (sw, rec)


@pytest.mark.parametrize("case", ["dtype", "shape", "cpu", "count"])
def test_reference_lw_kernel_refuses_bad_input(cuda, bc, case):
    m = Model(t30(lw_band_vectorized=False), device="cuda", bc_arrays=bc)
    ins, block = bp.physics_case(m, False)
    ins = list(ins)
    if case == "dtype":
        ins[2] = ins[2].half()
    elif case == "shape":
        ins[3] = ins[3][:-1]
    elif case == "cpu":
        ins[24] = ins[24].cpu()
    else:
        ins.pop()
    reset()
    with pytest.raises(ValueError):
        fused.launch_kernel(m.cfg, False, ins, block)
    assert counters["k1.launches"] == counters["k1.launches_reflw"] == 0


def test_reference_lw_main_path_launches(cuda, bc):
    """Every K1 launch of a reference-order run is counted as one, in the
    boot and in each replayed day."""
    m = Model(t30(lw_band_vectorized=False), device="cuda", bc_arrays=bc)
    capture_day(m, m.initialize(START), START)
    reset()
    m.run_fast(START, 1)
    nsteps, nstrad = m.cfg.nsteps, m.cfg.nstrad
    assert counters["k1.launches"] == counters["k1.launches_reflw"] \
        == 2 + nsteps
    assert counters["k1.launches_sw"] == counters["k1.launches_reflw_sw"] \
        == 2 + nsteps // nstrad


def test_sst_anomaly_replay_across_month_start(cuda):
    """An fp32 SST-anomaly run from 1982-01-30 over 4 days: replayed equal
    to the eager days, the window shifted at 1982-02-01 in both."""
    m = Model(t30(sst_anomaly_forcing=True), device="cuda",
              bc_arrays=synthetic_boundaries(0, anomaly=True))
    differ, shifted, end, _ = sst_replay_vs_eager(
        m, cal.Datetime(1982, 1, 30), 4)
    assert not differ and shifted
    assert end == cal.Datetime(1982, 2, 3)


def test_t85_day_launches_once_per_step(cuda, bc):
    m = Model(from_preset("t85"), device="cuda", bc_arrays=bc)
    state = m.initialize(START)
    capture_day(m, state, START)
    reset()
    out = m.run_fast(START, 1, state=state)
    assert counters["k1.launches"] == m.cfg.nsteps == 96
    assert counters["k1.launches_sw"] == m.cfg.nsteps // m.cfg.nstrad
    assert bool(torch.isfinite(out.prog.vor).all())


@pytest.mark.parametrize("preset", ["t42", "t63", "t170"])
def test_preset_day_launches_once_per_step(cuda, bc, preset):
    """A replayed fp32 day of each other preset in the guard: one K1
    launch a step, every prognostic field finite."""
    m = Model(from_preset(preset), device="cuda", bc_arrays=bc)
    state = m.initialize(START)
    capture_day(m, state, START)
    reset()
    out = m.run_fast(START, 1, state=state)
    assert counters["k1.launches"] == m.cfg.nsteps
    assert counters["k1.launches_sw"] == m.cfg.nsteps // m.cfg.nstrad
    assert all(bool(torch.isfinite(x).all()) for x in out.prog)


@pytest.mark.parametrize("preset", ["t30", "t42", "t63", "t85", "t170"])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_k1_layout_matches_kernel(cuda, preset, itemsize):
    """The wrapper's plan is the launch the kernel makes, for every built
    kx and both variants."""
    cfg = from_preset(preset)
    layout = fused.library().column_physics_layout
    for kx in (5, 7, 8):
        for sw in (True, False):
            got = [ctypes.c_int() for _ in range(4)]
            assert layout(int(itemsize == 8), kx, int(sw), cfg.il, cfg.ix,
                          *map(ctypes.byref, got)) == 0
            assert tuple(v.value for v in got) == fused.block_plan(
                kx, cfg.il, cfg.ix, itemsize, sw)


@pytest.mark.parametrize("case", ["dtype", "mixed", "shape",
                                  "noncontiguous", "cpu", "count"])
def test_k1_refuses_bad_input(cuda, bc, case):
    m = Model(t30(), device="cuda", bc_arrays=bc)
    ins, block = bp.physics_case(m, True)
    ins = list(ins)
    if case == "dtype":
        ins[2] = ins[2].half()
    elif case == "mixed":
        ins[5] = ins[5].double()
    elif case == "shape":
        ins[3] = ins[3][:-1]
    elif case == "noncontiguous":
        ins[4] = ins[4].transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "cpu":
        ins[6] = ins[6].cpu()
    else:
        ins.append(ins[5])
    reset()
    with pytest.raises(ValueError):
        fused.launch_kernel(m.cfg, True, ins, block)
    assert counters["k1.launches"] == 0


# ---------------------------------------------------------------------------
# the spectral-update kernel
# ---------------------------------------------------------------------------

UPDATE_GRIDS = {"t30": ("t30", {}), "t170": ("t170", {}),
                "t21_kx5": ("t30", dict(trunc=21, ix=64, il=32, kx=5))}


def update_kernel_name(name):
    return "spectral_step_elementwise_kernel" in name


@pytest.mark.parametrize("grid,members", [("t30", None), ("t30", 64),
                                          ("t170", None), ("t21_kx5", None)])
@pytest.mark.parametrize("precision", ["fp64", "fp32"])
def test_spectral_update_kernel_equals_twin(cuda, grid, members, precision):
    """One launch, torch.equal to the plain twin on the same CUDA tensors
    (the tendencies strided as the step leaves them), for the boot's
    forward step (j1=1, eps=0) and the filtered leapfrog (j1=2, rob)."""
    preset, kw = UPDATE_GRIDS[grid]
    cfg = from_preset(preset, precision=precision, **kw)
    sc, dc, ic, state, tend, corr = update_case(cfg, members, "cuda")
    for j1, eps in ((1, 0.0), (2, cfg.rob)):
        reset()
        got = ts.launch_update(cfg, sc, dc, ic, state, tend, corr, j1,
                               2 * cfg.delt, eps)
        want = ts.spectral_update_plain(cfg, sc, dc, ic, state, tend, corr,
                                        j1, 2 * cfg.delt, eps)
        torch.cuda.synchronize()
        assert counters["step.update_launches"] == 1
        for f, a, b in zip(got._fields, got, want):
            assert a.shape == b.shape and a.is_contiguous(), f
            assert torch.equal(a, b), (j1, f, (a - b).abs().max().item())


@pytest.mark.parametrize("case", ["dtype", "mixed", "shape", "members",
                                  "table", "cpu", "j1"])
def test_spectral_update_kernel_refuses_bad_input(cuda, case):
    cfg = t30()
    sc, dc, ic, state, tend, corr = update_case(cfg, 4, "cuda")
    tend, j1 = list(tend), 2
    if case == "dtype":
        state = state._replace(vor=state.vor.half())
    elif case == "mixed":
        tend[2] = tend[2].double()
    elif case == "shape":
        tend[1] = tend[1][..., :-1, :, :]
    elif case == "members":
        tend[0] = tend[0][:2]
    elif case == "table":
        dc = dc._replace(dmp=dc.dmp.t().contiguous().t())
    elif case == "cpu":
        corr = corr._replace(qcorh=corr.qcorh.cpu())
    else:
        j1 = 3
    reset()
    with pytest.raises(ValueError):
        ts.launch_update(cfg, sc, dc, ic, state, tuple(tend), corr, j1,
                         2 * cfg.delt, cfg.rob)
    assert counters["step.update_launches"] == 0


def test_replayed_day_holds_one_update_a_step(cuda, bc):
    """A replayed T30 day: the counter and the profiler both see one
    update launch a step, and the step has at most 370 kernels."""
    m = Model(t30(), device="cuda", bc_arrays=bc)
    cd, _, _ = capture_day(m, m.initialize(START), START)
    nsteps = m.cfg.nsteps
    assert cd.counts["step.update_launches"] == nsteps
    reset()
    names = [n for n, _ in trace(lambda: cd.advance(0))[1]
             if not n.startswith(("Memcpy", "Memset"))]
    assert counters["step.update_launches"] == nsteps
    assert sum(map(update_kernel_name, names)) == nsteps
    assert len(names) <= 370 * nsteps, len(names) / nsteps


@pytest.mark.parametrize("precision", ["fp32", "fp64"])
def test_kernel_boot_and_day_equal_the_twins(cuda, bc, precision,
                                             monkeypatch):
    """The boot and a replayed day through the kernel equal, bit for bit,
    the boot and the eager day with the step's update in the plain twin
    (the code before the kernel)."""
    m = Model(t30(precision=precision), device="cuda", bc_arrays=bc)
    reset()
    state = m.initialize(START)
    assert counters["step.update_launches"] == 2
    fast = m.run_fast(START, 1, state=state)
    monkeypatch.setattr(ts, "spectral_update", ts.spectral_update_plain)
    reset()
    twin = m.initialize(START)
    assert counters["step.update_launches"] == 0
    assert all(torch.equal(a, b) for a, b in zip(leaves(state),
                                                 leaves(twin)))
    twin, _ = m.run_day(twin, START, START)
    differ = [i for i, (a, b) in enumerate(zip(leaves(fast), leaves(twin)))
              if not torch.equal(a, b)]
    assert not differ, differ


def spectral_case(preset, precision, batch):
    cfg = from_preset(preset, precision=precision)
    sc = sp.build_spectral(cfg, build_geometry_np(cfg), "cuda")
    rng = np.random.default_rng(batch)
    spec = torch.as_tensor(rng.standard_normal((batch, cfg.mx, cfg.nx, 2)),
                           dtype=cfg.rdtype, device="cuda")
    grid = torch.as_tensor(rng.standard_normal((batch, cfg.il, cfg.ix)),
                           dtype=cfg.rdtype, device="cuda")
    return cfg, sc, spec, grid


# the step's batches (25/48 analysis, 34/57 synthesis), ragged and large ones
# at T30 and T85; every other preset up to T170 at a small batch
TRANSFORM_CASES = (
    [(p, b, prec) for p, batches in (("t30", (1, 7, 25, 34, 48, 57, 256)),
                                     ("t85", (25, 48, 57, 256)))
     for b in batches for prec in ("fp64", "fp32")]
    + [(p, 3, prec) for p in ("t42", "t63", "t170")
       for prec in ("fp64", "fp32")])


@pytest.mark.parametrize("preset,batch,precision", TRANSFORM_CASES)
def test_transform_kernels_match_einsum(cuda, preset, batch, precision):
    cfg, sc, spec, grid = spectral_case(preset, precision, batch)
    bound = TRANSFORM_BOUND[cfg.rdtype]
    reset()
    for kernel, plain, x in ((ft.fused_spec_to_grid, sp.spec_to_grid, spec),
                             (ft.fused_grid_to_spec, sp.grid_to_spec, grid)):
        out = kernel(sc, x)
        (err, _), = bp.field_errors([out], [plain(sc, x)])
        assert err <= bound, (kernel.__name__, err)
    assert counters["k2.launches_syn"] == 1
    assert counters["k2.launches_ana"] == 1
    # the pairs the truncation drops are not computed: exactly 0
    dropped = (torch.arange(cfg.nx, device="cuda")
               >= ft.truncation_extent(sc.cpol_dir).cuda()[:, None])
    assert int(dropped.sum()) > 0
    assert bool((out[:, dropped] == 0).all())


LAUNCH = {"syn": ft.launch_synthesis, "ana": ft.launch_analysis}
PLAIN = {"syn": sp.spec_to_grid, "ana": sp.grid_to_spec}
FUSED = {"syn": ft.fused_spec_to_grid, "ana": ft.fused_grid_to_spec}


def launches(direction):
    return counters["k2.launches_" + direction]


@pytest.mark.parametrize(
    "direction,tiles,precision",
    [("ana", t, p) for t in ft.ANA_BUILT_TILES for p in ("fp64", "fp32")]
    + [("syn", t, p) for p, size in (("fp64", 8), ("fp32", 4))
       for t in ft.SYN_BUILT_TILES[size]])
def test_every_built_tile(cuda, direction, tiles, precision):
    """Each tile the kernel is built for, at a ragged batch."""
    cfg, sc, spec, grid = spectral_case("t30", precision, 7)
    x = spec if direction == "syn" else grid
    out = LAUNCH[direction](sc, x, tiles=tiles)
    (err, _), = bp.field_errors([out], [PLAIN[direction](sc, x)])
    assert err <= TRANSFORM_BOUND[cfg.rdtype], err


@pytest.mark.parametrize("direction", ["syn", "ana"])
@pytest.mark.parametrize("preset", ["t30", "t42", "t63", "t85", "t170"])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_smem_matches_kernel(cuda, direction, preset, itemsize):
    """The wrapper's shared-memory plan is what the kernel asks for."""
    cfg = from_preset(preset)
    lib = ft._library()
    if direction == "syn":
        for batch in (1, 57, 256):
            plan = ft.synthesis_plan(cfg.mx, cfg.nx, cfg.il, cfg.ix,
                                     itemsize, batch)
            assert lib.spectral_synthesis_smem_bytes(
                int(itemsize == 8), plan.fb, plan.tj, plan.ti, plan.mc,
                cfg.nx) == plan.smem
            assert plan.smem <= ft.MAX_SMEM_BYTES
        return
    plan = ft.analysis_plan(cfg.mx, cfg.nx, cfg.il, cfg.ix, itemsize)
    assert lib.spectral_analysis_smem_bytes(
        int(itemsize == 8), plan.fb, plan.tm, cfg.il, cfg.ix, plan.jc,
        plan.nc, int(plan.early)) == plan.smem
    assert plan.smem <= ft.MAX_SMEM_BYTES


@pytest.mark.parametrize("direction", ["syn", "ana"])
@pytest.mark.parametrize("case", ["dtype", "mixed", "noncontiguous", "cpu"])
def test_refuses_bad_input(cuda, direction, case):
    cfg, sc, spec, grid = spectral_case("t30", "fp32", 4)
    x = spec if direction == "syn" else grid
    if case == "dtype":
        x = x.half()
    elif case == "mixed":
        x = x.double()
    elif case == "noncontiguous":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        x = x.cpu()
    reset()
    with pytest.raises(ValueError):
        LAUNCH[direction](sc, x)
    assert launches(direction) == 0


@pytest.mark.parametrize("direction", ["syn", "ana"])
def test_counts_launches(cuda, direction):
    _, sc, spec, grid = spectral_case("t30", "fp32", 25)
    x = spec if direction == "syn" else grid
    reset()
    for n in range(1, 4):
        FUSED[direction](sc, x)
        assert launches(direction) == n
    FUSED[direction](sc, x[:0])   # nothing to launch
    assert counters["k2.launches_syn"] + counters["k2.launches_ana"] == 3


@pytest.mark.parametrize("preset", ["t30", "t85", "t170"])
@pytest.mark.parametrize("precision", ["fp64", "fp32"])
def test_synthesis_skips_truncated_pairs(cuda, preset, precision):
    """The synthesis kernel does not read the pairs n >= extent[m] of
    cpol_inv: large finite values there leave the output bit-equal. The
    pair (0, trunc + 1) is kept (cpol_dir's extent would drop it), so a
    value there changes the output, as it does the einsum chain's."""
    cfg, sc, spec, _ = spectral_case(preset, precision, 5)
    extent = ft.truncation_extent(sc.cpol_inv).cuda()
    dropped = torch.arange(cfg.nx, device="cuda") >= extent[:, None]
    assert int(dropped.sum()) > 0 and not bool(dropped[0, cfg.trunc + 1])
    zeroed = spec.clone()
    zeroed[:, dropped] = 0
    noisy = zeroed.clone()
    noisy[:, dropped] = 1e6 * torch.randn_like(spec)[:, dropped]
    base = ft.fused_spec_to_grid(sc, zeroed)
    assert torch.equal(ft.fused_spec_to_grid(sc, noisy), base)
    bumped = zeroed.clone()
    bumped[:, 0, cfg.trunc + 1, 0] += 10.0
    out = ft.fused_spec_to_grid(sc, bumped)
    assert not torch.equal(out, base)
    (err, _), = bp.field_errors([out], [sp.spec_to_grid(sc, bumped)])
    assert err <= TRANSFORM_BOUND[cfg.rdtype], err


STEP_CASES = {"t30": ("t30", {}), "t30-sppt": ("t30", dict(sppt_on=True)),
              "t85": ("t85", {}),
              "t30-reflw": ("t30", dict(lw_band_vectorized=False)),
              "t30-sst": ("t30", dict(sst_anomaly_forcing=True))}


@pytest.mark.parametrize("case", list(STEP_CASES),   # T30's ids by sppt_on
                         ids=["False", "True", "t85", "t30-reflw", "t30-sst"])
def test_cuda_steps_match_cpu(cuda, bc, case):
    """Boot + 6 fp64 steps on the CPU (plain physics) and on CUDA (K1):
    every prognostic field and the SPPT pattern within 1e-10, SPPT fed the
    same innovations from a numpy seed; the reference LW order; SST
    anomalies on the stand-in set with its anomaly file."""
    preset, options = STEP_CASES[case]
    arrays = synthetic_boundaries(0, anomaly=True) \
        if options.get("sst_anomaly_forcing") else bc
    states = []
    for device in ("cpu", "cuda"):
        m = Model(from_preset(preset, precision="fp64", **options),
                  device=device, bc_arrays=arrays, sppt_noise=sppt_noise(1))
        s = m.initialize(START)
        daily = m.daily_forcing(s, START, START)
        for i in range(6):
            s, _ = m.one_step(s, daily, i % m.cfg.nstrad == 0)
        states.append(dict(s.prog._asdict(), **(
            {"sppt": s.sppt.spec} if m.cfg.sppt_on else {})))
    for f, a in states[0].items():
        b = states[1][f].cpu()
        assert ((a - b).abs().max() / a.abs().max()).item() <= 1e-10, f


def test_main_path_goes_through_kernel(cuda, bc):
    """run_fast's day goes through K1, with SPPT off and on."""
    for sppt_on in (False, True):
        m = Model(t30(sppt_on=sppt_on), device="cuda", bc_arrays=bc)
        capture_day(m, m.initialize(START), START)
        reset()
        m.run_fast(START, 1)
        assert counters["k1.launches"] == 2 + m.cfg.nsteps, sppt_on
        assert counters["k1.launches_sw"] == \
            2 + m.cfg.nsteps // m.cfg.nstrad, sppt_on


@pytest.mark.parametrize("members", bp.MEMBER_COUNTS)
@pytest.mark.parametrize("precision", ["fp64", "fp32"])
def test_k1_members_match_plain_and_single_launches(cuda, bc, members,
                                                    precision):
    m = Model(t30(precision=precision), device="cuda", bc_arrays=bc)
    for sw in (True, False):
        _, _, rec = bp.check_members(m, sw, members)
        rec["bound"] = bp.error_bound(m.cfg.rdtype)
        assert bp.passed(rec), (sw, rec)


@pytest.mark.parametrize("case", ["members", "strided", "shared_shape"])
def test_k1_refuses_bad_member_input(cuda, bc, case):
    m = Model(t30(), device="cuda", bc_arrays=bc)
    ins, block = bp.physics_case(m, True)
    ins = bp.member_inputs(ins, 4)
    if case == "members":
        ins[3] = ins[3][:3]
    elif case == "strided":
        ins[4] = ins[4].contiguous().transpose(2, 3).contiguous() \
            .transpose(2, 3)
    else:
        ins[13] = ins[13][:-1]
    reset()
    with pytest.raises(ValueError):
        fused.launch_kernel(m.cfg, True, ins, block)
    assert counters["k1.launches"] == 0


def test_ensemble_cuda_matches_cpu(cuda, bc):
    states = []
    for device in ("cpu", "cuda"):
        m = Model(t30(precision="fp64", sppt_on=True), device=device,
                  bc_arrays=bc, sppt_noise=sppt_noise(1))
        ens = Ensemble(m, 2, noise=[sppt_noise(2 + i)
                                    for i in range(2)])
        s = ens.initialize(START)
        daily = m.daily_forcing(s, START, START)
        for i in range(6):
            s, _ = one_step(m.cfg, m.pp, m.lsp, m.mc, s, daily,
                            i % m.cfg.nstrad == 0, noise=ens.noise)
        states.append(dict(s.prog._asdict(), sppt=s.sppt.spec))
    for f, a in states[0].items():
        b = states[1][f].cpu()
        for k in range(2):
            err = ((a[k] - b[k]).abs().max() / a[k].abs().max()).item()
            assert err <= 1e-10, (f, k, err)


@pytest.mark.parametrize("members", [1, 8, 64])
def test_ensemble_day_launches_once_per_step(cuda, bc, members):
    """A replayed fp32 SPPT day of the ensemble in the guard: one K1
    launch a step whatever the member count, every field finite, each
    member apart from member 0."""
    m = Model(t30(sppt_on=True), device="cuda", bc_arrays=bc)
    ens = Ensemble(m, members)
    estate = ens.initialize(START)
    capture_day(m, estate, START)
    reset()
    estate, _ = ens.run_days(estate, START, 1)
    assert counters["k1.launches"] == m.cfg.nsteps
    assert counters["k1.launches_sw"] == m.cfg.nsteps // m.cfg.nstrad
    assert all(bool(torch.isfinite(x).all()) for g in estate[:3] for x in g)
    vor = estate.prog.vor
    assert all(not torch.equal(vor[k], vor[0]) for k in range(1, members))


# ---------------------------------------------------------------------------
# the captured day
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("members", [None, 8])
@pytest.mark.parametrize("sppt_on", [False, True])
@pytest.mark.parametrize("precision", ["fp64", "fp32"])
def test_replayed_day_equals_eager_day(cuda, bc, precision, sppt_on,
                                       members):
    m = Model(t30(precision=precision, sppt_on=sppt_on), device="cuda",
              bc_arrays=bc)
    equal, differ, _ = replay_vs_eager(m, START, members)
    assert equal, differ


@pytest.mark.parametrize("members", [None, 8])
@pytest.mark.parametrize("grids", [False, True])
@pytest.mark.parametrize("precision", ["fp64", "fp32"])
def test_replayed_output_day_equals_eager_day(cuda, bc, precision, grids,
                                              members):
    """The output variants (Model.run's without and with a writer,
    run_days' with writers): the state and every step's diagnostics and,
    with grids, gridded fields equal run_day's with diagnostics every
    step."""
    m = Model(t30(precision=precision, sppt_on=True), device="cuda",
              bc_arrays=bc)
    equal, differ, _ = replay_vs_eager(m, START, members,
                                             collect_output=True, grids=grids)
    assert equal, differ


def test_replayed_day_holds_the_k1_launches(cuda, bc):
    m = Model(t30(), device="cuda", bc_arrays=bc)
    cd, _, _ = capture_day(m, m.initialize(START), START)
    nsteps, n_sw = m.cfg.nsteps, m.cfg.nsteps // m.cfg.nstrad
    assert (cd.counts["k1.launches"], cd.counts["k1.launches_sw"]) \
        == (nsteps, n_sw)
    reset()
    assert k1_in_trace(lambda: cd.advance(0))[:2] == (nsteps, n_sw)
    assert (counters["k1.launches"], counters["k1.launches_sw"]) \
        == (nsteps, n_sw)


@pytest.mark.parametrize("members", [None, 2])
def test_run_paths_sync_only_where_marked(cuda, bc, members):
    """run_fast and run_days over 2 days, capture included, under the sync
    debug mode "error": only the marked synchronisations happen."""
    m = Model(t30(sppt_on=True), device="cuda", bc_arrays=bc)
    state, _, _ = booted(m, START, members)
    with sync_error():
        if members is None:
            out = m.run_fast(START, 2, state=state, max_chunk_days=1)
        else:
            out, _ = Ensemble(m, members).run_days(state, START, 2)
    assert bool(torch.isfinite(out.prog.vor).all())


def test_run_checkpoint_resume_equals_straight_run(cuda, bc, tmp_path):
    from speedy_tpu_torch.utils.checkpoint import load_checkpoint
    m = Model(t30(sppt_on=True), device="cuda", bc_arrays=bc)
    day2 = cal.Datetime(1982, 1, 3)
    booted = m.initialize(START)
    with sync_error():
        straight = m.run(START, day2, state=booted, verbose=False,
                         checkpoint_every=1, checkpoint_dir=str(tmp_path))
    restored, date, step, _ = load_checkpoint(
        str(tmp_path / "ckpt_198201020000.npz"), m.initialize(START),
        cfg=m.cfg)
    resumed = m.run(START, day2, state=restored, resume_date=date,
                    model_step=step, verbose=False)
    for a, b in zip(leaves(straight), leaves(resumed), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("nsteps_out", [36, 9])
def test_run_writes_the_buffered_fields(cuda, bc, nsteps_out):
    """Model.run with a writer over 3 replayed T30 fp32 days (SPPT on),
    each day enqueued before the day before is checked and written, under
    the sync debug mode "error": each writer call receives exactly that
    step's fields in the day's full buffer, at the cadence's steps and
    dates, and no later day overwrites them; the day brings to the host
    every step's diagnostics and the written steps' fields only (759,168 B
    a day at nsteps_out 36)."""
    m = Model(t30(precision="fp32", sppt_on=True, nsteps_out=nsteps_out),
              device="cuda", bc_arrays=bc)
    day3 = cal.Datetime(1982, 1, 4)
    booted = m.initialize(START)
    ahead = counters["run.days_ahead"]
    with sync_error():
        calls, bad, counted = run_against_buffer(m, booted, START, day3)
    assert not bad
    assert calls == expected_calls(m.cfg, START, day3)
    assert counters["run.days_ahead"] - ahead == 2
    grid_steps = 3 * m.cfg.nsteps // nsteps_out
    assert counted == {"output.grid_steps": grid_steps,
                       "d2h.bytes": fetch_bytes(m.cfg, 3, grid_steps)}
    if nsteps_out == 36:
        assert counted["d2h.bytes"] == 3 * 759_168


@pytest.mark.parametrize("precision", ["fp64", "fp32"])
def test_debug_nans_run_equals_replayed_run(cuda, bc, precision):
    """The eager, checked day of Model.run(debug_nans=True) leaves the
    replayed run's state and writes its fields (SPPT on)."""
    m = Model(t30(precision=precision, sppt_on=True), device="cuda",
              bc_arrays=bc)
    runs = []
    for debug_nans in (False, True):
        written = {}

        def writer(step, date, start, fields, written=written):
            written[step] = {k: np.array(v) for k, v in fields.items()}

        state = m.run(START, cal.next_day(START), output_writer=writer,
                      verbose=False, debug_nans=debug_nans)
        runs.append((state, written))
    (a, wa), (b, wb) = runs
    for x, y in zip(leaves(a), leaves(b), strict=True):
        assert torch.equal(x, y)
    assert sorted(wa) == sorted(wb) == list(range(m.cfg.nsteps + 1))
    for step, fields in wa.items():
        for k, v in fields.items():
            np.testing.assert_array_equal(v, wb[step][k], err_msg=f"{step} {k}")


# ---------------------------------------------------------------------------
# the accumulating day (run_multiyear) and the dp axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["fp64", "fp32"])
def test_accumulating_day_replay_equals_eager_day(cuda, bc, precision):
    """Two replayed days of the accumulating variant: the state and every
    sum equal the eager days' (run_day with its fluxes, summed as the day
    sums them)."""
    m = Model(t30(precision=precision), device="cuda", bc_arrays=bc)
    equal, differ = accumulate_vs_eager(m, START)
    assert equal, differ


# tests/torch_mesh_worker.py over two ranks under torchrun
TWO_RANKS = ("torch.distributed.run", "--standalone", "--nproc-per-node",
             "2", os.path.join("tests", "torch_mesh_worker.py"))


def test_two_ranks_on_one_card_equal_unsharded_blocks(cuda, bc, tmp_path):
    """tests/torch_mesh_worker.py over two ranks on cuda:0 (Gloo), T21
    kx=5 fp32, 4 members, a day: the gathered state equals, array for
    array, unsharded 2-member Ensembles with the ranks' seeds; a member
    pushed out of range on rank 1 raises on both ranks."""
    r = program(*TWO_RANKS, str(tmp_path), "--device", "cuda:0",
                "--precision", "fp32", "--seed", "5")
    said = [(tmp_path / f"rank{k}.txt").read_text() for k in (0, 1)]
    assert r.returncode != 0 and all(
        x.startswith("Model variables out of accepted range at day 0, "
                     "member 2") for x in said), said
    got = np.load(tmp_path / "gathered.npz")
    m = Model(t30(precision="fp32", sppt_on=True, trunc=21, ix=64, il=32,
                  kx=5), device="cuda", bc_arrays=bc)
    for first in (0, 2):
        ens = Ensemble(m, 2, base_seed=5 + first)
        estate, _ = ens.run_days(ens.initialize(START), START, 1)
        for group in ("prog", "surf", "rad"):
            for f, v in getattr(estate, group)._asdict().items():
                np.testing.assert_array_equal(
                    got[f"{group}.{f}"][first:first + 2], v.cpu().numpy(),
                    err_msg=f"{group}.{f}")


@pytest.mark.parametrize("preset,rows", [("t30", 24), ("t30", 12),
                                         ("t170", 64)],
                         ids=["24", "12", "t170-64"])   # T30's by rows
@pytest.mark.parametrize("compute_sw", [True, False])
@pytest.mark.parametrize("precision", ["fp64", "fp32"])
def test_k1_at_band_shapes_matches_plain(cuda, bc, precision, compute_sw,
                                         preset, rows):
    """K1 on the northernmost ``rows`` latitude rows of the perturbed
    booted inputs (an sp rank's band), against its plain chain on the
    same CUDA tensors."""
    m = Model(from_preset(preset, precision=precision), device="cuda",
              bc_arrays=bc)
    ins, block = bp.physics_case(m, compute_sw)
    band = band_inputs(bp.perturb(ins), slice(m.cfg.il - rows,
                                                    m.cfg.il))
    kout = fused.launch_kernel(m.cfg, compute_sw, band, block)
    pout = fused.plain_outputs(m.cfg, m.pp, compute_sw, band)
    assert tuple(kout[4].shape) == (rows, m.cfg.ix)
    worst = max(e[0] for e in bp.field_errors(kout, pout))
    assert worst <= bp.error_bound(m.cfg.rdtype), worst


def test_sp_ranks_on_one_card_match_unsharded(cuda, bc, tmp_path):
    """tests/torch_mesh_worker.py over dp=1 x sp=2 on cuda:0 (Gloo, so
    each day runs eagerly), T21 kx=5 fp64, 2 SPPT members, a day: the
    gathered state within 1e-12 per field and member of an unsharded
    Ensemble's on the card, the ranks' spectral leaves equal."""
    r = program(*TWO_RANKS, str(tmp_path), "--device", "cuda:0", "--sp",
                "2", "--members", "2", "--no-trip")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    m = Model(t30(precision="fp64", sppt_on=True, trunc=21, ix=64, il=32,
                  kx=5), device="cuda", bc_arrays=bc)
    ens = Ensemble(m, 2, base_seed=5)
    estate, _ = ens.run_days(ens.initialize(START), START, 1)
    got = np.load(tmp_path / "gathered.npz")
    for group in ("prog", "surf", "rad"):
        for f, v in getattr(estate, group)._asdict().items():
            v = v.cpu().numpy()
            for k in range(2):
                err = np.abs(got[f"{group}.{f}"][k] - v[k]).max() \
                    / max(np.abs(v[k]).max(), 1e-300)
                assert err <= 1e-12, (group, f, k, err)
    a, b = (np.load(tmp_path / f"spec{k}.npz") for k in (0, 1))
    for f in a.files:
        assert np.array_equal(a[f], b[f]), f
    runs = [json.load(open(tmp_path / f"run{k}.json")) for k in (0, 1)]
    assert [x["captured"] for x in runs] == [False, False]
    assert [x["allreduces"] for x in runs] == [2 * m.cfg.nsteps + 2] * 2


def test_one_nccl_rank_captures_the_band_day(cuda, bc):
    """One NCCL rank in this process. With an sp group of that one rank
    (the band holds every row, and each Legendre analysis makes its
    all-reduce), the T30 fp64 SPPT day is captured with its all-reduces
    inside the graph: 2 x nsteps + 2 of them and nsteps K1 launches a
    replayed day, nsteps K1 kernels in its profiler trace, and its replay
    torch.equal to the band's eager day and to the unsharded replayed
    day. With the dp mesh of that one rank, as the ``ensemble`` command
    runs under torchrun (the guard's all-reduce under NCCL): 8 fp32 SPPT
    members over 2 days equal a plain process's Ensemble, and
    gather_members gives them back. The process group is destroyed at
    the end."""
    import dataclasses
    import socket
    import torch.distributed as dist
    from speedy_tpu_torch.convert import gather_members, model_state_to_numpy
    from speedy_tpu_torch.parallel.mesh import make_mesh, new_group

    def equal(a, b):
        return all(torch.equal(x, y)
                   for x, y in zip(leaves(a), leaves(b), strict=True))

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1, device="cuda:0")
        assert mesh.backend == "nccl"
        model = Model(t30(precision="fp64", sppt_on=True),
                      device=mesh.device, bc_arrays=bc)
        band = model.for_band(dataclasses.replace(
            mesh, sp_group=new_group([0], mesh.device)))
        nsteps = model.cfg.nsteps
        state, noise, _ = booted(model, START)
        cd, _, _ = capture_day(band, state, START)
        assert cd.captured and cd.graph is not None
        assert cd.counts["spectral.allreduces"] == 2 * nsteps + 2
        reset()
        with sync_error():
            cd.advance(0, noise)
        torch.cuda.synchronize()
        assert (counters["spectral.allreduces"], counters["k1.launches"]) \
            == (2 * nsteps + 2, nsteps)
        replayed = cd.result()
        plain, _, _ = capture_day(model, state, START)
        plain.advance(0, noise)
        assert equal(replayed, side_eager_day(band, state, START, noise)[0])
        assert equal(replayed, plain.result())
        names = [n for n, _ in trace(lambda: cd.advance(0, noise))[1]]
        assert sum("column_physics" in n for n in names) == nsteps
        del model, band, cd, plain

        model = Model(t30(sppt_on=True), device=mesh.device, bc_arrays=bc)
        runs = []
        for on_mesh in (mesh, None):
            ens = Ensemble(model, 8, mesh=on_mesh)
            runs.append(ens.run_days(ens.initialize(START), START, 2)[0])
        assert equal(*runs)
        got, want = (gather_members(runs[0], mesh),
                     model_state_to_numpy(runs[1]))
        for group, fields in want.items():
            for f, v in fields.items():
                np.testing.assert_array_equal(got[group][f], v,
                                              err_msg=f"{group}.{f}")
    finally:
        dist.destroy_process_group()


PROGRAM_ARGS = ("--synthetic-bc", "0", "--device", "cuda")


@pytest.mark.parametrize("presets,days", [("t30,t42,t63,t85", 90),
                                          ("t170", 10)])
def test_stability_gate_runs_clean(cuda, presets, days):
    """The stability gate through its entry: a line per preset, each
    guard-clean and finite over ``days`` days; rc 0 exactly when every
    preset passes."""
    r = program("speedy_tpu_torch.stability_gate", "--presets", presets,
                "--days", str(days), *PROGRAM_ARGS)
    per = [x for x in json_lines(r.stdout) if "preset" in x]
    assert [x["preset"] for x in per] == presets.split(","), \
        r.stdout[-3000:] + r.stderr[-3000:]
    assert all(x["guard_clean"] and x["finite"] for x in per), per
    assert r.returncode == (0 if all(x["pass"] for x in per) else 1), per


def test_climatology_year_is_finite(cuda):
    """run_climatology over 365 T30 days through its entry: rc 0, one
    finite summary line."""
    r = program("speedy_tpu_torch.run_climatology", "--days", "365",
                *PROGRAM_ARGS)
    rows = json_lines(r.stdout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert len(rows) == 1 and rows[0]["finite"], rows


def test_fp32_qualification_runs_every_part(cuda, tmp_path):
    """fp32_qualification over 30 days and 64 members through its entry:
    rc 0, the five runs finite, a row of the drift table a day."""
    days = 30
    r = program("speedy_tpu_torch.fp32_qualification", "--days", str(days),
                "--members", "64", "--out", str(tmp_path), *PROGRAM_ARGS)
    runs = json_lines(r.stdout)
    table = [line for line in r.stdout.splitlines()
             if re.match(r"\s*\d+\s", line)]
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert len(runs) == 5 and all(x["finite"] for x in runs), runs
    assert len(table) == days, table


def test_multiyear_with_elnino_counts_every_month(cuda, tmp_path):
    """run_multiyear over 2 years with the El Nino run through its entry:
    rc 0, both summary lines, every month's printed olr and saved means
    finite, one host copy a month, and 2 + (days + 1) x nsteps K1
    launches a run."""
    years, nsteps = 2, t30().nsteps
    out = tmp_path / "clim.npz"
    r = program("speedy_tpu_torch.run_multiyear", "--years", str(years),
                "--elnino", "--out", str(out), *PROGRAM_ARGS)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rows = json_lines(r.stdout)
    assert [x.get("metric") for x in rows] == \
        [f"climatology_t30_{years}y", "elnino_response_DJF"], rows
    n_months = 2 * 12 * years
    olr = [float(x) for x in re.findall(r"done \(olr mean ([^)]+)\)",
                                        r.stdout)]
    assert len(olr) == n_months and np.isfinite(olr).all(), olr
    months = np.load(out, allow_pickle=True)["months"]
    assert len(months) == n_months // 2
    assert all(np.isfinite(m[k]).all() for m in months
               for k in ("u", "t", "precip", "olr", "tsr", "ssr"))
    tail = re.search(r"(\d+) months, (\d+) host copies of the accumulating "
                     r"days, column-physics kernel launches (\d+)", r.stdout)
    assert tail is not None, r.stdout[-3000:]
    assert [int(g) for g in tail.groups()] == \
        [n_months, n_months, 2 * (2 + (365 * years + 1) * nsteps)]


def test_stability_diag_t85_runs_clean(cuda, tmp_path):
    """stability_diag at T85 over 9 days in chunks of 3 through its
    entry: rc 0, status clean, the npz arrays in the JAX script's shapes,
    2 + (days + 1) x nsteps K1 launches."""
    days, chunk = 9, 3
    cfg = from_preset("t85")
    out = tmp_path / "stab.npz"
    r = program("speedy_tpu_torch.stability_diag", "--preset", "t85",
                "--days", str(days), "--chunk", str(chunk), "--out",
                str(out), *PROGRAM_ARGS)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rows = json_lines(r.stdout)
    assert rows and rows[-1].get("status") == "clean", rows
    n, nell = -(-days // chunk) + 1, cfg.mx + cfg.nx - 1
    with np.load(out) as f:
        shapes = {k: f[k].shape for k in f.files}
    assert shapes == dict(days=(n,), ke_rot=(n, nell, cfg.kx),
                          ke_div=(n, nell, cfg.kx), t_var=(n, nell, cfg.kx),
                          vor_max=(n,), guard=(days, 5))
    m = re.search(r"column-physics kernel launches (\d+)", r.stdout)
    assert m is not None and int(m.group(1)) == \
        2 + (days + 1) * cfg.nsteps, r.stdout[-3000:]
