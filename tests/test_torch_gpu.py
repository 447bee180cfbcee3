"""The CUDA kernels on the card (marked ``gpu``; every test skips without
a CUDA device). This file imports neither JAX nor speedy_tpu, so it also
runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The column-physics kernel is held against its plain PyTorch chain on the
same CUDA tensors (field-normalised error, fp64 <= 1e-12, fp32 <= 1e-4)
for every built level count at T30 and at kx=8 on the T63, T85 and T170
grids, its launch (columns, threads, blocks, shared memory) against
``fused.block_plan`` at every preset, and its refusal of bad inputs; the
spectral-transform kernels against their
einsum chain (fp64 <= 1e-12, fp32 <= 1e-5) at the step's, ragged and large
batches at T30 and T85 and at every preset up to T170 (both kernels'
largest shared-memory case is T170 fp64) and at every tile they are built
for, with the analysis output exactly 0 at the pairs the truncation drops
and the synthesis output blind to its input there, and the CUDA model
against the CPU model after
boot + 6 fp64 steps (<= 1e-10), with SPPT off and on (the same innovations
from a numpy seed). Ensembles: the column-physics kernel with 1, 8 and 64
members as extra columns against its plain chain, each member's outputs
equal to a one-member launch, its refusal of bad member-batched inputs, a
2-member SPPT ensemble on CUDA against the CPU after boot + 6 fp64 steps,
and one kernel launch a step whatever the member count. The captured day
(models/captured.py): a replayed day against the eager run_day on a side
stream (torch.equal, fp64 and fp32, SPPT off and on, one model and 8
members), and its output variants' every-step diagnostics and gridded
fields against run_day's, with the replay under the sync debug mode
"error"; the K1
launches of a replayed T30 day in a profiler trace (36, 12 SW) and in the
launch counters; run_fast, run_days and Model.run with checkpoints
synchronising only where marked; a checkpoint resumed on the card equal to
the straight run. The reference LW order (lw_band_vectorized=False): the
column-physics kernel against its plain chain at T30 (kx 5/7/8), T85 and
T170 (kx=8), its fp32 outputs not equal to the default order's, with 1
and 8 members, its refusal of bad inputs, and the main path's launches
counted as reference-order ones; an SST-anomaly run across a month start
replayed against the eager days (torch.equal); one K1 launch a step of a
replayed T85 day. Model.run with a writer at nsteps_out 36 and 9 over 3
days, each enqueued before the day before is written: each call's fields
equal to the day's buffer of every step's fields and never overwritten by
a later day, and the day's host copy only the written steps' fields and
the diagnostics.
Model.run(debug_nans=True), the CLI's --debug-nans,
against the replayed Model.run: the same state and written fields. The
sp axis: K1 at latitude-band shapes against its plain chain, and two
sp ranks on one card (Gloo, eager days) against the unsharded run.
"""
import ctypes
import json
import os
import sys

import numpy as np
import pytest
import torch

from speedy_tpu_torch import bench_physics as bp
from speedy_tpu_torch.config import from_preset, t30
from speedy_tpu_torch.geometry import build_geometry_np
from speedy_tpu_torch.models.captured import leaves
from speedy_tpu_torch.models.model import Model, one_step
from speedy_tpu_torch.models.physics import fused
from speedy_tpu_torch.ops import fused_transforms as ft
from speedy_tpu_torch.ops import spectral as sp
from speedy_tpu_torch.parallel.ensemble import Ensemble
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils.synthetic_bc import synthetic_boundaries
from speedy_tpu_torch.utils.tracing import counters, reset
from torch_run_checks import expected_calls, fetch_bytes, run_against_buffer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START = cal.Datetime(1982, 1, 1)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, REPO_ROOT)
    import chip_smoke
    return chip_smoke


@pytest.fixture(scope="module")
def bc():
    return synthetic_boundaries(0)


K1_GRIDS = [("t30", 5), ("t30", 7), ("t30", 8), ("t63", 8), ("t85", 8),
            ("t170", 8)]


@pytest.mark.parametrize("preset,kx", K1_GRIDS)
@pytest.mark.parametrize("precision", ["fp64", "fp32"])
def test_kernel_matches_plain_chain(smoke, bc, preset, kx, precision):
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
def test_reference_lw_kernel_matches_plain_chain(smoke, bc, preset, kx,
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
def test_reference_lw_kernel_with_members(smoke, bc, members, precision):
    m = Model(t30(precision=precision, lw_band_vectorized=False),
              device="cuda", bc_arrays=bc)
    for sw in (True, False):
        _, _, rec = bp.check_members(m, sw, members)
        rec["bound"] = bp.error_bound(m.cfg.rdtype)
        assert bp.passed(rec), (sw, rec)


@pytest.mark.parametrize("case", ["dtype", "shape", "cpu", "count"])
def test_reference_lw_kernel_refuses_bad_input(smoke, bc, case):
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


def test_reference_lw_main_path_launches(smoke, bc):
    """Every K1 launch of a reference-order run is counted as one, in the
    boot and in each replayed day."""
    m = Model(t30(lw_band_vectorized=False), device="cuda", bc_arrays=bc)
    smoke.capture_day(m, m.initialize(START), START)
    reset()
    m.run_fast(START, 1)
    nsteps, nstrad = m.cfg.nsteps, m.cfg.nstrad
    assert counters["k1.launches"] == counters["k1.launches_reflw"] \
        == 2 + nsteps
    assert counters["k1.launches_sw"] == counters["k1.launches_reflw_sw"] \
        == 2 + nsteps // nstrad


def test_sst_anomaly_replay_across_month_start(smoke):
    """An fp32 SST-anomaly run from 1982-01-30 over 4 days: replayed equal
    to the eager days, the window shifted at 1982-02-01 in both."""
    m = Model(t30(sst_anomaly_forcing=True), device="cuda",
              bc_arrays=synthetic_boundaries(0, anomaly=True))
    differ, shifted, end, _ = smoke.sst_replay_vs_eager(
        m, cal.Datetime(1982, 1, 30), 4)
    assert not differ and shifted
    assert end == cal.Datetime(1982, 2, 3)


def test_t85_day_launches_once_per_step(smoke, bc):
    m = Model(from_preset("t85"), device="cuda", bc_arrays=bc)
    state = m.initialize(START)
    smoke.capture_day(m, state, START)
    reset()
    out = m.run_fast(START, 1, state=state)
    assert counters["k1.launches"] == m.cfg.nsteps == 96
    assert counters["k1.launches_sw"] == m.cfg.nsteps // m.cfg.nstrad
    assert bool(torch.isfinite(out.prog.vor).all())


@pytest.mark.parametrize("preset", ["t30", "t42", "t63", "t85", "t170"])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_k1_layout_matches_kernel(smoke, preset, itemsize):
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
def test_k1_refuses_bad_input(smoke, bc, case):
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


def spectral_case(preset, precision, batch):
    cfg = from_preset(preset, precision=precision)
    sc = sp.build_spectral(cfg, build_geometry_np(cfg), "cuda")
    rng = np.random.default_rng(batch)
    spec = torch.as_tensor(rng.standard_normal((batch, cfg.mx, cfg.nx, 2)),
                           dtype=cfg.rdtype, device="cuda")
    grid = torch.as_tensor(rng.standard_normal((batch, cfg.il, cfg.ix)),
                           dtype=cfg.rdtype, device="cuda")
    return cfg, sc, spec, grid


# the step's batches (25/48 analysis, 57 synthesis), ragged and large ones
# at T30 and T85; every other preset up to T170 at a small batch
TRANSFORM_CASES = (
    [(p, b, prec) for p, batches in (("t30", (1, 7, 25, 48, 57, 256)),
                                     ("t85", (25, 48, 57, 256)))
     for b in batches for prec in ("fp64", "fp32")]
    + [(p, 3, prec) for p in ("t42", "t63", "t170")
       for prec in ("fp64", "fp32")])


@pytest.mark.parametrize("preset,batch,precision", TRANSFORM_CASES)
def test_transform_kernels_match_einsum(smoke, preset, batch, precision):
    cfg, sc, spec, grid = spectral_case(preset, precision, batch)
    bound = smoke.TRANSFORM_BOUND[cfg.rdtype]
    reset()
    for kernel, plain, x in ((ft.fused_spec_to_grid, sp.spec_to_grid, spec),
                             (ft.fused_grid_to_spec, sp.grid_to_spec, grid)):
        out = kernel(sc, x)
        (err, _), = smoke.field_errors([out], [plain(sc, x)])
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
def test_every_built_tile(smoke, direction, tiles, precision):
    """Each tile the kernel is built for, at a ragged batch."""
    cfg, sc, spec, grid = spectral_case("t30", precision, 7)
    x = spec if direction == "syn" else grid
    out = LAUNCH[direction](sc, x, tiles=tiles)
    (err, _), = smoke.field_errors([out], [PLAIN[direction](sc, x)])
    assert err <= smoke.TRANSFORM_BOUND[cfg.rdtype], err


@pytest.mark.parametrize("direction", ["syn", "ana"])
@pytest.mark.parametrize("preset", ["t30", "t42", "t63", "t85", "t170"])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_smem_matches_kernel(smoke, direction, preset, itemsize):
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
def test_refuses_bad_input(smoke, direction, case):
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
def test_counts_launches(smoke, direction):
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
def test_synthesis_skips_truncated_pairs(smoke, preset, precision):
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
    (err, _), = smoke.field_errors([out], [sp.spec_to_grid(sc, bumped)])
    assert err <= smoke.TRANSFORM_BOUND[cfg.rdtype], err


@pytest.mark.parametrize("sppt_on", [False, True])
def test_cuda_steps_match_cpu(smoke, bc, sppt_on):
    states = []
    for device in ("cpu", "cuda"):
        m = Model(t30(precision="fp64", sppt_on=sppt_on), device=device,
                  bc_arrays=bc, sppt_noise=smoke.sppt_noise(1))
        s = m.initialize(START)
        daily = m.daily_forcing(s, START, START)
        for i in range(6):
            s, _ = m.one_step(s, daily, i % m.cfg.nstrad == 0)
        states.append(s.prog)
    for f in states[0]._fields:
        a, b = getattr(states[0], f), getattr(states[1], f).cpu()
        assert ((a - b).abs().max() / a.abs().max()).item() <= 1e-10, f


def test_main_path_goes_through_kernel(smoke, bc):
    m = Model(t30(), device="cuda", bc_arrays=bc)
    smoke.capture_day(m, m.initialize(START), START)
    reset()
    m.run_fast(START, 1)
    assert counters["k1.launches"] == 2 + m.cfg.nsteps
    assert counters["k1.launches_sw"] == 2 + m.cfg.nsteps // m.cfg.nstrad


@pytest.mark.parametrize("members", bp.MEMBER_COUNTS)
@pytest.mark.parametrize("precision", ["fp64", "fp32"])
def test_k1_members_match_plain_and_single_launches(smoke, bc, members,
                                                    precision):
    m = Model(t30(precision=precision), device="cuda", bc_arrays=bc)
    for sw in (True, False):
        _, _, rec = bp.check_members(m, sw, members)
        rec["bound"] = bp.error_bound(m.cfg.rdtype)
        assert bp.passed(rec), (sw, rec)


@pytest.mark.parametrize("case", ["members", "strided", "shared_shape"])
def test_k1_refuses_bad_member_input(smoke, bc, case):
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


def test_ensemble_cuda_matches_cpu(smoke, bc):
    states = []
    for device in ("cpu", "cuda"):
        m = Model(t30(precision="fp64", sppt_on=True), device=device,
                  bc_arrays=bc, sppt_noise=smoke.sppt_noise(1))
        ens = Ensemble(m, 2, noise=[smoke.sppt_noise(2 + i)
                                    for i in range(2)])
        s = ens.initialize(START)
        daily = m.daily_forcing(s, START, START)
        for i in range(6):
            s, _ = one_step(m.cfg, m.pp, m.lsp, m.mc, s, daily,
                            i % m.cfg.nstrad == 0, noise=ens.noise)
        states.append(s.prog)
    for f in states[0]._fields:
        a, b = getattr(states[0], f), getattr(states[1], f).cpu()
        for k in range(2):
            err = ((a[k] - b[k]).abs().max() / a[k].abs().max()).item()
            assert err <= 1e-10, (f, k, err)


@pytest.mark.parametrize("members", [1, 8])
def test_ensemble_day_launches_once_per_step(smoke, bc, members):
    m = Model(t30(sppt_on=True), device="cuda", bc_arrays=bc)
    ens = Ensemble(m, members)
    estate = ens.initialize(START)
    smoke.capture_day(m, estate, START)
    reset()
    estate, _ = ens.run_days(estate, START, 1)
    assert counters["k1.launches"] == m.cfg.nsteps
    assert counters["k1.launches_sw"] == m.cfg.nsteps // m.cfg.nstrad
    assert bool(torch.isfinite(estate.prog.vor).all())


# ---------------------------------------------------------------------------
# the captured day
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("members", [None, 8])
@pytest.mark.parametrize("sppt_on", [False, True])
@pytest.mark.parametrize("precision", ["fp64", "fp32"])
def test_replayed_day_equals_eager_day(smoke, bc, precision, sppt_on,
                                       members):
    m = Model(t30(precision=precision, sppt_on=sppt_on), device="cuda",
              bc_arrays=bc)
    equal, differ, _ = smoke.replay_vs_eager(m, START, members)
    assert equal, differ


@pytest.mark.parametrize("members", [None, 8])
@pytest.mark.parametrize("grids", [False, True])
@pytest.mark.parametrize("precision", ["fp64", "fp32"])
def test_replayed_output_day_equals_eager_day(smoke, bc, precision, grids,
                                              members):
    """The output variants (Model.run's without and with a writer,
    run_days' with writers): the state and every step's diagnostics and,
    with grids, gridded fields equal run_day's with diagnostics every
    step."""
    m = Model(t30(precision=precision, sppt_on=True), device="cuda",
              bc_arrays=bc)
    equal, differ, _ = smoke.replay_vs_eager(m, START, members,
                                             collect_output=True, grids=grids)
    assert equal, differ


def test_replayed_day_holds_the_k1_launches(smoke, bc):
    m = Model(t30(), device="cuda", bc_arrays=bc)
    cd, _, _ = smoke.capture_day(m, m.initialize(START), START)
    nsteps, n_sw = m.cfg.nsteps, m.cfg.nsteps // m.cfg.nstrad
    assert (cd.counts["k1.launches"], cd.counts["k1.launches_sw"]) \
        == (nsteps, n_sw)
    reset()
    assert smoke.k1_in_trace(lambda: cd.advance(0))[:2] == (nsteps, n_sw)
    assert (counters["k1.launches"], counters["k1.launches_sw"]) \
        == (nsteps, n_sw)


@pytest.mark.parametrize("members", [None, 2])
def test_run_paths_sync_only_where_marked(smoke, bc, members):
    """run_fast and run_days over 2 days, capture included, under the sync
    debug mode "error": only the marked synchronisations happen."""
    m = Model(t30(sppt_on=True), device="cuda", bc_arrays=bc)
    state, _, _ = smoke.booted(m, START, members)
    with smoke.sync_error():
        if members is None:
            out = m.run_fast(START, 2, state=state, max_chunk_days=1)
        else:
            out, _ = Ensemble(m, members).run_days(state, START, 2)
    assert bool(torch.isfinite(out.prog.vor).all())


def test_run_checkpoint_resume_equals_straight_run(smoke, bc, tmp_path):
    from speedy_tpu_torch.utils.checkpoint import load_checkpoint
    m = Model(t30(sppt_on=True), device="cuda", bc_arrays=bc)
    day2 = cal.Datetime(1982, 1, 3)
    booted = m.initialize(START)
    with smoke.sync_error():
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
def test_run_writes_the_buffered_fields(smoke, bc, nsteps_out):
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
    with smoke.sync_error():
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
def test_debug_nans_run_equals_replayed_run(smoke, bc, precision):
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
def test_accumulating_day_replay_equals_eager_day(smoke, bc, precision):
    """Two replayed days of the accumulating variant: the state and every
    sum equal the eager days' (run_day with its fluxes, summed as the day
    sums them)."""
    m = Model(t30(precision=precision), device="cuda", bc_arrays=bc)
    equal, differ = smoke.accumulate_vs_eager(m, START)
    assert equal, differ


def test_two_ranks_on_one_card_equal_unsharded_blocks(smoke, bc, tmp_path):
    """tests/torch_mesh_worker.py over two ranks on cuda:0 (Gloo), T21
    kx=5 fp32, 4 members, a day: the gathered state equals, array for
    array, unsharded 2-member Ensembles with the ranks' seeds; a member
    pushed out of range on rank 1 raises on both ranks."""
    import subprocess
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2",
         os.path.join(REPO_ROOT, "tests", "torch_mesh_worker.py"),
         str(tmp_path), "--device", "cuda:0", "--precision", "fp32",
         "--seed", "5"], env=env, capture_output=True, text=True,
        timeout=600)
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


@pytest.mark.parametrize("rows", [24, 12])
@pytest.mark.parametrize("compute_sw", [True, False])
@pytest.mark.parametrize("precision", ["fp64", "fp32"])
def test_k1_at_band_shapes_matches_plain(smoke, bc, precision, compute_sw,
                                         rows):
    """K1 on the northernmost ``rows`` latitude rows of the perturbed
    booted T30 inputs (an sp rank's band), against its plain chain on the
    same CUDA tensors."""
    m = Model(t30(precision=precision), device="cuda", bc_arrays=bc)
    ins, block = bp.physics_case(m, compute_sw)
    band = smoke.band_inputs(bp.perturb(ins), slice(m.cfg.il - rows,
                                                    m.cfg.il))
    kout = fused.launch_kernel(m.cfg, compute_sw, band, block)
    pout = fused.plain_outputs(m.cfg, m.pp, compute_sw, band)
    assert tuple(kout[4].shape) == (rows, m.cfg.ix)
    worst = max(e[0] for e in bp.field_errors(kout, pout))
    assert worst <= bp.error_bound(m.cfg.rdtype), worst


def test_sp_ranks_on_one_card_match_unsharded(smoke, bc, tmp_path):
    """tests/torch_mesh_worker.py over dp=1 x sp=2 on cuda:0 (Gloo, so
    each day runs eagerly), T21 kx=5 fp64, 2 SPPT members, a day: the
    gathered state within 1e-12 per field and member of an unsharded
    Ensemble's on the card, the ranks' spectral leaves equal."""
    import subprocess
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2",
         os.path.join(REPO_ROOT, "tests", "torch_mesh_worker.py"),
         str(tmp_path), "--device", "cuda:0", "--sp", "2", "--members",
         "2", "--no-trip"], env=env, capture_output=True, text=True,
        timeout=600)
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
