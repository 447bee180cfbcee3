"""The metric readers on a recorded synthetic kernel table: two simulated
days of a T30 step with known kernel times, and what each reader makes of
them; a reader that finds nothing returns None."""
from __future__ import annotations

import pytest

from benchmark import counts, harness, trace
from benchmark.trace import Kernel, Span, Trace

K1_SW = "void column_physics_kernel<float, 8, true, false, false>(ParamsOf)"
K1 = "void column_physics_kernel<float, 8, false, false, false>(ParamsOf)"
GEMM = "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_cublas"
ADD = ("void at::native::vectorized_elementwise_kernel<4, "
       "at::native::CUDAFunctor_add<float>>(int, ...)")
STRIDED = "void at::native::elementwise_kernel<128, 2, ...>(int, ...)"
CAT = "void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>"
RNG = ("void at::native::(anonymous namespace)::"
       "distribution_elementwise_grid_stride_kernel<float, 4, ...>")
REDUCE = "void at::native::reduce_kernel<512, 1, ...>"


def step_kernels(t0, sw, members):
    """One step's kernels from t0 µs, back to back with a 1 µs gap: a K1
    launch, two GEMMs, three elementwise kinds, a reduction and, with
    members, a draw."""
    ks = [(K1_SW if sw else K1, 10.0), (GEMM, 4.0), (GEMM, 4.0),
          (ADD, 2.0), (STRIDED, 3.0), (CAT, 1.0), (REDUCE, 1.0)]
    if members > 1:
        ks.append((RNG, 0.5))
    out, t = [], t0
    for name, dur in ks:
        out.append(Kernel(name, t, dur))
        t += dur + 1.0
    return out, t


class FakeCell:
    def __init__(self, members=1, sppt=False):
        self.members, self.sppt = members, sppt
        self.model_config = dict(trunc=30, ix=96, il=48, kx=8, nsteps=36,
                                 nstrad=3, precision="fp32")
        self.params = {}
        self.reference = None


def recorded_run(members=1, days=2, wall_day_s=0.0005):
    cell = FakeCell(members, members > 1)
    run = harness.Run(cell, 1, 1.0, True, "cuda", 0.0)
    kernels, t = [], 0.0
    for step in range(days * 36):
        ks, t = step_kernels(t, step % 3 == 0, members)
        kernels += ks
    host = [Span("bench.chunk", -5.0, t + 5.0),
            Span("cudaGraphLaunch", -4.0, 30.0)]
    run.trace = Trace(wall_s=t * 1e-6 * 1.5, kernels=kernels, spans=host)
    run.profile_days = days
    run.window_days, run.window_s = 100, 100 * wall_day_s
    run.window_start = 0.0
    return run, t


def read(name, run):
    mod = harness.find_module(harness.HERE, "metrics", name)
    return mod.read(run, name)


def test_classes():
    assert [trace.kernel_class(k) for k in (K1, GEMM, ADD, STRIDED, CAT,
                                            RNG, REDUCE)] == \
        ["k1", "transform", "elementwise", "elementwise", "elementwise",
         "rng", "other"]


def test_per_step_times_and_launches():
    run, _ = recorded_run()
    assert read("launches_per_step.sim", run) == pytest.approx(7.0)
    assert read("elementwise_us_per_step.sim", run) == pytest.approx(6.0)
    assert read("transform_us_per_step.sim", run) == pytest.approx(8.0)
    assert read("sppt_draw_us_per_step.members", run) is None
    run, _ = recorded_run(members=4)
    assert read("sppt_draw_us_per_step.members", run) == pytest.approx(0.5)


def test_idle_share_divides_by_the_unprofiled_wall():
    run, _ = recorded_run()
    busy_day = (10 + 4 + 4 + 2 + 3 + 1 + 1) * 36e-6
    want = 100 * (1 - busy_day / 0.0005)
    assert read("idle_share.sim", run) == pytest.approx(want)


def test_k1_roofline():
    run, _ = recorded_run()
    cfg = run.shapes
    least = 24 * counts.k1_least_s(cfg, True) \
        + 48 * counts.k1_least_s(cfg, False)
    assert read("k1_roofline.sim", run) == pytest.approx(
        100 * least / (72 * 10e-6))


def test_step_mfu():
    run, _ = recorded_run(members=2)
    ops = counts.step_operations(run.shapes, True, 2) * 100 * 36
    assert read("step_mfu.members", run) == pytest.approx(
        100 * ops / run.window_s / 67e12)


def test_nothing_to_read():
    run, _ = recorded_run()
    run.trace = Trace(1.0, [], [])
    for name in ("idle_share.sim", "launches_per_step.sim",
                 "elementwise_us_per_step.sim", "k1_roofline.sim",
                 "transform_us_per_step.sim"):
        assert read(name, run) is None, name


def test_breakdown():
    run, end = recorded_run()
    top = trace.top_kernels(run.trace.kernels)
    assert top[0] == [GEMM, pytest.approx(72 * 8e-6)]
    assert top[1] == [K1, pytest.approx(48 * 10e-6)]
    assert len(top) == 7
    gaps = trace.idle_gaps(run.trace)
    assert len(gaps) == 10
    assert all(g[1] == pytest.approx(1e-6) for g in gaps)
    assert trace.busy_us(run.trace.kernels) == pytest.approx(
        end - 72 * 7 * 1.0)
    # a gap inside the launch's host call names both spans, the
    # innermost of each kind
    assert gaps[0][0] == "chunk/cudaGraphLaunch"
    assert gaps[-1][0] == "chunk"


def test_writer_and_day_times():
    run, _ = recorded_run()
    run.window_start = 10.0
    for i in range(1, 5):
        with_stamp = 10.0 + 0.05 * i
        run.spans.done.setdefault("writer", []).append(0.002)
        run.spans.stamps.setdefault("writer", []).append(with_stamp)
    run.window_days = 4
    assert run.day_seconds() == pytest.approx([0.05] * 4)
    assert read("writer_ms_per_day", run) == pytest.approx(2.0)
    assert read("day_ms_p95", run) == pytest.approx(50.0)


def test_copies_are_busy_but_not_launches():
    run, end = recorded_run()
    copy = Kernel("Memcpy DtoH (Device -> Pageable)", end, 5.0)
    run.trace = run.trace._replace(kernels=run.trace.kernels + [copy])
    assert read("launches_per_step.sim", run) == pytest.approx(7.0)
    assert trace.busy_us(run.trace.kernels) == pytest.approx(
        end - 72 * 7 * 1.0 + 5.0)
