"""The frozen counts reproduce the bounds that PERF.md gives for the
column-physics kernel K1 and the transform kernels (µs on the H100 at
3.35 TB/s and 67 TFLOP/s)."""
from __future__ import annotations

import pytest

from benchmark import counts

T30 = dict(trunc=30, ix=96, il=48, kx=8)
T85 = dict(trunc=85, ix=256, il=128, kx=8)
T170 = dict(trunc=170, ix=512, il=256, kx=8)


@pytest.mark.parametrize("cfg,members,prec,sw,nosw", [
    (T30, 1, "fp32", 0.782, 0.771), (T30, 1, "fp64", 1.563, 1.541),
    (T85, 1, "fp32", 5.557, 5.479), (T170, 1, "fp32", 22.23, 21.91),
    (T170, 1, "fp64", 44.45, 43.83), (T30, 8, "fp32", 6.020, 5.932),
    (T30, 64, "fp32", 47.92, 47.22), (T30, 64, "fp64", 95.85, 94.44)])
def test_k1_bound(cfg, members, prec, sw, nosw):
    for compute_sw, want in ((True, sw), (False, nosw)):
        got = counts.k1_least_s(cfg, compute_sw, members, prec) * 1e6
        assert got == pytest.approx(want, abs=0.006 * max(1, want / 10))


@pytest.mark.parametrize("direction,cfg,b,want", [
    ("syn", T30, 57, 0.562), ("syn", T30, 25, 0.246), ("ana", T30, 48, 0.473),
    ("ana", T30, 25, 0.246), ("syn", T30, 256, 2.52), ("syn", T85, 256, 49.9)])
def test_transform_bound(direction, cfg, b, want):
    ops = counts.transform_cost(direction, cfg, b)[1]
    assert ops / 67e12 * 1e6 == pytest.approx(want, rel=0.01)


def test_step_batches_are_the_t30_steps():
    assert counts.step_batches(T30, False) == ([57, 34], [48, 25])
    assert counts.step_batches(T30, True) == ([65, 34], [48, 25])


def test_step_operations():
    t30 = counts.step_operations(T30, False)
    assert t30 == pytest.approx(111.957e6, rel=1e-4)
    assert counts.step_operations(T30, True, 64) > 64 * t30
    assert counts.step_operations(T170, False) == pytest.approx(16.9986e9,
                                                                rel=1e-4)
