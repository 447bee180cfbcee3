"""The column-physics CUDA kernel on the card (marked ``gpu``; every test
skips without a CUDA device). This file imports neither JAX nor
speedy_tpu, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The kernel is held against its plain PyTorch chain on the same CUDA
tensors (field-normalised error, fp64 <= 1e-12, fp32 <= 1e-4) for every
built level count, and the CUDA model against the CPU model after boot +
6 fp64 steps (<= 1e-10).
"""
import os
import sys

import pytest
import torch

from speedy_tpu_torch.config import t30
from speedy_tpu_torch.models.model import Model
from speedy_tpu_torch.models.physics import fused
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils.synthetic_bc import synthetic_boundaries

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


@pytest.mark.parametrize("kx", [5, 7, 8])
@pytest.mark.parametrize("precision", ["fp64", "fp32"])
def test_kernel_matches_plain_chain(smoke, bc, kx, precision):
    bound = smoke.FP64_BOUND if precision == "fp64" else smoke.FP32_BOUND
    m = Model(t30(precision=precision, kx=kx), device="cuda", bc_arrays=bc)
    for sw in (True, False):
        booted, block = smoke.physics_case(m, sw)
        for ins in (booted, smoke.perturb(booted)):
            kout = fused.launch_kernel(m.cfg, sw, ins, block)
            pout = fused.plain_outputs(m.cfg, m.pp, sw, ins)
            errs = smoke.field_errors(kout, pout)
            for name, (e, _) in zip(smoke.OUTPUT_NAMES, errs):
                assert e <= bound, (sw, name, e)


def test_cuda_steps_match_cpu(smoke, bc):
    states = []
    for device in ("cpu", "cuda"):
        m = Model(t30(precision="fp64"), device=device, bc_arrays=bc)
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
    fused.reset_launches()
    m.run_fast(START, 1)
    assert fused.launches == 2 + m.cfg.nsteps
    assert fused.launches_sw == 2 + m.cfg.nsteps // m.cfg.nstrad
