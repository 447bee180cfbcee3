"""The CUDA kernels on the card (marked ``gpu``; every test skips without
a CUDA device). This file imports neither JAX nor speedy_tpu, so it also
runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The column-physics kernel is held against its plain PyTorch chain on the
same CUDA tensors (field-normalised error, fp64 <= 1e-12, fp32 <= 1e-4)
for every built level count, the spectral-transform kernels against their
einsum chain (fp64 <= 1e-12, fp32 <= 1e-5) at T30 and T85, and the CUDA
model against the CPU model after boot + 6 fp64 steps (<= 1e-10), with
SPPT off and on (the same innovations from a numpy seed).
"""
import os
import sys

import numpy as np
import pytest
import torch

from speedy_tpu_torch.config import from_preset, t30
from speedy_tpu_torch.geometry import build_geometry_np
from speedy_tpu_torch.models.model import Model
from speedy_tpu_torch.models.physics import fused
from speedy_tpu_torch.ops import fused_transforms as ft
from speedy_tpu_torch.ops import spectral as sp
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


@pytest.mark.parametrize("preset,batch", [("t30", 25), ("t30", 57),
                                          ("t85", 48)])
@pytest.mark.parametrize("precision", ["fp64", "fp32"])
def test_transform_kernels_match_einsum(smoke, preset, batch, precision):
    cfg = from_preset(preset, precision=precision)
    sc = sp.build_spectral(cfg, build_geometry_np(cfg), "cuda")
    rng = np.random.default_rng(batch)
    spec = torch.as_tensor(rng.standard_normal((batch, cfg.mx, cfg.nx, 2)),
                           dtype=cfg.rdtype, device="cuda")
    grid = torch.as_tensor(rng.standard_normal((batch, cfg.il, cfg.ix)),
                           dtype=cfg.rdtype, device="cuda")
    bound = smoke.TRANSFORM_BOUND[cfg.rdtype]
    ft.reset_launches()
    for kernel, plain, x in ((ft.fused_spec_to_grid, sp.spec_to_grid, spec),
                             (ft.fused_grid_to_spec, sp.grid_to_spec, grid)):
        (err, _), = smoke.field_errors([kernel(sc, x)], [plain(sc, x)])
        assert err <= bound, (kernel.__name__, err)
    assert ft.launches_syn == 1 and ft.launches_ana == 1


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
    fused.reset_launches()
    m.run_fast(START, 1)
    assert fused.launches == 2 + m.cfg.nsteps
    assert fused.launches_sw == 2 + m.cfg.nsteps // m.cfg.nstrad
