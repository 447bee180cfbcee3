"""speedy_tpu_torch.ops.fused_transforms on the CPU: the wrappers of the
spectral-transform CUDA kernels run their plain twin (the einsum chain of
ops/spectral.py) on CPU tensors.

* Against the JAX package's Pallas kernels (speedy_tpu/ops/
  pallas_transforms.py) run in interpret mode exactly as
  tests/test_spectral.py runs them: fp32, T30, B=6. Analysis is held to
  that test's tolerance (rtol=1e-5, atol=1e-6). Synthesis is held to
  rtol=1e-5 and an atol of twice the Pallas kernel's own largest error
  against the fp64 einsum chain on the same inputs (3.8e-5 for fields up
  to ~22 in magnitude): the port's fp32 einsum sums in another order than
  XLA's dot, and one of 27,648 values differs from the Pallas result by
  1.8e-5, more than the 1e-5 that test allows between the two XLA paths,
  while both lie as close to the fp64 result (4.2e-5 and 3.8e-5).
* Against the JAX einsum path in fp64 at T30 and T85: max |port - jax| /
  max |jax| <= 1e-12.
* The kernel launchers refuse CPU tensors, and the CPU path launches
  nothing. The shared-memory plans fit every preset (synthesis at every
  batch up to 256), and the per-m truncation extents the wrappers pass
  match their tables (cpol_inv for synthesis, cpol_dir for analysis). The
  kernels themselves are held against the twin on the card in
  tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from speedy_tpu import config as jconfig
from speedy_tpu.geometry import build_geometry_np as jgeom_np
from speedy_tpu.ops import spectral as jsp
from speedy_tpu_torch import config as tconfig
from speedy_tpu_torch.geometry import build_geometry_np
from speedy_tpu_torch.ops import fused_transforms as ft
from speedy_tpu_torch.ops import spectral as tsp
from speedy_tpu_torch.utils.tracing import counters, reset

BOUND = 1e-12


def rel_err(port, ref):
    port = port.cpu().numpy()
    ref = np.asarray(ref)
    return np.abs(port - ref).max() / np.abs(ref).max()


def consts(preset, precision):
    jcfg = jconfig.from_preset(preset, precision=precision)
    tcfg = tconfig.from_preset(preset, precision=precision)
    return (tcfg, jsp.build_spectral(jcfg, jgeom_np(jcfg)),
            tsp.build_spectral(tcfg, build_geometry_np(tcfg), "cpu"))


def test_matches_pallas_kernels_interpreted():
    from jax.experimental.pallas import tpu as pltpu
    from speedy_tpu.ops import pallas_transforms as pt

    cfg, jsc, tsc = consts("t30", "fp32")
    _, jsc64, _ = consts("t30", "fp64")
    ftab = pt.build_fused_tables(jsc)
    rng = np.random.default_rng(3)
    b = 6
    spec = rng.standard_normal((b, cfg.mx, cfg.nx, 2)).astype(np.float32)
    grid = rng.standard_normal((b, cfg.il, cfg.ix)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        g_p = pt.fused_spec_to_grid(ftab, jnp.asarray(spec), cfg.il, cfg.ix)
        s_p = pt.fused_grid_to_spec(ftab, jnp.asarray(grid), cfg.mx, cfg.nx)
    g_t = ft.fused_spec_to_grid(tsc, torch.from_numpy(spec))
    s_t = ft.fused_grid_to_spec(tsc, torch.from_numpy(grid))
    assert g_t.dtype == torch.float32 and s_t.dtype == torch.float32
    g64 = jsp.spec_to_grid(jsc64, jnp.asarray(spec, jnp.float64))
    pallas_err = np.abs(np.asarray(g_p, np.float64) - np.asarray(g64)).max()
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_p),
                               rtol=1e-5, atol=2.0 * pallas_err)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_p),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("preset", ["t30", "t85"])
@pytest.mark.parametrize("batch", [1, 7])
def test_matches_jax_einsum_fp64(preset, batch):
    cfg, jsc, tsc = consts(preset, "fp64")
    rng = np.random.default_rng(4)
    spec = rng.standard_normal((batch, cfg.mx, cfg.nx, 2))
    grid = rng.standard_normal((batch, cfg.il, cfg.ix))
    g = ft.fused_spec_to_grid(tsc, torch.from_numpy(spec))
    s = ft.fused_grid_to_spec(tsc, torch.from_numpy(grid))
    assert tuple(g.shape) == (batch, cfg.il, cfg.ix)
    assert tuple(s.shape) == (batch, cfg.mx, cfg.nx, 2)
    assert rel_err(g, jsp.spec_to_grid(jsc, jnp.asarray(spec))) <= BOUND
    assert rel_err(s, jsp.grid_to_spec(jsc, jnp.asarray(grid))) <= BOUND


def test_cpu_path_launches_nothing():
    cfg, _, tsc = consts("t30", "fp64")
    reset()
    ft.fused_spec_to_grid(tsc, torch.zeros(2, cfg.mx, cfg.nx, 2,
                                           dtype=torch.float64))
    ft.fused_grid_to_spec(tsc, torch.zeros(2, cfg.il, cfg.ix,
                                           dtype=torch.float64))
    assert counters["k2.launches_syn"] == 0
    assert counters["k2.launches_ana"] == 0


@pytest.mark.parametrize("direction", ["syn", "ana"])
def test_kernel_refuses_cpu_tensors(direction):
    cfg, _, tsc = consts("t30", "fp64")
    if direction == "syn":
        x = torch.zeros(2, cfg.mx, cfg.nx, 2, dtype=torch.float64)
        launch = ft.launch_synthesis
    else:
        x = torch.zeros(2, cfg.il, cfg.ix, dtype=torch.float64)
        launch = ft.launch_analysis
    with pytest.raises(ValueError, match="CUDA"):
        launch(tsc, x)


@pytest.mark.parametrize("preset", ["t30", "t85", "t170"])
def test_shared_memory_fits_every_preset(preset):
    """In fp32 and fp64 at every preset up to T170, the synthesis plan fits
    the H100's 227 KB per block (two blocks per SM where it can) and the
    kernel's limits on its tile, and the analysis plan fits the same and
    the kernel's limits on its chunks."""
    cfg = tconfig.from_preset(preset)
    dims = (cfg.mx, cfg.nx, cfg.il, cfg.ix)
    for itemsize in (4, 8):
        for batch in (1, 57, 256):
            plan = ft.synthesis_plan(*dims, itemsize, batch)
            assert ft.smem_bytes("syn", *dims, itemsize, batch) == plan.smem
            assert plan.smem <= ft.SMEM_TARGET
            assert (plan.fb, plan.tj) in ft.SYN_BUILT_TILES[itemsize]
            assert cfg.il % plan.tj == 0 and cfg.ix % plan.ti == 0
            assert plan.ti % (16 // itemsize) == 0
            r = plan.fb * plan.tj
            assert 0 < ft.syn_ri(itemsize, r, plan.ti) <= ft.syn_ri_max(
                itemsize, r)
            assert 1 <= plan.mc <= cfg.mx
            assert plan.smem == ft.synthesis_smem(plan.fb, plan.tj, plan.ti,
                                                  plan.mc, cfg.nx, itemsize)
        ana = ft.analysis_plan(*dims, itemsize)
        assert ft.smem_bytes("ana", *dims, itemsize, 1) == ana.smem
        assert ana.smem <= ft.MAX_SMEM_BYTES
        assert (ana.fb, ana.tm) in ft.ANA_BUILT_TILES
        assert cfg.il % ana.jc == 0
        assert ana.fb * ana.jc <= ft.ana_max_rows(ana.tm)
        assert ana.tm * -(-ana.nc // ft.ANA_RN) <= ft.ANA_THREADS
        assert ana.smem == ft.analysis_smem(ana.fb, ana.tm, cfg.il, cfg.ix,
                                            ana.jc, ana.nc, ana.early,
                                            itemsize)
        assert not ana.early or ana.nc == cfg.nx


@pytest.mark.parametrize("preset", ["t30", "t42", "t63", "t85", "t170"])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_synthesis_plan_every_batch(preset, itemsize):
    """At every batch from 1 to 256 the synthesis plan picks a built tile
    that fits, or raises ValueError (it never does at these presets); a
    tile the kernel is not built for, or a TI that is not a divisor of ix,
    raises."""
    cfg = tconfig.from_preset(preset)
    dims = (cfg.mx, cfg.nx, cfg.il, cfg.ix)
    for batch in range(1, 257):
        plan = ft.synthesis_plan(*dims, itemsize, batch)
        assert (plan.fb, plan.tj) in ft.SYN_BUILT_TILES[itemsize]
        assert plan.smem <= ft.MAX_SMEM_BYTES
    for tiles in [(3, 8)] + [t for t in ft.SYN_BUILT_TILES[4]
                             if t not in ft.SYN_BUILT_TILES[itemsize]]:
        with pytest.raises(ValueError, match="not built"):
            ft.synthesis_plan(*dims, itemsize, 1, tiles=tiles)
    with pytest.raises(ValueError, match="TI="):
        ft.synthesis_plan(*dims, itemsize, 1, tiles=(2, 8, cfg.ix - 4))


def test_analysis_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="not built"):
        ft.analysis_plan(31, 32, 48, 96, 4, tiles=(3, 3))
    with pytest.raises(ValueError, match="shared memory"):
        ft.analysis_plan(31, 32, 48, 8192, 8)
    with pytest.raises(ValueError, match="shared memory"):
        ft.synthesis_plan(31, 8192, 48, 96, 8, 1)


@pytest.mark.parametrize("preset", ["t30", "t42", "t63", "t85", "t170"])
def test_truncation_extent_matches_cpol_dir(preset):
    """The per-m extent the analysis wrapper passes: the rows of cpol_dir
    at and above it are zero, the row below it is not, and it is the
    triangular truncation's n <= min(trunc, trunc + 1 - m). Computed once
    per table."""
    cfg = tconfig.from_preset(preset, precision="fp32")
    sc = tsp.build_spectral(cfg, build_geometry_np(cfg), "cpu")
    extent = ft.truncation_extent(sc.cpol_dir)
    assert extent.dtype == torch.int32 and tuple(extent.shape) == (cfg.mx,)
    m = np.arange(cfg.mx)
    np.testing.assert_array_equal(
        extent.numpy(), np.minimum(cfg.trunc, cfg.trunc + 1 - m) + 1)
    rows = (sc.cpol_dir != 0).any(dim=-1)              # [mx, nx]
    for mm, e in enumerate(extent.tolist()):
        assert not rows[mm, e:].any() and rows[mm, e - 1]
    assert ft.truncation_extent(sc.cpol_dir) is extent


@pytest.mark.parametrize("preset", ["t30", "t42", "t63", "t85", "t170"])
def test_truncation_extent_matches_cpol_inv(preset):
    """The per-m extent the synthesis wrapper passes comes from cpol_inv:
    min(nx, trunc + 2 - m), the rows of cpol_inv at and above it zero. It
    keeps n = trunc + 1 at m = 0, which cpol_dir's extent drops."""
    cfg = tconfig.from_preset(preset, precision="fp32")
    sc = tsp.build_spectral(cfg, build_geometry_np(cfg), "cpu")
    extent = ft.truncation_extent(sc.cpol_inv)
    m = np.arange(cfg.mx)
    np.testing.assert_array_equal(
        extent.numpy(), np.minimum(cfg.nx, cfg.trunc + 2 - m))
    rows = (sc.cpol_inv != 0).any(dim=-1)              # [mx, nx]
    for mm, e in enumerate(extent.tolist()):
        assert not rows[mm, e:].any() and rows[mm, e - 1]
    ext_dir = ft.truncation_extent(sc.cpol_dir)
    assert int(extent[0]) == cfg.trunc + 2 == int(ext_dir[0]) + 1
    assert torch.equal(extent[1:], ext_dir[1:])
