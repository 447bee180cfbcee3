"""The port's column physics against the JAX package, fp64 on the CPU.

Inputs come from the JAX model's booted T30 state on the stand-in boundary
set: the physics grid fields of the first leapfrog step, the daily forcing,
the surface and the radiation state. The same numpy arrays go through
speedy_tpu's grid_physics_core (and once through its Pallas kernel in
interpret mode) and through the port's grid_physics_core, which is the
CPU path of the column-physics kernel's wrapper. Bound: max |port - jax| /
max |jax| <= 1e-12 per output. The kernel itself runs only on a GPU
(tests/test_torch_gpu.py and chip_smoke.py hold it against this chain).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from speedy_tpu.config import t30 as jt30
from speedy_tpu.models import coupling as jcoupling
from speedy_tpu.models import physics as jphys
from speedy_tpu.models.geopotential import get_geopotential as jgeop
from speedy_tpu.models.model import Model as JModel
from speedy_tpu.models.tendencies import grid_dynamics_tendencies as jgdt
from speedy_tpu.utils import calendar as jcal
from speedy_tpu_torch.config import PRESETS, from_preset, t30
from speedy_tpu_torch.models import physics as tphys
from speedy_tpu_torch.models.model import Model
from speedy_tpu_torch.models.physics import fused
from speedy_tpu_torch.utils.tracing import counters, reset
from speedy_tpu_torch.utils.synthetic_bc import (synthetic_boundaries,
                                                 write_boundary_files)
from torch_parity import mismatch_report

BOUND = 1e-12
NAMES = ["utend", "vtend", "ttend", "qtend", "precnv", "precls", "cbmf",
         "slrd", "slr", "olr", "ustr", "vstr", "shf", "evap", "slru",
         "hfluxn", "tsfc", "tskin", "u0", "v0", "t0",
         "tau2", "stratc", "tt_rsw", "ssrd", "ssr", "tsr"]


def rel_err(port, ref):
    port = port.cpu().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def flat(outs):
    """(..., sfc, ...) -> list of the 21/27 arrays in NAMES order."""
    return list(outs[:10]) + list(outs[10]) + list(outs[11:])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    bc = synthetic_boundaries(0)
    d = tmp_path_factory.mktemp("bc")
    write_boundary_files(str(d), bc)
    jcfg = jt30(precision="fp64")
    jm = JModel(jcfg, bc_search=[str(d)])
    start = jcal.Datetime(1982, 1, 1)
    js = jm.initialize(start)
    im, tm, ty = jcal.season_vars(start, 1, 1)
    ds = jcoupling.make_date_scalars(jcfg, jm.geom_np, im, tm, ty, year=1982)
    daily = jcoupling.daily_update(jcfg, jm.pp, jm.lsp, jm.mc.dyn.sc,
                                   jm.mc.clim, ds, js.surf)
    phi0 = jgeop(jm.mc.dyn.gc, js.prog.t[0], jm.mc.dyn.phis)
    pg = jgdt(jcfg, jm.mc.dyn, jm.mc.ic_2dt, js.prog, 1, phi0)[1]
    tm_ = Model(t30(precision="fp64"), device="cpu", bc_arrays=bc)
    return jcfg, jm, js, daily, pg, tm_


def jax_args(jm, daily, js, pg):
    """Keyword-free argument list of grid_physics_core after compute_sw."""
    pp = jm.pp
    return [pg.ug, pg.vg, pg.tg, pg.qg, pg.phig, pg.pslg,
            daily.fsol, daily.ozupp, daily.ozone, daily.zenit, daily.stratz,
            daily.albsfc, daily.ablco2, daily.alb_l, daily.alb_s,
            daily.snowc, daily.soilw_am, js.surf.stl_am, js.surf.sst_am,
            jnp.asarray(pp.forog), jnp.asarray(pp.coa),
            jnp.asarray(pp.phis0), jnp.asarray(pp.fmask_l)]


def carried(js, compute_sw):
    r = js.rad
    return [None] * 4 if compute_sw else [r.tau2, r.stratc, r.tt_rsw, r.ssrd]


def perturbed(pg, seed=0):
    """The physics grid fields with seeded noise on the winds and
    temperature and extra moisture, so that convection and clouds are
    active (the booted rest state does not convect)."""
    rng = np.random.default_rng(seed)
    shape = tuple(pg.tg.shape)
    return pg._replace(ug=pg.ug + rng.normal(0.0, 5.0, shape),
                       vg=pg.vg + rng.normal(0.0, 5.0, shape),
                       tg=pg.tg + rng.normal(0.0, 1.5, shape),
                       qg=pg.qg * (1.0 + rng.uniform(0.0, 0.6, shape)))


CASES = ("booted", "perturbed")


@pytest.fixture(scope="module")
def outputs(setup):
    """Both chains on the same inputs, per case and compute_sw."""
    jcfg, jm, js, daily, pg, tm = setup
    res = {}
    for case in CASES:
        cpg = pg if case == "booted" else perturbed(pg)
        for sw in (True, False):
            args = jax_args(jm, daily, js, cpg) + carried(js, sw)
            jout = flat(jphys.grid_physics_core(jcfg, jm.pp, sw, *args))
            targs = [None if a is None else torch.from_numpy(np.array(a))
                     for a in args]
            tout = flat(tphys.grid_physics_core(tm.cfg, tm.pp, sw, *targs))
            res[case, sw] = (jout, tout)
            res["inputs", case, sw] = targs
    return res


def test_perturbed_case_convects(outputs):
    jout, tout = outputs["perturbed", True]
    cbmf = np.asarray(jout[NAMES.index("cbmf")])
    assert (cbmf > 0).sum() > 100
    assert (tout[NAMES.index("cbmf")] > 0).sum() == (cbmf > 0).sum()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("compute_sw,name",
                         [(True, n) for n in NAMES]
                         + [(False, n) for n in NAMES[:21]])
def test_physics_chain_matches_jax(outputs, case, compute_sw, name):
    jout, tout = outputs[case, compute_sw]
    assert len(jout) == len(tout) == (27 if compute_sw else 21)
    i = NAMES.index(name)
    assert tout[i].shape == tuple(jout[i].shape), name
    assert rel_err(tout[i], jout[i]) <= BOUND, mismatch_report(
        outputs["inputs", case, compute_sw], [name], [tout[i]], [jout[i]])


def test_physics_matches_interpreted_pallas_kernel(setup, outputs):
    """One SW call of the JAX package's Pallas kernel in interpret mode
    (fuse_physics=True on the CPU, as tests/test_fused_physics.py runs it)
    against the port's chain on the same inputs."""
    from speedy_tpu.models.physics import fused as jfused
    jcfg, jm, js, daily, pg, tm = setup
    kcfg = jt30(precision="fp64", fuse_physics=True)
    jout = flat(jfused.fused_grid_physics(kcfg, jm.pp, True, daily,
                                          js.surf, js.rad, perturbed(pg)))
    _, tout = outputs["perturbed", True]
    for name, j, t in zip(NAMES, jout, tout):
        assert rel_err(t, j) <= BOUND, name


def test_wrapper_cpu_path_is_plain_chain(setup, outputs):
    """fused_grid_physics on CPU tensors runs grid_physics_core and
    launches nothing."""
    jcfg, jm, js, daily, pg, tm = setup
    t = lambda a: torch.from_numpy(np.array(a))
    fields = dict(fsol=daily.fsol, ozupp=daily.ozupp, ozone=daily.ozone,
                  zenit=daily.zenit, stratz=daily.stratz,
                  ablco2=daily.ablco2, albsfc=daily.albsfc,
                  alb_l=daily.alb_l, alb_s=daily.alb_s, snowc=daily.snowc,
                  soilw_am=daily.soilw_am)
    td = {k: t(v) for k, v in fields.items()}
    zero = torch.zeros_like(td["alb_l"])
    tdaily = tphys.DailyForcing(**{
        f: td.get(f, zero) for f in tphys.DailyForcing._fields})
    tsurf = tphys.SurfaceState(**{f: t(getattr(js.surf, f))
                                  for f in tphys.SurfaceState._fields})
    trad = tphys.RadiationState(*[t(x) for x in js.rad])
    from speedy_tpu_torch.models.tendencies import PhysicsGridState
    tpg = PhysicsGridState(*[t(x) for x in pg[:6]])
    reset()
    for sw in (True, False):
        out = flat(fused.fused_grid_physics(tm.cfg, tm.pp, sw, tdaily, tsurf,
                                            trad, tpg))
        _, ref = outputs["booted", sw]
        for name, a, b in zip(NAMES, out, ref):
            assert torch.equal(a, b), mismatch_report(
                outputs["inputs", "booted", sw], NAMES, out, ref)
    assert counters["k1.launches"] == 0 and counters["k1.launches_sw"] == 0


@pytest.mark.parametrize("threads", [1, 2, 4])
def test_chain_bit_equal_across_thread_counts(setup, outputs, threads):
    """The booted SW chain (T30 fp64) with 1, 2 and 4 intra-op threads is
    torch.equal to the run with the default count: a result that moved
    with the OpenMP team's size would show here."""
    tm = setup[5]
    default = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        out = flat(tphys.grid_physics_core(
            tm.cfg, tm.pp, True, *outputs["inputs", "booted", True]))
    finally:
        torch.set_num_threads(default)
    _, ref = outputs["booted", True]
    for name, a, b in zip(NAMES, out, ref):
        assert torch.equal(a, b), mismatch_report(
            outputs["inputs", "booted", True], NAMES, out, ref)


def test_argument_block_layout(setup):
    """The kernel's argument block carries the plain chain's tables."""
    tm = setup[5]
    block = fused.argument_block(tm.pp)
    assert block.shape == (fused.N_TABLES * fused.MAXL + fused.N_SCALARS,)
    # built once with the model, and what the wrapper hands the kernel
    np.testing.assert_array_equal(tm.pp.kernel_block, block)
    assert tm.pp.kernel_block.dtype == np.float64
    tab = block[:fused.N_TABLES * fused.MAXL].reshape(fused.N_TABLES,
                                                      fused.MAXL)
    kx = tm.cfg.kx
    np.testing.assert_array_equal(tab[0, :kx], tm.pp.fsg)
    np.testing.assert_array_equal(tab[2, :kx + 1], tm.pp.sigh)
    np.testing.assert_array_equal(tab[3, :kx], tm.pp.wvi2)
    # moisture diffusion above the PBL at 1-based levels with sigh > 0.5
    mask = int(block[fused.N_TABLES * fused.MAXL + 6])
    assert mask == sum(1 << k for k in range(3, kx - 1)
                       if tm.pp.sigh[k] > 0.5)


def test_wrapper_rejects_cpu_launch(setup):
    """The kernel path raises on CPU tensors instead of falling back."""
    tm = setup[5]
    ins = [torch.zeros(1, dtype=torch.float64)] * fused.N_IN_SW
    with pytest.raises(ValueError, match="CUDA"):
        fused.launch_kernel(tm.cfg, True, ins, fused.argument_block(tm.pp))
    assert counters["k1.launches"] == 0


STATIC_SMEM_BYTES = 48 * 1024  # a block's shared memory without an opt-in
MAX_SMEM_BYTES = 232448        # 227 KB, the most an H100 block may opt in to


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("itemsize", [4, 8])
def test_block_plan_fits_the_card(preset, itemsize):
    """The kernel's launch fits an H100 at every preset, type, built kx and
    variant: 256 threads (COLS columns x LANES lanes, a lane per level),
    blocks that cover the grid, and shared memory within the 48 KB a block
    gets without an opt-in (fp32) or within the 227 KB opt-in (fp64, which
    the launch requests above 48 KB)."""
    cfg = from_preset(preset)
    ncol = cfg.il * cfg.ix
    for kx in (5, 7, 8):
        for sw in (True, False):
            plan = fused.block_plan(kx, cfg.il, cfg.ix, itemsize, sw)
            assert plan.threads == fused.COLS * fused.LANES == 256
            assert plan.cols == fused.COLS and kx <= fused.LANES
            assert (plan.blocks - 1) * plan.cols < ncol <= plan.blocks * plan.cols
            assert plan.smem <= MAX_SMEM_BYTES
            if itemsize == 4:
                assert plan.smem <= STATIC_SMEM_BYTES
    # the largest block: fp64, kx=8, SW
    assert fused.block_plan(8, cfg.il, cfg.ix, 8, True).smem == (
        (37 + 105 + 112 + 7 + 15) * (32 * 8 + 16))


def test_launch_signature_layout():
    """The wrapper's per-signature record: one output buffer holding the
    outputs back to back, in output_shapes order, and the inputs' sizes in
    kernel_inputs order."""
    for sw, n_in, n_out in ((True, fused.N_IN_SW, fused.N_OUT_SW),
                            (False, fused.N_IN, fused.N_OUT)):
        sig = fused._signature(8, 48, 96, torch.float32, sw)
        assert sig is fused._signature(8, 48, 96, torch.float32, sw)
        assert len(sig.in_shapes) == len(sig.in_numels) == n_in
        assert sig.out_shapes == fused.output_shapes(8, 48, 96, sw)
        assert len(sig.out_numels) == n_out
        ends = np.cumsum(sig.out_numels)
        np.testing.assert_array_equal(sig.out_offsets[1:], ends[:-1] * 4)
        assert [v[2] for v in sig.out_views] == [0] + ends[:-1].tolist()
        buf = torch.arange(float(ends[-1]))
        for (shape, stride, off), n in zip(sig.out_views, sig.out_numels):
            view = torch.as_strided(buf, shape, stride, off)
            assert view.is_contiguous() and view.shape == shape
            assert view.flatten()[0] == off and view.numel() == n
    with pytest.raises(ValueError, match="kx=6"):
        fused._signature(6, 48, 96, torch.float32, True)
    with pytest.raises(ValueError, match="dtype"):
        fused._signature(8, 48, 96, torch.float16, True)
