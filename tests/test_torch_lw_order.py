"""The reference-order LW sweeps (``lw_band_vectorized=False``) of the
port against the JAX package, fp64 on the CPU, on the stand-in boundary
set (the JAX model reads HDF5 copies of it, the port the same arrays in
memory):

* the standalone pair on seeded inputs (<= 1e-15 relative per output;
  with a member axis, within that bound of member-by-member calls), in
  both orders;
* the column-physics chain at T30, SW and non-SW (<= 1e-12), and against
  the JAX package's Pallas kernel in interpret mode at T21 kx=5
  (<= 1e-12);
* the port's two orders are not ``torch.equal`` (standalone and in the
  chain), so the flag reaches the arithmetic;
* the model after boot, 6 steps and one day at T21 kx=5 (<= 1e-10).

Bounds are max |port - jax| / max |jax| per field (tests/torch_parity.py).
The CUDA kernel's reference-order variant is held against this chain on
the card (tests/test_torch_gpu.py).
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
from speedy_tpu.models.physics import longwave as jlw
from speedy_tpu.models.tendencies import grid_dynamics_tendencies as jgdt
from speedy_tpu.utils import calendar as jcal
from speedy_tpu_torch.config import t30
from speedy_tpu_torch.models import physics as tphys
from speedy_tpu_torch.models.model import Model
from speedy_tpu_torch.models.physics import fused as tfused
from speedy_tpu_torch.models.physics import longwave as tlw
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils.synthetic_bc import (synthetic_boundaries,
                                                 write_boundary_files)
from torch_parity import (NAMES, PHYSICS_BOUND, SMALL, START, assert_close,
                          flat, jax_steps, perturbed, port_steps, rel_err,
                          to_port)

LW_BOUND = 1e-15


@pytest.fixture(scope="module")
def bc():
    return synthetic_boundaries(0)


@pytest.fixture(scope="module")
def bc_dir(bc, tmp_path_factory):
    d = tmp_path_factory.mktemp("bc")
    write_boundary_files(str(d), bc)
    return str(d)


LW_PAIRS = {"ref": (jlw.downward_longwave, jlw.upward_longwave,
                    tlw.downward_longwave, tlw.upward_longwave),
            "vec": (jlw.downward_longwave_vec, jlw.upward_longwave_vec,
                    tlw.downward_longwave_vec, tlw.upward_longwave_vec)}


@pytest.fixture(scope="module")
def lw_inputs():
    """Seeded LW inputs at kx=8 on a 6 x 10 grid: temperatures around a
    standard profile, band transmissivities from seeded absorber amounts,
    the stratospheric corrections and the surface flux."""
    kx, il, ix = 8, 6, 10
    rng = np.random.default_rng(3)
    sig = np.linspace(0.05, 0.95, kx)
    ta = 288.0 * np.maximum(0.3, sig)[:, None, None] ** 0.28 \
        + rng.normal(0.0, 3.0, (kx, il, ix))
    dhs = np.full(kx, 1.0 / kx)
    tau2 = np.exp(-np.array([0.3, 6.0, 1.4, 25.0])[:, None, None, None]
                  * dhs[None, :, None, None]
                  * rng.uniform(0.5, 1.0, (4, kx, il, ix)))
    ts = ta[-1] + rng.normal(2.0, 1.0, (il, ix))
    return dict(wvi2=rng.uniform(0.3, 0.7, kx), dhs=dhs, ta=ta, tau2=tau2,
                stratc=rng.uniform(0.0, 5.0, (2, il, ix)), ts=ts,
                fsfcu=0.98 * 5.67e-8 * ts ** 4)


def lw_outputs(pair, x, lib):
    """(down outputs..., up outputs...) of an LW pair on ``x``'s arrays,
    through JAX (lib 'jax') or the port (lib 'torch')."""
    jd, ju, td, tu = pair
    down, up = (jd, ju) if lib == "jax" else (td, tu)
    a = (lambda v: jnp.asarray(v)) if lib == "jax" else torch.as_tensor
    d = down(x["wvi2"], a(x["tau2"]), a(x["ta"]))
    u = up(x["dhs"], a(x["tau2"]), a(x["stratc"]), a(x["ta"]), a(x["ts"]),
           d[0], a(x["fsfcu"]), d[2], d[3], d[4], d[1])
    return list(d) + list(u)


@pytest.mark.parametrize("order", list(LW_PAIRS))
def test_lw_pair_matches_jax(lw_inputs, order):
    """slrd, dfabs, st4a1, st4a2, flux, slr, olr and the final dfabs."""
    pair = LW_PAIRS[order]
    for i, (j, t) in enumerate(zip(lw_outputs(pair, lw_inputs, "jax"),
                                   lw_outputs(pair, lw_inputs, "torch"))):
        assert t.shape == tuple(j.shape), i
        assert rel_err(t, j) <= LW_BOUND, (i, rel_err(t, j))


def test_lw_orders_differ(lw_inputs):
    """The two orders round differently: the absorbed fluxes (dfabs after
    each sweep) and olr are not equal, the fluxes themselves are."""
    ref = lw_outputs(LW_PAIRS["ref"], lw_inputs, "torch")
    vec = lw_outputs(LW_PAIRS["vec"], lw_inputs, "torch")
    for i in (1, 6, 7):   # dfabs (down), olr, dfabs (up)
        assert not torch.equal(ref[i], vec[i]), i
        assert rel_err(ref[i], vec[i].numpy()) <= 1e-12, i
    for i in (0, 2, 3, 4, 5):   # slrd, st4a1, st4a2, flux, slr
        assert torch.equal(ref[i], vec[i]), i


def test_lw_reference_order_with_members(lw_inputs):
    """A leading member axis batches through the reference-order pair: each
    member's outputs match a call on that member's inputs alone, within
    the parity bound (not bit for bit: PyTorch's CPU ``pow`` rounds an
    element by where it falls in its vector loop, and st4a1 takes a fourth
    power)."""
    x = lw_inputs
    other = dict(x, ta=x["ta"] + 1.5, tau2=x["tau2"] ** 1.1,
                 ts=x["ts"] - 1.0, fsfcu=x["fsfcu"] * 0.99)
    both = {k: np.stack([x[k], other[k]]) if k not in ("wvi2", "dhs")
            else x[k] for k in x}
    pair = LW_PAIRS["ref"]
    batched = lw_outputs(pair, both, "torch")
    for m, single in enumerate((x, other)):
        for i, (b, s) in enumerate(zip(batched,
                                       lw_outputs(pair, single, "torch"))):
            assert b[m].shape == s.shape, (m, i)
            assert rel_err(b[m], s.numpy()) <= LW_BOUND, (m, i)


@pytest.fixture(scope="module")
def ref_physics(bc, bc_dir):
    """The physics inputs of the JAX T30 model's booted state with seeded
    noise (convection and clouds active), and both packages' chains on
    them in the reference LW order, SW and non-SW; the port's chain in the
    default order too."""
    jcfg = jt30(precision="fp64", lw_band_vectorized=False)
    jm = JModel(jcfg, bc_search=[bc_dir])
    start = jcal.Datetime(*START)
    js = jm.initialize(start)
    im, tmo, ty = jcal.season_vars(start, 1, 1)
    ds = jcoupling.make_date_scalars(jcfg, jm.geom_np, im, tmo, ty,
                                     year=1982)
    daily = jcoupling.daily_update(jcfg, jm.pp, jm.lsp, jm.mc.dyn.sc,
                                   jm.mc.clim, ds, js.surf)
    phi0 = jgeop(jm.mc.dyn.gc, js.prog.t[0], jm.mc.dyn.phis)
    pg = jgdt(jcfg, jm.mc.dyn, jm.mc.ic_2dt, js.prog, 1, phi0)[1]
    pg = perturbed(pg)
    tm = Model(t30(precision="fp64", lw_band_vectorized=False),
               device="cpu", bc_arrays=bc)
    pp = jm.pp
    args = [pg.ug, pg.vg, pg.tg, pg.qg, pg.phig, pg.pslg,
            daily.fsol, daily.ozupp, daily.ozone, daily.zenit, daily.stratz,
            daily.albsfc, daily.ablco2, daily.alb_l, daily.alb_s,
            daily.snowc, daily.soilw_am, js.surf.stl_am, js.surf.sst_am,
            jnp.asarray(pp.forog), jnp.asarray(pp.coa),
            jnp.asarray(pp.phis0), jnp.asarray(pp.fmask_l)]
    out = {}
    for sw in (True, False):
        carried = [None] * 4 if sw else list(js.rad[:4])
        jout = flat(jphys.grid_physics_core(jcfg, pp, sw, *args, *carried))
        targs = [None if a is None else torch.from_numpy(np.array(a))
                 for a in args + carried]
        tout = flat(tphys.grid_physics_core(tm.cfg, tm.pp, sw, *targs))
        vec_cfg = t30(precision="fp64")
        tvec = flat(tphys.grid_physics_core(vec_cfg, tm.pp, sw, *targs))
        out[sw] = (jout, tout, tvec)
    return out


@pytest.mark.parametrize("compute_sw,name",
                         [(True, n) for n in NAMES]
                         + [(False, n) for n in NAMES[:21]])
def test_reference_lw_physics_matches_jax(ref_physics, compute_sw, name):
    jout, tout, _ = ref_physics[compute_sw]
    i = NAMES.index(name)
    assert tout[i].shape == tuple(jout[i].shape), name
    assert rel_err(tout[i], jout[i]) <= PHYSICS_BOUND, name


@pytest.mark.parametrize("compute_sw", [True, False])
def test_reference_lw_physics_differs_from_default(ref_physics, compute_sw):
    """The LW heating (in ttend) and olr of the two orders are not equal."""
    _, tout, tvec = ref_physics[compute_sw]
    for name in ("ttend", "olr"):
        i = NAMES.index(name)
        assert not torch.equal(tout[i], tvec[i]), name
        assert rel_err(tout[i], tvec[i].numpy()) <= 1e-12, name


@pytest.fixture(scope="module")
def ref_model_runs(bc, bc_dir):
    """Both models at T21 kx=5 with the reference LW order: boot, 6 steps
    and one day from the JAX booted state; and the JAX model itself (for
    the interpreted kernel)."""
    jm = JModel(jt30(lw_band_vectorized=False, **SMALL),
                bc_search=[bc_dir])
    tm = Model(t30(lw_band_vectorized=False, **SMALL), device="cpu",
               bc_arrays=bc)
    jstart, start = jcal.Datetime(*START), cal.Datetime(*START)
    jboot, js, ds = jax_steps(jm, jstart)
    tboot, ts = port_steps(tm, start)
    jday, _ = jm._run_day(jm.mc, jboot, ds, collect_output=False)
    tday, _ = tm.run_day(to_port(jboot), start, start)
    return dict(boot=(jboot, tboot), steps=(js, ts), day=(jday, tday),
                jm=jm, tm=tm)


@pytest.mark.parametrize("stage", ["boot", "steps", "day"])
def test_reference_lw_model_matches_jax(ref_model_runs, stage):
    assert_close(*ref_model_runs[stage])


def test_reference_lw_physics_matches_interpreted_pallas_kernel(
        ref_model_runs, bc):
    """One SW call of the JAX package's Pallas kernel in interpret mode
    (fuse_physics=True on the CPU) in the reference LW order, at T21 kx=5,
    against the port's chain on the same perturbed inputs."""
    from speedy_tpu.models.physics import fused as jfused
    from speedy_tpu_torch.models.tendencies import PhysicsGridState
    jm, tm = ref_model_runs["jm"], ref_model_runs["tm"]
    jcfg, start = jm.cfg, jcal.Datetime(*START)
    js = ref_model_runs["boot"][0]
    im, tmo, ty = jcal.season_vars(start, 1, 1)
    ds = jcoupling.make_date_scalars(jcfg, jm.geom_np, im, tmo, ty,
                                     year=1982)
    daily = jcoupling.daily_update(jcfg, jm.pp, jm.lsp, jm.mc.dyn.sc,
                                   jm.mc.clim, ds, js.surf)
    phi0 = jgeop(jm.mc.dyn.gc, js.prog.t[0], jm.mc.dyn.phis)
    pg = perturbed(jgdt(jcfg, jm.mc.dyn, jm.mc.ic_2dt, js.prog, 1,
                        phi0)[1])
    kcfg = jt30(fuse_physics=True, lw_band_vectorized=False, **SMALL)
    jout = flat(jfused.fused_grid_physics(kcfg, jm.pp, True, daily,
                                          js.surf, js.rad, pg))
    t = lambda a: torch.from_numpy(np.array(a))
    tdaily = tphys.DailyForcing(**{f: t(getattr(daily, f))
                                   for f in tphys.DailyForcing._fields})
    tsurf = tphys.SurfaceState(**{f: t(getattr(js.surf, f))
                                  for f in tphys.SurfaceState._fields})
    tpg = PhysicsGridState(*[t(x) for x in pg[:6]])
    tout = flat(tfused.fused_grid_physics(
        tm.cfg, tm.pp, True, tdaily, tsurf,
        tphys.RadiationState(*[t(x) for x in js.rad]), tpg))
    for name, j, tt in zip(NAMES, jout, tout):
        assert rel_err(tt, j) <= PHYSICS_BOUND, name


SASS_LISTING = (
    "\tcode for sm_90a\n"
    "\t\tFunction : _ZN12_GLOBAL__N_121column_physics_kernelIfLi8ELb0ELb0E"
    "{extra}EvNS_6ParamsIT_EE\n"
    "        /*0000*/                   LDC R1, c[0x0][0x28] ;"
    "                     /* 0x00000a00ff017b82 */\n"
    "                                                        "
    "                      /* 0x000fe20000000800 */\n"
    "        /*0010*/                   {op} R0, SR_TID.X ;"
    "                        /* 0x0000000000007919 */\n")


def test_sass_diff_keys_and_compares_kernels(monkeypatch):
    """sass_diff keys a listing's column-physics kernels by their template
    arguments (a build without the LW order reads as the default order)
    and compares their instruction text, not addresses or encodings."""
    from speedy_tpu_torch import sass_diff
    listings = {"old.so": SASS_LISTING.format(extra="", op="S2R"),
                "new.so": SASS_LISTING.format(extra="Lb0E", op="S2R"),
                "changed.so": SASS_LISTING.format(extra="Lb0E", op="CS2R")}
    monkeypatch.setattr(sass_diff, "cuobjdump", lambda: "cuobjdump")
    monkeypatch.setattr(
        sass_diff.subprocess, "run",
        lambda cmd, **kw: type("R", (), {"stdout": listings[cmd[-1]]}))
    old = sass_diff.kernels("old.so")
    assert old == {("f", "8", "0", "0", "0"): ["LDC R1, c[0x0][0x28]",
                                               "S2R R0, SR_TID.X"]}
    assert sass_diff.kernels("new.so") == old
    assert sass_diff.main(["old.so", "new.so"]) == 0
    assert sass_diff.main(["old.so", "changed.so"]) == 1
