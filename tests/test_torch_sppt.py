"""SPPT in the port against the JAX package, fp64 on the CPU.

torch cannot reproduce jax.random, so the port is fed the JAX key chain's
innovations through its ``noise`` source (physics/sppt.py): each AR(1)
update of the JAX package splits its key and draws from the sub-key, and
``jax_noise`` makes the same draws in the same order.

* sppt_sigma and sppt_phi: <= 1e-12 relative;
* one AR(1) update and one gen_sppt pattern: <= 1e-12;
* the model with sppt_on=True (T30): the booted state, 6 steps and one
  day, each field and the SPPT spectral state <= 1e-10 (max |port - jax| /
  max |jax|), both models on the stand-in boundary set;
* the port's own generator: one seed gives identical runs, two seeds
  differ, and a state advanced twice gives the same pattern;
* the pattern's grid-point standard deviation before clipping over 300
  AR(1) steps is within 3% of the stationary value the tables give, which
  is STDDEV/sqrt(2) = 0.233, not STDDEV = 0.33, within 3%: the amplitude
  formula of sppt.f90, copied by both packages, normalises by twice the
  variance that the packed-real spectral fields carry.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speedy_tpu.config import t30 as jt30
from speedy_tpu.models import coupling as jcoupling
from speedy_tpu.models.model import Model as JModel
from speedy_tpu.models.physics import sppt as jsppt
from speedy_tpu.utils import calendar as jcal
from speedy_tpu_torch import convert
from speedy_tpu_torch.config import t30
from speedy_tpu_torch.geometry import build_geometry_np
from speedy_tpu_torch.models.model import Model
from speedy_tpu_torch.models.physics import sppt
from speedy_tpu_torch.ops import spectral as sp
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils.synthetic_bc import (synthetic_boundaries,
                                                 write_boundary_files)

BOUND = 1e-12
MODEL_BOUND = 1e-10
START = (1982, 1, 1)
SMALL = dict(precision="fp64", trunc=21, ix=64, il=32, kx=5)


def rel_err(port, ref):
    port = port.cpu().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def jax_noise(key):
    """A noise source drawing what the JAX key chain from ``key`` draws:
    split, then a standard normal from the sub-key, per update."""
    chain = {"key": key}

    def noise(shape):
        chain["key"], sub = jax.random.split(chain["key"])
        return np.asarray(jax.random.normal(sub, shape, jnp.float64))
    return noise


def tables(cfg):
    spn = sp.build_spectral_np(cfg, build_geometry_np(cfg))
    return spn, sp.build_spectral(cfg, build_geometry_np(cfg), "cpu")


def test_sigma_and_phi():
    cfg = t30(precision="fp64")
    spn, _ = tables(cfg)
    assert rel_err(sppt.sppt_sigma(cfg, spn["el2"]),
                   jsppt.sppt_sigma(jt30(precision="fp64"), spn["el2"])) \
        <= BOUND
    assert sppt.sppt_phi(cfg) == jsppt.sppt_phi(jt30(precision="fp64"))


def test_ar1_update_and_pattern():
    cfg, jcfg = t30(precision="fp64"), jt30(precision="fp64")
    spn, sc = tables(cfg)
    from speedy_tpu.geometry import build_geometry_np as jgeom
    from speedy_tpu.ops import spectral as jsp
    jsc = jsp.build_spectral(jcfg, jgeom(jcfg))
    sigma = sppt.sppt_sigma(cfg, spn["el2"])
    spec = np.random.default_rng(0).normal(
        0.0, 0.05, (cfg.kx, cfg.mx, cfg.nx, 2))
    key = jax.random.PRNGKey(7)
    jstate = jsppt.SpptState(spec=jnp.asarray(spec), key=key)
    tstate = sppt.SpptState(spec=torch.from_numpy(spec),
                            generator=torch.Generator())
    tsig = torch.from_numpy(sigma)

    jspec, jnew = jsppt.sppt_ar1(jcfg, sigma, jstate)
    tspec, tnew = sppt.sppt_ar1(cfg, tsig, tstate, jax_noise(key))
    assert rel_err(tspec, jspec) <= BOUND
    assert rel_err(tnew.spec, jnew.spec) <= BOUND

    jgrid, _ = jsppt.gen_sppt(jcfg, jsc, sigma, jnew)
    tgrid, _ = sppt.gen_sppt(cfg, sc, tsig, tnew, jax_noise(jnew.key))
    assert float(tgrid.abs().max()) <= 1.0
    assert rel_err(tgrid, jgrid) <= BOUND


def state_errors(jstate, tstate):
    errs = {f"{g}.{f}": rel_err(getattr(getattr(tstate, g), f),
                                getattr(getattr(jstate, g), f))
            for g in ("prog", "surf", "rad")
            for f in getattr(tstate, g)._fields}
    errs["sppt.spec"] = rel_err(tstate.sppt.spec, jstate.sppt.spec)
    return errs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Boot, 6 steps and one day of both models with SPPT on, the port fed
    the JAX key chain's innovations."""
    bc = synthetic_boundaries(0)
    d = tmp_path_factory.mktemp("bc")
    write_boundary_files(str(d), bc)
    kw = dict(precision="fp64", sppt_on=True)
    jcfg = jt30(**kw)
    jm = JModel(jcfg, bc_search=[str(d)], sppt_seed=3)
    tm = Model(t30(**kw), device="cpu", bc_arrays=bc,
               sppt_noise=jax_noise(jax.random.PRNGKey(3)))
    jstart, start = jcal.Datetime(*START), cal.Datetime(*START)

    jboot = jm.initialize(jstart)
    tboot = tm.initialize(start)

    im, tmo, ty = jcal.season_vars(jstart, 1, 1)
    imn, tmn, _ = jcal.season_vars(jcal.next_day(jstart), 1, 1)
    ds = jcoupling.make_date_scalars(jcfg, jm.geom_np, im, tmo, ty,
                                     year=jstart.year, imont1_next=imn,
                                     tmonth_next=tmn)
    jdaily = jcoupling.daily_update(jcfg, jm.pp, jm.lsp, jm.mc.dyn.sc,
                                    jm.mc.clim, ds, jboot.surf)
    to_port = lambda s: convert.model_state_from_numpy(
        jax.tree.map(np.asarray, s), "cpu", torch.float64)

    one = jax.jit(jm.raw_fns["one_step"], static_argnums=(3,))
    js, ts = jboot, to_port(jboot)
    tm.sppt_noise = jax_noise(jboot.sppt.key)
    tdaily = tm.daily_forcing(ts, start, start)
    for i in range(6):
        js, _ = one(jm.mc, js, jdaily, i % jcfg.nstrad == 0)
        ts, _ = tm.one_step(ts, tdaily, i % jcfg.nstrad == 0)

    jday, _ = jm._run_day(jm.mc, jboot, ds, collect_output=False)
    tm.sppt_noise = jax_noise(jboot.sppt.key)
    tday, _ = tm.run_day(to_port(jboot), start, start)
    return dict(boot=(jboot, tboot), steps=(js, ts), day=(jday, tday))


@pytest.mark.parametrize("stage", ["boot", "steps", "day"])
def test_model_matches_jax(runs, stage):
    jstate, tstate = runs[stage]
    errs = state_errors(jstate, tstate)
    bad = {k: v for k, v in errs.items() if not v <= MODEL_BOUND}
    assert not bad, bad


def test_sppt_state_moves(runs):
    """The AR(1) state advanced over the day (test_seeds shows that the
    pattern reaches the prognostics)."""
    _, tboot = runs["boot"]
    assert not torch.equal(runs["day"][1].sppt.spec, tboot.sppt.spec)


def _short_run(bc, seed):
    m = Model(t30(sppt_on=True, **SMALL), device="cpu", bc_arrays=bc,
              sppt_seed=seed)
    start = cal.Datetime(*START)
    s = m.initialize(start)
    daily = m.daily_forcing(s, start, start)
    for i in range(3):
        s, _ = m.one_step(s, daily, i == 0)
    return s


def test_seeds():
    bc = synthetic_boundaries(0)
    a, b, c = (_short_run(bc, seed) for seed in (1, 1, 2))
    for f in a.prog._fields:
        assert torch.equal(getattr(a.prog, f), getattr(b.prog, f)), f
    assert torch.equal(a.sppt.spec, b.sppt.spec)
    assert not torch.equal(a.sppt.spec, c.sppt.spec)
    assert not torch.equal(a.prog.vor, c.prog.vor)


def test_state_is_a_value():
    """Advancing the same state twice draws the same innovations: the
    generator in the state is copied, not consumed."""
    cfg = t30(**SMALL)
    spn, sc = tables(cfg)
    sigma = torch.from_numpy(sppt.sppt_sigma(cfg, spn["el2"]))
    st = sppt.init_sppt_state(cfg, sigma, 5)
    g1, n1 = sppt.gen_sppt(cfg, sc, sigma, st)
    g2, n2 = sppt.gen_sppt(cfg, sc, sigma, st)
    assert torch.equal(g1, g2) and torch.equal(n1.spec, n2.spec)
    g3, _ = sppt.gen_sppt(cfg, sc, sigma, n1)
    assert not torch.equal(g1, g3)


def test_pattern_standard_deviation():
    cfg = t30(precision="fp64")
    spn, sc = tables(cfg)
    sigma_np = sppt.sppt_sigma(cfg, spn["el2"])
    sigma = torch.from_numpy(sigma_np)
    # stationary variance per latitude from the tables: sigma^2/(1-phi^2)
    # per coefficient, through cpol_inv^2 and the DFT's mean square weight
    # (1 for m=0, re only; 2 for each of re, im at m>0)
    var = sigma_np**2 / (1.0 - sppt.sppt_phi(cfg)**2)
    fac = np.where(np.arange(cfg.mx) == 0, 1.0, 4.0)
    expect = np.sqrt(np.einsum("mn,mnj,m->j", var, spn["cpol_inv"]**2,
                               fac).mean())
    assert abs(expect / (sppt.STDDEV / np.sqrt(2.0)) - 1.0) < 0.03, expect

    st = sppt.init_sppt_state(cfg, sigma, 11)
    sq = []
    for _ in range(300):
        spec, st = sppt.sppt_ar1(cfg, sigma, st)
        sq.append(float(sp.spec_to_grid(sc, spec).pow(2).mean()))
    std = np.sqrt(np.mean(sq))
    assert abs(std / expect - 1.0) < 0.03, (std, expect)
