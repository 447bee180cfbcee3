"""The port's column physics with a member axis against the JAX package,
fp64 on the CPU (split from tests/test_torch_ensemble.py so that the
Tier-1 run's workers can share the two files' work).

The kernel wrapper's CPU path, its plain twin grid_physics_core on
member-batched inputs, against ``jax.vmap`` of speedy_tpu's
grid_physics_core, T30, 3 members with different inputs, SW and non-SW:
<= 1e-12 per output (max |port - jax| / max |jax|); and at a T21 kx=5
grid against ``jax.vmap`` of the JAX package's Pallas kernel in interpret
mode. The port's chain is bit-equal under 1, 2 and 6 intra-op threads.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speedy_tpu.config import t30 as jt30
from speedy_tpu.models import coupling as jcoupling
from speedy_tpu.models import physics as jphys
from speedy_tpu.models.geopotential import get_geopotential as jgeop
from speedy_tpu.models.model import Model as JModel
from speedy_tpu.models.tendencies import PhysicsGridState as JPhysicsGridState
from speedy_tpu.models.tendencies import grid_dynamics_tendencies as jgdt
from speedy_tpu.utils import calendar as jcal
from speedy_tpu_torch.config import t30
from speedy_tpu_torch.models import physics as tphys
from speedy_tpu_torch.models.model import Model
from speedy_tpu_torch.models.physics import fused
from speedy_tpu_torch.models.tendencies import PhysicsGridState
from speedy_tpu_torch.utils.tracing import counters, reset
from speedy_tpu_torch.utils.synthetic_bc import (synthetic_boundaries,
                                                 write_boundary_files)

PHYSICS_BOUND = 1e-12
SMALL = dict(precision="fp64", trunc=21, ix=64, il=32, kx=5)
START = (1982, 1, 1)
M = 3
NAMES = ["utend", "vtend", "ttend", "qtend", "precnv", "precls", "cbmf",
         "slrd", "slr", "olr", "ustr", "vstr", "shf", "evap", "slru",
         "hfluxn", "tsfc", "tskin", "u0", "v0", "t0",
         "tau2", "stratc", "tt_rsw", "ssrd", "ssr", "tsr"]


def rel_err(port, ref):
    port = port.cpu().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def flat(outs):
    return list(outs[:10]) + list(outs[10]) + list(outs[11:])


@pytest.fixture(scope="module")
def bc():
    return synthetic_boundaries(0)


@pytest.fixture(scope="module")
def bc_dir(bc, tmp_path_factory):
    d = tmp_path_factory.mktemp("bc")
    write_boundary_files(str(d), bc)
    return str(d)


# ---------------------------------------------------------------------------
# the column physics with a member axis
# ---------------------------------------------------------------------------

def physics_members(jm, members):
    """The JAX model's physics inputs at its booted state, with each
    member's grid fields, sea surface and land temperature perturbed by its
    own seed (convection and clouds active)."""
    jcfg = jm.cfg
    start = jcal.Datetime(*START)
    js = jm.initialize(start)
    im, tm, ty = jcal.season_vars(start, 1, 1)
    ds = jcoupling.make_date_scalars(jcfg, jm.geom_np, im, tm, ty, year=1982)
    daily = jcoupling.daily_update(jcfg, jm.pp, jm.lsp, jm.mc.dyn.sc,
                                   jm.mc.clim, ds, js.surf)
    phi0 = jgeop(jm.mc.dyn.gc, js.prog.t[0], jm.mc.dyn.phis)
    pg = jgdt(jcfg, jm.mc.dyn, jm.mc.ic_2dt, js.prog, 1, phi0)[1]
    shape = tuple(pg.tg.shape)
    per = {k: [] for k in ("ug", "vg", "tg", "qg", "sst_am", "stl_am")}
    for m in range(members):
        rng = np.random.default_rng(m)
        per["ug"].append(pg.ug + rng.normal(0.0, 5.0, shape))
        per["vg"].append(pg.vg + rng.normal(0.0, 5.0, shape))
        per["tg"].append(pg.tg + rng.normal(0.0, 1.5, shape))
        per["qg"].append(pg.qg * (1.0 + rng.uniform(0.0, 0.6, shape)))
        per["sst_am"].append(js.surf.sst_am + rng.normal(0.0, 1.0,
                                                         shape[1:]))
        per["stl_am"].append(js.surf.stl_am + rng.normal(0.0, 1.0,
                                                         shape[1:]))
    stack = lambda xs: jnp.stack([jnp.asarray(x) for x in xs])
    batched = {k: stack(v) for k, v in per.items()}
    rep = lambda x: jnp.broadcast_to(x, (members,) + x.shape)
    batched.update(phig=rep(pg.phig), pslg=rep(pg.pslg),
                   albsfc=rep(daily.albsfc), alb_s=rep(daily.alb_s))
    return js, daily, batched


def jax_members(jcfg, pp, sw, daily, js, b, carried=None):
    """jax.vmap of speedy_tpu's grid_physics_core over the members."""
    def core(ug, vg, tg, qg, phig, pslg, albsfc, alb_s, stl_am, sst_am,
             *rad):
        return jphys.grid_physics_core(
            jcfg, pp, sw, ug, vg, tg, qg, phig, pslg, daily.fsol,
            daily.ozupp, daily.ozone, daily.zenit, daily.stratz, albsfc,
            daily.ablco2, daily.alb_l, alb_s, daily.snowc, daily.soilw_am,
            stl_am, sst_am, jnp.asarray(pp.forog), jnp.asarray(pp.coa),
            jnp.asarray(pp.phis0), jnp.asarray(pp.fmask_l),
            *(rad if rad else (None,) * 4))
    args = [b[k] for k in ("ug", "vg", "tg", "qg", "phig", "pslg", "albsfc",
                           "alb_s", "stl_am", "sst_am")]
    return flat(jax.jit(jax.vmap(core))(*args, *(carried or ())))


def port_members(tm, sw, daily, js, b, carried=None):
    """The port's column-physics wrapper on CPU tensors with a member
    axis (its plain twin), fed what the JAX members get; the fields all
    members share are passed once, without the axis."""
    t = lambda a: torch.from_numpy(np.array(a))
    tdaily = tphys.DailyForcing(**{
        f: t(getattr(daily, f)) for f in tphys.DailyForcing._fields})
    tdaily = tdaily._replace(albsfc=t(b["albsfc"]), alb_s=t(b["alb_s"]))
    tsurf = tphys.SurfaceState(**{f: t(getattr(js.surf, f))
                                  for f in tphys.SurfaceState._fields})
    tsurf = tsurf._replace(stl_am=t(b["stl_am"]), sst_am=t(b["sst_am"]))
    rad = [t(x) for x in js.rad] if carried is None \
        else [t(x) for x in carried] + [t(x) for x in js.rad[4:]]
    tpg = PhysicsGridState(*[t(b[k]) for k in ("ug", "vg", "tg", "qg",
                                               "phig", "pslg")])
    reset()
    out = flat(fused.fused_grid_physics(tm.cfg, tm.pp, sw, tdaily, tsurf,
                                        tphys.RadiationState(*rad), tpg))
    assert counters["k1.launches"] == 0
    return out


@pytest.fixture(scope="module")
def jmodel(bc_dir):
    """The JAX T30 model with SPPT on (its own SPPT seed 3), whose booted
    state the physics cases use (tests/test_torch_ensemble.py's)."""
    return JModel(jt30(precision="fp64", sppt_on=True), bc_search=[bc_dir],
                  sppt_seed=3)


@pytest.fixture(scope="module")
def physics_outputs(bc, jmodel):
    """Both chains over 3 members at T30, SW then non-SW (the non-SW call
    carrying each member's SW radiation outputs), and the port's inputs
    (model, daily, booted state, member inputs, carried radiation)."""
    jm, jcfg = jmodel, jmodel.cfg
    js, daily, b = physics_members(jm, M)
    tm = Model(t30(precision="fp64", sppt_on=True), device="cpu",
               bc_arrays=bc)
    res = {}
    jsw = jax_members(jcfg, jm.pp, True, daily, js, b)
    res[True] = (jsw, port_members(tm, True, daily, js, b))
    carried = jsw[21:25]   # tau2 stratc tt_rsw ssrd
    res[False] = (jax_members(jcfg, jm.pp, False, daily, js, b, carried),
                  port_members(tm, False, daily, js, b, carried))
    res["inputs"] = (tm, daily, js, b, carried)
    return res


@pytest.mark.parametrize("compute_sw", [True, False])
def test_physics_members_match_vmapped_jax(physics_outputs, compute_sw):
    jout, tout = physics_outputs[compute_sw]
    assert len(jout) == len(tout) == (27 if compute_sw else 21)
    bad = {}
    for name, j, t in zip(NAMES, jout, tout):
        assert tuple(t.shape) == tuple(j.shape) and t.shape[0] == M, name
        for m in range(M):
            e = rel_err(t[m], j[m])
            if not e <= PHYSICS_BOUND:
                bad[name, m] = e
    assert not bad, bad
    # the members' inputs differ, and so do their outputs
    cbmf = tout[NAMES.index("cbmf")]
    assert int((cbmf[0] > 0).sum()) > 100
    assert not torch.equal(cbmf[0], cbmf[1])


@pytest.mark.parametrize("threads", [1, 2, 6])
def test_physics_members_independent_of_thread_count(physics_outputs,
                                                     threads):
    """The port's chain on the same 3-member inputs under 1, 2 and 6
    intra-op threads (the Tier-1 run uses 6 workers): bit-equal to the
    run with the default count, SW and non-SW, and so within the bound of
    jax.vmap. One CPU run once found member 2 of the SW case ~1e-8 off in
    one column; a sum whose order followed the thread count would show
    here."""
    tm, daily, js, b, carried = physics_outputs["inputs"]
    default = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        outs = {True: port_members(tm, True, daily, js, b),
                False: port_members(tm, False, daily, js, b, carried)}
    finally:
        torch.set_num_threads(default)
    for sw, tout in outs.items():
        jout, ref = physics_outputs[sw]
        for name, t, r, j in zip(NAMES, tout, ref, jout):
            assert torch.equal(t, r), (sw, name)
            for m in range(M):
                assert rel_err(t[m], j[m]) <= PHYSICS_BOUND, (sw, name, m)


def test_physics_members_match_vmapped_pallas_kernel(bc, bc_dir):
    """The JAX package's Pallas kernel in interpret mode (fuse_physics=True
    on the CPU), vmapped over 2 members at T21 kx=5, against the port's
    chain on the same inputs (SW step)."""
    from speedy_tpu.models.physics import fused as jfused
    jm = JModel(jt30(**SMALL), bc_search=[bc_dir])
    js, daily, b = physics_members(jm, 2)
    tm = Model(t30(**SMALL), device="cpu", bc_arrays=bc)
    kcfg = jt30(fuse_physics=True, **SMALL)

    def kernel(ug, vg, tg, qg, phig, pslg, albsfc, alb_s, stl_am, sst_am):
        jpg = JPhysicsGridState(ug=ug, vg=vg, tg=tg, qg=qg, phig=phig,
                                pslg=pslg)
        return jfused.fused_grid_physics(
            kcfg, jm.pp, True, daily._replace(albsfc=albsfc, alb_s=alb_s),
            js.surf._replace(stl_am=stl_am, sst_am=sst_am), js.rad, jpg)
    args = [b[k] for k in ("ug", "vg", "tg", "qg", "phig", "pslg", "albsfc",
                           "alb_s", "stl_am", "sst_am")]
    jout = flat(jax.vmap(kernel)(*args))
    tout = port_members(tm, True, daily, js, b)
    for name, j, t in zip(NAMES, jout, tout):
        for m in range(2):
            assert rel_err(t[m], j[m]) <= PHYSICS_BOUND, (name, m)
