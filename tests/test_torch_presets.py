"""The port's model at T85 against the JAX package, fp64 on the CPU: boot
and 6 steps from 1982-01-01 on the stand-in boundary set, which both
packages regrid from its 48 x 96 grid to 128 x 256 (the JAX model reads
HDF5 copies of it, the port the same arrays in memory). Bound: max
|port - jax| / max |jax| <= 1e-10 per field of each state group after the
boot and after the steps. The other presets run on the card
(tests/test_torch_gpu.py); their grids and tables are held by
tests/test_torch_spectral.py and tests/test_torch_physics.py."""
import numpy as np
import pytest
import jax
import torch

from speedy_tpu.config import t85 as jt85
from speedy_tpu.models import coupling as jcoupling
from speedy_tpu.models.model import Model as JModel
from speedy_tpu.utils import calendar as jcal
from speedy_tpu_torch.config import t85
from speedy_tpu_torch.models.model import Model
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils.synthetic_bc import (synthetic_boundaries,
                                                 write_boundary_files)

BOUND = 1e-10
START = (1982, 1, 1)
STEPS = 6


def rel_err(port, ref):
    port = port.cpu().numpy()
    ref = np.asarray(ref)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both T85 models' booted state and their states STEPS steps later."""
    bc = synthetic_boundaries(0)
    d = tmp_path_factory.mktemp("bc")
    write_boundary_files(str(d), bc)
    jm = JModel(jt85(precision="fp64"), bc_search=[str(d)])
    tm = Model(t85(precision="fp64"), device="cpu", bc_arrays=bc)
    assert (tm.cfg.il, tm.cfg.ix, tm.cfg.nsteps) == (128, 256, 96)
    jstart, start = jcal.Datetime(*START), cal.Datetime(*START)

    jboot, tboot = jm.initialize(jstart), tm.initialize(start)
    jcfg = jm.cfg
    im, tmo, ty = jcal.season_vars(jstart, 1, 1)
    imn, tmn, _ = jcal.season_vars(jcal.next_day(jstart), 1, 1)
    ds = jcoupling.make_date_scalars(jcfg, jm.geom_np, im, tmo, ty,
                                     year=jstart.year, imont1_next=imn,
                                     tmonth_next=tmn)
    jdaily = jcoupling.daily_update(jcfg, jm.pp, jm.lsp, jm.mc.dyn.sc,
                                    jm.mc.clim, ds, jboot.surf)
    one = jax.jit(jm.raw_fns["one_step"], static_argnums=(3,))
    tdaily = tm.daily_forcing(tboot, start, start)
    js, ts = jboot, tboot
    for i in range(STEPS):
        js, _ = one(jm.mc, js, jdaily, i % jcfg.nstrad == 0)
        ts, _ = tm.one_step(ts, tdaily, i % jcfg.nstrad == 0)
    return dict(boot=(jboot, tboot), steps=(js, ts))


@pytest.mark.parametrize("group", ["prog", "surf", "rad"])
@pytest.mark.parametrize("stage", ["boot", "steps"])
def test_t85_matches_jax(runs, stage, group):
    jstate, tstate = runs[stage]
    errs = {f: rel_err(getattr(getattr(tstate, group), f),
                       getattr(getattr(jstate, group), f))
            for f in getattr(tstate, group)._fields}
    bad = {k: v for k, v in errs.items() if not v <= BOUND}
    assert not bad, bad


def test_t85_state_is_finite_and_moving(runs):
    """The steps change the state and keep it finite: the comparison is
    not of two rest states."""
    tboot, ts = runs["boot"][1], runs["steps"][1]
    assert all(bool(torch.isfinite(x).all()) for x in ts.prog)
    assert float((ts.prog.vor - tboot.prog.vor).abs().max()) > 0.0
