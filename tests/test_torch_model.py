"""The port's coupled model step against the JAX package, fp64 on the CPU.

Both models run on the same stand-in boundary set (the JAX one from HDF5
files, the port from the same arrays in memory). Checked at 1e-10 (max
|port - jax| / max |jax| per field of prog, surf and rad):
* the booted state (rest state + leapfrog bootstrap with physics);
* 6 steps of the jitted JAX one_step, with the port started from the JAX
  booted state through speedy_tpu_torch.convert (step parity apart from
  boot parity);
* one whole run_day, which ends with the couple-with-next-day step;
at T30 and at a reduced kx=5 T21 grid. Also the package's hygiene: no JAX
import, CUDA by default, no silent CPU fall-back, the refused option
(sea_coupling_flag >= 1, which the JAX package refuses too).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import torch

from speedy_tpu.config import t30 as jt30
from speedy_tpu.models import coupling as jcoupling
from speedy_tpu.models.model import Model as JModel
from speedy_tpu.utils import calendar as jcal
from speedy_tpu_torch import convert
from speedy_tpu_torch.config import t30
from speedy_tpu_torch.models.model import Model
from speedy_tpu_torch.models.physics import fused
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils.synthetic_bc import (synthetic_boundaries,
                                                 write_boundary_files)

BOUND = 1e-10
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"t30": dict(precision="fp64"),
           "t21_kx5": dict(precision="fp64", trunc=21, ix=64, il=32, kx=5)}
START = (1982, 1, 1)


def rel_err(port, ref):
    port = port.cpu().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def state_errors(jstate, tstate):
    return {f"{g}.{f}": rel_err(getattr(getattr(tstate, g), f),
                                getattr(getattr(jstate, g), f))
            for g in ("prog", "surf", "rad")
            for f in getattr(tstate, g)._fields}


def to_port(jstate):
    return convert.model_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                          "cpu", torch.float64)


@pytest.fixture(scope="module")
def bc():
    return synthetic_boundaries(0)


@pytest.fixture(scope="module", params=list(CONFIGS))
def runs(request, bc, tmp_path_factory):
    """Boot, 6 steps and one day of both models from the same start."""
    kw = CONFIGS[request.param]
    d = tmp_path_factory.mktemp("bc")
    write_boundary_files(str(d), bc)
    jcfg = jt30(**kw)
    jm = JModel(jcfg, bc_search=[str(d)])
    tm = Model(t30(**kw), device="cpu", bc_arrays=bc)
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
    one = jax.jit(jm.raw_fns["one_step"], static_argnums=(3,))
    js, ts = jboot, to_port(jboot)
    tdaily = tm.daily_forcing(ts, start, start)
    for i in range(6):
        js, _ = one(jm.mc, js, jdaily, i % jcfg.nstrad == 0)
        ts, _ = tm.one_step(ts, tdaily, i % jcfg.nstrad == 0)

    jday, _ = jm._run_day(jm.mc, jboot, ds, collect_output=False)
    tday, diags = tm.run_day(to_port(jboot), start, start)
    return dict(boot=(jboot, tboot), steps=(js, ts), day=(jday, tday),
                diags=diags, model=tm)


@pytest.mark.parametrize("stage", ["boot", "steps", "day"])
def test_matches_jax(runs, stage):
    jstate, tstate = runs[stage]
    errs = state_errors(jstate, tstate)
    bad = {k: v for k, v in errs.items() if not v <= BOUND}
    assert not bad, bad


def test_day_diagnostics_in_guard(runs):
    m = runs["model"]
    assert len(runs["diags"]) == m.cfg.nsteps
    tmean = torch.stack([d.tmean for d in runs["diags"]])
    assert bool(torch.isfinite(tmean).all())
    assert float(tmean.min()) > 180.0 and float(tmean.max()) < 320.0


def test_run_fast_equals_run_day(bc):
    """run_fast is initialize + run_day with the per-day guard."""
    cfg = t30(**CONFIGS["t21_kx5"])
    m = Model(cfg, device="cpu", bc_arrays=bc)
    start = cal.Datetime(*START)
    fast = m.run_fast(start, 1)
    day, _ = m.run_day(m.initialize(start), start, start)
    for f in fast.prog._fields:
        assert torch.equal(getattr(fast.prog, f), getattr(day.prog, f)), f


def test_convert_round_trip(runs):
    _, tstate = runs["steps"]
    tree = convert.model_state_to_numpy(tstate)
    assert set(tree) == {"prog", "surf", "rad"}
    assert len(tree["surf"]) == 9 and len(tree["rad"]) == 6
    back = convert.model_state_from_numpy(tree, "cpu", torch.float64)
    for g in ("prog", "surf", "rad"):
        for f in getattr(tstate, g)._fields:
            assert torch.equal(getattr(getattr(back, g), f),
                               getattr(getattr(tstate, g), f)), (g, f)


def test_cpu_run_launches_no_kernel(bc):
    fused.reset_launches()
    m = Model(t30(**CONFIGS["t21_kx5"]), device="cpu", bc_arrays=bc)
    start = cal.Datetime(*START)
    s = m.initialize(start)
    m.one_step(s, m.daily_forcing(s, start, start), True)
    assert fused.launches == 0


def test_package_imports_no_jax():
    code = ("import importlib, pkgutil, sys, speedy_tpu_torch\n"
            "for m in pkgutil.walk_packages(speedy_tpu_torch.__path__, "
            "'speedy_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [n for n in sys.modules if n == 'jax' or n.startswith("
            "'jax.') or n == 'speedy_tpu' or n.startswith('speedy_tpu.')]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO_ROOT)
    assert res.returncode == 0, res.stderr


def test_model_defaults_to_cuda_and_never_falls_back(bc):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(t30(), bc_arrays=bc)


@pytest.mark.parametrize("option", [dict(sea_coupling_flag=1)])
def test_unported_options_raise(bc, option):
    with pytest.raises(NotImplementedError):
        Model(t30(**option), device="cpu", bc_arrays=bc)


def test_tpu_knobs_are_ignored(bc):
    """synthesis_split, tables_bf16, scan_unroll and fuse_physics change
    nothing in the port."""
    start = cal.Datetime(*START)
    kw = CONFIGS["t21_kx5"]
    a = Model(t30(**kw), device="cpu", bc_arrays=bc).initialize(start)
    b = Model(t30(synthesis_split=True, tables_bf16=True, scan_unroll=4,
                  fuse_physics=True, **kw),
              device="cpu", bc_arrays=bc).initialize(start)
    for f in a.prog._fields:
        assert torch.equal(getattr(a.prog, f), getattr(b.prog, f)), f
