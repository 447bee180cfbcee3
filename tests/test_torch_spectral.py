"""speedy_tpu_torch.ops.spectral against speedy_tpu.ops.spectral: the
tables, the transforms and the spectral operators at T30 and T85, in fp64
on the CPU. Bound: max |port - jax| / max |jax| <= 1e-12 per field."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from speedy_tpu import config as jconfig
from speedy_tpu.geometry import build_geometry_np as jgeom_np
from speedy_tpu.ops import spectral as jsp
from speedy_tpu_torch import config as tconfig
from speedy_tpu_torch import geometry as tgeom
from speedy_tpu_torch.ops import spectral as tsp

BOUND = 1e-12
PRESETS = ("t30", "t85")


def rel_err(port, ref):
    port = port.cpu().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.fixture(scope="module", params=PRESETS)
def pair(request):
    jcfg = jconfig.from_preset(request.param, precision="fp64")
    tcfg = tconfig.from_preset(request.param, precision="fp64")
    jg = jgeom_np(jcfg)
    tg = tgeom.build_geometry_np(tcfg)
    return (jcfg, tcfg, jsp.build_spectral(jcfg, jg),
            tsp.build_spectral(tcfg, tg, "cpu"), jg, tg)


def random_spec(cfg, seed, levels):
    """Random packed spectral field with support l <= trunc, real m=0."""
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(levels, cfg.mx, cfg.nx, 2))
    ell = np.arange(cfg.mx)[:, None] + np.arange(cfg.nx)[None, :]
    s = s * (ell <= cfg.trunc)[None, :, :, None]
    s[:, 0, :, 1] = 0.0
    return s


def test_geometry_tables(pair):
    _, _, _, _, jg, tg = pair
    for k, v in jg.items():
        assert rel_err(tg[k], v) <= BOUND, k


def test_spectral_tables(pair):
    _, _, jsc, tsc, _, _ = pair
    for name in jsc._fields:
        assert rel_err(getattr(tsc, name), getattr(jsc, name)) <= BOUND, name


@pytest.mark.parametrize("kcos", [False, True])
def test_round_trip(pair, kcos):
    jcfg, _, jsc, tsc, _, _ = pair
    spec = random_spec(jcfg, 1, 3)
    jgrid = jsp.spec_to_grid(jsc, jnp.asarray(spec), scale_by_inv_cos=kcos)
    tgrid = tsp.spec_to_grid(tsc, torch.from_numpy(spec),
                             scale_by_inv_cos=kcos)
    assert rel_err(tgrid, jgrid) <= BOUND
    jback = jsp.grid_to_spec(jsc, jgrid)
    tback = tsp.grid_to_spec(tsc, tgrid)
    assert rel_err(tback, jback) <= BOUND


def test_random_grid_analysis(pair):
    jcfg, _, jsc, tsc, _, _ = pair
    grid = np.random.default_rng(2).normal(size=(4, jcfg.il, jcfg.ix))
    assert rel_err(tsp.grid_to_spec(tsc, torch.from_numpy(grid)),
                   jsp.grid_to_spec(jsc, jnp.asarray(grid))) <= BOUND


@pytest.mark.parametrize("op", ["laplacian", "inverse_laplacian", "trunct",
                                "grad", "uvspec", "vds", "cmul_i"])
def test_operators(pair, op):
    jcfg, _, jsc, tsc, _, _ = pair
    a = random_spec(jcfg, 3, 2)
    b = random_spec(jcfg, 4, 2)
    if op == "cmul_i":
        outs = [(jsp.cmul_i(jnp.asarray(a)), tsp.cmul_i(torch.from_numpy(a)))]
    elif op in ("uvspec", "vds"):
        j = getattr(jsp, op)(jsc, jnp.asarray(a), jnp.asarray(b))
        t = getattr(tsp, op)(tsc, torch.from_numpy(a), torch.from_numpy(b))
        outs = list(zip(j, t))
    elif op == "grad":
        outs = list(zip(jsp.grad(jsc, jnp.asarray(a[0])),
                        tsp.grad(tsc, torch.from_numpy(a[0]))))
    else:
        outs = [(getattr(jsp, op)(jsc, jnp.asarray(a)),
                 getattr(tsp, op)(tsc, torch.from_numpy(a)))]
    for j, t in outs:
        assert rel_err(t, j) <= BOUND, op


@pytest.mark.parametrize("kcos", [False, True])
def test_vdspec(pair, kcos):
    jcfg, _, jsc, tsc, _, _ = pair
    rng = np.random.default_rng(5)
    ug = rng.normal(size=(3, jcfg.il, jcfg.ix))
    vg = rng.normal(size=(3, jcfg.il, jcfg.ix))
    j = jsp.vdspec(jsc, jnp.asarray(ug), jnp.asarray(vg), kcos)
    t = tsp.vdspec(tsc, torch.from_numpy(ug), torch.from_numpy(vg), kcos)
    for a, b in zip(j, t):
        assert rel_err(b, a) <= BOUND
