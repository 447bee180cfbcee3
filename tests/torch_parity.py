"""Helpers shared by the port's parity tests of its configuration surface
(tests/test_torch_lw_order.py, test_torch_sst.py, test_torch_options.py):
the bounds, the error measures, and boot + n steps of a JAX model and of
the port's model. Bounds are max |port - jax| / max |jax| per field."""
import ctypes
import hashlib

import numpy as np
import jax
import torch

from speedy_tpu.models import coupling as jcoupling
from speedy_tpu.utils import calendar as jcal
from speedy_tpu_torch import convert
from speedy_tpu_torch.models.captured import leaves

PHYSICS_BOUND = 1e-12
STEP_BOUND = 1e-10
SMALL = dict(precision="fp64", trunc=21, ix=64, il=32, kx=5)
START = (1982, 1, 1)
NAMES = ["utend", "vtend", "ttend", "qtend", "precnv", "precls", "cbmf",
         "slrd", "slr", "olr", "ustr", "vstr", "shf", "evap", "slru",
         "hfluxn", "tsfc", "tskin", "u0", "v0", "t0",
         "tau2", "stratc", "tt_rsw", "ssrd", "ssr", "tsr"]


def rel_err(port, ref):
    port = port.cpu().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def state_errors(jstate, tstate):
    return {f"{g}.{f}": rel_err(getattr(getattr(tstate, g), f),
                                getattr(getattr(jstate, g), f))
            for g in ("prog", "surf", "rad")
            for f in getattr(tstate, g)._fields}


def assert_close(jstate, tstate, bound=STEP_BOUND):
    bad = {k: v for k, v in state_errors(jstate, tstate).items()
           if not v <= bound}
    assert not bad, bad


def assert_states_equal(a, b):
    for i, (x, y) in enumerate(zip(leaves(a), leaves(b), strict=True)):
        assert torch.equal(x, y), i


def to_port(jstate):
    return convert.model_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                          "cpu", torch.float64)


def flat(outs):
    """(..., sfc, ...) -> the 21/27 physics outputs in NAMES order."""
    return list(outs[:10]) + list(outs[10]) + list(outs[11:])


def perturbed(pg, seed=0):
    """The physics grid fields with seeded noise on the winds and
    temperature and extra moisture, so that convection and clouds are
    active (tests/test_torch_physics.py's)."""
    rng = np.random.default_rng(seed)
    shape = tuple(pg.tg.shape)
    return pg._replace(ug=pg.ug + rng.normal(0.0, 5.0, shape),
                       vg=pg.vg + rng.normal(0.0, 5.0, shape),
                       tg=pg.tg + rng.normal(0.0, 1.5, shape),
                       qg=pg.qg * (1.0 + rng.uniform(0.0, 0.6, shape)))


def jax_steps(jm, start, n=6):
    """The JAX model's booted state, its state n jitted steps later (the
    day's first date inputs, the shortwave every nstrad steps) and the
    day's date inputs."""
    jcfg = jm.cfg
    jboot = jm.initialize(start)
    im, tmo, ty = jcal.season_vars(start, jcfg.iseasc, start.month)
    imn, tmn, _ = jcal.season_vars(jcal.next_day(start), jcfg.iseasc,
                                   start.month)
    ds = jcoupling.make_date_scalars(jcfg, jm.geom_np, im, tmo, ty,
                                     year=start.year, imont1_next=imn,
                                     tmonth_next=tmn)
    daily = jcoupling.daily_update(jcfg, jm.pp, jm.lsp, jm.mc.dyn.sc,
                                   jm.mc.clim, ds, jboot.surf)
    one = jax.jit(jm.raw_fns["one_step"], static_argnums=(3,))
    js = jboot
    for i in range(n):
        js, _ = one(jm.mc, js, daily, i % jcfg.nstrad == 0)
    return jboot, js, ds


def port_steps(tm, start, n=6):
    """The port's booted state and its state n steps later."""
    tboot = tm.initialize(start)
    daily = tm.daily_forcing(tboot, start, start)
    ts = tboot
    for i in range(n):
        ts, _ = tm.one_step(ts, daily, i % tm.cfg.nstrad == 0)
    return tboot, ts


def openmp_state():
    """The OpenMP runtime's settings as this process loaded it: the
    thread count torch reports, and omp_get_max_threads, omp_get_dynamic
    (whether the runtime may shrink a team) and omp_get_num_procs from the
    libgomp/libiomp mapped into the process (Linux), or why not."""
    out = f"torch.get_num_threads()={torch.get_num_threads()}"
    try:
        with open("/proc/self/maps") as f:
            libs = sorted({line.split()[-1] for line in f
                           if "omp" in line.rsplit("/", 1)[-1]})
        for path in libs:
            lib = ctypes.CDLL(path)
            out += (f"; {path.rsplit('/', 1)[-1]}: max_threads="
                    f"{lib.omp_get_max_threads()} dynamic="
                    f"{lib.omp_get_dynamic()} num_procs="
                    f"{lib.omp_get_num_procs()}")
    except (OSError, AttributeError) as e:
        out += f"; OpenMP runtime not read: {e}"
    return out


def describe(x):
    """A tensor's data pointer, shape, strides, dtype and checksums (a
    digest of its bytes and its sum)."""
    if x is None:
        return "None"
    t = x.detach().cpu().contiguous()
    digest = hashlib.sha1(t.numpy().tobytes()).hexdigest()[:16]
    return (f"ptr={x.data_ptr():#x} shape={tuple(x.shape)} "
            f"stride={tuple(x.stride())} {x.dtype} sha1={digest} "
            f"sum={float(t.double().sum())!r}")


def mismatch_report(inputs, names, a, b):
    """What to dump when two results that should agree do not: the
    OpenMP state, every input (``describe``) and every output pair that
    differs, with its largest difference."""
    lines = [openmp_state()]
    lines += [f"in[{i}] {describe(x)}" for i, x in enumerate(inputs)]
    for n, x, y in zip(names, a, b):
        x, y = torch.as_tensor(np.asarray(x)), torch.as_tensor(np.asarray(y))
        if not torch.equal(x, y):
            lines.append(f"{n}: max |a - b| = "
                         f"{float((x - y).abs().max())!r}\n  a {describe(x)}"
                         f"\n  b {describe(y)}")
    return "\n".join(lines)
