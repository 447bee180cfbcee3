"""The step's spectral update (models/time_stepping.py) on the CPU: the
wrapper takes the plain twin for CPU tensors; the kernel's launch refuses
what it does not take before it loads anything, and falls back to nothing;
the strides it would pass address the inputs' elements; and the twin
equals the JAX package's update in fp64 at T21L5 with members. The kernel
itself runs in tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_tpu import config as jconfig
from speedy_tpu.geometry import build_geometry_np as jgeometry
from speedy_tpu.models import hdiffusion as jhdiff
from speedy_tpu.models import implicit as jimplicit
from speedy_tpu.models import time_stepping as jts
from speedy_tpu.models.state import PrognosticState as JState
from speedy_tpu.models.tendencies import DynConsts as JDyn
from speedy_tpu.ops import spectral as jsp
from speedy_tpu_torch.config import t30
from speedy_tpu_torch.models import time_stepping as ts
from speedy_tpu_torch.utils.tracing import counters, reset
from torch_gpu_cases import update_case

T21L5 = dict(trunc=21, ix=64, il=32, kx=5)
MEMBERS = 3


@pytest.fixture
def no_kernel(monkeypatch):
    """Any load of the kernel library or launch fails the test."""
    def fail(*a, **k):
        raise AssertionError("the kernel was reached")
    monkeypatch.setattr(ts, "library", fail)
    return fail


@pytest.mark.parametrize("members", [None, MEMBERS])
def test_wrapper_takes_the_twin_on_cpu(no_kernel, monkeypatch, members):
    monkeypatch.setattr(ts, "launch_update", no_kernel)
    cfg = t30(precision="fp32", **T21L5)
    sc, dc, ic, state, tend, corr = update_case(cfg, members, "cpu")
    reset()
    for j1, eps in ((1, 0.0), (2, cfg.rob)):
        got = ts.spectral_update(cfg, sc, dc, ic, state, tend, corr, j1,
                                 2 * cfg.delt, eps)
        want = ts.spectral_update_plain(cfg, sc, dc, ic, state, tend, corr,
                                        j1, 2 * cfg.delt, eps)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert counters["step.update_launches"] == 0


@pytest.mark.parametrize("case", ["dtype", "mixed", "shape", "members",
                                  "axes", "table", "device", "j1", "cpu"])
def test_launch_refuses_bad_input(no_kernel, case):
    """A wrong type, shape, layout or device, two member axes, or CPU
    tensors, raise ValueError before the library is loaded: no fall-back
    to the twin."""
    cfg = t30(precision="fp32", **T21L5)
    sc, dc, ic, state, tend, corr = update_case(cfg, MEMBERS, "cpu")
    tend, j1 = list(tend), 2
    if case == "dtype":
        state = state._replace(vor=state.vor.half())
    elif case == "mixed":
        tend[2] = tend[2].double()
    elif case == "shape":
        tend[1] = tend[1][..., :-1, :, :]
    elif case == "members":
        tend[0] = tend[0][:2]
    elif case == "axes":
        state = state._replace(**{f: x[None] for f, x in
                                  state._asdict().items()})
    elif case == "table":
        dc = dc._replace(dmp=dc.dmp.t().contiguous().t())
    elif case == "device":
        corr = corr._replace(qcorh=corr.qcorh.to("meta"))
    elif case == "j1":
        j1 = 3
    reset()
    with pytest.raises(ValueError):
        ts.launch_update(cfg, sc, dc, ic, state, tuple(tend), corr, j1,
                         2 * cfg.delt, cfg.rob)
    assert counters["step.update_launches"] == 0


@pytest.mark.parametrize("members", [None, MEMBERS])
def test_layout_strides_address_the_inputs(members):
    """Each input read at the strides the launch passes (member, time
    level, tracer, level, m, n, re/im) is the input."""
    cfg = t30(precision="fp64", ntr=2, **T21L5)
    sc, dc, ic, state, tend, corr = update_case(cfg, members, "cpu")
    lead, strides, tables = ts.kernel_layout(cfg, sc, dc, ic, state, tend,
                                             corr)
    assert lead == (() if members is None else (members,))
    assert len(strides) == 73 and tables[-2] is dc.tcorv
    m, kx, ntr, spec = members or 1, cfg.kx, cfg.ntr, (cfg.mx, cfg.nx, 2)
    subs = dict(vor=(1, kx), div=(1, kx), t=(1, kx), ps=(1, 1),
                tr=(ntr, kx))

    def read(x, shape, st):
        return torch.as_strided(x, shape, st, x.storage_offset())

    for i, (f, x) in enumerate(state._asdict().items()):
        ns, tsd = strides[13 * i:13 * i + 7], strides[13 * i + 7:13 * i + 13]
        assert torch.equal(read(x, (m, 2) + subs[f] + spec, ns).reshape(
            x.shape), x), f
        assert torch.equal(read(tend[i], (m,) + subs[f] + spec, tsd).reshape(
            tend[i].shape), tend[i]), f
    tc, qc = strides[65:69], strides[69:73]
    assert tc[0] == 0
    assert torch.equal(read(corr.tcorh, (m,) + spec, tc)[-1], corr.tcorh)
    assert torch.equal(read(corr.qcorh, (m,) + spec, qc).reshape(
        corr.qcorh.shape), corr.qcorh)


def _jax_update(jcfg, state, tend, corr, j1, dt):
    """The JAX package's step after its tendencies, with get_tendencies
    returning ``tend``: each member through jax.vmap."""
    geom = jgeometry(jcfg)
    diff = jhdiff.build_diffusion_np(jcfg, geom)
    dyn = JDyn(sc=jsp.build_spectral(jcfg, geom), geom=None, gc=None,
               phis=None)
    dc = jhdiff.build_diffusion(jcfg, geom)
    ic = jimplicit.build_implicit(jcfg, geom, diff, dt)
    tcorh = jnp.asarray(corr.tcorh.numpy())
    orig = jts.get_tendencies

    def one(st, td, qcorh):
        jts.get_tendencies = lambda *a, **k: (*td, None)
        try:
            return jts.step(jcfg, dyn, dc, ic, st, j1, 2, dt,
                            jts.OrographicCorrection(tcorh, qcorh))[0]
        finally:
            jts.get_tendencies = orig

    as_jax = lambda xs: [jnp.asarray(x.numpy()) for x in xs]
    return jax.vmap(one)(JState(*as_jax(state)), tuple(as_jax(tend)),
                         jnp.asarray(corr.qcorh.numpy()))


@pytest.mark.parametrize("j1", [1, 2])
def test_twin_matches_jax_step_update(j1):
    cfg = t30(precision="fp64", **T21L5)
    jcfg = jconfig.t30(precision="fp64", **T21L5)
    sc, dc, ic, state, tend, corr = update_case(cfg, MEMBERS, "cpu")
    eps, dt = (0.0 if j1 == 1 else cfg.rob), 2 * cfg.delt   # ic is for 2 dt
    port = ts.spectral_update_plain(cfg, sc, dc, ic, state, tend, corr, j1,
                                    dt, eps)
    ref = _jax_update(jcfg, state, tend, corr, j1, dt)
    for f, a, b in zip(port._fields, port, ref):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert err <= 1e-12, (f, err)
