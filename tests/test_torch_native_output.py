"""The port's native asynchronous NetCDF writer on the CPU (g++ builds it
here and on the card): its files against the port's scipy writer's (every
variable, long_name and units; tests/test_native_output.py's pattern) and
byte for byte against the JAX package's native writer's, asynchronous
submission and drain, the shape check before the pointers are passed, and
the compiler's error text kept when the build fails."""
import os

import numpy as np
import pytest
from scipy.io import netcdf_file

from speedy_tpu.config import t30 as jt30
from speedy_tpu.utils import calendar as jcal
from speedy_tpu.utils.native_output import AsyncNetCDFWriter as JWriter
from speedy_tpu_torch.config import t30
from speedy_tpu_torch.utils import native
from speedy_tpu_torch.utils.calendar import Datetime, newdate
from speedy_tpu_torch.utils.native_output import (AsyncNetCDFWriter,
                                                  native_available)
from speedy_tpu_torch.utils.output import NetCDFWriter

DATE, START = Datetime(1982, 3, 14, 6, 40), Datetime(1982, 1, 1)


def _fields(cfg, seed=0):
    rng = np.random.default_rng(seed)
    grid = (cfg.kx, cfg.il, cfg.ix)
    return dict(
        u=rng.normal(0, 10, grid), v=rng.normal(0, 10, grid),
        t=rng.normal(260, 20, grid), q=rng.uniform(0, 0.02, grid),
        phi=rng.normal(5000, 3000, grid),
        ps=rng.normal(1.0e5, 3e3, (cfg.il, cfg.ix)))


def test_native_library_builds():
    assert native_available()


@pytest.mark.parametrize("kw", [{}, dict(trunc=21, ix=64, il=32, kx=5)])
def test_native_writer_matches_scipy_writer(tmp_path, kw):
    cfg = t30(**kw)
    fields = _fields(cfg)
    p1 = NetCDFWriter(cfg, str(tmp_path / "py"))(107, DATE, START, fields)
    p2 = AsyncNetCDFWriter(cfg, str(tmp_path / "cc"), synchronous=True)(
        107, DATE, START, fields)
    assert os.path.basename(p1) == os.path.basename(p2) == "198203140640.nc"
    with netcdf_file(p1, mmap=False) as f1, netcdf_file(p2, mmap=False) as f2:
        assert f1.dimensions == f2.dimensions
        assert set(f1.variables) == set(f2.variables) == {
            "time", "lon", "lat", "lev", "u", "v", "t", "q", "phi", "ps"}
        for k in f1.variables:
            a, b = f1.variables[k], f2.variables[k]
            np.testing.assert_array_equal(np.asarray(a[:]), np.asarray(b[:]),
                                          k)
            for att in ("long_name", "units"):
                assert getattr(a, att, None) == getattr(b, att, None), \
                    (k, att)


@pytest.mark.parametrize("synchronous", [True, False])
def test_native_file_byte_equal_to_jax_writer(tmp_path, synchronous):
    fields = _fields(t30(), seed=3)
    with AsyncNetCDFWriter(t30(), str(tmp_path / "port"),
                           synchronous=synchronous) as w:
        port = w(107, DATE, START, fields)
    jw = JWriter(jt30(), str(tmp_path / "jax"), synchronous=synchronous)
    ref = jw(107, jcal.Datetime(1982, 3, 14, 6, 40),
             jcal.Datetime(1982, 1, 1), fields)
    jw.drain()
    with open(port, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_async_submission_and_drain(tmp_path):
    cfg = t30()
    paths, date = [], START
    with AsyncNetCDFWriter(cfg, str(tmp_path)) as w:
        for step in range(1, 9):
            date = newdate(date, cfg.nsteps)
            paths.append(w(step, date, START, _fields(cfg, seed=step)))
    # drained: every file is complete and readable
    for step, p in enumerate(paths, start=1):
        with netcdf_file(p, mmap=False) as f:
            np.testing.assert_allclose(float(f.variables["time"][0]),
                                       step * 24.0 / cfg.nsteps, rtol=1e-6)
            assert f.variables["time"].units == \
                b"hours since 1982-01-01 00:00:0.0"
            np.testing.assert_array_equal(
                np.asarray(f.variables["t"][0]),
                _fields(cfg, seed=step)["t"].astype(np.float32))


def test_wrong_field_shape_raises_before_the_call(tmp_path):
    cfg = t30()
    fields = _fields(cfg)
    fields["t"] = fields["t"][:, :-1]
    w = AsyncNetCDFWriter(cfg, str(tmp_path), synchronous=True)
    with pytest.raises(ValueError, match="'t'"):
        w(1, DATE, START, fields)
    assert not os.listdir(tmp_path)


def test_build_failure_keeps_the_compiler_message(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f() { return undeclared; }\n")
    monkeypatch.setattr(native, "CSRC", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken") as e:
        native.build("broken", ["broken.cpp"], host=True)
    assert "undeclared" in str(e.value)
