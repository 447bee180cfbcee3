"""The port's command line (speedy_tpu_torch/cli.py) on the CPU.

* parse_namelist and _dt against the JAX CLI's on the same inputs;
* ``run`` against the JAX CLI's ``run``: T30 fp64 from 1982-01-01 to
  04:00, the JAX CLI on HDF5 copies of the stand-in set (--bc-path), the
  port on the same set in memory (--synthetic-bc 0 --device cpu). Both
  compute the whole day and write until the end date: step 0 and 6 steps,
  7 files each with the same names, variables and attributes, values
  within float32 rounding of the fp64 states (<= 1e-6 field-normalised);
* without --device, on a machine without CUDA, ``run`` raises;
* --debug-nans raises FloatingPointError at the first step when the
  initial state holds a NaN;
* --restart-from takes the run's start from the checkpoint;
* --matmul-precision holds after the model is built; --profile writes a
  trace; the writer falls back to scipy's, naming why;
* ``ensemble`` writes each member's fields, equal to Ensemble.member_fields
  of a direct run with the same seed (the port's SPPT draws are its own, so
  the ensemble is held against the port's Ensemble; tests/
  test_torch_ensemble.py holds that against JAX).
"""
import argparse
import contextlib
import io
import os

import numpy as np
import pytest
import jax
import torch
from scipy.io import netcdf_file

from speedy_tpu import cli as jcli
from speedy_tpu_torch import cli
from speedy_tpu_torch.config import t30
from speedy_tpu_torch.models.model import Model
from speedy_tpu_torch.parallel.ensemble import Ensemble
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils.output import NetCDFWriter
from speedy_tpu_torch.utils.synthetic_bc import (synthetic_boundaries,
                                                 write_boundary_files)

PORT = ["--synthetic-bc", "0", "--device", "cpu"]
FILE_BOUND = 1e-6   # float32 files of fp64 states that agree to ~1e-10
NAMELISTS = {
    "test_infra": """! comment
&params
nsteps_out = 1
nstdia     = 180
/
&date
start_datetime%year   = 1982
start_datetime%month  = 1
start_datetime%day    = 1
start_datetime%hour   = 0
start_datetime%minute = 0
end_datetime%year     = 1982
end_datetime%month    = 1
end_datetime%day      = 10
/
""",
    "commas": """\
&params
nsteps_out = 2,
nstdia = 180
/

&date
start_datetime%year = 1982,
start_datetime%month = 1,
start_datetime%day = 1,
end_datetime%year = 1982,
end_datetime%month = 1,
end_datetime%day = 10,
/
"""}


def run_main(main, argv):
    """main(argv) with its printed lines kept: (rc, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def read_nc(path):
    with netcdf_file(path, mmap=False) as f:
        return {k: (np.asarray(v[:]).copy(), getattr(v, "long_name", None),
                    getattr(v, "units", None))
                for k, v in f.variables.items()}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's CPU runs: the suite runs
    several workers on the machine's cores, and a thread pool of the
    machine's width in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bc():
    return synthetic_boundaries(0)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The JAX CLI's and the port's ``run`` of T30 fp64 to 04:00; returns
    (JAX output dir, port output dir, the port's printed lines). The JAX
    main points its persistent compilation cache at ~: HOME is a temporary
    directory for the call, and the cache settings are put back after it
    for the rest of the process."""
    d = tmp_path_factory.mktemp("cli")
    (d / "bc").mkdir()
    write_boundary_files(str(d / "bc"), synthetic_boundaries(0))
    span = ["--precision", "fp64", "--start", "1982-01-01", "--end",
            "1982-01-01T04:00"]
    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOME", str(d))
        try:
            assert run_main(jcli.main, ["run", "--bc-path", str(d / "bc"),
                                        "--output-dir", str(d / "jax")]
                            + span)[0] == 0
        finally:
            for k, v in keep.items():
                jax.config.update(k, v)
            from jax.experimental.compilation_cache import \
                compilation_cache as cc
            cc.reset_cache()
    rc, text = run_main(cli.main, ["run", "--output-dir", str(d / "port")]
                        + PORT + span)
    assert rc == 0
    return str(d / "jax"), str(d / "port"), text


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(NAMELISTS))
def test_parse_namelist_matches_jax(tmp_path, name):
    p = tmp_path / "namelist.nml"
    p.write_text(NAMELISTS[name])
    assert cli.parse_namelist(str(p)) == jcli.parse_namelist(str(p))


@pytest.mark.parametrize("s", ["1982-01-01", "1982-01-01T04:00",
                               "1982-03-14 06:40", "1999-12-31T23:20x"])
def test_dt_matches_jax(s):
    a, b = cli._dt(s), jcli._dt(s)
    assert (a.year, a.month, a.day, a.hour, a.minute) == \
        (b.year, b.month, b.day, b.hour, b.minute)


@pytest.mark.parametrize("s", ["1982/01/01", "82-1-1", ""])
def test_dt_refuses_what_jax_refuses(s):
    for dt in (cli._dt, jcli._dt):
        with pytest.raises(argparse.ArgumentTypeError):
            dt(s)


def test_run_files_match_jax_cli(cli_runs):
    jdir, pdir, _ = cli_runs
    names = sorted(os.listdir(pdir))
    assert names == sorted(os.listdir(jdir))
    assert names[0] == "198201010000.nc" and names[-1] == "198201010400.nc"
    assert len(names) == 7
    for n in names:
        a, b = read_nc(os.path.join(pdir, n)), read_nc(os.path.join(jdir, n))
        assert set(a) == set(b)
        for k, (x, ln, un) in a.items():
            y, lnj, unj = b[k]
            assert (ln, un) == (lnj, unj), (n, k)
            assert x.shape == y.shape and x.dtype == y.dtype, (n, k)
            x, y = x.astype(np.float64), y.astype(np.float64)
            err = np.abs(x - y).max() / max(np.abs(y).max(), 1e-300)
            assert err <= FILE_BOUND, (n, k, err)


def test_run_prints_the_jax_lines_and_the_writer(cli_runs):
    text = cli_runs[2]
    assert "speedy_tpu_torch: T30 96x48x8, dt=2400s, fp64" in text
    assert "start Datetime(year=1982, month=1, day=1, hour=0, minute=0) -> " \
        "end Datetime(year=1982, month=1, day=1, hour=4, minute=0)" in text
    assert "output writer: native asynchronous" in text
    assert "wall time: " in text


def test_run_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["run", "--synthetic-bc", "0", "--output-dir",
                  str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_debug_nans_raises_at_the_first_step(monkeypatch, tmp_path):
    initialize = Model.initialize

    def with_nan(self, start):
        state = initialize(self, start)
        t = state.prog.t.clone()
        t[0, 2, 3, 1, 0] = float("nan")
        return state._replace(prog=state.prog._replace(t=t))

    monkeypatch.setattr(Model, "initialize", with_nan)
    with pytest.raises(FloatingPointError,
                       match=r"^step 1: prog\.\w+ is not finite"):
        run_main(cli.main, ["run", "--no-output", "--end",
                            "1982-01-01T04:00", "--debug-nans"] + PORT)


@pytest.fixture(scope="module")
def checkpointed(tmp_path_factory):
    """One day of ``run`` with a checkpoint, --matmul-precision
    tensorfloat32 and --profile; returns (its directory, its printed
    lines, the float32 matmul precision it left set)."""
    d = tmp_path_factory.mktemp("ck")
    try:
        rc, text = run_main(cli.main, [
            "run", "--no-output", "--end", "1982-01-02",
            "--checkpoint-every", "1", "--checkpoint-dir", str(d / "ck"),
            "--matmul-precision", "tensorfloat32", "--profile",
            str(d / "prof")] + PORT)
        precision = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision("highest")
    assert rc == 0
    return d, text, precision


def test_restart_takes_the_checkpoint_start(checkpointed, tmp_path):
    path = str(checkpointed[0] / "ck" / "ckpt_198201020000.npz")
    rc, text = run_main(cli.main, [
        "run", "--start", "1982-03-01", "--end", "1982-01-02T04:00",
        "--restart-from", path, "--output-dir", str(tmp_path / "out")]
        + PORT)
    assert rc == 0
    assert "note: using original run start Datetime(year=1982, month=1, " \
        "day=1" in text
    assert f"resuming from {path} at " in text and "(step 36)" in text
    names = sorted(os.listdir(tmp_path / "out"))
    assert names == [f"19820102{h:02d}{m:02d}.nc" for h, m in
                     ((0, 40), (1, 20), (2, 0), (2, 40), (3, 20), (4, 0))]
    f = read_nc(str(tmp_path / "out" / names[0]))
    assert f["time"][2] == b"hours since 1982-01-01 00:00:0.0"
    assert f["time"][0][0] == np.float32(37 * 24.0 / 36)


def test_auto_resume_takes_the_newest_checkpoint(checkpointed, tmp_path):
    """--auto-resume picks the newest checkpoint of --checkpoint-dir (an
    older copy beside it is passed over) and continues as --restart-from
    does; with no checkpoints it starts fresh."""
    import shutil
    ck = tmp_path / "ck"
    ck.mkdir()
    newest = ck / "ckpt_198201020000.npz"
    shutil.copy(checkpointed[0] / "ck" / newest.name, newest)
    shutil.copy(newest, ck / "ckpt_198201010000.npz")
    rc, text = run_main(cli.main, [
        "run", "--end", "1982-01-02T01:20", "--auto-resume",
        "--checkpoint-dir", str(ck), "--output-dir", str(tmp_path / "out")]
        + PORT)
    assert rc == 0
    assert f"resuming from {newest} at " in text and "(step 36)" in text
    assert sorted(os.listdir(tmp_path / "out")) == [
        "198201020040.nc", "198201020120.nc"]
    rc, text = run_main(cli.main, [
        "run", "--no-output", "--end", "1982-01-01T00:40", "--auto-resume",
        "--checkpoint-dir", str(tmp_path / "none")] + PORT)
    assert rc == 0 and "auto-resume: no checkpoints in " in text


def test_matmul_precision_and_profile(checkpointed):
    d, text, precision = checkpointed
    assert precision == "high"
    assert os.path.getsize(d / "prof" / "trace.json") > 0
    assert f"profile: {d / 'prof' / 'trace.json'}" in text


def test_writer_falls_back_to_scipy_naming_why(monkeypatch, tmp_path):
    from speedy_tpu_torch.utils import native_output

    def broken():
        raise RuntimeError("g++ failed for ncwriter:\nerror: no compiler")

    monkeypatch.setattr(native_output, "_library", broken)
    w, line = cli.make_writer(t30(), str(tmp_path))
    assert isinstance(w, NetCDFWriter)
    assert line.startswith("output writer: scipy")
    assert "g++ failed for ncwriter: error: no compiler" in line
    w, line = cli.make_writer(t30(), str(tmp_path))
    assert isinstance(w, NetCDFWriter)


@pytest.fixture(scope="module")
def direct_ensemble(bc):
    """Member fields of a direct 2-member, 1-day SPPT ensemble, seed 3."""
    model = Model(t30(sppt_on=True), device="cpu", bc_arrays=bc)
    ens = Ensemble(model, 2, base_seed=3)
    start = cal.Datetime(1982, 1, 1)
    estate, _ = ens.run_days(ens.initialize(start), start, 1)
    return [{k: v.numpy().astype(np.float32)
             for k, v in ens.member_fields(estate, i).items()}
            for i in range(2)]


@pytest.mark.parametrize("every_step", [False, True])
def test_ensemble_member_files(tmp_path, direct_ensemble, every_step):
    argv = ["ensemble", "--members", "2", "--days", "1", "--seed", "3",
            "--output-dir", str(tmp_path)] + PORT
    rc, text = run_main(cli.main, argv + (["--output-every-step"]
                                          if every_step else []))
    assert rc == 0
    assert sorted(os.listdir(tmp_path)) == ["member000", "member001"]
    for i, direct in enumerate(direct_ensemble):
        names = sorted(os.listdir(tmp_path / f"member{i:03d}"))
        assert len(names) == (37 if every_step else 1)
        assert names[-1] == "198201020000.nc"
        f = read_nc(str(tmp_path / f"member{i:03d}" / names[-1]))
        for k, v in direct.items():
            np.testing.assert_array_equal(f[k][0][0], v, err_msg=k)
    assert ("output writer: native" in text) == every_step
