"""speedy_tpu_torch.stability_diag against the JAX script
(scripts/stability_diag.py, imported by path), on the CPU:

* ``spectra`` (per total wavenumber and level: rotational and divergent
  KE, T variance; vor/div maxima) against the JAX ``spectra`` on the same
  seeded fp64 spectral state, T21 kx=5 and T30, <= 1e-12 per array;
* a 2-day run (T30, chunks of one day) ends ``clean`` and writes the JAX
  script's npz keys with its shapes, and its final JSON line has the JAX
  script's keys;
* ``--tf32`` is recorded as f32_matmul false and the caller's matmul
  precision is restored.
"""
import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

from speedy_tpu.config import t30 as jt30
from speedy_tpu.geometry import build_geometry_np as jgeometry
from speedy_tpu.ops import spectral as jsp
from speedy_tpu_torch import stability_diag as sd
from speedy_tpu_torch.config import t30
from speedy_tpu_torch.geometry import build_geometry_np
from speedy_tpu_torch.models.state import PrognosticState
from speedy_tpu_torch.ops import spectral as tsp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = 1e-12
GRIDS = {"t21_kx5": dict(trunc=21, ix=64, il=32, kx=5), "t30": {}}
NPZ_KEYS = {"days", "ke_rot", "ke_div", "t_var", "vor_max", "guard"}
JSON_KEYS = {"metric", "preset", "days_run", "status",
             "first_guard_trip_day", "lwvec", "f32_matmul", "rob", "thd",
             "thdd", "thds", "nsteps", "out", "wall_s"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's runs with one intra-op thread, as in
    tests/test_torch_cli.py: the Tier-1 run puts 6 workers on the
    machine's cores, and 6 full thread teams oversubscribe them."""
    default = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(default)


@pytest.fixture(scope="module")
def jax_stability_diag():
    spec = importlib.util.spec_from_file_location(
        "_jax_stability_diag", os.path.join(REPO, "scripts",
                                            "stability_diag.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("grid", list(GRIDS))
def test_spectra_match_jax(jax_stability_diag, grid):
    kw = dict(precision="fp64", **GRIDS[grid])
    jcfg, cfg = jt30(**kw), t30(**kw)
    jmodel = types.SimpleNamespace(
        cfg=jcfg, sp_np=jsp.build_spectral_np(jcfg, jgeometry(jcfg)))
    model = types.SimpleNamespace(
        cfg=cfg, sp_np=tsp.build_spectral_np(cfg, build_geometry_np(cfg)))
    rng = np.random.default_rng(3)
    spec = (2, cfg.kx, cfg.mx, cfg.nx, 2)
    arrays = dict(vor=rng.normal(0.0, 1e-5, spec),
                  div=rng.normal(0.0, 1e-6, spec),
                  t=rng.normal(0.0, 5.0, spec),
                  ps=rng.normal(0.0, 1e-2, spec[:1] + spec[2:]),
                  tr=rng.normal(0.0, 1.0, (2, 1) + spec[1:]))
    want = jax_stability_diag.spectra(
        jmodel, types.SimpleNamespace(prog=types.SimpleNamespace(**arrays)))
    got = sd.spectra(model, PrognosticState(
        **{k: torch.from_numpy(v) for k, v in arrays.items()}))
    assert got.keys() == want.keys()
    for k, v in want.items():
        v = np.asarray(v)
        assert np.shape(got[k]) == v.shape, k
        err = np.abs(got[k] - v).max() / max(np.abs(v).max(), 1e-300)
        assert err <= BOUND, k


def test_two_day_run_ends_clean(tmp_path, capsys):
    out = str(tmp_path / "stab.npz")
    assert sd.main(["--preset", "t30", "--days", "2", "--chunk", "1",
                    "--synthetic-bc", "0", "--device", "cpu",
                    "--out", out]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    final = lines[-1]
    assert final["status"] == "clean" and final["days_run"] == 2
    assert final["first_guard_trip_day"] is None
    assert JSON_KEYS <= set(final) and final["f32_matmul"] is True
    assert [x["day"] for x in lines[:-1]] == [1, 2]
    cfg = t30()
    nell = cfg.mx + cfg.nx - 1
    with np.load(out) as f:
        assert set(f.files) == NPZ_KEYS
        np.testing.assert_array_equal(f["days"], [0, 1, 2])
        for k in ("ke_rot", "ke_div", "t_var"):
            assert f[k].shape == (3, nell, cfg.kx), k
            assert np.isfinite(f[k]).all()
        assert f["vor_max"].shape == (3,)
        assert f["guard"].shape == (2, 5)
        np.testing.assert_array_equal(f["guard"][:, 0], [1, 2])


def test_tf32_switch_is_recorded_and_undone(tmp_path, capsys):
    """--tf32 sets TF32 matmuls for the run (the A/B of the JAX script's
    --f32-matmul), records f32_matmul false, and restores the precision
    the caller had (a run of no days: the boot only)."""
    before = torch.get_float32_matmul_precision()
    assert sd.main(["--preset", "t30", "--days", "0", "--tf32",
                    "--synthetic-bc", "0", "--device", "cpu",
                    "--out", str(tmp_path / "stab.npz")]) == 0
    final = json.loads([x for x in capsys.readouterr().out.splitlines()
                        if x.startswith("{")][-1])
    assert final["f32_matmul"] is False and final["status"] == "clean"
    assert torch.get_float32_matmul_precision() == before
