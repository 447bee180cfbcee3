"""The port's validation programs (speedy_tpu_torch/stability_gate.py,
run_climatology.py, fp32_qualification.py) against the JAX package's
scripts on the CPU.

* run_climatology.climate_stats on a JAX state converted to the port
  (T21 kx=5 fp64, 6 steps after boot) against the JAX scripts' inline
  formulas on the JAX model's own gridded fields
  (scripts/stability_gate.py:62-70, scripts/run_climatology.py:56-74):
  <= 1e-12 relative;
* gate_preset("t30", 1, device="cpu") against the JAX script's
  gate_preset on HDF5 copies of the same stand-in set (its boundary search
  path pointed at them): the JAX keys, a clean guard, and t_sfc_global_K
  and jet_max_ms within 0.01 after one fp32 day (the JAX script's
  rounding is shadowed to compare unrounded values);
* the qualification's report against scripts/fp32_qualification.py's
  part_report on the same seeded arrays: the same table and crossing days
  (the port's matmul pair is TF32 where the JAX script's is bf16).
"""
import contextlib
import importlib.util
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from speedy_tpu.config import t30 as jt30
from speedy_tpu.models.model import Model as JModel
from speedy_tpu.utils import io as jio
from speedy_tpu_torch import fp32_qualification as fq
from speedy_tpu_torch import stability_gate
from speedy_tpu_torch.config import t30
from speedy_tpu_torch.models.model import Model
from speedy_tpu_torch.run_climatology import climate_stats
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils.synthetic_bc import (synthetic_boundaries,
                                                 write_boundary_files)
from torch_parity import SMALL, START, port_steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS_BOUND = 1e-12
GATE_TOL = 0.01


def jax_script(name):
    """scripts/<name>.py of the JAX package, imported as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
def bc_dir(bc, tmp_path_factory):
    d = tmp_path_factory.mktemp("bc")
    write_boundary_files(str(d), bc)
    return str(d)


def jax_inline_stats(jm, prog):
    """The JAX scripts' formulas, as they stand there, on the JAX model's
    gridded fields."""
    cfg = jm.cfg
    g = {k: np.asarray(v) for k, v in jm._gridded(jm.mc, prog).items()}
    fsg = jm.geom_np["fsg"]
    kjet = int(np.argmin(np.abs(fsg - 0.2)))
    ubar = g["u"].mean(axis=-1)
    wt = jm.sp_np["wt"]
    wfull = np.concatenate([wt, wt[::-1]])
    wfull = wfull / wfull.sum()
    return dict(
        t_sfc_global_K=float((g["t"][cfg.kx - 1].mean(axis=-1)
                              * wfull).sum()),
        jet_sigma=float(fsg[kjet]),
        jet_max_ms=float(g["u"][kjet].mean(axis=-1).max()),
        jet_min_ms=float(ubar[kjet].min()),
        ps_min_Pa=float(g["ps"].min()), ps_max_Pa=float(g["ps"].max()),
        finite=bool(np.all([np.isfinite(v).all() for v in g.values()])))


def test_climate_stats_match_jax_formulas(bc, bc_dir):
    """On a JAX state made from the port's state 6 steps after boot (no
    JAX step is compiled) and converted back to the port."""
    import jax.numpy as jnp
    from speedy_tpu.models.state import PrognosticState as JProg
    jm = JModel(jt30(**SMALL), bc_search=[bc_dir])
    tm = Model(t30(**SMALL), device="cpu", bc_arrays=bc)
    _, ts = port_steps(tm, cal.Datetime(*START))
    jprog = JProg(**{k: jnp.asarray(v.numpy())
                     for k, v in ts.prog._asdict().items()})
    port = climate_stats(tm, type(ts.prog)(*(
        torch.as_tensor(np.array(x)) for x in jprog)))
    ref = jax_inline_stats(jm, jprog)
    assert set(port) == set(ref)
    assert port["finite"] and ref["finite"]
    for k, v in ref.items():
        if k != "finite":
            assert abs(port[k] - v) <= STATS_BOUND * abs(v), (k, port[k], v)


@pytest.fixture(scope="module")
def port_gate():
    """The port's gate over one T30 day on the CPU, through its main
    (gate_preset("t30", 1, device="cpu") on the stand-in set): (rc, the
    printed lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = stability_gate.main(["--presets", "t30", "--days", "1",
                                  "--synthetic-bc", "0", "--device", "cpu"])
    return rc, buf.getvalue().strip().splitlines()


def test_gate_preset_matches_jax_script(bc_dir, port_gate, monkeypatch):
    gate = jax_script("stability_gate")
    monkeypatch.setattr(jio, "DEFAULT_BC_PATHS", [bc_dir])
    monkeypatch.setattr(gate, "round", lambda x, n=None: x, raising=False)
    ref = gate.gate_preset("t30", 1)
    port = json.loads(port_gate[1][0])
    assert set(ref) <= set(port)
    assert ref["guard_clean"] and port["guard_clean"] and port["finite"]
    for k in ("preset", "days", "diag_every", "dt_s", "fused"):
        assert port[k] == ref[k], k
    for k in ("t_sfc_global_K", "jet_max_ms"):
        assert abs(port[k] - ref[k]) <= GATE_TOL, (k, port[k], ref[k])
    for k in ("t_sfc_ok", "jet_ok", "pass"):
        assert port[k] == ref[k], k


def test_gate_main_prints_a_line_per_preset(port_gate):
    rc, lines = port_gate
    assert len(lines) == 2 and '"preset": "t30"' in lines[0]
    assert lines[1] == ('{"metric": "stability_gate", "presets": "t30", '
                        '"days": 1, "pass": false}')
    assert rc == 1   # one day from rest: the jet has not spun up yet


def seeded_curves(days=12, seed=5):
    """Daily fields whose drifts and spread grow at different rates, so
    each drift crosses each fraction of the spread on some day."""
    rng = np.random.default_rng(seed)
    shape = (days, 6, 8)
    grow = lambda rate: np.exp(rate * np.arange(1, days + 1))[:, None, None]
    base = rng.normal(280.0, 5.0, shape)
    return dict(
        t_fp64=base, t_fp32=base + 0.01 * grow(0.6) * rng.normal(size=shape),
        t_mm_a=base + 0.03 * grow(0.45) * rng.normal(size=shape),
        t_mm_b=base.copy(),
        t_ens=base[:, None] + 0.2 * grow(0.15)[:, None]
        * rng.normal(size=(days, 16, 6, 8)))


def test_report_matches_jax_part_report(tmp_path, monkeypatch, capsys):
    days = 12
    c = seeded_curves(days)
    np.savez(tmp_path / "fp32_qual_precision_t30.npz", t_fp64=c["t_fp64"],
             t_fp32=c["t_fp32"])
    np.savez(tmp_path / "fp32_qual_matmul_t30.npz", t_tf32=c["t_mm_a"],
             t_f32mm=c["t_mm_b"])
    np.savez(tmp_path / "fp32_qual_ensemble_t30.npz", t_ens=c["t_ens"])
    assert fq.main(["--part", "report", "--days", str(days), "--out",
                    str(tmp_path)]) == 0
    port = capsys.readouterr().out

    qual = jax_script("fp32_qualification")
    files = {"/tmp/fp32_qual_cpu_t30.npz": dict(t_fp64=c["t_fp64"],
                                                  t_fp32=c["t_fp32"]),
             "/tmp/fp32_qual_tpu_t30.npz": dict(t_bf16=c["t_mm_a"],
                                                  t_f32mm=c["t_mm_b"],
                                                  t_ens=c["t_ens"])}

    class Numpy:   # the script's numpy with its loads from the arrays above
        load = staticmethod(files.__getitem__)

        def __getattr__(self, name):
            return getattr(np, name)

    monkeypatch.setattr(qual, "np", Numpy())
    monkeypatch.setattr(qual, "DAYS", days)
    qual.part_report()
    ref = capsys.readouterr().out
    assert port.replace("tf32", "bf16") == ref
    crossings = re.findall(r"at day (\w+)", ref)
    assert len(crossings) == 6 and "None" not in crossings[:4]
    assert len(port.splitlines()) == days + 4
