"""The check's plain reference is the configuration's: every cell of
BENCHMARK.json resolves to ``reference/``, also in a copy of the
benchmark that leaves it out; a configuration added by files and entries
alone that names a package of its own is checked (its SPPT start and first
day too, with a stub day) and counted through that package; a name with no package behind it fails, naming the
configuration. No model day is run."""
from __future__ import annotations

import hashlib
import os

import numpy as np
import pytest
import torch

import benchmark.reference
from benchmark import check, counts, harness
from benchmark.tests.test_bench_cells import (add_cell, copy_benchmark,
                                              tiny_config)
from benchmark.tests.test_bench_manifest import missing_interface

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]

# a reference package as a later change adds one: it records its calls
TOY = '''
import dataclasses
import types

import numpy as np

calls = []


class ModelConfig:
    def __init__(self, **fields):
        self.fields = fields


@dataclasses.dataclass
class Datetime:
    year: int
    month: int
    day: int
    hour: int = 0
    minute: int = 0


class ReferenceModel:
    def __init__(self, cfg, device, boundaries):
        self.cfg, self.device = cfg, device
        calls.append(("ReferenceModel", cfg.fields["kx"]))

    def initial_state(self, date): ...

    def initialize(self, date):
        calls.append(("initialize", date))
        return types.SimpleNamespace(sppt="booted")

    def run_day(self, state, date, run_start, steps):
        calls.append(("run_day", state, date, run_start, steps))
        return [], state

    def gridded_fields(self, prog): ...


def to_state(model, arrays, sppt=None):
    calls.append(("to_state", model.cfg.fields["precision"], sorted(arrays),
                  sppt))
    return "toy state"


def sppt_start(model, seeds):
    calls.append(("sppt_start", list(seeds)))
    return "drawn"


def load_checkpoint(path, template):
    return (template,)


def transform_tables(trunc, ix, il, kx):
    calls.append(("transform_tables", trunc, ix, il, kx))
    eye = lambda n: np.eye(n)
    return dict(syn=(eye(3), eye(5)), ana=(eye(2), eye(7)))
'''


def snapshot(root: str) -> dict:
    out = {}
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def toy_cell(root: str, reference: str = "toy_reference") -> harness.Cell:
    """A configuration at 20 levels naming ``reference``, and its cell,
    which runs SPPT."""
    config = tiny_config()
    config.update(name="toy", reference=reference)
    config["model"]["kx"] = 20
    params = dict(driver="run_fast", start="1982-01-01", sppt=True,
                  check={"step1": 1})
    add_cell(root, "toy.single", config, params)
    return harness.Cell("toy.single", root=root)


@pytest.mark.parametrize("copy", [False, True], ids=["repo", "copy"])
@pytest.mark.parametrize("cell", CELLS)
def test_cells_resolve_to_the_default(tmp_path, cell, copy):
    root = copy_benchmark(tmp_path) if copy else harness.ROOT
    c = harness.Cell(cell, root=root)
    assert c.reference_dir is None
    assert c.reference is benchmark.reference
    run = harness.Run(c, 1, 1.0, False, "cpu", 0.0)
    assert run.shapes["reference"] is benchmark.reference


def test_named_reference_is_checked_and_counted(tmp_path):
    root = copy_benchmark(tmp_path)
    before = snapshot(root)
    os.mkdir(os.path.join(root, "benchmark", "toy_reference"))
    with open(os.path.join(root, "benchmark", "toy_reference",
                           "__init__.py"), "w") as f:
        f.write(TOY)
    cell = toy_cell(root)
    run = harness.Run(cell, 1, 1.0, False, "cpu", 0.0)
    pkg = cell.reference
    assert pkg is not benchmark.reference
    assert os.path.dirname(pkg.__file__) == cell.reference_dir
    assert missing_interface(pkg, sppt=True) == []

    model = check.reference_model(run)
    assert isinstance(model, pkg.ReferenceModel)
    assert model.cfg.fields["precision"] == "fp64"
    start = {"prog.t": torch.zeros(2)}
    assert check.to_state(run, start, precision="tf32") == "toy state"
    ops = counts.transform_cost("syn", run.shapes, 1)[1]
    assert ops == 2 * (2 * 3 + cell.model_config["il"] * 5)
    day, begun = (1982, 1, 2, 0, 0), (1982, 1, 1, 0, 0)
    for seeds in ([5, 6], None):
        pair = dict(date=day, run_start=begun, sppt_seeds=seeds)
        assert check.first_day(run, start, pair, 2) == ([], "toy state")
    d, b = pkg.Datetime(*day), pkg.Datetime(*begun)
    assert check._start(run) == b
    assert pkg.calls == [
        ("ReferenceModel", 20), ("ReferenceModel", 20),
        ("to_state", "fp32", ["prog.t"], None),
        ("transform_tables", 21, 64, 32, 20),
        ("sppt_start", [5, 6]), ("to_state", "fp64", ["prog.t"], "drawn"),
        ("run_day", "toy state", d, b, 2),
        ("initialize", b), ("to_state", "fp64", ["prog.t"], "booted"),
        ("run_day", "toy state", d, b, 2)]
    check._models.clear()

    after = snapshot(root)
    assert {k for k in after if after[k] != before.get(k)} == {
        "BENCHMARK.json", "benchmark/configs/toy.json",
        "benchmark/workloads/toy.single.json",
        "benchmark/toy_reference/__init__.py"}
    assert set(before) <= set(after)


@pytest.mark.parametrize("name", ["no_such_reference", "..", "configs"])
def test_missing_reference_names_the_configuration(tmp_path, name):
    root = copy_benchmark(tmp_path)
    with pytest.raises(FileNotFoundError, match="configuration 'toy'"):
        toy_cell(root, name)


def test_default_transform_tables_take_any_kx():
    at8 = benchmark.reference.transform_tables(21, 64, 32, 8)
    at20 = benchmark.reference.transform_tables(21, 64, 32, 20)
    for d in ("syn", "ana"):
        for a, b in zip(at8[d], at20[d]):
            np.testing.assert_array_equal(a, b)
