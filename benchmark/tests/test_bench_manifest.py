"""BENCHMARK.json against the benchmark's contract: names, units and
lengths, the keys of each entry, the metrics each cell reports, and the
files the harness finds by name, the configurations' reference packages
among them."""
from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import harness

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"[A-Za-z0-9_./\-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# what a reference package gives the check and the counts
REFERENCE = ("ModelConfig", "ReferenceModel", "to_state", "Datetime",
             "load_checkpoint", "transform_tables")
REFERENCE_MODEL = ("initial_state", "initialize", "run_day",
                   "gridded_fields")


@pytest.fixture(scope="module")
def manifest():
    with open(harness.MANIFEST) as f:
        text = f.read()
    assert len(text.encode()) <= 64 * 1024
    return json.loads(text)


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(manifest):
    assert set(manifest) == TOP
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for w in cmd[1:]:
        if os.path.sep in w or w.endswith(".py"):
            assert any(w.startswith(p) for p in manifest["paths"])
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51


def test_check_fits_with_24_cells(manifest):
    rs = manifest["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries(manifest, kind):
    entries = manifest[kind]
    assert entries
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
            assert e["source"] in SOURCES
        for k in ("why", "layer"):
            if k in e:
                assert line(e[k]), (e["name"], k)
        if kind == "configs":
            assert line(e["source"])


def test_configs(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    for c in manifest["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in
                                          manifest["paths"]))
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))


def missing_interface(pkg, sppt: bool = False) -> list:
    """The names of the interface (reference/__init__.py) that the
    reference package ``pkg`` does not give, ``sppt_start`` too with
    ``sppt``, ``ReferenceModel``'s methods as ``ReferenceModel.<name>``."""
    names = REFERENCE + (("sppt_start",) if sppt else ())
    out = [n for n in names if not hasattr(pkg, n)]
    if "ReferenceModel" not in out:
        out += [f"ReferenceModel.{m}" for m in REFERENCE_MODEL
                if not callable(getattr(pkg.ReferenceModel, m, None))]
    return out


@pytest.mark.parametrize("config", [c["name"] for c in
                                    harness.load_manifest()["configs"]])
def test_reference_gives_the_interface(manifest, config):
    """A configuration's ``reference`` names a package under the
    benchmark's directory that gives what the check and the counts take
    (``sppt_start`` too where a cell of it runs SPPT); without the key,
    the default does."""
    cells = [harness.Cell(w["name"], manifest) for w in manifest["workloads"]
             if w["config"] == config]
    pkg = cells[0].reference
    assert missing_interface(pkg, any(c.sppt for c in cells)) == []


def test_cells(manifest):
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)
    for w in manifest["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])


def test_bounds(manifest):
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in manifest["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_manifest()
                                  ["workloads"]])
def test_each_cell_reports_and_its_files_exist(manifest, cell):
    c = harness.Cell(cell, manifest)
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    assert harness.find_module(c.package_dir, "drivers",
                               c.params["driver"]) is not None
    for m in c.end_to_end + c.per_layer:
        assert harness.find_module(c.package_dir, "metrics",
                                   m["name"]) is not None, m["name"]
    assert c.params["check"]


def test_moves_names_a_metric_every_listed_cell_reports(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = [w["name"] for w in manifest["workloads"]]
    layers = {}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        mover = e2e[m["moves"]]
        reporting = set(mover.get("workloads", cells))
        assert set(m.get("workloads", reporting)) <= reporting, m["name"]
        layers.setdefault(m["layer"], set()).add(m["name"])
    # a share of a roofline or of a peak is named as such, in %
    for m in manifest["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline") or \
                "mfu" in m["name"]:
            assert m["unit"] == "%"
