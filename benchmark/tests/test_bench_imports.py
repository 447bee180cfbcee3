"""Nothing the benchmark runs on the chip imports JAX or the JAX package,
and no plain reference (``reference/``, and every package that a
configuration names) imports anything of the program either. Modules are
compared by their top-level name, the part before the first dot, whole:
the program's name begins with the JAX package's."""
from __future__ import annotations

import ast
import json
import os

import pytest

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "speedy_tpu"}
PROGRAM = "speedy_tpu_torch"


def sources(sub: str = ""):
    base = os.path.join(harness.HERE, sub)
    for dirpath, dirnames, files in os.walk(base):
        dirnames[:] = [d for d in dirnames if d not in ("tests",
                                                        "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_level_imports(path: str):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


def references():
    """The directories of every reference package: the default and each
    one that a configuration's file names."""
    dirs = {"reference"}
    for c in harness.load_manifest()["configs"]:
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            dirs.add(json.load(f).get("reference", "reference"))
    return sorted(dirs)


@pytest.mark.parametrize("path", sorted(p for d in references()
                                        for p in sources(d)),
                         ids=lambda p: os.path.relpath(p, harness.HERE))
def test_reference_imports_nothing_of_the_program(path):
    names = set(top_level_imports(path))
    assert not names & (FORBIDDEN | {PROGRAM, "benchmark"})
    assert names <= {"__future__", "numpy", "torch", "typing",
                     "dataclasses", "functools", "json", "logging", "math",
                     "os", "scipy", "warnings", "h5py"}, names


def test_names_are_compared_whole(monkeypatch):
    import sys
    import types
    for name in list(sys.modules):      # a process that loaded them
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    for name in ("speedy_tpu_torch_probe", "jaxlike.sub", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "speedy_tpu.models",
                        types.ModuleType("speedy_tpu.models"))
    assert harness.forbidden_modules() == ["jax", "speedy_tpu"]
