"""The control on the card: the reference in the program's place, in
float32 with TF32 matrix products, fails the check of every cell, while
the program passes it, at each cell's own size on one seed (the readings
the limits were set from, on a dozen seeds and the control's on three, are
in PERF.md). A cell that asks for more cards than the machine has is
skipped. Run on the card with

    python -m pytest -m gpu benchmark/tests/test_bench_control.py
"""
from __future__ import annotations

import pytest

from benchmark import harness

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 matrix products "
                    "and the program's kernels run only there")
    from benchmark.run import environment
    environment()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    import torch
    from benchmark.control import readings
    c = harness.Cell(cell)
    found = torch.cuda.device_count()
    if found < c.chips:
        pytest.skip(f"{cell} needs {c.chips} cards, {found} found")
    r = readings(c, 20261017, 1.0)
    limits = c.params["check"]
    assert all(r["program"][k] <= v for k, v in limits.items()), r
    assert any(r["control"][k] > v for k, v in limits.items()), r
