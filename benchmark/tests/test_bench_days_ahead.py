"""The reader of ``days_ahead_per_day`` on a synthetic span log: the
``run.days_ahead`` counter's events inside the window over its simulated
days; None for a program that never counted it, and for a ring that
dropped events of the window."""
from __future__ import annotations

import math

import pytest

from benchmark import harness, program_spans
from benchmark.program_spans import Log
from benchmark.tests.test_bench_program_spans import KERNELS, make_run

NAME = "days_ahead_per_day.day"


def read(monkeypatch, log):
    monkeypatch.setattr(program_spans, "program_log", lambda: log)
    run = make_run(KERNELS)     # the window: [1, 5] s, 8 days
    return harness.find_module(harness.HERE, "metrics", NAME).read(run, NAME)


def test_counts_the_days_enqueued_ahead_in_the_window(monkeypatch):
    ev = [("run.days_ahead", t, t, -1, -1, 1)
          for t in (0.5, 1.5, 2.0, 2.5, 3.0, 4.5, 5.5)]
    assert read(monkeypatch, Log(ev, -math.inf)) == pytest.approx(5 / 8)


def test_a_program_that_never_counted_it_gives_none(monkeypatch):
    ev = [("d2h.bytes", 2.0, 2.0, -1, -1, 100)]
    assert read(monkeypatch, Log(ev, -math.inf)) is None
    assert read(monkeypatch, None) is None


def test_a_dropped_window_gives_none(monkeypatch):
    ev = [("run.days_ahead", 2.0, 2.0, -1, -1, 1)]
    assert read(monkeypatch, Log(ev, 1.5)) is None
