"""The readers of the program's own spans and counters (program_spans.py
and the metrics that use it) on a synthetic trace and span log: the
anchor maps program spans onto the trace's clock, idle time goes to the
innermost span open and to ``outside`` where none is, host self time
leaves out child spans, the SPPT draws' host time leaves out a step
blocked on the launch queue, counters are summed over the window, set-up's
spans are read outermost only, and a ring that dropped events inside what
a reader reads gives None, as does a program without the ring."""
from __future__ import annotations

import math
import sys

import pytest

from benchmark import harness, program_spans
from benchmark.program_spans import Log
from benchmark.trace import Kernel, Span, Trace

NONE = -math.inf
H0, H1 = 10.0, 10.001          # the sub-window's chunk, host seconds
T0, T1 = 5000.0, 6000.0        # the same on the trace's clock, µs


def host(us: float) -> float:
    """A trace stamp (µs) as a host stamp (s)."""
    return H1 + (us - T1) * 1e-6


def span(name, a_us, b_us, seq, parent=-1):
    return ("speedy." + name, host(a_us), host(b_us), seq, parent, 0)


class FakeCell:
    members, sppt, params = 1, False, {}
    model_config = dict(nsteps=36)


def make_run(kernels, profile_days=1):
    run = harness.Run(FakeCell(), 1, 1.0, True, "cuda", 0.0)
    run.spans.done["chunk"] = [0.5, H1 - H0]
    run.spans.stamps["chunk"] = [5.5, H1]
    run.trace = Trace(wall_s=0.001, kernels=kernels, spans=[
        Span("bench.chunk", T0, T1), Span("cudaMemcpyAsync", 5150, 5450)])
    run.profile_days = profile_days
    run.window_start, run.window_s, run.window_days = 1.0, 4.0, 8
    return run


# busy [5000, 5100] and [5500, 6000]: idle [5100, 5500], 400 µs
KERNELS = [Kernel("k", 5000, 100), Kernel("k", 5500, 300),
           Kernel("k", 5800, 200)]


def test_anchor_maps_spans_onto_the_trace():
    run = make_run(KERNELS)
    log = Log([span("call.run", 5000, 6000, 0),
               span("day.fetch", 5200, 5400, 1, 0)], NONE)
    idle = program_spans.idle_us(run, log)
    assert idle["fetch"] == pytest.approx(200)
    assert idle["call"] == pytest.approx(200)
    assert idle["outside"] == pytest.approx(0, abs=1e-6)


def test_innermost_span_takes_the_idle(monkeypatch):
    run = make_run(KERNELS)
    log = Log([span("day.fetch", 5200, 5400, 2, 1),
               span("day.guard", 5150, 5450, 1, 0),
               span("call.run_fast", 5000, 6000, 0)], NONE)
    idle = program_spans.idle_us(run, log)
    assert idle == pytest.approx({"call": 100, "guard": 100, "fetch": 200,
                                  "outside": 0}, abs=1e-6)
    monkeypatch.setattr(program_spans, "program_log", lambda: log)
    got = {k: harness.find_module(harness.HERE, "metrics", "idle_ms.x")
           .read(run, f"idle_ms.{k}.t170") for k in ("fetch", "dates")}
    assert got == pytest.approx({"fetch": 0.2, "dates": 0.0})


def test_idle_in_no_span_is_outside_and_tails_count():
    # the last kernel ends after the chunk: the sub-window runs to it
    run = make_run(KERNELS[:2] + [Kernel("k", 6200, 100)], profile_days=2)
    log = Log([span("day.replay", 5120, 5200, 0)], NONE)
    idle = program_spans.idle_us(run, log)
    assert idle["replay"] == pytest.approx(80)
    assert idle["outside"] == pytest.approx(400 - 80 + 400)
    assert sum(idle.values()) == pytest.approx(800)


def test_host_self_time_leaves_out_child_spans(monkeypatch):
    log = Log([("speedy.day.fetch", 2.0, 2.25, 1, 0, 0),
               ("speedy.day.guard", 1.5, 3.0, 0, -1, 0),
               ("speedy.day.guard", 3.5, 4.0, 2, -1, 0),
               ("speedy.day.guard", 4.5, 6.0, 3, -1, 0),  # past the window
               ("d2h.bytes", 2.1, 2.1, -1, -1, 4_000_000),
               ("d2h.bytes", 5.5, 5.5, -1, -1, 4_000_000)], NONE)
    assert program_spans.self_seconds(log, 1.0, 5.0) == pytest.approx(
        {"speedy.day.guard": 1.25 + 0.5, "speedy.day.fetch": 0.25})
    monkeypatch.setattr(program_spans, "program_log", lambda: log)
    run = make_run(KERNELS)
    read = lambda name: harness.find_module(
        harness.HERE, "metrics", name).read(run, name)
    assert read("host_ms.guard.day") == pytest.approx(1750 / 8)
    assert read("host_ms.fetch.day") == pytest.approx(250 / 8)
    assert read("host_ms.checkpoint.day") == 0.0
    assert read("d2h_mb_per_day.day") == pytest.approx(0.5)
    assert read("draw_launches_per_day.members") == 0


def test_draw_host_time_leaves_out_a_step_blocked_on_the_queue(monkeypatch):
    # two draw spans of 4 steps at 1 ms each, the second day's third
    # step blocked 50 ms behind the day before
    ev = []
    for a, slow in ((1.0, 0.0), (2.0, 0.05)):
        ev.append(("speedy.day.draw", a, a + 0.004 + slow + 0.0001,
                   len(ev), -1, 0))
        t = a
        for i in range(4):
            t += 0.001 + (slow if i == 2 else 0.0)
            ev.append(("sppt.draw_launches", t, t, -1, -1, 64))
    ev.append(("speedy.day.draw", 3.0, 3.003, 99, -1, 0))  # no steps marked
    log = Log(ev, NONE)
    own, blocked = program_spans.stepped_seconds(
        log, "speedy.day.draw", "sppt.draw_launches", 0.5, 5.0)
    assert own == pytest.approx(0.008 + 0.003)
    assert blocked == pytest.approx(0.05 + 0.0002)
    monkeypatch.setattr(program_spans, "program_log", lambda: log)
    run = make_run(KERNELS)
    read = lambda name: harness.find_module(
        harness.HERE, "metrics", name).read(run, name)
    assert read("host_ms.draw.members") == pytest.approx(11 / 8)
    assert read("draw_launches_per_day.members") == pytest.approx(512 / 8)


def test_setup_phases_read_outermost_spans_before_the_window(monkeypatch):
    log = Log([("speedy.setup.tables", 0.1, 0.3, 0, -1, 0),
               ("speedy.setup.boot", 0.35, 0.4, 2, 1, 0),
               ("speedy.setup.boot", 0.3, 0.5, 1, -1, 0),
               ("speedy.capture.warmup", 0.6, 0.7, 4, 3, 0),
               ("speedy.call.run_fast", 0.5, 0.9, 3, -1, 0),
               ("speedy.setup.boot", 1.5, 1.6, 5, -1, 0)], NONE)
    monkeypatch.setattr(program_spans, "program_log", lambda: log)
    run = make_run(KERNELS)
    read = lambda name: harness.find_module(
        harness.HERE, "metrics", name).read(run, name)
    assert read("setup_phase_s.tables") == pytest.approx(0.2)
    assert read("setup_phase_s.boot") == pytest.approx(0.2)
    assert read("setup_phase_s.warmup") == pytest.approx(0.1)
    assert read("setup_phase_s.graph") is None


def test_a_dropped_window_gives_none(monkeypatch):
    run = make_run(KERNELS)
    log = Log([span("call.run", 5000, 6000, 0)], H0 + 1e-4)
    assert program_spans.idle_us(run, log) is None
    monkeypatch.setattr(program_spans, "program_log", lambda: log)
    for name in ("idle_ms.call.day", "host_ms.fetch.day",
                 "d2h_mb_per_day.day", "draw_launches_per_day.members",
                 "setup_phase_s.tables"):
        mod = harness.find_module(harness.HERE, "metrics", name)
        assert mod.read(run, name) is None, name
    # dropped before the window: the window's readers still read
    monkeypatch.setattr(program_spans, "program_log",
                        lambda: Log([], run.window_start - 0.5))
    mod = harness.find_module(harness.HERE, "metrics", "host_ms")
    assert mod.read(run, "host_ms.fetch.day") == 0.0


def test_no_ring_in_the_program_gives_none(monkeypatch):
    import speedy_tpu_torch.utils
    monkeypatch.delattr(speedy_tpu_torch.utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "speedy_tpu_torch.utils.tracing", None)
    assert program_spans.program_log() is None
    run = make_run(KERNELS)
    for name in ("idle_ms.call.day", "host_ms.fetch.day",
                 "d2h_mb_per_day.day", "setup_phase_s.boot"):
        mod = harness.find_module(harness.HERE, "metrics", name)
        assert mod.read(run, name) is None, name


def test_the_program_ring_reads_as_a_log():
    from speedy_tpu_torch.utils import tracing
    with tracing.span("day.fetch"):
        tracing.count("d2h.bytes", 3)
    log = program_spans.program_log()
    assert log.events[-1][0] == "speedy.day.fetch"
    assert log.events[-2][0] == "d2h.bytes" and log.events[-2][5] == 3
    assert program_spans.key(log.events[-1][0]) == "fetch"
    assert program_spans.key("speedy.call.run_days") == "call"
