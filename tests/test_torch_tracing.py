"""The program's spans and counters (speedy_tpu_torch/utils/tracing.py),
on the CPU.

* A tracer on a stepped clock: the parents and self times of nested
  spans, a ring that overflows reporting what it dropped, counter events
  inside a window, a recorded block's counts taken out of the registry and
  the ring and added back once per replay (the captured day's path, with
  a stub body: CPU days are not captured), and the CLI's spans.json.
* The run paths at T21L5 (the smallest grid of the port's tests): a
  ``Model.run`` of 2 days writes its day spans in order, and its
  ``d2h.bytes`` a day are the day's output buffer; ``run_fast`` and
  ``Ensemble.run_days`` write one ``day.guard`` a chunk and one
  ``day.draw`` a day, and ``sppt.draw_launches`` counts nsteps x members a
  day.
"""
import itertools
import json

import pytest

from speedy_tpu_torch import cli
from speedy_tpu_torch.config import t30
from speedy_tpu_torch.models.model import Model
from speedy_tpu_torch.parallel.ensemble import Ensemble
from speedy_tpu_torch.utils import calendar as cal
from speedy_tpu_torch.utils import tracing
from speedy_tpu_torch.utils.synthetic_bc import synthetic_boundaries

SMALL = dict(precision="fp32", trunc=21, ix=64, il=32, kx=5, sppt_on=True)
START = cal.Datetime(1982, 1, 1)


def stepped():
    """A clock that reads 0, 1, 2, ... at its successive calls."""
    return itertools.count().__next__


def spans(events):
    return [e for e in events if e.seq >= 0]


def self_time(events, span):
    return span.end - span.start - sum(
        e.end - e.start for e in spans(events) if e.parent == span.seq)


def test_nested_spans_parents_and_self_time():
    tr = tracing.Tracer(clock=stepped())
    with tr.span("call.run"):            # 0 .. 7
        with tr.span("day.guard"):       # 1 .. 4
            with tr.span("day.fetch"):   # 2 .. 3
                pass
        with tr.span("day.write"):       # 5 .. 6
            pass
    ev = {e.name: e for e in spans(tr.events())}
    assert [e.name for e in tr.events()] == [
        "speedy.day.fetch", "speedy.day.guard", "speedy.day.write",
        "speedy.call.run"]
    run, guard = ev["speedy.call.run"], ev["speedy.day.guard"]
    assert run.parent == -1
    assert guard.parent == ev["speedy.day.write"].parent == run.seq
    assert ev["speedy.day.fetch"].parent == guard.seq
    assert (run.start, run.end) == (0, 7)
    assert self_time(tr.events(), run) == 7 - 3 - 1
    assert self_time(tr.events(), guard) == 3 - 1


def test_span_records_when_its_block_raises():
    tr = tracing.Tracer(clock=stepped())
    with pytest.raises(ValueError):
        with tr.span("day.guard"):
            raise ValueError("out of range")
    assert [e.name for e in tr.events()] == ["speedy.day.guard"]
    with tr.span("day.fetch"):
        pass
    assert tr.events()[-1].parent == -1


def test_ring_that_overflows_reports_its_drop():
    tr = tracing.Tracer(size=4, clock=stepped())
    for _ in range(6):
        tr.count("d2h.bytes", 10)
    assert tr.counters["d2h.bytes"] == 60
    assert tr.ring.dropped == 2 and tr.ring.lost_until == 1
    assert [e.start for e in tr.events()] == [2, 3, 4, 5]
    assert tr.whole_since(2) and not tr.whole_since(1)
    assert tracing.Tracer().whole_since(0)


def test_count_events_fall_in_their_window():
    tr = tracing.Tracer(clock=stepped())
    for n in (1, 2, 4, 8):                      # at 0, 1, 2, 3
        tr.count("sppt.draw_launches", n)
    tr.count("d2h.bytes", 100)                  # at 4
    inside = sum(e.n for e in tr.events()
                 if e.name == "sppt.draw_launches" and 1 <= e.start <= 2)
    assert inside == 2 + 4
    assert tr.counters == {"sppt.draw_launches": 15, "d2h.bytes": 100}


def test_recorded_counts_are_taken_out_and_replayed_once():
    tr = tracing.Tracer(clock=stepped())
    tr.count("k1.launches", 5)

    def body():                                 # a day's stub body
        with tr.span("day.inside"):
            for sw in (True, False, False):
                tr.count("k1.launches")
                if sw:
                    tr.count("k1.launches_sw")
        tr.count("spectral.allreduces", 2)

    before = tr.events()
    with tr.recorded() as delta:
        body()
    assert delta == {"k1.launches": 3, "k1.launches_sw": 1,
                     "spectral.allreduces": 2}
    assert tr.counters == {"k1.launches": 5}
    assert tr.events() == before
    for _ in range(2):
        tr.replay(delta)
    assert tr.counters == {"k1.launches": 11, "k1.launches_sw": 2,
                           "spectral.allreduces": 4}
    assert [e.name for e in tr.events()[1:]] == [
        "k1.launches", "k1.launches_sw", "spectral.allreduces"] * 2


def test_cli_spans_json(tmp_path):
    t0 = tracing.TRACER.clock()
    with tracing.span("call.run"):
        tracing.count("d2h.bytes", 7)
    t1 = tracing.TRACER.clock()
    path = tmp_path / "spans.json"
    cli.write_spans(str(path), t0, t1)
    got = json.loads(path.read_text())
    assert got["t0"] == t0 and got["whole"]
    assert [s[0] for s in got["spans"]] == ["speedy.call.run"]
    assert [c[0] for c in got["counts"]] == ["d2h.bytes"]
    assert got["counts"][0][2] == 7
    assert t0 <= got["spans"][0][1] <= got["counts"][0][1] \
        <= got["spans"][0][2] <= t1


@pytest.fixture(scope="module")
def model():
    return Model(t30(nsteps_out=36, **SMALL), device="cpu",
                 bc_arrays=synthetic_boundaries(0))


def since(t0):
    """The global tracer's events from ``t0`` on."""
    return [e for e in tracing.events() if e.start >= t0]


def test_run_writes_its_day_spans_in_order(model, tmp_path):
    state = model.initialize(START)
    t0 = tracing.TRACER.clock()
    model.run(START, cal.Datetime(1982, 1, 3), verbose=False, state=state,
              output_writer=lambda *a: None, checkpoint_every=2,
              checkpoint_dir=str(tmp_path))
    ev = since(t0)
    sp = sorted(spans(ev), key=lambda e: e.start)
    day = ["day.dates", "day.draw", "day.replay", "day.fetch", "day.guard",
           "day.write"]
    assert [e.name[len(tracing.PREFIX):] for e in sp] == \
        ["call.run", "day.write"] + day + day + ["day.checkpoint"]
    run = sp[0]
    guards = {e.seq for e in sp if e.name == "speedy.day.guard"}
    for e in sp[1:]:
        assert e.parent in ({run.seq} | guards)
        assert run.start <= e.start <= e.end <= run.end
    # every step's fields and diagnostics, once a day
    cd = model.captured_day(state, collect_output=True, grids=True)
    per_day = cd.out_flat.numel() * cd.out_flat.element_size()
    fetched = [e.n for e in ev if e.name == "d2h.bytes"]
    assert fetched == [per_day, per_day]
    assert sum(e.n for e in ev if e.name == "sppt.draw_launches") == \
        2 * model.cfg.nsteps


def test_fast_and_ensemble_guard_once_a_chunk_draw_once_a_day(model):
    nsteps = model.cfg.nsteps
    state = model.initialize(START)
    t0 = tracing.TRACER.clock()
    model.run_fast(START, 2, state=state, max_chunk_days=1)
    ev = since(t0)
    names = [e.name for e in spans(ev)]
    assert names.count("speedy.day.guard") == 2     # 2 chunks of a day
    assert names.count("speedy.day.draw") == 2
    assert names.count("speedy.call.run_fast") == 1
    # one event a step, after its draw
    assert [e.n for e in ev if e.name == "sppt.draw_launches"] == \
        [1] * (2 * nsteps)

    members = 2
    ens = Ensemble(model, members, base_seed=3)
    estate = ens.initialize(START)
    t1 = tracing.TRACER.clock()
    ens.run_days(estate, START, 1)
    ev = since(t1)
    names = [e.name for e in spans(ev)]
    assert names.count("speedy.day.guard") == 1
    assert names.count("speedy.day.draw") == 1
    assert names.count("speedy.call.run_days") == 1
    assert [e.n for e in ev if e.name == "sppt.draw_launches"] == \
        [members] * nsteps
    # the ensemble's boot holds the model's: one outermost boot
    boots = [e for e in tracing.events()
             if e.name == "speedy.setup.boot" and t0 <= e.start < t1]
    outer = [e for e in boots if e.parent == -1]
    assert len(outer) == 1
    assert [e.parent for e in boots if e.parent != -1] == [outer[0].seq]
