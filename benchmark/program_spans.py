"""The program's own spans and counter events, as the per-layer readers
take them: from the ring of ``speedy_tpu_torch.utils.tracing``, imported
at run time as program.py imports the program (a program without it gives
nothing to read, and its readers return None).

Every stamp is ``time.perf_counter``, the clock of the harness's own
spans. The readers take three things from the ring:
- spans over a host window (the unprofiled window, or set-up before it),
  each with its self time: its duration less its child spans'; where a
  counter marks a span's steps, the host's own time apart from the time
  it spent blocked on a full launch queue;
- counter events over a window, summed;
- device idle time by program span: the profiled sub-window's trace is
  mapped onto the host clock through one anchor, the harness's ``chunk``
  span around the sub-window, which is both in the harness's log (its end
  on the host clock) and in the trace (the host event ``bench.chunk``).
  Each idle instant between the kernels of the sub-window goes to the
  innermost program span open then, and to ``outside`` where none is.

A reader returns None where the ring dropped events inside what it
reads.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Optional, Tuple

from .trace import busy_intervals

PREFIX = "speedy."
ANCHOR = "bench.chunk"


class Log(NamedTuple):
    """The ring's events, (name, start, end, seq, parent, n) each (a span
    has seq >= 0, a count seq -1), and the latest end among the events it
    dropped."""
    events: List[tuple]
    lost_until: float

    def whole_since(self, t: float) -> bool:
        return self.lost_until < t

    def spans(self) -> List[tuple]:
        return [e for e in self.events if e[3] >= 0]


def program_log() -> Optional[Log]:
    """The program's ring as it stands, or None where the program keeps
    none."""
    try:
        from speedy_tpu_torch.utils import tracing
    except ImportError:
        return None
    ring = tracing.TRACER.ring
    return Log([tuple(e) for e in ring.events], ring.lost_until)


def window(run) -> Tuple[float, float]:
    """The unprofiled window on the host clock."""
    return run.window_start, run.window_start + run.window_s


def key(span_name: str) -> str:
    """A span's name as the metrics name it: ``speedy.day.fetch`` ->
    ``fetch``, ``speedy.call.run_days`` -> ``call``."""
    group, _, rest = span_name[len(PREFIX):].partition(".")
    return "call" if group == "call" else rest


def counted(log: Log, name: str, t0: float, t1: float) -> int:
    """The sum of counter ``name``'s events stamped within [t0, t1]."""
    return sum(e[5] for e in log.events
               if e[3] < 0 and e[0] == name and t0 <= e[1] <= t1)


def self_seconds(log: Log, t0: float, t1: float) -> Dict[str, float]:
    """Self seconds (duration less child spans') of the spans that lie
    within [t0, t1], summed by span name."""
    inside = [e for e in log.spans() if t0 <= e[1] and e[2] <= t1]
    child = {}
    for e in inside:
        child[e[4]] = child.get(e[4], 0.0) + e[2] - e[1]
    out: Dict[str, float] = {}
    for e in inside:
        out[e[0]] = out.get(e[0], 0.0) + e[2] - e[1] - child.get(e[3], 0.0)
    return out


def stepped_seconds(log: Log, span: str, counter: str, t0: float,
                    t1: float) -> Tuple[float, float]:
    """(own, blocked) host seconds of the spans named ``span`` that lie
    within [t0, t1], where the program counts ``counter`` once after each
    step of the span's work. A step runs from the span's start or the step
    before to its event. A step whose launches find the launch queue full
    waits there for the device work ahead of it, so the host's own time is
    the steps times the median step of the window, and the rest of the
    spans' time is ``blocked``. A span with no such events is own time."""
    marks = sorted(e[1] for e in log.events
                   if e[3] < 0 and e[0] == counter and t0 <= e[1] <= t1)
    steps, total, plain = [], 0.0, 0.0
    for e in log.spans():
        if e[0] != span or e[1] < t0 or e[2] > t1:
            continue
        total += e[2] - e[1]
        inner = marks[bisect.bisect_left(marks, e[1]):
                      bisect.bisect_right(marks, e[2])]
        if not inner:
            plain += e[2] - e[1]
        steps += [b - a for a, b in zip([e[1]] + inner, inner)]
    if not steps:
        return plain, 0.0
    steps.sort()
    median = steps[len(steps) // 2] if len(steps) % 2 else \
        0.5 * (steps[len(steps) // 2 - 1] + steps[len(steps) // 2])
    own = plain + len(steps) * median
    return own, max(total - own, 0.0)


def outermost_seconds(log: Log, t_end: float) -> Dict[str, float]:
    """Seconds of the spans that ended by ``t_end`` and lie inside no span
    of their own name, summed by name."""
    by_seq = {e[3]: e for e in log.spans()}
    out: Dict[str, float] = {}
    for e in by_seq.values():
        if e[2] > t_end:
            continue
        p = by_seq.get(e[4])
        while p is not None and p[0] != e[0]:
            p = by_seq.get(p[4])
        if p is None:
            out[e[0]] = out.get(e[0], 0.0) + e[2] - e[1]
    return out


def _anchor(run):
    """(host seconds of the sub-window's start and end, µs to add to a
    host stamp x 1e6 to put it on the trace's clock), or None."""
    marks = [s for s in run.trace.spans if s.name == ANCHOR]
    ends = run.spans.stamps.get("chunk")
    if not marks or not ends:
        return None
    end = ends[-1]
    start = end - run.spans.done["chunk"][-1]
    return start, end, marks[-1].end_us - end * 1e6


def _subtract(a: float, b: float, cuts: List[Tuple[float, float]]):
    """[a, b) less the sorted, disjoint intervals ``cuts``."""
    out, x = [], a
    for s, e in cuts:
        if e <= x or s >= b:
            continue
        if s > x:
            out.append((x, s))
        x = max(x, e)
    if x < b:
        out.append((x, b))
    return out


def idle_us(run, log: Log) -> Optional[Dict[str, float]]:
    """Device idle µs of the profiled sub-window by the innermost program
    span open at each idle instant (``key``), and ``outside``. The
    sub-window runs from the anchor's start to its end or the last
    kernel's, whichever is later. None without a trace, an anchor, or a
    whole ring over the sub-window."""
    if run.trace is None or not run.trace.kernels:
        return None
    anchor = _anchor(run)
    if anchor is None:
        return None
    h0, h1, off = anchor
    if not log.whole_since(h0):
        return None
    mark = [s for s in run.trace.spans if s.name == ANCHOR][-1]
    busy = busy_intervals(run.trace.kernels)
    lo, hi = mark.start_us, max(mark.end_us, busy[-1][1])
    idle = _subtract(lo, hi, busy)
    starts = [s for s, _ in idle]

    def idle_in(a: float, b: float) -> float:
        """Idle µs within [a, b)."""
        if b <= a:
            return 0.0
        total = 0.0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(idle) and idle[i][0] < b:
            s, e = idle[i]
            total += max(0.0, min(e, b) - max(s, a))
            i += 1
        return total

    to_us = lambda t: t * 1e6 + off
    spans = [e for e in log.spans() if e[2] >= h0 and e[1] <= h1]
    children: Dict[int, List[Tuple[float, float]]] = {}
    for e in spans:
        children.setdefault(e[4], []).append((to_us(e[1]), to_us(e[2])))
    out: Dict[str, float] = {"outside": 0.0}
    for e in spans:
        a, b = max(to_us(e[1]), lo), min(to_us(e[2]), hi)
        own = _subtract(a, b, sorted(children.get(e[3], [])))
        k = key(e[0])
        out[k] = out.get(k, 0.0) + sum(idle_in(s, t) for s, t in own)
    out["outside"] = sum(e - s for s, e in idle) - sum(out.values())
    return out
