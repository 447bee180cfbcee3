"""The program's own spans and counters, always on.

A span is a named interval of the host clock around work the program does
at call, day or chunk level (never per step or per member)::

    with tracing.span("day.fetch"):
        ...

records ``speedy.day.fetch`` with its start, its end and its parent, the
program span open around it on the same thread (spans are opened only on
the thread that drives the model). A counter adds to a cumulative
registry, ``tracing.counters`` (a ``Counter``: a name never counted reads
0)::

    tracing.count("d2h.bytes", n)

and both append an event to one bounded ring, so a reader can take spans
and counts over a window of its own. The clock is ``time.perf_counter``.
The ring keeps the newest ``RING`` events; ``Ring.lost_until`` is the
latest end among those it dropped, so a reader of a window that began
later knows it is whole (``Tracer.whole_since``).

A CUDA graph's replay runs no Python, so what the body counted while it
was captured is taken out of the registry and the ring (``recorded``) and
added back at each replay (``replay``): the counters count what ran.

Nothing here opens a profiler range: a trace's reader would count its
device-side counterpart as device work. The counters kept: ``k1.launches``,
``k1.launches_sw``, ``k1.launches_reflw``, ``k1.launches_reflw_sw``
(models/physics/fused.py), ``k2.launches_syn``, ``k2.launches_ana``
(ops/fused_transforms.py), ``spectral.allreduces`` (ops/spectral.py),
``d2h.bytes`` (a staged day's host copies), ``sppt.draw_launches`` (the
``normal_`` calls of the SPPT draws, an event a step) and
``graph.captures``.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
import time
from collections import Counter, deque
from typing import Dict, Iterator, List, NamedTuple

PREFIX = "speedy."
RING = 1 << 17      # events kept: any benchmark window's several times over


class Event(NamedTuple):
    """A span (``n`` 0: ``seq`` its id, ``parent`` the enclosing span's id
    or -1) or a count (``n`` added; ``start`` == ``end``, ``seq`` -1)."""
    name: str
    start: float
    end: float
    seq: int
    parent: int
    n: int


class Ring:
    """The newest ``size`` events, oldest first; ``dropped`` counts the
    events it let go and ``lost_until`` is the latest end among them."""

    def __init__(self, size: int = RING):
        self.events: deque = deque(maxlen=size)
        self.dropped = 0
        self.lost_until = -math.inf

    def append(self, ev: Event) -> None:
        if len(self.events) == self.events.maxlen:
            old = self.events[0]
            self.dropped += 1
            self.lost_until = max(self.lost_until, old.end)
        self.events.append(ev)


class Tracer:
    """Spans, counters and their ring (the module keeps one, ``TRACER``),
    stamped by ``clock``."""

    def __init__(self, size: int = RING, clock=time.perf_counter):
        self.clock = clock
        self.ring = Ring(size)
        self.counters: Counter = Counter()
        self._ids = itertools.count()
        self._local = threading.local()

    def _stack(self) -> List[int]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        """Record ``PREFIX + name`` around the block."""
        stack = self._stack()
        seq = next(self._ids)
        parent = stack[-1] if stack else -1
        stack.append(seq)
        t0 = self.clock()
        try:
            yield
        finally:
            t1 = self.clock()
            stack.pop()
            self.ring.append(Event(PREFIX + name, t0, t1, seq, parent, 0))

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` and log it."""
        self.counters[name] += n
        t = self.clock()
        self.ring.append(Event(name, t, t, -1, -1, n))

    def reset(self) -> None:
        """Zero every counter (the ring keeps its events)."""
        self.counters.clear()

    @contextlib.contextmanager
    def recorded(self) -> Iterator[Counter]:
        """Yields a ``Counter`` that holds, after the block, what the block
        counted (a counter it never touched reads 0); the registry is left
        as it was before the block, and the events the block appended are
        taken out of the ring (the capture of a graph, whose replays
        ``replay`` counts)."""
        before = dict(self.counters)
        mark = len(self.ring.events), self.ring.dropped
        delta: Counter = Counter()
        try:
            yield delta
        finally:
            for k, v in self.counters.items():
                if v != before.get(k, 0):
                    delta[k] = v - before.get(k, 0)
            self.counters.clear()
            self.counters.update(before)
            added = len(self.ring.events) - mark[0] + self.ring.dropped \
                - mark[1]
            for _ in range(min(added, len(self.ring.events))):
                self.ring.events.pop()

    def replay(self, delta: Dict[str, int]) -> None:
        """Count a recorded block's ``delta`` once more."""
        for k, n in delta.items():
            self.count(k, n)

    def events(self) -> List[Event]:
        """The ring's events, oldest first."""
        return list(self.ring.events)

    def whole_since(self, t: float) -> bool:
        """Whether the ring holds every event that ended at ``t`` or
        later."""
        return self.ring.lost_until < t


TRACER = Tracer()
span = TRACER.span
count = TRACER.count
counters = TRACER.counters
reset = TRACER.reset
recorded = TRACER.recorded
replay = TRACER.replay
events = TRACER.events
whole_since = TRACER.whole_since
