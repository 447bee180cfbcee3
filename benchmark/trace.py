"""Reading a torch.profiler trace of the profiled sub-window: the kernel
table (frozen from ``bench_step.trace`` of speedy_tpu_torch at commit
8f72ba0: every CUDA event of ``prof.events()`` with its device time), the
union of the kernels' intervals, the idle gaps between them named by what
the host was doing, and the frozen name patterns that sort kernels into the
program's layers.

Unlike ``bench_step.device_profile``, nothing here divides by the profiled
wall: the profiler stretches a day 1.4-2x, so shares of time divide by the
unprofiled wall of the same work (the metric readers do).
"""
from __future__ import annotations

import re
import time
from typing import Dict, List, NamedTuple, Tuple

# kernel classes by name, first match wins; the patterns are frozen so
# that a class counts the same kernels whatever a later change calls them
CLASSES = (
    ("k1", re.compile(r"column_physics")),
    ("transform", re.compile(r"gemm|cutlass|xmma|synthesis_kernel|"
                             r"analysis_kernel", re.I)),
    ("rng", re.compile(r"distribution_|philox|curand|normal_kernel|"
                       r"randn", re.I)),
    ("elementwise", re.compile(r"elementwise_kernel|CatArrayBatchedCopy|"
                               r"CatArray|copy_kernel")),
)


class Kernel(NamedTuple):
    name: str
    start_us: float
    dur_us: float


class Span(NamedTuple):
    name: str
    start_us: float
    end_us: float


class Trace(NamedTuple):
    wall_s: float            # the profiled sub-window, host clock
    kernels: List[Kernel]    # every device operation, in start order
    spans: List[Span]        # host events (operators, runtime calls, spans)


def launches(kernels: List[Kernel]) -> int:
    """The kernels among the device operations (copies and sets left
    out)."""
    return sum(1 for k in kernels if not k.name.startswith(COPIES))


def kernel_class(name: str) -> str:
    for cls, pat in CLASSES:
        if pat.search(name):
            return cls
    return "other"


COPIES = ("Memcpy", "Memset")


def profile(fn, prefix: str = "bench.") -> Trace:
    """One call of ``fn`` under torch.profiler, ending in a synchronise:
    its wall seconds, its device operations (kernels, copies and sets; not
    the device-side ranges of the benchmark's own spans, named
    ``prefix``...) and its host events."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, host = [], []
    for e in prof.events():
        r = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name.startswith(prefix):
                continue
            kernels.append(Kernel(e.name, float(r.start),
                                  float(r.elapsed_us())))
        else:
            host.append(Span(e.name, float(r.start), float(r.end)))
    kernels.sort(key=lambda k: k.start_us)
    return Trace(wall, kernels, host)


def busy_intervals(kernels: List[Kernel]) -> List[Tuple[float, float]]:
    """The union of the kernels' intervals, merged, in µs."""
    out: List[List[float]] = []
    for k in kernels:
        s, e = k.start_us, k.start_us + k.dur_us
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(kernels: List[Kernel]) -> float:
    return sum(e - s for s, e in busy_intervals(kernels))


def device_us_by_class(kernels: List[Kernel]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for k in kernels:
        c = kernel_class(k.name)
        out[c] = out.get(c, 0.0) + k.dur_us
    return out


def top_kernels(kernels: List[Kernel], n: int = 10, width: int = 160):
    """[[name, device seconds]] of the ``n`` kernel names that took most
    device time (names cut to ``width`` characters)."""
    by: Dict[str, float] = {}
    for k in kernels:
        by[k.name] = by.get(k.name, 0.0) + k.dur_us
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:width], us * 1e-6] for name, us in top]


def idle_gaps(trace: Trace, n: int = 10, prefix: str = "bench."):
    """[[what the host was in, seconds]] of the ``n`` longest gaps between
    busy intervals: the benchmark span (``prefix``) open at the gap's
    start and the innermost host event open there, the innermost of each
    kind."""
    busy = busy_intervals(trace.kernels)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:n]:
        open_ = [h for h in trace.spans if h.start_us <= s < h.end_us]
        dur = lambda h: h.end_us - h.start_us
        ours = [h for h in open_ if h.name.startswith(prefix)]
        theirs = [h for h in open_ if not h.name.startswith(prefix)]
        name = min(ours, key=dur).name[len(prefix):] if ours else "outside"
        if theirs:
            name += "/" + min(theirs, key=dur).name[:80]
        out.append([name, (e - s) * 1e-6])
    return out
