"""k1_roofline: the column-physics kernel's share of its roofline, in %:
the least time of the sub-window's steps (counts.k1_least_s, SW on the
first step of each ``nstrad``, the rest without, over all the members'
columns) over the device time of the ``column_physics`` kernels in the
profiled sub-window."""
from benchmark.counts import k1_least_s
from benchmark.trace import device_us_by_class


def read(run, name):
    if run.trace is None:
        return None
    us = device_us_by_class(run.trace.kernels).get("k1")
    if not us:
        return None
    shapes = run.shapes
    steps = run.profile_days * run.nsteps
    sw = steps // int(shapes.get("nstrad", 3))
    precision = shapes.get("precision", "fp32")
    least = sw * k1_least_s(shapes, True, run.members, precision) \
        + (steps - sw) * k1_least_s(shapes, False, run.members, precision)
    return 100.0 * least / (us * 1e-6)
