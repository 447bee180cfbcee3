"""idle_share: the share of the wall in which no kernel runs, 1 - (the
union of the kernels' intervals a day in the profiled sub-window) / (the
unprofiled wall a day of the window), in %. The profiler stretches the
host's side of a day, not the kernels, so the unprofiled wall is the
denominator."""
from benchmark.trace import busy_us


def read(run, name):
    if run.trace is None or not run.trace.kernels:
        return None
    busy_per_day = busy_us(run.trace.kernels) * 1e-6 / run.profile_days
    return 100.0 * (1.0 - busy_per_day / run.wall_per_day_s)
