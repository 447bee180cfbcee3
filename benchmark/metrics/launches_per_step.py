"""launches_per_step: kernels in the profiled sub-window (device copies
and sets left out) over its steps."""
from benchmark.trace import launches


def read(run, name):
    if run.trace is None:
        return None
    n = launches(run.trace.kernels)
    return n / (run.profile_days * run.nsteps) if n else None
