"""sppt_draw_us_per_step: device µs a step of the random-number kernels
(the SPPT innovations drawn ahead; trace.CLASSES) in the profiled
sub-window."""
from benchmark.trace import device_us_by_class


def read(run, name):
    if run.trace is None:
        return None
    us = device_us_by_class(run.trace.kernels).get("rng")
    return None if not us else us / (run.profile_days * run.nsteps)
