"""transform_us_per_step: device µs a step of the spectral transforms'
kernels (cuBLAS's and CUTLASS's GEMMs, and the hand-written synthesis and
analysis kernels where the step takes them; trace.CLASSES) in the profiled
sub-window."""
from benchmark.trace import device_us_by_class


def read(run, name):
    if run.trace is None:
        return None
    us = device_us_by_class(run.trace.kernels).get("transform")
    return None if not us else us / (run.profile_days * run.nsteps)
