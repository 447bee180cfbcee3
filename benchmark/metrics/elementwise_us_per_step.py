"""elementwise_us_per_step: device µs a step of PyTorch's elementwise,
strided-copy and cat kernels (trace.CLASSES, frozen name patterns) in the
profiled sub-window."""
from benchmark.trace import device_us_by_class


def read(run, name):
    if run.trace is None:
        return None
    us = device_us_by_class(run.trace.kernels).get("elementwise")
    return None if not us else us / (run.profile_days * run.nsteps)
