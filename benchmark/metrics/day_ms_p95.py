"""day_ms_p95: the 95th percentile of the wall time of every simulated day
of the window, each from one day-end writer call to the next (a day ends
in a device-to-host copy, so the stamps are synchronised), host clock."""
from benchmark.harness import quantile


def read(run, name):
    days = run.day_seconds()
    return quantile(days, 95) * 1e3 if days else None
