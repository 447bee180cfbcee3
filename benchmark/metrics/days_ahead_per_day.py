"""days_ahead_per_day: the simulated days ``Model.run`` enqueued while the
day before still had its guard and writer calls to run, a simulated day:
the program's ``run.days_ahead`` counter events
(speedy_tpu_torch/utils/tracing.py) inside the unprofiled window, over its
simulated days. None where the ring dropped events of the window, and
where the program never counted it (one that runs each day in series)."""
from benchmark import program_spans

COUNTER = "run.days_ahead"


def read(run, name):
    log = program_spans.program_log()
    t0, t1 = program_spans.window(run)
    if log is None or not run.window_days or not log.whole_since(t0) \
            or not any(e[0] == COUNTER for e in log.events):
        return None
    return program_spans.counted(log, COUNTER, t0, t1) / run.window_days
