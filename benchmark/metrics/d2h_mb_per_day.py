"""d2h_mb_per_day: megabytes (10^6 bytes) the program's staged days copy
to the host a simulated day: its ``d2h.bytes`` counter events
(speedy_tpu_torch/utils/tracing.py, counted at each host copy of a
captured day) inside the unprofiled window, over its simulated days. None
where the ring dropped events of the window."""
from benchmark import program_spans


def read(run, name):
    log = program_spans.program_log()
    t0, t1 = program_spans.window(run)
    if log is None or not run.window_days or not log.whole_since(t0):
        return None
    return program_spans.counted(log, "d2h.bytes", t0, t1) \
        / run.window_days * 1e-6
