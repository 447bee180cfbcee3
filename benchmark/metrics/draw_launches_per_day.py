"""draw_launches_per_day: the SPPT draws' ``normal_`` calls the host
enqueues a simulated day: the program's ``sppt.draw_launches`` counter
events (speedy_tpu_torch/utils/tracing.py) inside the unprofiled window,
over its simulated days. None where the ring dropped events of the
window."""
from benchmark import program_spans


def read(run, name):
    log = program_spans.program_log()
    t0, t1 = program_spans.window(run)
    if log is None or not run.window_days or not log.whole_since(t0):
        return None
    return program_spans.counted(log, "sppt.draw_launches", t0, t1) \
        / run.window_days
