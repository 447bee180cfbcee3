"""host_ms: host milliseconds a simulated day of one of the program's day
spans (speedy_tpu_torch/utils/tracing.py), ``host_ms.<name>.<cell>`` for
``speedy.day.<name>``: the self time (duration less its child spans') of
those spans inside the unprofiled window, over its simulated days; host
clock. The SPPT draws (``draw``) give the host's own time: the program
counts ``sppt.draw_launches`` after each step's draws, and a step that
waited on a full launch queue behind the day before is left out at the
median step's time (program_spans.stepped_seconds); that wait moves with
the device's time a day, not with the draws. None where the ring dropped
events of the window."""
from benchmark import program_spans

STEPPED = {"draw": "sppt.draw_launches"}


def read(run, name):
    log = program_spans.program_log()
    t0, t1 = program_spans.window(run)
    if log is None or not run.window_days or not log.whole_since(t0):
        return None
    part = name.split(".")[1]
    span = program_spans.PREFIX + "day." + part
    if part in STEPPED:
        seconds = program_spans.stepped_seconds(log, span, STEPPED[part],
                                                t0, t1)[0]
    else:
        seconds = program_spans.self_seconds(log, t0, t1).get(span, 0.0)
    return seconds / run.window_days * 1e3
