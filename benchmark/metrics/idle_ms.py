"""idle_ms: device-idle milliseconds a profiled day, by the program span
the host was in (speedy_tpu_torch/utils/tracing.py): ``idle_ms.<name>.
<cell>``. Each idle instant between the kernels of the profiled
sub-window (from the harness's ``chunk`` span's start to its end or the
last kernel's end) goes to the innermost program span open then,
``<name>`` as ``program_spans.key`` gives it (``day.fetch`` -> ``fetch``,
any ``call.*`` -> ``call``), or to ``outside`` where none is open; the
spans reach the trace's clock through the ``chunk`` span, in both records
(program_spans.py). A cell's ``idle_ms.*`` sum to the sub-window's idle
time a profiled day. None where the ring dropped events of the
sub-window."""
from benchmark import program_spans


def read(run, name):
    log = program_spans.program_log()
    if log is None or not run.profile_days:
        return None
    idle = program_spans.idle_us(run, log)
    if idle is None:
        return None
    return idle.get(name.split(".")[1], 0.0) * 1e-3 / run.profile_days
