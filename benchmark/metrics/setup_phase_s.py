"""setup_phase_s: seconds of one phase of set-up by the program's own
span (speedy_tpu_torch/utils/tracing.py), of the spans that ended before
the window began, outermost spans only: ``tables`` (``setup.tables``,
``Model.__init__``), ``boot`` (``setup.boot``, ``Model.initialize`` or
``Ensemble.initialize``), ``warmup`` (``capture.warmup``, the eager
warm-up day before a capture) and ``graph`` (``capture.graph``, the CUDA
graph capture); host clock. None where the ring has dropped any event
(set-up's are its oldest)."""
from benchmark import program_spans

SPANS = {"tables": "setup.tables", "boot": "setup.boot",
         "warmup": "capture.warmup", "graph": "capture.graph"}


def read(run, name):
    log = program_spans.program_log()
    if log is None or log.lost_until > float("-inf"):
        return None
    done = program_spans.outermost_seconds(log, run.window_start)
    return done.get(program_spans.PREFIX + SPANS[name.split(".")[1]])
