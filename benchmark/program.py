"""What the drivers share: the program's model built from a cell, and the
calendar arithmetic of its entry points. Every import of the program
(``speedy_tpu_torch``) happens inside these functions, at run time."""
from __future__ import annotations

from .inputs import boundaries, date_tuple, perturb_temperature


def build_model(run):
    """The program's Model of the cell's configuration on the run's
    device, with the benchmark's boundary arrays."""
    from speedy_tpu_torch.config import ModelConfig
    from speedy_tpu_torch.models.model import Model
    cfg = ModelConfig(**run.cell.model_config).validate()
    return Model(cfg, device=run.device,
                 bc_arrays=boundaries(run.cell.config["boundaries_seed"]))


def start_date(run):
    from speedy_tpu_torch.utils.calendar import Datetime
    return Datetime(*date_tuple(run.cell.params["start"]))


def add_days(date, n: int, nsteps: int):
    """``date`` advanced ``n`` days by the program's calendar."""
    from speedy_tpu_torch.utils.calendar import newdate
    for _ in range(n * nsteps):
        date = newdate(date, nsteps)
    return date


def perturb(run, state):
    """The booted ``state`` with the cell's seeded temperature
    perturbation added (inputs.perturb_temperature), in place."""
    p = run.cell.params["perturbation"]
    perturb_temperature(state.prog.t, run.seed, p["amplitude"],
                        p["max_wavenumber"])
    return state


def built_libraries() -> bool:
    """Whether this process compiled any of the program's native
    libraries (its first run in a checkout)."""
    try:
        from speedy_tpu_torch.utils import native
    except ImportError:
        return False
    return bool(getattr(native, "build_seconds", {}))


def _noop_writer(step, date, start, fields):
    pass


def output_day(model, state, date, steps: int, ensemble=None):
    """The day from ``state`` as the output day computes it, through
    ``Model.run`` with a writer, or ``Ensemble.run_days`` with writers;
    the given state is left as it was. Returns its end state (``arrays``)
    and the gridded fields after each of its first ``steps`` steps (u, v,
    t, q, phi [..., kx, il, ix], ps [..., il, ix], float64), from the
    day's buffer of every step's fields, fetched once a day."""
    from .check import arrays
    if ensemble is None:
        end = add_days(date, 1, model.cfg.nsteps)
        out = model.run(date, end, output_writer=_noop_writer,
                        verbose=False, state=state)
    else:
        out, _ = ensemble.run_days(
            state, date, 1, output_writers=[_noop_writer] * ensemble.n_local)
    return arrays(out), buffered_steps(model, state, steps)


def buffered_steps(model, state, steps: int):
    """The first ``steps`` steps' fields of the last output day run for
    states shaped like ``state``, from its buffer (float64 tensors)."""
    import torch
    from .check import FIELDS
    if not steps:
        return []
    day = model.captured_day(state, collect_output=True,
                             grids=True).outputs()
    return [{k: torch.from_numpy(day[k][i].astype("float64"))
             for k in FIELDS} for i in range(steps)]
