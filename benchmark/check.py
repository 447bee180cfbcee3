"""The comparison that decides ``correct``.

A SPEEDY day is chaotic at the scale of single columns: a rounding
difference that tips a threshold (convection, condensation, the longwave
band of a temperature) moves a column by a finite amount, and within a
day such differences spread. After tens of days two computations that
differ only in rounding no longer agree point by point, and from a
spun-up state one day is already enough to make a float32 run and one
with TF32 matrix products differ from a float64 reference alike (PERF.md).
So the reference does not follow the window.
Once the window has closed, the driver runs the first day once more
through the cell's timed entry (the captured day the window replayed, at
its sizes and member count), from the perturbed booted state the window
started from, and the reference (float64, eagerly, step by step) runs
that day from the same state. The reference is the configuration's: the
package its file names (``"reference": "<dir>"``, found by name under the
benchmark's directory as drivers and metrics are), or ``reference/``,
SPEEDY's frozen plain day, where it names none (``harness.Cell.reference``);
``reference/__init__.py`` says what such a package gives. The start, which
this follows from, is checked on its own: the program's boot against the
reference's from the same inputs. What is compared:

- ``boot``: the booted prognostic state (of one member in an ensemble);
- ``step<n>``: the gridded fields after each of the day's first steps, as
  the output day computes them into its buffer (``Model.run`` with a
  writer, ``Ensemble.run_days`` with writers): the steps with and without
  the shortwave, and the slab coupling of each step in the next one's
  fields;
- ``day``: the day's end state, leaf by leaf (``day.lp``: its prognostic
  scales up to total wavenumber LOW_PASS);
- ``fast``: where the timed entry is the fast day (no output), its end
  state against the output day's from the same start (the same kernels:
  the day's end is bit-equal), so that what the steps judge holds the
  variant the window replays;
- ``ckpt``: where the entry writes a checkpoint, the checkpoint read back
  against the entry's end state in memory;
- ``nc0``, ``nc``: the fields the writer was given at step 0 and at the
  day's end, read back from the files written.

Each number is a relative error of an increment: for a leaf of the state,
||program end - reference end|| / ||reference end - start|| (the 2-norm
over the leaf, for an ensemble over each member's slice, the worst member
kept), the worst leaf of a group kept. A 2-norm, not a largest value: a
tipped threshold moves one column by a finite amount whatever the
precision, while the norm grows with the number of columns tipped, which
the precision sets.

With SPPT the reference draws the innovations itself, from generators
seeded as the program seeds them (the members' seeds, and the model's for
the boot), in the type the configuration states: the same seeds give the
same draws, so the steps hold the program's draws too.

``control``: the reference in the program's place, in float32 with TF32
matrix products (the precision below the configuration's float32 with TF32
off), from the same start; the limits lie between the program's readings
and the control's (PERF.md).
"""
from __future__ import annotations

import math
import re
from typing import Dict, Tuple

import numpy as np
import torch

from .inputs import boundaries, date_tuple

GROUPS = ("prog", "surf", "rad", "sppt")
LOW_PASS = 2     # total wavenumber up to which ``day.lp`` keeps scales
FIELDS = ("u", "v", "t", "q", "phi", "ps")
# the fields but humidity, whose increment a tipped condensation or
# convection threshold moves by a finite amount from the second step on
DRY = ("u", "v", "t", "phi", "ps")
STEP = re.compile(r"step(\d+)(\.|$)")
_models: Dict[tuple, object] = {}


def _date(run, t):
    return run.cell.reference.Datetime(*t)


def _start(run):
    return _date(run, date_tuple(run.cell.params["start"]))


def reference_model(run, precision: str = "fp64"):
    """The reference model of the run's configuration on its device, from
    the boundary arrays the benchmark gives the program: float64, or the
    control's (``tf32``: float32, its matrix products in TF32)."""
    dtype = "fp32" if precision == "tf32" else precision
    key = (id(run), dtype)
    if key not in _models:
        pkg = run.cell.reference
        stated = run.cell.model_config.get("precision", "fp32")
        kw = dict(run.cell.model_config, precision=dtype,
                  sppt_draws=stated)
        _models[key] = pkg.ReferenceModel(
            pkg.ModelConfig(**kw), run.device,
            boundaries(run.cell.config["boundaries_seed"]))
    return _models[key]


class _TF32:
    """TF32 matrix products on or off for a block (on for the control)."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.old


def arrays(state) -> Dict[str, torch.Tensor]:
    """A ModelState's tensors by ``group.field``, float64 copies."""
    out = {}
    for group in GROUPS:
        g = getattr(state, group, None)
        if g is None:
            continue
        for f in g._fields:
            x = getattr(g, f)
            if isinstance(x, torch.Tensor):
                out[f"{group}.{f}"] = x.detach().to(torch.float64).clone()
    return out


def to_state(run, a: Dict[str, torch.Tensor], sppt=None,
             precision: str = "fp64"):
    """The reference's state from ``arrays``, in the type and on the
    device of its model in ``precision``, with the SPPT state ``sppt``
    (the reference's own)."""
    return run.cell.reference.to_state(reference_model(run, precision), a,
                                       sppt)


def asked(run) -> Tuple[int, bool]:
    """What the cell's limits ask of the check day: how many of its first
    steps are compared (the largest n of a ``step<n>`` or ``step<n>.*``
    limit) and whether the end state of the entry's other path is (a
    ``fast`` limit). The run's ``check_steps`` and ``check_other``, where
    set, ask for more (the readings of ``control.py``)."""
    limits = run.cell.params["check"]
    steps = max([int(m.group(1)) for m in map(STEP.match, limits) if m]
                + [run.check_steps])
    other = "fast" in limits or run.check_other
    return steps, other


def increment_error(p_end: torch.Tensor, r_end: torch.Tensor,
                    start: torch.Tensor, members: bool) -> float:
    """||p_end - r_end|| / ||r_end - start||, over each member's slice
    with ``members`` (the worst member); where the reference leaves the
    leaf as it was, relative to ||r_end||; 0 where both are 0."""
    dims = tuple(range(1 if members else 0, r_end.dim())) or None
    norm = lambda x: torch.linalg.vector_norm(x.double(), dim=dims)
    dev = r_end.device
    num = norm(p_end.to(dev) - r_end)
    den = norm(r_end - start.to(dev))
    den = torch.where(den > 1e-12 * norm(r_end), den, norm(r_end))
    err = torch.where(den > 0, num / den, torch.where(
        num > 0, torch.full_like(num, math.inf), torch.zeros_like(num)))
    return float(err.max())


def leaf_errors(p: Dict[str, torch.Tensor], r: Dict[str, torch.Tensor],
                s: Dict[str, torch.Tensor], members: bool,
                prefix: str) -> Dict[str, float]:
    """The increment error of each of the reference's leaves
    (``<prefix>.<group>.<field>``) and the worst of each group
    (``<prefix>.<group>``); a leaf the candidate lacks, or has in another
    shape, reads infinite."""
    out: Dict[str, float] = {}
    for k in r:
        ok = k in p and tuple(p[k].shape) == tuple(r[k].shape)
        e = increment_error(p[k], r[k], s[k], members) if ok else math.inf
        g = f"{prefix}.{k.split('.')[0]}"
        out[f"{prefix}.{k}"] = e
        out[g] = max(out.get(g, 0.0), e)
    return out


def booted(run, precision: str = "fp64"):
    """The reference's booted state from the benchmark's inputs."""
    ref = reference_model(run, precision)
    with torch.no_grad(), _TF32(precision == "tf32"):
        return ref.initialize(_start(run))


def sppt_start(run, pair, precision: str = "fp64"):
    """The reference's own SPPT state at the window's start: the members'
    stationary states from their seeds (``sppt_seeds``), or one model's
    after the reference's boot; None without SPPT."""
    if not run.cell.sppt:
        return None
    seeds = pair.get("sppt_seeds")
    if seeds is None:
        return booted(run, precision).sppt
    return run.cell.reference.sppt_start(reference_model(run, precision),
                                         seeds)


def first_day(run, start: Dict[str, torch.Tensor], pair, steps: int,
              precision: str = "fp64"):
    """The reference's first day from the state ``start`` (arrays), in
    ``precision``: (the states after its first ``steps`` steps, the state
    at its end)."""
    ref = reference_model(run, precision)
    with torch.no_grad(), _TF32(precision == "tf32"):
        state = to_state(run, start, sppt_start(run, pair, precision),
                         precision)
        return ref.run_day(state, _date(run, pair["date"]),
                           _date(run, pair["run_start"]), steps)


def fields(run, state, precision: str = "fp64") -> Dict[str, torch.Tensor]:
    """The gridded output fields of the reference's ``state``, float64."""
    ref = reference_model(run, precision)
    with torch.no_grad(), _TF32(precision == "tf32"):
        return {k: v.double() for k, v in
                ref.gridded_fields(state.prog).items()}


def read_checkpoint(run, path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint's state leaves, read by the reference's own loader."""
    return arrays(run.cell.reference.load_checkpoint(path, booted(run))[0])


def read_netcdf(path: str) -> Dict[str, torch.Tensor]:
    """The six fields of one output file, [kx, il, ix] (ps [il, ix])."""
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        return {k: torch.from_numpy(np.array(f.variables[k][0], np.float64))
                for k in FIELDS}


def field_errors(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                 base: Dict[str, torch.Tensor], prefix: str,
                 members: bool = False) -> Dict[str, float]:
    """Each field's increment error (``<prefix>.<field>``, the worst
    member's with ``members``), the worst (``<prefix>``) and the worst but
    humidity's (``<prefix>.dry``)."""
    out = {}
    for k, r in ref.items():
        ok = k in got and tuple(got[k].shape) == tuple(r.shape)
        out[f"{prefix}.{k}"] = increment_error(
            got[k].to(r.device), r, base[k], members) if ok else math.inf
    out[prefix] = max(out[f"{prefix}.{k}"] for k in ref)
    out[f"{prefix}.dry"] = max(out[f"{prefix}.{k}"] for k in ref
                               if k in DRY)
    return out


def low_pass(x: torch.Tensor, wn: int) -> torch.Tensor:
    """The spectral field ``x`` [..., mx, nx, 2] kept up to total
    wavenumber ``wn``."""
    mx, nx = x.shape[-3:-1]
    m = torch.arange(mx, device=x.device)[:, None]
    n = torch.arange(nx, device=x.device)[None, :]
    return x * ((m + n) <= wn).to(x.dtype)[..., None]


def judged(run, pair, control: bool) -> dict:
    """What is judged: the program's outputs as the pair carries them, or
    with ``control`` the control's, from the same start (the control
    takes the place of the timed entry; the entry's other path, against
    which ``fast`` and ``ckpt`` hold it, stays the program's)."""
    steps = pair.get("steps") or []
    if not control:
        out = dict(boot=pair.get("boot"), end=pair.get("end"), steps=steps)
        if pair["kind"] == "files":
            out["end"] = read_checkpoint(run, pair["checkpoint"])
            out["fields0"] = read_netcdf(pair["fields0_file"])
            out["fields"] = read_netcdf(pair["fields_file"])
        return out
    firsts, end = first_day(run, pair["start"], pair, len(steps), "tf32")
    out = dict(boot=None if pair.get("boot") is None
               else arrays(booted(run, "tf32")), end=arrays(end),
               steps=[fields(run, s, "tf32") for s in firsts])
    if pair["kind"] == "files":
        out["fields0"] = fields(run, to_state(run, pair["start"],
                                              precision="tf32"), "tf32")
        out["fields"] = fields(run, end, "tf32")
    return out


def evaluate(run, pair, control: bool = False) -> Dict[str, float]:
    """Every candidate number of the cell (the module's list), for the
    program, or with ``control`` the control, against the float64
    reference: ``boot.*``; ``step<n>.*`` for each step the pair carries;
    ``day.*`` and ``day.lp`` (from the checkpoint written at the day's end
    where the entry writes one); ``fast.*`` or ``ckpt.*`` where the pair
    carries the other path's end state; ``nc0.*`` (relative to the fields
    themselves: they are the start's, no increment) and ``nc.*`` where the
    entry writes fields."""
    got = judged(run, pair, control)
    numbers: Dict[str, float] = {}
    members = run.members > 1
    if got["boot"] is not None:
        ref = reference_model(run)
        init = arrays(ref.initial_state(_start(run)))
        prog = lambda a: {k: v for k, v in a.items()
                          if k.startswith("prog.")}
        numbers.update(leaf_errors(prog(got["boot"]),
                                   prog(arrays(booted(run))), prog(init),
                                   False, "boot"))
    start = pair["start"]
    firsts, end = first_day(run, start, pair, len(got["steps"]))
    ref_end = arrays(end)
    numbers.update(leaf_errors(got["end"], ref_end, start, members, "day"))
    low = lambda a: {k: low_pass(v, LOW_PASS) for k, v in a.items()
                     if k.startswith("prog.")}
    numbers["day.lp"] = leaf_errors(low(got["end"]), low(ref_end),
                                    low(start), members, "x")["x.prog"]
    f0 = fields(run, to_state(run, start))
    for i, (g, r) in enumerate(zip(got["steps"], firsts)):
        numbers.update(field_errors(g, fields(run, r), f0, f"step{i + 1}",
                                    members))
    other = pair.get("other_end")
    if other is not None:
        name = "ckpt" if pair["kind"] == "files" else "fast"
        errs = leaf_errors(got["end"], other, start, members, name)
        numbers.update(errs)
        numbers[name] = max(v for k, v in errs.items()
                            if k.count(".") == 1)
    if pair["kind"] == "files":
        zero = {k: torch.zeros_like(v) for k, v in f0.items()}
        numbers.update(field_errors(got["fields0"], f0, zero, "nc0"))
        numbers.update(field_errors(got["fields"], fields(run, end), f0,
                                    "nc"))
    _models.clear()
    return numbers
