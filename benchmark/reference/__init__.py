"""The plain reference of the benchmark: SPEEDY's spectral dynamics, column
physics and slab coupling in plain PyTorch, eagerly, step by step, with no
compiled kernel and no captured graph.

It is a frozen copy of the modules of ``speedy_tpu_torch`` that one model
day is made of, taken at commit 8f72ba0 (``models/physics/fused.py``
reduced to the plain chain, ``ops/spectral.py`` without the latitude-band
all-reduce, ``models/model.py`` without the run drivers), kept here so that
later changes to the program cannot move the yardstick. It imports nothing
of the program, nor JAX, and builds every table from the configuration and
the boundary arrays it is given.

It is the reference of every configuration whose file has no
``reference`` key. A configuration of another model names its own: a
package ``<dir>`` under the benchmark's directory (``"reference":
"<dir>"``), which gives the check (check.py) and the counts (counts.py)
what this package gives them at its top level:

- ``ModelConfig(**fields)``: the configuration file's ``model`` fields
  with the cell's overrides, and ``precision`` ("fp64", or "fp32" for the
  control) and ``sppt_draws`` (the type the configuration states);
- ``ReferenceModel(cfg, device, boundaries)``, the boundaries being the
  benchmark's stand-in set (``inputs.boundaries``, which a reference may
  ignore), with ``cfg``, ``device``, ``initial_state(date)`` (the state
  before the boot), ``initialize(date)`` (after it), ``run_day(state,
  date, run_start, steps)`` (the states after the day's first ``steps``
  steps, and the state at its end) and ``gridded_fields(prog)`` (the
  output fields by name, ``u v t q phi ps``, of a state's ``prog``);
  a state holds its leaves in named groups (``prog``, and any of
  ``surf``, ``rad``, ``sppt``), each a named tuple of tensors; ``sppt``
  is the reference's own SPPT state (None without SPPT), and the check
  takes the booted state's where the members' seeds are not given;
- ``to_state(model, arrays, sppt=None)``: the model's state, in its type
  and on its device, from ``check.arrays`` of the program's state, with
  the reference's own SPPT state ``sppt``;
- ``sppt_start(model, seeds)``: the stacked stationary SPPT states of the
  members' seeds (only for a configuration whose cells run SPPT);
- ``Datetime(year, month, day, hour, minute)``: the date type;
- ``load_checkpoint(path, template)``: a checkpoint the program wrote,
  read back in the shape of the state ``template``: a tuple whose first
  item is the state;
- ``transform_tables(trunc, ix, il, kx)``: the spectral transforms' tables
  (``syn`` and ``ana``: the Legendre table and the zonal DFT), whose
  nonzero entries the counts count.

Here ``to_state``, ``sppt_start`` and ``transform_tables`` are defined and
the rest re-exported, each module imported at its first use, so that the
boundary set (``utils/synthetic_bc.py``) loads nothing more.
"""
from __future__ import annotations


def __getattr__(name):
    if name == "ModelConfig":
        from .config import ModelConfig
        return ModelConfig
    if name == "ReferenceModel":
        from .models.model import ReferenceModel
        return ReferenceModel
    if name == "Datetime":
        from .utils.calendar import Datetime
        return Datetime
    if name == "load_checkpoint":
        from .utils.checkpoint import load_checkpoint
        return load_checkpoint
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def to_state(model, a, sppt=None):
    """The reference's ModelState from ``check.arrays`` output, in the
    model's type and on its device, with the SPPT state ``sppt`` (the
    reference's own)."""
    from .models.model import ModelState
    from .models.physics import SurfaceState
    from .models.physics.shortwave import RadiationState
    from .models.state import PrognosticState
    dev, dtype = model.device, model.cfg.rdtype
    get = lambda g, t: t(**{f: a[f"{g}.{f}"].to(dev, dtype)
                            for f in t._fields})
    return ModelState(prog=get("prog", PrognosticState),
                      surf=get("surf", SurfaceState),
                      rad=get("rad", RadiationState), sppt=sppt)


def sppt_start(model, seeds):
    """The members' stationary SPPT states from their seeds, stacked."""
    from .models.physics.sppt import init_sppt_state, stack_states
    return stack_states([init_sppt_state(model.cfg, model.pp.sppt_sigma, s)
                         for s in seeds])


def transform_tables(trunc: int, ix: int, il: int, kx: int):
    """The synthesis and analysis tables (Legendre, zonal DFT), float64.
    The levels do not enter them: the latitudes are built at a level count
    that the sigma tables hold, so that no ``kx`` reaches those tables."""
    import dataclasses
    from .config import ModelConfig
    from .geometry import build_geometry_np
    from .ops.spectral import build_spectral_np
    cfg = ModelConfig(trunc=trunc, ix=ix, il=il, kx=kx, precision="fp64")
    t = build_spectral_np(cfg, build_geometry_np(
        dataclasses.replace(cfg, kx=8)))
    return dict(syn=(t["cpol_inv"], t["dft_syn"]),
                ana=(t["cpol_dir"], t["dft_ana"]))
