"""SPPT ensembles: the members' states on a leading axis, advanced together
(the JAX package's speedy_tpu/parallel/ensemble.py, which vmaps the day
over members).

Every leaf of an ensemble state is [M, ...], and one step serves all
members: the transforms batch them into the same contractions and the
column-physics kernel takes them as extra columns of one launch. What
depends only on the date is computed once a day and shared. A day of all
members is one replay of the model's captured day for M members
(models/captured.py), one graph per member count and variant. With SPPT on,
each member has its own generator, seeded ``base_seed + i``, so a member's
trajectory does not depend on how many members run beside it; with SPPT
off every member equals the single model. With SST-anomaly forcing, as in
the JAX package, ``initialize`` sets the model's anomaly window (through
``Model.initialize``) and ``run_days`` never shifts it, however many
month starts it crosses.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..models.model import (GRID_FIELDS, Model, ModelState, gridded_fields,
                            _to_host)
from ..models.physics.sppt import Noise, init_sppt_state, stack_states
from ..utils import calendar as cal


def broadcast_state(state: ModelState, n: int) -> ModelState:
    """One model's state copied to ``n`` members (contiguous, [n, ...])."""
    rep = lambda x: x.unsqueeze(0).expand((n,) + x.shape).contiguous()
    return ModelState(*[None if g is None else type(g)(*map(rep, g))
                        for g in state[:3]], sppt=state.sppt)


class Ensemble:
    """``n_members`` copies of the model state advanced together, on the
    model's device.

    ``noise``: optional sequence of ``n_members`` innovation sources
    (models/physics/sppt.py), member i's; it replaces the members'
    generators (the parity tests feed the JAX key chains through it).
    """

    def __init__(self, model: Model, n_members: int, base_seed: int = 0,
                 noise: Optional[Sequence] = None):
        if n_members < 1:
            raise ValueError(f"n_members={n_members}: need at least one")
        self.model = model
        self.n = n_members
        self.base_seed = base_seed
        self.noise: Noise = noise

    def initialize(self, start: cal.Datetime) -> ModelState:
        """The model's booted state on every member; with SPPT, then each
        member's own stationary AR(1) state and generator. As in the JAX
        package, the boot uses the model's own SPPT seed, and the members'
        SPPT states replace the booted one afterwards, so they have not
        been advanced by the boot."""
        model, cfg = self.model, self.model.cfg
        estate = broadcast_state(model.initialize(start), self.n)
        if cfg.sppt_on:
            sources = self.noise or [None] * self.n
            estate = estate._replace(sppt=stack_states([
                init_sppt_state(cfg, model.pp.sppt_sigma, self.base_seed + i,
                                sources[i])
                for i in range(self.n)]))
        return estate

    def run_days(self, estate: ModelState, start: cal.Datetime, n_days: int,
                 output_writers=None, model_step: int = 0
                 ) -> Tuple[ModelState, cal.Datetime]:
        """Advance all members ``n_days`` from ``start``, each day one
        replay of the captured day (Model.run_staged); returns (a new state,
        end date).

        ``output_writers``: optional list of ``n_members`` writers with
        Model.run's signature ``writer(step, date, start, fields)``, one per
        member (e.g. a NetCDFWriter per memberNNN/ directory): every step's
        gridded fields of every member, and the initial state's when
        ``model_step`` is 0. A day's grids come to the host in one copy for
        all members and steps. The stability guard is checked on each
        day's extrema, per member, once per chunk of days, as in
        Model.run_fast.
        """
        model, cfg = self.model, self.model.cfg
        collect = output_writers is not None
        if collect:
            if len(output_writers) != self.n:
                raise ValueError(f"{len(output_writers)} writers for "
                                 f"{self.n} members")
            if model_step == 0:
                g0 = _to_host(gridded_fields(cfg, model.mc, estate.prog))
                for m, w in enumerate(output_writers):
                    w(0, start, start, {k: v[m] for k, v in g0.items()})
        cd = model.captured_day(estate, collect_output=collect,
                                 grids=collect)
        cd.load(estate)
        date = start

        def write(day: int) -> None:
            nonlocal date
            grids = cd.outputs()
            for i in range(cfg.nsteps):
                date = cal.newdate(date, cfg.nsteps)
                step = model_step + day * cfg.nsteps + i + 1
                for m, w in enumerate(output_writers):
                    w(step, date, start,
                      {k: grids[k][i, m] for k in GRID_FIELDS})

        end = model.run_staged(cd, start, start, n_days, self.noise,
                               after_day=write if collect else None)
        return cd.result(), end

    def member_fields(self, estate: ModelState, member: int
                      ) -> Dict[str, torch.Tensor]:
        """Member ``member``'s gridded fields (Model.gridded_fields)."""
        prog = type(estate.prog)(*(x[member] for x in estate.prog))
        return self.model.gridded_fields(prog)
