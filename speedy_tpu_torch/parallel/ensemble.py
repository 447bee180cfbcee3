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

With a mesh (parallel/mesh.py) the members are split over the 'dp' ranks,
one process each: a rank holds the contiguous block ``mesh.members(M)``
of global members and runs them through its own captured day. Member g
keeps the seed ``base_seed + g`` on every rank that holds it, so its
trajectory does not depend on the sharding. The guard's rows are reduced
over the ranks once per chunk of days, on the host, so every rank raises
at the same chunk naming the same member and day.

With sp > 1 the dp row's sp ranks hold the same members, each on its
latitude band (``mesh.rows``): the model's band view (``Model.for_band``)
runs the day on the band, with the spectral state replicated and one
all-reduce over the row's sp group per Legendre analysis, inside the
captured day under NCCL and in an eager day under Gloo (models/
captured.py). ``initialize`` boots the full model, as without a mesh, and
keeps the band's rows of the grid leaves (surf, rad). Output gathers the
bands over the sp group: a day's grids once a day to sp rank 0, whose
writers alone write, and ``member_fields`` to every sp rank of the row.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..convert import band_state
from ..models.model import (GRID_FIELDS, Model, ModelState, gridded_fields,
                            _to_host)
from ..models.physics.sppt import Noise, init_sppt_state, stack_states
from ..utils import calendar as cal
from ..utils import tracing
from ..utils.diagnostics import InstabilityError, bad_days


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
    ``mesh``: a ('dp', 'sp') mesh (parallel/mesh.make_mesh); this rank
    then holds the global members ``self.members`` on the mesh's device,
    which must be the model's, on the latitude rows ``self.rows`` (the
    model's band view ``self.band``), and ``noise`` is sliced to them.
    """

    def __init__(self, model: Model, n_members: int, base_seed: int = 0,
                 noise: Optional[Sequence] = None, mesh=None):
        if n_members < 1:
            raise ValueError(f"n_members={n_members}: need at least one")
        if noise is not None and len(noise) != n_members:
            raise ValueError(f"{len(noise)} noise sources for {n_members} "
                             "members")
        self.model = model
        self.n = n_members
        self.base_seed = base_seed
        self.mesh = mesh
        self.members = range(n_members) if mesh is None \
            else mesh.members(n_members)
        if mesh is not None and mesh.device != model.device:
            raise ValueError(f"the model is on {model.device}, the rank's "
                             f"mesh device is {mesh.device}")
        if noise is not None:
            noise = list(noise)[self.members.start:self.members.stop]
        self.noise: Noise = noise
        self.band = model if mesh is None else model.for_band(mesh)
        self.rows = self.band.rows
        # writers write on the dp row's first sp rank only
        self.writes = mesh is None or mesh.sp_rank == 0

    def _gather_rows(self, fields: Dict[str, np.ndarray]
                     ) -> Optional[Dict[str, np.ndarray]]:
        """Band fields [..., rows, ix] of every sp rank of the dp row,
        concatenated on the latitude axis in sp order on the row's first
        sp rank (None on the others); the fields themselves without
        bands."""
        group = self.band.sp_group
        if group is None:
            return fields
        parts = [None] * dist.get_world_size(group) if self.writes else None
        dist.gather_object(fields, parts, dst=self.mesh.sp_root(),
                           group=group)
        if not self.writes:
            return None
        return {k: np.concatenate([p[k] for p in parts], axis=-2)
                for k in fields}

    @property
    def n_local(self) -> int:
        """The members this rank holds."""
        return len(self.members)

    @tracing.span("setup.boot")
    def initialize(self, start: cal.Datetime) -> ModelState:
        """The model's booted state on every member; with SPPT, then each
        member's own stationary AR(1) state and generator. As in the JAX
        package, the boot uses the model's own SPPT seed, and the members'
        SPPT states replace the booted one afterwards, so they have not
        been advanced by the boot. Its ``setup.boot`` span holds the
        model's (utils/tracing.py)."""
        model, cfg = self.model, self.model.cfg
        state = band_state(model.initialize(start), self.rows)
        if cfg.sst_anomaly_forcing and self.band is not model:
            self.band.set_anomaly_window(start)
        estate = broadcast_state(state, self.n_local)
        if cfg.sppt_on:
            sources = self.noise or [None] * self.n_local
            estate = estate._replace(sppt=stack_states([
                init_sppt_state(cfg, model.pp.sppt_sigma, self.base_seed + g,
                                src)
                for g, src in zip(self.members, sources)]))
        return estate

    @tracing.span("call.run_days")
    def run_days(self, estate: ModelState, start: cal.Datetime, n_days: int,
                 output_writers=None, model_step: int = 0,
                 after_day=None) -> Tuple[ModelState, cal.Datetime]:
        """Advance all members ``n_days`` from ``start``, each day one
        replay of the captured day (Model.run_staged); returns (a new state,
        end date).

        ``output_writers``: optional list of writers with Model.run's
        signature ``writer(step, date, start, fields)``, one per member
        this rank holds, in the order of ``self.members`` (e.g. a
        NetCDFWriter per memberNNN/ directory, NNN the global index):
        every step's gridded fields of every member, and the initial
        state's when ``model_step`` is 0. A day's grids come to the host in
        one copy for all members and steps. The stability guard is checked
        on each day's extrema, per member, once per chunk of days, as in
        Model.run_fast (``guard``, reduced over the ranks of a mesh).
        ``after_day(i)`` runs after day i's replay (and its output).
        Spans (utils/tracing.py): ``call.run_days`` around the call,
        ``day.write`` around a day's writer calls, and Model.run_staged's.
        """
        model, cfg = self.band, self.model.cfg
        collect = output_writers is not None
        if collect:
            if len(output_writers) != self.n_local:
                raise ValueError(f"{len(output_writers)} writers for "
                                 f"{self.n_local} members")
            if model_step == 0:
                g0 = self._gather_rows(_to_host(gridded_fields(
                    cfg, model.mc, estate.prog)))
                if self.writes:
                    with tracing.span("day.write"):
                        for m, w in enumerate(output_writers):
                            w(0, start, start,
                              {k: v[m] for k, v in g0.items()})
        cd = model.captured_day(estate, collect_output=collect,
                                 grids=collect)
        cd.load(estate)
        date = start

        def write(day: int) -> None:
            nonlocal date
            grids = self._gather_rows(cd.outputs())
            if not self.writes:
                return
            with tracing.span("day.write"):
                for i in range(cfg.nsteps):
                    date = cal.newdate(date, cfg.nsteps)
                    step = model_step + day * cfg.nsteps + i + 1
                    for m, w in enumerate(output_writers):
                        w(step, date, start,
                          {k: grids[k][i, m] for k in GRID_FIELDS})

        def day_done(day: int) -> None:
            if collect:
                write(day)
            if after_day is not None:
                after_day(day)

        end = model.run_staged(cd, start, start, n_days, self.noise,
                               after_day=day_done, guard=self.guard)
        return cd.result(), end

    def guard(self, rows: np.ndarray, first_day: int) -> None:
        """The stability guard (``diagnostics.bad_days``) on a chunk's rows
        [days, 4, members, kx] of this rank's members, days counted from
        ``first_day``: InstabilityError names the first rejected day and
        its global member. Over a mesh's process group, one all-reduce
        (MIN) of that (day, member), coded day x n_members + member, makes
        every rank raise at the same chunk, naming the same member and
        day, or none."""
        hits = np.argwhere(bad_days(rows))
        none = rows.shape[0] * self.n
        code = none if len(hits) == 0 else \
            int(hits[0][0]) * self.n + self.members.start + int(hits[0][1])
        if self.mesh is not None and self.mesh.backend is not None:
            t = torch.tensor([code], dtype=torch.int64,
                             device=self.mesh.host_device())
            dist.all_reduce(t, op=dist.ReduceOp.MIN)
            code = int(t.item())
        if code < none:
            day, member = divmod(code, self.n)
            mine = ""
            if member in self.members:
                r = rows[day, :, member - self.members.start]
                mine = (f": reke={r[0]}, deke={r[1]}, temp min={r[2]}, "
                        f"max={r[3]}")
            raise InstabilityError(
                f"Model variables out of accepted range at day "
                f"{first_day + day}, member {member}{mine}")

    def member_fields(self, estate: ModelState, member: int
                      ) -> Dict[str, torch.Tensor]:
        """Global member ``member``'s gridded fields (Model.gridded_fields),
        on the rank that holds it; another rank raises. On a mesh with sp
        > 1, a collective of the dp row's sp ranks: each gets the whole
        grid, the bands gathered over the sp group."""
        if member not in self.members:
            raise ValueError(
                f"member {member} is not held here: this rank holds "
                f"{self.members.start}..{self.members.stop - 1}")
        local = member - self.members.start
        prog = type(estate.prog)(*(x[local] for x in estate.prog))
        fields = self.band.gridded_fields(prog)
        group = self.band.sp_group
        if group is None:
            return fields
        parts = [None] * dist.get_world_size(group)
        dist.all_gather_object(parts, _to_host(fields), group=group)
        return {k: torch.from_numpy(np.concatenate(
            [p[k] for p in parts], axis=-2)).to(self.band.device)
            for k in fields}
