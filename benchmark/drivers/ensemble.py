"""``Ensemble.run_days``: M members advanced together, each call of the
window a forecast of the cell's chunk of days from the state and date the
last one ended at. The members' SPPT base seed is the run's seed."""
from __future__ import annotations

from benchmark import program
from benchmark.check import arrays, asked
from benchmark.inputs import as_tuple


class Driver:
    def __init__(self, run):
        self.run = run

    def setup(self) -> None:
        from speedy_tpu_torch.parallel.ensemble import Ensemble
        run = self.run
        self.model = program.build_model(run)
        self.ens = Ensemble(self.model, run.members, base_seed=run.seed)
        self.date = program.start_date(run)
        state = self.ens.initialize(self.date)
        # every member is booted alike: one member's boot is compared
        self.boot = {k: v[0].clone() for k, v in arrays(state).items()}
        # the window's start, which the entry leaves as it was (SPPT
        # generators included: each draw copies them)
        self.first = self.state = program.perturb(run, state)

    def _advance(self, days: int) -> int:
        self.state, self.date = self.ens.run_days(self.state, self.date,
                                                  days)
        return days

    def warm_up(self) -> None:
        self._advance(1)

    def chunk(self) -> int:
        return self._advance(int(self.run.cell.params["chunk_days"]))

    def profile_call(self, days: int):
        return lambda: self._advance(days)

    def check_day(self) -> dict:
        """The first day once more, from the window's start: its end state;
        and where the cell's limits ask for steps or for ``fast``, the
        same day through the output day (``run_days`` with writers): its
        end state and its first steps' fields of every member. The
        members' SPPT seeds go with it: the reference draws from them."""
        date = program.start_date(self.run)
        end, _ = self.ens.run_days(self.first, date, 1)
        steps, other = asked(self.run)
        out_end = out_steps = None
        if steps or other:
            out_end, out_steps = program.output_day(
                self.model, self.first, date, steps, self.ens)
        seeds = [self.ens.base_seed + g for g in self.ens.members] \
            if self.run.cell.sppt else None
        return {"kind": "state", "boot": self.boot,
                "start": arrays(self.first), "end": arrays(end),
                "other_end": out_end, "steps": out_steps,
                "sppt_seeds": seeds,
                "date": as_tuple(date), "run_start": as_tuple(date)}

    def built_libraries(self) -> bool:
        return program.built_libraries()

    def free(self) -> None:
        self.model = self.ens = self.state = self.first = self.boot = None

    def close(self) -> None:
        self.free()
