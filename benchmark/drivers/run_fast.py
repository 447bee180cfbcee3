"""``Model.run_fast``: whole days with no output, the stability guard
checked once a call; each call of the window runs the cell's chunk of days
from the state and date the last one ended at."""
from __future__ import annotations

from benchmark import program
from benchmark.check import arrays, asked
from benchmark.inputs import as_tuple


class Driver:
    def __init__(self, run):
        self.run = run

    def setup(self) -> None:
        run = self.run
        self.model = program.build_model(run)
        self.date = program.start_date(run)
        state = self.model.initialize(self.date)
        self.boot = arrays(state)
        # the window's start, which the entry leaves as it was
        self.first = self.state = program.perturb(run, state)

    def _advance(self, days: int) -> int:
        self.state = self.model.run_fast(self.date, days, state=self.state)
        self.date = program.add_days(self.date, days, self.run.nsteps)
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
        same day through ``Model.run``'s output day: its end state, and
        its first steps' fields."""
        date = program.start_date(self.run)
        end = self.model.run_fast(date, 1, state=self.first)
        steps, other = asked(self.run)
        out_end = out_steps = None
        if steps or other:
            out_end, out_steps = program.output_day(self.model, self.first,
                                                    date, steps)
        return {"kind": "state", "boot": self.boot,
                "start": arrays(self.first), "end": arrays(end),
                "other_end": out_end, "steps": out_steps,
                "date": as_tuple(date), "run_start": as_tuple(date)}

    def built_libraries(self) -> bool:
        return program.built_libraries()

    def free(self) -> None:
        self.model = self.state = self.first = None

    def close(self) -> None:
        self.free()
