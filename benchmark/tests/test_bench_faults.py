"""Runs with the timed path broken underneath come out not correct. Each
drives the rest of a run on the CPU at a small size (the harness's look
for a card skipped: the check's comparison is the same code there), the
program patched to commit one fault that the cell can have:

- a step that returns its state unchanged (every cell);
- half of the batch left out and the mean of the rest put in its place
  (the ensemble: its members are the batch);
- an answer altered where it is produced: one value of each step's
  state (a level's global-mean temperature) or of the fields the writer
  is given, off by a plausible amount; the same value altered only where
  the fast day (no output) hands its state back, the output day that the
  steps are judged on left sound; the SPPT innovations drawn from other
  seeds than the members' (the ensemble); the checkpoint written with one
  value off.

The exchange between chips does not exist in these one-card cells. A
clean run at the same size comes out correct.
"""
from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import harness
from benchmark.tests.test_bench_cells import (add_cell, copy_benchmark,
                                              tiny_config)

CELLS = {"single": ("t30l8.single", 1), "ens": ("t30l8.ens64", 4),
         "daily": ("t30l8.run_daily", 1)}


def tiny_cell(tmp_path, kind):
    root = copy_benchmark(tmp_path)
    name, members = CELLS[kind]
    with open(os.path.join(harness.HERE, "workloads", name + ".json")) as f:
        params = json.load(f)
    params.update(chunk_days=1, members=members)
    add_cell(root, "t21l5." + kind, tiny_config(), params)
    return harness.Cell("t21l5." + kind, root=root)


def unchanged(orig):
    """Each step returns the state it was given (its diagnostics taken
    of that state, as the step takes them of its result)."""
    def one_step(cfg, pp, lsp, mc, state, daily, compute_sw,
                 couple_next=False, with_diag=True, **kw):
        from speedy_tpu_torch.models.state import time_level
        from speedy_tpu_torch.utils.diagnostics import compute_diagnostics
        _, outs = orig(cfg, pp, lsp, mc, state, daily, compute_sw,
                       couple_next, with_diag, **kw)
        now = time_level(state.prog, 1)
        diag = compute_diagnostics(mc.dyn.sc, now.vor, now.div, now.t) \
            if with_diag else None
        return state, outs._replace(diag=diag)
    return one_step


def half_batch(orig):
    """The second half of the members is not stepped: each step puts the
    mean of the first half's results in its place."""
    def one_step(*a, **kw):
        state, outs = orig(*a, **kw)

        def fold(x):
            m = x.shape[0] // 2
            return torch.cat([x[:m], x[:m].mean(0, keepdim=True)
                              .expand_as(x[m:])])
        fold_all = lambda g: type(g)(*map(fold, g))
        return state._replace(prog=fold_all(state.prog),
                              surf=fold_all(state.surf),
                              rad=fold_all(state.rad)), outs
    return one_step


def altered(orig):
    """Each step's global-mean temperature of the top level comes out
    0.05 K warm: one spectral coefficient altered where it is made."""
    def one_step(*a, **kw):
        state, outs = orig(*a, **kw)
        t = state.prog.t.clone()
        t[..., 0, 0, 0, 0] += 0.05 / 0.5 ** 0.5
        return state._replace(prog=state.prog._replace(t=t)), outs
    return one_step


def altered_fields(writer):
    """The writer is given a temperature off by 1 K at one point."""
    def call(step, date, start, fields):
        t = fields["t"].copy()
        t.reshape(-1)[t.size // 3] += 1.0
        return writer(step, date, start, dict(fields, t=t))
    return call


def stale_fast(orig):
    """The fast day (no output) hands its state back with the top level's
    global-mean temperature 0.05 K warm; the output variants are sound."""
    def result(self):
        state = orig(self)
        if self.collect:
            return state
        t = state.prog.t.clone()
        t[..., 0, 0, 0, 0] += 0.05 / 0.5 ** 0.5
        return state._replace(prog=state.prog._replace(t=t))
    return result


def shifted_seeds(orig):
    """Each member's SPPT state is seeded one above its seed."""
    def init(cfg, sigma, seed=0, noise=None):
        return orig(cfg, sigma, seed + 1, noise)
    return init


def altered_checkpoint(orig):
    """The checkpoint is written with one surface temperature 1 K off."""
    def save(path, state, *a, **kw):
        stl = state.surf.stl_lm.clone()
        stl.reshape(-1)[stl.numel() // 3] += 1.0
        return orig(path, state._replace(
            surf=state.surf._replace(stl_lm=stl)), *a, **kw)
    return save


def drive(cell, patch=None, monkeypatch=None):
    from speedy_tpu_torch.models import model as model_mod
    if patch is not None:
        monkeypatch.setattr(model_mod, "one_step",
                            patch(model_mod.one_step))
    return harness.drive(cell, 7, 0.01, False, "cpu",
                         log=lambda *a, **k: None)


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_clean_run_is_correct(tmp_path, kind):
    res = drive(tiny_cell(tmp_path, kind))
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_unchanged_state_is_not_correct(tmp_path, monkeypatch, kind):
    res = drive(tiny_cell(tmp_path, kind), unchanged, monkeypatch)
    assert not res["correct"], res["checks"]


def test_half_the_members_is_not_correct(tmp_path, monkeypatch):
    res = drive(tiny_cell(tmp_path, "ens"), half_batch, monkeypatch)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("kind", ["single", "ens"])
def test_altered_answer_is_not_correct(tmp_path, monkeypatch, kind):
    res = drive(tiny_cell(tmp_path, kind), altered, monkeypatch)
    assert not res["correct"], res["checks"]


def test_altered_written_field_is_not_correct(tmp_path, monkeypatch):
    from speedy_tpu_torch.utils import native_output
    cls = native_output.AsyncNetCDFWriter
    orig = cls.__call__
    monkeypatch.setattr(cls, "__call__", lambda self, *a:
                        altered_fields(lambda *b: orig(self, *b))(*a))
    res = drive(tiny_cell(tmp_path, "daily"))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("kind", ["single", "ens"])
def test_fault_of_the_fast_day_alone_is_not_correct(tmp_path, monkeypatch,
                                                     kind):
    from speedy_tpu_torch.models.captured import CapturedDay
    monkeypatch.setattr(CapturedDay, "result", stale_fast(CapturedDay.result))
    res = drive(tiny_cell(tmp_path, kind))
    assert not res["correct"], res["checks"]
    assert res["checks"]["fast"]["value"] > res["checks"]["fast"]["limit"]


def test_draws_from_other_seeds_are_not_correct(tmp_path, monkeypatch):
    from speedy_tpu_torch.parallel import ensemble
    monkeypatch.setattr(ensemble, "init_sppt_state",
                        shifted_seeds(ensemble.init_sppt_state))
    res = drive(tiny_cell(tmp_path, "ens"))
    assert not res["correct"], res["checks"]


def test_altered_checkpoint_is_not_correct(tmp_path, monkeypatch):
    from speedy_tpu_torch.models import model as model_mod
    monkeypatch.setattr(model_mod, "save_checkpoint",
                        altered_checkpoint(model_mod.save_checkpoint))
    res = drive(tiny_cell(tmp_path, "daily"))
    assert not res["correct"], res["checks"]
    assert res["checks"]["ckpt"]["value"] > res["checks"]["ckpt"]["limit"]
