"""A whole run, the look for a card skipped, with the timed path broken
underneath: ``correct`` comes out false for each fault a cell can have.

* a step that returns its state unchanged: the solve hands back its start
  (``x0``, and ``b`` as the residual);
* half of the batch left out (served cells): half of a batch's lanes get
  the mean of the other half's answers;
* an answer altered where it is produced: one entry of every solution.

The exchange between chips has no fault here: every cell runs on one.
"""
from __future__ import annotations

import pytest
import torch

from bench.harness.cell import run_cell
from repro_torch.api.artifacts import CompiledPlan
from repro_torch.serve.batched import BatchedPlan

SOLVE_CELLS = ["tiny_cg.solve", "tiny_bicg.solve"]


def _unchanged_run(orig):
    def run(self, feeds=None, **kw):
        out = orig(self, feeds, **kw)
        xs, rs = list(out)
        return {xs: feeds["x0"].clone(), rs: feeds["b"].clone()}
    return run


def _altered_run(orig):
    def run(self, feeds=None, **kw):
        out = orig(self, feeds, **kw)
        x = out[next(iter(out))]
        x[x.shape[0] // 3] += 1e-3 * float(x.abs().max())
        return out
    return run


@pytest.mark.parametrize("cell", SOLVE_CELLS)
def test_sound_runs_are_correct(tiny_spec, cell):
    res, _ = run_cell(tiny_spec, cell, 21, 0.3, False, "cpu")
    assert res["correct"] is True


@pytest.mark.parametrize("cell", SOLVE_CELLS)
@pytest.mark.parametrize("fault", [_unchanged_run, _altered_run])
def test_a_broken_solve_is_not_correct(tiny_spec, monkeypatch, cell, fault):
    monkeypatch.setattr(CompiledPlan, "run", fault(CompiledPlan.run))
    res, lines = run_cell(tiny_spec, cell, 21, 0.3, False, "cpu")
    assert res["correct"] is False, lines


def _half_batch(orig):
    def run_many(self, requests, shared, *, pad=True):
        outs = orig(self, requests, shared, pad=pad)
        if len(outs) < 2:
            return outs
        half = len(outs) // 2
        kept = outs[:len(outs) - half]
        for o in outs[len(outs) - half:]:
            for k in o:
                o[k] = torch.stack([q[k] for q in kept]).mean(dim=0)
        return outs
    return run_many


def _altered_lanes(orig):
    def run_many(self, requests, shared, *, pad=True):
        outs = orig(self, requests, shared, pad=pad)
        for o in outs:
            x = o[next(iter(o))].clone()
            x[x.shape[0] // 3] += 1e-3 * float(x.abs().max())
            o[next(iter(o))] = x
        return outs
    return run_many


def _unchanged_lanes(orig):
    def run_many(self, requests, shared, *, pad=True):
        outs = orig(self, requests, shared, pad=pad)
        return [{k: torch.as_tensor(req[("x0", "b")[i]]).clone()
                 for i, k in enumerate(o)} for o, req in zip(outs, requests)]
    return run_many


def test_a_sound_served_run_is_correct(tiny_spec):
    res, _ = run_cell(tiny_spec, "tiny_cg.serve", 22, 0.5, False, "cpu")
    assert res["correct"] is True


@pytest.mark.parametrize("fault", [_half_batch, _altered_lanes,
                                   _unchanged_lanes])
def test_a_broken_served_batch_is_not_correct(tiny_spec, monkeypatch,
                                              fault):
    monkeypatch.setattr(BatchedPlan, "run_many",
                        fault(BatchedPlan.run_many))
    res, lines = run_cell(tiny_spec, "tiny_cg.serve", 22, 0.5, False, "cpu")
    assert res["correct"] is False, lines
