"""A run with the timed path broken underneath comes out not correct
(CPU, the tiny configuration; the harness's look for a card skipped by
calling run_cell on the CPU).  The faults the cells can have: the
program returns its state unchanged (an earlier answer), or an answer
is altered where it is produced.  One card and one request a call: no
exchange between chips, no batch to halve."""

import dataclasses
import time

import pytest

from pdnbench import harness
from pdnbench.conftest import TINY_CELLS


def _run(tiny, cell):
    bench, root = tiny
    return harness.run_cell(bench, cell, 2**31 + 77, 0.01, False, "cpu",
                            time.perf_counter(), root)


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_a_sound_run_is_correct(tiny, cell):
    result, checks = _run(tiny, cell)
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert checks and all(v <= limit for _, v, limit in checks)


def _stale(fn):
    """fn returning the first answer it ever gave."""
    first = []

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        if not first:
            first.append(out)
        return first[0]
    return wrapper


def _altered_bordered(fn):
    def wrapper(*args, **kwargs):
        sol = fn(*args, **kwargs)
        v = sol.v.copy()
        v[len(v) // 2] += 1e-6
        return dataclasses.replace(sol, v=v)
    return wrapper


def _altered_solution(fn):
    def wrapper(*args, **kwargs):
        sol = fn(*args, **kwargs)
        pots = sol.layer_solutions[0].potentials[0]
        pots.values = pots.values.copy()
        pots.values[len(pots.values) // 2] += 1e-6
        return sol
    return wrapper


def _patch(monkeypatch, cell, make):
    from padne_tpu_torch import solver
    from padne_tpu_torch.ops import schur

    kind = cell.split(".")[1]
    if kind == "resolve":
        monkeypatch.setattr(schur.DiaBorderedSolver, "solve",
                            make(schur.DiaBorderedSolver.solve))
    elif kind == "board":
        monkeypatch.setattr(schur, "solve_bordered",
                            make(schur.solve_bordered))
    else:
        monkeypatch.setattr(solver, "solve", make(solver.solve))


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_state_returned_unchanged_is_not_correct(tiny, cell, monkeypatch):
    _patch(monkeypatch, cell, _stale)
    result, checks = _run(tiny, cell)
    assert result["correct"] is False
    assert all(v > limit for _, v, limit in checks)


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_an_altered_answer_is_not_correct(tiny, cell, monkeypatch):
    alter = (_altered_solution if cell.endswith("project")
             else _altered_bordered)
    _patch(monkeypatch, cell, alter)
    result, checks = _run(tiny, cell)
    assert result["correct"] is False
    assert all(v > limit for _, v, limit in checks)


def test_a_failed_request_is_not_correct(tiny, monkeypatch):
    from padne_tpu_torch.ops import schur

    calls, solve = [], schur.solve_bordered

    def broken(*args, **kwargs):
        calls.append(1)
        if len(calls) > 1:          # after the warm-up
            raise RuntimeError("planted fault")
        return solve(*args, **kwargs)

    monkeypatch.setattr(schur, "solve_bordered", broken)
    bench, root = tiny
    result, _ = harness.run_cell(bench, "tiny.board", 3, 0.01, False, "cpu",
                                 time.perf_counter(), root)
    assert result["correct"] is False and result["failed"] >= 1
