"""A run with its timed path broken underneath must come out not
correct: the faults a cell of this benchmark can have, planted in the
program, each driven through the harness on the CPU (the harness's look
for a card skipped). The exchange between chips has no fault here:
every cell runs on one card."""
import numpy as np
import pytest

from conftest import run_tiny

PDLP_CELLS = ["block_lp.solve64k", "synth_lp.solve50k", "synth_lp.batch16"]


def judged(result):
    assert result["correct"] is False
    assert result["failed"] > 0
    return result["checks"]


@pytest.mark.parametrize("name", PDLP_CELLS)
def test_pdhg_step_that_returns_its_state_unchanged(tiny_cell, monkeypatch,
                                                    name):
    from highs_tpu_torch.solvers.pdlp import pdhg
    cell = tiny_cell(name, {"pdlp_iteration_limit": 400})
    monkeypatch.setattr(pdhg, "_halpern_step",
                        lambda problem, state, gamma, step_op=None: state)
    checks = judged(run_tiny(cell))
    assert checks["not_optimal"]["value"] > 0


def test_ipm_step_that_returns_its_state_unchanged(tiny_cell, monkeypatch):
    from highs_tpu_torch.solvers.ipm import solver
    real = solver.ipm_step

    def stuck(problem, state, *args, **kwargs):
        _, metrics = real(problem, state, *args, **kwargs)
        return state, metrics
    cell = tiny_cell("synth_lp.ipm20k")
    monkeypatch.setattr(solver, "ipm_step", stuck)
    checks = judged(run_tiny(cell))
    assert checks["kkt_worst"]["value"] > checks["kkt_worst"]["limit"] or \
        checks["not_optimal"]["value"] > 0


def test_half_of_the_batch_left_out(tiny_cell, monkeypatch):
    from highs_tpu_torch.solvers.pdlp import batch
    real = batch.solve_lp_batch

    def half(lps, *args, **kwargs):
        return real(lps[:len(lps) // 2], *args, **kwargs)
    cell = tiny_cell("synth_lp.batch16")
    monkeypatch.setattr(batch, "solve_lp_batch", half)
    checks = judged(run_tiny(cell))
    assert checks["missing"]["value"] == len(cell.traffic["members"]) // 2


@pytest.mark.parametrize("name", ["synth_lp.solve50k", "synth_lp.ipm20k"])
def test_facade_answer_altered_where_it_is_produced(tiny_cell, monkeypatch,
                                                    name):
    import highs_tpu_torch
    real = highs_tpu_torch.Highs.getSolution

    def altered(self):
        sol = real(self)
        sol.col_value = np.asarray(sol.col_value, dtype=float).copy()
        sol.col_value[0] += 1e-2
        return sol
    cell = tiny_cell(name)
    monkeypatch.setattr(highs_tpu_torch.Highs, "getSolution", altered)
    checks = judged(run_tiny(cell))
    assert checks["not_optimal"]["value"] == 0
    assert checks["kkt_worst"]["value"] > checks["kkt_worst"]["limit"]


def test_batch_answer_altered_where_it_is_produced(tiny_cell, monkeypatch):
    from highs_tpu_torch.solvers.pdlp import batch
    real = batch.solve_lp_batch

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        status, sol, info = out[-1]
        info.primal_obj += 1e-2
        return out
    cell = tiny_cell("synth_lp.batch16")
    monkeypatch.setattr(batch, "solve_lp_batch", altered)
    checks = judged(run_tiny(cell))
    assert checks["kkt_worst"]["value"] > checks["kkt_worst"]["limit"]
