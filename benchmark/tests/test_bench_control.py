"""The control and the faults: the plain reference in the program's place
one precision down (``control.py``), and runs with the timed path broken
underneath, each judged as a sound run is and found not correct.

The control runs here at the tiny cut; ``test_control_at_cell_size``
(marker ``gpu``) runs it at the cells' own sizes on a card:
``python -m pytest -m gpu benchmark/tests/test_bench_control.py``."""

import numpy as np
import pytest
import torch

from benchmark import cells, control, harness, judge
from conftest import REPO

CELLS = [w['name'] for w in cells.load_spec(REPO)['workloads']]


@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct(tiny_root, cell):
    limits = cells.load_limits(tiny_root, cell)
    for r in control.readings(tiny_root, cell, [3, 4, 5], 'cpu'):
        correct, checks = judge.verdict(r['numbers'], limits)
        assert not correct, checks


@pytest.mark.parametrize('cell', CELLS)
def test_table_only_control_differs_in_counts_alone(tiny_root, cell):
    """The table-only control keeps the reference's fields, potentials
    and summary: only its counts can tell it from the program."""
    for r in control.readings(tiny_root, cell, [3], 'cpu',
                              table_only=True):
        n = r['numbers']
        assert n['updraft_gap'] < 1e-6 and n['potential_resid'] < 1e-9
        assert n['summary_gap'] < 1e-12
        assert n['counts_l1'] > 0 and n['counts_mass'] >= 0


def _state_unchanged(mp):
    """The chunk kernel returns the agents' state as it found it, and the
    refined solves return their starting guess."""
    import ssrs_tpu_torch.potential as potential
    from ssrs_tpu_torch.agents import simulate
    mp.setattr(simulate, 'fused_chunk', lambda *a, **k: None)

    def guess(cond, bmask, bvals, **kw):
        return torch.as_tensor(bvals, device=cond.device), 0.

    def guess_batch(conds, bmask, bvals, **kw):
        b = torch.as_tensor(bvals, device=conds.device)
        stats = kw.get('stats')
        if stats is not None:
            stats.update(passes=[0] * len(conds), vcycles=[0] * len(conds))
        return b.expand(conds.shape).clone(), [0.] * len(conds)

    mp.setattr(potential, 'solve_potential_refined', guess)
    mp.setattr(potential, 'solve_potential_refined_batch', guess_batch)


def _half_left_out(mp):
    """Half of the agents are left out of the track drivers."""
    from ssrs_tpu_torch import simulator
    single = simulator.simulate_presence_compacting
    cases = simulator.simulate_presence_cases_compacting

    def half(params, starts, *a, **k):
        return single(params, starts[:len(starts) // 2], *a, **k)

    def half_cases(params, tables, starts, *a, **k):
        return cases(params, tables, starts[:len(starts) // 2], *a, **k)

    mp.setattr(simulator, 'simulate_presence_compacting', half)
    mp.setattr(simulator, 'simulate_presence_cases_compacting', half_cases)


def _summary_altered(mp):
    """One cell of the summary map altered where it is made."""
    from ssrs_tpu_torch.plotting import PlottingMixin
    orig = PlottingMixin._finish_summary_presence

    def altered(self, summary):
        summary = np.array(summary)
        summary[summary.shape[0] // 2, summary.shape[1] // 2] += 0.01
        return orig(self, summary)

    mp.setattr(PlottingMixin, '_finish_summary_presence', altered)


def _updraft_altered(mp):
    """One interior cell of the orographic updraft altered where it is
    made."""
    from ssrs_tpu_torch import simulator
    orig = simulator.compute_orographic_updraft

    def altered(*a, **k):
        out = orig(*a, **k).clone()
        out[out.shape[0] // 2, out.shape[1] // 2] += 0.5
        return out

    mp.setattr(simulator, 'compute_orographic_updraft', altered)


FAULTS = [_state_unchanged, _half_left_out, _summary_altered,
          _updraft_altered]


@pytest.mark.parametrize('fault', FAULTS, ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize('cell', CELLS)
def test_fault_is_not_correct(tiny_root, cell, fault, monkeypatch,
                              one_thread):
    fault(monkeypatch)
    res = harness.run_cell(tiny_root, cell, 17, 0.3, False, 'cpu')
    assert res['correct'] is False, res['checks']


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return 'cuda:0'


# the jobs a window of the cell holds (the median of the chip runs), where
# fewer than judge.COUNT_JOBS
WINDOW_JOBS = {'wy_uniform.run': 15}


@pytest.mark.gpu
@pytest.mark.parametrize('cell', CELLS)
def test_control_at_cell_size(card, cell):
    limits = cells.load_limits(REPO, cell)
    for r in control.readings(REPO, cell, [1, 2, 3], card,
                              jobs=WINDOW_JOBS.get(cell)):
        correct, checks = judge.verdict(r['numbers'], limits)
        assert not correct, checks


@pytest.mark.gpu
def test_table_only_control_at_cell_size(card):
    """A float8 move table and walk on the reference's fields and
    potentials fails the ensemble's counts limits: the counts see the
    table's precision, not only the fields'."""
    cell = 'wy_sweep.ensemble'
    limits = cells.load_limits(REPO, cell)
    for r in control.readings(REPO, cell, [1, 2, 3], card,
                              table_only=True):
        n = r['numbers']
        assert n['counts_l1'] > limits['counts_l1'] or \
            n['counts_mass'] > limits['counts_mass'], n
