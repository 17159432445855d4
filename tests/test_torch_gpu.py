"""Tests of the port's CUDA kernel and its card path (marker ``gpu``).

They skip without a CUDA device. This file imports no JAX, so it also
runs on a machine that has the card but no JAX:

    python -m pytest --noconftest -m gpu -q tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest.py configures JAX.)
"""

import numpy as np
import pytest
import torch

import ssrs_tpu_torch
from ssrs_tpu_torch.agents import fused_step as fs
from ssrs_tpu_torch.agents.moves import directional_probs, restriction_table
from ssrs_tpu_torch.agents.presence import smooth_presence

pytestmark = pytest.mark.gpu

GRID = (48, 56)
N = 2000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _inputs(seed, k, dtype, dev):
    """All-zero and sparse table rows, dead agents, palive 0 and random
    memory: every branch of the cascade runs."""
    rng = np.random.default_rng(seed)
    nrow, ncol = GRID
    table = (rng.random((nrow * ncol, 9)) * 50.).astype(np.float32)
    kind = rng.random(nrow * ncol)
    table[kind < 0.2] = 0.
    sparse = (kind >= 0.2) & (kind < 0.5)
    table[sparse] *= rng.random((int(sparse.sum()), 9)) < 0.2
    table[:, 4] = 0.
    ints = dict(pr=rng.integers(1, nrow - 1, N),
                pc=rng.integers(1, ncol - 1, N),
                r=rng.integers(0, nrow, N), c=rng.integers(0, ncol, N),
                mem=rng.integers(0, 9, (max(k, 1), N)))
    args = {key: torch.from_numpy(v.astype(np.int32)).to(dev)
            for key, v in ints.items()}
    args['alive'] = torch.from_numpy(rng.random(N) < 0.85).to(dev)
    args['palive'] = torch.from_numpy(rng.random(N) < 0.85).to(dev)
    args['u'] = torch.from_numpy(rng.random(N).astype(np.float32)).to(dev)
    return torch.from_numpy(table).to(dev).to(dtype), args


def _call(fn, table, a, presence, nu, k):
    dev = presence.device
    return fn(table, torch.from_numpy(restriction_table()).to(dev),
              torch.from_numpy(directional_probs(0.)).to(dev), a['pr'],
              a['pc'], a['r'], a['c'], a['alive'], a['palive'], a['mem'],
              a['u'], presence, nu=nu, memory_k=k)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('k', [0, 1, 3])
@pytest.mark.parametrize('nu', [1.0, 0.0])
def test_kernel_matches_plain_on_card(cuda, dtype, k, nu):
    table, a = _inputs(k + 10 * int(nu), k, dtype, cuda)
    pk = torch.zeros(GRID, dtype=torch.int32, device=cuda)
    pp = torch.zeros_like(pk)
    out_k = _call(fs.fused_step, table, a, pk, nu, k)
    out_p = _call(fs.fused_step_plain, table, a, pp, nu, k)
    torch.cuda.synchronize()
    for x, y in zip(out_k + (pk,), out_p + (pp,)):
        assert torch.equal(x, y)


def test_launch_counter_counts_card_launches(cuda):
    table, a = _inputs(1, 1, torch.float32, cuda)
    fs.reset_launch_count()
    pres = torch.zeros(GRID, dtype=torch.int32, device=cuda)
    for _ in range(3):
        _call(fs.fused_step, table, a, pres, 1.0, 1)
    _call(fs.fused_step_plain, table, a, pres, 1.0, 1)
    assert fs.launch_count() == 3


def test_wrapper_rejects_mixed_devices(cuda):
    table, a = _inputs(2, 1, torch.float32, cuda)
    with pytest.raises(ValueError, match='on'):
        _call(fs.fused_step, table.cpu(), a,
              torch.zeros(GRID, dtype=torch.int32, device=cuda), 1.0, 1)


def test_simulator_card_matches_cpu(cuda, tmp_path):
    """The small WY run on the card against the same run through the
    plain versions on the CPU, on one potential (the CPU run reads the
    card run's cached potential; see tests/test_torch_simulator.py on why
    the potential must be shared): smoothed maps within L1 0.08."""
    cfg = dict(run_name='wy_test', sim_mode='uniform', sim_seed=11,
               region_width_km=(12., 10.), resolution=200.,
               track_count=4096, track_start_region=(1., 11., 1., 2.),
               track_max_steps=400, potential_solver='direct',
               track_pkl_budget=0, mesh_devices=1, out_dir=str(tmp_path))
    maps = []
    for device in (cuda, 'cpu'):
        sim = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(**cfg),
                                       device=device)
        sim.simulate_tracks()
        counts = sim.get_presence_counts(sim.case_ids[0], 0)
        m = smooth_presence(torch.from_numpy(counts), 3).numpy()
        maps.append(m.astype(np.float64) / m.sum())
    assert np.abs(maps[0] - maps[1]).sum() < 0.08
