"""The twin of ``tests/test_pipeline_fidelity.py`` for the port: the whole
pipeline on the CPU against the sequential NumPy oracle.

Synthetic DEM -> slope and aspect -> orographic updraft -> threshold ->
float64 direct potential -> lockstep simulation, all through
``ssrs_tpu_torch`` (``simulate_presence`` on a CPU generator, the plain
step), compared with ``tests/oracle_agents.py::simulate_tracks_numpy`` on
the same fields: the acceptance strategy of SURVEY.md section 4,
presence-map distributions rather than per-track RNG parity. The bounds
are the JAX test's: L1 < 0.10 between the normalized smoothed maps, and
hot cells visited more than 1.2x as often as cold ones. 2,500 agents,
250 steps, on the ``synthetic_dem`` fixture.
"""

import numpy as np
import torch

from ssrs_tpu_torch.agents import TrackParams, simulate_presence
from ssrs_tpu_torch.agents.presence import smooth_presence
from ssrs_tpu_torch.fields import (compute_orographic_updraft,
                                   compute_slope_aspect_degrees,
                                   get_above_threshold_speed)
from ssrs_tpu_torch.potential import solve_potential_direct

from oracle_agents import simulate_tracks_numpy

AGENTS = 2500
STEPS = 250


def _pipeline_fields(synthetic_dem):
    res = 100.
    slope, aspect = compute_slope_aspect_degrees(synthetic_dem, res)
    w = compute_orographic_updraft(
        10. * np.ones(synthetic_dem.shape, np.float32),
        270. * np.ones(synthetic_dem.shape, np.float32),
        slope.numpy(), aspect.numpy())
    usable = get_above_threshold_speed(w, 0.75).numpy()
    potential = solve_potential_direct(usable, 0.)
    return usable, potential


def _presence(usable, potential, rng, seed):
    nrow, ncol = usable.shape
    params = TrackParams(grid_shape=(nrow, ncol), move_dirn=0., nu=1.,
                         memory_k=1, burnin=int(min(nrow, ncol) / 10),
                         nsteps=STEPS)
    starts = np.stack([rng.integers(3, 8, AGENTS),
                       rng.integers(10, ncol - 10, AGENTS)],
                      axis=1).astype(np.int32)
    presence, _ = simulate_presence(
        params, torch.from_numpy(starts), torch.Generator().manual_seed(seed),
        updraft=usable, potential=potential)
    return presence, starts


def test_fluidflow_pipeline_matches_oracle(synthetic_dem, rng):
    usable, potential = _pipeline_fields(synthetic_dem)
    presence, starts = _presence(usable, potential, rng, 17)
    counts_np, _ = simulate_tracks_numpy(
        starts, usable.shape, 0., 1., 1, STEPS,
        np.random.default_rng(99), updraft=usable, potential=potential)
    a = smooth_presence(presence, 4).double().numpy()
    b = smooth_presence(torch.from_numpy(counts_np.astype(np.int32)),
                        4).double().numpy()
    a /= a.sum()
    b /= b.sum()
    l1 = np.abs(a - b).sum()
    assert l1 < 0.10, f'pipeline presence L1 distance {l1}'


def test_pipeline_tracks_follow_updraft_corridors(synthetic_dem, rng):
    """With fluidflow, cells of high usable updraft gather more presence
    than cells of none, on average (the model's purpose)."""
    usable, potential = _pipeline_fields(synthetic_dem)
    presence, _ = _presence(usable, potential, rng, 21)
    presence = presence.double().numpy()
    nrow = usable.shape[0]
    # away from the start rows and the borders
    zone = slice(20, nrow - 5)
    hot = usable[zone, 5:-5] > 1.0
    cold = usable[zone, 5:-5] == 0.0
    p = presence[zone, 5:-5]
    assert hot.sum() > 100 and cold.sum() > 100
    assert p[hot].mean() > 1.2 * p[cold].mean()
