"""Agent engine: move tables, start sampler, the fused step and chunk
kernels, the presence histogram kernels, the lockstep drivers (with
compaction, with recorded trajectories, and over several cases at once),
presence counting and smoothing."""

# the modules ``agents.fused_step``, ``agents.fused_chunk`` and
# ``agents.presence_hist`` hold kernel wrappers of the same names; they
# are not re-exported here, so the submodules stay reachable
from .fused_step import fused_step_plain, launch_count, reset_launch_count
from .moves import directional_probs, restriction_table
from .presence import (circular_kernel, compute_presence_counts,
                       compute_smooth_presence_counts, smooth_presence,
                       smooth_presence_from_counts)
from .presence_hist import (presence_histogram_batch_plain,
                            presence_histogram_plain)
from .simulate import (RecordedRun, SimState, TrackParams, flush_count,
                       flush_pending, init_state, make_chunk_fn,
                       make_step_fn, prepared_weights,
                       prepared_weights_batch, reset_flush_count,
                       simulate_presence, simulate_presence_cases,
                       simulate_presence_cases_compacting,
                       simulate_presence_compacting,
                       simulate_tracks_recorded, state_from_numpy,
                       weights_from_numpy)
from .starts import get_starting_indices

__all__ = ['fused_step_plain', 'launch_count',
           'reset_launch_count', 'directional_probs', 'restriction_table',
           'circular_kernel', 'compute_presence_counts',
           'compute_smooth_presence_counts', 'smooth_presence',
           'smooth_presence_from_counts', 'presence_histogram_batch_plain',
           'presence_histogram_plain', 'RecordedRun', 'SimState',
           'TrackParams', 'flush_count', 'flush_pending', 'init_state',
           'make_chunk_fn', 'make_step_fn', 'prepared_weights',
           'prepared_weights_batch', 'reset_flush_count',
           'simulate_presence', 'simulate_presence_cases',
           'simulate_presence_cases_compacting',
           'simulate_presence_compacting', 'simulate_tracks_recorded',
           'state_from_numpy', 'weights_from_numpy',
           'get_starting_indices']
