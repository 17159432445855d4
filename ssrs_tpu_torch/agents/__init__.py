"""Agent engine: move tables, start sampler, the fused step kernel, the
lockstep loop with compaction, presence smoothing."""

# the module ``agents.fused_step`` holds the kernel wrapper of the same
# name; it is not re-exported here, so the submodule stays reachable
from .fused_step import fused_step_plain, launch_count, reset_launch_count
from .moves import directional_probs, restriction_table
from .presence import circular_kernel, smooth_presence
from .simulate import (SimState, TrackParams, flush_pending, init_state,
                       make_step_fn, prepared_weights,
                       simulate_presence_compacting, state_from_numpy,
                       weights_from_numpy)
from .starts import get_starting_indices

__all__ = ['fused_step_plain', 'launch_count',
           'reset_launch_count', 'directional_probs', 'restriction_table',
           'circular_kernel', 'smooth_presence', 'SimState', 'TrackParams',
           'flush_pending', 'init_state', 'make_step_fn',
           'prepared_weights', 'simulate_presence_compacting',
           'state_from_numpy', 'weights_from_numpy',
           'get_starting_indices']
