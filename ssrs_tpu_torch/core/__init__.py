"""Core primitives: grid geometry, generator seeding, timing."""

from .grid import Grid
from .rng import case_generator, case_seed, fold_in, fold_str, root_seed
from .timing import PhaseTimer, elapsed_str

__all__ = ['Grid', 'case_generator', 'case_seed', 'fold_in', 'fold_str',
           'root_seed', 'PhaseTimer', 'elapsed_str']
