"""Several devices: agents sharded over a mesh (``mesh.py``) and fields
sharded by rows (``fields.py``), in one process, over a list of
``torch.device``s that may repeat a device."""

from .fields import (RowBlocks, Transfers, make_field_mesh,
                     orographic_updraft_from_dem_sharded,
                     solve_potential_refined_sharded)
from .mesh import (make_mesh, pad_to_multiple, sharded_presence_fn,
                   simulate_presence_sharded,
                   simulate_presence_sharded_compacting)

__all__ = ['RowBlocks', 'Transfers', 'make_field_mesh',
           'orographic_updraft_from_dem_sharded',
           'solve_potential_refined_sharded', 'make_mesh',
           'pad_to_multiple', 'sharded_presence_fn',
           'simulate_presence_sharded',
           'simulate_presence_sharded_compacting']
