"""Fields sharded by rows over several devices: grids beyond one card.

The PyTorch counterpart of ``ssrs_tpu/parallel/fields.py``. There GSPMD
partitions the single-device program from row-sharded inputs: the
stencils become 1-row halo exchanges, the dots and island sums small
all-reduces, and the small coarse levels are replicated. The port does
the same by hand, in one process, over a list of devices
(:func:`make_field_mesh`, which may repeat a device):

- a field is a :class:`RowBlocks`: one block of rows a device, in row
  order, with the arithmetic of a tensor block by block;
- a stencil runs the single-device code on a block plus one halo row
  from each neighbouring block (none at the grid's edge, which the code
  then treats as it does on one device) and keeps the block's own rows.
  The stencils are local and the halos exact copies, so a stencil's
  result is bitwise the single-device one: the Horn orograph, the weight
  planes, the smoother;
- the refined solve is ``potential/lap.py``'s own code (its V-cycle, GCR
  and refinement take row blocks as they take a tensor); this module
  builds its sharded levels. The multigrid's transfers are block-local:
  block boundaries fall on rows that stay even at every sharded level
  (the blocks are sized so; the field is not padded);
- dots, norms and island sums are per-block partials summed in block
  order on ``mesh[0]``, in float64 where the single-device solve sums in
  float64. That order is fixed, so two solves on one mesh give the same
  bits (ROADMAP.md section 3, hazard 5); against the single-device solve
  only those sums round apart;
- the levels whose blocks would hold fewer than ``_MIN_BLOCK_ROWS`` rows
  are single-device levels on ``mesh[0]``: the V-cycle gathers the
  residual there (the JAX package replicates its small coarse levels
  too);
- :class:`Transfers` counts the bytes each move between shards carries,
  by kind: the bound that the JAX package reads from the compiled HLO
  (``tests/test_shard_fields.py``) is read from it here.

The host work of a solve is unchanged: one ``label`` of ``cond > 0`` and
the island layouts, now a block each, and one scalar read per GCR
iteration. No ``torch.distributed``: one process drives every device, as
in ``parallel/mesh.py``.
"""

from __future__ import annotations

import operator
from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..fields.updraft import orographic_updraft_from_dem
from ..potential.lap import (LapLevel, _coarsen_bmask, _crossing_planes,
                             _diag_inv, _galerkin_coarsen,
                             _host_coarsen_labels, _refine, build_lap_levels,
                             hierarchy_depth, island_labels, island_segments,
                             island_sum, symmetrize_planes, weight_planes)
from .mesh import make_mesh

# a level stays sharded while its blocks hold at least this many rows
_MIN_BLOCK_ROWS = 8

# the devices of a 1-D row mesh, as for agents
make_field_mesh = make_mesh


class Transfers:
    """The moves between shards of a sharded computation: ``(kind,
    bytes)`` a move, in order. Kinds: ``'scatter'`` (an input on
    ``mesh[0]`` cut into blocks), ``'halo'`` (a block's edge row to its
    neighbour), ``'reduce'`` (a partial to ``mesh[0]``), ``'bcast'`` (a
    scalar or a per-island vector from ``mesh[0]``), ``'gather'`` (a block
    to ``mesh[0]``: the coarse levels, a result) and ``'split'`` (a
    gathered coarse level's correction back to its blocks)."""

    def __init__(self):
        self.moves = []

    def add(self, kind: str, tensor: torch.Tensor) -> None:
        self.moves.append((kind, tensor.numel() * tensor.element_size()))

    def summary(self) -> dict:
        """``{kind: {'moves', 'bytes', 'largest'}}``."""
        out = {}
        for kind, nbytes in self.moves:
            rec = out.setdefault(kind, {'moves': 0, 'bytes': 0,
                                        'largest': 0})
            rec['moves'] += 1
            rec['bytes'] += nbytes
            rec['largest'] = max(rec['largest'], nbytes)
        return out


def _move(x: torch.Tensor, mesh, src: int, dst: int, transfers: Transfers,
          kind: str) -> torch.Tensor:
    """``x`` from shard ``src`` to shard ``dst``, counted when they
    differ (on one device repeated the copy is free, the count is not)."""
    if src != dst:
        transfers.add(kind, x)
    return x.to(mesh[dst])


def _reduce(parts, mesh, transfers: Transfers) -> torch.Tensor:
    """The sum of per-shard partials (``{shard: tensor}``) on ``mesh[0]``,
    in shard order."""
    total = None
    for i in sorted(parts):
        p = _move(parts[i], mesh, i, 0, transfers, 'reduce')
        total = p if total is None else total + p
    return total


def _binary(op, reflected: bool = False):
    """A RowBlocks operator: ``op`` block by block with another RowBlocks
    of the same layout, a Python number, or a 0-d tensor on ``mesh[0]``
    (copied to each shard); ``reflected``: the RowBlocks is the right
    operand."""
    def method(self, other):
        if isinstance(other, RowBlocks):
            parts = other.blocks
        elif torch.is_tensor(other):
            if other.dim():
                raise ValueError('a RowBlocks operand: another RowBlocks, '
                                 'a number or a 0-d tensor')
            parts = self.bcast(other)
        else:
            parts = [other] * len(self.blocks)
        return self.like([op(p, b) if reflected else op(b, p)
                          for b, p in zip(self.blocks, parts)])
    return method


class RowBlocks:
    """A field whose rows (its second-last axis) are cut into blocks, in
    row order, block i on ``mesh[i]``: the port's row-sharded array. Its
    arithmetic runs block by block; its scalars (sums, norms) live on
    ``mesh[0]``. Moves between shards are counted in ``transfers``."""

    def __init__(self, blocks, mesh, transfers: Transfers):
        self.blocks = list(blocks)
        self.mesh = tuple(mesh)
        self.transfers = transfers

    @classmethod
    def split(cls, x, offsets, mesh, transfers: Transfers, dtype=None):
        """``x`` (numpy, or a tensor, whose home is taken to be
        ``mesh[0]``) cut at the row ``offsets`` (n + 1 of them). A numpy
        field is uploaded block by block."""
        blocks = []
        for i in range(len(mesh)):
            part = x[..., offsets[i]:offsets[i + 1], :]
            if torch.is_tensor(part):
                part = _move(part.contiguous(), mesh, 0, i, transfers,
                             'scatter')
            else:
                part = torch.from_numpy(np.ascontiguousarray(part)).to(
                    mesh[i])
            blocks.append(part if dtype is None else part.to(dtype))
        return cls(blocks, mesh, transfers)

    @property
    def offsets(self) -> List[int]:
        out = [0]
        for b in self.blocks:
            out.append(out[-1] + b.shape[-2])
        return out

    @property
    def device(self) -> torch.device:
        """Where the field's scalars live: ``mesh[0]``."""
        return self.mesh[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    def like(self, blocks) -> 'RowBlocks':
        return RowBlocks(blocks, self.mesh, self.transfers)

    def map(self, fn, *others) -> 'RowBlocks':
        """``fn`` block by block; ``others`` are RowBlocks of the same
        layout or per-shard lists."""
        parts = [o.blocks if isinstance(o, RowBlocks) else o for o in others]
        return self.like([fn(b, *(p[i] for p in parts))
                          for i, b in enumerate(self.blocks)])

    def to(self, dtype) -> 'RowBlocks':
        return self.map(lambda b: b.to(dtype))

    __add__ = _binary(operator.add)
    __sub__ = _binary(operator.sub)
    __mul__ = _binary(operator.mul)
    __radd__ = _binary(operator.add, reflected=True)
    __rsub__ = _binary(operator.sub, reflected=True)
    __rmul__ = _binary(operator.mul, reflected=True)

    def __neg__(self) -> 'RowBlocks':
        return self.map(operator.neg)

    def bcast(self, x: torch.Tensor) -> list:
        """``x`` from ``mesh[0]`` to every shard."""
        return [_move(x, self.mesh, 0, i, self.transfers, 'bcast')
                for i in range(len(self.mesh))]

    def total(self) -> torch.Tensor:
        """The sum of the cells: per-block sums added in block order on
        ``mesh[0]``."""
        return _reduce({i: torch.sum(b) for i, b in enumerate(self.blocks)},
                       self.mesh, self.transfers)

    def norm(self) -> torch.Tensor:
        """The 2-norm of the cells, from per-block norms, on ``mesh[0]``."""
        parts = [_move(torch.linalg.vector_norm(b), self.mesh, i, 0,
                       self.transfers, 'reduce')
                 for i, b in enumerate(self.blocks)]
        return torch.linalg.vector_norm(torch.stack(parts))

    def spread(self, c: torch.Tensor) -> 'RowBlocks':
        """``c[self]`` for an integer field (the island labels): the
        per-island vector ``c`` on ``mesh[0]`` indexed block by block."""
        return self.map(lambda lb, cb: cb[lb], self.bcast(c))

    def _edge(self, i: int, j: int, first: bool) -> torch.Tensor:
        """Block j's first or last row, on shard i (a halo move)."""
        row = self.blocks[j][..., :1, :] if first \
            else self.blocks[j][..., -1:, :]
        return _move(row, self.mesh, j, i, self.transfers, 'halo')

    def extended(self):
        """Each block with its neighbours' edge rows around it: a list of
        ``(block with halo rows, rows above, rows below)``; the grid's top
        and bottom get no halo row."""
        n = len(self.blocks)
        out = []
        for i, b in enumerate(self.blocks):
            parts = ([self._edge(i, i - 1, False)] if i else []) + [b] + \
                ([self._edge(i, i + 1, True)] if i + 1 < n else [])
            out.append((torch.cat(parts, dim=-2), int(i > 0),
                        int(i + 1 < n)))
        return out

    def stencil(self, fn, *others) -> 'RowBlocks':
        """``fn`` of the single-device code applied to each block with its
        halo rows (``others``: more RowBlocks of the same layout, halo'd
        alike), cropped to the block's rows: bitwise ``fn`` of the whole
        field cut into the blocks, for any ``fn`` whose output row r reads
        rows r-1..r+1 and treats the array's edge as the grid's."""
        exts = [self.extended()] + [o.extended() for o in others]
        out = []
        for i, b in enumerate(self.blocks):
            top = exts[0][i][1]
            res = fn(*(e[i][0] for e in exts))
            out.append(res[..., top:top + b.shape[-2], :].contiguous())
        return self.like(out)

    def padded(self):
        """Each 2-D block in a one-cell frame: its neighbours' edge rows
        above and below, zeros beyond the grid (what ``F.pad(u, (1, 1, 1,
        1))`` gives the single-device stencil)."""
        n = len(self.blocks)
        out = []
        for i, b in enumerate(self.blocks):
            upad = F.pad(b, (1, 1, 1, 1))
            if i:
                upad[:1, 1:-1] = self._edge(i, i - 1, False)
            if i + 1 < n:
                upad[-1:, 1:-1] = self._edge(i, i + 1, True)
            out.append(upad)
        return out

    def gather(self, device=None) -> torch.Tensor:
        """The whole field on ``device`` (default ``mesh[0]``); the blocks of
        the other shards count as gathered."""
        device = self.mesh[0] if device is None else device
        parts = [_move(b, self.mesh, i, 0, self.transfers, 'gather')
                 .to(device) for i, b in enumerate(self.blocks)]
        return torch.cat(parts, dim=-2)

    def split_like(self, x: torch.Tensor) -> 'RowBlocks':
        """A whole field on ``mesh[0]`` with this one's rows, cut back into
        its blocks (``'split'`` moves)."""
        offs = self.offsets
        return self.like([_move(x[..., offs[i]:offs[i + 1], :], self.mesh,
                                0, i, self.transfers, 'split')
                          for i in range(len(self.blocks))])


# ---- the orograph -----------------------------------------------------------


def orographic_updraft_from_dem_sharded(z_mat, res: float, wspeed, wdirn,
                                        min_updraft_val: float = 0.,
                                        mesh=None) -> RowBlocks:
    """Row-sharded DEM -> orographic updraft (the Horn stencils with one
    halo row a side). ``z_mat``: numpy or a tensor; ``wspeed`` and
    ``wdirn``: scalars. Returns the updraft as :class:`RowBlocks`, bitwise
    equal to ``fields.updraft.orographic_updraft_from_dem`` of the whole
    DEM cut into the blocks (``.gather()`` joins them)."""
    mesh = make_field_mesh() if mesh is None else tuple(mesh)
    nrow = z_mat.shape[0]
    n = len(mesh)
    if nrow < n:
        raise ValueError(f'{nrow} rows do not split over {n} shards')
    offsets = [i * nrow // n for i in range(n + 1)]
    z = RowBlocks.split(z_mat, offsets, mesh, Transfers(),
                        dtype=torch.float32)

    def updraft(zb):
        def scalar(v):
            return torch.as_tensor(v, dtype=torch.float32, device=zb.device)
        return orographic_updraft_from_dem(zb, res, scalar(wspeed),
                                           scalar(wdirn), min_updraft_val)

    return z.stencil(updraft)


# ---- the refined solve ---------------------------------------------------------


def plan_rows(shape, n: int):
    """Row offsets of ``n`` blocks of a ``shape`` grid, and the index S of
    the last level kept sharded: every block but the last holds a multiple
    of 2^(S+1) rows, so the transfers between levels 0..S+1 stay inside
    the blocks, and S is the deepest level whose blocks keep at least
    ``_MIN_BLOCK_ROWS`` rows (at most the one before the coarsest)."""
    nrow = shape[0]
    depth = hierarchy_depth(shape)
    if depth < 2:
        raise ValueError(f'a {shape} grid has one multigrid level: '
                         'nothing to shard')
    per = -(-nrow // n)
    last = 0
    while last + 2 < depth and per >> (last + 1) >= _MIN_BLOCK_ROWS:
        last += 1
    step = 2 ** (last + 1)
    block = -(-per // step) * step
    offsets = [i * block for i in range(n)] + [nrow]
    if offsets[n - 1] >= nrow:
        raise ValueError(f'{nrow} rows do not split over {n} shards in '
                         f'blocks of a multiple of {step} rows')
    return offsets, last


class BlockSegments(NamedTuple):
    """A sharded level's island layout: the labels as RowBlocks and each
    block's ``IslandSegments`` (None where the block has no island cell).
    ``potential.lap.island_sum`` calls :meth:`sum`."""
    labels: RowBlocks
    segs: list
    num: int

    def sum(self, x: RowBlocks) -> torch.Tensor:
        """Per-island float64 sums (num,) on ``mesh[0]``: each block's
        ``island_sum`` over its own island cells, summed in block order."""
        parts = {i: island_sum(b, seg) for i, (b, seg)
                 in enumerate(zip(x.blocks, self.segs)) if seg is not None}
        if not parts:
            return torch.zeros(self.num, dtype=torch.float64,
                               device=x.mesh[0])
        return _reduce(parts, x.mesh, x.transfers)


def _shard_level(planes: RowBlocks, mask: RowBlocks, labels: np.ndarray,
                 num: int) -> LapLevel:
    """A sharded level of ``planes`` and the Dirichlet ``mask``; the host
    ``labels`` of the level are cut into the same blocks."""
    dinv = planes.map(_diag_inv)
    notb = mask.map(lambda m: (~m).to(torch.float32))
    if num <= 1:
        return LapLevel(planes, planes, notb, dinv, None, None)
    offs = planes.offsets
    lab = RowBlocks.split(labels.astype(np.int64), offs, planes.mesh,
                          planes.transfers)
    seg = BlockSegments(lab, [
        island_segments(labels[offs[i]:offs[i + 1]], num, dev)
        if labels[offs[i]:offs[i + 1]].any() else None
        for i, dev in enumerate(planes.mesh)], num)
    planes_x = planes.stencil(_crossing_planes, lab)
    # z_I^T A z_I (lap.island_zaz), its partials summed in block order
    zaz = seg.sum(planes_x.map(lambda p: p.to(torch.float64).sum(0)))
    zaz[0] = 1.0
    return LapLevel(planes, planes_x, notb, dinv, seg,
                    1.0 / torch.clamp(zaz, min=1e-30))


def build_shard_levels(planes: RowBlocks, bmask: RowBlocks,
                       bmask_host: np.ndarray, labels: np.ndarray, num: int,
                       last: int) -> List[LapLevel]:
    """The hierarchy of ``build_lap_levels``: levels 0..``last`` sharded
    (their fields RowBlocks), the levels below them on ``mesh[0]``, built
    from the gathered level ``last + 1`` exactly as ``build_lap_levels``
    builds them. ``bmask_host`` and ``labels``: the host's copies of the
    mask and of the island labels, coarsened on the host level by
    level."""
    levels = []
    lab, bm = np.asarray(labels, np.int32), np.asarray(bmask_host, bool)
    mask = bmask
    for _ in range(last + 1):
        levels.append(_shard_level(planes, mask, lab, num))
        lab, bm = _host_coarsen_labels(lab, bm)
        planes = planes.map(_galerkin_coarsen)
        mask = mask.map(_coarsen_bmask)
    return levels + build_lap_levels(planes.gather(), mask.gather(), lab,
                                     num)


def solve_potential_refined_sharded(conductivity, bmask, bvals, mesh=None,
                                    tol: float = 1e-7, maxcycles: int = 60,
                                    stats=None):
    """Row-sharded ``potential.lap.solve_potential_refined``: its
    refinement, GCR and deflated V-cycle over row blocks (module
    docstring), on ``mesh`` (default: every visible card).

    ``conductivity``: numpy, or a tensor on ``mesh[0]``; ``bmask`` and
    ``bvals`` as ``boundary_masks`` gives them. Returns (potential float32
    as :class:`RowBlocks`, relative residual float). ``stats``, a dict,
    receives ``passes``, ``vcycles``, ``shards``, ``sharded_levels`` (the
    levels cut into blocks; the rest are on ``mesh[0]``) and
    ``transfers`` (:meth:`Transfers.summary` of the solve's moves)."""
    mesh = make_field_mesh() if mesh is None else tuple(mesh)
    transfers = Transfers()
    if torch.is_tensor(conductivity):
        cond_host = conductivity.detach().cpu().numpy()
    else:
        conductivity = np.asarray(conductivity, np.float32)
        cond_host = conductivity
    bmask = np.asarray(torch.as_tensor(bmask).cpu(), bool)
    bvals = np.asarray(torch.as_tensor(bvals).cpu(), np.float32)
    offsets, last = plan_rows(bmask.shape, len(mesh))
    cond = RowBlocks.split(conductivity, offsets, mesh, transfers,
                           dtype=torch.float32)
    bm = RowBlocks.split(bmask, offsets, mesh, transfers)
    bv = RowBlocks.split(bvals, offsets, mesh, transfers)
    labels, k = island_labels(cond_host > 0, bmask)
    planes_t = cond.stencil(weight_planes)
    levels = build_shard_levels(planes_t.stencil(symmetrize_planes), bm,
                                bmask, labels, k + 1, last)
    out, rrel, passes, cycles = _refine(planes_t, levels, bm, bv, labels, k,
                                        tol, maxcycles)
    if stats is not None:
        stats.update(passes=passes, vcycles=cycles, shards=len(mesh),
                     sharded_levels=last + 1,
                     transfers=transfers.summary())
    return out, rrel
