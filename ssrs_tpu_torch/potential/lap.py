"""Reference-exact directional potential on the device: difference-form
operator, Galerkin multigrid, float64 iterative refinement and island
deflation.

The PyTorch counterpart of ``ssrs_tpu/potential/lap.py`` (its module
docstring has the analysis). In short: the reference system's hard modes
are the *levels* of high-conductivity islands surrounded by
zero-conductivity plateaus, coupled only through the 1e-8 harmonic-mean
floor (ssrs/movmodel.py:442-447), so the condition number is ~1e9-1e10.
The solver answers that with

1. the **difference form** ``A u (i) = sum_d W_d(i) (u_i - u_{i+d})``
   (the same solution as the row-normalized ``(I - P) x = P_b b``, with
   constants annihilated exactly in any precision);
2. **iterative refinement**: the iterate is float64 and each residual
   applies the float32 true planes, upcast, to it in float64. The JAX
   package carries the iterate as a double-single pair because TPUs
   have no float64 (``ssrs_tpu/potential/ds.py``); the card has it, so
   the port has no ``ds.py``;
3. **island deflation**: the connected components of ``cond > 0`` that
   are not anchored to the Dirichlet perimeter are a near-null subspace,
   corrected per island at every level of the cycle and once more in
   every refinement pass;
4. **Galerkin coarse grids** with piecewise-constant prolongation and
   block-sum restriction, so the 1e-8/O(1) contrast survives coarsening;
5. truncated flexible **GCR** preconditioned by one deflated V-cycle.

The preconditioner (V-cycle, smoother, deflation, GCR) runs in float32,
as in JAX. Per-island sums run in float64 (the deflation divides by
``z^T A z ~ 1e-8``), in a fixed order (see :func:`island_sum`), so two
solves of one field on one device give the same bits.

The cycle, the GCR and the refinement take a field in one of three
kinds: a ``(nrow, ncol)`` tensor on one device; row blocks over several
(``parallel/fields.py``'s ``RowBlocks``, whose arithmetic runs block by
block); or a batch of C cases of one grid and one direction, a
``(C, nrow, ncol)`` tensor whose planes are ``(8, C, nrow, ncol)``
(:func:`solve_potential_refined_batch`). One code for all three. The few
operations that differ go through :func:`_each`, :func:`_total`,
:func:`_norm`, :func:`_spread`, :func:`_keep`, :func:`_apply_lap`,
:func:`island_sum` and :func:`_island_max`, which take the plain torch
call on a tensor and reduce per case on a batch.

A GCR iteration runs ~2,800 small kernels at 500x600, each launched
from Python at ~12 us of host time against ~1.4 us of device time. On a
CUDA tensor (one field or a batch) a solve captures the iteration once
as a CUDA graph and replays it (:class:`_GcrGraph`); row blocks and CPU
tensors run the same iteration function eagerly.

What the TPU needed and the card does not, and is left out: the tiled
label dictionary (XLA lowers ``segment_sum`` to a serial scatter on the
TPU), the parity-mask ``reduce_window`` and selector-matmul transfers
(TPU lane layout), the power-of-4 padding of the island count (XLA
recompiles), the batch's padding to its cases' maxima and the
row-sharding constraints. No matmul or convolution is left in the
solver, so TF32 cannot enter it whatever the backend flags say.

Reference semantics: ``MovModel.solve_sparse_linear_system``
(ssrs/movmodel.py:86-128), edge weights ``harmonic_mean/fac`` with the
east-column fac quirk (see ``solver.py``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..agents.moves import NEIGHBOR_DELTAS
from ..core.timing import count, read_host, span
from .solver import _DIRS, _on_device, _shift, weight_planes

_DELTAS = [(int(NEIGHBOR_DELTAS[m, 0]), int(NEIGHBOR_DELTAS[m, 1]))
           for m in _DIRS]
_DELTA_TO_K = {d: k for k, d in enumerate(_DELTAS)}

__all__ = ['solve_potential_refined', 'solve_potential_refined_batch',
           'weight_planes', 'symmetrize_planes', 'island_labels',
           'island_sound_mask', 'build_lap_levels', 'vcycle']


# ---- fields: one tensor, row blocks, or a batch of cases ----------------------


def _is_batch(x) -> bool:
    """Whether ``x`` is a batch of cases: a ``(C, nrow, ncol)`` tensor."""
    return torch.is_tensor(x) and x.dim() == 3


def _each(fn, x, *others):
    """``fn`` of a field (``others``: fields alike): a tensor's own call,
    or block by block."""
    return fn(x, *others) if torch.is_tensor(x) else x.map(fn, *others)


def _total(x) -> torch.Tensor:
    """The sum of a field's cells (row blocks: their partials, in block
    order, on the first device; a batch: each case's, shaped (C, 1, 1))."""
    if _is_batch(x):
        return torch.sum(x, dim=(-2, -1), keepdim=True)
    return torch.sum(x) if torch.is_tensor(x) else x.total()


def _norm(x) -> torch.Tensor:
    """The 2-norm of a field (row blocks: of their norms; a batch: each
    case's, shaped (C, 1, 1))."""
    if _is_batch(x):
        return torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
    return torch.linalg.vector_norm(x) if torch.is_tensor(x) else x.norm()


def _spread(c: torch.Tensor, labels):
    """``c[labels]``: a per-island vector spread over the cells."""
    return c[labels] if torch.is_tensor(labels) else labels.spread(c)


def _keep(active, new, old):
    """A batch's ``new`` where its case is ``active`` ((C, 1, 1) bool) and
    ``old`` where it has finished; any other field is ``new``."""
    return torch.where(active, new, old) if _is_batch(old) else new


def _fetch(x: torch.Tensor) -> np.ndarray:
    """``x`` on the host, the seconds the host waited counted as
    ``read_wait_s`` on the solve's ``potential.solve`` span."""
    return read_host(x, 'read_wait_s', on='potential.solve').numpy()


def _host(x) -> np.ndarray:
    """A per-case device value (a scalar, or a batch's (C, 1, 1)) on the
    host, shaped (cases,)."""
    return _fetch(x.reshape(-1))


# ---- operator ---------------------------------------------------------------


def symmetrize_planes(planes: torch.Tensor) -> torch.Tensor:
    """Pairwise-symmetrized edge weights ``W_sym = 0.5 (W_ij + W_ji)``.

    The reference's east-column fac quirk makes W nonsymmetric on the
    edges between the two easternmost columns, and symmetric everywhere
    else. The preconditioner hierarchy is built on the symmetrized
    operator, where deflation is an orthogonal projection at every
    level; the refinement's residuals use the true operator, which
    iterates the localized skew part away
    (``ssrs_tpu/potential/lap.py::symmetrize_planes``)."""
    out = []
    for k, (dr, dc) in enumerate(_DELTAS):
        kopp = _DELTA_TO_K[(-dr, -dc)]
        w_opp_n = _shift(planes[kopp], dr, dc)
        out.append(torch.where(planes[k] > 0.,
                               0.5 * (planes[k] + w_opp_n), 0.))
    return torch.stack(out)


def _apply_lap(planes: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A u = sum_d W_d * (u - shift_d(u)), in the dtype of ``u`` (the
    planes must share it). One pad, eight slices, JAX's op order. Row
    blocks frame each block with its neighbours' edge rows."""
    if not torch.is_tensor(u):
        return planes.map(_apply_lap_padded, u.padded())
    return _apply_lap_padded(planes, F.pad(u, (1, 1, 1, 1)))


def _apply_lap_padded(planes: torch.Tensor,
                      upad: torch.Tensor) -> torch.Tensor:
    """:func:`_apply_lap` of ``u`` given as ``upad``: u inside a one-cell
    frame of its neighbours, zero beyond the grid. A row block of a
    sharded field passes its neighbour blocks' edge rows in the frame
    (``parallel/fields.py``)."""
    nrow, ncol = planes.shape[-2:]
    u = upad[..., 1:1 + nrow, 1:1 + ncol]
    acc = torch.zeros_like(u)
    for k, (dr, dc) in enumerate(_DELTAS):
        nb = upad[..., dr + 1:dr + 1 + nrow, dc + 1:dc + 1 + ncol]
        acc = acc + planes[k] * (u - nb)
    return acc


def _crossing_planes(planes: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """``planes`` with island-internal edges (label > 0 on both ends, the
    same label) zeroed. Edges from or to the background (label 0) and
    between different labels are kept.

    The deflation sums the residual over an island through these edges
    only: in exact arithmetic the internal edges add nothing to an
    island's sum, but in float32 their O(1) terms leave cancellation
    noise that the division by ``z^T A z ~ 1e-8`` turns into
    O(10)-potential-unit corrections (``ssrs_tpu/potential/lap.py``,
    ``LapLevel.labels``). JAX masks on the fly to save TPU memory; the
    port keeps one masked stack per level (32 bytes a cell)."""
    nrow, ncol = labels.shape[-2:]
    labpad = F.pad(labels, (1, 1, 1, 1), value=-1)
    out = []
    for k, (dr, dc) in enumerate(_DELTAS):
        nb_lab = labpad[..., dr + 1:dr + 1 + nrow, dc + 1:dc + 1 + ncol]
        internal = (labels > 0) & (nb_lab == labels)
        out.append(torch.where(internal, 0., planes[k]))
    return torch.stack(out)


def _apply_lap_crossing(planes: torch.Tensor, labels: torch.Tensor,
                        u: torch.Tensor) -> torch.Tensor:
    """A u through crossing edges only (see :func:`_crossing_planes`)."""
    return _apply_lap(_crossing_planes(planes, labels), u)


# ---- transfers ---------------------------------------------------------------


def _pad_even(x: torch.Tensor, fill=0.) -> torch.Tensor:
    """Pad the last two dims at the end to even sizes."""
    nrow, ncol = x.shape[-2:]
    pr, pc = nrow % 2, ncol % 2
    if pr or pc:
        x = F.pad(x, (0, pc, 0, pr), value=fill)
    return x


def _galerkin_coarsen(planes: torch.Tensor) -> torch.Tensor:
    """Coarse difference-form planes: the coarse edge (I -> J) weight is
    the sum of the fine edges from block I into block J (RAP with
    piecewise-constant prolongation and block-sum restriction). Fine
    edges internal to a block vanish. Strided slices, summed in the
    order of fine direction, then block offset."""
    wp = _pad_even(planes)
    coarse = [None] * 8
    for k, (dr, dc) in enumerate(_DELTAS):
        for i in (0, 1):
            for j in (0, 1):
                di, dj = (i + dr) // 2, (j + dc) // 2
                if (di, dj) == (0, 0):
                    continue  # internal fine edge
                kc = _DELTA_TO_K[(di, dj)]
                term = wp[k, ..., i::2, j::2]
                coarse[kc] = term if coarse[kc] is None else coarse[kc] + term
    return torch.stack(coarse)


def _restrict(r: torch.Tensor) -> torch.Tensor:
    """Block-sum restriction (adjoint of piecewise-constant
    prolongation): each coarse cell sums its 2x2 block."""
    rp = _pad_even(r)
    *lead, m, n = rp.shape
    return rp.reshape(*lead, m // 2, 2, n // 2, 2).sum(dim=(-3, -1))


def _coarsen_bmask(bmask: torch.Tensor) -> torch.Tensor:
    """A coarse cell is Dirichlet if any fine cell of its block is (the
    coarse correction must vanish there)."""
    return _restrict(bmask.to(torch.float32)) > 0.


def _prolong_pc(e: torch.Tensor, fine_shape: Tuple[int, int]) -> torch.Tensor:
    """Piecewise-constant prolongation, cropped to the fine shape."""
    out = e.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return out[..., :fine_shape[-2], :fine_shape[-1]]


# ---- islands -----------------------------------------------------------------


def island_labels(conductivity: np.ndarray,
                  bmask: np.ndarray) -> Tuple[np.ndarray, int]:
    """Label the near-decoupled components whose levels are near-null
    modes (host, scipy; a copy of the JAX package's function).

    A component of ``cond > 0`` (8-connectivity, matching the stencil)
    is a floating island unless it contains or touches a Dirichlet cell
    that itself has ``cond > 0``; then it is *anchored*, and excluded.
    The JAX package's opt-in weak-plateau labels, off in every solve,
    are not ported.

    ``conductivity`` may be the bool mask ``cond > 0`` itself. Returns
    (labels int32 (nrow, ncol): 0 = anchored or ``cond <= 0``, 1..K
    floating islands; K).
    """
    from scipy import ndimage
    pos = np.asarray(conductivity)
    pos = pos if pos.dtype == np.bool_ else pos > 0.
    bmask = np.asarray(bmask, bool)
    structure = np.ones((3, 3), bool)
    lab, nlab = ndimage.label(pos, structure=structure)
    strong_anchor = ndimage.binary_dilation(bmask & pos, structure=structure)
    anchored = np.unique(lab[strong_anchor & (lab > 0)])
    # O(N) relabel: anchored/background -> 0, floating islands -> 1..K
    keep = np.ones(nlab + 1, bool)
    keep[0] = False
    keep[anchored] = False
    newid = np.where(keep, np.cumsum(keep), 0).astype(np.int32)
    return newid[lab], int(keep.sum())


def batch_island_labels(pos: np.ndarray, bmask: np.ndarray
                        ) -> Tuple[np.ndarray, int]:
    """:func:`island_labels` of each case of a batch, ``pos`` the
    (C, nrow, ncol) bool ``cond > 0``: case c's island j takes the label
    offset_c + j, where offset_c counts the islands of the cases before
    it; every background stays 0. Returns (labels int32, island count)."""
    labels = np.zeros(pos.shape, np.int32)
    k = 0
    for c in range(pos.shape[0]):
        lab, kc = island_labels(pos[c], bmask)
        labels[c] = np.where(lab > 0, lab + k, 0)
        k += kc
    return labels, k


def _host_coarsen_labels(labels: np.ndarray, bmask: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Host replica of the level coarsening: coarse Dirichlet = any fine
    Dirichlet in the 2x2 block; coarse label = max fine label, zeroed on
    coarse Dirichlet cells. Where distinct islands merge into one cell at
    deep levels, the union is still a valid 1-D deflation subspace. A
    batch's ``(C, m, n)`` labels coarsen case by case against the shared
    mask."""
    *lead, m, n = labels.shape
    mp, npad = m + (m % 2), n + (n % 2)
    lab = np.zeros((*lead, mp, npad), labels.dtype)
    lab[..., :m, :n] = labels
    bm = np.zeros((mp, npad), bool)
    bm[:m, :n] = bmask
    bm_c = (bm[::2, ::2] | bm[1::2, ::2] | bm[::2, 1::2] | bm[1::2, 1::2])
    lab_c = np.maximum(np.maximum(lab[..., ::2, ::2], lab[..., 1::2, ::2]),
                       np.maximum(lab[..., ::2, 1::2], lab[..., 1::2, 1::2]))
    return np.where(bm_c, 0, lab_c).astype(labels.dtype), bm_c


def island_sound_mask(labels_np: np.ndarray, num: int) -> np.ndarray:
    """Per-island indicator (float32, length ``num``) of the islands that
    never occupy the two easternmost columns, where the east-column fac
    quirk makes W nonsymmetric. Only for these is the outer island
    correction ``z^T r / z^T A z`` an orthogonal projection; for strip
    islands it is oblique and explodes, so they are left to the
    symmetrized per-level deflation and GCR. Index 0 (background) is 0.
    A batch's ``(C, nrow, ncol)`` labels (each case's islands numbered
    after the previous case's) give every case's islands at once."""
    sound = np.zeros(num, np.float32)
    k = int(labels_np.max())
    if k:
        strip = np.unique(labels_np[..., -2:])
        sound[1:k + 1] = 1.0
        sound[strip[strip > 0]] = 0.0
    return sound


class IslandSegments(NamedTuple):
    """One level's per-island reduction layout, built on the host. A
    batch's labels are (C, nrow, ncol), each case's islands numbered after
    the previous case's, every case's background 0."""
    labels: torch.Tensor   # (nrow, ncol) int64 island label per cell
    order: torch.Tensor    # (cells with label > 0,) int64 flat indices,
    #                        sorted by label
    offsets: torch.Tensor  # (num + 1,) int64: island I owns
    #                        order[offsets[I]:offsets[I + 1]]; island 0
    #                        (the background) owns none


def island_segments(labels: np.ndarray, num: int,
                    device) -> IslandSegments:
    """The :class:`IslandSegments` of an int label map with labels < num."""
    flat = np.asarray(labels).ravel().astype(np.int64)
    cells = np.flatnonzero(flat)
    order = cells[np.argsort(flat[cells], kind='stable')]
    counts = np.bincount(flat[cells], minlength=num)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return IslandSegments(
        labels=torch.as_tensor(flat.reshape(labels.shape), device=device),
        order=torch.as_tensor(order, device=device),
        offsets=torch.as_tensor(offsets, device=device))


def island_sum(x: torch.Tensor, seg: IslandSegments) -> torch.Tensor:
    """Per-island float64 sums of a cell field, shape (num,), 0 at the
    background.

    The cells are gathered in the host-sorted island order and reduced
    segment by segment (``torch.segment_reduce`` with offsets: on CUDA
    a CUB segmented reduction, each island summed in a fixed order by
    one block). ``index_add_``, ``scatter_add_`` and ``bincount`` on
    CUDA floats add with atomics in an order that changes from run to
    run, and the deflation divides these sums by ``z^T A z ~ 1e-8``: a
    last-bit change there moves the solve along its near-null mode. The
    offsets form also skips the length checks that would read the
    device from the host in every call. Row blocks carry a layout a
    block (``parallel/fields.py``), whose sums add in block order."""
    if not isinstance(seg, IslandSegments):
        return seg.sum(x)
    vals = x.reshape(-1)[seg.order].to(torch.float64)
    return torch.segment_reduce(vals, 'sum', offsets=seg.offsets)


def _island_max(c: torch.Tensor, seg) -> torch.Tensor:
    """The largest entry of a non-negative per-island vector (0 at the
    background): a batch's per case, shaped (C,), through its cells (every
    island owns a cell of the level its layout is of)."""
    if isinstance(seg, IslandSegments) and seg.labels.dim() == 3:
        return c[seg.labels].amax(dim=(-2, -1))
    return c.max()


def island_zaz(planes: torch.Tensor, seg: IslandSegments) -> torch.Tensor:
    """z_I^T A z_I, float64 (num,): the total weight of the edges from
    the cells of island I to cells with another label. Index 0
    (background, never used) is 1."""
    total = _crossing_planes(planes, seg.labels).to(torch.float64).sum(0)
    zaz = island_sum(total, seg)
    zaz[0] = 1.0
    return torch.clamp(zaz, min=1e-30)


# ---- level hierarchy -----------------------------------------------------------


_MIN_SIZE = 4  # coarsen until min(shape) <= _MIN_SIZE


class LapLevel(NamedTuple):
    """One level of the V-cycle. On a row-sharded level the four fields
    are row blocks and ``seg`` has a layout a block
    (``parallel/fields.py``)."""
    planes: torch.Tensor    # (8, nrow, ncol) f32 difference-form weights
    planes_x: torch.Tensor  # the same with island-internal edges zeroed
    notb: torch.Tensor      # (nrow, ncol) f32, 1 where NOT Dirichlet
    dinv: torch.Tensor      # (nrow, ncol) f32, 1/sum_d W_d (0 where 0)
    seg: Optional[IslandSegments]  # None when the field has no islands
    zaz_inv: Optional[torch.Tensor]  # (num,) f64 1/(z_I^T A z_I)

    @property
    def shape(self):
        return self.planes.shape[-2:]


def _diag_inv(planes: torch.Tensor) -> torch.Tensor:
    """1 / sum_d W_d, 0 where the sum is 0."""
    diag = torch.sum(planes, dim=0)
    return torch.where(diag > 0., 1. / torch.where(diag > 0., diag, 1.), 0.)


def hierarchy_depth(shape) -> int:
    """The number of levels :func:`build_lap_levels` builds for a grid of
    ``shape``."""
    m, n = shape
    depth = 1
    while min(m, n) > _MIN_SIZE:
        m, n = (m + 1) // 2, (n + 1) // 2
        depth += 1
    return depth


def build_lap_levels(planes: torch.Tensor, bmask: torch.Tensor,
                     labels: np.ndarray, num: int) -> List[LapLevel]:
    """The V-cycle's level hierarchy: Galerkin coarsening of ``planes``
    until ``min(shape) <= _MIN_SIZE`` (8 levels at 500x600), with each
    level's island labels coarsened on the host. ``num`` is the island
    count plus one; ``num == 1`` builds no island structures. A batch's
    planes are (8, C, nrow, ncol) and its labels (C, nrow, ncol); the
    mask is shared."""
    levels = []
    mask = bmask
    lab = np.asarray(labels, np.int32)
    bm = bmask.cpu().numpy()
    while True:
        dinv = _diag_inv(planes)
        seg = zaz_inv = None
        planes_x = planes
        if num > 1:
            seg = island_segments(lab, num, planes.device)
            planes_x = _crossing_planes(planes, seg.labels)
            zaz_inv = 1.0 / island_zaz(planes, seg)
        levels.append(LapLevel(planes=planes, planes_x=planes_x,
                               notb=(~mask).to(torch.float32), dinv=dinv,
                               seg=seg, zaz_inv=zaz_inv))
        if min(lab.shape[-2:]) <= _MIN_SIZE:
            break
        lab, bm = _host_coarsen_labels(lab, bm)
        planes = _galerkin_coarsen(planes)
        mask = _coarsen_bmask(mask)
    return levels


# ---- cycle -----------------------------------------------------------------------


_OMEGA = 0.85         # Jacobi damping
_NU1 = _NU2 = 2       # pre- and post-smoothing sweeps
_COARSE_SWEEPS = 32   # sweeps on the coarsest level
_KAPPA = 2.0          # over-correction of the prolongated coarse update


def _smooth(level: LapLevel, u: torch.Tensor, rhs: torch.Tensor,
            nsweeps: int) -> torch.Tensor:
    """Damped diagonally-scaled Jacobi on the difference form."""
    w = (_OMEGA * level.notb) * level.dinv
    for _ in range(nsweeps):
        r = rhs - _apply_lap(level.planes, u)
        u = u + w * r
    return u


def _deflate(level: LapLevel, u: torch.Tensor,
             rhs: torch.Tensor) -> torch.Tensor:
    """Island-subspace correction at this level,
    ``u += z_I (z_I^T r)/(z_I^T A z_I)`` for every island, with the
    residual taken through crossing edges only (:func:`_crossing_planes`).
    The coefficient of the background is 0: its segment is empty."""
    if level.seg is None:
        return u
    r = (rhs - _apply_lap(level.planes_x, u)) * level.notb
    c = (island_sum(r, level.seg) * level.zaz_inv).to(u.dtype)
    return u + _spread(c, level.seg.labels) * level.notb


def vcycle(levels: List[LapLevel], rhs: torch.Tensor,
           u0: torch.Tensor) -> torch.Tensor:
    """One deflated V-cycle for A u = rhs with u clamped (0 correction)
    at Dirichlet cells. ``_KAPPA`` over-corrects the prolongated coarse
    update: the piecewise-constant Galerkin operator is ~2x too stiff
    for smooth modes (``ssrs_tpu/potential/lap.py::vcycle``). Where a
    row-sharded level meets one on a single device, the restricted
    residual is gathered onto the first device and the correction cut
    back into the blocks."""
    return _cycle(levels, 0, u0, rhs)


def _cycle(levels: List[LapLevel], idx: int, u: torch.Tensor,
           rhs: torch.Tensor) -> torch.Tensor:
    """The V-cycle from level ``idx`` down. A module function, not a
    closure: a closure that calls itself is a reference cycle, which
    would keep a finished solve's levels (~5 GB at 6667^2) alive until
    Python's cyclic collector runs."""
    level = levels[idx]
    if idx == len(levels) - 1:
        u = _smooth(level, u, rhs, _COARSE_SWEEPS)
        return _deflate(level, u, rhs)
    u = _smooth(level, u, rhs, _NU1)
    u = _deflate(level, u, rhs)
    r = (rhs - _apply_lap(level.planes, u)) * level.notb
    coarse = levels[idx + 1]
    r_c = _each(_restrict, r)
    blocks = None
    if torch.is_tensor(coarse.notb) and not torch.is_tensor(r_c):
        blocks, r_c = r_c, r_c.gather()
    r_c = r_c * coarse.notb
    e_c = _cycle(levels, idx + 1, _each(torch.zeros_like, r_c), r_c)
    if blocks is not None:
        e_c = blocks.split_like(e_c)
    pe = _each(lambda e, f: _prolong_pc(e, f.shape), e_c, u)
    u = u + _KAPPA * pe * level.notb
    u = _deflate(level, u, rhs)
    return _smooth(level, u, rhs, _NU2)


# ---- Krylov --------------------------------------------------------------------


_GCR_K = 3  # truncated-GCR history depth (Orthomin(k))
_REFINE_PASSES = 30  # budget of float64 refinement passes per solve
# a single CUDA tensor field (2-D or a batch) replays each GCR iteration
# as a CUDA graph; tests set this False to run the eager loop on the card
_GRAPHS = True


class _Gcr(NamedTuple):
    """The state a GCR iteration carries to the next. The history is
    fixed slots (``_GCR_K`` by default) of directions ``zs`` and their
    images ``qs``, oldest first, as JAX's shifted buffer: an empty slot
    holds exact zeros, whose ``beta`` is +-0 and leaves ``z`` and ``q`` as
    they are in value. ``rn_prev`` comes before ``rn``: :class:`_GcrGraph`
    copies a new state into the old in this order, and a single field's
    new ``rn_prev`` is the old ``rn``."""
    x: torch.Tensor
    zs: tuple
    qs: tuple
    rn_prev: torch.Tensor
    rn: torch.Tensor
    active: Optional[torch.Tensor]  # a batch's (C, 1, 1) bool, else None

    def fields(self) -> list:
        """The state's fields in copying order (``active`` where set)."""
        out = [self.x, *self.zs, *self.qs, self.rn_prev, self.rn]
        return out if self.active is None else out + [self.active]


def _snorm(top: LapLevel, r):
    """The norm of the diagonally scaled residual ``D^-1 r``."""
    return _norm(r * top.dinv)


def _gcr_start(levels: List[LapLevel], rhs, active=None,
               depth: int = _GCR_K) -> _Gcr:
    """The state before the first iteration of a GCR solve of ``rhs``
    that keeps ``depth`` directions: x and the history zero, ``rn =
    rn_prev = snorm(rhs)``; every field its own tensor."""
    zero = lambda: _each(torch.zeros_like, rhs)  # noqa: E731
    rn = _snorm(levels[0], rhs)
    return _Gcr(x=zero(), zs=tuple(zero() for _ in range(depth)),
                qs=tuple(zero() for _ in range(depth)), rn_prev=rn.clone(),
                rn=rn, active=active)


def _gcr_iteration(levels: List[LapLevel], rhs, s: _Gcr, go) -> _Gcr:
    """One GCR iteration of A x = rhs from the state ``s``: the residual,
    one deflated V-cycle, q = A z, the orthogonalization against the
    history, the update of x and the next scaled residual norm. ``go``,
    a batch's (C, 1, 1) bool, marks the cases that take the iteration:
    the others keep x and their norms (:func:`_keep`); a case that has
    stopped never goes on again, so what its history becomes does not
    matter. Reads nothing back from the device."""
    top = levels[0]
    notb = top.notb
    dinv2 = top.dinv * top.dinv

    def sdot(a, b):
        return _total((a * dinv2) * b)

    r = (rhs - _apply_lap(top.planes, s.x)) * notb
    z = vcycle(levels, r, _each(torch.zeros_like, s.x)) * notb
    q = _apply_lap(top.planes, z) * notb
    for zi, qi in zip(s.zs, s.qs):
        beta = sdot(q, qi)
        z = z - beta * zi
        q = q - beta * qi
    nrm2 = sdot(q, q)
    inv = torch.where(nrm2 > 0, torch.rsqrt(nrm2 + 1e-38), 0.)
    z, q = z * inv, q * inv
    alpha = sdot(r, q)
    x = _keep(go, s.x + alpha * z, s.x)
    rn = _snorm(top, (rhs - _apply_lap(top.planes, x)) * notb)
    return _Gcr(x=x, zs=s.zs[1:] + (z,), qs=s.qs[1:] + (q,),
                rn_prev=_keep(go, s.rn, s.rn_prev), rn=_keep(go, rn, s.rn),
                active=go if _is_batch(x) else s.active)


def _write_state(bufs: _Gcr, new: _Gcr) -> None:
    """Copy the state ``new`` into the buffers ``bufs`` (the state it
    was computed from), in the order of :meth:`_Gcr.fields`: the history
    shifts oldest first, and a single field's new ``rn_prev``, the old
    ``rn``, is copied before ``rn`` is overwritten."""
    for buf, val in zip(bufs.fields(), new.fields()):
        buf.copy_(val)


def _takes_graph(field) -> bool:
    """Whether a solve of ``field``'s kind replays its GCR iterations as a
    CUDA graph: a tensor on a CUDA device, one field or a batch. CPU
    tensors and row blocks run the same iteration eagerly."""
    return _GRAPHS and torch.is_tensor(field) and field.is_cuda


class _GcrGraph:
    """One GCR iteration (:func:`_gcr_iteration`) over a solve's
    ``levels``, captured once as a CUDA graph on buffers allocated once:
    each replay runs the iteration's kernels (~2,800 at 500x600) from the
    buffers and copies the new state into them, with no launch from
    Python. ``like`` is a field of the solve's shape and device, ``depth``
    the directions the GCR keeps. Nothing but the solve keeps it: the
    graph's memory pool goes with it."""

    def __init__(self, levels: List[LapLevel], like: torch.Tensor,
                 depth: int = _GCR_K):
        self.levels = levels  # the graph reads their memory
        self.rhs = torch.zeros_like(like, dtype=torch.float32)
        batch = _is_batch(like)
        self.go = torch.ones(like.shape[0], 1, 1, dtype=torch.bool,
                             device=like.device) if batch else None
        self.state = _gcr_start(levels, self.rhs,
                                self.go.clone() if batch else None, depth)
        self.graph = torch.cuda.CUDAGraph()
        with span('potential.capture'):
            # a stream of the field's device, which need not be the
            # current one; 'thread_local': CUDA calls of other threads (a
            # profiler's) do not break the capture
            with torch.cuda.graph(self.graph,
                                  stream=torch.cuda.Stream(like.device),
                                  capture_error_mode='thread_local'):
                _write_state(self.state, _gcr_iteration(
                    levels, self.rhs, self.state, self.go))

    def start(self, rhs: torch.Tensor, active) -> _Gcr:
        """The state of a GCR solve of ``rhs`` from ``active``, written
        into the buffers (:func:`_gcr_start`)."""
        s = self.state
        self.rhs.copy_(rhs)
        for buf in (s.x, *s.zs, *s.qs):
            buf.zero_()
        s.rn.copy_(_snorm(self.levels[0], self.rhs))
        s.rn_prev.copy_(s.rn)
        if active is not None:
            s.active.copy_(active)
        return s

    def step(self, s: _Gcr, go) -> _Gcr:
        """:func:`_gcr_iteration` of the buffers' state, in place."""
        if self.go is not None:
            self.go.copy_(go)
        self.graph.replay()
        return s


def _gcr_solve(levels: List[LapLevel], rhs: torch.Tensor, maxiter: int,
               tol_abs: torch.Tensor, active=None, graph=None,
               depth: int = _GCR_K
               ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Solve A x = rhs (x clamped 0 at Dirichlet cells) by truncated
    flexible GCR, ``depth`` directions kept, preconditioned with one
    deflated V-cycle per iteration (:func:`_gcr_iteration`). Inner
    products are taken in the D^-1-weighted norm, so plateau rows (D ~
    1e-8) are not invisible next to island rows (D ~ 1).

    With ``graph`` (a :class:`_GcrGraph` of ``levels``, which holds its
    own depth) each iteration is a replay of it, else the iteration runs
    eagerly. The exit test reads one device value per iteration, the only
    host sync of an iteration: each iteration (the span
    ``potential.iteration``) ends with the next one's test.

    On a batch the test is per case, as under JAX's ``vmap`` of the
    loop: the loop runs while any case goes on, and a case that has
    stopped keeps its iterate and its norms. ``active`` ((C, 1, 1) bool)
    marks the cases that start at all. Returns (x, scaled residual norm,
    iterations = V-cycles, per case as an int array); with ``graph``, x
    and the norm are its buffers, overwritten by its next solve."""
    if graph is None:
        s = _gcr_start(levels, rhs, active, depth)
        step = lambda s, go: _gcr_iteration(levels, rhs, s, go)  # noqa: E731
    else:
        s = graph.start(rhs, active)
        step = graph.step
    its = np.zeros(s.rn.numel(), np.int64)
    it = 0

    def exit_test():
        """(go, go on the host): the cases that run iteration ``it``;
        every case still going has run all ``it`` before it."""
        go = s.rn > tol_abs
        if it >= 8:
            # exit at the float32 floor: past the slow start (~0.97 per
            # iteration on hard fields), an iteration must gain 0.5%
            go = go & (s.rn < 0.995 * s.rn_prev)
        if s.active is not None:
            go = go & s.active
        return go, _host(go)

    stop = np.zeros(s.rn.numel(), bool)
    go, going = exit_test() if maxiter > 0 else (None, stop)
    while going.any():
        with span('potential.iteration'):
            its += going
            s = step(s, go)
            it += 1
            go, going = exit_test() if it < maxiter else (go, stop)
    return s.x, s.rn, its


# ---- refined solve -------------------------------------------------------------


def _solve_refined_core(cond: torch.Tensor, bmask: torch.Tensor,
                        bvals: torch.Tensor, labels: np.ndarray, k: int,
                        tol: float, maxcycles: int, init=None,
                        depth: int = _GCR_K
                        ) -> Tuple[torch.Tensor, float, int, int]:
    """Returns (potential f32, rrel, refinement passes, V-cycles)."""
    planes_t = weight_planes(cond)
    # the preconditioner hierarchy on the SYMMETRIZED operator; the
    # refinement residuals use the TRUE planes, so the solution solves
    # the reference's system
    with span('potential.levels'):
        levels = build_lap_levels(symmetrize_planes(planes_t), bmask,
                                  labels, k + 1)
    u0 = None
    if init is not None:
        # warm start, sanitized so a pathological prior solve can only
        # cost iterations, never poison this one
        init = torch.as_tensor(init, dtype=torch.float32, device=cond.device)
        u0 = torch.where(bmask, bvals,
                         torch.where(torch.isfinite(init), init, 500.))
    return _refine(planes_t, levels, bmask, bvals, labels, k, tol,
                   maxcycles, u0, depth)


def _refine(planes_t, levels: List[LapLevel], bmask, bvals,
            labels: np.ndarray, k: int, tol: float, maxcycles: int,
            u0=None, depth: int = _GCR_K):
    """The float64 refinement of the potential from the TRUE planes
    ``planes_t``, each pass a GCR solve over ``levels`` that keeps
    ``depth`` directions, from ``u0`` (by default the cold start); the
    fields are tensors on one device, row blocks, or a batch (``bvals``
    then (C, nrow, ncol)). On a CUDA tensor the first pass that runs
    captures one GCR iteration as a CUDA graph (the span
    ``potential.capture``), which every iteration of every pass replays
    (the counter ``graph_replays``); it is dropped, with its memory, when
    this returns. Returns (potential f32, rrel, refinement passes,
    V-cycles): numbers, or for a batch arrays of one per case."""
    num = k + 1
    top = levels[0]
    planes_t64 = planes_t.to(torch.float64)
    notb64 = top.notb.to(torch.float64)
    dinv64 = top.dinv.to(torch.float64)
    u0_cold = _each(lambda m, v: torch.where(m, v, 500.), bmask, bvals)
    if u0 is None:
        u0 = u0_cold
    batch = _is_batch(u0_cold)

    def resid(u):
        return -_apply_lap(planes_t64, u) * notb64

    # all norms are of the diagonally SCALED residual D^-1 r (potential
    # units): the error has sensitivity ~1/D to the raw residual in
    # plateau rows (D ~ 8e-8) and island rows alike
    def scaled_norm(r):
        return _norm(r * dinv64)

    # convergence is judged against the COLD start's residual, so tol and
    # rrel (and the 5e-3 fallback threshold) mean the same with a warm
    # start
    scale = _host(scaled_norm(resid(u0_cold.to(torch.float64)))) + 1e-30
    target = tol * scale
    # the floor of each pass's GCR tolerance: a number, or per case
    floor = torch.as_tensor(0.5 * target, device=u0_cold.device).view(
        -1, 1, 1) if batch else 0.5 * float(target[0])
    lev_target = 1e-4  # island level-error estimate, potential units
    if k:
        sound = torch.as_tensor(island_sound_mask(labels, num),
                                dtype=torch.float64,
                                device=top.zaz_inv.device)

    def island_coeff(r):
        """Sound-island level-error estimates z^T r / z^T A z (zero for
        the background and east-strip islands, whose quotient is
        oblique; see island_sound_mask)."""
        return island_sum(r, top.seg) * top.zaz_inv * sound

    u = u0.to(torch.float64)
    n = scale.shape[0]
    graph = None  # captured when the first pass starts (_GcrGraph)
    lev = np.full(n, np.inf)
    rn, best = scale.copy(), scale.copy()
    stall, passes, cycles = (np.zeros(n, np.int64) for _ in range(3))
    # each pass: one GCR solve of the correction in float32, then the
    # outer island correction over sound islands, then the float64
    # residual; a case exits on convergence, on the pass budget, or once
    # no pass in its last 3 set a new best (<= 0.9x) residual (the outer
    # refinement converges non-monotonically on east-strip fields). A
    # batch runs while any case goes on, a finished case's potential
    # kept (:func:`_keep`); one host read a pass, for every case.
    while True:
        going = (passes < _REFINE_PASSES) & (
            (rn > target) | (lev > lev_target)) & (stall < 3)
        if not going.any():
            break
        if graph is None and _takes_graph(u0_cold):
            graph = _GcrGraph(levels, u0_cold, depth)
        with span('potential.pass'):
            active = torch.as_tensor(going, device=u.device).view(
                -1, 1, 1) if batch else None
            r = resid(u)
            tol_abs = torch.clamp(0.02 * scaled_norm(r), min=floor)
            delta, _, its = _gcr_solve(levels, r.to(torch.float32),
                                       maxcycles, tol_abs.to(torch.float32),
                                       active, graph, depth=depth)
            cycles += its
            # the GCR's loop turns: a batch's case that goes on has run
            # every turn
            count('iterations', int(its.max()), on='potential.solve')
            if graph is not None:
                count('graph_replays', int(its.max()), on='potential.solve')
            u_new = u + (delta * top.notb).to(torch.float64)
            if k:
                u_new = u_new + _spread(island_coeff(resid(u_new)),
                                        top.seg.labels) * notb64
            u = _keep(active, u_new, u)
            r = resid(u)
            lev_t = _island_max(island_coeff(r).abs(), top.seg) if k else \
                torch.zeros(n, dtype=torch.float64, device=u0_cold.device)
            rn_t, lev_t = _fetch(torch.stack([scaled_norm(r).reshape(-1),
                                              lev_t.reshape(-1)]))
        rn = np.where(going, rn_t, rn)
        lev = np.where(going, lev_t, lev)
        stall = np.where(going, np.where(rn < 0.9 * best, 0, stall + 1),
                         stall)
        best = np.minimum(best, rn)
        passes += going

    out = _each(lambda m, v, a: torch.where(m, v.to(torch.float64), a).to(
        torch.float32), bmask, bvals, u)
    rrel = rn / scale
    if batch:
        return out, rrel, passes, cycles
    return out, float(rrel[0]), int(passes[0]), int(cycles[0])


def solve_potential_refined(conductivity, bmask, bvals, tol: float = 1e-7,
                            maxcycles: int = 60, init=None, device=None,
                            stats=None, depth: int = _GCR_K):
    """Solve the reference directional-potential system on a device.
    Returns (potential float32 (nrow, ncol) tensor, relative residual
    float).

    A tensor conductivity is solved on its own device; a numpy one on
    ``device``, which it then requires. ``bmask`` and ``bvals`` (numpy or
    tensors, as ``boundary_masks`` gives them) follow it there. Host work
    per solve is one ``scipy.ndimage.label`` of ``cond > 0`` and the
    per-level island layouts. ``tol`` is the target of the scaled
    residual relative to the cold start's, ``maxcycles`` the V-cycle
    budget of one GCR solve (at most ``_REFINE_PASSES`` refinement passes
    run).
    ``init`` optionally warm-starts the refinement (non-finite values
    are replaced); ``depth`` is the number of directions each GCR solve
    keeps. ``stats``, a dict, receives ``passes`` (refinement passes) and
    ``vcycles``."""
    with span('potential.solve'):
        cond = _on_device(conductivity, device, 'solve_potential_refined')
        bmask = torch.as_tensor(bmask, device=cond.device).to(torch.bool)
        bvals = torch.as_tensor(bvals, device=cond.device).to(torch.float32)
        with span('potential.labels'):
            labels, k = island_labels(_fetch(cond > 0), _fetch(bmask))
        pot, rrel, passes, cycles = _solve_refined_core(
            cond, bmask, bvals, labels, k, tol, maxcycles, init, depth)
    if stats is not None:
        stats.update(passes=passes, vcycles=cycles)
    return pot, rrel


def solve_potential_refined_batch(conductivities, bmask, bvals,
                                  tol: float = 1e-7, maxcycles: int = 60,
                                  device=None, stats=None, init=None,
                                  depth: int = _GCR_K):
    """The refined solve of C conductivity fields of one grid and one
    track direction, as one batch: every operation of a V-cycle, a GCR
    iteration and a refinement pass runs once for all C cases.

    The semantics of the JAX package's ``_solve_refined_batch_jit`` (a
    ``vmap`` of the single solve): each case runs its own loops and exit
    tests, a finished case is held while the others go on. A case's
    answer differs from its single solve by float32 reduction-order
    noise only: its islands keep their own sums, in the single solve's
    order (:func:`island_sum`), but the stencil sums run over a larger
    tensor.

    ``conductivities``: a (C, nrow, ncol) tensor, a sequence of such
    fields (tensors or numpy), solved on their device, or numpy on
    ``device``, which it then requires. ``bmask`` and ``bvals`` are
    shared; ``init`` and ``depth`` are :func:`solve_potential_refined`'s,
    ``init`` one field a case. Returns (potentials float32 (C, nrow,
    ncol) tensor, rrel float64 (C,) numpy). ``stats``, a dict, receives
    per-case lists ``passes`` and ``vcycles``."""
    with span('potential.solve'):
        if torch.is_tensor(conductivities):
            cond = conductivities.to(torch.float32)
        else:
            fields = list(conductivities)
            dev = fields[0].device if torch.is_tensor(fields[0]) else device
            cond = torch.stack([_on_device(c, dev,
                                           'solve_potential_refined_batch')
                                for c in fields])
        n_cases = cond.shape[0]
        bmask = torch.as_tensor(bmask, device=cond.device).to(torch.bool)
        bvals = torch.as_tensor(bvals, device=cond.device).to(torch.float32)
        with span('potential.labels'):
            labels, k = batch_island_labels(_fetch(cond > 0), _fetch(bmask))
        pots, rrel, passes, cycles = _solve_refined_core(
            cond, bmask, bvals.expand(n_cases, -1, -1), labels, k, tol,
            maxcycles, init, depth)
    if stats is not None:
        stats.update(passes=passes.tolist(), vcycles=cycles.tolist())
    return pots, rrel
