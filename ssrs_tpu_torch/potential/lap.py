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

What the TPU needed and the card does not, and is left out: the tiled
label dictionary (XLA lowers ``segment_sum`` to a serial scatter on the
TPU), the parity-mask ``reduce_window`` and selector-matmul transfers
(TPU lane layout), the power-of-4 padding of the island count (XLA
recompiles), the batched multi-case solve and the row-sharding
constraints. No matmul or convolution is left in the solver, so TF32
cannot enter it whatever the backend flags say.

Reference semantics: ``MovModel.solve_sparse_linear_system``
(ssrs/movmodel.py:86-128), edge weights ``harmonic_mean/fac`` with the
east-column fac quirk (see ``solver.py``).
"""

from __future__ import annotations

from collections import deque
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..agents.moves import NEIGHBOR_DELTAS
from .solver import _DIRS, _shift, weight_planes

_DELTAS = [(int(NEIGHBOR_DELTAS[m, 0]), int(NEIGHBOR_DELTAS[m, 1]))
           for m in _DIRS]
_DELTA_TO_K = {d: k for k, d in enumerate(_DELTAS)}

__all__ = ['solve_potential_refined', 'weight_planes', 'symmetrize_planes',
           'island_labels', 'island_sound_mask', 'build_lap_levels',
           'vcycle']


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
    planes must share it). One pad, eight slices, JAX's op order."""
    nrow, ncol = u.shape
    upad = F.pad(u, (1, 1, 1, 1))
    acc = torch.zeros_like(u)
    for k, (dr, dc) in enumerate(_DELTAS):
        nb = upad[dr + 1:dr + 1 + nrow, dc + 1:dc + 1 + ncol]
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
    nrow, ncol = labels.shape
    labpad = F.pad(labels, (1, 1, 1, 1), value=-1)
    out = []
    for k, (dr, dc) in enumerate(_DELTAS):
        nb_lab = labpad[dr + 1:dr + 1 + nrow, dc + 1:dc + 1 + ncol]
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
                term = wp[k, i::2, j::2]
                coarse[kc] = term if coarse[kc] is None else coarse[kc] + term
    return torch.stack(coarse)


def _restrict(r: torch.Tensor) -> torch.Tensor:
    """Block-sum restriction (adjoint of piecewise-constant
    prolongation): each coarse cell sums its 2x2 block."""
    rp = _pad_even(r)
    m, n = rp.shape
    return rp.reshape(m // 2, 2, n // 2, 2).sum(dim=(1, 3))


def _coarsen_bmask(bmask: torch.Tensor) -> torch.Tensor:
    """A coarse cell is Dirichlet if any fine cell of its block is (the
    coarse correction must vanish there)."""
    return _restrict(bmask.to(torch.float32)) > 0.


def _prolong_pc(e: torch.Tensor, fine_shape: Tuple[int, int]) -> torch.Tensor:
    """Piecewise-constant prolongation, cropped to the fine shape."""
    out = e.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    return out[:fine_shape[0], :fine_shape[1]]


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


def _host_coarsen_labels(labels: np.ndarray, bmask: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Host replica of the level coarsening: coarse Dirichlet = any fine
    Dirichlet in the 2x2 block; coarse label = max fine label, zeroed on
    coarse Dirichlet cells. Where distinct islands merge into one cell at
    deep levels, the union is still a valid 1-D deflation subspace."""
    m, n = labels.shape
    mp, npad = m + (m % 2), n + (n % 2)
    lab = np.zeros((mp, npad), labels.dtype)
    lab[:m, :n] = labels
    bm = np.zeros((mp, npad), bool)
    bm[:m, :n] = bmask
    bm_c = (bm[::2, ::2] | bm[1::2, ::2] | bm[::2, 1::2] | bm[1::2, 1::2])
    lab_c = np.maximum(np.maximum(lab[::2, ::2], lab[1::2, ::2]),
                       np.maximum(lab[::2, 1::2], lab[1::2, 1::2]))
    lab_c[bm_c] = 0
    return lab_c, bm_c


def island_sound_mask(labels_np: np.ndarray, num: int) -> np.ndarray:
    """Per-island indicator (float32, length ``num``) of the islands that
    never occupy the two easternmost columns, where the east-column fac
    quirk makes W nonsymmetric. Only for these is the outer island
    correction ``z^T r / z^T A z`` an orthogonal projection; for strip
    islands it is oblique and explodes, so they are left to the
    symmetrized per-level deflation and GCR. Index 0 (background) is 0."""
    sound = np.zeros(num, np.float32)
    k = int(labels_np.max())
    if k:
        strip = np.unique(labels_np[:, -2:])
        sound[1:k + 1] = 1.0
        sound[strip[strip > 0]] = 0.0
    return sound


class IslandSegments(NamedTuple):
    """One level's per-island reduction layout, built on the host."""
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
    device from the host in every call."""
    vals = x.reshape(-1)[seg.order].to(torch.float64)
    return torch.segment_reduce(vals, 'sum', offsets=seg.offsets)


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
    planes: torch.Tensor    # (8, nrow, ncol) f32 difference-form weights
    planes_x: torch.Tensor  # the same with island-internal edges zeroed
    notb: torch.Tensor      # (nrow, ncol) f32, 1 where NOT Dirichlet
    dinv: torch.Tensor      # (nrow, ncol) f32, 1/sum_d W_d (0 where 0)
    seg: Optional[IslandSegments]  # None when the field has no islands
    zaz_inv: Optional[torch.Tensor]  # (num,) f64 1/(z_I^T A z_I)

    @property
    def shape(self):
        return self.planes.shape[-2:]


def build_lap_levels(planes: torch.Tensor, bmask: torch.Tensor,
                     labels: np.ndarray, num: int) -> List[LapLevel]:
    """The V-cycle's level hierarchy: Galerkin coarsening of ``planes``
    until ``min(shape) <= _MIN_SIZE`` (8 levels at 500x600), with each
    level's island labels coarsened on the host. ``num`` is the island
    count plus one; ``num == 1`` builds no island structures."""
    levels = []
    mask = bmask
    lab = np.asarray(labels, np.int32)
    bm = bmask.cpu().numpy()
    while True:
        diag = torch.sum(planes, dim=0)
        dinv = torch.where(diag > 0., 1. / torch.where(diag > 0., diag, 1.),
                           0.)
        seg = zaz_inv = None
        planes_x = planes
        if num > 1:
            seg = island_segments(lab, num, planes.device)
            planes_x = _crossing_planes(planes, seg.labels)
            zaz_inv = 1.0 / island_zaz(planes, seg)
        levels.append(LapLevel(planes=planes, planes_x=planes_x,
                               notb=(~mask).to(torch.float32), dinv=dinv,
                               seg=seg, zaz_inv=zaz_inv))
        if min(lab.shape) <= _MIN_SIZE:
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
    return u + c[level.seg.labels] * level.notb


def vcycle(levels: List[LapLevel], rhs: torch.Tensor,
           u0: torch.Tensor) -> torch.Tensor:
    """One deflated V-cycle for A u = rhs with u clamped (0 correction)
    at Dirichlet cells. ``_KAPPA`` over-corrects the prolongated coarse
    update: the piecewise-constant Galerkin operator is ~2x too stiff
    for smooth modes (``ssrs_tpu/potential/lap.py::vcycle``)."""

    def cycle(idx: int, u: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
        level = levels[idx]
        if idx == len(levels) - 1:
            u = _smooth(level, u, rhs, _COARSE_SWEEPS)
            return _deflate(level, u, rhs)
        u = _smooth(level, u, rhs, _NU1)
        u = _deflate(level, u, rhs)
        r = (rhs - _apply_lap(level.planes, u)) * level.notb
        coarse = levels[idx + 1]
        r_c = _restrict(r) * coarse.notb
        e_c = cycle(idx + 1, torch.zeros_like(r_c), r_c)
        pe = _prolong_pc(e_c, level.shape)
        u = u + _KAPPA * pe * level.notb
        u = _deflate(level, u, rhs)
        return _smooth(level, u, rhs, _NU2)

    return cycle(0, u0, rhs)


# ---- Krylov --------------------------------------------------------------------


_GCR_K = 3  # truncated-GCR history depth (Orthomin(k))
_REFINE_PASSES = 30  # budget of float64 refinement passes per solve


def _gcr_solve(levels: List[LapLevel], rhs: torch.Tensor, maxiter: int,
               tol_abs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                               int]:
    """Solve A x = rhs (x clamped 0 at Dirichlet cells) by truncated
    flexible GCR preconditioned with one deflated V-cycle per iteration.
    Inner products are taken in the D^-1-weighted norm, so plateau rows
    (D ~ 1e-8) are not invisible next to island rows (D ~ 1).

    The history is a ring of the last ``_GCR_K`` directions, oldest
    first, as JAX's shifted buffer (whose empty slots contribute exact
    zeros). The exit test reads one device scalar per iteration, the
    only host sync of an iteration. Returns (x, scaled residual norm,
    iterations = V-cycles)."""
    top = levels[0]
    notb = top.notb
    dinv2 = top.dinv * top.dinv

    def sdot(a, b):
        return torch.sum((a * dinv2) * b)

    def snorm(r):
        return torch.linalg.vector_norm(r * top.dinv)

    x = torch.zeros_like(rhs)
    hist = deque(maxlen=_GCR_K)
    rn, rn_prev = snorm(rhs), None
    it = 0
    while it < maxiter:
        go = rn > tol_abs
        if it >= 8:
            # exit at the float32 floor: past the slow start (~0.97 per
            # iteration on hard fields), an iteration must gain 0.5%
            go = go & (rn < 0.995 * rn_prev)
        if not bool(go):
            break
        r = (rhs - _apply_lap(top.planes, x)) * notb
        z = vcycle(levels, r, torch.zeros_like(x)) * notb
        q = _apply_lap(top.planes, z) * notb
        for zi, qi in hist:
            beta = sdot(q, qi)
            z = z - beta * zi
            q = q - beta * qi
        nrm2 = sdot(q, q)
        inv = torch.where(nrm2 > 0, torch.rsqrt(nrm2 + 1e-38), 0.)
        z, q = z * inv, q * inv
        alpha = sdot(r, q)
        x = x + alpha * z
        hist.append((z, q))
        rn_prev, rn = rn, snorm((rhs - _apply_lap(top.planes, x)) * notb)
        it += 1
    return x, rn, it


# ---- refined solve -------------------------------------------------------------


def _solve_refined_core(cond: torch.Tensor, bmask: torch.Tensor,
                        bvals: torch.Tensor, labels: np.ndarray, k: int,
                        tol: float, maxcycles: int,
                        init=None) -> Tuple[torch.Tensor, float, int, int]:
    """Returns (potential f32, rrel, refinement passes, V-cycles)."""
    num = k + 1
    planes_t = weight_planes(cond)
    # the preconditioner hierarchy on the SYMMETRIZED operator; the
    # refinement residuals below use the TRUE planes, so the solution
    # solves the reference's system
    levels = build_lap_levels(symmetrize_planes(planes_t), bmask, labels,
                              num)
    top = levels[0]
    planes_t64 = planes_t.to(torch.float64)
    notb64 = top.notb.to(torch.float64)
    dinv64 = top.dinv.to(torch.float64)
    u0_cold = torch.where(bmask, bvals, 500.)
    if init is None:
        u0 = u0_cold
    else:
        # warm start, sanitized so a pathological prior solve can only
        # cost iterations, never poison this one
        init = torch.as_tensor(init, dtype=torch.float32, device=cond.device)
        u0 = torch.where(bmask, bvals,
                         torch.where(torch.isfinite(init), init, 500.))

    def resid(u):
        return -_apply_lap(planes_t64, u) * notb64

    # all norms are of the diagonally SCALED residual D^-1 r (potential
    # units): the error has sensitivity ~1/D to the raw residual in
    # plateau rows (D ~ 8e-8) and island rows alike
    def scaled_norm(r):
        return torch.linalg.vector_norm(r * dinv64)

    # convergence is judged against the COLD start's residual, so tol and
    # rrel (and the 5e-3 fallback threshold) mean the same with a warm
    # start
    scale = float(scaled_norm(resid(u0_cold.to(torch.float64)))) + 1e-30
    target = tol * scale
    lev_target = 1e-4  # island level-error estimate, potential units
    if k:
        sound = torch.as_tensor(island_sound_mask(labels, num),
                                dtype=torch.float64, device=cond.device)

    def island_coeff(r):
        """Sound-island level-error estimates z^T r / z^T A z (zero for
        the background and east-strip islands, whose quotient is
        oblique; see island_sound_mask)."""
        return island_sum(r, top.seg) * top.zaz_inv * sound

    u = u0.to(torch.float64)
    lev = float('inf')
    rn, best, stall, passes, cycles = scale, scale, 0, 0, 0
    # each pass: one GCR solve of the correction in float32, then the
    # outer island correction over sound islands, then the float64
    # residual; exit on convergence, on the pass budget, or once no pass
    # in the last 3 set a new best (<= 0.9x) residual (the outer
    # refinement converges non-monotonically on east-strip fields)
    while passes < _REFINE_PASSES and (rn > target or lev > lev_target) \
            and stall < 3:
        r = resid(u)
        tol_abs = torch.clamp(0.02 * scaled_norm(r), min=0.5 * target)
        delta, _, its = _gcr_solve(levels, r.to(torch.float32), maxcycles,
                                   tol_abs.to(torch.float32))
        cycles += its
        u = u + (delta * top.notb).to(torch.float64)
        if k:
            u = u + island_coeff(resid(u))[top.seg.labels] * notb64
        r = resid(u)
        lev_t = island_coeff(r).abs().max() if k else \
            torch.zeros((), dtype=torch.float64, device=r.device)
        rn, lev = torch.stack([scaled_norm(r), lev_t]).tolist()
        stall = 0 if rn < 0.9 * best else stall + 1
        best = min(best, rn)
        passes += 1

    out = torch.where(bmask, bvals.to(torch.float64), u)
    return out.to(torch.float32), rn / scale, passes, cycles


def solve_potential_refined(conductivity, bmask, bvals, tol: float = 1e-7,
                            maxcycles: int = 60, init=None, device=None,
                            stats=None):
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
    are replaced). ``stats``, a dict, receives ``passes`` (refinement
    passes) and ``vcycles``."""
    if torch.is_tensor(conductivity):
        cond = conductivity.to(torch.float32)
    else:
        if device is None:
            raise ValueError('solve_potential_refined: a numpy '
                             'conductivity needs an explicit device=')
        cond = torch.as_tensor(np.asarray(conductivity, np.float32),
                               device=torch.device(device))
    bmask = torch.as_tensor(bmask, device=cond.device).to(torch.bool)
    bvals = torch.as_tensor(bvals, device=cond.device).to(torch.float32)
    labels, k = island_labels((cond > 0).cpu().numpy(),
                              bmask.cpu().numpy())
    pot, rrel, passes, cycles = _solve_refined_core(
        cond, bmask, bvals, labels, k, tol, maxcycles, init)
    if stats is not None:
        stats.update(passes=passes, vcycles=cycles)
    return pot, rrel
