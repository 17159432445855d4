"""The plain reference: the run's quantities worked out again from the DEM
and the seeds, in float64, with plain PyTorch, NumPy and SciPy.

It follows the semantics of the reference SSRS (``ssrs/layers.py``,
``ssrs/movmodel.py``) as the port documents them, and imports nothing of
the program. Its pieces, from the terrain down:

- :func:`slope_aspect`, :func:`orograph`, :func:`threshold`: the Horn
  stencil, the Brandes-Ombalski orographic updraft and the usable-updraft
  transform;
- :func:`boundary_masks`, :func:`row_weights`, :func:`interior_residual`,
  :func:`direct_potential`: the directional-potential system (8-neighbour
  graph, harmonic-mean edge weights over ``fac``, row-normalized, the
  directed Dirichlet boundary) and its float64 sparse direct solve;
- :func:`move_table`, :func:`transitions`: the per-cell move weights and
  the move probabilities after each previous move (direction memory of one
  move, the fallback cascade, the ``nu`` exponent);
- :func:`starting_indices`: the tracks' start cells from the run's NumPy
  generator;
- :func:`expected_counts`: the exact expectation of the presence counts of
  given starts, by carrying the probability mass of the (cell, previous
  move) chain step by step, with the burn-in push, boundary absorption and
  the step cap;
- :func:`walk_counts`: a sampled walk of the same chain (the control puts
  it in the program's place);
- :func:`summary_map`: the smoothed, normalized summary presence map.
"""

from __future__ import annotations

from math import ceil, floor

import numpy as np
import torch
import torch.nn.functional as F

F64 = torch.float64
# (dr, dc) of the nine moves, row-major over the 3x3 neighbourhood
DELTAS = [(m // 3 - 1, m % 3 - 1) for m in range(9)]
NORM_INV = [0. if (dr, dc) == (0, 0) else 1. / float(np.hypot(dr, dc))
            for dr, dc in DELTAS]
CENTER0 = [0. if m == 4 else 1. for m in range(9)]
SQRT2 = float(np.sqrt(2.0))


# ---- fields ---------------------------------------------------------------

def slope_aspect(z: torch.Tensor, res: float):
    """(slope, aspect) in degrees, zero on the border: the Horn stencil with
    axis 0 as x (ssrs/layers.py:63-128)."""
    z1, z2, z3 = z[:-2, 2:], z[1:-1, 2:], z[2:, 2:]
    z4, z6 = z[:-2, 1:-1], z[2:, 1:-1]
    z7, z8, z9 = z[:-2, :-2], z[1:-1, :-2], z[2:, :-2]
    dx = ((z3 + 2. * z6 + z9) - (z1 + 2. * z4 + z7)) / (8. * res)
    dy = ((z1 + 2. * z2 + z3) - (z7 + 2. * z8 + z9)) / (8. * res)
    slope = torch.rad2deg(torch.arctan(torch.sqrt(dx * dx + dy * dy)))
    dxs = torch.where(dx == 0., torch.full_like(dx, 1e-10), dx)
    aspect = 180. - torch.rad2deg(torch.arctan(dy / dxs)) \
        + 90. * dxs / torch.abs(dxs)
    out = []
    for inner in (slope, aspect):
        full = torch.zeros_like(z)
        full[1:-1, 1:-1] = inner
        out.append(torch.nan_to_num(full))
    return tuple(out)


def orograph(slope, aspect, speed: float, dirn: float) -> torch.Tensor:
    """w = max(0, speed * sin(slope) * max(0, cos(aspect - dirn)))
    (ssrs/layers.py:11-22)."""
    rad = np.pi / 180.
    diff = torch.clamp(torch.cos((aspect - dirn) * rad), min=0.)
    return torch.clamp(speed * torch.sin(slope * rad) * diff, min=0.)


def threshold(w: torch.Tensor, thr: float) -> torch.Tensor:
    """0 at or below 1e-2, a smooth blend up to ``thr``, ``w`` above
    (ssrs/layers.py:171-185)."""
    blend = thr * (torch.exp((w / thr) ** 5) - 1.) / (np.e - 1.)
    out = torch.where(w > thr, w, blend)
    return torch.where(w > 1e-2, out, torch.zeros_like(out))


# ---- the directional potential -------------------------------------------

def boundary_masks(dirn: float, shape):
    """(Dirichlet mask, values) of ``get_boundary_nodes``
    (ssrs/movmodel.py:21-57): the perimeter split into a 0 and a 1000 set
    by the movement quadrant, the split taken by position in the
    concatenated column-major node list."""
    nrow, ncol = shape
    north = np.array([nrow * (x + 1) - 1 for x in range(ncol)])
    south = np.array([nrow * x for x in range(ncol)])
    west = np.arange(1, nrow - 1)
    east = np.array([(ncol - 1) * nrow + x for x in range(1, nrow - 1)])
    ang, quad = dirn % 90., (dirn % 360) // 90.
    cl, rl = round(ncol * ang / 90.), round(nrow * ang / 90.)
    if quad == 0:
        low = np.concatenate((north[cl:], east[nrow - rl:]))
        high = np.concatenate((south[:ncol - cl], west[:rl]))
    elif quad == 1:
        low = np.concatenate((south[ncol - cl:], east[:nrow - rl]))
        high = np.concatenate((north[:cl], west[rl:]))
    elif quad == 2:
        low = np.concatenate((south[:ncol - cl], west[:rl]))
        high = np.concatenate((north[cl:], east[nrow - rl:]))
    else:
        high = np.concatenate((south[ncol - cl:], east[:nrow - rl]))
        low = np.concatenate((north[:cl], west[rl:]))
    nodes = np.concatenate((low, high)).astype(np.int64)
    vals = np.zeros(nodes.size)
    vals[nodes.size // 2:] = 1000.
    mask = np.zeros(shape, bool)
    value = np.zeros(shape)
    mask[nodes % nrow, nodes // nrow] = True
    value[nodes % nrow, nodes // nrow] = vals
    return mask, value


def _fac(dr: int, dc: int, shape) -> np.ndarray:
    """The edge's divisor: sqrt 2 on diagonals, 1 on axials, with the
    east-column quirk of the reference's assembly (ssrs/movmodel.py:66-79:
    on the east column's inner nodes the (-1, 0) and (-1, -1) edges swap
    their divisors)."""
    fac = np.full(shape, SQRT2 if (dr and dc) else 1.0)
    if (dr, dc) == (-1, 0):
        fac[1:-1, -1] = SQRT2
    elif (dr, dc) == (-1, -1):
        fac[1:-1, -1] = 1.0
    return fac


def row_weights(cond: torch.Tensor):
    """The 8 moves off the centre with their edge weights
    ``hm(cond_i, cond_j) / fac`` (hm = 1e-8 where either is exactly 0),
    each an (nrow, ncol) float64 plane, zero off the grid."""
    cond = cond.to(F64)
    nrow, ncol = cond.shape
    pad = F.pad(cond, (1, 1, 1, 1))
    inside = F.pad(torch.ones_like(cond), (1, 1, 1, 1))
    out = []
    for dr, dc in DELTAS:
        if (dr, dc) == (0, 0):
            continue
        nbr = pad[1 + dr:1 + dr + nrow, 1 + dc:1 + dc + ncol]
        ok = inside[1 + dr:1 + dr + nrow, 1 + dc:1 + dc + ncol] > 0
        both = (cond != 0.) & (nbr != 0.)
        hm = torch.where(both, 2. / (1. / torch.where(cond == 0., 1., cond)
                                     + 1. / torch.where(nbr == 0., 1., nbr)),
                         torch.full_like(cond, 1e-8))
        fac = torch.as_tensor(_fac(dr, dc, (nrow, ncol)), device=cond.device)
        out.append(((dr, dc), torch.where(ok, hm / fac,
                                          torch.zeros_like(hm))))
    return out


def interior_residual(pot: torch.Tensor, cond: torch.Tensor,
                      dirn: float) -> float:
    """max |x - P x| over the cells off the Dirichlet boundary: how far the
    potential ``x`` (0..1000) is from solving the row-normalized system of
    the conductivity ``cond``."""
    x = pot.to(device=cond.device, dtype=F64)
    nrow, ncol = x.shape
    xpad = F.pad(x, (1, 1, 1, 1))
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for (dr, dc), w in row_weights(cond):
        num += w * xpad[1 + dr:1 + dr + nrow, 1 + dc:1 + dc + ncol]
        den += w
    mask, _ = boundary_masks(dirn, (nrow, ncol))
    resid = torch.abs(x - num / den)
    resid[torch.as_tensor(mask, device=x.device)] = 0.
    return float(resid.max())


def direct_potential(cond: np.ndarray, dirn: float) -> np.ndarray:
    """The float64 solution of the potential system by SciPy's sparse
    direct solver (the reference's ``spsolve``, ssrs/movmodel.py:86-128),
    Dirichlet cells at their values."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    cond = torch.as_tensor(np.asarray(cond, np.float64))
    nrow, ncol = cond.shape
    n = nrow * ncol
    idx = np.arange(n).reshape(nrow, ncol)
    rows, cols, vals = [], [], []
    for (dr, dc), w in row_weights(cond):
        w = w.numpy()
        r0, r1 = max(0, -dr), nrow - max(0, dr)
        c0, c1 = max(0, -dc), ncol - max(0, dc)
        rows.append(idx[r0:r1, c0:c1].ravel())
        cols.append(idx[r0 + dr:r1 + dr, c0 + dc:c1 + dc].ravel())
        vals.append(w[r0:r1, c0:c1].ravel())
    g = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    g = sp.diags(1. / np.asarray(g.sum(axis=1)).ravel()) @ g
    mask, value = boundary_masks(dirn, (nrow, ncol))
    fixed = mask.ravel()
    free = np.flatnonzero(~fixed)
    g = g.tocsr()[free]
    a = sp.eye(free.size, format='csc') - g[:, free].tocsc()
    rhs = g[:, np.flatnonzero(fixed)] @ value.ravel()[fixed]
    x = value.ravel().copy()
    x[free] = spla.spsolve(a, rhs)
    return x.reshape(nrow, ncol)


# ---- moves ------------------------------------------------------------------

def restriction_table() -> np.ndarray:
    """(9, 9): row m allows the moves within 45 degrees of move m
    (``get_track_restrictions``, ssrs/movmodel.py:185-202, with its
    ``abs(dr + dc % 2)`` precedence); row 4 (no move yet) allows all but
    the centre."""
    rows = []
    for dr, dc in DELTAS:
        a = np.zeros((3, 3), int)
        if abs(dr + dc % 2) == 1:
            if dr == 0:
                a[:, dc + 1] = 1
            else:
                a[dr + 1, :] = 1
        else:
            drm = np.zeros((3, 3), int)
            dcm = np.zeros((3, 3), int)
            drm[(dr + 1, 1), :] = 1
            dcm[:, (1, dc + 1)] = 1
            a = np.logical_and(drm, dcm).astype(int)
        if dr == 0 and dc == 0:
            a[:, :] = 1
        a[1, 1] = 0
        rows.append(a.ravel())
    return np.array(rows, np.float64)


def directional_probs(dirn: float) -> np.ndarray:
    """The directional prior (``get_directional_probs``,
    ssrs/movmodel.py:247-257), flattened row-major, centre 0."""
    th = float(dirn) * np.pi / 180.
    d = np.zeros((3, 3))
    d[0, :] = [np.cos(np.pi / 4 + th), np.cos(th), np.cos(7 * np.pi / 4 + th)]
    d[1, :] = [np.cos(np.pi / 2 + th), 0, np.cos(3 * np.pi / 2 + th)]
    d[2, :] = [np.cos(3 * np.pi / 4 + th), np.cos(np.pi + th),
               np.cos(5 * np.pi / 4 + th)]
    d[d < 0.01] = 0.
    return np.flipud(d.clip(min=0.)).ravel()


def move_table(updraft: torch.Tensor, potential: torch.Tensor,
               dirn: float) -> torch.Tensor:
    """(nrow, ncol, 9) float64 move weights: hm(w, w_nbr) * (p - p_nbr) /
    |move| with the updraft floored at 1e-6 (ssrs/movmodel.py:294-305),
    clipped at 0, centre 0; a cell with a neighbour off the grid takes the
    directional prior (ssrs/movmodel.py:227-232)."""
    w = torch.clamp(updraft.to(F64), min=1e-6)
    p = potential.to(device=w.device, dtype=F64)
    nrow, ncol = w.shape
    wpad = F.pad(w, (1, 1, 1, 1), value=1e-6)
    ppad = F.pad(p, (1, 1, 1, 1), value=float('nan'))
    layers = []
    for m, (dr, dc) in enumerate(DELTAS):
        wn = wpad[1 + dr:1 + dr + nrow, 1 + dc:1 + dc + ncol]
        pn = ppad[1 + dr:1 + dr + nrow, 1 + dc:1 + dc + ncol]
        layers.append(2. / (1. / w + 1. / wn) * (p - pn) * NORM_INV[m]
                      * CENTER0[m])
    base = torch.stack(layers, dim=-1)
    base = torch.where(torch.isnan(base), base, torch.clamp(base, min=0.))
    prior = torch.as_tensor(directional_probs(dirn) * np.array(CENTER0),
                            device=w.device)
    return torch.where(torch.isnan(base).any(-1, keepdim=True), prior, base)


def transitions(table: torch.Tensor, dirn: float, memory_k: int,
                nu: float) -> torch.Tensor:
    """(9 previous moves, 9 next moves, nrow, ncol) move probabilities:
    the cell's weights masked by the moves the previous one allows, then
    the prior masked, then the prior, whichever is first not all zero;
    raised to ``nu`` after division by the largest; normalized
    (ssrs/movmodel.py:220-244)."""
    if memory_k not in (0, 1):
        raise ValueError('the reference carries a direction memory of 0 or '
                         f'1 moves, not {memory_k}')
    dev = table.device
    p0 = table.to(F64).permute(2, 0, 1)                     # (9, H, W)
    dirp = torch.as_tensor(directional_probs(dirn), device=dev)[:, None,
                                                                None]
    center = torch.as_tensor(CENTER0, device=dev, dtype=F64)[:, None, None]
    restr = torch.as_tensor(restriction_table(), device=dev)
    out = []
    for m in range(9):
        p = p0
        if memory_k:
            mask = restr[m][:, None, None] * center
            p = p * mask
            p = torch.where((p == 0.).all(0, keepdim=True),
                            (dirp * center * mask).expand_as(p), p)
        p = torch.where((p == 0.).all(0, keepdim=True), dirp.expand_as(p), p)
        if nu == 0.:
            p = torch.ones_like(p)
        elif nu != 1.:
            p = p / p.amax(0, keepdim=True)
            p = torch.where(p > 0., p.clamp(min=1e-300) ** nu,
                            torch.zeros_like(p))
        out.append(p / p.sum(0, keepdim=True))
    return torch.stack(out)


# ---- starts, counts and maps ----------------------------------------------

def starting_indices(ntracks: int, sbounds, stype: str, twidth, tres: float,
                     rng: np.random.Generator):
    """(rows, cols) of the tracks' start cells (``get_starting_indices``,
    ssrs/movmodel.py:144-182), from ``rng`` for the random type."""
    res_km = tres / 1000.
    xmax, ymax = ceil(twidth[0] / res_km), ceil(twidth[1] / res_km)
    xlo = min(max(floor(sbounds[0] / res_km) - 1, 1), xmax - 2)
    xhi = max(min(ceil(sbounds[1] / res_km), xmax - 1), 2)
    ylo = min(max(floor(sbounds[2] / res_km) - 1, 1), ymax - 2)
    yhi = max(min(ceil(sbounds[3] / res_km), ymax - 1), 2)
    xm, ym = np.mgrid[xlo:xhi, ylo:yhi]
    base = np.vstack((np.ravel(ym), np.ravel(xm)))
    count = base.shape[1]
    if stype == 'structured':
        idx = np.round(np.linspace(0, count - 1, ntracks % count))
        if ntracks > count:
            inds = np.tile(base, (1, ntracks // count))
            inds = np.hstack((inds, inds[:, idx.astype(int)]))
        else:
            inds = base[:, idx.astype(int)]
    elif stype == 'random':
        inds = base[:, rng.integers(0, count, ntracks)]
    else:
        raise ValueError(f'track_start_type {stype!r}')
    return inds[0].astype(int), inds[1].astype(int)


def _push_index(n: int, low: int, device) -> torch.Tensor:
    """Where the burn-in push sends each row (``low`` = 1) or column
    (``low`` = 0): up 2 at or below ``low``, down 2 at or above n - 2."""
    i = torch.arange(n, device=device)
    return torch.where(i <= low, i + 2, torch.where(i >= n - 2, i - 2, i))


def _shift_add(out, src, dr: int, dc: int):
    """out[..., r + dr, c + dc] += src[..., r, c] where both are on the
    grid."""
    h, w = src.shape[-2:]
    out[..., max(dr, 0):h + min(dr, 0), max(dc, 0):w + min(dc, 0)] += \
        src[..., max(-dr, 0):h - max(dr, 0), max(-dc, 0):w - max(dc, 0)]


def expected_counts(trans: torch.Tensor, starts: torch.Tensor, burnin: int,
                    nsteps: int, tol: float = 1e-7) -> torch.Tensor:
    """The expected presence counts ``(J, nrow, ncol)`` (float64) of ``J``
    start histograms ``starts (J, nrow, ncol)`` under the move
    probabilities ``trans`` (:func:`transitions`, or ``(J, 9, 9, nrow,
    ncol)``, one chain a start histogram): the starts count, then at each
    step t < ``nsteps`` every agent alive moves and counts its new cell.
    Up to step ``burnin`` an agent near the edge moves from the cell the
    push gives; after it an agent on the border dies. The mass is carried
    in float32 and the counts summed in float64. Stops early once the mass
    still alive could add less than ``tol`` of the counts; the step it
    stopped at is ``expected_counts.last_step``."""
    dev = trans.device
    f32 = torch.float32
    if trans.dim() == 4:
        trans = trans.unsqueeze(0)
    trans = trans.to(f32)
    mass = torch.zeros((starts.shape[0], 9, *starts.shape[-2:]), dtype=f32,
                       device=dev)
    mass[:, 4] = starts.to(f32)
    counts = starts.to(F64).clone()
    nrow, ncol = starts.shape[-2:]
    prow, pcol = _push_index(nrow, 1, dev), _push_index(ncol, 0, dev)
    flux = torch.empty_like(mass)
    t = 0
    for t in range(nsteps):
        if t > burnin:
            mass[..., 0, :] = 0.
            mass[..., -1, :] = 0.
            mass[..., :, 0] = 0.
            mass[..., :, -1] = 0.
        else:
            mass = torch.zeros_like(mass).index_add_(-2, prow, mass)
            mass = torch.zeros_like(mass).index_add_(-1, pcol, mass)
        flux.zero_()
        for m in range(9):
            flux.addcmul_(mass[:, m:m + 1], trans[:, m])
        mass.zero_()
        for n, (dr, dc) in enumerate(DELTAS):
            _shift_add(mass[:, n], flux[:, n], dr, dc)
        counts += mass.sum(1, dtype=F64)
        if t > burnin and t % 128 == 0:
            alive = float(mass.sum(dtype=F64))
            if alive * (nsteps - t) < tol * float(counts.sum()):
                break
    expected_counts.last_step = t
    return counts


def walk_counts(tables: torch.Tensor, starts_rc: torch.Tensor, dirn: float,
                memory_k: int, nu: float, burnin: int, nsteps: int,
                gen: torch.Generator, chunk: int = 1 << 23) -> torch.Tensor:
    """Presence counts ``(C, nrow, ncol)`` of the agents of ``starts_rc
    (N, 2)`` walking the chain of :func:`expected_counts` on each of the
    weights ``tables (C, nrow, ncol, 9)``, one uniform per agent-step from
    ``gen``, ``chunk`` agents at a time."""
    n_case, nrow, ncol, _ = tables.shape
    dev = tables.device
    cells = nrow * ncol
    flat = tables.reshape(-1, 9)
    dirp = torch.as_tensor(directional_probs(dirn), device=dev,
                           dtype=flat.dtype)
    center = torch.as_tensor(CENTER0, device=dev, dtype=flat.dtype)
    restr = torch.as_tensor(restriction_table(), device=dev,
                            dtype=flat.dtype)
    counts = torch.zeros(n_case * cells, dtype=F64, device=dev)
    n = starts_rc.shape[0]
    case = torch.arange(n_case, device=dev).repeat_interleave(n)
    all_r = starts_rc[:, 0].to(dev, torch.int64).repeat(n_case)
    all_c = starts_rc[:, 1].to(dev, torch.int64).repeat(n_case)
    for a0 in range(0, n_case * n, chunk):
        r, c = all_r[a0:a0 + chunk], all_c[a0:a0 + chunk]
        base = case[a0:a0 + chunk] * cells
        m = torch.full_like(r, 4)
        alive = torch.ones_like(r, dtype=torch.bool)
        counts.index_add_(0, base + r * ncol + c,
                          torch.ones(r.shape, dtype=F64, device=dev))
        for t in range(nsteps):
            if t > burnin:
                alive &= (r > 0) & (r < nrow - 1) & (c > 0) & (c < ncol - 1)
                pr, pc = r, c
            else:
                pr = torch.where(r <= 1, r + 2,
                                 torch.where(r >= nrow - 2, r - 2, r))
                pc = torch.where(c <= 0, c + 2,
                                 torch.where(c >= ncol - 2, c - 2, c))
            if t % 64 == 0:
                keep = torch.nonzero(alive).squeeze(1)
                if keep.numel() == 0:
                    break
                r, c, m, pr, pc = r[keep], c[keep], m[keep], pr[keep], \
                    pc[keep]
                alive, base = alive[keep], base[keep]
            p = flat[base + pr * ncol + pc]
            if memory_k:
                mask = restr[m] * center
                p = p * mask
                p = torch.where((p == 0.).all(1, keepdim=True),
                                dirp * center * mask, p)
            p = torch.where((p == 0.).all(1, keepdim=True),
                            dirp.expand_as(p), p)
            if nu == 0.:
                p = torch.ones_like(p)
            elif nu != 1.:
                p = p / p.amax(1, keepdim=True)
                p = torch.where(p > 0., p.clamp(min=1e-30) ** nu,
                                torch.zeros_like(p))
            cdf = torch.cumsum(p, 1)
            u = torch.rand(r.shape, generator=gen, device=dev,
                           dtype=cdf.dtype) * cdf[:, -1]
            j = torch.clamp((cdf < u[:, None]).sum(1), max=8)
            r = torch.where(alive, pr + j // 3 - 1, r)
            c = torch.where(alive, pc + j % 3 - 1, c)
            m = torch.where(alive, j, m)
            counts.index_add_(0, (base + r * ncol + c)[alive],
                              torch.ones(int(alive.sum()), dtype=F64,
                                         device=dev))
    return counts.reshape(n_case, nrow, ncol)


def start_histogram(rows, cols, shape, device) -> torch.Tensor:
    """Start cells as an (nrow, ncol) float64 histogram."""
    hist = torch.zeros(shape[0] * shape[1], dtype=F64, device=device)
    idx = torch.as_tensor(np.asarray(rows) * shape[1] + np.asarray(cols),
                          device=device)
    hist.index_add_(0, idx, torch.ones(idx.shape, dtype=F64, device=device))
    return hist.reshape(shape)


def kernel_radius(radius: float, res: float, shape) -> int:
    """The smoothing kernel's radius in cells, clamped to [2, grid / 2]."""
    return int(round(min(max(radius / res, 2), min(shape) / 2)))


def circular_kernel(krad: int, dtype=F64, device=None) -> torch.Tensor:
    """Flat disc of radius ``krad``, summing to 1 (ssrs/movmodel.py:431)."""
    y, x = np.ogrid[-krad:krad + 1, -krad:krad + 1]
    k = (x ** 2 + y ** 2 <= krad ** 2).astype(np.float64)
    return torch.as_tensor(k / k.sum(), dtype=dtype, device=device)


def summary_map(counts: torch.Tensor, krad: int,
                dtype=F64) -> torch.Tensor:
    """The summary presence map of the cases' counts ``(C, nrow, ncol)``
    (one realization each): each smoothed by the disc and divided by its
    largest value, summed over the cases, divided by the largest value
    (ssrs/simulator.py:508-546)."""
    x = counts.to(dtype)[:, None]
    k = circular_kernel(krad, dtype, counts.device)[None, None]
    prob = F.conv2d(x, k, padding=krad)[:, 0]
    prob = prob / prob.amax((-2, -1), keepdim=True)
    total = prob.sum(0)
    return total / total.amax()
