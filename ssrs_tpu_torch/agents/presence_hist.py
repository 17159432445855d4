"""Presence histograms: CUDA kernel wrappers and their plain PyTorch
versions.

The counterparts of ``ssrs_tpu/agents/pallas_hist.py``, all in
``csrc/presence_hist.cu``:

- :func:`presence_flush`: the flush of the delayed presence count
  (``agents.simulate.flush_pending``, where ``ssrs_tpu`` runs kernel B's
  computation with the pending flags as weights): one launch adds one
  into the presence map, in place, for every in-grid agent whose flag is
  set, and returns the cleared flags as a new tensor.
- :func:`presence_histogram` (kernel B, ``_hist_kernel``): int32
  ``(nrow, ncol)`` map of the float32 weights of ``(rows, cols)`` points.
  Each weight is rounded to bf16 and the per-cell sum, taken in float32,
  is truncated to int32, as on the TPU. No path of the port runs it; as
  in ``ssrs_tpu``, it is a standalone kernel.
- :func:`presence_histogram_batch` (kernel C, ``_hist_kernel_nw``): int32
  count of int16 or int32 ``(rows, cols)`` points, where row -1 marks a
  dead point. The recount of recorded trajectories runs it. Of its two
  kernels, :func:`_count_plan` picks one from the shapes: the privatized
  count, in bands of cells held in the blocks' shared memory, where
  points are many per cell on a grid of few bands; the direct one, with
  a global atomic a point, elsewhere.

Points outside ``[0, nrow) x [0, ncol)`` count nothing in any of them.
The TPU kernels' ``tile`` argument (a VMEM blocking size) has no
counterpart.

On CUDA tensors each wrapper launches its kernel or raises; on CPU
tensors it runs its ``_plain`` version.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

# launches of each CUDA kernel since the last reset_launch_count()
_launches = {'presence_flush': 0, 'presence_histogram': 0,
             'presence_histogram_batch': 0}

# shared memory a block of the privatized count gives its band of cells;
# the card allows 227 KB a block
MAX_SMEM_BYTES = 200 * 1024
# the rule between the two count kernels: privatized from this many points
# a cell, on grids of at most MAX_BANDS bands (every band reads every
# point). Measured by chip_smoke.py on an H100 SXM (700 W), uniform
# points: at 500x600 (6 bands) the privatized kernel loses at 4 points a
# cell (28.7 against 21.6 us) and wins from 10 (41.7 against 43.5 us); at
# 25 a cell it wins on 8 bands (92.5 against 97 us) and loses on 10
# (109.5 against 95.7 us)
MIN_POINTS_PER_CELL = 10
MAX_BANDS = 8
# streaming multiprocessors of an H100 SXM, for plans made off the card
H100_SMS = 132


def launch_count(name: str) -> int:
    """CUDA launches of ``'presence_flush'``, ``'presence_histogram'`` or
    ``'presence_histogram_batch'``."""
    return _launches[name]


def reset_launch_count() -> None:
    for name in _launches:
        _launches[name] = 0


def _in_grid(rows: torch.Tensor, cols: torch.Tensor, nrow: int, ncol: int):
    """(mask of the points inside the grid, their int64 flat indices, 0
    where outside)."""
    r, c = rows.long(), cols.long()
    sel = (r >= 0) & (r < nrow) & (c >= 0) & (c < ncol)
    return sel, torch.where(sel, r * ncol + c, 0)


def presence_flush_plain(rows: torch.Tensor, cols: torch.Tensor,
                         palive: torch.Tensor,
                         presence: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`presence_flush`."""
    nrow, ncol = presence.shape
    sel, flat = _in_grid(rows, cols, nrow, ncol)
    flat = flat[sel & palive]
    presence.view(-1).index_put_(
        (flat,), torch.ones_like(flat, dtype=torch.int32), accumulate=True)
    return torch.zeros_like(palive)


def presence_histogram_plain(rows: torch.Tensor, cols: torch.Tensor,
                             weights: torch.Tensor, nrow: int,
                             ncol: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`presence_histogram`."""
    sel, flat = _in_grid(rows, cols, nrow, ncol)
    w = weights.to(torch.bfloat16).to(torch.float32)
    w = torch.where(sel, w, torch.zeros_like(w))
    acc = torch.zeros(nrow * ncol, dtype=torch.float32, device=rows.device)
    acc.index_add_(0, flat, w)
    return acc.to(torch.int32).view(nrow, ncol)


def presence_histogram_batch_plain(rows: torch.Tensor, cols: torch.Tensor,
                                   nrow: int, ncol: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`presence_histogram_batch`."""
    sel, flat = _in_grid(rows, cols, nrow, ncol)
    counts = torch.bincount(flat[sel], minlength=nrow * ncol)
    return counts.to(torch.int32).view(nrow, ncol)


class CountPlan(NamedTuple):
    """How :func:`presence_histogram_batch` counts on the card."""
    kernel: str       # 'privatized' or 'direct'
    bands: int        # bands of cells, one block's shared memory each
    band: int         # cells of a band (the last may have fewer)
    shares: int       # blocks a band, each reading a share of the points;
    #                   the copies of the map summed at the end
    smem_bytes: int   # a block's shared memory: its band, int32


def _count_plan(nrow: int, ncol: int, m: int,
                sms: int = H100_SMS) -> CountPlan:
    """The count's plan for ``m`` points on an ``nrow x ncol`` grid, on a
    card of ``sms`` multiprocessors.

    The grid's cells are cut into the fewest bands of at most
    ``MAX_SMEM_BYTES`` of int32 counts, and each band gets ``sms //
    bands`` blocks (at least one), so that bands x shares blocks, one an
    SM, fill the card. The privatized kernel reads every point once a
    band, and stores and sums ``shares`` copies of the map, so it is the
    plan's kernel only where the points are at least
    ``MIN_POINTS_PER_CELL`` a cell and the bands at most ``MAX_BANDS``;
    elsewhere (few points, or a large grid) the direct kernel is.
    """
    cells = nrow * ncol
    bands = -(-cells // (MAX_SMEM_BYTES // 4))
    band = -(-cells // bands)
    privatized = bands <= MAX_BANDS and m >= MIN_POINTS_PER_CELL * cells
    return CountPlan('privatized' if privatized else 'direct', bands, band,
                     max(1, sms // bands), band * 4)


def _cell_owner(plan: CountPlan, cells: np.ndarray):
    """(band, index in the shared memory of the band's blocks) of each
    flat cell index, as the privatized kernel places them."""
    band = cells // plan.band
    return band, cells - band * plan.band


def _check(tensors, dtypes, nrow: int, ncol: int) -> torch.device:
    if nrow <= 0 or ncol <= 0:
        raise ValueError(f'grid must be non-empty, got {nrow}x{ncol}')
    n = tensors[0][1].shape[0]
    dev = tensors[0][1].device
    for (name, t), allowed in zip(tensors, dtypes):
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f'{name} must be 1-D of length {n}, got '
                             f'{tuple(t.shape)}')
        if t.dtype not in allowed:
            raise ValueError(f'{name} must be one of {allowed}, got '
                             f'{t.dtype}')
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, '
                             f'{tensors[0][0]} on {dev}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'presence histograms run on cuda or cpu tensors, '
                         f'got {dev}')
    return dev


def _count_launch(err: int, name: str) -> None:
    """Raise on a failed launch; count a good one."""
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: CUDA error {err}')
    _launches[name] += 1


def presence_flush(rows: torch.Tensor, cols: torch.Tensor,
                   palive: torch.Tensor,
                   presence: torch.Tensor) -> torch.Tensor:
    """Add the pending points into ``presence`` in place; return the
    cleared flags.

    ``rows`` and ``cols`` are int32 ``(N,)`` positions and ``palive`` the
    bool ``(N,)`` pending flags; ``presence`` is the int32 ``(nrow,
    ncol)`` map, which gains one at every in-grid position whose flag is
    set. The result is a NEW all-false bool ``(N,)`` tensor: ``palive``
    itself is left as it is, since a caller's ``palive`` may be its
    ``alive`` (``agents.simulate.make_step_fn``).
    """
    if presence.dtype != torch.int32 or presence.dim() != 2 or \
            not presence.is_contiguous():
        raise ValueError('presence must be a contiguous int32 (nrow, ncol) '
                         f'map, got {presence.dtype} {tuple(presence.shape)}')
    nrow, ncol = presence.shape
    dev = _check([('rows', rows), ('cols', cols), ('palive', palive)],
                 [(torch.int32,), (torch.int32,), (torch.bool,)], nrow, ncol)
    if presence.device != dev:
        raise ValueError(f'presence is on {presence.device}, rows on {dev}')
    if dev.type == 'cpu':
        return presence_flush_plain(rows, cols, palive, presence)
    from .._build import load_library
    lib = load_library()
    cleared = torch.empty_like(palive)
    with torch.cuda.device(dev):
        err = lib.ssrs_presence_flush(
            rows.data_ptr(), cols.data_ptr(), palive.data_ptr(),
            presence.data_ptr(), cleared.data_ptr(), rows.shape[0], nrow,
            ncol, torch.cuda.current_stream().cuda_stream)
    _count_launch(err, 'presence_flush')
    return cleared


def presence_histogram(rows: torch.Tensor, cols: torch.Tensor,
                       weights: torch.Tensor, nrow: int,
                       ncol: int) -> torch.Tensor:
    """int32 ``(nrow, ncol)`` histogram of ``(rows, cols)`` with per-point
    weights.

    ``rows`` and ``cols`` are int32 ``(N,)``; ``weights`` float32
    ``(N,)``, rounded to bf16 before the float32 sum, which is truncated
    to int32. Exact while each cell's partial sums fit float32's 24-bit
    significand. Points outside the grid count nothing. Returns a new map
    on the inputs' device.
    """
    dev = _check([('rows', rows), ('cols', cols), ('weights', weights)],
                 [(torch.int32,), (torch.int32,), (torch.float32,)],
                 nrow, ncol)
    if dev.type == 'cpu':
        return presence_histogram_plain(rows, cols, weights, nrow, ncol)
    from .._build import load_library
    lib = load_library()
    acc = torch.empty(nrow * ncol, dtype=torch.float32, device=dev)
    out = torch.empty((nrow, ncol), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssrs_presence_hist_weighted(
            rows.data_ptr(), cols.data_ptr(), weights.data_ptr(),
            acc.data_ptr(), out.data_ptr(), rows.shape[0], nrow, ncol,
            stream)
    _count_launch(err, 'presence_histogram')
    return out


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    """Multiprocessors of the card."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def presence_histogram_batch(rows: torch.Tensor, cols: torch.Tensor,
                             nrow: int, ncol: int,
                             plan: Optional[CountPlan] = None
                             ) -> torch.Tensor:
    """int32 ``(nrow, ncol)`` count of ``(rows, cols)`` points.

    ``rows`` and ``cols`` are int16 or int32 ``(M,)``, of one dtype; row
    -1 marks a dead point, and every point outside the grid counts
    nothing. Exact in int32 for any number of points below 2^31 per
    cell. Returns a new map on the inputs' device. On the card the kernel
    is the one ``plan`` names, by default :func:`_count_plan`'s for this
    card; the privatized count reads 16 bytes at a time where both planes
    start on a 16-byte boundary (``agents.presence.track_points`` lays
    them out so).
    """
    dev = _check([('rows', rows), ('cols', cols)],
                 [(torch.int16, torch.int32), (rows.dtype,)], nrow, ncol)
    if dev.type == 'cpu':
        return presence_histogram_batch_plain(rows, cols, nrow, ncol)
    m = rows.shape[0]
    if plan is None:
        plan = _count_plan(nrow, ncol, m, _sms(dev.index))
    from .._build import load_library
    lib = load_library()
    out = torch.empty((nrow, ncol), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.kernel == 'direct':
            launch = (lib.ssrs_presence_hist_count_i16
                      if rows.dtype == torch.int16
                      else lib.ssrs_presence_hist_count_i32)
            err = launch(rows.data_ptr(), cols.data_ptr(), out.data_ptr(), m,
                         nrow, ncol, stream)
        else:
            scratch = torch.empty((plan.shares, nrow * ncol),
                                  dtype=torch.int32, device=dev)
            err = lib.ssrs_presence_count_bands(
                rows.data_ptr(), cols.data_ptr(), scratch.data_ptr(),
                out.data_ptr(), m, nrow, ncol, rows.element_size(),
                plan.bands, plan.shares, plan.band, stream)
    _count_launch(err, 'presence_histogram_batch')
    return out
