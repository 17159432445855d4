"""Presence histograms: CUDA kernel wrappers and their plain PyTorch
versions.

The counterparts of ``ssrs_tpu/agents/pallas_hist.py``, both in
``csrc/presence_hist.cu``:

- :func:`presence_histogram` (kernel B, ``_hist_kernel``): int32
  ``(nrow, ncol)`` map of the float32 weights of ``(rows, cols)`` points.
  Each weight is rounded to bf16 and the per-cell sum, taken in float32,
  is truncated to int32, as on the TPU. The flush of the delayed presence
  count runs it with the alive flags as weights.
- :func:`presence_histogram_batch` (kernel C, ``_hist_kernel_nw``): int32
  count of int16 or int32 ``(rows, cols)`` points, where row -1 marks a
  dead point. The recount of recorded trajectories runs it.

Points outside ``[0, nrow) x [0, ncol)`` count nothing in either. The TPU
kernels' ``tile`` argument (a VMEM blocking size) has no counterpart.

On CUDA tensors each wrapper launches its kernel or raises; on CPU
tensors it runs its ``_plain`` version.
"""

from __future__ import annotations

import torch

# launches of each CUDA kernel since the last reset_launch_count()
_launches = {'presence_histogram': 0, 'presence_histogram_batch': 0}


def launch_count(name: str) -> int:
    """CUDA launches of ``'presence_histogram'`` or
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


def presence_histogram(rows: torch.Tensor, cols: torch.Tensor,
                       weights: torch.Tensor, nrow: int,
                       ncol: int) -> torch.Tensor:
    """int32 ``(nrow, ncol)`` histogram of ``(rows, cols)`` with per-point
    weights.

    ``rows`` and ``cols`` are int32 ``(N,)``; ``weights`` float32
    ``(N,)`` (typically the alive flags), rounded to bf16 before the
    float32 sum, which is truncated to int32. Exact while each cell's
    partial sums fit float32's 24-bit significand. Points outside the
    grid count nothing. Returns a new map on the inputs' device.
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


def presence_histogram_batch(rows: torch.Tensor, cols: torch.Tensor,
                             nrow: int, ncol: int) -> torch.Tensor:
    """int32 ``(nrow, ncol)`` count of ``(rows, cols)`` points.

    ``rows`` and ``cols`` are int16 or int32 ``(M,)``, of one dtype; row
    -1 marks a dead point, and every point outside the grid counts
    nothing. Exact in int32 for any number of points below 2^31 per
    cell. Returns a new map on the inputs' device.
    """
    dev = _check([('rows', rows), ('cols', cols)],
                 [(torch.int16, torch.int32), (rows.dtype,)], nrow, ncol)
    if dev.type == 'cpu':
        return presence_histogram_batch_plain(rows, cols, nrow, ncol)
    from .._build import load_library
    lib = load_library()
    launch = (lib.ssrs_presence_hist_count_i16 if rows.dtype == torch.int16
              else lib.ssrs_presence_hist_count_i32)
    out = torch.empty((nrow, ncol), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(rows.data_ptr(), cols.data_ptr(), out.data_ptr(),
                     rows.shape[0], nrow, ncol, stream)
    _count_launch(err, 'presence_histogram_batch')
    return out
