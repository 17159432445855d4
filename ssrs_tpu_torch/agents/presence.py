"""Presence-density maps: counting and circular-kernel smoothing.

The PyTorch counterpart of ``ssrs_tpu/agents/presence.py``: the count of
a list of trajectories (``compute_presence_counts``, the reference's
per-(track, step) loop, ssrs/movmodel.py:410-419) through the presence
count kernel, and the smoothing (flat circular kernel, normalized, 'same'
2-D convolution, ssrs/movmodel.py:422-439). The simulation itself counts
in the agent step (``agents/fused_step.py``) and its flush.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .presence_hist import presence_histogram_batch


def circular_kernel(krad: int) -> np.ndarray:
    """Flat circular kernel of radius ``krad``, normalized to sum 1
    (ssrs/movmodel.py:431-436)."""
    kernel = np.zeros((2 * krad + 1, 2 * krad + 1))
    y, x = np.ogrid[-krad:krad + 1, -krad:krad + 1]
    kernel[x ** 2 + y ** 2 <= krad ** 2] = 1
    return (kernel / kernel.sum()).astype(np.float32)


def smooth_presence(count_mat: torch.Tensor, krad: int) -> torch.Tensor:
    """'same'-mode 2-D convolution of a count map with the circular
    kernel, in full float32: cuDNN would otherwise run a float32
    convolution in TF32, where the JAX package asks for
    ``Precision.HIGHEST``."""
    kern = torch.from_numpy(circular_kernel(krad)).to(count_mat.device)
    x = count_mat.to(torch.float32)[None, None]
    k = torch.flip(kern, (0, 1))[None, None]  # convolution, not correlation
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = F.conv2d(x, k, padding=krad)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return out[0, 0]


def card_or_raise(device, caller: str) -> torch.device:
    """``device`` as a torch device; a CUDA device that is not there
    raises."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'{caller}(device=cuda): no CUDA device is available; pass '
            "device='cpu' explicitly to run the plain PyTorch versions")
    return device


def track_points(tracks: List[np.ndarray], device):
    """The ``(rows, cols)`` planes of a list of ``(len, 2)`` trajectories,
    concatenated, int16 (int32 unless every track is int16), on
    ``device``. Both planes start on a 16-byte boundary (the row plane is
    padded to a multiple of 8 points), so the count kernel reads them 16
    bytes at a time."""
    if tracks:
        pts = np.concatenate([np.asarray(t).reshape(-1, 2) for t in tracks])
    else:
        pts = np.zeros((0, 2), np.int16)
    if pts.dtype != np.int16:
        pts = pts.astype(np.int32)
    m = pts.shape[0]
    planes = np.empty((2, -(-m // 8) * 8), pts.dtype)
    planes[:, :m] = pts.T
    planes = torch.from_numpy(planes).to(device)
    return planes[0, :m], planes[1, :m]


def compute_presence_counts(tracks: List[np.ndarray],
                            gridshape: Tuple[int, int],
                            device='cuda') -> np.ndarray:
    """Visits per cell over a list of ``(len, 2)`` (row, col)
    trajectories, as a numpy int16 ``(nrow, ncol)`` map.

    The tracks are concatenated and counted on ``device`` (the card by
    default, which raises where there is none; ``'cpu'`` runs the plain
    version) by :func:`presence_histogram_batch`. The int32 counts are
    cast to int16 as the JAX package casts its int64 ones: a cell above
    32767 visits wraps the same way, since both casts keep the low 16
    bits.
    """
    device = card_or_raise(device, 'compute_presence_counts')
    rows, cols = track_points(tracks, device)
    counts = presence_histogram_batch(rows, cols, int(gridshape[0]),
                                      int(gridshape[1]))
    return counts.cpu().numpy().astype(np.int16)


def compute_smooth_presence_counts(tracks: List[np.ndarray],
                                   gridshape: Tuple[int, int],
                                   radius: float,
                                   device='cuda') -> np.ndarray:
    """The smoothed count map of a list of trajectories, float32
    (ssrs/movmodel.py:422-439), on ``device`` as
    :func:`compute_presence_counts`."""
    device = card_or_raise(device, 'compute_smooth_presence_counts')
    counts = compute_presence_counts(tracks, gridshape, device=device)
    out = smooth_presence(torch.from_numpy(counts).to(device), int(radius))
    return out.cpu().numpy().astype(np.float32)


def smooth_presence_from_counts(count_mat: torch.Tensor,
                                radius: float) -> torch.Tensor:
    """Smooth a count map on its device."""
    return smooth_presence(count_mat, int(radius))
