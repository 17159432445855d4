"""Presence-density maps: circular-kernel smoothing.

The PyTorch counterpart of ``ssrs_tpu/agents/presence.py``
(``compute_smooth_presence_counts``: flat circular kernel, normalized,
'same' 2-D convolution, ssrs/movmodel.py:422-439). Counting happens in
the agent step (``agents/fused_step.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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
