"""Phase timing.

The human-readable format of ``ssrs_tpu/core/timing.py`` (after the
reference, ssrs/utils.py:97-108) and a structured in-memory phase log.
On a CUDA device every phase boundary synchronizes the device, so a
phase's seconds include the device work it enqueued.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch


def elapsed_str(start: float) -> str:
    """Human format matching the reference (ssrs/utils.py:97-108)."""
    hours, rem = divmod(time.time() - start, 3600)
    mins, secs = divmod(rem, 60)
    if hours == 0:
        if mins == 0:
            return f'{int(secs) + 1} sec'
        return f'{int(mins)} min {int(secs)} sec'
    return f'{int(hours)} hr {int(mins)} min'


class PhaseTimer:
    """Structured phase timer; ``device`` names the device to
    synchronize at phase boundaries (only a CUDA device needs it)."""

    def __init__(self, device: Optional[torch.device] = None):
        self.records: List[Dict] = []
        self.device = None if device is None else torch.device(device)

    def _sync(self) -> None:
        if self.device is not None and self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str, **meta):
        self._sync()
        start = time.perf_counter()
        yield
        self._sync()
        dur = time.perf_counter() - start
        self.records.append({'phase': name, 'seconds': dur, **meta})
