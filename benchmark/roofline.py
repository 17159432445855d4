"""Peaks of the card and the work a kernel must do, counted from the
model's own quantities so that any implementation is held to the same
bound.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
rates: 3.35 TB/s of HBM3 bandwidth, 67 TFLOP/s of float32 outside the
tensor cores."""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# the table rule of the configuration's 'auto' precision: float32 while
# the float32 table is at most this many bytes, else bfloat16
AUTO_F32_MAX_BYTES = 6 * 2 ** 20


def bound_seconds(nbytes: float, flops: float):
    """(seconds, 'bytes' or 'operations'): the least time the card needs
    to move ``nbytes`` through its memory and to do ``flops`` float32
    operations, whichever is longer."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_F32_S
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def move_flops(k: int) -> int:
    """Float multiplies and adds of one live agent-step at nu = 1: the
    direction-memory mask and its product with the nine weights
    (9 (k + 1) when k > 0), the total and the running sum (18) and the
    threshold (1)."""
    return 19 + (9 * (k + 1) if k > 0 else 0)


def table_row_bytes(precision: str, shape) -> int:
    """Bytes of one cell's nine move weights at the configured table
    precision (``'auto'``, ``'float32'`` or ``'bfloat16'``)."""
    if precision == 'auto':
        f32 = int(shape[0]) * int(shape[1]) * 9 * 4
        precision = 'float32' if f32 <= AUTO_F32_MAX_BYTES else 'bfloat16'
    return 9 * (4 if precision == 'float32' else 2)


def track_bound(live_steps: int, k: int, cells_visited: int,
                row_bytes: int):
    """Bound of the moves of a track phase: ``live_steps`` agent-steps of
    :func:`move_flops` operations, each visited cell's table row read once
    and its int32 count read and written once. Uniforms and the agents'
    state are not counted: an implementation may make the one in
    registers and keep the other on chip."""
    return bound_seconds(cells_visited * (row_bytes + 8),
                         live_steps * move_flops(k))
