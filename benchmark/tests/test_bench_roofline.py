"""The bound arithmetic of ``roofline.py``."""

import pytest

from benchmark import roofline


def test_move_flops():
    assert roofline.move_flops(0) == 19
    assert roofline.move_flops(1) == 37
    assert roofline.move_flops(3) == 55


def test_bound_takes_the_longer():
    t, by = roofline.bound_seconds(3.35e12, 0.)
    assert by == 'bytes' and t == pytest.approx(1.)
    t, by = roofline.bound_seconds(1., 67e12 * 2)
    assert by == 'operations' and t == pytest.approx(2.)


def test_table_row_bytes():
    # 500x600 in float32 is 10.8 MB, above the 6 MiB 'auto' limit
    assert roofline.table_row_bytes('auto', (500, 600)) == 18
    assert roofline.table_row_bytes('auto', (50, 60)) == 36
    assert roofline.table_row_bytes('float32', (500, 600)) == 36
    assert roofline.table_row_bytes('bfloat16', (50, 60)) == 18


def test_track_bound():
    # 4.5e9 live agent-steps at k=1 and 8 x 300,000 cells of bf16 rows:
    # 1.665e11 operations (2.49 ms) against 62.4 MB (18.6 us)
    t, by = roofline.track_bound(4_500_000_000, 1, 2_400_000, 18)
    assert by == 'operations'
    assert t == pytest.approx(4.5e9 * 37 / 67e12)
    t, by = roofline.track_bound(10, 1, 1_000_000, 18)
    assert by == 'bytes' and t == pytest.approx(26e6 / 3.35e12)
