"""Host helpers, copied from ``ssrs_tpu/utils.py``: only those the port
uses."""

from __future__ import annotations

import errno
import os


def makedir_if_not_exists(dirname: str) -> None:
    try:
        os.makedirs(dirname)
    except OSError as exc:
        if exc.errno != errno.EEXIST:
            raise
