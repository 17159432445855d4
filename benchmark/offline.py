"""Offline runs: a ``requests`` that refuses every request.

A copy of ``chip_smoke.py``'s ``_refuse_http``. Registered before the
program is imported, it makes the terrain chain's 3DEP attempt and the
USWTDB fetch fail at once, as they do on a machine without a network, so
the ``Simulator`` finds the benchmark's saved raster and no turbines."""

from __future__ import annotations

import sys
import types


def refuse_http():
    """Put a refusing ``requests`` into ``sys.modules``; returns it."""

    class ConnectionError(OSError):
        pass

    def get(*args, **kwargs):
        raise ConnectionError('the benchmark runs offline')

    mod = types.ModuleType('requests')
    mod.get = get
    mod.exceptions = types.SimpleNamespace(
        ConnectionError=ConnectionError, ConnectTimeout=ConnectionError,
        HTTPError=ConnectionError)
    sys.modules['requests'] = mod
    return mod
