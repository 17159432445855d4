"""Host C++ track builder, loaded with ctypes.

The counterpart of ``ssrs_tpu/native``: the recording driver
(``agents/simulate.py::simulate_tracks_recorded``) rebuilds each agent's
trajectory on the host from the per-chunk emissions the card sends back.
:class:`TrackBuilder` does that in one C++ pass per chunk
(``trackbuild.cpp``, a copy of the JAX package's); :class:`PyTrackBuilder`
is the same reconstruction as a Python loop, for hosts without a
compiler. Both give the same tracks; :func:`make_builder` picks the C++
one when it builds.

The library is compiled with ``g++`` at first use into
``build/ssrs_tpu_torch/`` beside the package (git ignores ``build/``),
named by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional

import numpy as np

from .._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    'trackbuild.cpp')
_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _library_path() -> str:
    digest = hashlib.sha256(' '.join(_FLAGS).encode())
    with open(_SRC, 'rb') as fobj:
        digest.update(fobj.read())
    return os.path.join(BUILD_DIR,
                        f'libssrs_trackbuild_{digest.hexdigest()[:16]}.so')


def _compile(out_path: str) -> bool:
    gxx = shutil.which('g++')
    if gxx is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([gxx, *_FLAGS, '-o', tmp, _SRC],
                             capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        os.unlink(tmp)
        return False
    if res.returncode != 0:
        os.unlink(tmp)
        return False
    os.replace(tmp, out_path)  # atomic: a concurrent process never sees half
    return True


def _load() -> Optional[ctypes.CDLL]:
    """Load (compiling if needed) the native library; None on failure."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        path = _library_path()
        if not os.path.isfile(path) and not _compile(path):
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _lib_failed = True
            return None
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.tb_create.restype = ptr
        lib.tb_create.argtypes = [i64, ptr]
        lib.tb_append_chunk.restype = None
        lib.tb_append_chunk.argtypes = [ptr, ptr, ptr, ptr, i64, i64]
        lib.tb_total_rows.restype = i64
        lib.tb_total_rows.argtypes = [ptr]
        lib.tb_export.restype = None
        lib.tb_export.argtypes = [ptr, ptr, ptr]
        lib.tb_destroy.restype = None
        lib.tb_destroy.argtypes = [ptr]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _check_chunk(pos: np.ndarray, alive: np.ndarray, ids: np.ndarray,
                 n_agents: int):
    pos = np.ascontiguousarray(pos, np.int16)
    alive = np.ascontiguousarray(alive, np.bool_)
    ids = np.ascontiguousarray(ids, np.int32)
    if alive.ndim != 2:
        raise ValueError(f'alive must be (chunk, b), got {alive.shape}')
    chunk, b = alive.shape
    if pos.shape != (chunk, b, 2) or ids.shape != (b,):
        raise ValueError(f'pos {pos.shape} and ids {ids.shape} do not '
                         f'match alive {alive.shape}')
    if b and (ids.min() < 0 or ids.max() >= n_agents):
        raise ValueError(f'ids must lie in [0, {n_agents})')
    return pos, alive, ids


class TrackBuilder:
    """Per-agent trajectory accumulator backed by the C++ library; use
    :func:`native_available` before constructing."""

    kind = 'native'

    def __init__(self, starts: np.ndarray):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError('native trackbuild library unavailable')
        starts = np.ascontiguousarray(starts, np.int16)
        if starts.ndim != 2 or starts.shape[1] != 2:
            raise ValueError('starts must be (n_agents, 2)')
        self.n_agents = starts.shape[0]
        self._h = self._lib.tb_create(self.n_agents, starts.ctypes.data)

    def append_chunk(self, pos: np.ndarray, alive: np.ndarray,
                     ids: np.ndarray) -> None:
        """pos (chunk, b, 2) int16, alive (chunk, b) bool, ids (b,) int32
        mapping batch slots to agents."""
        pos, alive, ids = _check_chunk(pos, alive, ids, self.n_agents)
        chunk, b = alive.shape
        self._lib.tb_append_chunk(self._h, pos.ctypes.data,
                                  alive.view(np.uint8).ctypes.data,
                                  ids.ctypes.data, chunk, b)

    def export(self) -> List[np.ndarray]:
        """Per-agent int16 (len, 2) trajectories (reference format)."""
        total = self._lib.tb_total_rows(self._h)
        flat = np.empty((total, 2), np.int16)
        lens = np.empty((self.n_agents,), np.int64)
        self._lib.tb_export(self._h, flat.ctypes.data, lens.ctypes.data)
        if self.n_agents == 0:
            # np.split would return one empty piece
            return []
        bounds = np.cumsum(lens)[:-1]
        return [np.ascontiguousarray(t) for t in np.split(flat, bounds)]

    def __del__(self):
        h = getattr(self, '_h', None)
        if h and self._lib is not None:
            self._lib.tb_destroy(h)
            self._h = None


class PyTrackBuilder:
    """The same reconstruction as a Python loop over the agents of each
    chunk (``ssrs_tpu/agents/simulate.py::simulate_tracks_recorded``
    without a compiler)."""

    kind = 'python'

    def __init__(self, starts: np.ndarray):
        starts = np.asarray(starts)
        if starts.ndim != 2 or starts.shape[1] != 2:
            raise ValueError('starts must be (n_agents, 2)')
        self.n_agents = starts.shape[0]
        self._traj = [[starts[i:i + 1]] for i in range(self.n_agents)]

    def append_chunk(self, pos: np.ndarray, alive: np.ndarray,
                     ids: np.ndarray) -> None:
        pos, alive, ids = _check_chunk(pos, alive, ids, self.n_agents)
        for j, agent in enumerate(ids):
            steps_alive = int(alive[:, j].sum())
            if steps_alive:
                self._traj[agent].append(pos[:steps_alive, j])

    def export(self) -> List[np.ndarray]:
        return [np.ascontiguousarray(
            np.concatenate(parts, axis=0).astype(np.int16))
            for parts in self._traj]


def make_builder(starts: np.ndarray):
    """The C++ builder where it builds, else the Python loop."""
    return TrackBuilder(starts) if native_available() \
        else PyTrackBuilder(starts)


__all__ = ['PyTrackBuilder', 'TrackBuilder', 'make_builder',
           'native_available']
