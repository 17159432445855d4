"""Phase timing: the port's one mechanism of spans and counters.

The human-readable format of ``ssrs_tpu/core/timing.py`` (after the
reference, ssrs/utils.py:97-108) and a structured in-memory log of
spans, each closed span one record::

    {'phase': name, 'seconds': ..., **meta, 'span': n, 'parent': m or None,
     't0_ns': ..., **counters}

``span`` numbers a timer's spans in the order they open, ``parent`` is
the number of the span that was open around it, ``t0_ns`` its start by
``time.time_ns()``, the clock of ``torch.profiler``'s host events, and
``seconds`` its length by ``time.perf_counter()``. A record is appended
when its span closes, after its children's records.

``PhaseTimer.phase`` opens a span that synchronizes a CUDA device at both
ends, so its seconds include the device work it enqueued;
``PhaseTimer.span`` one that does not, whose seconds are the host's.
While a span of a timer is open, the module's :func:`span`,
:func:`count` and :func:`read_host` reach that timer from library code
(a ``contextvars.ContextVar``); with none open they do nothing. While a
profiler is on, every span is also the profiler range
``phase:<name>``."""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import time
from typing import Dict, List, Optional

import torch

# the PhaseTimer whose span is open in this context
_OPEN: contextvars.ContextVar = contextvars.ContextVar('ssrs_phase_timer',
                                                       default=None)
_NOTHING = contextlib.nullcontext()


def elapsed_str(start: float) -> str:
    """Human format matching the reference (ssrs/utils.py:97-108)."""
    hours, rem = divmod(time.time() - start, 3600)
    mins, secs = divmod(rem, 60)
    if hours == 0:
        if mins == 0:
            return f'{int(secs) + 1} sec'
        return f'{int(mins)} min {int(secs)} sec'
    return f'{int(hours)} hr {int(mins)} min'


def span(name: str, **meta):
    """A span of the timer open in this context, under its innermost open
    span (:meth:`PhaseTimer.span`); with none open, a context that does
    nothing."""
    timer = _OPEN.get()
    return _NOTHING if timer is None else timer.span(name, **meta)


def count(name: str, value=1, on: Optional[str] = None) -> None:
    """Add ``value`` to the counter ``name`` of the innermost open span
    (named ``on``, where given) of the timer open in this context; with
    none open, nothing."""
    timer = _OPEN.get()
    if timer is not None:
        timer.count(name, value, on)


def read_host(tensor: torch.Tensor, wait: str,
              on: Optional[str] = None) -> torch.Tensor:
    """``tensor.cpu()``, with the seconds the copy took (the host blocked
    on the device, where the tensor is on one) added to the counter
    ``wait``, as :func:`count`."""
    timer = _OPEN.get()
    if timer is None:
        return tensor.cpu()
    t0 = time.perf_counter()
    out = tensor.cpu()
    timer.count(wait, time.perf_counter() - t0, on)
    return out


def _range(name: str):
    """The profiler range ``phase:<name>``, entered, while a profiler is
    on; else None."""
    if not torch._C._autograd._profiler_enabled():
        return None
    rng = torch.profiler.record_function(f'phase:{name}')
    rng.__enter__()
    return rng


def _stat(fpath: str):
    """What tells a file from one written since: its inode, size and
    modification time; None where there is no file."""
    try:
        st = os.stat(fpath)
    except FileNotFoundError:
        return None
    return st.st_ino, st.st_size, st.st_mtime_ns


class _Span:
    """One span of a :class:`PhaseTimer`, a context manager."""

    __slots__ = ('timer', 'name', 'sync', 'meta', 'rec', 'token', 'range',
                 'start')

    def __init__(self, timer: 'PhaseTimer', name: str, sync: bool,
                 meta: dict):
        self.timer, self.name, self.sync, self.meta = timer, name, sync, meta

    def __enter__(self):
        timer = self.timer
        if self.sync:
            timer._sync()
        self.range = _range(self.name)
        self.rec = timer._record(self.name, self.meta, time.time_ns())
        timer._open.append(self.rec)
        self.token = _OPEN.set(timer)
        self.start = time.perf_counter()
        return self.rec

    def __exit__(self, exc_type, exc, tb):
        timer = self.timer
        try:
            if self.sync and exc_type is None:
                timer._sync()
            self.rec['seconds'] = time.perf_counter() - self.start
        finally:
            _OPEN.reset(self.token)
            timer._open.pop()
            if self.range is not None:
                self.range.__exit__(exc_type, exc, tb)
        if exc_type is None:
            timer.records.append(self.rec)
        return False


class PhaseTimer:
    """Structured phase timer; ``device`` names the device to
    synchronize at phase boundaries (only a CUDA device needs it)."""

    def __init__(self, device: Optional[torch.device] = None):
        self.records: List[Dict] = []
        self.device = None if device is None else torch.device(device)
        # the records of the open spans, innermost last
        self._open: List[Dict] = []
        self._spans = 0              # spans opened
        self._dumped = 0             # records written by dump()
        self._dump_path = self._stat = None

    def _sync(self) -> None:
        if self.device is not None and self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def phase(self, name: str, **meta):
        """A span whose ends synchronize the timer's CUDA device."""
        return _Span(self, name, True, meta)

    def span(self, name: str, **meta):
        """A span that does not synchronize: its seconds are the host's."""
        return _Span(self, name, False, meta)

    def count(self, name: str, value=1, on: Optional[str] = None) -> None:
        """Add ``value`` to the counter ``name`` of the innermost open span
        (of the innermost named ``on``, where given); with none, nothing."""
        for rec in reversed(self._open):
            if on is None or rec['phase'] == on:
                rec[name] = rec.get(name, 0) + value
                return

    def _record(self, name: str, meta: dict, t0_ns: int) -> Dict:
        """A new span's record, numbered, under the innermost open span."""
        rec = {'phase': name, 'seconds': 0., **meta, 'span': self._spans,
               'parent': self._open[-1]['span'] if self._open else None,
               't0_ns': int(t0_ns)}
        self._spans += 1
        return rec

    def add(self, name: str, seconds: float, t0_ns: int, **meta) -> None:
        """Append the record of work timed elsewhere (no range, no device
        synchronization), under the innermost open span. Its ``t0_ns``
        and ``seconds`` are the caller's, and need not be one interval
        of the trace's timeline."""
        rec = self._record(name, meta, t0_ns)
        rec['seconds'] = seconds
        self.records.append(rec)

    def dump(self, fpath: str) -> int:
        """Write the records to ``fpath`` as one JSON list, a record a line,
        the last one the record of this write, a span ``save.phase_log``
        that does not synchronize (its seconds leave out the write of its own line).
        While the file is the one this timer's last dump left (the same
        path, inode, size and modification time), the records added
        since go in before its closing bracket, so a dump's bytes grow
        with the records it adds, not with the log; otherwise (a first
        dump, a file deleted, or written by another timer since) the
        whole log is written anew. The file is then equal to
        ``records``. Returns the bytes written."""
        rng = _range('save.phase_log')
        try:
            rec = self._record('save.phase_log', {}, time.time_ns())
            start = time.perf_counter()
            append = fpath == self._dump_path and _stat(fpath) == self._stat
            new = self.records[self._dumped:] if append else self.records
            head = ''.join(json.dumps(r, default=str) + ',\n' for r in new)
            with open(fpath, 'r+b' if append else 'wb') as fobj:
                if append:
                    fobj.seek(-1, os.SEEK_END)
                data = (',\n' if append else '[') + head
                fobj.write(data.encode())
                rec['seconds'] = time.perf_counter() - start
                last = json.dumps(rec, default=str) + ']'
                fobj.write(last.encode())
        finally:
            if rng is not None:
                rng.__exit__(None, None, None)
        self.records.append(rec)
        self._dump_path, self._stat = fpath, _stat(fpath)
        self._dumped = len(self.records)
        return len(data.encode()) + len(last.encode())

    def summary(self) -> str:
        lines = [f'{r["phase"]}: {r["seconds"]:.3f} s' for r in self.records]
        return '\n'.join(lines)
