"""A small column table, in place of the pandas DataFrames of ``ssrs_tpu``.

The JAX package's WTK and USWTDB clients return DataFrames and cache them
as CSV files. The port does not import pandas, so this module holds the
little those clients and the ``Simulator`` use of one: named 1-D numpy
columns in order, a row index that survives selection and sorting,
``assign``, a sort by one column, equality of a column, and ``to_csv`` /
``read_csv`` in the layout pandas gives these frames (a leading unnamed
index column, shortest round-trip floats, empty fields for NaN), so that
a ``wtk_locations.csv``, ``y..._wtk.csv`` or ``turbines.csv`` written by
either package serves the other.
"""

from __future__ import annotations

import csv
from typing import Dict, Iterable, List, Optional

import numpy as np


class EmptyDataError(ValueError):
    """``read_csv`` of a file without a header line."""


class Table:
    """Named 1-D columns of one length, in order, with a row index."""

    def __init__(self, columns: Optional[Dict[str, Iterable]] = None,
                 index=None):
        self._cols: Dict[str, np.ndarray] = {}
        for name, values in (columns or {}).items():
            self._cols[str(name)] = _as_column(values)
        lengths = {len(v) for v in self._cols.values()}
        if len(lengths) > 1:
            raise ValueError(f'Table: columns of unequal length {lengths}')
        nrow = lengths.pop() if lengths else (0 if index is None
                                              else len(index))
        self.index = np.arange(nrow) if index is None else np.asarray(index)
        if len(self.index) != nrow:
            raise ValueError('Table: the index does not match the columns')

    @classmethod
    def from_any(cls, data) -> 'Table':
        """A table, or a dict of columns, as a table."""
        return data if isinstance(data, cls) else cls(data)

    # ---- shape and access ------------------------------------------------

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return len(self.index)

    @property
    def empty(self) -> bool:
        return len(self) == 0 or not self._cols

    def __contains__(self, name) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def __setitem__(self, name: str, values) -> None:
        values = _as_column(values)
        if len(values) != len(self):
            raise ValueError(f'Table: column {name!r} has {len(values)} '
                             f'values for {len(self)} rows')
        self._cols[str(name)] = values

    # ---- new tables ------------------------------------------------------

    def copy(self) -> 'Table':
        return Table({k: v.copy() for k, v in self._cols.items()},
                     self.index.copy())

    def assign(self, **columns) -> 'Table':
        out = self.copy()
        for name, values in columns.items():
            out[name] = values
        return out

    def select(self, rows) -> 'Table':
        """The rows of a boolean mask or of integer positions; each keeps
        its index label."""
        rows = np.asarray(rows)
        return Table({k: v[rows] for k, v in self._cols.items()},
                     self.index[rows])

    def sort_values(self, by: str, ascending: bool = True) -> 'Table':
        """Rows sorted by one column, NaN last, ties in the order pandas
        leaves them (its ``nargsort``)."""
        items = self._cols[by]
        isnan = _isnan(items)
        idx = np.arange(len(items))
        good, good_idx = items[~isnan], idx[~isnan]
        if not ascending:
            good, good_idx = good[::-1], good_idx[::-1]
        order = good_idx[good.argsort(kind='quicksort')]
        if not ascending:
            order = order[::-1]
        return self.select(np.concatenate([order, idx[isnan]]))

    # ---- comparison ------------------------------------------------------

    def column_equals(self, name: str, other: 'Table') -> bool:
        """Whether a column holds the same values, of the same type, as
        the other table's (NaN equal to NaN)."""
        a, b = self._cols[name], other[name]
        return a.dtype == b.dtype and a.shape == b.shape and \
            bool(np.all((a == b) | (_isnan(a) & _isnan(b))))

    def equals(self, other: 'Table') -> bool:
        return self.columns == other.columns and \
            np.array_equal(self.index, other.index) and \
            all(self.column_equals(k, other) for k in self._cols)

    # ---- CSV -------------------------------------------------------------

    def to_csv(self, fpath: str) -> None:
        """Write as pandas writes a frame: the header with an unnamed first
        (index) column, one line a row."""
        cols = [[_field(v) for v in col] for col in self._cols.values()]
        with open(fpath, 'w', encoding='utf-8', newline='') as fobj:
            writer = csv.writer(fobj, lineterminator='\n')
            writer.writerow([''] + self.columns)
            for i, label in enumerate(self.index):
                writer.writerow([_field(label)] + [c[i] for c in cols])

    def __repr__(self) -> str:
        return f'Table({len(self)} rows x {self.columns})'


def read_csv(fpath: str) -> Table:
    """Read a CSV whose first column is the index (pandas'
    ``read_csv(fpath, index_col=0)``). A column of integers becomes int64,
    one of numbers with empty fields float64 (NaN), anything else
    strings."""
    with open(fpath, 'r', encoding='utf-8', newline='') as fobj:
        rows = list(csv.reader(fobj))
    if not rows or not rows[0]:
        raise EmptyDataError(f'No columns to parse from file {fpath}')
    header, body = rows[0], [r for r in rows[1:] if r]
    fields = [[r[j] if j < len(r) else '' for r in body]
              for j in range(len(header))]
    parsed = [_parse_column(f) for f in fields]
    return Table(dict(zip(header[1:], parsed[1:])), index=parsed[0])


def _as_column(values) -> np.ndarray:
    arr = np.asarray(values)
    if arr.ndim != 1:
        raise ValueError(f'Table: a column must be 1-D, got {arr.shape}')
    if arr.dtype.kind in 'US':
        arr = arr.astype(object)
    return arr


def _isnan(arr: np.ndarray) -> np.ndarray:
    if arr.dtype.kind == 'f':
        return np.isnan(arr)
    if arr.dtype.kind == 'O':
        return np.array([isinstance(v, float) and v != v for v in arr],
                        dtype=bool)
    return np.zeros(arr.shape, bool)


def _field(value) -> str:
    """One CSV field: ``repr`` of a float (the shortest string that reads
    back exactly), nothing for NaN or None."""
    if value is None:
        return ''
    if isinstance(value, (float, np.floating)):
        if value != value:
            return ''
        # numpy's str of a float32 is its own shortest round trip
        return repr(float(value)) if isinstance(value, (float, np.float64)) \
            else str(value)
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    return str(value)


def _parse_column(fields: List[str]) -> np.ndarray:
    try:
        return np.array([int(f) for f in fields], dtype=np.int64)
    except ValueError:
        pass
    try:
        return np.array([float(f) if f != '' else np.nan for f in fields],
                        dtype=np.float64)
    except ValueError:
        pass
    out = np.empty(len(fields), dtype=object)
    out[:] = [f if f != '' else np.nan for f in fields]
    return out
