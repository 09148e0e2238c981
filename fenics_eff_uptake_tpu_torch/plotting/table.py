"""Study rows as typed columns, for the study figures (the JAX package's
figures take pandas DataFrames; the port has no pandas).

A ``Table`` holds one numpy array per column, typed as pandas types a
DataFrame of the same rows or CSV: int64 where every value is an integer
and none is missing, float64 where every value is a number or missing
(missing as NaN), otherwise object.  The types matter beyond arithmetic:
the figures' file names carry values as ``str(value)``, so a mu factor of
1 names ``mu1`` and one of 1.0 ``mu1p0``, as in the JAX package.
"""

from __future__ import annotations

import csv
import numbers

import numpy as np

__all__ = ["Table"]

# what pandas.read_csv reads as missing by default
_NA_TEXT = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])


def _missing(v):
    return v is None or (isinstance(v, float) and np.isnan(v))


def _column(values):
    """A column of Python or numpy scalars, typed as pandas types it."""
    present = [v for v in values if not _missing(v)]
    if all(isinstance(v, numbers.Integral) and not isinstance(v, bool)
           for v in present) and len(present) == len(values) and present:
        return np.array(values, dtype=np.int64)
    if all(isinstance(v, numbers.Real) and not isinstance(v, bool)
           for v in present):
        return np.array([np.nan if _missing(v) else v for v in values],
                        dtype=np.float64)
    out = np.empty(len(values), dtype=object)
    out[:] = [np.nan if _missing(v) else v for v in values]
    return out


def _parse(text):
    """A CSV column's cells typed as pandas.read_csv types them."""
    if all(t not in _NA_TEXT for t in text):
        try:
            return np.array([int(t) for t in text], dtype=np.int64)
        except ValueError:
            pass
    try:
        return np.array([np.nan if t in _NA_TEXT else float(t)
                         for t in text], dtype=np.float64)
    except ValueError:
        out = np.empty(len(text), dtype=object)
        out[:] = [np.nan if t in _NA_TEXT else t for t in text]
        return out


class Table:
    """Named columns of equal length (see the module docstring)."""

    def __init__(self, columns):
        self.columns = dict(columns)
        self.n = len(next(iter(self.columns.values()))) if columns else 0

    @classmethod
    def from_rows(cls, rows):
        """Rows as the studies' ``save_csv`` returns them (a list of
        dicts); a key a row lacks is a missing value there."""
        names = list(dict.fromkeys(k for r in rows for k in r))
        return cls({k: _column([r.get(k) for r in rows]) for k in names})

    @classmethod
    def read_csv(cls, path):
        with open(path, newline="") as f:
            reader = csv.reader(f)
            header = next(reader)
            cells = list(reader)
        return cls({name: _parse([r[i] if i < len(r) else ""
                                  for r in cells])
                    for i, name in enumerate(header)})

    @classmethod
    def of(cls, data):
        """A Table as it is, or one made from a list of row dicts."""
        return data if isinstance(data, Table) else cls.from_rows(data)

    def __len__(self):
        return self.n

    def __contains__(self, name):
        return name in self.columns

    def __getitem__(self, name):
        return self.columns[name]

    def __setitem__(self, name, values):
        self.columns[name] = np.asarray(values)

    def notna(self, name):
        """Mask of the column's present values."""
        col = self.columns[name]
        if col.dtype == object:
            return np.array([not _missing(v) for v in col], dtype=bool)
        if col.dtype.kind == "f":
            return ~np.isnan(col)
        return np.ones(len(col), dtype=bool)

    def has(self, name):
        """The column exists and holds at least one present value."""
        return name in self.columns and bool(self.notna(name).any())

    def where(self, mask):
        mask = np.asarray(mask, dtype=bool)
        return Table({k: v[mask] for k, v in self.columns.items()})

    def eq(self, name, value):
        """Rows whose ``name`` equals ``value``."""
        return self.where(self.columns[name] == value)

    def sort_by(self, name):
        """Rows in ascending order of ``name`` (stable; missing last)."""
        col = self.columns[name]
        present = self.notna(name)
        idx = np.flatnonzero(present)
        order = idx[np.argsort(col[idx], kind="stable")]
        order = np.concatenate([order, np.flatnonzero(~present)])
        return Table({k: v[order] for k, v in self.columns.items()})

    def unique(self, name):
        """The column's distinct present values, ascending."""
        col = self.columns[name]
        return sorted(set(col[self.notna(name)].tolist())) \
            if col.dtype == object else \
            list(np.unique(col[self.notna(name)]))

    def groups(self, name):
        """(value, rows) per distinct present value of ``name``, in
        ascending order (pandas' groupby)."""
        return [(v, self.eq(name, v)) for v in self.unique(name)]

    def rows(self):
        """The rows as dicts."""
        return [{k: v[i] for k, v in self.columns.items()}
                for i in range(self.n)]
