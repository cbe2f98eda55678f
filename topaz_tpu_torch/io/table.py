"""A table of named numpy columns, without pandas: the DataFrame operations
the JAX package's coordinate tools use (topaz_tpu/io/coordinates.py,
topaz_tpu/ops/masks.py, topaz_tpu/cli/commands/), with pandas' results.

- ``concat`` joins tables row-wise over the union of their columns in the
  order they first appear; a table that lacks a column contributes NaN,
  so an integer column with a gap becomes float64 and prints as ``1.0``.
- ``groupby`` yields the groups by sorted key; rows with no key (NaN) are
  left out.
- ``merge_left`` is ``pd.merge(left, right, on=key, how="left")``: left's
  rows in order, each with every matching row of right (NaN where none
  matches), shared non-key columns suffixed ``_x`` and ``_y``.
- ``write_csv`` prints as ``to_csv(sep=..., index=False)``: a float in its
  shortest round-trip form (numpy's ``str``, float32 as float32), NaN as
  an empty field, strings as they are.
- ``read_csv`` types a text column as pandas' reader does: int64 when
  every value is an integer, float64 when every value is a number or
  empty (empty is NaN), else strings; ``str_columns`` stay strings. Its
  numbers are pandas' C parser's (``xstrtod``): at most 17 digits are
  accumulated in a double, then scaled by a power of ten, so a value of
  16 or 17 significant digits can land one unit in the last place from
  the correctly rounded one, and the port lands there too.
"""

from __future__ import annotations

import csv
import re
from typing import IO, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def _is_nan(v) -> bool:
    return isinstance(v, (float, np.floating)) and v != v


def format_column(values: np.ndarray) -> List[str]:
    """Each value of a column as pandas' ``to_csv`` prints it."""
    values = np.asarray(values)
    if values.dtype.kind == "f":
        text = values.astype(str)
        text[np.isnan(values)] = ""
        return text.tolist()
    if values.dtype.kind in "iub":
        return values.astype(str).tolist()
    return ["" if v is None or _is_nan(v) else str(v) for v in values.tolist()]


_NUMBER = re.compile(r"\s*([+-]?)([0-9]*)(?:\.([0-9]*))?(?:[eE]([+-]?[0-9]+))?\s*$")
_POW10 = [float(f"1e{k}") for k in range(309)]
_MAX_DIGITS = 17


def parse_float(text: str) -> float:
    """``text`` as pandas' default C parser reads a float
    (pandas/_libs/src/parser/tokenizer.c, ``precise_xstrtod``)."""
    m = _NUMBER.match(text)
    if m is None or not (m.group(2) or m.group(3)):
        word = text.strip().lower().lstrip("+")
        if word in ("inf", "-inf", "infinity", "-infinity"):
            return float(word)
        raise ValueError(f"could not convert string to float: {text!r}")
    sign, whole, frac, exp = m.groups()
    number, exponent, digits = 0.0, 0, 0
    for c in whole:
        if digits < _MAX_DIGITS:
            number = number * 10.0 + int(c)
            digits += 1
        else:
            exponent += 1
    for c in (frac or "")[:max(0, _MAX_DIGITS - digits)]:
        number = number * 10.0 + int(c)
        exponent -= 1
    if sign == "-":
        number = -number
    if exp:
        exponent += int(exp[:_MAX_DIGITS + (exp[0] in "+-")])
    if exponent > 308:
        return float("inf") if number > 0 else float("-inf") if number < 0 else 0.0
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def parse_column(values: Sequence[str]) -> np.ndarray:
    """A text column as pandas' reader types it."""
    present = [v for v in values if v != ""]
    if len(present) == len(values):
        try:
            return np.array([int(v) for v in values], dtype=np.int64)
        except ValueError:
            pass
    try:
        return np.array([parse_float(v) if v != "" else np.nan for v in values],
                        dtype=np.float64)
    except ValueError:
        return np.array([v if v != "" else np.nan for v in values], dtype=object)


def _missing(n: int) -> np.ndarray:
    return np.full(n, np.nan)


def _join(parts: List[np.ndarray]) -> np.ndarray:
    """Row-wise join of column pieces with numpy's promotion; strings with
    anything give strings; empty pieces do not count."""
    parts = [p for p in parts if len(p)] or parts[:1]
    if any(p.dtype.kind in "OUS" for p in parts):
        return np.concatenate([p.astype(object) for p in parts])
    return np.concatenate(parts)


class Table:
    """Named numpy columns of equal length, in order."""

    def __init__(self, columns: Optional[Dict[str, Iterable]] = None, n_rows: int = None):
        self.data: Dict[str, np.ndarray] = {}
        self._n = n_rows
        for name, values in (columns or {}).items():
            self[name] = values

    @property
    def columns(self) -> List[str]:
        return list(self.data)

    def __len__(self) -> int:
        if self.data:
            return len(next(iter(self.data.values())))
        return self._n or 0

    def __contains__(self, name: str) -> bool:
        return name in self.data

    def __getitem__(self, name: str) -> np.ndarray:
        return self.data[name]

    def __setitem__(self, name: str, values) -> None:
        """Set a column, in place if it exists, else last; a scalar fills
        every row."""
        if np.ndim(values) == 0:
            values = np.full(len(self), values)
        values = np.asarray(values)
        if values.dtype.kind in "US":
            values = values.astype(object)
        if self.data and len(values) != len(self):
            raise ValueError(f"column {name} has {len(values)} rows, the table {len(self)}")
        self.data[name] = values

    def rename(self, old: str, new: str) -> None:
        """``t[new] = t[old]`` then drop ``old``: the column moves to the
        end unless ``new`` already exists."""
        values = self.data.pop(old)
        self[new] = values

    def select(self, names: Sequence[str]) -> "Table":
        return Table({n: self.data[n] for n in names}, n_rows=len(self))

    def take(self, rows) -> "Table":
        """The rows selected by a boolean mask or an index array."""
        rows = np.asarray(rows)
        n = int(rows.sum()) if rows.dtype == bool else len(rows)
        return Table({k: v[rows] for k, v in self.data.items()}, n_rows=n)

    def groupby(self, name: str) -> Iterator[Tuple[object, "Table"]]:
        """(key, rows of that key in table order), keys sorted."""
        keys = self.data[name]
        rows = np.array([i for i, k in enumerate(keys.tolist()) if not _is_nan(k)],
                        dtype=np.int64)
        if not len(rows):
            return
        unique, inverse = np.unique(keys[rows], return_inverse=True)
        order = rows[np.argsort(inverse, kind="stable")]
        start = 0
        for key, stop in zip(unique.tolist(), np.cumsum(np.bincount(inverse))):
            yield key, self.take(order[start:stop])
            start = stop

    def drop_duplicates(self) -> "Table":
        seen, keep = set(), []
        rows = zip(*(v.tolist() for v in self.data.values()))
        for i, row in enumerate(rows):
            key = tuple("\0nan" if _is_nan(v) else v for v in row)
            if key not in seen:
                seen.add(key)
                keep.append(i)
        return self.take(np.array(keep, dtype=np.int64))

    def merge_left(self, right: "Table", on: str) -> "Table":
        left_rows, right_rows = [], []
        matches: Dict[object, List[int]] = {}
        for j, key in enumerate(right[on].tolist()):
            matches.setdefault(key, []).append(j)
        for i, key in enumerate(self[on].tolist()):
            for j in matches.get(key, [-1]):
                left_rows.append(i)
                right_rows.append(j)
        left_rows = np.array(left_rows, dtype=np.int64)
        right_rows = np.array(right_rows, dtype=np.int64)
        hit = right_rows >= 0
        shared = (set(self.columns) & set(right.columns)) - {on}
        out = Table(n_rows=len(left_rows))
        for name, values in self.data.items():
            out[name + "_x" if name in shared else name] = values[left_rows]
        for name, values in right.data.items():
            if name == on:
                continue
            if not len(values):
                got = _missing(len(right_rows))
            else:
                got = values[np.where(hit, right_rows, 0)]
            if not hit.all():
                got = got.astype(np.float64) if got.dtype.kind in "iub" else got
                got[~hit] = np.nan
            out[name + "_y" if name in shared else name] = got
        return out

    def write_csv(self, f: IO[str], sep: str = "\t", header: bool = True) -> None:
        if header:
            _write_row(f, self.columns, sep)
        for row in zip(*(format_column(v) for v in self.data.values())):
            _write_row(f, row, sep)


def _write_row(f: IO[str], fields: Sequence[str], sep: str) -> None:
    if sep == ",":
        csv.writer(f, lineterminator="\n").writerow(fields)
    else:
        f.write(sep.join(fields) + "\n")


def concat(tables: Sequence[Table]) -> Table:
    """``pd.concat(tables, axis=0)``."""
    if not tables:
        raise ValueError("No objects to concatenate")
    names: List[str] = []
    for t in tables:
        names += [n for n in t.columns if n not in names]
    out = Table(n_rows=sum(len(t) for t in tables))
    for name in names:
        parts = [t[name] if name in t else _missing(len(t)) for t in tables]
        out[name] = _join(parts)
    return out


def read_csv(path: str, sep: str = "\t", header: bool = True,
             str_columns: Sequence[str] = ()) -> Table:
    """A delimited text table (``pd.read_csv(path, sep=sep)``): blank lines
    are skipped; without ``header`` the columns are named 0, 1, ..."""
    with open(path) as f:
        lines = [line.rstrip("\r\n") for line in f if line.strip()]
    if header and not lines:
        raise ValueError(f"{path}: no header line")
    names = lines[0].split(sep) if header else None
    rows = [line.split(sep) for line in lines[1 if header else 0:]]
    if names is None:
        names = list(range(max((len(r) for r in rows), default=0)))
    for row in rows:
        if len(row) > len(names):
            raise ValueError(f"{path}: a row has {len(row)} fields for {len(names)} "
                             f"columns: {row}")
        row += [""] * (len(names) - len(row))
    table = Table(n_rows=len(rows))
    for i, name in enumerate(names):
        values = [r[i] for r in rows]
        table[name] = (np.array(values, dtype=object) if name in str_columns
                       else parse_column(values))
    return table
