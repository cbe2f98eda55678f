"""Minimal RELION STAR reading and writing, without pandas (port of
topaz_tpu/io/star.py:17-111, the reference's topaz/utils/star.py:19-98).

``parse`` reads the first ``data_`` block's ``loop_`` table: 'rln' prefixes
and '#' comments come off the column names, the legacy 'ParticleScore'
becomes 'AutopickFigureOfMerit', and the known columns become numbers. The
table is a dict of numpy columns in file order. ``write`` writes a
'data_images' loop with '_rln<name> #<i>' headers and tab-separated rows.
"""

from __future__ import annotations

from typing import IO, Dict

import numpy as np

X_COLUMN_NAME = "CoordinateX"
Y_COLUMN_NAME = "CoordinateY"
SCORE_COLUMN_NAME = "AutopickFigureOfMerit"
OLD_SCORE_COLUMN_NAME = "ParticleScore"

VOLTAGE = "Voltage"
DETECTOR_PIXEL_SIZE = "DetectorPixelSize"
MAGNIFICATION = "Magnification"
AMPLITUDE_CONTRAST = "AmplitudeContrast"

_INT_COLUMNS = (X_COLUMN_NAME, Y_COLUMN_NAME)
_FLOAT_COLUMNS = (SCORE_COLUMN_NAME, VOLTAGE, DETECTOR_PIXEL_SIZE, MAGNIFICATION,
                  AMPLITUDE_CONTRAST)


def _clean_column(raw: str) -> str:
    name = raw[1:]  # strip leading underscore
    loc = name.find("#")
    if loc >= 0:
        name = name[:loc]
    name = name.strip()
    if name.startswith("rln"):
        name = name[3:]
    return name


def _is_block_start(stripped: str) -> bool:
    """A new data block is a bare ``data_<name>`` token; a body row whose
    first cell merely starts with 'data' is particle data."""
    return stripped.startswith("data_") and len(stripped.split()) == 1


def parse(f: IO[str]) -> Dict[str, np.ndarray]:
    """The first data_ block of a STAR file as {column: numpy array}."""
    columns, rows = [], []
    state = "preamble"  # -> in_data -> in_loop -> in_body
    for line in f:
        stripped = line.strip()
        if state == "preamble":
            if stripped.startswith("data_"):
                state = "in_data"
        elif state == "in_data":
            if stripped.startswith("loop_"):
                state = "in_loop"
        elif state == "in_loop":
            if stripped.startswith("_"):
                columns.append(_clean_column(stripped))
            elif stripped:
                if _is_block_start(stripped):
                    break
                state = "in_body"
                if not (stripped.startswith("#") or stripped.startswith(";")):
                    rows.append(stripped.split())
        elif state == "in_body":
            if _is_block_start(stripped):
                break
            if stripped.startswith("#") or stripped.startswith(";") or not stripped:
                continue
            rows.append(stripped.split())

    for row in rows:
        if len(row) != len(columns):
            raise ValueError(f"STAR row has {len(row)} fields for {len(columns)} "
                             f"columns: {row}")
    table = {name: np.array([row[i] for row in rows], dtype=object)
             for i, name in enumerate(columns)}
    if OLD_SCORE_COLUMN_NAME in table and SCORE_COLUMN_NAME not in table:
        table[SCORE_COLUMN_NAME] = table.pop(OLD_SCORE_COLUMN_NAME)
    for col in _INT_COLUMNS:
        if col in table:
            table[col] = table[col].astype(float).astype(np.int64)
    for col in _FLOAT_COLUMNS:
        if col in table:
            table[col] = table[col].astype(float)
    return table


def write(table: Dict[str, np.ndarray], f: IO[str]) -> None:
    """Write a data_images loop (topaz/utils/star.py:91-98)."""
    print("data_images", file=f)
    print("loop_", file=f)
    names = list(table)
    for i, name in enumerate(names):
        print(f"_rln{name} #{i + 1}", file=f)
    # numpy scalars print as pandas' to_csv prints them (float32 shortest)
    for row in zip(*(np.asarray(table[n]) for n in names)):
        print("\t".join(str(v) for v in row), file=f)
