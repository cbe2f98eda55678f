"""Minimal RELION STAR reading and writing, without pandas (port of
topaz_tpu/io/star.py:17-131, the reference's topaz/utils/star.py:19-98).

``parse`` reads the first ``data_`` block's ``loop_`` table: 'rln' prefixes
and '#' comments come off the column names, the legacy 'ParticleScore'
becomes 'AutopickFigureOfMerit', and the known columns become numbers. The
table is a dict of numpy columns in file order. ``write`` writes a
'data_images' loop with '_rln<name> #<i>' headers and tab-separated rows.
"""

from __future__ import annotations

import sys
from typing import IO, Dict, Optional

import numpy as np

from topaz_tpu_torch.io.table import Table

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


def write(table, f: IO[str]) -> None:
    """Write a data_images loop (topaz/utils/star.py:91-98) of a
    ``Table`` or a {column: array} dict, each value as pandas' ``to_csv``
    prints it (float32 in its shortest form, NaN as an empty field)."""
    if not isinstance(table, Table):
        table = Table(table)
    print("data_images", file=f)
    print("loop_", file=f)
    for i, name in enumerate(table.columns):
        print(f"_rln{name} #{i + 1}", file=f)
    table.write_csv(f, header=False)


def threshold_star_particles(input_file: str, threshold: float,
                             output_file: Optional[str] = None) -> None:
    """Keep the particles of a STAR file whose score is at least
    ``threshold``, every column kept (topaz_tpu/io/star.py:114-131); the
    score is AutopickFigureOfMerit, else the legacy ParticleScore."""
    with open(input_file) as f:
        particles = Table(parse(f))
    n = len(particles)
    col = SCORE_COLUMN_NAME if SCORE_COLUMN_NAME in particles else OLD_SCORE_COLUMN_NAME
    particles[col] = particles[col].astype(float)
    particles = particles.take(particles[col] >= threshold)
    print(f"# filtered {n} particles to {len(particles)} with threshold of {threshold}",
          file=sys.stderr)
    out = sys.stdout if output_file is None else open(output_file, "w")
    try:
        write(particles, out)
    finally:
        if output_file is not None:
            out.close()
