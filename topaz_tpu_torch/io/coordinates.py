"""Particle coordinate files (port of topaz_tpu/io/coordinates.py:25-302, the
reference's topaz/utils/files.py), without pandas.

The JAX package holds coordinates in a pandas DataFrame; the card's machine
has no pandas, so the port holds them in ``Coordinates``: one numpy array a
column, ``image_name``, ``x_coord`` and ``y_coord``, and the optional
``z_coord``, ``score`` and ``source``. Other columns of a file are dropped.
It has what training needs: the rows under a mask (``take``), the rows of
one image (``for_image``), and the first source of each image
(``source_by_image``). Reading covers the coord (TSV), STAR, EMAN .box and
VIA CSV formats; writing covers those and EMAN2 box-manager JSON, byte for
byte as the JAX package's pandas writers write them (numbers as numpy
prints them, so float32 scores keep their shortest form).
"""

from __future__ import annotations

import csv
import json
import os
from dataclasses import dataclass, fields
from typing import IO, Dict, List, Optional, Sequence

import numpy as np

from topaz_tpu_torch.io import star

PARTICLE_FORMAT_MAP = {
    ".star": "star",
    ".box": "box",
    ".json": "json",
    ".csv": "csv",
    ".txt": "coord",
    ".tab": "coord",
}

IMAGE_FORMATS = (".mrc", ".tiff", ".tif", ".png", ".jpg", ".jpeg")

# canonical <-> star column names (topaz/utils/files.py:173-181); the
# microscope columns have no place in the table and are dropped
_STAR_TO_CANONICAL = {
    star.SCORE_COLUMN_NAME: "score",
    "MicrographName": "image_name",
    star.X_COLUMN_NAME: "x_coord",
    star.Y_COLUMN_NAME: "y_coord",
}
_CANONICAL_TO_STAR = {v: k for k, v in _STAR_TO_CANONICAL.items()}


@dataclass
class Coordinates:
    """Particle coordinates, one entry a particle in every column."""

    image_name: np.ndarray
    x_coord: np.ndarray
    y_coord: np.ndarray
    z_coord: Optional[np.ndarray] = None
    score: Optional[np.ndarray] = None
    source: Optional[np.ndarray] = None

    def __post_init__(self):
        self.image_name = np.array([str(n) for n in self.image_name], dtype=object)
        for name in self.columns[1:]:
            setattr(self, name, np.asarray(getattr(self, name)))
            if len(getattr(self, name)) != len(self.image_name):
                raise ValueError(f"column {name} has {len(getattr(self, name))} "
                                 f"rows, image_name {len(self.image_name)}")

    @classmethod
    def from_columns(cls, columns: Dict[str, Sequence]) -> "Coordinates":
        """The canonical columns of ``columns``; others are dropped."""
        missing = [c for c in ("image_name", "x_coord", "y_coord") if c not in columns]
        if missing:
            raise ValueError(f"coordinates lack the column(s) {missing}; found "
                             f"{sorted(columns)}")
        return cls(**{f.name: columns[f.name] for f in fields(cls) if f.name in columns})

    @property
    def columns(self) -> List[str]:
        return [f.name for f in fields(self) if getattr(self, f.name) is not None]

    def __len__(self) -> int:
        return len(self.image_name)

    def take(self, rows) -> "Coordinates":
        """The rows selected by a boolean mask or an index array."""
        return Coordinates(**{c: getattr(self, c)[rows] for c in self.columns})

    def for_image(self, name: str) -> "Coordinates":
        return self.take(self.image_name == name)

    def source_by_image(self) -> Dict[str, object]:
        """{image name: source of its first row} (DataFrame
        groupby('image_name')['source'].first())."""
        out: Dict[str, object] = {}
        for name, source in zip(self.image_name, self.source.tolist()):
            out.setdefault(name, source)
        return out


class UnknownFormatError(Exception):
    """Unrecognized coordinate-file extension (topaz/utils/files.py:32-36)."""

    def __init__(self, ext):
        super().__init__(f"unrecognized coordinate file extension: {ext!r}")
        self.ext = ext


def detect_format(path: str) -> str:
    """Map a file extension to its coordinate format name (files.py:16-36)."""
    ext = os.path.splitext(path)[1]
    if ext not in PARTICLE_FORMAT_MAP:
        raise UnknownFormatError(ext)
    return PARTICLE_FORMAT_MAP[ext]


def strip_ext(name: str) -> str:
    """Drop one trailing file extension from a name."""
    return os.path.splitext(name)[0]


def strip_image_ext(filename: str) -> str:
    """Strip known image extensions from a micrograph name (files.py:39-62)."""
    name, ext = os.path.splitext(filename)
    return name if ext in IMAGE_FORMATS else filename


def parse_column(values: Sequence[str]) -> np.ndarray:
    """A text column as pandas' reader types it: int64 when every value is
    an integer, else float64 when every value is a number, else strings."""
    for kind in (int, float):
        try:
            return np.array([kind(v) for v in values], dtype=np.int64 if kind is int
                            else np.float64)
        except ValueError:
            pass
    return np.array(list(values), dtype=object)


def read_tsv(path: str, str_columns: Sequence[str] = ()) -> Dict[str, np.ndarray]:
    """A tab-separated table with a header line as {column: array}; blank
    lines are skipped and ``str_columns`` stay strings."""
    with open(path) as f:
        lines = [line.rstrip("\r\n") for line in f if line.strip()]
    if not lines:
        raise ValueError(f"{path}: no header line")
    header = lines[0].split("\t")
    rows = [line.split("\t") for line in lines[1:]]
    for row in rows:
        if len(row) != len(header):
            raise ValueError(f"{path}: a row has {len(row)} fields for "
                             f"{len(header)} columns: {row}")
    return {name: (np.array([r[i] for r in rows], dtype=object) if name in str_columns
                   else parse_column([r[i] for r in rows]))
            for i, name in enumerate(header)}


def read_box(path: str) -> np.ndarray:
    """EMAN .box rows: x_lower_left, y_lower_left, width, height."""
    rows = []
    with open(path) as f:
        for line in f:
            tokens = line.split()
            if tokens:
                rows.append([int(t) for t in tokens[:4]])
    return np.array(rows, dtype=int) if rows else np.zeros((0, 4), dtype=int)


def boxes_to_coordinates(boxes: np.ndarray, image_name: str) -> Coordinates:
    """Box corners and sizes -> centers (topaz/utils/conversions.py:22-52)."""
    boxes = np.asarray(boxes, dtype=int).reshape(-1, 4)
    return Coordinates(np.array([image_name] * len(boxes), dtype=object),
                       boxes[:, 0] + boxes[:, 2] // 2, boxes[:, 1] + boxes[:, 3] // 2)


def read_via_csv(path: str) -> Coordinates:
    """A VIA (VGG annotator) CSV of picks (files.py:65-107)."""
    with open(path, newline="") as f:
        rows = [r for r in csv.DictReader(f) if int(r["region_count"]) > 0]
    regions = [json.loads(r["region_shape_attributes"]) for r in rows]
    table = Coordinates(np.array([strip_ext(r["filename"]) for r in rows], dtype=object),
                        np.array([g["cx"] for g in regions], dtype=int),
                        np.array([g["cy"] for g in regions], dtype=int))
    atts = [json.loads(r["region_attributes"]) for r in rows]
    if atts and "score" in atts[0]:
        table.score = np.array([float(a.get("score", -np.inf)) for a in atts],
                               dtype=np.float32)
    return table


def read_coordinates(path: str, format: str = "auto") -> Coordinates:
    """Read any supported particle file into the canonical table
    (topaz/utils/files.py:164-205)."""
    if format == "auto":
        format = detect_format(path)
    if format == "star":
        with open(path) as f:
            columns = {_STAR_TO_CANONICAL.get(k, k): v for k, v in star.parse(f).items()}
        if "image_name" in columns:
            columns["image_name"] = [strip_ext(n) for n in columns["image_name"]]
        table = Coordinates.from_columns(columns)
    elif format == "box":
        table = boxes_to_coordinates(read_box(path), os.path.basename(strip_ext(path)))
    elif format == "csv":
        table = read_via_csv(path)
    elif format == "coord":
        table = Coordinates.from_columns(read_tsv(path, str_columns=("image_name",)))
    else:
        raise NotImplementedError(f"reading {format} coordinates is not yet ported "
                                  f"to topaz_tpu_torch")
    table.image_name = np.array([strip_image_ext(n) for n in table.image_name], dtype=object)
    return table


def write_tsv(f: IO[str], table: Coordinates, columns: Sequence[str]) -> None:
    """``columns`` of ``table`` as a tab-separated table with a header, each
    value as pandas' ``to_csv`` writes it."""
    print("\t".join(columns), file=f)
    for row in zip(*(getattr(table, c) for c in columns)):
        print("\t".join(str(v) for v in row), file=f)


def coordinates_to_boxes(coords: np.ndarray, box_width: int, box_height: int,
                         shape=None, invert_y: bool = False) -> np.ndarray:
    """Center coordinates -> EMAN box rows (x_lower_left, y_lower_left,
    width, height) (topaz_tpu/io/coordinates.py:127-137)."""
    x = np.asarray(coords[:, 0])
    y = np.asarray(coords[:, 1])
    if invert_y:
        y = shape[0] - 1 - y
    w = np.full(len(x), box_width, dtype=np.int32)
    h = np.full(len(x), box_height, dtype=np.int32)
    return np.stack([x - w // 2, y - h // 2, w, h], axis=1)


def coordinates_to_eman2_json(coords: np.ndarray, shape=None, invert_y: bool = False,
                              tag: str = "manual") -> List[list]:
    """Center coordinates -> EMAN2 box-manager entries [x, y, tag]
    (topaz_tpu/io/coordinates.py:140-148)."""
    x = np.asarray(coords[:, 0])
    y = np.asarray(coords[:, 1])
    if invert_y:
        y = shape[0] - 1 - y
    return [[int(xi), int(yi), tag] for xi, yi in zip(x, y)]


def write_via_csv(f: IO[str], table: Coordinates) -> None:
    """Picks as a VIA (VGG annotator) CSV (topaz_tpu/io/coordinates.py:
    185-210): one row a pick, ``region_count`` the picks of its image and
    ``region_id`` its rank among them in table order."""
    names = table.image_name.tolist()
    counts: Dict[str, int] = {}
    for name in names:
        counts[name] = counts.get(name, 0) + 1
    seen: Dict[str, int] = {}
    writer = csv.writer(f, lineterminator="\n")
    writer.writerow(["filename", "file_size", "file_attributes", "region_count",
                     "region_id", "region_shape_attributes", "region_attributes"])
    scores = table.score.tolist() if table.score is not None else [None] * len(names)
    for name, x, y, score in zip(names, table.x_coord.tolist(), table.y_coord.tolist(),
                                 scores):
        region_id = seen.get(name, 0)
        seen[name] = region_id + 1
        writer.writerow([name + ".png", -1, "{}", counts[name], region_id,
                         f'{{"name":"point","cx":{x},"cy":{y}}}',
                         "{}" if score is None else f'{{"score":"{score}"}}'])


def write_table(f: IO[str], table: Coordinates, format: str = "coord",
                boxsize: int = 0, image_ext: str = "") -> None:
    """Write one already-open stream (topaz/utils/files.py:242-268,
    topaz_tpu/io/coordinates.py:287-302)."""
    if format == "coord":
        write_tsv(f, table, [c for c in table.columns if c != "source"])
    elif format == "star":
        # renamed columns go last, in this order, as the JAX package writes them
        out = {c: getattr(table, c) for c in table.columns if c not in _CANONICAL_TO_STAR}
        out.update((name, getattr(table, c)) for c, name in _CANONICAL_TO_STAR.items()
                   if c in table.columns)
        out["MicrographName"] = np.array([n + image_ext for n in table.image_name],
                                         dtype=object)
        star.write(out, f)
    elif format == "box":
        xy = np.stack([table.x_coord, table.y_coord], axis=1).astype(np.int32)
        for row in coordinates_to_boxes(xy, boxsize, boxsize):
            print("\t".join(str(v) for v in row), file=f)
    elif format == "json":
        xy = np.stack([table.x_coord, table.y_coord], axis=1).astype(int)
        json.dump({"boxes": coordinates_to_eman2_json(xy)}, f, indent=0)
    elif format == "csv":
        write_via_csv(f, table)
    else:
        raise ValueError(f"unknown coordinate format {format!r}")
