"""Particle coordinate files (port of topaz_tpu/io/coordinates.py, the
reference's topaz/utils/files.py and topaz/utils/conversions.py), without
pandas.

The JAX package holds coordinates in a pandas DataFrame; the card's machine
has no pandas. The port has two forms:

- ``Coordinates``, for training and extraction: one numpy array a column,
  ``image_name``, ``x_coord`` and ``y_coord``, and the optional
  ``z_coord``, ``score`` and ``source``; other columns are dropped. It has
  what training needs: the rows under a mask (``take``), the rows of one
  image (``for_image``), and the first source of each image
  (``source_by_image``).
- ``io.table.Table``, for the coordinate tools: every column of a file in
  the JAX package's order, with the microscope and other STAR columns.

Reading covers the coord (TSV), STAR, EMAN .box and VIA CSV formats;
writing covers those and EMAN2 box-manager JSON, byte for byte as the JAX
package's pandas writers write them (numbers as numpy prints them, so
float32 scores keep their shortest form). Image names stay strings
everywhere: ``0001`` is not the number 1.
"""

from __future__ import annotations

import csv
import glob
import json
import os
import sys
from dataclasses import dataclass, fields
from typing import IO, Dict, List, Optional, Sequence, Union

import numpy as np

from topaz_tpu_torch.io import star
from topaz_tpu_torch.io.table import Table, concat, read_csv

PARTICLE_FORMAT_MAP = {
    ".star": "star",
    ".box": "box",
    ".json": "json",
    ".csv": "csv",
    ".txt": "coord",
    ".tab": "coord",
}

IMAGE_FORMATS = (".mrc", ".tiff", ".tif", ".png", ".jpg", ".jpeg")

# canonical <-> star column names (topaz/utils/files.py:173-181)
_STAR_TO_CANONICAL = {
    star.SCORE_COLUMN_NAME: "score",
    "MicrographName": "image_name",
    star.X_COLUMN_NAME: "x_coord",
    star.Y_COLUMN_NAME: "y_coord",
    star.VOLTAGE: "voltage",
    star.DETECTOR_PIXEL_SIZE: "detector_pixel_size",
    star.MAGNIFICATION: "magnification",
    star.AMPLITUDE_CONTRAST: "amplitude_contrast",
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

    def to_table(self) -> Table:
        return Table({c: getattr(self, c) for c in self.columns})


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


def mirror_y_axis(table: Table, n: int) -> Table:
    """Flip y coordinates on an n-row image (conversions.py:16-19)."""
    out = table.take(np.arange(len(table)))
    out["y_coord"] = n - 1 - out["y_coord"]
    return out


def read_box(path: str) -> np.ndarray:
    """EMAN .box rows: x_lower_left, y_lower_left, width, height."""
    rows = []
    with open(path) as f:
        for line in f:
            tokens = line.split()
            if tokens:
                rows.append([int(t) for t in tokens[:4]])
    return np.array(rows, dtype=int) if rows else np.zeros((0, 4), dtype=int)


def boxes_to_coordinates(boxes: np.ndarray, image_name: str, shape=None,
                         invert_y: bool = False) -> Table:
    """Box corners and sizes -> centers (topaz/utils/conversions.py:22-52);
    with ``invert_y`` the y axis of an image of ``shape`` is mirrored."""
    boxes = np.asarray(boxes)
    if len(boxes) < 1:  # the JAX package's empty frame, columns in its order
        return Table({"x_coord": [], "y_coord": [], "image_name": []})
    x_lo, y_lo, width, height = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    y_coord = y_lo + height // 2
    if invert_y:
        y_coord = (shape[0] - 1 - y_lo) - height // 2
    return Table({"image_name": np.array([image_name] * len(boxes), dtype=object),
                  "x_coord": x_lo + width // 2, "y_coord": y_coord})


def read_via_csv(path: str) -> Table:
    """A VIA (VGG annotator) CSV of picks (files.py:65-107)."""
    with open(path, newline="") as f:
        rows = [r for r in csv.DictReader(f) if int(r["region_count"]) > 0]
    regions = [json.loads(r["region_shape_attributes"]) for r in rows]
    table = Table({"image_name": np.array([strip_ext(r["filename"]) for r in rows],
                                          dtype=object),
                   "x_coord": np.array([g["cx"] for g in regions], dtype=int),
                   "y_coord": np.array([g["cy"] for g in regions], dtype=int)})
    atts = [json.loads(r["region_attributes"]) for r in rows]
    if atts and "score" in atts[0]:
        table["score"] = np.array([float(a.get("score", -np.inf)) for a in atts],
                                  dtype=np.float32)
    return table


def read_coordinates_table(path: str, format: str = "auto") -> Table:
    """Read any supported particle file into a table of every column, in
    the JAX package's order (topaz_tpu/io/coordinates.py:215-239): from
    STAR the canonical columns are renamed and moved last."""
    if format == "auto":
        format = detect_format(path)
    if format == "star":
        with open(path) as f:
            table = Table(star.parse(f))
        for k, v in _STAR_TO_CANONICAL.items():
            if k in table:
                table.rename(k, v)
        table["image_name"] = np.array([strip_ext(n) for n in table["image_name"]],
                                       dtype=object)
    elif format == "box":
        table = boxes_to_coordinates(read_box(path), os.path.basename(strip_ext(path)))
    elif format == "csv":
        table = read_via_csv(path)
    elif format == "coord":
        table = read_csv(path, str_columns=("image_name",))
    else:
        raise ValueError(f"cannot read {format} coordinates")
    if "image_name" in table and len(table):
        table["image_name"] = np.array([strip_image_ext(n) for n in table["image_name"]],
                                       dtype=object)
    return table


def read_coordinates(path: str, format: str = "auto") -> Coordinates:
    """Read any supported particle file into the canonical columns
    (topaz/utils/files.py:164-205)."""
    return Coordinates.from_columns(read_coordinates_table(path, format).data)


def write_tsv(f: IO[str], table: Coordinates, columns: Sequence[str]) -> None:
    """``columns`` of ``table`` as a tab-separated table with a header, each
    value as pandas' ``to_csv`` writes it."""
    table.to_table().select(columns).write_csv(f)


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


def write_boxes(f: IO[str], boxes: np.ndarray) -> None:
    """Box rows, tab-separated, no header."""
    Table({i: boxes[:, i] for i in range(boxes.shape[1])}).write_csv(f, header=False)


def write_via_csv(f: IO[str], table: Table) -> None:
    """Picks as a VIA (VGG annotator) CSV (topaz_tpu/io/coordinates.py:
    185-210): one row a pick, ``region_count`` the picks of its image and
    ``region_id`` its rank among them in table order."""
    names = table["image_name"].tolist()
    counts: Dict[str, int] = {}
    for name in names:
        counts[name] = counts.get(name, 0) + 1
    seen: Dict[str, int] = {}
    writer = csv.writer(f, lineterminator="\n")
    writer.writerow(["filename", "file_size", "file_attributes", "region_count",
                     "region_id", "region_shape_attributes", "region_attributes"])
    scores = table["score"].tolist() if "score" in table else [None] * len(names)
    for name, x, y, score in zip(names, table["x_coord"].tolist(), table["y_coord"].tolist(),
                                 scores):
        region_id = seen.get(name, 0)
        seen[name] = region_id + 1
        writer.writerow([name + ".png", -1, "{}", counts[name], region_id,
                         f'{{"name":"point","cx":{x},"cy":{y}}}',
                         "{}" if score is None else f'{{"score":"{score}"}}'])


def coordinates_to_star_table(table: Table, image_ext: str = "") -> Table:
    """Canonical pick columns renamed to their STAR names and moved last
    (conversions.py:173-195), the image extension added to MicrographName."""
    out = table.take(np.arange(len(table)))
    for k, v in _CANONICAL_TO_STAR.items():
        if k in out:
            out.rename(k, v)
    out["MicrographName"] = np.array([n + image_ext for n in out["MicrographName"]],
                                     dtype=object)
    return out


def _coord_columns(table: Table) -> List[str]:
    return [c for c in ("image_name", "x_coord", "y_coord", "z_coord", "score")
            if c in table]


def _xy(table: Table, dtype) -> np.ndarray:
    return np.stack([table["x_coord"], table["y_coord"]], axis=1).astype(dtype)


def write_table(f: IO[str], table: Union[Table, Coordinates], format: str = "coord",
                boxsize: int = 0, image_ext: str = "") -> None:
    """Write one already-open stream (topaz/utils/files.py:242-268,
    topaz_tpu/io/coordinates.py:287-302)."""
    if isinstance(table, Coordinates):
        table = table.to_table()
    if format in ("coord", "auto"):
        table.select(_coord_columns(table)).write_csv(f)
    elif format == "star":
        star.write(coordinates_to_star_table(table, image_ext=image_ext), f)
    elif format == "box":
        write_boxes(f, coordinates_to_boxes(_xy(table, np.int32), boxsize, boxsize))
    elif format == "json":
        json.dump({"boxes": coordinates_to_eman2_json(_xy(table, int))}, f, indent=0)
    elif format == "csv":
        write_via_csv(f, table)
    else:
        raise ValueError(f"unknown coordinate format {format!r}")


def write_coordinates(path: str, table: Table, format: str = "auto", boxsize: int = 0,
                      image_ext: str = ".mrc", suffix: str = "") -> None:
    """Write ``table`` to ``path`` in ``format`` (topaz/utils/files.py:208-239);
    box and json write one file an image, in sorted order, into the
    directory ``path``."""
    if format in ("box", "json"):
        for image_name, group in table.groupby("image_name"):
            tail = ".box" if format == "box" else "_info.json"
            with open(os.path.join(path, image_name + suffix + tail), "w") as f:
                write_table(f, group, format=format, boxsize=boxsize)
    else:
        with open(path, "w") as f:
            write_table(f, table, format=format, image_ext=image_ext)


def get_image_path(image_name: str, root: str, ext: str) -> Optional[str]:
    """The image file of a coordinate row (topaz/utils/files.py:271-294):
    the match of ``root/<image_name>.<ext>``; of several, the first .tiff,
    .mrc or .png; None, with a warning, where nothing matches."""
    paths = glob.glob(os.path.join(root, image_name + "." + ext))
    if not paths:
        print(f'WARNING: no micrograph found matching image name "{image_name}". '
              f"Skipping it.", file=sys.stderr)
        return None
    if len(paths) > 1:
        print(f"WARNING: multiple images detected matching to image_name={image_name}",
              file=sys.stderr)
        for preferred in (".tiff", ".mrc", ".png"):
            for p in paths:
                if p.endswith(preferred):
                    return os.path.abspath(p)
    return os.path.abspath(paths[0])


def train_test_split_micrographs(seed: int, n: int, path: str, format: str,
                                 image_dir: str, file_ext: str):
    """Random micrograph-level train/test split; writes <path>_train.txt,
    <path>_test.txt and the image lists image_list_{train,test}.txt beside
    ``path`` (topaz/utils/data/train_test_split_micrographs.py:11-90). The
    draw is ``np.random.RandomState(seed).permutation`` over the image
    names in sorted order, as the JAX package draws it."""
    random = np.random.RandomState(seed)
    coords = read_coordinates_table(path, format=format)
    image_names, groups = [], []
    for name, group in coords.groupby("image_name"):
        image_names.append(name)
        groups.append(group)
    print(f"# splitting {len(image_names)} micrographs with {len(coords)} "
          f"labeled particles into {len(image_names) - n} train and {n} test "
          f"micrographs", file=sys.stderr)
    order = random.permutation(len(image_names))
    test_idx, train_idx = order[:n], order[n:]

    def image_list(indices):
        kept, paths = [], []
        for j in indices:
            p = get_image_path(image_names[j], image_dir, file_ext)
            if p is not None:
                kept.append(image_names[j])
                paths.append(p)
        return Table({"image_name": np.array(kept, dtype=object),
                      "path": np.array(paths, dtype=object)})

    targets_train = concat([groups[j] for j in train_idx])
    targets_test = concat([groups[j] for j in test_idx])
    image_list_train, image_list_test = image_list(train_idx), image_list(test_idx)
    root = os.path.dirname(path) or "."
    basename = os.path.splitext(path)[0]
    for out_path, table in [
            (basename + "_train.txt", targets_train),
            (basename + "_test.txt", targets_test),
            (os.path.join(root, "image_list_train.txt"), image_list_train),
            (os.path.join(root, "image_list_test.txt"), image_list_test)]:
        print("# writing:", out_path, file=sys.stderr)
        with open(out_path, "w") as f:
            table.write_csv(f)
    return image_list_train, image_list_test, targets_train, targets_test


def split_particle_file(input_file: str, format: str, suffix: str, threshold: float,
                        output_dir: str) -> None:
    """Split a particle file into one file a micrograph, rows with a score
    below ``threshold`` left out (topaz/utils/files.py:297-329). A STAR
    MicrographName is a relative path (MotionCorr/job002/mic.mrc); its
    base name without extension names the file."""
    output_dir = output_dir.rstrip("/")
    if format == "auto":
        format = detect_format(input_file)
    ext = os.path.splitext(input_file)[1]
    if format == "star":
        with open(input_file) as f:
            table = Table(star.parse(f))
        key, score = "MicrographName", star.SCORE_COLUMN_NAME
    else:
        table = read_csv(input_file, str_columns=("image_name",))
        key, score = "image_name", "score"
    if score in table:
        table = table.take(table[score] >= threshold)
    for image_name, group in table.groupby(key):
        name = os.path.splitext(os.path.basename(image_name))[0] if format == "star" \
            else image_name
        with open(os.path.join(output_dir, name + suffix + ext), "w") as f:
            if format == "star":
                star.write(group, f)
            else:
                group.write_csv(f)
