"""topaz star_to_coordinates [deprecated] (topaz_tpu/cli/commands/
star_to_coordinates.py): the JAX CLI's flags and defaults."""
import sys

name = "star_to_coordinates"
help = "convert .star file coordinates to tab delimited coordinates table"


def add_arguments(parser):
    parser.add_argument("file", help="path to input star file")
    parser.add_argument("-o", "--output", help="output file (default: stdout)")
    return parser


def main(args):
    import os

    import numpy as np

    from topaz_tpu_torch.io import star
    from topaz_tpu_torch.io.table import Table

    with open(args.file) as f:
        table = star.parse(f)
    out = Table({
        "image_name": np.array([os.path.splitext(p)[0] for p in table["MicrographName"]],
                               dtype=object),
        "x_coord": table["CoordinateX"].astype(float).astype(int),
        "y_coord": table["CoordinateY"].astype(float).astype(int)})
    for col in ("ParticleScore", star.SCORE_COLUMN_NAME):
        if col in table:
            out["score"] = table[col]
            break
    if args.output is None:
        out.write_csv(sys.stdout)
    else:
        with open(args.output, "w") as f:
            out.write_csv(f)
