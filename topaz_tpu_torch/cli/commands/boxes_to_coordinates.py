"""topaz boxes_to_coordinates [deprecated] (topaz_tpu/cli/commands/
boxes_to_coordinates.py): the JAX CLI's flags and defaults."""
import os
import sys

name = "boxes_to_coordinates"
help = "convert .box format coordinates to tab delimited coordinates table"


def add_arguments(parser):
    parser.add_argument("files", nargs="+", help="path to input box files")
    parser.add_argument("--invert-y", action="store_true", help="invert (mirror) the y-axis particle coordinates")
    parser.add_argument("--imagedir", help="directory of images, required to invert the y-axis")
    parser.add_argument("--image-ext", default="tiff", help="image format extension (default: tiff)")
    parser.add_argument("-o", "--output", help="destination file (default: stdout)")
    return parser


def main(args):
    import glob

    import numpy as np

    from topaz_tpu_torch.io.coordinates import boxes_to_coordinates
    from topaz_tpu_torch.io.image import load_image
    from topaz_tpu_torch.io.table import concat, read_csv

    tables = []
    for path in args.files:
        if os.path.getsize(path) == 0:
            continue
        shape = None
        image_name = os.path.splitext(os.path.basename(path))[0]
        if args.invert_y:
            impath = glob.glob(os.path.join(args.imagedir, image_name) + "." + args.image_ext)[0]
            shape = load_image(impath).shape
        box = read_csv(path, header=False)
        box = np.stack([box[c] for c in box.columns], axis=1)
        tables.append(boxes_to_coordinates(box, image_name, shape=shape,
                                           invert_y=args.invert_y))
    table = concat(tables)
    if args.output is None:
        table.write_csv(sys.stdout)
    else:
        with open(args.output, "w") as f:
            table.write_csv(f)
