"""topaz coordinates_to_boxes [deprecated] (topaz_tpu/cli/commands/
coordinates_to_boxes.py): the JAX CLI's flags and defaults; image names
stay strings."""
import os

name = "coordinates_to_boxes"
help = "convert coordinates table to .box format files per image"


def add_arguments(parser):
    parser.add_argument("paths", nargs="+", help="path to input coordinates file")
    parser.add_argument("--destdir", required=True, help="directory to write per image files")
    parser.add_argument("--boxsize", required=True, type=int, help="size of particle boxes")
    parser.add_argument("--invert-y", action="store_true", help="invert (mirror) the y-axis particle coordinates")
    parser.add_argument("--imagedir", help="directory of images, required to invert the y-axis")
    parser.add_argument("--image-ext", default="tiff", help="image format extension (default: tiff)")
    return parser


def image_shape(args, image_name):
    """The shape of the image ``image_name`` under --imagedir where
    --invert-y asks for it, else None."""
    import glob

    from topaz_tpu_torch.io.image import load_image

    if not args.invert_y:
        return None
    return load_image(glob.glob(os.path.join(args.imagedir, image_name) + "."
                                + args.image_ext)[0]).shape


def read_tables(paths):
    """The coordinate tables of ``paths`` joined, duplicate rows dropped."""
    from topaz_tpu_torch.io.table import concat, read_csv

    return concat([read_csv(p, str_columns=("image_name",)) for p in paths]).drop_duplicates()


def main(args):
    import numpy as np

    from topaz_tpu_torch.io.coordinates import coordinates_to_boxes, write_boxes

    coords = read_tables(args.paths)
    os.makedirs(args.destdir, exist_ok=True)
    for image_name, group in coords.groupby("image_name"):
        xy = np.stack([group["x_coord"], group["y_coord"]], axis=1).astype(np.int32)
        boxes = coordinates_to_boxes(xy, args.boxsize, args.boxsize,
                                     shape=image_shape(args, image_name), invert_y=args.invert_y)
        with open(os.path.join(args.destdir, image_name + ".box"), "w") as f:
            write_boxes(f, boxes)
