"""topaz coordinates_to_eman2_json [deprecated] (topaz_tpu/cli/commands/
coordinates_to_eman2_json.py): the JAX CLI's flags and defaults."""
import os

name = "coordinates_to_eman2_json"
help = "convert coordinates table to EMAN2 json format files per image"


def add_arguments(parser):
    parser.add_argument("paths", nargs="+", help="path to input coordinates file")
    parser.add_argument("--destdir", required=True, help="directory to write per image files")
    parser.add_argument("--invert-y", action="store_true", help="invert (mirror) the y-axis particle coordinates")
    parser.add_argument("--imagedir", help="directory of images, required to invert the y-axis")
    parser.add_argument("--image-ext", default="tiff", help="image format extension (default: tiff)")
    return parser


def main(args):
    import json

    import numpy as np

    from topaz_tpu_torch.cli.commands.coordinates_to_boxes import image_shape, read_tables
    from topaz_tpu_torch.io.coordinates import coordinates_to_eman2_json

    coords = read_tables(args.paths)
    os.makedirs(args.destdir, exist_ok=True)
    for image_name, group in coords.groupby("image_name"):
        xy = np.stack([group["x_coord"], group["y_coord"]], axis=1).astype(int)
        boxes = coordinates_to_eman2_json(xy, shape=image_shape(args, image_name),
                                          invert_y=args.invert_y)
        with open(os.path.join(args.destdir, image_name + "_info.json"), "w") as f:
            json.dump({"boxes": boxes}, f, indent=0)
