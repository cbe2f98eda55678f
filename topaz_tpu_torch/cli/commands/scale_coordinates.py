"""topaz scale_coordinates [deprecated] (topaz_tpu/cli/commands/
scale_coordinates.py): the JAX CLI's flags and defaults; image names stay
strings."""
name = "scale_coordinates"
help = "scale particle coordinates for resized images"


def add_arguments(parser):
    parser.add_argument("file")
    parser.add_argument("-s", "--scale", default=0.25, type=float, help="scaling factor, coordinates become roughly <scale*x,scale*y> (default: 0.25)")
    parser.add_argument("-o", "--output", help="output file")
    return parser


def main(args):
    from topaz_tpu_torch.ops.masks import scale_coordinates_file

    scale_coordinates_file(args.file, args.scale, args.output)
