"""topaz coordinates_to_star [deprecated] (topaz_tpu/cli/commands/
coordinates_to_star.py): the JAX CLI's flags and defaults."""
import sys

name = "coordinates_to_star"
help = "convert coordinates table to .star file format"


def add_arguments(parser):
    parser.add_argument("file", help="path to input coordinates file")
    parser.add_argument("--image-ext", default=".mrc", help="image file extension")
    parser.add_argument("--voltage", type=float, default=-1, help="voltage setting")
    parser.add_argument("--defocus-u", type=float, default=-1, help="defocus U setting")
    parser.add_argument("--defocus-v", type=float, default=-1, help="defocus V setting")
    parser.add_argument("--defocus-angle", type=float, default=-1, help="defocus angle setting")
    parser.add_argument("--spherical-aberation", type=float, default=-1, help="spherical aberation setting")
    parser.add_argument("--amplitude-contrast", type=float, default=-1, help="amplitude contrast setting")
    parser.add_argument("--detector-pixel-size", type=float, default=-1, help="detector pixel size setting")
    parser.add_argument("--magnification", type=float, default=-1, help="magnification setting")
    return parser


def main(args):
    import numpy as np

    from topaz_tpu_torch.io import star
    from topaz_tpu_torch.io.table import Table, read_csv

    particles = read_csv(args.file, str_columns=("image_name",))
    names = particles["image_name"]
    table = Table({"ImageName": np.array(["1@" + n + args.image_ext for n in names], dtype=object),
                   "MicrographName": np.array([n + args.image_ext for n in names], dtype=object),
                   "CoordinateX": particles["x_coord"], "CoordinateY": particles["y_coord"]})
    if "score" in particles:
        table["ParticleScore"] = particles["score"]
    for flag, col in [
            (args.voltage, "Voltage"), (args.defocus_u, "DefocusU"),
            (args.defocus_v, "DefocusV"), (args.defocus_angle, "DefocusAngle"),
            (args.spherical_aberation, "SphericalAberration"),
            (args.amplitude_contrast, "AmplitudeContrast"),
            (args.detector_pixel_size, "DetectorPixelSize"),
            (args.magnification, "Magnification")]:
        if flag >= 0:
            table[col] = flag
    star.write(table, sys.stdout)
