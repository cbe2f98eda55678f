"""topaz star_particles_threshold [deprecated] (topaz_tpu/cli/commands/
star_particles_threshold.py): the JAX CLI's flags and defaults."""
import numpy as np

name = "star_particles_threshold"
help = "filter the particles in a .star file by score threshold"


def add_arguments(parser):
    parser.add_argument("file", help="path to input star file")
    parser.add_argument("-o", "--output", help="path to write particle stack file")
    parser.add_argument("-t", "--threshold", type=float, default=-np.inf, help="only take particles with scores >= this value (default: -inf)")
    return parser


def main(args):
    from topaz_tpu_torch.io.star import threshold_star_particles

    threshold_star_particles(args.file, args.threshold, args.output)
