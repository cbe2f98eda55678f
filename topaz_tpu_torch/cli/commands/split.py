"""topaz split (topaz/commands/split.py): the JAX CLI's flags and defaults
(topaz_tpu/cli/commands/split.py); image names stay strings."""
import argparse

import numpy as np

name = "split"
help = ("split particle file containing coordinates for multiple micrographs "
        "into one file per micrograph")


def add_arguments(parser=None):
    if parser is None:
        parser = argparse.ArgumentParser(help)
    parser.add_argument("file", help="path to input particle file")
    parser.add_argument("-o", "--output", help="path to output directory")
    parser.add_argument("--format", dest="_from", choices=["auto", "coord", "star"], default="auto", help="file format of the INPUT file (default: auto)")
    parser.add_argument("--suffix", default="", help="suffix to append to file names (default: none)")
    parser.add_argument("-t", "--threshold", type=float, default=-np.inf, help="threshold the particles by score (optional)")
    return parser


def main(args):
    from topaz_tpu_torch.io.coordinates import split_particle_file

    split_particle_file(args.file, args._from, args.suffix, args.threshold, args.output)
