"""topaz particle_stack (topaz/commands/particle_stack.py): the JAX CLI's
flags and defaults (topaz_tpu/cli/commands/particle_stack.py), plus ``-d``:
``--resize`` downsamples on that device."""
import argparse

import numpy as np

from topaz_tpu_torch.device import parse_device_flag

name = "particle_stack"
help = "extract images of particles into a particle stack"


def add_arguments(parser=None):
    if parser is None:
        parser = argparse.ArgumentParser(help)
    parser.add_argument("file", help="path to input particle file")
    parser.add_argument("-o", "--output", help="path to write particle stack file")
    parser.add_argument("--image-root", help="root directory of the micrograph files")
    parser.add_argument("--size", type=int, help="size of particle stack images")
    parser.add_argument("--threshold", type=float, default=-np.inf, help="only take particles with scores >= this value (default: -inf)")
    parser.add_argument("--resize", type=int, default=-1, help="rescaled particle size (default: no rescaling)")
    parser.add_argument("--image-ext", default=".mrc", help="image file extension (default: .mrc)")
    parser.add_argument("--metadata", help="path to metadata star file to merge into output")
    parser.add_argument("-d", "--device", default=0, type=parse_device_flag, help="CUDA device index for --resize, or cpu to run on the CPU (default: 0)")
    return parser


def main(args):
    from topaz_tpu_torch.ops.masks import create_particle_stack

    create_particle_stack(args.file, args.output, args.threshold, args.size, args.resize,
                          args.image_root, args.image_ext, args.metadata, device=args.device)
