"""topaz train_test_split (topaz/commands/train_test_split.py): the JAX
CLI's flags and defaults (topaz_tpu/cli/commands/train_test_split.py)."""
import argparse

name = "train_test_split"
help = "split micrographs with labeled particles into train/test sets"


def add_arguments(parser=None):
    if parser is None:
        parser = argparse.ArgumentParser(help)
    parser.add_argument("file", help="path to particle file")
    parser.add_argument("--image-dir", help="path to images directory")
    parser.add_argument("--image-ext", default="*", help="extension of images (default: auto detect)")
    parser.add_argument("--format", dest="format_", choices=["auto", "coord", "csv", "star", "box"], default="auto", help="file format of the particle file (default: auto)")
    parser.add_argument("-n", "--number", type=int, help="number of images to put into test set")
    parser.add_argument("--seed", default=0, type=int, help="random seed used to generate the random split (default: 0)")
    return parser


def main(args):
    from topaz_tpu_torch.io.coordinates import train_test_split_micrographs

    train_test_split_micrographs(args.seed, args.number, args.file, args.format_,
                                 args.image_dir, args.image_ext)
