"""topaz segment (topaz/commands/segment.py): the JAX CLI's flags and
defaults (topaz_tpu/cli/commands/segment.py); ``-d cpu`` runs on the CPU,
``-d -2`` splits each whole image by rows over every CUDA device."""
import argparse

from topaz_tpu_torch.device import parse_device_flag

name = "segment"
help = "segment images using a trained region classifier"


def add_arguments(parser=None):
    if parser is None:
        parser = argparse.ArgumentParser(help)
    parser.add_argument("paths", nargs="+", help="paths to image files for processing")
    parser.add_argument("-m", "--model", default="resnet16", help="path to trained classifier. uses the pretrained resnet16 (2D) model by default.")
    parser.add_argument("-o", "--destdir", help="output directory")
    parser.add_argument("-d", "--device", default=0, type=parse_device_flag, help="CUDA device index, -2 to split each whole image over every CUDA device, or cpu to run on the CPU (default: 0)")
    parser.add_argument("-j", "--num-threads", type=int, default=0, help="host threads (compatibility flag)")
    parser.add_argument("-p", "--patch-size", type=int, default=None, help="size of patches to predict on, None will predict on the whole image (default: None)")
    parser.add_argument("-v", "--verbose", action="store_true", help="verbose mode")
    return parser


def main(args):
    from topaz_tpu_torch.segment import segment_images

    if args.patch_size is not None and args.patch_size <= 0:
        raise ValueError("patch size must be positive")
    from topaz_tpu_torch.parallel.devices import resolve_devices

    segment_images(args.model, args.paths, args.destdir, patch_size=args.patch_size,
                   verbose=args.verbose, devices=resolve_devices(args.device))
