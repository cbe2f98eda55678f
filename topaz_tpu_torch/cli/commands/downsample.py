"""topaz downsample (topaz/commands/downsample.py): Fourier-crop one
micrograph on the device (``io/image.downsample_file``)."""
import argparse

from topaz_tpu_torch.device import parse_device_flag

name = "downsample"
help = "downsample micrographs with truncated DFT"


def add_arguments(parser=None):
    if parser is None:
        parser = argparse.ArgumentParser(help)
    parser.add_argument("file")
    parser.add_argument("-s", "--scale", default=4, type=int, help="downsampling factor (default: 4)")
    parser.add_argument("-o", "--output", help="output file")
    parser.add_argument("-v", "--verbose", action="store_true", help="print info")
    parser.add_argument("-d", "--device", default=0, type=parse_device_flag, help="CUDA device index, or cpu to run on the CPU (default: 0)")
    return parser


def main(args):
    from topaz_tpu_torch.io.image import downsample_file

    downsample_file(args.file, args.scale, args.output, args.verbose, device=args.device)
