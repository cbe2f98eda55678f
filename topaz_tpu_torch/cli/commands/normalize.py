"""topaz normalize (topaz/commands/normalize.py): the JAX CLI's flags;
``--batch-size > 1`` fits shape-bucketed batches on one device, and
``-d -2`` fits them split over every device (one image a device unless
``--batch-size`` says more)."""
import argparse
import sys

from topaz_tpu_torch.device import parse_device_flag

name = "normalize"
help = "normalize a set of images using the 2-component Gaussian mixture model"


def add_arguments(parser=None):
    if parser is None:
        parser = argparse.ArgumentParser(help)
    parser.add_argument("files", nargs="+")
    parser.add_argument("-s", "--scale", default=1, type=int, help="downsample images by this factor (default: 1)")
    parser.add_argument("--affine", action="store_true", help="use standard normalization (x-mu)/std of whole image rather than GMM normalization")
    parser.add_argument("--sample", default=None, type=int, help="pixel sampling factor for model fit (default: 10)")
    parser.add_argument("--bins", default=0, type=int, help="fit the GMM to a histogram of ALL pixels with this many bins instead of subsampling — faster and lower-variance than --sample for large images; 0 disables (default: 0)")
    parser.add_argument("--niters", default=100, type=int, help="maximum number of EM iterations to run for model fit (default: 100)")
    parser.add_argument("-a", "--alpha", default=900, type=float, help="alpha parameter of the beta distribution prior on the mixing proportion (default: 900)")
    parser.add_argument("-b", "--beta", default=1, type=float, help="beta parameter of the beta distribution prior on the mixing proportion (default: 1)")
    parser.add_argument("--metadata", action="store_true", help="if set, save parameter metadata for each micrograph")
    parser.add_argument("-d", "--device", default=-1, type=parse_device_flag, help="CUDA device index, -1 for the current CUDA device, -2 to batch micrographs and split the GMM fits over every CUDA device, or cpu to run on the CPU (default: -1)")
    parser.add_argument("--batch-size", default=1, type=int, help="fit this many micrographs at once on the device (shape-bucketed + masked) (default: 1)")
    parser.add_argument("-t", "--num-workers", type=int, default=0, help="number of parallel processes (compatibility flag; per-image fits run on the accelerator)")
    parser.add_argument("-j", "--num-threads", type=int, default=0, help="number of host threads (compatibility flag)")
    parser.add_argument("-o", "--destdir", help="output directory")
    parser.add_argument("--format", dest="format_", default="mrc", help="image format(s) to write, comma separated: mrc, tiff, png (default: mrc)")
    parser.add_argument("-v", "--verbose", action="store_true", help="verbose output")
    parser.add_argument("--skip-errors", action="store_true", help="warn and continue past unreadable/corrupt micrographs in the batched path instead of aborting the run (extension; default aborts on the first bad file like the reference)")
    from topaz_tpu_torch.cli.fast import add_fast_flag

    add_fast_flag(parser)
    return parser


def main(args):
    from topaz_tpu_torch.cli.fast import apply_fast
    from topaz_tpu_torch.preprocess import normalize_images, normalize_images_batched

    apply_fast(args)  # --fast -> --bins 65536 (histogram EM)
    formats = args.format_.split(",")
    if args.device == -2 or args.batch_size > 1:
        device, mesh = args.device, None
        if args.device == -2:
            from topaz_tpu_torch.parallel.devices import data_mesh_for, resolve_devices

            devices = resolve_devices(-2)
            device = devices[0]
            # shrink to a device count that divides the batch
            bs = args.batch_size if args.batch_size > 1 else len(devices)
            mesh = data_mesh_for(devices, bs, warn=True)
        if args.sample is not None and args.sample > 1:
            # only when the user asked for subsampling
            print("# batched normalization fits all valid pixels; --sample "
                  "subsampling is a CPU-only workaround and is ignored "
                  "(use --bins for a faster fit)", file=sys.stderr)
        normalize_images_batched(
            args.files, args.destdir, scale=args.scale, affine=args.affine,
            num_iters=args.niters, alpha=args.alpha, beta=args.beta,
            metadata=args.metadata, formats=formats, bins=args.bins,
            verbose=args.verbose,
            batch_size=args.batch_size if args.batch_size > 1 else 0,
            skip_errors=args.skip_errors, device=device, mesh=mesh,
        )
        return
    normalize_images(
        args.files, args.destdir, scale=args.scale, affine=args.affine,
        num_iters=args.niters, alpha=args.alpha, beta=args.beta,
        sample=args.sample if args.sample is not None else 10,
        metadata=args.metadata, formats=formats,
        bins=args.bins, verbose=args.verbose, device=args.device,
    )
