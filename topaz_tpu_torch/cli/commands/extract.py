"""topaz extract (topaz/commands/extract.py): the JAX CLI's flags; the
paths this port does not run yet raise a not-yet-ported error."""
import argparse

from topaz_tpu_torch.device import parse_device_flag

name = "extract"
help = ("extract particles from segmented images or segment and extract in "
        "one step with a trained classifier")


def add_arguments(parser=None):
    if parser is None:
        parser = argparse.ArgumentParser(help)
    parser.add_argument("paths", nargs="*", help="paths to image files for processing, can also be streamed from stdin")
    parser.add_argument("-m", "--model", default="resnet16", help='path to trained subimage classifier. uses the pretrained resnet16 model by default. set to "none" for pre-segmented score maps (default: resnet16)')
    parser.add_argument("-r", "--radius", type=int, help="radius of the regions to extract")
    parser.add_argument("-t", "--threshold", default=-6, type=float, help="log-likelihood score threshold at which to terminate region extraction, -6 is p>=0.0025 (default: -6)")
    parser.add_argument("-s", "--down-scale", type=float, default=1, help="DOWN-scale coordinates by this factor (default: 1)")
    parser.add_argument("-x", "--up-scale", type=float, default=1, help="UP-scale coordinates by this factor (default: 1)")
    parser.add_argument("--num-workers", type=int, default=0, help="worker processes (compatibility flag; NMS runs on the accelerator)")
    parser.add_argument("-j", "--num-threads", type=int, default=0, help="host threads (compatibility flag)")
    parser.add_argument("-p", "--patch-size", type=int, default=0, help="patch size for scoring micrographs in pieces (default: 0, no patching)")
    parser.add_argument("--batch-size", type=int, default=1, help="batch size for scoring micrographs with model (default: 1)")
    parser.add_argument("--assignment-radius", type=int, help="maximum distance between prediction and labeled target allowed for considering them a match (default: same as extraction radius)")
    parser.add_argument("--min-radius", type=int, default=5, help="minimum radius for region extraction when tuning radius parameter (default: 5)")
    parser.add_argument("--max-radius", type=int, default=100, help="maximum radius for region extraction when tuning radius parameters (default: 100)")
    parser.add_argument("--step-radius", type=int, default=5, help="grid size when searching for optimal radius parameter (default: 5)")
    parser.add_argument("--targets", help="path to file specifying particle coordinates. used to find extraction radius that maximizes the AUPRC")
    parser.add_argument("--only-validate", action="store_true", help="flag indicating to only calculate validation metrics. does not report full prediction list")
    parser.add_argument("-d", "--device", default=0, type=parse_device_flag, help="CUDA device index, or cpu to run on the CPU; -2 (all devices) is not yet ported (default: 0)")
    parser.add_argument("-o", "--output", help="file path to write")
    parser.add_argument("--per-micrograph", action="store_true", help="write one particle file per micrograph at the location of the micrograph")
    parser.add_argument("--suffix", default="", help="optional suffix to add to particle file paths when using the --per-micrograph flag.")
    parser.add_argument("--format", choices=["coord", "csv", "star", "json", "box"], default="coord", help="file format of the OUTPUT files (default: coord)")
    parser.add_argument("--dims", type=int, default=2, choices=[2, 3], help="image dimensionality (default: 2/micrographs), set to 3 for tomograms")
    parser.add_argument("-v", "--verbose", action="store_true", help="report as each image is scored and picks are extracted")
    parser.add_argument("--skip-errors", action="store_true", help="warn and continue past unreadable/corrupt micrographs in the batched path instead of aborting the run (extension; default aborts on the first bad file like the reference)")
    return parser


def main(args):
    from topaz_tpu_torch.extract import extract_particles

    extract_particles(
        args.paths, args.model, args.threshold, args.radius,
        targets=args.targets, patch_size=args.patch_size,
        batch_size=args.batch_size, only_validate=args.only_validate,
        output=args.output, per_micrograph=args.per_micrograph,
        up_scale=args.up_scale, down_scale=args.down_scale, dims=args.dims,
        verbose=args.verbose, device=args.device,
    )
