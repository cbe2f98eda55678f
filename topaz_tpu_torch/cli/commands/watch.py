"""topaz watch (topaz_tpu/cli/commands/watch.py): stream micrographs through
the batched pipeline as a microscope writes them. The JAX CLI's flags and
defaults; ``-d cpu`` runs on the CPU, ``-d -2`` splits the batches over
every CUDA device."""
import argparse

from topaz_tpu_torch.device import parse_device_flag

name = "watch"
help = ("monitor a directory during data collection and process new "
        "micrographs on the fly: downsample + normalize + pick "
        "(+ denoise), crash-safe and restartable")


def add_arguments(parser=None):
    if parser is None:
        parser = argparse.ArgumentParser(help)
    parser.add_argument("dir", help="directory to watch for new micrographs")
    parser.add_argument("-o", "--output", required=True, help="particle file to append picks to (image_name/x_coord/y_coord/score, raw pixel coordinates); a .manifest.json next to it makes the watcher restartable")
    parser.add_argument("-m", "--model", default="resnet16_u32", help="trained classifier or pretrained model name (default: resnet16_u32)")
    parser.add_argument("--denoise-model", default=None, help="optional denoiser; writes a denoised preview of each micrograph at the working scale (e.g. unet, or a trained .npz/.sav)")
    parser.add_argument("--denoised-output", default=None, help="directory for denoised previews (default: 'denoised' next to --output)")
    parser.add_argument("-s", "--scale", type=int, default=8, help="downsampling factor before scoring, as in preprocess -s (default: 8)")
    parser.add_argument("-r", "--radius", type=int, default=14, help="NMS suppression radius at the working scale (default: 14)")
    parser.add_argument("-t", "--threshold", type=float, default=-6.0, help="log-likelihood pick threshold (default: -6)")
    parser.add_argument("--batch-size", type=int, default=1, help="micrographs per device batch (default: 1)")
    parser.add_argument("--pattern", action="append", default=None, help="filename glob(s) to watch (default: *.mrc; repeatable)")
    parser.add_argument("--poll-interval", type=float, default=5.0, help="seconds between directory polls (default: 5)")
    parser.add_argument("--recursive", action="store_true", help="also watch subdirectories created during the run (EPU/SerialEM write per-grid-square folders)")
    parser.add_argument("--settle-polls", type=int, default=1, help="polls a file's size must be unchanged before it counts as fully written (default: 1; raise on slow network filesystems)")
    parser.add_argument("--once", action="store_true", help="process the current backlog and exit instead of watching")
    parser.add_argument("--idle-timeout", type=float, default=None, help="exit after this many seconds without a new micrograph (default: watch forever)")
    parser.add_argument("--per-micrograph", action="store_true", help="write one coordinate file per micrograph into the --output DIRECTORY instead of appending to a single table (the layout live RELION/CryoSPARC imports consume)")
    parser.add_argument("--format", dest="out_format", default="coord", choices=["coord", "csv", "star", "json", "box"], help="per-micrograph coordinate file format, as in extract --format (default: coord; with --per-micrograph)")
    parser.add_argument("--suffix", default="", help="filename suffix for per-micrograph files (default: none)")
    parser.add_argument("--fail-fast", action="store_true", help="abort on unreadable files instead of skipping them with a warning (a live acquisition directory defaults to skipping)")
    parser.add_argument("--precision", choices=["f32", "bf16"], default="f32", help="denoise-arm precision; picks stay f32 either way (default: f32)")
    parser.add_argument("--bins", type=int, default=0, help="histogram-EM normalization bins (0 = exact EM; 65536 matches --fast)")
    parser.add_argument("-d", "--device", default=0, type=parse_device_flag, help="CUDA device index, -1 for the current one, -2 for every CUDA device, or cpu to run on the CPU (default: 0)")
    from topaz_tpu_torch.cli.fast import add_fast_flag

    add_fast_flag(parser)
    return parser


def main(args):
    from topaz_tpu_torch.cli.fast import apply_fast
    from topaz_tpu_torch.watch import watch_from_args

    apply_fast(args)  # --fast -> bf16 denoise arm + histogram-EM bins
    if args.pattern is None:
        args.pattern = ["*.mrc"]
    watch_from_args(args)
