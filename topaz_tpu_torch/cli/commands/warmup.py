"""topaz warmup (topaz_tpu/cli/commands/warmup.py): build the CUDA kernels
and run the acquisition-shaped programs once before a session. The JAX
CLI's flags and defaults; ``-d cpu`` runs on the CPU, ``-d -2`` warms the
pipeline split over every CUDA device."""
import argparse

from topaz_tpu_torch.device import parse_device_flag

name = "warmup"
help = ("build the CUDA kernels and run the standard device programs "
        "(extract pipeline + whole-image denoise) once for given shapes, "
        "so acquisition runs start warm")


def add_arguments(parser=None):
    if parser is None:
        parser = argparse.ArgumentParser(help)
    parser.add_argument("-m", "--model", default="resnet16_u32", help="picker whose scoring program to warm (default: resnet16_u32)")
    parser.add_argument("--denoise-model", default=None, help="also warm this denoiser's whole-image program at each raw shape (default: none)")
    parser.add_argument("--shapes", default="4096x4096", help="comma-separated raw micrograph shapes HxW to warm (default: 4096x4096; add your camera's, e.g. 5760x4092 for K3)")
    parser.add_argument("--batch-sizes", default="1,8", help="comma-separated pipeline batch sizes to warm (default: 1,8 — single frames and the watch/serve batch)")
    parser.add_argument("-s", "--scale", type=int, default=8, help="downsampling factor the acquisition run will use (default: 8)")
    parser.add_argument("-r", "--radius", type=int, default=14, help="NMS radius at the working scale (default: 14)")
    parser.add_argument("-t", "--threshold", type=float, default=-6.0, help="pick threshold (default: -6)")
    parser.add_argument("--bins", type=int, default=0, help="histogram-EM bins, as the acquisition run will use (0 = exact EM; 65536 matches --fast)")
    parser.add_argument("--precision", choices=["f32", "bf16"], default="f32", help="denoise-arm precision to warm (default: f32)")
    parser.add_argument("-d", "--device", default=0, type=parse_device_flag, help="CUDA device index, -1 for the current one, -2 for every CUDA device, or cpu to run on the CPU (default: 0)")
    from topaz_tpu_torch.cli.fast import add_fast_flag

    add_fast_flag(parser)
    return parser


def main(args):
    from topaz_tpu_torch.cli.fast import apply_fast
    from topaz_tpu_torch.warmup import warmup_from_args

    apply_fast(args)
    return warmup_from_args(args)
