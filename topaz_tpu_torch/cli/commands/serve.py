"""topaz serve (topaz_tpu/cli/commands/serve.py): picking and denoising over
HTTP. The JAX CLI's flags and defaults; ``-d`` takes an index, ``cpu``, or
``-1`` or ``-2``, which serve on the current CUDA device (the JAX CLI runs
``-d < 0`` on its default device)."""
import argparse

from topaz_tpu_torch.device import parse_device_flag

name = "serve"
help = ("serve picking and denoising over HTTP: POST micrographs to "
        "/extract or /denoise with the models and compiled programs kept "
        "warm between requests")


def add_arguments(parser=None):
    if parser is None:
        parser = argparse.ArgumentParser(help)
    parser.add_argument("--host", default="127.0.0.1", help="interface to bind (default: 127.0.0.1; bind 0.0.0.0 only behind your own auth/ingress — the endpoint itself is unauthenticated)")
    parser.add_argument("--port", type=int, default=8000, help="port to listen on; 0 picks a free port (default: 8000)")
    parser.add_argument("-m", "--model", default="resnet16_u32", help="trained classifier or pretrained model name (default: resnet16_u32)")
    parser.add_argument("--denoise-model", default=None, help="denoiser served at /denoise (default: unet, loaded on first use)")
    parser.add_argument("-s", "--scale", type=int, default=8, help="downsampling factor before scoring, as in preprocess -s; /extract returns raw-pixel coordinates (default: 8)")
    parser.add_argument("-r", "--radius", type=int, default=14, help="NMS suppression radius at the working scale (default: 14)")
    parser.add_argument("-t", "--threshold", type=float, default=-6.0, help="log-likelihood pick threshold; per-request ?threshold= may only raise it (default: -6)")
    parser.add_argument("--precision", choices=["f32", "bf16"], default="f32", help="denoise-arm precision; picks stay f32 either way (default: f32)")
    parser.add_argument("--bins", type=int, default=0, help="histogram-EM normalization bins (0 = exact EM; 65536 matches --fast)")
    parser.add_argument("--max-request-bytes", type=int, default=2 << 30, help="reject request bodies larger than this (default: 2 GiB)")
    parser.add_argument("--max-batch", type=int, default=8, help="dynamic batching: coalesce up to this many concurrent /extract requests into one device batch (1 disables; default: 8)")
    parser.add_argument("--batch-window-ms", type=float, default=20.0, help="how long the device worker waits for more requests after the first before running a partial batch (default: 20 ms)")
    parser.add_argument("--queue-depth", type=int, default=64, help="requests queued for the device beyond this get 503 (backpressure; default: 64)")
    parser.add_argument("--device-timeout", type=float, default=300.0, help="per-request device deadline in seconds: requests unanswered by then get 504, and a worker wedged mid-call is replaced so later requests recover (0 disables; default: 300)")
    parser.add_argument("-d", "--device", default=0, type=parse_device_flag, help="CUDA device index, -1 or -2 for the current one, or cpu to run on the CPU (default: 0)")
    from topaz_tpu_torch.cli.fast import add_fast_flag

    add_fast_flag(parser)
    return parser


def main(args):
    from topaz_tpu_torch.cli.fast import apply_fast
    from topaz_tpu_torch.serve import serve_from_args

    apply_fast(args)  # --fast -> bf16 denoise arm + histogram-EM bins
    return serve_from_args(args)
